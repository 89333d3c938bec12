"""The consensus kernels on the card (CUDA C++), as in
``repro.kernels.consensus_mix``.

* Kernel 1, ``consensus_mix_cuda`` (source ``csrc/consensus_mix.cu``):
  one round ``W <- A W`` for f32 or bf16 ``W`` (A f32, an f32 sum, the
  output in W's dtype, as the Pallas ``_mix_kernel``); replaces
  ``consensus_mix_2d``.
* Kernel 4, ``quantized_consensus_mix_cuda`` (source
  ``csrc/quantized_mix.cu``): the simulated wire's ``A · D(C(w; u))`` in
  one pass; replaces ``quantized_consensus_mix_2d``.
* The physical wire's kernels 5-8 (one source, ``csrc/quantized_wire.cu``):
  ``quantized_gossip_encode_cuda``, ``bucketed_gossip_round_cuda``,
  ``bucketed_gossip_round_pipelined_cuda`` and
  ``quantized_gossip_round_cuda``; they replace the Pallas kernels of the
  same names (``..._2d``).  They update their state operands IN PLACE (each
  block reads a slab of whole chunks before it overwrites it), so a gossip
  period allocates nothing per round.
* Row forms of kernels 1, 7 and 8 (``consensus_mix_rows_cuda``,
  ``bucketed_gossip_round_rows_cuda``,
  ``bucketed_gossip_round_pipelined_rows_cuda``): the rank of the
  multi-process wire owns ``M_out`` of the ``M`` gathered rows, so it
  passes A's own rows ``(M_out, M)``, the gathered operand read-only and
  separate output buffers; row r of a row form is bitwise row r of the
  square call.  Their launches count in ``row_launches``.

Each wrapper checks its operands, launches on PyTorch's current stream,
raises on a launch error and counts its launches (``launches``,
``quant_mix_launches``, ``wire_launches``).  The sources' notes say what bounds each kernel and how
the design answers.  The plain versions are in ``repro_torch.kernels.ref``;
``repro_torch.kernels.ops`` picks between kernel and plain version by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last ``ops.reset_launch_counts()``
launches = 0
#: launches of kernel 4 since the last reset
quant_mix_launches = 0
#: launches of the wire kernels, by the name of the ``ops`` entry point
wire_launches = {"quantized_gossip_encode": 0, "bucketed_gossip_round": 0,
                 "bucketed_gossip_round_pipelined": 0,
                 "quantized_gossip_round": 0}
#: launches of the row forms of kernels 1, 7 and 8, by ``ops`` entry point
row_launches = {"consensus_mix_rows": 0, "bucketed_gossip_round_rows": 0,
                "bucketed_gossip_round_pipelined_rows": 0}
_MAX_M = 64


_MIX_FNS = {torch.float32: "consensus_mix_f32",
            torch.bfloat16: "consensus_mix_bf16"}
_ROW_FNS = {torch.float32: "consensus_mix_rows_f32",
            torch.bfloat16: "consensus_mix_rows_bf16"}


def _lib(dtype: torch.dtype, rows: bool = False):
    lib = _build.load("consensus_mix")
    fn = getattr(lib, (_ROW_FNS if rows else _MIX_FNS)[dtype])
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * (2 if rows else 1)
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def consensus_mix_cuda(a: torch.Tensor, w: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    """``out <- a @ w`` on the card.  a: (M, M) f32 contiguous, M <= 64;
    w, out: (M, D) CUDA views of one dtype, float32 or bfloat16, with unit
    column stride (any row stride, so a column block of a wider buffer
    works); ``out`` must not overlap ``w``.  The sum runs in f32 and rounds
    once to W's dtype.  Other dtypes raise, nothing is cast."""
    global launches
    m = w.shape[0] if w.dim() == 2 else -1
    _mix_check(a, w, out, m)
    d = w.shape[1]
    ld_w = w.stride(0) if m > 1 else d
    ld_o = out.stride(0) if m > 1 else d
    fn = _lib(w.dtype)
    err = fn(a.data_ptr(), m, w.data_ptr(), ld_w, out.data_ptr(), ld_o, d,
             torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"consensus_mix kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def consensus_mix_rows_cuda(a: torch.Tensor, w: torch.Tensor,
                            out: torch.Tensor) -> torch.Tensor:
    """Kernel 1's row form, ``out <- a @ w`` with a: (M_out, M) f32
    contiguous (the rows of A one rank owns), w: (M, D) and out: (M_out, D)
    as in ``consensus_mix_cuda``.  Row r of ``out`` is bitwise row r of the
    square call with the full A."""
    if w.dim() != 2 or a.dim() != 2:
        raise ValueError("consensus_mix_rows_cuda takes a 2-D A and W")
    m, m_out = w.shape[0], a.shape[0]
    if not 1 <= m_out <= m:
        raise ValueError(f"A has {m_out} rows for W of {m} rows")
    _mix_check(a, w, out, m, m_out)
    d = w.shape[1]
    ld_w = w.stride(0) if m > 1 else d
    ld_o = out.stride(0) if m_out > 1 else d
    fn = _lib(w.dtype, rows=True)
    err = fn(a.data_ptr(), m_out, m, w.data_ptr(), ld_w, out.data_ptr(),
             ld_o, d, torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"consensus_mix_rows kernel launch failed: CUDA "
                           f"error {err}")
    row_launches["consensus_mix_rows"] += 1
    return out


def _mix_check(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, m: int,
               m_out: int = -1) -> None:
    """Device, dtype, shape and layout of kernel 1's operands: A (m_out, m)
    (m_out = m for the square call), W (m, D), out (m_out, D)."""
    m_out = m if m_out < 0 else m_out
    if not (a.is_cuda and w.is_cuda and out.is_cuda):
        raise ValueError("consensus_mix_cuda takes CUDA tensors only")
    if a.device != w.device or out.device != w.device:
        raise ValueError("a, w and out must be on one device")
    if a.dtype != torch.float32:
        raise TypeError(f"consensus_mix_cuda takes a float32 A, got {a.dtype}")
    if w.dtype not in _MIX_FNS or out.dtype != w.dtype:
        raise TypeError(f"consensus_mix_cuda takes float32 or bfloat16 W and "
                        f"out of one dtype; got {w.dtype} and {out.dtype}")
    if w.dim() != 2 or out.dim() != 2 or out.shape[1] != w.shape[1] \
            or out.shape[0] != m_out:
        raise ValueError(f"w must be (M, D) and out ({m_out}, D), got "
                         f"{tuple(w.shape)} and {tuple(out.shape)}")
    d = w.shape[1]
    if not 1 <= m <= _MAX_M:
        raise ValueError(f"consensus_mix_cuda takes 1 <= M <= {_MAX_M}, "
                         f"got M={m}")
    if a.shape != (m_out, m) or not a.is_contiguous():
        raise ValueError(f"a must be a contiguous ({m_out}, {m}) matrix")
    if d and (w.stride(1) != 1 or out.stride(1) != 1):
        raise ValueError("w and out need unit column stride")
    if d and ((m > 1 and w.stride(0) < d)
              or (m_out > 1 and out.stride(0) < d)):
        raise ValueError("row stride shorter than the row")
    if d and _overlap(w, out):
        raise ValueError("out must not overlap w (ping-pong two buffers)")


def _overlap(x: torch.Tensor, y: torch.Tensor) -> bool:
    def span(t):
        lo = t.data_ptr()
        hi = lo + ((t.shape[0] - 1) * t.stride(0)
                   + t.shape[1]) * t.element_size()
        return lo, hi
    (a0, a1), (b0, b1) = span(x), span(y)
    return a0 < b1 and b0 < a1


# ---------------------------------------------------------------------------
# the physical wire: kernels 5-8
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_WIRE_ARGS = {
    "wire_encode_f32": [_P] * 5 + [_I, _L, _I, _I, _P],
    "wire_bucketed_round_f32": [_P] * 6 + [_I, _L, _I, _I, _P],
    "wire_pipelined_round_f32": [_P] * 7 + [_I, _L, _I, _I, _P],
    "wire_leaf_round_f32": [_P] * 6 + [_I, _L, _I, _I, _P],
    "wire_bucketed_round_rows_f32": [_P] * 8 + [_I, _I, _I, _L, _I, _I, _P],
    "wire_pipelined_round_rows_f32": [_P] * 9 + [_I, _I, _L, _I, _I, _P],
}


def _wire_fn(name: str):
    lib = _build.load("quantized_wire")
    fn = getattr(lib, name)
    fn.argtypes = _WIRE_ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def _wire_check(m: int, d: int, bits: int, chunk: int, a=None, m_out=None,
                **tensors):
    """Device, dtype, shape and contiguity of a wire kernel's operands: the
    gathered ``codes`` / ``scales`` have ``m`` rows, A and every other
    operand ``m_out`` (default ``m``)."""
    m_out = m if m_out is None else m_out
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if chunk < 1 or d % chunk:
        raise ValueError(f"chunk={chunk} must divide D={d} (pad the wire "
                         f"buffer to the bucket grid first, as the gossip "
                         f"paths do)")
    if not 1 <= m <= _MAX_M:
        raise ValueError(f"the wire kernels take 1 <= M <= {_MAX_M}, got {m}")
    if not 1 <= m_out <= m:
        raise ValueError(f"{m_out} own rows of {m}")
    if a is not None:
        tensors["a"] = a
    want = {"codes": (torch.int8, (m, d)), "scales": (torch.float32,
                                                      (m, d // chunk)),
            "codes_out": (torch.int8, (m_out, d)),
            "scales_out": (torch.float32, (m_out, d // chunk)),
            "a": (torch.float32, (m_out, m))}
    device = None
    for name, t in tensors.items():
        dtype, shape = want.get(name, (torch.float32, (m_out, d)))
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if device is None:
            device = t.device
        if t.device != device:
            raise ValueError("every operand must be on one device")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")


def _wire_launch(name: str, counter: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = _wire_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if counter in row_launches:
        row_launches[counter] += 1
    else:
        wire_launches[counter] += 1


def _distinct(*named) -> None:
    """The row forms' outputs must not overlap their read-only inputs."""
    for i, (na, x) in enumerate(named):
        for nb, y in named[i + 1:]:
            if x.numel() and y.numel() and _overlap(x.reshape(x.shape[0], -1),
                                                    y.reshape(y.shape[0], -1)):
                raise ValueError(f"{na} must not overlap {nb}")


def bucketed_gossip_round_rows_cuda(a, codes, scales, ref, acc, dither,
                                    codes_out, scales_out, *, row0: int,
                                    bits: int, chunk: int):
    """Kernel 7's row form: a (M_out, M); the gathered codes (M, D) and
    scales (M, D/chunk) read only; ref, acc, dither (M_out, D), ref and acc
    updated in place; the next codes and scales into ``codes_out`` (M_out,
    D) and ``scales_out`` (M_out, D/chunk).  ``row0`` is the first own row
    among the M.  Returns ``(acc, ref, codes_out, scales_out)``."""
    m, d = codes.shape
    m_out = ref.shape[0]
    _wire_check(m, d, bits, chunk, a=a, m_out=m_out, codes=codes,
                scales=scales, ref=ref, acc=acc, dither=dither,
                codes_out=codes_out, scales_out=scales_out)
    if not 0 <= row0 <= m - m_out:
        raise ValueError(f"row0={row0} out of range for {m_out} of {m} rows")
    _distinct(("codes_out", codes_out), ("codes", codes))
    _distinct(("scales_out", scales_out), ("scales", scales))
    _wire_launch("wire_bucketed_round_rows_f32", "bucketed_gossip_round_rows",
                 a.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                 ref.data_ptr(), acc.data_ptr(), dither.data_ptr(),
                 codes_out.data_ptr(), scales_out.data_ptr(), m_out, row0, m,
                 d, chunk, bits)
    return acc, ref, codes_out, scales_out


def bucketed_gossip_round_pipelined_rows_cuda(a, codes, scales, w, ref, acc,
                                              dither, codes_out, scales_out,
                                              *, bits: int, chunk: int):
    """Kernel 8's row form: a (M_out, M); the DELAYED gathered codes (M,
    D) and scales (M, D/chunk) read only; w, ref, acc, dither (M_out, D),
    ``acc`` may be ``w``; this round's codes and scales into ``codes_out``
    and ``scales_out``.  Returns ``(acc, ref, codes_out, scales_out)``."""
    m, d = codes.shape
    m_out = ref.shape[0]
    _wire_check(m, d, bits, chunk, a=a, m_out=m_out, codes=codes,
                scales=scales, w=w, ref=ref, acc=acc, dither=dither,
                codes_out=codes_out, scales_out=scales_out)
    _distinct(("codes_out", codes_out), ("codes", codes))
    _distinct(("scales_out", scales_out), ("scales", scales))
    _wire_launch("wire_pipelined_round_rows_f32",
                 "bucketed_gossip_round_pipelined_rows", a.data_ptr(),
                 codes.data_ptr(), scales.data_ptr(), w.data_ptr(),
                 ref.data_ptr(), acc.data_ptr(), dither.data_ptr(),
                 codes_out.data_ptr(), scales_out.data_ptr(), m_out, m, d,
                 chunk, bits)
    return acc, ref, codes_out, scales_out


def quantized_gossip_encode_cuda(w, ref, dither, codes, scales, *, bits: int,
                                 chunk: int):
    """Kernel 6: ``codes, scales <- C(w - ref; dither)``.  Returns
    ``(codes, scales)``."""
    m, d = w.shape
    _wire_check(m, d, bits, chunk, w=w, ref=ref, dither=dither, codes=codes,
                scales=scales)
    _wire_launch("wire_encode_f32", "quantized_gossip_encode", w.data_ptr(),
                 ref.data_ptr(), dither.data_ptr(), codes.data_ptr(),
                 scales.data_ptr(), m, d, chunk, bits)
    return codes, scales


def bucketed_gossip_round_cuda(a, codes, scales, ref, acc, dither, *,
                               bits: int, chunk: int):
    """Kernel 7, in place on ``codes``, ``scales``, ``ref`` and ``acc``.
    Returns ``(acc, ref, codes, scales)``."""
    m, d = codes.shape
    _wire_check(m, d, bits, chunk, a=a, codes=codes, scales=scales, ref=ref,
                acc=acc, dither=dither)
    _wire_launch("wire_bucketed_round_f32", "bucketed_gossip_round",
                 a.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                 ref.data_ptr(), acc.data_ptr(), dither.data_ptr(), m, d,
                 chunk, bits)
    return acc, ref, codes, scales


def bucketed_gossip_round_pipelined_cuda(a, codes, scales, w, ref, acc,
                                         dither, *, bits: int, chunk: int):
    """Kernel 8, in place on ``codes``/``scales`` (delayed in, shipped out),
    ``ref`` and ``acc``; ``acc`` may be ``w`` itself.  Returns ``(acc, ref,
    codes, scales)``."""
    m, d = codes.shape
    _wire_check(m, d, bits, chunk, a=a, codes=codes, scales=scales, w=w,
                ref=ref, acc=acc, dither=dither)
    _wire_launch("wire_pipelined_round_f32",
                 "bucketed_gossip_round_pipelined", a.data_ptr(),
                 codes.data_ptr(), scales.data_ptr(), w.data_ptr(),
                 ref.data_ptr(), acc.data_ptr(), dither.data_ptr(), m, d,
                 chunk, bits)
    return acc, ref, codes, scales


def quantized_gossip_round_cuda(a, codes, scales, ref, mixed, dither, *,
                                bits: int, chunk: int):
    """Kernel 5, in place on ``codes``, ``scales`` and ``ref``; the mixed
    iterates go to ``mixed``.  Returns ``(mixed, ref, codes, scales)``."""
    m, d = codes.shape
    _wire_check(m, d, bits, chunk, a=a, codes=codes, scales=scales, ref=ref,
                mixed=mixed, dither=dither)
    _wire_launch("wire_leaf_round_f32", "quantized_gossip_round",
                 a.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                 ref.data_ptr(), mixed.data_ptr(), dither.data_ptr(), m, d,
                 chunk, bits)
    return mixed, ref, codes, scales


# ---------------------------------------------------------------------------
# the simulated wire: kernel 4
# ---------------------------------------------------------------------------


def quantized_consensus_mix_cuda(a, w, dither, out, *, bits: int,
                                 chunk: int):
    """Kernel 4: ``out <- a · D(C(w; dither))``.  a: (M, M); w, dither,
    out: contiguous (M, D) float32 CUDA tensors, ``chunk`` dividing D;
    ``out`` may be ``w`` or ``dither`` itself (each column is read whole
    before it is written), but no other overlap.  Returns ``out``."""
    global quant_mix_launches
    m, d = w.shape
    _wire_check(m, d, bits, chunk, a=a, w=w, dither=dither, out=out)
    if d and out.data_ptr() not in (w.data_ptr(), dither.data_ptr()) and (
            _overlap(out, w) or _overlap(out, dither)):
        raise ValueError("out may be w or dither itself, but must not "
                         "partly overlap them")
    lib = _build.load("quantized_mix")
    fn = lib.quantized_mix_f32
    fn.argtypes = [_P] * 4 + [_I, _L, _I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), w.data_ptr(), dither.data_ptr(), out.data_ptr(), m,
             d, chunk, bits, torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantized_mix kernel launch failed: CUDA error "
                           f"{err}")
    quant_mix_launches += 1
    return out
