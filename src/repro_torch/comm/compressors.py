"""Lossy compressors for inter-server gossip messages: port of
``repro.comm.compressors``.

Every compressor is a ``compress``/``decompress`` pair over arrays whose
leading axis is the server (row i is server i's outgoing message):

* ``IdentityCompressor``: exact passthrough (the accounting baseline);
* ``StochasticQuantizer(bits, chunk)``: int8/int4 with per-chunk absmax
  scales over the LAST axis and stochastic rounding
  ``clip(floor(x * (1/s) + u), -qmax, qmax)``, the multiply-add fused into
  one rounding as the reference's jitted programs round it;
* ``TopKCompressor(ratio)``: per-row magnitude top-k, values and int32
  indices on the wire;
* ``RandomKCompressor(ratio)``: one shared coordinate set per call, drawn
  by the O(k) Feistel ``keyed_index_sample`` from the shared key, so only
  the values cross the wire.

**Simulated wire** (quantize once per period): ``roundtrip_tree`` is what
every receiver reconstructs of a server tree, leaf ``i`` keyed by
``prng.fold_in(key, i)`` in JAX's sorted leaf order.  A quantizer's dither
is ``prng.uniform(key_i, leaf.shape)``, bitwise ``jax.random.uniform``, and
its round trip runs on kernel 4 (``kernels.ops.quantized_consensus_mix``,
``StochasticQuantizer.mix``): each leaf in its natural layout, rows of the
last axis zero-padded to a multiple of the kernel's chunk where they are
ragged.  Top-k and random-k flatten each leaf to (M, d) and run in plain
PyTorch ops (no TPU kernel computes them).

**Physical wire**: ``StochasticQuantizer.encode_block`` turns a flattened
block into the byte layout that crosses the wire -- int8 codes (two int4
codes packed per byte by ``pack_int4``) plus one f32 scale per chunk -- and
``decode_block`` inverts it; its dither is ``wire_dither``, a keyed counter
hash (``_mix32``) over the element index keyed by four threefry
``fold_in``s, bitwise the reference's.

Spec grammar of ``make_compressor``: ``none | int8[:CHUNK] | int4[:CHUNK] |
top_k:RATIO | random_k:RATIO | identity``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

_MASK32 = 0xFFFFFFFF
#: columns of one dither block: bounds the int64 transient to ~0.5 GB
_DITHER_COLS = 1 << 24


# ---------------------------------------------------------------------------
# int4 byte packing + the shared wire-dither convention
# ---------------------------------------------------------------------------


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 tensor, values in [-8, 7]) two per byte along
    the last axis: element ``2i`` in the low nibble, ``2i+1`` in the high
    nibble; an odd-length axis gets one zero code of padding."""
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    u = codes.to(torch.int16) & 0x0F
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8).view(
        torch.int8)


def unpack_int4(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: (..., ceil(length/2)) bytes -> (..., length)
    sign-extended int8 codes."""
    u = packed.view(torch.uint8).to(torch.int16)
    both = torch.stack([u & 0x0F, (u >> 4) & 0x0F], dim=-1)
    both = (both ^ 8) - 8
    return both.reshape(both.shape[:-2] + (-1,))[..., :length].to(torch.int8)


def bucket_block(d_tot: int, block: int, chunk: int) -> Tuple[int, int]:
    """``(blk, nb)`` of the bucketed physical-wire layout: the whole server
    tree flattened to ``d_tot`` elements and cut into ``nb`` blocks of
    ``blk`` elements, ``blk`` being ``min(block, d_tot)`` rounded up to a
    multiple of ``lcm(chunk, 2)`` (no chunk crosses a block; packed int4
    blocks are whole bytes)."""
    d_tot = max(int(d_tot), 1)
    unit = chunk if chunk % 2 == 0 else 2 * chunk
    blk = -(-min(block, d_tot) // unit) * unit
    return blk, -(-d_tot // blk)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche on uint32 values held in int64 (in place)."""
    x.bitwise_xor_(x >> 16).mul_(0x85EBCA6B).bitwise_and_(_MASK32)
    x.bitwise_xor_(x >> 13).mul_(0xC2B2AE35).bitwise_and_(_MASK32)
    return x.bitwise_xor_(x >> 16)


def wire_dither(key, n: int, *, leaf: int, rnd: int, server: int,
                block: int, start: int = 0, stop: Optional[int] = None,
                out: Optional[torch.Tensor] = None,
                device: Any = "cpu") -> torch.Tensor:
    """THE stochastic-rounding dither of the wire: uniform [0, 1) noise of
    the ``n``-element cell ``(leaf, rnd, server, block)``, element ``e``
    being ``(_mix32(((e ^ k1) * 0x9E3779B9) ^ k0) >> 8) * 2^-24`` with
    ``(k0, k1)`` the cell's key data.  Bitwise ``repro.comm.compressors.
    wire_dither(key, (n,), ...)``; ``key`` is threefry key data
    (``comm.prng``).  ``[start, stop)`` selects a column range of the cell
    (chunks are independent, so a slab of a row is exact); ``out`` receives
    it in place.  The hash runs in int64 masked to 32 bits, in column blocks
    of 2^24."""
    stop = n if stop is None else stop
    for data in (leaf, rnd, server, block):
        key = prng.fold_in(key, data)
    k0, k1 = int(key[0]), int(key[1])
    if out is None:
        out = torch.empty(stop - start, dtype=torch.float32, device=device)
    scale = torch.tensor(2.0 ** -24, dtype=torch.float32, device=out.device)
    for lo in range(start, stop, _DITHER_COLS):
        hi = min(stop, lo + _DITHER_COLS)
        x = torch.arange(lo, hi, dtype=torch.int64, device=out.device)
        x.bitwise_xor_(k1).mul_(0x9E3779B9).bitwise_and_(_MASK32)
        x = _mix32(x.bitwise_xor_(k0))
        torch.mul((x >> 8).to(torch.float32), scale,
                  out=out[lo - start:hi - start])
    return out


# ---------------------------------------------------------------------------
# counter-based O(k) index sampling (random-k at LM scale)
# ---------------------------------------------------------------------------


def keyed_index_sample(key, d: int, k: int, *,
                       device: Any = "cpu") -> torch.Tensor:
    """``k`` distinct indices in ``[0, d)`` in O(k) work, bitwise the
    reference's: the counters ``0..k-1`` encrypted by a keyed 4-round
    Feistel bijection over the smallest even-bit power-of-two domain
    ``>= d`` (round keys ``jax.random.bits(key, (4,), uint32)``), values
    outside ``[0, d)`` walked back through the cipher until they land.
    ``d`` is capped at ``2^31 - 1`` as in the reference (uint32 cipher,
    int32 indices).  Returns a (k,) int32 tensor."""
    if not 0 < k <= d:
        raise ValueError(f"need 0 < k <= d, got k={k}, d={d}")
    if d > np.iinfo(np.int32).max:
        raise ValueError(
            f"keyed_index_sample is 32-bit (uint32 cipher, int32 gather "
            f"indices): d={d} exceeds 2^31 - 1 and would silently alias "
            f"coordinates")
    half = max(1, -(-max(d - 1, 1).bit_length() // 2))    # ceil(bits/2)
    mask = (1 << half) - 1
    round_keys = [int(b) for b in prng.random_bits(key, (4,))]

    def feistel(x):
        left, right = x >> half, x & mask
        for rk in round_keys:
            left, right = right, left ^ (_mix32(right ^ rk) & mask)
        return (left << half) | right

    idx = feistel(torch.arange(k, dtype=torch.int64, device=device))
    while True:     # cycle-walk: the cipher is a bijection, so this ends
        outside = (idx >= d).nonzero().squeeze(1)
        if outside.numel() == 0:
            return idx.to(torch.int32)
        idx[outside] = feistel(idx[outside])


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------


class Compressed(NamedTuple):
    """On-wire representation of one compressed message batch: ``data``
    (codes or values), ``scale`` (per-chunk, quantizers only), ``idx``
    (sparsifiers only)."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: a compress/decompress pair + metadata-derived wire bytes.
    ``wire_bits_data`` is the on-wire width of one ``data`` element;
    ``shape_preserving`` compressors chunk a leaf's last axis in its natural
    layout."""

    wire_bits_data = 32
    idx_on_wire = True
    shape_preserving = False

    name = "?"

    def compress(self, x: torch.Tensor, key=None) -> Compressed:
        raise NotImplementedError

    def decompress(self, comp: Compressed, d: int) -> torch.Tensor:
        raise NotImplementedError

    def roundtrip(self, x: torch.Tensor, key=None) -> torch.Tensor:
        """What the receivers reconstruct: D(C(x)), in ``x``'s dtype."""
        return self.decompress(self.compress(x, key),
                               x.shape[-1]).to(x.dtype)

    def residual(self, corrected: torch.Tensor,
                 msg: torch.Tensor) -> torch.Tensor:
        """Error feedback's new residual: what ``msg`` left of
        ``corrected``."""
        return corrected - msg

    def wire_bytes_per_row(self, d: int) -> int:
        """On-wire bytes of ONE server's compressed d-element message."""
        return self.wire_bytes_per_leaf((1, d))

    def wire_bytes_per_leaf(self, shape) -> int:
        """Bytes of one server's compressed message for a leaf of ``shape``
        (leading axis = server), read off the payload of compressing a
        meta-device tensor of that shape — payload metadata, not a closed
        form (``comm.accounting.analytic_leaf_bytes`` is the closed form)."""
        shape = tuple(shape)
        if not self.shape_preserving:
            shape = (1, int(np.prod(shape[1:])))
        else:
            shape = (1,) + shape[1:]
        comp = self.compress(torch.empty(shape, device="meta"),
                             key=prng.key(0))
        total = int(np.ceil(comp.data.numel() * self.wire_bits_data / 8))
        if comp.scale is not None:
            total += comp.scale.numel() * comp.scale.element_size()
        if comp.idx is not None and self.idx_on_wire:
            total += comp.idx.numel() * comp.idx.element_size()
        return total


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    """Exact passthrough — the float32-wire baseline of the accounting."""

    name = "identity"
    shape_preserving = True

    def compress(self, x, key=None):
        del key
        return Compressed(data=x)

    def decompress(self, comp, d):
        return comp.data[..., :d]


@dataclasses.dataclass(frozen=True)
class StochasticQuantizer(Compressor):
    """int8/int4 quantization with per-chunk absmax scales over the LAST
    axis (the last chunk may be partial): ``s_c = absmax_c * f32(1/qmax)``
    (1 for an all-zero chunk) and codes ``clip(floor(x * (1/s_c) + u),
    -qmax, qmax)`` with the multiply-add fused (one rounding), as the
    reference's jitted encoders round it.  ``u`` is the wire dither; without
    one the rounding is deterministic (u = 0.5).  int4 codes ride in int8
    tensors and count 4 bits on the wire."""

    bits: int = 8
    chunk: int = 256

    shape_preserving = True

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")

    @property
    def name(self):
        return f"int{self.bits}"

    @property
    def wire_bits_data(self):
        return self.bits

    @property
    def qmax(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def _per_elem(self, scale: torch.Tensor, d: int) -> torch.Tensor:
        """(..., nc) chunk scales broadcast onto the d real elements."""
        return torch.repeat_interleave(scale, self.chunk, dim=-1)[..., :d]

    def compress(self, x, key=None, *, dither=None):
        if dither is None:
            # a meta tensor (the byte ledger's shapes) needs no draw: the
            # payload's shapes do not depend on the dither
            dither = (0.5 if key is None or x.is_meta
                      else prng.uniform(key, tuple(x.shape), device=x.device))
        d = x.shape[-1]
        x32 = x.float().reshape(-1, d)
        u = torch.as_tensor(dither, dtype=torch.float32, device=x.device)
        u = u.expand(x.shape).reshape(-1, d)
        nc = -(-d // self.chunk)
        pad = nc * self.chunk - d
        if pad:     # zeros never raise an absmax and code to 0
            x32 = torch.nn.functional.pad(x32, (0, pad))
            u = torch.nn.functional.pad(u, (0, pad))
        q, scale = _ref.wire_encode(x32, u, bits=self.bits, chunk=self.chunk)
        return Compressed(data=q[:, :d].reshape(x.shape),
                          scale=scale.reshape(x.shape[:-1] + (nc,)))

    def decompress(self, comp, d):
        scale = self._per_elem(comp.scale, d)
        return comp.data[..., :d].float() * scale

    # -- the simulated wire: kernel 4 -----------------------------------------
    def roundtrip(self, x, key=None):
        """``D(C(x))`` with the dither ``prng.uniform(key, x.shape)`` (0.5
        without a key), through kernel 4 with A = I."""
        return self.mix(x, key)

    def mix(self, x: torch.Tensor, key=None,
            a: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``a · D(C(x))`` over the leading (server) axis of ``x`` (``a``
        None: ``D(C(x))`` itself), in ``x``'s layout and dtype, through one
        launch of kernel 4 (``ops.quantized_consensus_mix``).

        The last axis (``n`` elements a row) is chunked as the reference
        chunks it: the kernel's chunk is ``n`` when ``n <= chunk``, else
        ``chunk`` with each row zero-padded to a multiple of it (a zero
        never raises an absmax, codes to ``floor(0 + u) = 0`` and mixes to
        0), so that no chunk crosses a row.  The kernel then sees the leaf
        as (M, rows * n_pad) rows to mix, or, with ``a`` None, as one row.
        The dither's real elements are the reference's
        ``jax.random.uniform(key, x.shape)``; its pad columns are 0.  A 1-D
        leaf (one value a server) is chunked across the servers, as in the
        reference: it is decoded as one row, then mixed by kernel 1."""
        n = x.shape[-1] if x.dim() else 1
        rows = x.numel() // max(n, 1)
        kc = n if n <= self.chunk else self.chunk
        n_pad = -(-n // kc) * kc
        one_row = a is None or x.dim() < 2
        lead = 1 if one_row else x.shape[0]
        w = x.float().reshape(rows, n)
        if n_pad != n:
            w = torch.nn.functional.pad(w, (0, n_pad - n))
        u = torch.zeros((rows, n_pad), dtype=torch.float32, device=x.device)
        if key is None:
            u[:, :n] = 0.5
        else:
            prng.uniform(key, (rows, n), out=u[:, :n])
        eye = torch.ones((1, 1), dtype=torch.float32, device=x.device)
        out = _ops.quantized_consensus_mix(
            eye if one_row else a, w.view(lead, -1), u.view(lead, -1),
            bits=self.bits, chunk=kc, out=u.view(lead, -1))
        y = out.view(rows, n_pad)[:, :n].reshape(x.shape)
        if a is not None and one_row:
            y = _ops.consensus_mix(a, y.reshape(x.shape[0], -1)).reshape(
                x.shape)
        return y.to(x.dtype)

    def residual(self, corrected: torch.Tensor, msg: torch.Tensor,
                 step: int = 1 << 22) -> torch.Tensor:
        """Error feedback's new residual ``corrected - msg``, rounded as the
        reference's jitted ``ef_roundtrip`` rounds it: XLA fuses the
        decode's product into the subtraction, ``fma(-q, s, corrected)``,
        except where a row is longer than a chunk and not a multiple of it
        (the rows ``mix`` pads), where it subtracts the rounded ``msg``.
        The codes are read back off ``msg`` (``q = rint(msg / s)``, exact
        for |q| <= 127), in row blocks of about ``step`` elements.  A leaf of
        another dtype than f32 subtracts the message as it was rounded to
        that dtype."""
        n = corrected.shape[-1] if corrected.dim() else 1
        if (n > self.chunk and n % self.chunk) or \
                corrected.dtype != torch.float32:
            return corrected - msg
        kc = min(n, self.chunk)
        c2, m2 = corrected.reshape(-1, n), msg.reshape(-1, n)
        out = torch.empty_like(c2)
        rq = torch.tensor(1.0 / self.qmax, dtype=torch.float32,
                          device=c2.device)
        stride = max(1, step // n)
        for r0 in range(0, c2.shape[0], stride):
            c3 = c2[r0:r0 + stride].reshape(-1, n // kc, kc)
            absmax = c3.abs().amax(dim=-1, keepdim=True)
            s = torch.where(absmax > 0, absmax * rq, torch.ones_like(absmax))
            s = s.expand_as(c3)
            q = torch.round(m2[r0:r0 + stride].reshape(c3.shape) / s)
            out[r0:r0 + stride] = _ref.fma(-q, s, c3).reshape(-1, n)
        return out.reshape(corrected.shape)

    # -- the wire codec (the physical wire's byte layout) --------------------
    def encode_block(self, x: torch.Tensor, dither) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
        """``(codes, scales)`` of a block as it crosses the wire: int8 codes
        (for ``bits=4`` packed two per byte) and one f32 scale per chunk."""
        comp = self.compress(x, dither=dither)
        codes = pack_int4(comp.data) if self.bits == 4 else comp.data
        return codes, comp.scale

    def decode_block(self, codes: torch.Tensor, scales: torch.Tensor,
                     length: int) -> torch.Tensor:
        """Invert ``encode_block``: unpack (int4) and dequantize to f32."""
        q = unpack_int4(codes, length) if self.bits == 4 else codes
        return self.decompress(Compressed(data=q, scale=scales), length)

    def code_chunks(self, codes: torch.Tensor, length: int) -> torch.Tensor:
        """Unpacked codes as f32 in per-chunk layout ``(..., nc, chunk)``;
        ``length`` must be a chunk multiple."""
        if length % self.chunk:
            raise ValueError(
                f"code_chunks needs a chunk-multiple length, got {length} "
                f"with chunk={self.chunk}")
        q = unpack_int4(codes, length) if self.bits == 4 else codes
        return q.float().reshape(q.shape[:-1]
                                 + (length // self.chunk, self.chunk))

    def wire_block_bytes(self, length: int) -> Tuple[int, int]:
        """(code bytes, scale bytes) of one encoded ``length``-element
        block."""
        nc = -(-length // self.chunk)
        code_bytes = -(-length // 2) if self.bits == 4 else length
        return code_bytes, 4 * nc


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Per-row magnitude top-k: each server keeps its ``k = max(1,
    round(ratio * d))`` largest-|.| coordinates; values and int32 indices
    cross the wire.  Ties rank as ``torch.topk`` ranks them, which need not
    be ``jax.lax.top_k``'s order."""

    ratio: float = 0.05

    name = "top_k"

    def __post_init__(self):
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"top_k ratio must be in (0, 1], got {self.ratio}")

    def k_for(self, d: int) -> int:
        return max(1, min(d, int(round(self.ratio * d))))

    def compress(self, x, key=None):
        del key
        idx = torch.topk(x.abs(), self.k_for(x.shape[1]), dim=1).indices
        return Compressed(data=torch.gather(x, 1, idx),
                          idx=idx.to(torch.int32))

    def decompress(self, comp, d):
        out = torch.zeros((comp.data.shape[0], d), dtype=torch.float32,
                          device=comp.data.device)
        return out.scatter_(1, comp.idx.long(), comp.data.float())


@dataclasses.dataclass(frozen=True)
class RandomKCompressor(Compressor):
    """Seed-coordinated random-k: ONE coordinate set per call, drawn from
    the shared key by ``keyed_index_sample`` and used by every server, so
    only the values cross the wire.  Unscaled (no d/k), as the reference."""

    ratio: float = 0.05

    name = "random_k"
    idx_on_wire = False

    def __post_init__(self):
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(
                f"random_k ratio must be in (0, 1], got {self.ratio}")

    def k_for(self, d: int) -> int:
        return max(1, min(d, int(round(self.ratio * d))))

    def compress(self, x, key=None):
        if key is None:
            raise ValueError("random_k needs the shared rng key (the "
                             "coordinate set IS the seed)")
        d = x.shape[1]
        k = self.k_for(d)
        if x.is_meta:
            idx = torch.empty((k,), dtype=torch.int32, device="meta")
        else:
            idx = keyed_index_sample(key, d, k, device=x.device)
        return Compressed(data=x[:, idx.long()], idx=idx)

    def decompress(self, comp, d):
        out = torch.zeros((comp.data.shape[0], d), dtype=torch.float32,
                          device=comp.data.device)
        out[:, comp.idx.long()] = comp.data.float()
        return out


def make_compressor(spec: str) -> Compressor:
    """Parse a compression spec.  ``"none"`` raises ``ValueError``: it means
    no compression layer at all, not an identity compressor."""
    s = spec.strip()
    if s in ("none", ""):
        raise ValueError("compression='none' disables the layer; there is "
                         "no compressor to build")
    head, _, arg = s.partition(":")
    if head in ("int8", "int4"):
        chunk = int(arg) if arg else 256
        return StochasticQuantizer(bits=int(head[3:]), chunk=chunk)
    if head in ("top_k", "random_k"):
        if not arg:
            raise ValueError(f"{head} needs a keep ratio, e.g. '{head}:0.05'")
        cls = TopKCompressor if head == "top_k" else RandomKCompressor
        return cls(ratio=float(arg))
    if head == "identity":
        return IdentityCompressor()
    raise ValueError(f"unknown compression spec {spec!r}; expected none | "
                     f"int8[:chunk] | int4[:chunk] | top_k:ratio | "
                     f"random_k:ratio")


# ---------------------------------------------------------------------------
# pytree helpers over the (M, d) row layout
# ---------------------------------------------------------------------------


def roundtrip_tree(compressor: Compressor, tree: Any, key=None) -> Any:
    """The simulated wire's round trip of a server tree (leaves ``(M, *w)``):
    what every receiver reconstructs.  Leaf ``i`` (JAX's sorted leaf order)
    is keyed by ``prng.fold_in(key, i)``.  Shape-preserving compressors
    (identity, the quantizers) work in each leaf's natural layout, the
    quantizers through kernel 4; top-k and random-k flatten it to (M, d)."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for i, leaf in enumerate(leaves):
        k = prng.fold_in(key, i) if key is not None else None
        if compressor.shape_preserving:
            out.append(compressor.roundtrip(leaf, k))
            continue
        x = leaf.reshape(leaf.shape[0], -1)
        out.append(compressor.roundtrip(x, k).reshape(leaf.shape))
    return tree_unflatten(treedef, out)


def tree_message_elems(tree: Any) -> int:
    """Elements of ONE server's message: the sum over leaves of everything
    behind the leading server axis (leaves may be tensors or shapes'
    holders with ``.shape``)."""
    return sum(int(np.prod(tuple(leaf.shape)[1:])) for leaf in
               tree_leaves(tree))


def tree_wire_bytes_per_server(compressor: Compressor, tree: Any) -> int:
    """On-wire bytes of one server's whole compressed message on the
    simulated wire: ``wire_bytes_per_leaf`` summed over the leaves (chunking
    and top-k rounding apply per leaf, and per leaf row for the
    quantizers); leaves need only ``.shape``."""
    return sum(compressor.wire_bytes_per_leaf(leaf.shape)
               for leaf in tree_leaves(tree))
