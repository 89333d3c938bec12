"""Lossy compressors for inter-server gossip messages: port of
``repro.comm.compressors`` for the physical wire.

Every compressor is a ``compress``/``decompress`` pair over arrays whose
leading axis is the server (row i is server i's outgoing message).  The
physical wire (``core.consensus.CompressedBackend(wire="physical")``) uses
the quantizers as wire codecs: ``StochasticQuantizer.encode_block`` turns a
flattened block into the byte layout that crosses the wire — int8 codes
(two int4 codes packed per byte by ``pack_int4``) plus one f32 scale per
chunk — and ``decode_block`` inverts it.

The stochastic rounding's dither is ``wire_dither``: a keyed counter hash
(``_mix32``) over the element index, keyed by four threefry ``fold_in``s
(``comm.prng``) of the wire key — bitwise the reference's, so the port's
codes are the reference's codes.  The simulated wire's threefry
``jax.random.uniform`` dither, top-k, random-k and ``roundtrip_tree`` arrive
with the simulated-wire slice and raise ``NotImplementedError`` here.

Spec grammar of ``make_compressor``: ``none | int8[:CHUNK] | int4[:CHUNK] |
identity`` (``top_k:RATIO`` and ``random_k:RATIO`` are the next slice's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.kernels import ref as _ref
from repro_torch.tree import tree_leaves

SIMULATED_SLICE = ("the simulated wire (threefry uniform dither, top-k, "
                   "random-k, roundtrip_tree, ef_roundtrip) arrives with the "
                   "simulated-wire slice (ROADMAP.md, Queue 1)")

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
        comp = self.compress(torch.empty(shape, device="meta"))
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
            if key is not None:
                raise NotImplementedError(
                    "StochasticQuantizer.compress with a key draws a "
                    "threefry uniform dither: " + SIMULATED_SLICE)
            dither = 0.5
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


def make_compressor(spec: str) -> Compressor:
    """Parse a compression spec.  ``"none"`` raises ``ValueError`` (it means
    no compression layer at all); top-k and random-k raise
    ``NotImplementedError`` until the simulated-wire slice."""
    s = spec.strip()
    if s in ("none", ""):
        raise ValueError("compression='none' disables the layer; there is "
                         "no compressor to build")
    head, _, arg = s.partition(":")
    if head in ("int8", "int4"):
        chunk = int(arg) if arg else 256
        return StochasticQuantizer(bits=int(head[3:]), chunk=chunk)
    if head in ("top_k", "random_k"):
        raise NotImplementedError(f"compression {spec!r}: {SIMULATED_SLICE}")
    if head == "identity":
        return IdentityCompressor()
    raise ValueError(f"unknown compression spec {spec!r}; expected none | "
                     f"int8[:chunk] | int4[:chunk] | top_k:ratio | "
                     f"random_k:ratio")


# ---------------------------------------------------------------------------
# pytree helpers over the (M, d) row layout
# ---------------------------------------------------------------------------


def roundtrip_tree(compressor: Compressor, tree: Any, key=None) -> Any:
    """The simulated wire's once-per-period round-trip: not ported yet."""
    raise NotImplementedError(f"roundtrip_tree: {SIMULATED_SLICE}")


def tree_message_elems(tree: Any) -> int:
    """Elements of ONE server's message: the sum over leaves of everything
    behind the leading server axis (leaves may be tensors or shapes'
    holders with ``.shape``)."""
    return sum(int(np.prod(tuple(leaf.shape)[1:])) for leaf in
               tree_leaves(tree))
