"""Plain PyTorch versions of the port's kernels.

The wrappers in ``repro_torch.kernels.ops`` run these for CPU tensors; the
CPU tests hold them against the JAX package (its Pallas kernels in
interpret mode and ``repro.kernels.ref``), and ``chip_smoke.py`` holds each
Hopper kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def consensus_mix_ref(a_eff: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """W <- A_eff W.  a_eff: (M, M); w: (M, D); f32 contraction, W's dtype."""
    return torch.einsum("ij,jd->id", a_eff.float(), w.float()).to(w.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, reduced in
    f32, returned in x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """Closed-form backward of ``rmsnorm_ref`` for x (rows, d), the formula
    the CUDA backward computes: with ``r = rsqrt(mean(x^2) + eps)``,

        dx     = r * (g * s) - x * r^3 * mean(g * s * x)
        dscale = sum_rows g * x * r

    Returns ``(dx in x's dtype, dscale in scale's dtype)``."""
    xf, gf, sf = x.float(), g.float(), scale.float()
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    gs = gf * sf
    dx = r * gs - xf * r ** 3 * torch.mean(gs * xf, dim=-1, keepdim=True)
    dscale = torch.sum(gf * xf * r, dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive GQA attention.  q: (b, sq, h, hd); k/v: (b, sk, kvh, hd) ->
    (b, sq, h, hd) in q's dtype, scores and softmax in f32.

    Queries sit at the END of the keys: query i has position
    ``i + sk - sq``; ``causal`` lets it see keys j <= that position and
    ``window`` only keys j > position - window.  ``softcap`` caps the scores
    as ``softcap * tanh(s / softcap)``; ``scale`` defaults to
    ``1/sqrt(hd)``.  A row that sees no key at all is **0**, as the TPU
    kernel's ``l == 0`` guard makes it (``repro.kernels.ref.attention_ref``
    averages v over such a row instead; the two agree on every other row).
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# mamba2 / SSD scan (kernel 9)
# ---------------------------------------------------------------------------


def ssd_scan_ref(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
                 dt: torch.Tensor, a_coef: torch.Tensor):
    """Naive per-timestep SSM recurrence (the definition, O(s) sequential):

        h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t'
        y_t = C_t . h_t

    xs: (b, s, nh, hd); bs/cs: (b, s, 1, ds); dt: (b, s, nh); a_coef:
    (nh,) negative.  Returns (y (b, s, nh, hd) f32, state (b, nh, ds, hd)
    f32).  The tests' oracle; the model never calls it."""
    bsz, s, nh, hd = xs.shape
    ds = bs.shape[-1]
    a = a_coef.float()
    h = torch.zeros((bsz, nh, ds, hd), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(s):
        x_t = xs[:, t].float()                       # (b, nh, hd)
        b_t = bs[:, t, 0].float()                    # (b, ds)
        c_t = cs[:, t, 0].float()
        dt_t = dt[:, t].float()                      # (b, nh)
        decay = torch.exp(dt_t * a)
        upd = torch.einsum("bn,bhp->bhnp", b_t, x_t * dt_t[..., None])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c_t, h))
    return torch.stack(ys, dim=1), h


def ssd_scan_chunked_ref(xs: torch.Tensor, bs: torch.Tensor,
                         cs: torch.Tensor, dt: torch.Tensor,
                         a_coef: torch.Tensor, *, chunk: int):
    """Kernel 9's plain version: what the TPU kernel's body computes, for
    every (batch, head) at once, over chunks of ``q = min(chunk, s)`` steps
    with a running state ``h`` (ds, hd) per (batch, head):

        cum   = cumsum(dt * A) over the chunk (inclusive), total = cum[-1]
        y     = (C B' * where(k <= q, exp(cum_q - cum_k), 0) * dt_k) x
                + exp(cum) * (C h)
        h    <- exp(total) h + sum_k (B_k * exp(total - cum_k) dt_k) x_k'

    Takes the model layout: xs (b, s, nh, hd), bs/cs (b, s, 1, ds) (group 0
    read for every head), dt (b, s, nh), a_coef (nh,); any float dtype,
    computed in f32.  Steps past ``s`` in the last chunk are zeros with
    dt = 0 (decay 1, no input), as the TPU kernel masks its ragged tail.
    Returns (y (b, s, nh, hd) f32, final state (b, nh, ds, hd) f32)."""
    bsz, s, nh, hd = xs.shape
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    x = xs.float()
    bb = bs[:, :, 0].float()
    cc = cs[:, :, 0].float()
    dtf = dt.float()
    if pad:
        x, bb, cc, dtf = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, bb, cc, dtf))
    a = a_coef.float()
    tri = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    h = torch.zeros((bsz, nh, bb.shape[-1], hd), dtype=torch.float32,
                    device=xs.device)
    ys = []
    for c in range(nc):
        rows = slice(c * q, (c + 1) * q)
        xc, bc, c_c, dtc = x[:, rows], bb[:, rows], cc[:, rows], dtf[:, rows]
        cum = torch.cumsum(dtc * a, dim=1)                      # (b, q, nh)
        total = cum[:, -1]                                      # (b, nh)
        seg = cum[:, :, None] - cum[:, None]                    # (b, q, k, nh)
        l_mat = torch.where(tri[..., None], torch.exp(seg),
                            torch.zeros((), device=xs.device))
        scores = torch.einsum("bqn,bkn->bqk", c_c, bc)[..., None]
        scores = scores * l_mat * dtc[:, None]                  # (b, q, k, nh)
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xc)
        ch = torch.einsum("bqn,bhnp->bqhp", c_c, h)
        y = y + torch.exp(cum)[..., None] * ch
        w = torch.exp(total[:, None] - cum) * dtc               # (b, q, nh)
        upd = torch.einsum("bkhn,bkhp->bhnp", bc[:, :, None] * w[..., None],
                           xc)
        h = torch.exp(total)[..., None, None] * h + upd
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def ssd_scan_passes_ref(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
                        dt: torch.Tensor, a_coef: torch.Tensor, *,
                        chunk: int):
    """Kernel 9's algebra, pass by pass, in plain PyTorch (used by tests
    only: the CUDA kernel's plain version is ``ssd_scan_chunked_ref``).
    Takes and returns what ``ssd_scan_chunked_ref`` does.

    (a) cum: the in-chunk prefix of dt * A, each step rounded and added in
        order in f32, carried past s (dt = 0 there);
    (b) C.B' once per (batch, chunk), shared by every head;
    (c) each chunk's state contribution sum_k (B_k exp(total - cum_k) dt_k)
        x_k';
    (d) the state entering each chunk, h_c = exp(total_{c-1}) h_{c-1} +
        S_{c-1}, and the final state;
    (e) y per tile of 64 queries t0.. (the kernel's), r = t0 - 1: the state
        term exp(cum_r) C.h and the keys before the tile, C.B' exp(cum_r -
        cum_k) dt_k x_k, both scaled by exp(cum_t - cum_r); then the tile's
        own band, C.B' exp(cum_t - cum_k) dt_k x_k where k <= t and 0
        selected elsewhere."""
    bsz, s, nh, hd = xs.shape
    ds = bs.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    x, bb, cc, dtf = xs.float(), bs[:, :, 0].float(), cs[:, :, 0].float(), \
        dt.float()
    if pad:
        x, bb, cc, dtf = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, bb, cc, dtf))
    xc = x.reshape(bsz, nc, q, nh, hd)
    bc, ccc = bb.reshape(bsz, nc, q, ds), cc.reshape(bsz, nc, q, ds)
    dtc = dtf.reshape(bsz, nc, q, nh)
    a = a_coef.float()
    # (a)
    steps, run = [], torch.zeros((bsz, nc, nh), dtype=torch.float32,
                                 device=xs.device)
    for t in range(q):
        run = run + dtc[:, :, t] * a
        steps.append(run)
    cum = torch.stack(steps, dim=2)                          # (b, nc, q, nh)
    total = cum[:, :, -1]
    # (b)
    cb = torch.einsum("bctn,bckn->bctk", ccc, bc)            # (b, nc, q, q)
    # (c)
    w = torch.exp(total[:, :, None] - cum) * dtc
    st = torch.einsum("bckn,bckh,bckhp->bchnp", bc, w, xc)  # b, nc, nh, ds, hd
    # (d)
    h = torch.zeros((bsz, nh, ds, hd), dtype=torch.float32, device=xs.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + st[:, c]
    h_in = torch.stack(h_in, dim=1)                         # b, nc, nh, ds, hd
    # (e)
    y = torch.empty((bsz, nc, q, nh, hd), dtype=torch.float32,
                    device=xs.device)
    for t0 in range(0, q, 64):
        t1 = min(t0 + 64, q)
        cum_r = cum[:, :, t0 - 1] if t0 else torch.zeros_like(total)
        acc = torch.einsum("bctn,bchnp->bcthp", ccc[:, :, t0:t1], h_in) \
            * torch.exp(cum_r)[:, :, None, :, None]
        colf = torch.exp(cum_r[:, :, None] - cum[:, :, :t0]) * dtc[:, :, :t0]
        acc = acc + torch.einsum("bctk,bckh,bckhp->bcthp",
                                 cb[:, :, t0:t1, :t0], colf, xc[:, :, :t0])
        acc = acc * torch.exp(cum[:, :, t0:t1] - cum_r[:, :, None])[..., None]
        seg = cum[:, :, t0:t1, None] - cum[:, :, None, t0:t1]  # (b,nc,t,k,nh)
        band = torch.ones((t1 - t0, t1 - t0), dtype=torch.bool,
                          device=xs.device).tril()
        decay = torch.where(band[..., None], torch.exp(seg),
                            torch.zeros((), device=xs.device))
        y[:, :, t0:t1] = acc + torch.einsum(
            "bctk,bctkh,bckh,bckhp->bcthp", cb[:, :, t0:t1, t0:t1], decay,
            dtc[:, :, t0:t1], xc[:, :, t0:t1])
    return y.reshape(bsz, nc * q, nh, hd)[:, :s], h


# ---------------------------------------------------------------------------
# the physical wire: kernels 5-8 (quantized, delta-coded gossip)
#
# The reference runs these steps under jit, where XLA:CPU contracts some
# multiply-adds into fused multiply-adds (one rounding) and leaves others
# apart (two roundings).  Codes are integers read off ``floor``, so one
# rounding more or less moves a code by one step: each multiply-add below
# states which form it takes, and the CUDA kernels use the same form
# (``__fmaf_rn`` for ``fma``, ``__fmul_rn``/``__fadd_rn`` otherwise).
# ---------------------------------------------------------------------------


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with ONE rounding (IEEE fusedMultiplyAdd),
    computed exactly in float64: the product of two float32 values is exact
    there, the sum is rounded to odd (``s`` plus the sign of the TwoSum
    error in the last bit), and one cast to float32 then rounds correctly.
    Plain PyTorch has no fused multiply-add of its own that is sure to
    fuse."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)
    bits = torch.where(odd, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).float()


def _qmax(bits: int) -> float:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return float(2 ** (bits - 1) - 1)


def _chunked(x: torch.Tensor, chunk: int) -> torch.Tensor:
    m, d = x.shape
    if d % chunk:
        raise ValueError(f"chunk={chunk} must divide D={d} (pad the wire "
                         f"buffer to the bucket grid first, as the gossip "
                         f"paths do)")
    return x.reshape(m, d // chunk, chunk)


def wire_encode(delta: torch.Tensor, dither: torch.Tensor, *, bits: int,
                chunk: int):
    """``C(delta; dither)``: per-chunk absmax scales
    ``where(absmax > 0, absmax * f32(1/qmax), 1)`` and codes
    ``clip(floor(fma(delta, 1/scale, u)), -qmax, qmax)`` (XLA contracts the
    multiply-add; ``1/scale`` is a true division).  Returns ``(codes (M, D)
    int8, scales (M, D/chunk) f32)``."""
    qmax = _qmax(bits)
    d3 = _chunked(delta, chunk)
    absmax = d3.abs().amax(dim=-1)
    one = torch.ones((), dtype=torch.float32, device=delta.device)
    scale = torch.where(absmax > 0, absmax * torch.tensor(
        1.0 / qmax, dtype=torch.float32, device=delta.device), one)
    inv = (one / scale)[..., None].expand_as(d3)
    q = torch.floor(fma(d3, inv, _chunked(dither, chunk)))
    return (torch.clamp(q, -qmax, qmax).to(torch.int8)
            .reshape(delta.shape), scale)


def quantized_consensus_mix_ref(a: torch.Tensor, w: torch.Tensor,
                                dither: torch.Tensor, *, bits: int = 8,
                                chunk: int = 256) -> torch.Tensor:
    """Kernel 4: ``A · D(C(w; dither))`` -- the simulated wire's round trip
    and one mix in one pass::

        codes, s = C(w; dither)               (``wire_encode``: fused encode)
        deq      = codes * s                  (one rounding)
        out[i]   = fma(a[i,j], deq[j], out[i])  for j = 0 .. M-1, out = +0

    With ``a = I`` every product is by 1 or 0 and every sum with 0, so the
    chain is exact: ``out`` is ``D(C(w))`` itself.  Returns (M, D) f32."""
    codes, scale = wire_encode(w.float(), dither, bits=bits, chunk=chunk)
    deq = (_chunked(codes.float(), chunk) * scale[..., None]).reshape(
        w.shape)
    a = a.to(device=w.device, dtype=torch.float32)
    out = torch.zeros_like(deq)
    for j in range(deq.shape[0]):
        out = fma(a[:, j:j + 1].expand_as(deq), deq[j:j + 1].expand_as(deq),
                  out)
    return out


def quantized_gossip_encode_ref(w: torch.Tensor, ref: torch.Tensor,
                                dither: torch.Tensor, *, bits: int = 8,
                                chunk: int = 256):
    """Kernel 6: ``C(w - ref; dither)`` -> ``(codes, scales)``."""
    return wire_encode(w.float() - ref, dither, bits=bits, chunk=chunk)


def bucketed_gossip_round_ref(a: torch.Tensor, codes: torch.Tensor,
                              scales: torch.Tensor, ref: torch.Tensor,
                              acc: torch.Tensor, dither: torch.Tensor, *,
                              bits: int = 8, chunk: int = 256):
    """Kernel 7, in the order of the bucketed wire that users run
    (``gossip_scan_wire_bucketed``'s synchronous body)::

        ref'  = fma(c, s, ref)                     (own decoded delta)
        acc'  = fma(a[i,j] * s[j], c[j], acc')     for j = 0 .. M-1
        codes', scales' = C(acc' - ref'; dither)

    The TPU kernel multiplies ``a[i,j] * (c s)[j]`` instead; the two agree
    when ``a`` is dyadic.  Returns ``(acc', ref', codes', scales')``."""
    return bucketed_gossip_round_rows_ref(a, codes, scales, ref, acc, dither,
                                          row0=0, bits=bits, chunk=chunk)


def bucketed_gossip_round_rows_ref(a: torch.Tensor, codes: torch.Tensor,
                                   scales: torch.Tensor, ref: torch.Tensor,
                                   acc: torch.Tensor, dither: torch.Tensor,
                                   *, row0: int, bits: int = 8,
                                   chunk: int = 256):
    """Kernel 7's row form: the rows ``row0 .. row0 + M_out - 1`` of the
    square round.  ``a`` is those rows of A, (M_out, M); ``codes`` and
    ``scales`` are all M gathered rows; ``ref``, ``acc`` and ``dither``
    have M_out rows.  Returns ``(acc', ref', codes', scales')`` of the own
    rows, each element computed as in the square round."""
    m, m_out = codes.shape[0], ref.shape[0]
    c3 = _chunked(codes.float(), chunk)
    own = slice(row0, row0 + m_out)
    s3 = scales[own][..., None].expand_as(c3[own])
    ref = fma(c3[own], s3, _chunked(ref, chunk)).reshape(ref.shape)
    ws = a.float()[:, :, None] * scales[None]          # ws[i, j] = a_ij s_j
    acc3 = _chunked(acc, chunk)
    for j in range(m):
        acc3 = fma(ws[:, j, :, None].expand_as(acc3),
                   c3[j][None].expand_as(acc3), acc3)
    acc = acc3.reshape(acc.shape)
    codes, scales = wire_encode(acc - ref, dither, bits=bits, chunk=chunk)
    return acc, ref, codes, scales


def bucketed_gossip_round_pipelined_ref(a: torch.Tensor, codes: torch.Tensor,
                                        scales: torch.Tensor, w: torch.Tensor,
                                        ref: torch.Tensor, acc: torch.Tensor,
                                        dither: torch.Tensor, *,
                                        bits: int = 8, chunk: int = 256):
    """Kernel 8, one round of the bounded-staleness wire::

        codes', scales' = C(w - ref; dither)       (what this round ships)
        ref'  = fma(codes', scales', ref)          (own decode, local codes)
        acc'  = fma(a[i,j] * s[j], c[j], acc')     over the DELAYED codes

    Returns ``(acc', ref', codes', scales')``.  The row form is the same
    function with ``a`` (M_out, M), the delayed ``codes`` and ``scales`` of
    all M rows and the other operands of the M_out own rows."""
    m = codes.shape[0]
    new_c, new_s = wire_encode(w.float() - ref, dither, bits=bits,
                               chunk=chunk)
    n3 = _chunked(new_c.float(), chunk)
    ref = fma(n3, new_s[..., None].expand_as(n3),
              _chunked(ref, chunk)).reshape(ref.shape)
    c3 = _chunked(codes.float(), chunk)
    ws = a.float()[:, :, None] * scales[None]
    acc3 = _chunked(acc, chunk)
    for j in range(m):
        acc3 = fma(ws[:, j, :, None].expand_as(acc3),
                   c3[j][None].expand_as(acc3), acc3)
    return acc3.reshape(acc.shape), ref, new_c, new_s


def quantized_gossip_round_ref(a: torch.Tensor, codes: torch.Tensor,
                               scales: torch.Tensor, ref: torch.Tensor,
                               dither: torch.Tensor, *, bits: int = 8,
                               chunk: int = 256):
    """Kernel 5, one round of the per-leaf wire::

        ref'   = fma(c, s, ref)                    (every sender's reference)
        mixed  = fma(a[:,0], ref'[0], a[:,1] * ref'[1]), then
                 fma(a[:,j], ref'[j], mixed) for j = 2 .. M-1
        codes', scales' = C(mixed - ref'; dither)

    Returns ``(mixed, ref', codes', scales')``."""
    c3 = _chunked(codes.float(), chunk)
    ref = fma(c3, scales[..., None].expand_as(c3),
              _chunked(ref, chunk)).reshape(ref.shape)
    mixed = wire_mix_rows(a, ref)
    codes, scales = wire_encode(mixed - ref, dither, bits=bits, chunk=chunk)
    return mixed, ref, codes, scales


def wire_mix_rows(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_j a[i, j] * g[j]`` over the leading axis, rounded as
    the reference's jitted ``consensus._wire_mix_rows`` and the TPU kernel
    round it: ``fma(a[:,0], g[0], a[:,1] * g[1])``, then
    ``fma(a[:,j], g[j], out)`` left to right (``a[:,0] * g[0]`` at M = 1)."""
    m = g.shape[0]
    a = a.float()
    col = (-1,) + (1,) * (g.dim() - 1)

    def term(j):
        return a[:, j].reshape(col).expand(g.shape), g[j:j + 1].expand(g.shape)

    if m == 1:
        return torch.mul(*term(0))
    out = fma(*term(0), torch.mul(*term(1)))
    for j in range(2, m):
        out = fma(*term(j), out)
    return out
