"""Mamba2 (state-space duality) block: port of ``repro.models.mamba``.

Recurrence implemented (per head h, state dim n, head dim p):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t'
    y_t = C_t h_t + D * x_t

The full-sequence forward splits it into chunk-local quadratic products plus
a small inter-chunk state recurrence (the SSD form).  ``impl="reference"``
runs the plain chunked form ``ssd_chunked`` (differentiable);
``impl="kernel"`` runs ``kernels.ops.ssd_scan`` — kernel 9 on the card, its
plain version on the CPU — the reference's ``impl="pallas"``.  Unlike the
reference, whose ``mamba_prefill`` always calls ``ssd_chunked``, the port's
prefill takes the same ``impl``: the kernel returns the outputs and the
final state from one scan, which is what the prefill needs.

``softplus`` and ``silu`` follow JAX's definitions: ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` computes
``log1p(exp(x))`` and returns x itself above 20), ``jax.nn.silu`` is
``x * sigmoid(x)``.  The causal convolution is the reference's sum of
shifted products, not ``conv1d`` (which cuDNN runs in TF32 unless told
otherwise).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.modules import _dense_init, rmsnorm_apply, rmsnorm_init

N_GROUPS = 1  # B/C groups (mamba2 default n_groups=1 at these scales)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def mamba_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
               device="cpu") -> Dict:
    m = cfg.mamba
    d = cfg.d_model
    di = m.d_inner(d)
    nh = m.num_heads(d)
    conv_ch = di + 2 * N_GROUPS * m.d_state
    return {
        # order: [z (di), xBC (conv_ch), dt (nh)]
        "in_proj": _dense_init(gen, (d, 2 * di + 2 * N_GROUPS * m.d_state + nh),
                               dtype, device),
        "conv_w": _dense_init(gen, (m.d_conv, conv_ch), dtype, device,
                              scale=1.0 / math.sqrt(m.d_conv)),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)).to(dtype),
        "d_skip": torch.ones((nh,), dtype=dtype, device=device),
        "norm": rmsnorm_init(di, dtype, device),
        "out_proj": _dense_init(gen, (di, d), dtype, device),
    }


def _split_proj(params, x, cfg: ArchConfig):
    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"])
    return _split(zxbcdt, params["dt_bias"], cfg)


def _split(zxbcdt, dt_bias, cfg: ArchConfig):
    """in_proj's output -> z, xbc, dt: (b,s,di), (b,s,conv_ch), (b,s,nh)
    f32."""
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    z, xbc, dt = torch.split(
        zxbcdt, [di, di + 2 * N_GROUPS * m.d_state,
                 zxbcdt.shape[-1] - 2 * di - 2 * N_GROUPS * m.d_state], dim=-1)
    dt = softplus(dt.float() + dt_bias.float())
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. xbc: (b, s, ch); w: (width, ch)."""
    width = w.shape[0]
    s = xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s] * w[i] for i in range(width))
    return silu(out + b)


def _split_xbc(xbc, cfg: ArchConfig):
    """xbc (all heads', or a TP rank's, x channels, then B and C) -> xs
    (b,s,heads,hd), bs / cs (b,s,g,ds)."""
    m = cfg.mamba
    ds = N_GROUPS * m.d_state
    xs, bs, cs = torch.split(xbc, [xbc.shape[-1] - 2 * ds, ds, ds], dim=-1)
    b, s = xs.shape[:2]
    xs = xs.reshape(b, s, -1, m.head_dim)
    bs = bs.reshape(b, s, N_GROUPS, m.d_state)
    cs = cs.reshape(b, s, N_GROUPS, m.d_state)
    return xs, bs, cs


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} a[..., k]
    (=-inf for j > i).  a: (..., q)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.full((), -math.inf,
                                              device=a.device))


def ssd_chunked(xs, bs, cs, dt, a_coef, chunk: int):
    """Chunked SSD scan (the plain reference form).

    xs: (b,s,nh,hd); bs/cs: (b,s,g,ds); dt: (b,s,nh) f32; a_coef: (nh,)
    negative.  Returns y: (b,s,nh,hd) f32 and the final state
    (b,nh,ds,hd) f32 (the layout the reference's code returns; its
    docstring says (b,nh,hd,ds)).
    """
    bsz, s, nh, hd = xs.shape
    ds = bs.shape[-1]
    orig_s = s
    if s % chunk:
        # right-pad with dt=0 steps: decay=exp(0)=1 and dt*B*x=0, so padding
        # is exact for both outputs (sliced off) and the final state.
        pad = chunk - s % chunk

        def z(t):
            return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                           + (0, pad))
        xs, bs, cs, dt = z(xs), z(bs), z(cs), z(dt)
        s = s + pad
    nc = s // chunk
    # group-broadcast B/C to heads (g=1)
    bh = bs[:, :, 0][:, :, None].expand(bsz, s, nh, ds)
    ch = cs[:, :, 0][:, :, None].expand(bsz, s, nh, ds)

    def r(t, last):  # reshape to chunks
        return t.reshape((bsz, nc, chunk) + last)

    xc = r(xs, (nh, hd)).float()
    bc = r(bh, (nh, ds)).float()
    cc = r(ch, (nh, ds)).float()
    dtc = r(dt, (nh,))
    a = dtc * a_coef.float()                          # (b,nc,q,nh) log-decay
    a_t = a.movedim(-1, -2)                           # (b,nc,nh,q)
    cum = torch.cumsum(a_t, dim=-1)                   # (b,nc,nh,q)
    total = cum[..., -1]                              # (b,nc,nh)

    # ---- intra-chunk (quadratic) ----
    l_mat = torch.exp(segsum(a_t))                    # (b,nc,nh,q,q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc) * l_mat
    # weight by dt of the source step
    scores = scores * dtc.movedim(-1, -2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # ---- chunk states ----
    # (two-operand contractions throughout: a many-operand einsum may
    # contract through a (b, nc, q, nh, ds, hd) intermediate, 34 GB at
    # Jamba's 256 heads)
    decay_to_end = torch.exp(total[..., None] - cum)  # (b,nc,nh,q)
    w = (decay_to_end * dtc.movedim(-1, -2)).movedim(-1, -2)   # (b,nc,q,nh)
    sts = torch.einsum("bcqhn,bcqhp->bchnp", bc * w[..., None], xc)

    # ---- inter-chunk recurrence over nc (sequential, tiny) ----
    h = torch.zeros((bsz, nh, ds, hd), dtype=torch.float32, device=xs.device)
    prev_states = []
    for c in range(nc):
        prev_states.append(h)                         # state BEFORE chunk
        h = h * torch.exp(total[:, c])[..., None, None] + sts[:, c]
    prev = torch.stack(prev_states, dim=1)            # (b,nc,nh,ds,hd)

    # ---- inter-chunk contribution ----
    in_decay = torch.exp(cum)                         # (b,nc,nh,q)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cc, prev) \
        * in_decay.movedim(-1, -2)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, nh, hd)
    return y[:, :orig_s], h


def _gate(y, xs, z, d_skip) -> torch.Tensor:
    """The skip term and the gate after the scan: (b, s, heads * hd)
    f32."""
    y = y + xs.float() * d_skip.float()[:, None]
    return y.reshape(z.shape) * silu(z.float())


def _mix_out(params, x, xs, z, y, cfg: ArchConfig) -> torch.Tensor:
    """Skip term, gate, gated norm and out-projection after the scan (or
    the decode step's state update)."""
    y = _gate(y, xs, z, params["d_skip"])
    y = rmsnorm_apply(params["norm"], y.to(x.dtype), cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", y, params["out_proj"])


def mamba_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                impl: str = "reference", tp=None) -> torch.Tensor:
    """Full-sequence forward (training / prefill); under ``tp`` (a
    ``launch.tp.ModelParallel``) on the rank's heads (``_tp_mix``)."""
    if tp is not None:
        return _tp_mix(params, x, cfg, impl, tp, None)[0]
    return mamba_prefill(params, x, cfg, impl=impl)[0]


def _scan(xs, bs, cs, dt, a_coef, chunk: int, impl: str):
    """The SSD scan -> (y, final state): kernel 9 (its plain version off
    the card) under ``impl="kernel"``, else ``ssd_chunked``."""
    if impl == "kernel":
        return kops.ssd_scan(xs, bs, cs, dt, a_coef, chunk=chunk)
    if impl == "reference":
        return ssd_chunked(xs, bs, cs, dt, a_coef, chunk)
    raise ValueError(f"impl must be 'reference' or 'kernel', got {impl!r}")


class _Rank:
    """A rank's share of a Mamba layer under ``tp`` (``launch.tp``'s Mamba
    layout): its heads ``[h_lo, h_lo + hl)``, whose x channels ``[lo, lo +
    dl)`` of d_inner are its z, x and norm channels."""

    def __init__(self, params: Dict, cfg: ArchConfig, tp):
        m = cfg.mamba
        self.di, self.nh = m.d_inner(cfg.d_model), m.num_heads(cfg.d_model)
        width = 2 * self.di + 2 * N_GROUPS * m.d_state + self.nh
        self.hl = self.nh // tp.size
        if self.hl * tp.size != self.nh or \
                params["in_proj"].shape[-1] * tp.size != width:
            raise ValueError(f"tensor parallelism over 'model' runs a rank's "
                             f"Mamba heads from its in_proj block: {self.nh} "
                             f"heads and {width} in_proj columns over "
                             f"{tp.size} model ranks")
        self.dl = self.hl * m.head_dim
        self.lo, self.h_lo = tp.pos * self.dl, tp.pos * self.hl

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's x channels, then B and C, of an xBC-wide ``t``."""
        return torch.cat([t[..., self.lo:self.lo + self.dl],
                          t[..., self.di:]], dim=-1)

    def inputs(self, params: Dict, x: torch.Tensor, cfg: ArchConfig, tp):
        """The in_proj column block of ``x`` after ``tp.copy``, gathered
        whole with the conv leaves (``gather_ssm``); the per-head leaves
        and the norm's scale through ``tp.replicated`` as one flat tensor.
        Returns the rank's z (a copy, so that what backward keeps holds no
        whole (b, s, W) buffer), its xBC before the conv (its x channels, B
        and C whole), dt, conv_w, conv_b, the norm's scale, A and D."""
        block = torch.einsum("bsd,de->bse", tp.copy(x), params["in_proj"])
        zxbcdt, conv_w, conv_b = tp.gather_ssm(block, params["conv_w"],
                                               params["conv_b"])
        rep = tp.replicated(torch.cat([params["norm"]["scale"],
                                       params["dt_bias"], params["a_log"],
                                       params["d_skip"]]))
        scale, dt_bias, a_log, d_skip = torch.split(
            rep, [self.di, self.nh, self.nh, self.nh])
        z, xbc, dt = _split(zxbcdt, dt_bias, cfg)
        lo, dl, h_lo, hl = self.lo, self.dl, self.h_lo, self.hl
        return (z[..., lo:lo + dl].contiguous(), self.mine(xbc),
                dt[..., h_lo:h_lo + hl], self.mine(conv_w),
                self.mine(conv_b), scale[lo:lo + dl],
                -torch.exp(a_log[h_lo:h_lo + hl].float()),
                d_skip[h_lo:h_lo + hl])

    @staticmethod
    def out(params: Dict, x, xs, z, y, d_skip, scale, cfg: ArchConfig, tp):
        """Skip term, gate, the gated norm of the rank's channels over the
        whole d_inner (``tp.norm``) and ``out_proj``'s rows of them,
        reduced."""
        y = _gate(y, xs, z, d_skip)
        y = tp.norm(y.to(x.dtype), scale, cfg.norm_eps)
        return tp.reduce(torch.einsum("bsi,id->bsd", y, params["out_proj"]))


def _tp_mix(params: Dict, x: torch.Tensor, cfg: ArchConfig, impl: str, tp,
            conv_cache_dtype) -> Tuple[torch.Tensor, Dict]:
    """``mamba_prefill`` on this rank's heads ``[p nh / tp, (p + 1) nh /
    tp)`` from its pieces as ``launch.sharding`` cuts them (``launch.tp``'s
    Mamba layout, ``_Rank``): the conv and the scan on the rank's x
    channels with B and C whole, the gated norm over the whole d_inner,
    ``out_proj`` reduced.  Its cache (``None`` without a
    ``conv_cache_dtype``): the last d_conv - 1 pre-conv inputs of the
    rank's x channels and of B and C (width dl + 2 ds), and its heads'
    final state (b, hl, ds, hd) f32."""
    r = _Rank(params, cfg, tp)
    z, xbc_raw, dt, conv_w, conv_b, scale, a_coef, d_skip = r.inputs(
        params, x, cfg, tp)
    xs, bs, cs = _split_xbc(_causal_conv(xbc_raw, conv_w, conv_b), cfg)
    conv = None if conv_cache_dtype is None else \
        xbc_raw[:, -(cfg.mamba.d_conv - 1):].to(conv_cache_dtype)
    del xbc_raw
    y, final = _scan(xs, bs, cs, dt, a_coef, cfg.mamba.chunk_size, impl)
    out = r.out(params, x, xs, z, y, d_skip, scale, cfg, tp)
    return out, (None if conv is None else {"conv": conv, "ssm": final})


def mamba_prefill(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                  conv_cache_dtype=torch.bfloat16, impl: str = "reference",
                  tp=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that ALSO returns the decode cache — one SSD
    scan for both: ``{"conv": the last d_conv - 1 pre-conv inputs,
    "ssm": the final state (b, nh, ds, hd) f32}``; under ``tp`` (a
    ``launch.tp.ModelParallel``) on the rank's heads, with the rank's
    cache (``_tp_mix``)."""
    if tp is not None:
        return _tp_mix(params, x, cfg, impl, tp, conv_cache_dtype)
    m = cfg.mamba
    z, xbc_raw, dt = _split_proj(params, x, cfg)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, bs, cs = _split_xbc(xbc, cfg)
    a_coef = -torch.exp(params["a_log"].float())
    y, final = _scan(xs, bs, cs, dt, a_coef, m.chunk_size, impl)
    out = _mix_out(params, x, xs, z, y, cfg)
    cache = {"conv": xbc_raw[:, -(m.d_conv - 1):].to(conv_cache_dtype),
             "ssm": final}
    return out, cache


# ---------------------------------------------------------------------------
# incremental decode
# ---------------------------------------------------------------------------


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cpu", tp=None) -> Dict:
    """An empty conv window and SSM state; under ``tp`` a rank's: the
    window of its heads' x channels and of B and C, the state of its
    heads."""
    m = cfg.mamba
    nh = m.num_heads(cfg.d_model)
    if tp is not None:
        nh //= tp.size
    conv_ch = nh * m.head_dim + 2 * N_GROUPS * m.d_state
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, m.d_state, m.head_dim),
                           dtype=torch.float32, device=device),
    }


def _step(cache: Dict, xbc_raw, dt, conv_w, conv_b, a_coef,
          cfg: ArchConfig):
    """The conv over [the window, the token] and the O(1) state update of
    a decode step: writes the new window and state into ``cache`` IN PLACE
    and returns xs (b, heads, hd) and y (b, heads, hd) f32."""
    m = cfg.mamba
    hist = torch.cat([cache["conv"], xbc_raw.to(cache["conv"].dtype)], dim=1)
    window = hist[:, -m.d_conv:].to(torch.promote_types(hist.dtype,
                                                        conv_w.dtype))
    conv_out = torch.einsum("bwc,wc->bc", window, conv_w.to(window.dtype)) \
        + conv_b
    xs, bs, cs = _split_xbc(silu(conv_out)[:, None], cfg)    # (b,1,ch)
    dt1 = dt[:, 0]                                        # (b,heads)
    decay = torch.exp(dt1 * a_coef)                       # (b,heads)
    bx = torch.einsum("bhn,bhp->bhnp",
                      bs[:, 0, 0][:, None].expand(*dt1.shape, m.d_state)
                      .float(),
                      xs[:, 0].float() * dt1[..., None])
    ssm = cache["ssm"] * decay[..., None, None] + bx
    y = torch.einsum("bhn,bhnp->bhp",
                     cs[:, 0, 0][:, None].expand(*dt1.shape, m.d_state)
                     .float(), ssm)
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(ssm)
    return xs[:, 0], y


def mamba_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ArchConfig, tp=None) -> Tuple[torch.Tensor, Dict]:
    """x: (b, 1, d).  O(1) per token.  Writes the new conv window and SSM
    state into ``cache`` IN PLACE (the reference returns a new cache) and
    returns ``(y, cache)``.  Under ``tp`` (a ``launch.tp.ModelParallel``)
    on the rank's heads against its cache (``mamba_cache_init(tp=)``), as
    ``_tp_mix`` runs a prefill: the token's in_proj block gathered whole,
    the conv over the rank's window, the state update on its heads, the
    gated norm over the whole d_inner, ``out_proj`` reduced."""
    if tp is not None:
        r = _Rank(params, cfg, tp)
        z, xbc_raw, dt, conv_w, conv_b, scale, a_coef, d_skip = r.inputs(
            params, x, cfg, tp)
        xs, y = _step(cache, xbc_raw, dt, conv_w, conv_b, a_coef, cfg)
        return r.out(params, x, xs, z, y, d_skip, scale, cfg, tp), cache
    z, xbc_raw, dt = _split_proj(params, x, cfg)          # seq dim == 1
    xs, y = _step(cache, xbc_raw, dt, params["conv_w"], params["conv_b"],
                  -torch.exp(params["a_log"].float()), cfg)
    return _mix_out(params, x, xs, z, y, cfg), cache
