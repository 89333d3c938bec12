"""``chip_smoke.py``'s ``shard_tp_mamba`` phase on one H100, alone or
taken apart.

    python3 tools/tp_mamba_probe.py [--only mamba|jamba] [--layers N]
                                    [--leaves] [--f32-sums]

Without ``--leaves`` it runs the phase as the script does (kernel 2's
checks, the one-process references, row 1r, four gloo ranks, the
checks), in a few minutes.  ``--only`` keeps one of its two runs and
``--layers`` sets Mamba2-780M's depth (16 in the script).

``--leaves`` runs, beside the four ranks, the one-process variants of
the run and prints each leaf's distance from the plain run over the
leaf's largest value (first-step gradients and pieces): ``proj``
(in_proj / out_proj regrouped, ``tp_regrouped``), ``scan`` (with the
scan per block of heads and the gated norm's sums grouped), ``conv`` (the
depthwise conv and the scan per block alone), ``regrouped`` (the
script's: all of them) and ``control`` (the grouped gated norm); then
``conv_b`` element by element: where each run's largest difference from
the plain run lies, and whether in B's and C's channels.  ``--f32-sums``
makes every bf16 sum of ``consensus.all_reduce_`` in f32, rounded once
(the sites' bytes then differ from the prediction, so use it with
``--leaves``).  The options are read at import, so the spawned ranks see
them.  Needs one NVIDIA GPU; prints JSON lines, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.models import mamba as mm  # noqa: E402

_p = argparse.ArgumentParser()
_p.add_argument("--only", choices=sorted(cs.TP_MAMBA_RUNS))
_p.add_argument("--layers", type=int)
_p.add_argument("--leaves", action="store_true")
_p.add_argument("--f32-sums", action="store_true")
ARGS = _p.parse_known_args()[0]

if ARGS.only:
    cs.TP_MAMBA_RUNS = {ARGS.only: cs.TP_MAMBA_RUNS[ARGS.only]}
if ARGS.layers and "mamba" in cs.TP_MAMBA_RUNS:
    arch, shape, _, dtype = cs.TP_MAMBA_RUNS["mamba"]
    cs.TP_MAMBA_RUNS = dict(cs.TP_MAMBA_RUNS,
                            mamba=(arch, shape, ARGS.layers, dtype))
_all_reduce = cns.all_reduce_


def _all_reduce_f32(x, group, op="sum", *, site="all_reduce"):
    """``consensus.all_reduce_`` with a bf16 sum made in f32."""
    if x.dtype != torch.bfloat16 or op != "sum":
        return _all_reduce(x, group, op, site=site)
    f = x.float()
    _all_reduce(f, group, op, site=site)
    return x.copy_(f)


if ARGS.f32_sums:
    cns.all_reduce_ = _all_reduce_f32
_PREFILL, _NORM = mm.mamba_prefill, mm.rmsnorm_apply


@contextlib.contextmanager
def _swap(**attrs):
    """Within the block, ``models.mamba``'s ``attrs`` replaced."""
    saved = {k: getattr(mm, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mm, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mm, k, v)


def _scan_by_block(k: int):
    """The one-process prefill with its scan per block of ``k`` heads."""
    scan = mm._scan

    def grouped(xs, bs, cs_, dt, a_coef, chunk, impl):
        outs = [scan(x_, bs, cs_, d_, a_, chunk, impl) for x_, d_, a_ in zip(
            xs.chunk(k, dim=2), dt.chunk(k, dim=-1), a_coef.chunk(k))]
        return (torch.cat([y for y, _ in outs], dim=2),
                torch.cat([f for _, f in outs], dim=1))
    return _swap(mamba_prefill=_PREFILL, _scan=grouped)


def _variants(k: int) -> dict:
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as ttf

    def proj():
        return cs.tp_regrouped(torch, (nn, ttf, mm), k)
    return {
        "plain": contextlib.nullcontext,
        "proj": proj,
        "scan": lambda: cs.nested(proj(), cs.mamba_regrouped(torch, mm, k),
                                  _scan_by_block(k)),
        "conv": lambda: cs.nested(cs.mamba_regrouped(torch, mm, k),
                                  _swap(rmsnorm_apply=_NORM)),
        "regrouped": lambda: cs.nested(proj(),
                                       cs.mamba_regrouped(torch, mm, k)),
        "control": lambda: cs.grouped_gated_norm(torch, mm, k)}


def _leaf_names(cfg) -> list:
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_map_with_path
    out = []
    tree_map_with_path(lambda p, x: out.append("/".join(
        str(getattr(e, "key", getattr(e, "idx", e))) for e in p)),
        ttf.init_params(torch.Generator(), cfg, torch.float32,
                        device="meta"))
    return out


def _leaves(smi: str) -> None:
    import numpy as np
    from repro_torch.models import transformer as ttf
    refs = {}
    for name, (arch, shape, layers, dtype) in cs.TP_MAMBA_RUNS.items():
        cfg = cs.tp_mamba_config(arch, layers)
        refs[name] = {m: cs.tp_one_process(torch, ttf, cfg, shape,
                                           cs.seeded_params(dtype), ctx())
                      for m, ctx in _variants(shape[3]).items()}
    ranks = cs.shard_world(torch, [("shard_tp_mamba", "shard_tp_mamba", {})])
    for name, (arch, shape, layers, dtype) in cs.TP_MAMBA_RUNS.items():
        cfg = cs.tp_mamba_config(arch, layers)
        names = _leaf_names(cfg)
        got = [r["shard_tp_mamba"][name] for r in ranks]
        sides = {"tp": {"grads": {r: x["grad_samples"]
                                  for r, x in enumerate(got)},
                        "samples": {r: x["samples"]
                                    for r, x in enumerate(got)}}}
        sides.update({m: v for m, v in refs[name].items() if m != "plain"})
        plain = refs[name]["plain"]
        conv_b = names.index(next(n for n in names
                                  if n.endswith("mixer/conv_b")))
        mc = cfg.mamba
        di = mc.d_inner(cfg.d_model)
        for key in ("grads", "samples"):
            for side, v in sides.items():
                d = cs.tp_moe_distances(v[key], plain[key])
                rel = {n: dd / max(sc, 1e-30) for n, (dd, sc) in
                       zip(names, d)}
                want = np.concatenate([plain[key][r][conv_b]
                                       for r in sorted(plain[key])])
                have = np.concatenate([v[key][r][conv_b]
                                       for r in sorted(v[key])])
                diff = np.abs(have - want)
                cs.emit("tp_mamba_probe", run=name, layers=layers, key=key,
                        side=side, f32_sums=ARGS.f32_sums,
                        worst=sorted(rel.items(), key=lambda kv: -kv[1])[:4],
                        conv_b_argmax=int(diff.argmax()),
                        conv_b_x_max=float(diff[:di].max()),
                        conv_b_bc_max=float(diff[di:].max()),
                        conv_b_largest=float(np.abs(want).max()),
                        nvidia_smi=smi)


def main() -> int:
    from repro_torch.kernels import _build
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as ttf
    ttrain.set_full_f32()
    smi = cs.nvidia_smi()
    _build.compile_all(["rmsnorm", "consensus_mix"])
    if ARGS.leaves:
        _leaves(smi)
    else:
        want = cs.tp_mamba_references(torch, ttf)
        if "mamba" in cs.TP_MAMBA_RUNS:
            cs.tp_mamba_row_check(torch, torch.Generator(
                device="cuda").manual_seed(0))
        ranks = cs.shard_world(torch, [("shard_tp_mamba", "shard_tp_mamba",
                                        {})])
        cs.tp_mamba_check(torch, ranks, want, smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
