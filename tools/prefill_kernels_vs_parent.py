#!/usr/bin/env python3
"""Kernels 9 (SSD scan) and 3 (flash attention) of this checkout against
another checkout's, on the card, at the prefill shapes of the serving paths.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/prefill_kernels_vs_parent.py --parent build/parent

Loads ``src/repro_torch/kernels/ssd_scan.py`` and ``flash_attention.py`` of
both checkouts, each built from its own ``csrc/`` by its own ``_build.py``
(into its own ``build/``), and at each kernel's main shape -- Mamba2-780M's
prefill scan (b=4, s=1024, 48 heads of 64, d_state 128, chunk 256, A =
-(1..48), x/B/C as views of one conv output) and Qwen3-1.7B's prefill
attention (b=4, s=1024, 16 query and 8 KV heads of 128, causal) -- checks
that the two agree, times both in turns (other, this, this, other) with
CUDA events around back-to-back calls, and reads each one's device time per
kernel from the profiler, then samples ``nvidia-smi``'s SM clock and power
while this checkout's kernel runs back to back.  Then kernel 3 at the zoo's
modes (``chip_smoke.FLASH_ZOO``): the f32 ones (InternVL2, Seamless's
encoder and decoder) must agree bitwise; the bf16 ones (Gemma-2's local and
global layers, Command-R, Mixtral) are held per row against each other and
timed beside their tensor-core bound.  Last, the
bf16 prefills of ``chip_smoke.py``'s Gemma-2-27B, Command-R-35B and
Mixtral-8x22B cells (full width, bf16 weights from seed 0; Mixtral cut to 10
layers) in turns with each checkout's kernel-3 module swapped into
``ops``, one model at a time.  Prints one JSON line per comparison, then the
card's name and power limit.  Rows 3a and 3b's library yardstick, the
compiled ``flex_attention`` at Gemma-2's shapes, runs after the zoo modes.
Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SSD_SHAPE = (4, 1024, 48, 64, 128, 256)          # b, s, nh, hd, ds, chunk
FLASH_SHAPE = (4, 1024, 1024, 16, 8, 128)        # b, sq, sk, h, kvh, hd


def load(path: pathlib.Path, name: str, build):
    """Module ``path`` with ``repro_torch.kernels._build`` bound to
    ``build`` while it is executed (its ``from ... import _build``)."""
    import repro_torch.kernels as pkg
    saved = pkg._build
    pkg._build = build
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        pkg._build = saved
    return mod


def events_ms(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_us(torch, fn, reps: int) -> dict:
    """Device time of one call per kernel name, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)
        if us:
            out[e.key[:80]] = us / reps
    return out


def clocks_under_load(torch, fn, seconds: float = 1.5) -> list:
    """``nvidia-smi``'s SM clock, its maximum and the power drawn, sampled
    every 250 ms while ``fn`` runs back to back for ``seconds``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "250"], stdout=subprocess.PIPE,
        text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    return proc.communicate()[0].strip().splitlines()


def in_turns(torch, fns: dict, reps: int, profile: bool = True) -> dict:
    times = {name: [] for name in fns}
    for name in ("other", "this", "this", "other"):
        times[name].append(events_ms(torch, fns[name], reps))
    return {name: {"events_ms": sum(t) / len(t), "runs_ms": t,
                   **({"device_us": device_us(torch, fns[name], 10)}
                      if profile else {})}
            for name, t in times.items()}


def row_rel(got, want) -> float:
    """The largest error of a row (one query of one head) over that row's
    largest |value| (``chip_smoke.row_rel_err``)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30))
                 .max())


def zoo_modes(torch, cs, other_fa, this_fa, g, reps: int) -> None:
    """Kernel 3 at each mode of ``chip_smoke.FLASH_ZOO``, both checkouts."""
    dev = torch.device("cuda")
    for name, _, b, s, h, kvh, hd, kw, dtype, _ in cs.FLASH_ZOO:
        dt = getattr(torch, dtype)
        q_scale = cs.FLASH_SOFTCAP_Q_SCALE if "softcap" in kw else 1.0
        q = (torch.randn((b, s, h, hd), device=dev, generator=g)
             * q_scale).to(dt)
        k = torch.randn((b, s, kvh, hd), device=dev, generator=g).to(dt)
        v = torch.randn((b, s, kvh, hd), device=dev, generator=g).to(dt)
        fns = {n: (lambda mod=mod: mod.flash_attention_cuda(q, k, v, **kw))
               for n, mod in (("other", other_fa), ("this", this_fa))}
        o0, o1 = fns["other"](), fns["this"]()
        torch.cuda.synchronize()
        row = {"phase": "flash_attention_zoo_vs_parent", "mode": name,
               "shape": [b, s, s, h, kvh, hd], "dtype": dtype, **kw}
        if dtype == "float32":
            row["bitwise_equal"] = bool(torch.equal(o0, o1))
            assert row["bitwise_equal"], name
        else:
            row["row_rel_diff"] = row_rel(o1, o0)
            row["limit_each_vs_plain"] = cs.FLASH_BF16_ROW_LIMIT
        del o0, o1
        row.update(in_turns(torch, fns, reps if s <= 2048 else 5,
                            profile=False))
        pairs = cs.attn_pairs(s, s, kw.get("causal", True), kw.get("window"))
        flops = b * h * pairs * 4 * hd
        peak = (cs.H100_BF16_TC_FLOP_PER_S if dtype == "bfloat16"
                else cs.H100_F32_FLOP_PER_S)
        bound = flops / peak * 1e3
        row.update(flops=flops, bound_ms=bound, **{
            f"{n}_bound_share": bound / row[n]["events_ms"]
            for n in ("other", "this")})
        print(json.dumps(row), flush=True)
        del q, k, v, fns
        torch.cuda.empty_cache()


def prefills_in_turns(torch, cs, other_fa, this_fa) -> None:
    """The bf16 prefills of chip_smoke's Gemma-2, Command-R and Mixtral
    cells, with each checkout's kernel-3 module in ``ops`` in turns."""
    import dataclasses
    import time
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as ttf
    dev = torch.device("cuda")
    cells = [(a, get_arch(a), cs.ZOO[a], ttf.ApplyOptions(attn_impl="kernel"))
             for a in ("gemma2-27b", "command-r-35b")]
    shape = cs.MOE_ZOO["mixtral-8x22b"]
    cells.append(("mixtral-8x22b", dataclasses.replace(
        get_arch("mixtral-8x22b"), num_layers=shape["num_layers"]), shape,
        ttf.ApplyOptions(attn_impl="kernel", moe_no_drop=True)))
    saved = ops._fa
    try:
        for arch, cfg, shape, opts in cells:
            b, s, gen = shape["batch"], shape["prompt_len"], shape["gen"]
            rng = torch.Generator(device=dev).manual_seed(0)
            params = ttf.init_params(rng, cfg, dtype=torch.bfloat16,
                                     device=dev)
            inputs = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                              generator=rng, device=dev)}
            kw = dict(opts=opts, max_len=s + gen, cache_dtype=torch.float32)
            runs = {"other": [], "this": []}
            logits = {}
            for name in ("other", "this", "this", "other"):
                ops._fa = other_fa if name == "other" else this_fa
                if name not in logits:      # first call: set-up, kept out
                    logits[name] = ttf.prefill(params, cfg, inputs,
                                               **kw)[0][:, -1].float()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ttf.prefill(params, cfg, inputs, **kw)
                torch.cuda.synchronize()
                runs[name].append(time.perf_counter() - t0)
            print(json.dumps({
                "phase": "prefill_vs_parent", "arch": arch,
                "layers": cfg.num_layers, "batch": b, "prompt_len": s,
                "last_logits_max_abs_diff": float(
                    (logits["this"] - logits["other"]).abs().max()),
                **{f"{n}_prefill_s": sum(t) / len(t) for n, t in runs.items()},
                **{f"{n}_runs_s": t for n, t in runs.items()}}), flush=True)
            del params, inputs, logits
            torch.cuda.empty_cache()
    finally:
        ops._fa = saved


def flex_attention_rows(torch, cs, this_fa, g, reps: int) -> None:
    """The library yardstick of rows 3a and 3b (Gemma-2's local and global
    layers, bf16): ``torch.nn.attention.flex_attention`` under
    ``torch.compile``, the tanh softcap as a ``score_mod`` and the causal
    mask with the sliding window as a block mask, at
    ``chip_smoke.FLASH_ZOO``'s shapes; held per row against this checkout's
    kernel 3 and timed beside it.  The port never calls it.  A failure to
    compile or run is printed as the row's ``error``."""
    dev = torch.device("cuda")
    for name, _, b, s, h, kvh, hd, kw, dtype, _ in cs.FLASH_ZOO:
        if not name.startswith("gemma2"):
            continue
        row = {"phase": "flex_attention_library", "mode": name,
               "shape": [b, s, s, h, kvh, hd], "dtype": dtype, **kw}
        try:
            from torch.nn.attention.flex_attention import (create_block_mask,
                                                           flex_attention)
            window, cap = kw.get("window"), kw["softcap"]

            def mask_mod(b_, h_, qi, ki):
                keep = ki <= qi
                if window is not None:
                    keep = keep & (ki > qi - window)
                return keep

            def score_mod(score, b_, h_, qi, ki):
                return cap * torch.tanh(score / cap)

            dt = getattr(torch, dtype)
            q = (torch.randn((b, s, h, hd), device=dev, generator=g)
                 * cs.FLASH_SOFTCAP_Q_SCALE).to(dt)
            k = torch.randn((b, s, kvh, hd), device=dev, generator=g).to(dt)
            v = torch.randn((b, s, kvh, hd), device=dev, generator=g).to(dt)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            block_mask = create_block_mask(mask_mod, None, None, s, s,
                                           device=dev)
            compiled = torch.compile(flex_attention, dynamic=False)

            def lib():
                return compiled(qt, kt, vt, score_mod=score_mod,
                                block_mask=block_mask, enable_gqa=True)
            t0 = time.perf_counter()
            out = lib()
            torch.cuda.synchronize()
            row["compile_s"] = time.perf_counter() - t0
            ours = this_fa.flash_attention_cuda(q, k, v, **kw)
            row["row_rel_diff_vs_kernel"] = row_rel(out.transpose(1, 2),
                                                    ours)
            row["limit_each_vs_plain"] = cs.FLASH_BF16_ROW_LIMIT
            del out, ours
            row["library_ms"] = events_ms(torch, lib, reps)
            row["kernel_ms"] = events_ms(
                torch, lambda: this_fa.flash_attention_cuda(q, k, v, **kw),
                reps)
            del q, k, v, qt, kt, vt
        except Exception as exc:    # recorded: the row says why
            row["library_ms"] = None
            row["error"] = f"{type(exc).__name__}: {exc}"[:2000]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention as this_fa
    from repro_torch.kernels import ssd_scan as this_ssd
    parent = pathlib.Path(args.parent).resolve() / "src/repro_torch/kernels"
    spec = importlib.util.spec_from_file_location("other_build",
                                                  parent / "_build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    other_ssd = load(parent / "ssd_scan.py", "other_ssd_scan", other_build)
    other_fa = load(parent / "flash_attention.py", "other_flash_attention",
                    other_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)

    with torch.inference_mode():
        b, s, nh, hd, ds, chunk = SSD_SHAPE
        xbc = torch.randn((b, s, nh * hd + 2 * ds), device=dev, generator=g)
        xbc[..., nh * hd:] *= 0.5
        xs = xbc[..., :nh * hd].view(b, s, nh, hd)
        bs = xbc[..., nh * hd:nh * hd + ds].view(b, s, 1, ds)
        cs = xbc[..., nh * hd + ds:].view(b, s, 1, ds)
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, nh), device=dev, generator=g))
        a = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
        fns = {name: (lambda mod=mod: mod.ssd_scan_cuda(xs, bs, cs, dt, a,
                                                         chunk=chunk))
               for name, mod in (("other", other_ssd), ("this", this_ssd))}
        (y0, h0), (y1, h1) = fns["other"](), fns["this"]()
        row = {"phase": "ssd_scan_vs_parent", "shape": list(SSD_SHAPE),
               "max_abs_diff": {"y": float((y0 - y1).abs().max()),
                                "state": float((h0 - h1).abs().max())},
               "blocks": this_ssd.blocks(b, s, nh, hd, ds, chunk),
               **in_turns(torch, fns, args.reps),
               "this_clocks_under_load": clocks_under_load(torch, fns["this"])}
        print(json.dumps(row), flush=True)
        del xbc, xs, bs, cs, dt, y0, y1, h0, h1

        b, sq, sk, h, kvh, hd = FLASH_SHAPE
        q = torch.randn((b, sq, h, hd), device=dev, generator=g)
        k = torch.randn((b, sk, kvh, hd), device=dev, generator=g)
        v = torch.randn((b, sk, kvh, hd), device=dev, generator=g)
        fns = {name: (lambda mod=mod: mod.flash_attention_cuda(q, k, v))
               for name, mod in (("other", other_fa), ("this", this_fa))}
        o0, o1 = fns["other"](), fns["this"]()
        row = {"phase": "flash_attention_vs_parent",
               "shape": list(FLASH_SHAPE),
               "max_abs_diff": float((o0 - o1).abs().max()),
               "bitwise_equal": bool(torch.equal(o0, o1)),
               "blocks": this_fa.blocks(b, sq, h, kvh),
               **in_turns(torch, fns, args.reps),
               "this_clocks_under_load": clocks_under_load(torch, fns["this"])}
        print(json.dumps(row), flush=True)
        del q, k, v, o0, o1, fns
        zoo_modes(torch, chip_smoke, other_fa, this_fa, g, args.reps)
        flex_attention_rows(torch, chip_smoke, this_fa, g, args.reps)
        prefills_in_turns(torch, chip_smoke, other_fa, this_fa)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
