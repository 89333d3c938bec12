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
while this checkout's kernel runs back to back.  Prints one JSON line per
kernel, then the card's name and power limit.  Needs one NVIDIA GPU.
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


def in_turns(torch, fns: dict, reps: int) -> dict:
    times = {name: [] for name in fns}
    for name in ("other", "this", "this", "other"):
        times[name].append(events_ms(torch, fns[name], reps))
    return {name: {"events_ms": sum(t) / len(t), "runs_ms": t,
                   "device_us": device_us(torch, fns[name], 10)}
            for name, t in times.items()}


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
               "blocks": this_fa.blocks(b, sq, h, kvh),
               **in_turns(torch, fns, args.reps),
               "this_clocks_under_load": clocks_under_load(torch, fns["this"])}
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
