#!/usr/bin/env python3
"""Kernel 2 (RMSNorm) of this checkout against another checkout's, on the card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/rmsnorm_vs_parent.py --parent build/parent

Loads ``src/repro_torch/kernels/rmsnorm.py`` of both checkouts (the other
one may launch its kernels through Triton, which this checkout no longer
uses) and, at each shape the port's paths run, times both forwards and
both backwards in turns (other, this, this, other) with CUDA events around
back-to-back calls, the host time of a call (enqueue only, no
synchronisation), and each one's device time per kernel from the profiler.
It also times ``torch.cuda.current_stream(device).cuda_stream``, which
every call of this checkout's wrappers reads.  Prints one JSON line per
shape and the card's name and power limit.  Needs one NVIDIA GPU.
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
# (rows, d): a SmolLM-360M client step, Qwen3-1.7B's prefill ln and q/k
# norms and a decode step's, Mamba2-780M's prefill ln and gated norm
SHAPES = [(256, 960), (4096, 2048), (65536, 128), (32768, 128), (4, 2048),
          (64, 128), (4096, 1536), (4096, 3072), (4, 1536), (4, 3072)]


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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


def host_us(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def device_us(torch, fn, reps: int) -> dict:
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
            out[e.key[:60]] = us / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import rmsnorm as this
    other = load(pathlib.Path(args.parent) / "src/repro_torch/kernels/"
                 "rmsnorm.py", "other_rmsnorm")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    stream_us = host_us(torch, lambda: torch.cuda.current_stream(
        dev).cuda_stream, 10000)
    print(json.dumps({"phase": "stream", "current_stream_us": stream_us}),
          flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, d in SHAPES:
        x = torch.randn((rows, d), device=dev, generator=g)
        s = 1 + 0.1 * torch.randn(d, device=dev, generator=g)
        gy = torch.randn((rows, d), device=dev, generator=g)
        fns = {}
        for name, mod in (("other", other), ("this", this)):
            _, rstd = mod.rmsnorm_fwd_cuda(x, s, 1e-6)
            fns[name] = (
                lambda mod=mod: mod.rmsnorm_fwd_cuda(x, s, 1e-6),
                lambda mod=mod, rstd=rstd: mod.rmsnorm_bwd_cuda(x, s, rstd,
                                                                gy))
        y0, y1 = fns["other"][0]()[0], fns["this"][0]()[0]
        d0, d1 = fns["other"][1](), fns["this"][1]()
        agree = {"y": float((y0 - y1).abs().max()),
                 "dx": float((d0[0] - d1[0]).abs().max()),
                 "dscale": float((d0[1] - d1[1]).abs().max())}
        row = {"phase": "rmsnorm_vs_parent", "rows": rows, "d": d,
               "dtype": "float32", "max_abs_diff": agree}
        for k, which in enumerate(("fwd", "bwd")):
            times = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                times[name].append(events_ms(torch, fns[name][k], args.reps))
            row[which] = {
                name: {"events_ms": sum(t) / 2,
                       "host_us": host_us(torch, fns[name][k], args.reps),
                       "device_us": device_us(torch, fns[name][k], 20)}
                for name, t in times.items()}
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
