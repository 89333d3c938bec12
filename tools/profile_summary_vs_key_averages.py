#!/usr/bin/env python3
"""``chip_smoke.kineto_averages`` against ``torch.profiler``'s own
``key_averages()`` on one profiled wire epoch of full SmolLM-360M, on the
card.

    python3 tools/profile_summary_vs_key_averages.py

Trains one epoch of ``chip_smoke.WIRE_TRAIN`` (int8 physical wire, EF) to
warm up, then one more under ``torch.profiler`` (CPU and CUDA activities),
as ``chip_smoke.py``'s ``profile_wire`` phase does.  Summarises the run both
ways and prints one JSON line: the seconds each summary took, the names
each one lists, and per name the largest difference in calls, self CPU
time and (for kernels) device time (µs), with the names that differ; the
device busy time and whether ``chip_smoke.profile_summary``'s top-12 host
and device lists are ``key_averages()``'s.  Then the card's name and power
limit.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as ttrain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    ttrain.set_full_f32()
    kw = {**cs.WIRE_TRAIN, "epochs": 1}
    ttrain.train("smollm-360m", **kw, log=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ttrain.train("smollm-360m", **kw, log=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t = time.perf_counter()
    ours = {(e.key, e.on_device): e for e in cs.kineto_averages(prof)}
    ours_s = time.perf_counter() - t
    summary = cs.profile_summary(prof, wall)
    t = time.perf_counter()
    theirs = {}
    for e in prof.key_averages():
        on_device = str(e.device_type).endswith("CUDA")
        theirs[(e.key, on_device)] = e
    theirs_s = time.perf_counter() - t

    worst = {"count": (0, None), "self_cpu_us": (0.0, None),
             "device_us": (0.0, None)}
    differ = []
    for key in set(ours) & set(theirs):
        o, w = ours[key], theirs[key]
        # a host row's device time in key_averages() is its kernels',
        # which kineto_averages leaves at 0 (the summary reads device time
        # from the kernels' own rows)
        diffs = {"count": abs(o.count - w.count),
                 "self_cpu_us": abs(o.self_cpu_time_total
                                    - w.self_cpu_time_total),
                 "device_us": abs(o.self_device_time_total
                                  - w.self_device_time_total)
                 if key[1] else 0.0}
        for k, v in diffs.items():
            if v > worst[k][0]:
                worst[k] = (v, key[0][:80])
        if diffs["count"] or diffs["self_cpu_us"] > 1e-3 or \
                diffs["device_us"] > 1e-3:
            differ.append({"name": key[0][:80], "on_device": key[1],
                           "count": [o.count, w.count],
                           "self_cpu_us": [o.self_cpu_time_total,
                                           w.self_cpu_time_total],
                           "device_us": [o.self_device_time_total,
                                         w.self_device_time_total]})
    kern = [e for k, e in theirs.items() if k[1]]
    host = sorted((e for k, e in theirs.items() if not k[1]),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    print(json.dumps({
        "phase": "profile_summary_vs_key_averages", "wall_s": wall,
        "kineto_averages_s": ours_s, "key_averages_s": theirs_s,
        "names": {"kineto_averages": len(ours), "key_averages": len(theirs),
                  "only_kineto_averages": sorted(
                      k[0][:80] for k in set(ours) - set(theirs)),
                  "only_key_averages": sorted(
                      k[0][:80] for k in set(theirs) - set(ours))},
        "largest_difference": {k: {"value": v, "name": n}
                               for k, (v, n) in worst.items()},
        "names_that_differ": differ[:20], "n_names_that_differ": len(differ),
        "device_busy_ms": {"kineto_averages": summary["device_busy_ms"],
                           "key_averages": sum(
                               e.self_device_time_total for e in kern) / 1e3},
        "top_host_same_order": [r["name"] for r in summary["top_host"]]
        == [e.key[:80] for e in host],
        "top_device_same_order": [r["name"] for r in summary["top_device"]]
        == [e.key[:80] for e in sorted(
            kern, key=lambda e: e.self_device_time_total,
            reverse=True)[:12]],
        "device": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
