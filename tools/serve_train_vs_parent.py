#!/usr/bin/env python3
"""The Qwen3-1.7B serving phase and the SmolLM-360M static training phase
of ``chip_smoke.py``, on this checkout and another, in one call on the card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/serve_train_vs_parent.py --parent build/parent

Runs each phase in a fresh process per checkout, in the order other, this,
this, other, each process importing ``repro_torch`` from its own ``src/``
(kernels built from its own ``csrc/`` into its own ``build/``).  A process
serves Qwen3-1.7B at full width through ``serve()`` (batch 4, prompt 1024,
64 tokens, f32, after a short run that takes the first calls' set-up) and
then trains SmolLM-360M for two static epochs through ``train()`` (M = 4
servers, 2 clients, T_C = 2, T_S = 5, ring, sequence 128, batch 2), the
shapes ``chip_smoke.py`` uses.  Prints one JSON line a process (prefill and
decode seconds, ms a decode step, epoch seconds), then the card's name and
power limit.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE = dict(smoke=False, batch=4, prompt_len=1024, gen=64, device="cuda")
TRAIN = dict(smoke=False, servers=4, clients=2, t_client=2, t_server=5,
             epochs=2, seq_len=128, per_client_batch=2, graph="ring",
             device="cuda")


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    ttrain.set_full_f32()
    tserve.serve("qwen3-1.7b", **{**SERVE, "prompt_len": 16, "gen": 2})
    res = tserve.serve("qwen3-1.7b", **SERVE)
    torch.cuda.synchronize()
    steps = SERVE["gen"] - 1
    out = {"checkout": str(root), "prefill_s": res["prefill_s"],
           "decode_s": res["decode_s"],
           "ms_a_decode_step": res["decode_s"] / steps * 1e3,
           "first_row": res["generated"][0, :8].tolist()}
    del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = ttrain.train("smollm-360m", **TRAIN, log=False)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["epoch_s"] = run["history"]["epoch_s"]
    out["loss"] = run["history"]["loss"]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=pathlib.Path,
                   help="root of the other checkout")
    p.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve())), flush=True)
        return 0
    if args.parent is None:
        p.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("serve_train_vs_parent: needs a CUDA device", file=sys.stderr)
        return 2
    other = args.parent.resolve()
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root)], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        rec = {"run": label, **json.loads(proc.stdout.strip()
                                          .splitlines()[-1])}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    for key in ("prefill_s", "ms_a_decode_step"):
        print(json.dumps({"compare": key, **{
            label: [r[key] for r in runs if r["run"] == label]
            for label in ("other", "this")}}))
    print(json.dumps({"compare": "epoch_s", **{
        label: [r["epoch_s"] for r in runs if r["run"] == label]
        for label in ("other", "this")}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
