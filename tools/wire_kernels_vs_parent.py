#!/usr/bin/env python3
"""The physical wire's kernels 5-8 of this checkout against another
checkout's, on the card, at the SmolLM-360M wire shape, and one
staleness-1 wire epoch of each.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/wire_kernels_vs_parent.py --parent build/parent

Loads ``src/repro_torch/kernels/consensus_mix.py`` of both checkouts, each
built from its own ``csrc/quantized_wire.cu`` by its own ``_build.py``
(into its own ``build/``).  At M = 4, D = 364,904,448 (the padded bucket of
full SmolLM-360M), chunk 256, int8, every kernel of the wire -- kernel 8's
square call and row form (the bounded-staleness round), kernel 7's square
call and row form, kernel 6 (the encode) and kernel 5 (the per-leaf round)
-- runs once on inputs made from one seed in each checkout, the two
outputs must be bitwise equal, and then both are timed in turns (other,
this, this, other) with CUDA events around back-to-back calls, beside the
kernel's byte bound (``chip_smoke.WIRE_TRAFFIC``; the row forms' as in
``chip_smoke.shard_kernel_rows``).  Kernel 8's square call is also timed
on its two-pass body, at M = 5 and 16 (chunk 256) and at chunk 2048, each
with the wire shape's bytes.  Then one process per checkout, in the
same order, trains full SmolLM-360M on the int8 physical wire with error
feedback at staleness 1 for two epochs (the second without set-up) through
``train()``.  Prints one JSON line per comparison, then the card's name and
power limit.  Needs one NVIDIA GPU (~40 GB of its memory).
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
M, D, CHUNK, BITS = 4, 364_904_448, 256, 8


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
    for _ in range(2):
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


def in_turns(torch, fns: dict, reps: int) -> dict:
    times = {name: [] for name in fns}
    for name in ("other", "this", "this", "other"):
        times[name].append(events_ms(torch, fns[name], reps))
    return {f"{name}_ms": sum(t) / len(t) for name, t in times.items()} | {
        f"{name}_runs_ms": t for name, t in times.items()}


def fill(torch, bufs: dict, seed: int) -> None:
    """The same inputs, from one seed, into the same buffers."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, t in bufs.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, device="cuda",
                                  generator=g, dtype=torch.int8))
        elif name.startswith("scales"):
            t.copy_(torch.rand(t.shape, device="cuda", generator=g) * 0.02
                    + 1e-3)
        elif name == "u":
            t.copy_(torch.rand(t.shape, device="cuda", generator=g))
        else:
            t.normal_(generator=g).mul_(1.0 if name == "w" else 0.5)


def compare(torch, cm: dict, name: str, bufs: dict, call, outs, n_bytes,
            reps: int, smi: str, instances=None, shape=(M, D, CHUNK)) -> None:
    """Run ``call(module, bufs)`` once per checkout on the same inputs, hold
    the outputs ``outs`` bitwise, then time both in turns.  ``shape`` is
    the call's (M, D, chunk), for the printed line."""
    import chip_smoke
    got = {}
    for who in ("other", "this"):
        fill(torch, bufs, 0)
        call(cm[who], bufs)
        torch.cuda.synchronize()
        got[who] = [bufs[k].clone() for k in outs]
    same = all(bool(torch.equal(x, y)) for x, y in zip(got["other"],
                                                       got["this"]))
    del got
    torch.cuda.empty_cache()
    if instances is not None:
        instances.clear()
    row = in_turns(torch, {who: (lambda mod=cm[who]: call(mod, bufs))
                           for who in ("other", "this")}, reps)
    bound = n_bytes / chip_smoke.H100_BYTES_PER_S * 1e3
    print(json.dumps({
        "phase": "wire_kernel_vs_parent", "kernel": name, "m": shape[0],
        "d": shape[1], "chunk": shape[2], "bits": BITS, "bitwise_equal": same,
        **row,
        "bound_ms": bound, "bound_by": "bytes",
        "other_bound_share": bound / row["other_ms"],
        "this_bound_share": bound / row["this_ms"],
        "this_over_other": row["this_ms"] / row["other_ms"],
        "this_instances": dict(instances) if instances is not None else None,
        "device": smi}), flush=True)
    assert same, name


def kernels(torch, cm: dict, reps: int, smi: str) -> None:
    import chip_smoke
    dev = torch.device("cuda")
    nc = D // CHUNK
    a = torch.tensor([[0.5, 0.25, 0.0, 0.25], [0.25, 0.5, 0.25, 0.0],
                      [0.0, 0.25, 0.5, 0.25], [0.25, 0.0, 0.25, 0.5]],
                     device=dev)
    kw = dict(bits=BITS, chunk=CHUNK)
    inst = getattr(cm["this"], "pipelined_instances", None)

    def traffic(name):
        per_elem, scale_passes, reads_a = chip_smoke.WIRE_TRAFFIC[name]
        return (M * D * per_elem + scale_passes * M * nc * 4
                + (M * M * 4 if reads_a else 0))

    # the square calls: (M, D) state, in place
    sq = {"w": torch.empty((M, D), device=dev),
          "ref": torch.empty((M, D), device=dev),
          "acc": torch.empty((M, D), device=dev),
          "u": torch.empty((M, D), device=dev),
          "codes": torch.empty((M, D), dtype=torch.int8, device=dev),
          "scales": torch.empty((M, nc), device=dev)}
    compare(torch, cm, "bucketed_gossip_round_pipelined", sq,
            lambda mod, b: mod.bucketed_gossip_round_pipelined_cuda(
                a, b["codes"], b["scales"], b["w"], b["ref"], b["acc"],
                b["u"], **kw),
            ("acc", "ref", "codes", "scales"),
            traffic("bucketed_gossip_round_pipelined"), reps, smi, inst)
    compare(torch, cm, "bucketed_gossip_round", sq,
            lambda mod, b: mod.bucketed_gossip_round_cuda(
                a, b["codes"], b["scales"], b["ref"], b["acc"], b["u"], **kw),
            ("acc", "ref", "codes", "scales"),
            traffic("bucketed_gossip_round"), reps, smi)
    compare(torch, cm, "quantized_gossip_encode", sq,
            lambda mod, b: mod.quantized_gossip_encode_cuda(
                b["w"], b["ref"], b["u"], b["codes"], b["scales"], **kw),
            ("codes", "scales"), traffic("quantized_gossip_encode"), reps,
            smi)
    compare(torch, cm, "quantized_gossip_round", sq,
            lambda mod, b: mod.quantized_gossip_round_cuda(
                a, b["codes"], b["scales"], b["ref"], b["acc"], b["u"], **kw),
            ("acc", "ref", "codes", "scales"),
            traffic("quantized_gossip_round"), reps, smi)
    del sq
    torch.cuda.empty_cache()
    # the row forms: row 1 of a gathered (M, D) round
    r = 1
    a_r = a[r:r + 1].contiguous()
    rows = {"codes": torch.empty((M, D), dtype=torch.int8, device=dev),
            "scales": torch.empty((M, nc), device=dev),
            "w": torch.empty((1, D), device=dev),
            "ref": torch.empty((1, D), device=dev),
            "acc": torch.empty((1, D), device=dev),
            "u": torch.empty((1, D), device=dev),
            "codes_out": torch.empty((1, D), dtype=torch.int8, device=dev),
            "scales_out": torch.empty((1, nc), device=dev)}
    outs = ("acc", "ref", "codes_out", "scales_out")
    for name, own_in, call in (
            ("bucketed_gossip_round_pipelined_rows", 4 * 4,
             lambda mod, b: mod.bucketed_gossip_round_pipelined_rows_cuda(
                 a_r, b["codes"], b["scales"], b["w"], b["ref"], b["acc"],
                 b["u"], b["codes_out"], b["scales_out"], **kw)),
            ("bucketed_gossip_round_rows", 4 * 3,
             lambda mod, b: mod.bucketed_gossip_round_rows_cuda(
                 a_r, b["codes"], b["scales"], b["ref"], b["acc"], b["u"],
                 b["codes_out"], b["scales_out"], row0=r, **kw))):
        # chip_smoke.shard_kernel_rows's count: the gathered codes and
        # scales, the own operands read, ref, acc, codes and scale written
        n_bytes = (M * D + M * nc * 4 + D * own_in + D * (4 + 4 + 1)
                   + nc * 4 + M * 4)
        compare(torch, cm, name, rows, call, outs, n_bytes, reps, smi,
                inst if "pipelined" in name else None)
    del rows
    torch.cuda.empty_cache()


def twopass_shapes(torch, cm: dict, reps: int, smi: str) -> None:
    """Kernel 8's square call on its two-pass body: one process holding M =
    5 or 16 servers (chunk 256) and a chunk wider than the slab (M = 4,
    chunk 2048), each at the wire shape's bytes (M * D ~ 4 * 364,904,448,
    D a multiple of 2048), A the ring's 1/2 self and 1/4 a neighbour."""
    import chip_smoke
    dev = torch.device("cuda")
    inst = getattr(cm["this"], "pipelined_instances", None)
    per_elem, scale_passes, _ = chip_smoke.WIRE_TRAFFIC[
        "bucketed_gossip_round_pipelined"]
    for m, chunk in ((5, 256), (16, 256), (4, 2048)):
        d = 4 * D // m // 2048 * 2048
        nc = d // chunk
        a = torch.zeros((m, m), device=dev)
        for i in range(m):
            a[i, i] += 0.5
            a[i, (i + 1) % m] += 0.25
            a[i, (i - 1) % m] += 0.25
        sq = {"w": torch.empty((m, d), device=dev),
              "ref": torch.empty((m, d), device=dev),
              "acc": torch.empty((m, d), device=dev),
              "u": torch.empty((m, d), device=dev),
              "codes": torch.empty((m, d), dtype=torch.int8, device=dev),
              "scales": torch.empty((m, nc), device=dev)}
        compare(torch, cm, "bucketed_gossip_round_pipelined", sq,
                lambda mod, b, a=a, chunk=chunk:
                mod.bucketed_gossip_round_pipelined_cuda(
                    a, b["codes"], b["scales"], b["w"], b["ref"], b["acc"],
                    b["u"], bits=BITS, chunk=chunk),
                ("acc", "ref", "codes", "scales"),
                m * d * per_elem + scale_passes * m * nc * 4 + m * m * 4,
                reps, smi, inst, shape=(m, d, chunk))
        del sq
        torch.cuda.empty_cache()


def child(root: pathlib.Path) -> dict:
    """Two staleness-1 epochs of full SmolLM-360M on the int8 physical wire
    with EF, through ``train()`` of the checkout at ``root``."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    ttrain.set_full_f32()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = ttrain.train("smollm-360m", smoke=False, servers=4, clients=2,
                       t_client=2, t_server=5, epochs=2, seq_len=128,
                       per_client_batch=2, graph="ring", device="cuda",
                       compression="int8", wire="physical",
                       error_feedback=True, staleness=1, log=False)
    torch.cuda.synchronize()
    counts = getattr(ops, "wire_pipelined_instance_counts", dict)()
    return {"checkout": str(root), "wall_s": time.perf_counter() - t0,
            "epoch_s": run["history"]["epoch_s"],
            "loss": run["history"]["loss"],
            "kernel8_launches": ops.launch_counts()[
                "bucketed_gossip_round_pipelined"],
            "kernel8_instances": counts}


def epochs_in_turns(other: pathlib.Path, smi: str) -> None:
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root)], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise RuntimeError(f"the {label} epoch failed")
        rec = {"run": label, **json.loads(proc.stdout.strip()
                                          .splitlines()[-1])}
        runs.append(rec)
        print(json.dumps({"phase": "wire_stale_epoch", **rec}), flush=True)
    second = {label: [r["epoch_s"][1] for r in runs if r["run"] == label]
              for label in ("other", "this")}
    same_loss = len({json.dumps(r["loss"]) for r in runs}) == 1
    print(json.dumps({"phase": "wire_stale_epoch_vs_parent",
                      "second_epoch_s": second,
                      "mean_s": {k: sum(v) / len(v)
                                 for k, v in second.items()},
                      "losses_equal": same_loss, "device": smi}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve())), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("wire_kernels_vs_parent: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.kernels import _build
    from repro_torch.kernels import consensus_mix as this_cm
    parent = args.parent.resolve() / "src/repro_torch/kernels"
    spec = importlib.util.spec_from_file_location("other_build",
                                                  parent / "_build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    other_cm = load(parent / "consensus_mix.py", "other_consensus_mix",
                    other_build)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # both checkouts' kernels at once (the epochs load three sources each)
    import threading
    builds = [threading.Thread(target=b.compile_all, args=(b.sources(),))
              for b in (_build, other_build)]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    print(json.dumps({"phase": "build", "ptxas": [
        line.strip() for line in _build.build_logs.get(
            "quantized_wire", "").splitlines()
        if "Used" in line or "spill" in line or "Compiling" in line]}),
          flush=True)
    with torch.inference_mode():
        kernels(torch, {"other": other_cm, "this": this_cm}, args.reps, smi)
        twopass_shapes(torch, {"other": other_cm, "this": this_cm},
                       args.reps, smi)
    epochs_in_turns(args.parent.resolve(), smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
