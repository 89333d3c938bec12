"""Meta-device dry run: every (arch x shape x mesh) device program at full
width and depth on ``device="meta"``, with its memory, FLOPs, collectives
and roofline terms (port of ``repro.launch.dryrun``).

Nothing is computed: a meta tensor has a shape and a dtype and no storage,
so a program runs as shape arithmetic (the kernels' plain versions, since
``kernels.ops`` sends any tensor that is not on CUDA to them), on any host.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 34 sp pairs
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Each run writes experiments/dryrun_torch/<arch>_<shape>_<sp|mp>.json.
Every number in it carries a label: ``measured_meta`` (read off the device
program's meta run: the local shapes' bytes, the peak of live meta storage,
``FlopCounterMode``'s FLOPs, the collective record of the rank's local
step (its client's FSDP gathers and gradient reductions, ``launch.fsdp``,
and the TP collectives over "model", ``launch.tp``, of every family: the
dense decoders, the encoder-decoder, the MoE and MLA families and Mamba-2
with Jamba; the vision frontend's plan splits the batch over "model") and
consensus period against ``consensus.DryGroup``s, and of a serve
program's TP over "model" for every family (the rank's pieces and cache,
``launch.serve.serve(mesh=)``'s layout)) or ``analytic_split`` (a part
the port runs whole where the reference shards it, divided evenly by the
plan's degree, ``meta["compute_shards"]``: the sequence over "data" at
``long_500k``'s batch of 1; the serving weights' FSDP over
"data" (``serve_fsdp``: Gemma-2, Command-R and the 140-400B plans), held
as the plan's pieces; and the roofline's napkin terms on the H100
datasheet constants of ``launch.roofline``).  None is a measurement on a
device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES
from repro_torch.core import consensus as cns
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import build_program, supported_pairs
from repro_torch.tree import tree_leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

MEASURED = "measured_meta"
SPLIT = "analytic_split"


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class LiveStorage(TorchDispatchMode):
    """The bytes of live tensor storage while a program runs: every
    storage an op returns counts from its first tensor until its last
    tensor is freed (``weakref.finalize``); ``peak`` is the largest total.
    Storages alive before the mode (the arguments) count from the start
    when ``track`` is given them."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def track(self, tensors) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out if isinstance(out, (tuple, list))
                             else [out]):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


def measure(bundle) -> Dict[str, Any]:
    """Run each stage of ``bundle`` once on its meta arguments, in order,
    under one live-storage tracker, each under its own FLOP counter and
    collective record.  Per stage: its FLOPs, its working set (the peak of
    live storage over the arguments while it runs) and its collectives;
    ``collectives`` is the program's: each stage's record times its
    ``repeats`` (a local step's gathers and reductions recur every
    microbatch step)."""
    tracker = LiveStorage()
    stage_flops, stage_work, stage_coll = {}, {}, {}
    t0 = time.perf_counter()
    with tracker:
        tracker.track(tree_leaves([list(st.args) for st in bundle.stages]))
        base = tracker.live
        for st in bundle.stages:
            cns.reset_collective_counts()
            tracker.peak = start = tracker.live
            with FlopCounterMode(display=False) as fc:
                out = st.fn(*st.args)
                del out
            stage_flops[st.name] = fc.get_total_flops()
            stage_work[st.name] = tracker.peak - start
            stage_coll[st.name] = cns.collective_counts()
    run_s = time.perf_counter() - t0
    total: Dict[str, Dict[str, Any]] = {"calls": {}, "bytes": {},
                                        "sites": {}}
    for st in bundle.stages:
        for part, counts in total.items():
            for k, v in stage_coll[st.name][part].items():
                counts[k] = counts.get(k, 0) + v * st.repeats
    return {"stage_flops": stage_flops, "stage_work": stage_work,
            "args_bytes": base, "run_s": run_s,
            "stage_collectives": stage_coll, "collectives": total}


def consensus_record(server_abs: Any, mesh_spec, a, t_server: int, *,
                     rank: int = 0, tp_axis: Optional[str] = "model",
                     compression: str = "none",
                     error_feedback: bool = False, wire: str = "simulated",
                     staleness: int = 0) -> Dict[str, Any]:
    """The collective record (``consensus.collective_counts()``) of one
    consensus period of rank ``rank``'s pieces of ``server_abs`` (leaves
    ``(M, *w)``; only their shapes are read) on the FL mesh of
    ``mesh_spec`` (a ``launch.mesh.FLMeshSpec`` of any size), run on meta
    against ``consensus.DryGroup``s with the mixing matrix ``a``: the
    bytes a real world of that mesh sends, without the world."""
    import numpy as np

    from repro_torch.comm.compressors import make_compressor
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import fl_rank_mesh
    mesh = fl_rank_mesh(mesh_spec, rank=rank, dry=True)
    leaf_specs = shd.fl_server_specs(server_abs, mesh, tp_axis=tp_axis)
    backend = cns.ShardMapBackend(mesh, np.asarray(a, np.float32), t_server,
                                  leaf_specs, staleness=staleness)
    compressed = compression != "none"
    if compressed:
        backend = cns.CompressedBackend(
            backend, make_compressor(compression),
            error_feedback=error_feedback, wire=wire)
    piece = sp.local_meta(server_abs, leaf_specs, mesh)
    residual = (sp.tree_map(torch.empty_like, piece)
                if compressed and error_feedback else None)
    cns.reset_collective_counts()
    sp.consensus_program(backend, compressed)(piece, residual)
    return cns.collective_counts()


def device_numbers(bundle, got: Dict[str, Any]) -> Dict[str, Any]:
    """Per device: FLOPs (each stage's times its repeats, a split stage's
    divided by ``compute_shards``) and the peak (the argument bytes of the
    plan's local shapes plus the largest stage working set, a split
    stage's divided likewise); labelled ``analytic_split`` where a split
    stage entered them, or where the serving weights' FSDP over "data"
    (``serve_fsdp``) is the plan's arithmetic (the program holds its
    "model" pieces whole over "data")."""
    shards = bundle.meta["compute_shards"]
    flops, peak_work = 0.0, 0.0
    split = bool(bundle.meta.get("serve_fsdp"))
    for st in bundle.stages:
        div = shards if st.split and shards > 1 else 1
        split = split or div > 1
        flops += got["stage_flops"][st.name] * st.repeats / div
        peak_work = max(peak_work, got["stage_work"][st.name] / div)
    args_dev = sum(bundle.arg_parts.values())
    return {"flops": flops, "args_bytes": args_dev,
            "peak_bytes": args_dev + peak_work,
            "label": SPLIT if split else MEASURED}


def run_one(arch_id: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: Optional[str] = None, verbose: bool = True,
            save: bool = True, **kw) -> dict:
    t0 = time.perf_counter()
    bundle = build_program(arch_id, shape_name, multi_pod=multi_pod, **kw)
    got = measure(bundle)
    meta, chips = bundle.meta, bundle.mesh.size()
    dev = device_numbers(bundle, got)
    label = dev["label"]
    coll = rl.collective_bytes(got["collectives"])
    report = rl.roofline(meta, chips, {"flops": dev["flops"],
                                       "bytes accessed": dev["args_bytes"]},
                         coll, dev["peak_bytes"])

    def num(value, lab):
        return {"value": value, "label": lab}

    row_labels = {k: SPLIT for k in ("compute_s", "memory_s", "model_flops",
                                     "analytic_bytes_per_device")}
    row_labels.update({"collective_s": MEASURED,
                       "collective_bytes_per_device": MEASURED,
                       "program_flops_per_device": label,
                       "program_bytes_per_device": MEASURED,
                       "useful_ratio": label,
                       "bytes_per_device_peak": label})
    rec = {
        "meta": meta,
        "mesh_axes": dict(bundle.mesh.shape),
        "chips": chips,
        "memory": {
            "argument_bytes": num(dev["args_bytes"], MEASURED),
            "argument_parts": {k: num(v, MEASURED)
                               for k, v in bundle.arg_parts.items()},
            "program_args_bytes": num(got["args_bytes"], MEASURED),
            "stage_working_set": {k: num(v, MEASURED)
                                  for k, v in got["stage_work"].items()},
            "peak_per_device": num(dev["peak_bytes"], label),
        },
        "cost": {"stage_flops": {k: num(v, MEASURED)
                                 for k, v in got["stage_flops"].items()},
                 "stage_repeats": {st.name: st.repeats
                                   for st in bundle.stages},
                 "flops_per_device": num(dev["flops"], label)},
        "collectives": {
            "bytes_by_kind": num(coll.bytes_by_kind, MEASURED),
            "count_by_kind": num(coll.count_by_kind, MEASURED),
            "total_bytes": num(coll.total_bytes, MEASURED),
            "record": got["collectives"],
            "stage_records": {
                k: {part: v[part] for part in ("calls", "bytes", "sites")}
                for k, v in got["stage_collectives"].items()},
        },
        "roofline": {k: (num(v, row_labels[k]) if k in row_labels else v)
                     for k, v in report.row().items()},
    }
    if verbose:
        peak = dev["peak_bytes"]
        print(f"[dryrun] {bundle.name}: {time.perf_counter() - t0:.1f}s "
              f"peak/dev={peak / 1e9:.2f} GB "
              f"({100 * peak / rl.H100_HBM_BYTES:.0f}% of H100 HBM, "
              f"{label}) coll/dev={coll.total_bytes:.3g}B "
              f"dominant={report.dominant}", flush=True)
    if save:
        d = out_dir or os.path.abspath(OUT_DIR)
        os.makedirs(d, exist_ok=True)
        tag = "mp" if multi_pod else "sp"
        path = os.path.join(
            d, f"{arch_id.replace('-', '_')}_{shape_name}_{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", help="architecture id (e.g. qwen3-1.7b)")
    p.add_argument("--shape", choices=tuple(INPUT_SHAPES),
                   help="input shape name")
    p.add_argument("--all", action="store_true",
                   help="run every supported (arch, shape) pair")
    p.add_argument("--multi-pod", action="store_true",
                   help="2-pod (2,16,16) mesh instead of single-pod (16,16)")
    p.add_argument("--consensus-mode", default=None,
                   choices=("gossip", "gossip_blocked", "gossip_shardmap",
                            "collapsed", "chebyshev", "exact_mean"),
                   help="override the per-plan consensus backend selection "
                        "(plans.DeploymentPlan.consensus_backend)")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        p.error("give --arch and --shape, or --all")

    pairs = (supported_pairs() if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch_id, shape_name in pairs:
        kw = {}
        if shape_name == "train_4k" and args.consensus_mode:
            kw["consensus_mode"] = args.consensus_mode
        try:
            run_one(arch_id, shape_name, multi_pod=args.multi_pod,
                    out_dir=args.out_dir, **kw)
        except Exception as e:  # noqa: BLE001 — report-all then fail
            failures.append((arch_id, shape_name, repr(e)))
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        raise SystemExit(1)
    print(f"\nall {len(pairs)} dry runs ran OK "
          f"({'multi-pod' if args.multi_pod else 'single-pod'})")


if __name__ == "__main__":
    main()
