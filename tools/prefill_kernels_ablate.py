#!/usr/bin/env python3
"""Where kernels 9 (SSD scan) and 3 (flash attention) spend their time, on
the card: each run here removes one part of a kernel and times what is left.

    python3 tools/prefill_kernels_ablate.py

Each ablation is this checkout's ``src/`` copied under
``build/ablate/<name>/`` with one edit to a CUDA source (a loop that runs
zero times, a copy that is not made), built there by that copy's own
``_build.py``, and timed against this checkout's kernels at the prefill
shapes of ``prefill_kernels_vs_parent.py``, in turns (ablation, this, this,
ablation).  The ablated kernels compute wrong results: only their times
mean anything.  Prints one JSON line per ablation, then the card's name and
power limit.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import prefill_kernels_vs_parent as pv

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"

# name -> (source, [(text, replacement, occurrences)])
ABLATIONS = {
    "ssd_no_mma": ("ssd_scan.cu", [(
        "  for (int k = 0; k < kTK; ++k) {",
        "  for (int k = 0; k < (lda < 0 ? kTK : 0); ++k) {", 1)]),
    "ssd_no_copy_after_first_tile": ("ssd_scan.cu", [(
        "    fetch(it + kStages - 1);", "    cp_async_commit();", 2)]),
    "ssd_no_transform": ("ssd_scan.cu", [
        ("    if (k0 < t0) {  // keys",
         "    if (p.b > 0) {\n    } else if (k0 < t0) {  // keys", 1),
        ("      for (int k = tid / (dsp / 4); k < kTK;",
         "      for (int k = tid / (dsp / 4); k < (p.b > 0 ? 0 : kTK);", 1)]),
    "flash_no_scores": ("flash_attention.cu", [(
        "    for (int m = 0; m < kUnits / 2; ++m) {",
        "    for (int m = 0; m < (p.b < 0 ? kUnits / 2 : 0); ++m) {", 1)]),
    "flash_no_softmax": ("flash_attention.cu", [
        ("    float mx[8];\n", "    float mx[8];\n    if (p.b < 0) {\n", 1),
        ("acc[i][c] *= mx[i];\n    }\n",
         "acc[i][c] *= mx[i];\n    }\n    }\n", 1)]),
    "flash_no_pv": ("flash_attention.cu", [(
        "    for (int k = 0; k < kTK; ++k) {",
        "    for (int k = 0; k < (p.b < 0 ? kTK : 0); ++k) {", 1)]),
}


def make_copy(name: str) -> pathlib.Path:
    """build/ablate/<name>/src: this checkout's src, the ablation's edit
    made."""
    source, edits = ABLATIONS[name]
    root = ROOT / "build" / "ablate" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / CSRC / source
    text = path.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} "
                               f"times in {source}, not {count}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import importlib.util
    from repro_torch.kernels import flash_attention as this_fa
    from repro_torch.kernels import ssd_scan as this_ssd
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, nh, hd, ds, chunk = pv.SSD_SHAPE
    xbc = torch.randn((b, s, nh * hd + 2 * ds), device=dev, generator=g)
    xbc[..., nh * hd:] *= 0.5
    ssd_args = (xbc[..., :nh * hd].view(b, s, nh, hd),
                xbc[..., nh * hd:nh * hd + ds].view(b, s, 1, ds),
                xbc[..., nh * hd + ds:].view(b, s, 1, ds),
                torch.nn.functional.softplus(
                    torch.randn((b, s, nh), device=dev, generator=g)),
                -torch.arange(1, nh + 1, dtype=torch.float32, device=dev))
    b, sq, sk, h, kvh, hd = pv.FLASH_SHAPE
    fa_args = (torch.randn((b, sq, h, hd), device=dev, generator=g),
               torch.randn((b, sk, kvh, hd), device=dev, generator=g),
               torch.randn((b, sk, kvh, hd), device=dev, generator=g))
    copies = {}
    for name, (source, _) in ABLATIONS.items():
        kernels = make_copy(name) / "src/repro_torch/kernels"
        spec = importlib.util.spec_from_file_location(f"{name}_build",
                                                      kernels / "_build.py")
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        copies[name] = (kernels, build)
    with ThreadPoolExecutor(len(copies)) as pool:  # one nvcc a copy, at once
        list(pool.map(lambda n: copies[n][1].compile_all(
            [pathlib.Path(ABLATIONS[n][0]).stem]), copies))
    with torch.inference_mode():
        for name, (source, _) in ABLATIONS.items():
            kernels, build = copies[name]
            if source == "ssd_scan.cu":
                mod = pv.load(kernels / "ssd_scan.py", f"{name}_ssd", build)
                fns = {n: (lambda m=m: m.ssd_scan_cuda(*ssd_args, chunk=chunk))
                       for n, m in (("other", mod), ("this", this_ssd))}
            else:
                mod = pv.load(kernels / "flash_attention.py", f"{name}_fa",
                              build)
                fns = {n: (lambda m=m: m.flash_attention_cuda(*fa_args))
                       for n, m in (("other", mod), ("this", this_fa))}
            times = pv.in_turns(torch, fns, 20)
            print(json.dumps({"phase": "ablation", "name": name,
                              "ablated": times["other"],
                              "this": times["this"]}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
