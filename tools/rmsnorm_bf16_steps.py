#!/usr/bin/env python3
"""Kernel 2's bf16 backward against its plain version in bf16 steps, on the
card.

    python3 tools/rmsnorm_bf16_steps.py

At every bf16 shape of ``chip_smoke.RMSNORM_SHAPES`` (inputs from one
generator, seed 0) it runs ``ops.rmsnorm`` forward and backward under
autograd and ``ref.rmsnorm_bwd_ref``, and prints one JSON line a shape:
for dx and dscale the most bf16 steps between the two, how many elements
differ by more than one, and at the element with the most steps both
values, the plain version's f32 value before its rounding, the float64
value of the same formula on the same bf16 inputs, and the magnitude of
dx's two terms (|r g s| + |x r^3 mean(g s x)|): where dx cancels far
below its terms, two f32 results a few f32 ulps of the terms apart round
to bf16 values many steps apart; the same for dscale, whose column sums
over the rows cancel too (its terms: sum over rows of |g x r|).  Then the
card's name and power limit.  Needs one NVIDIA GPU.

    python3 tools/rmsnorm_bf16_steps.py --tp-mamba

takes instead Jamba-1.5-Large's first-layer training rows with its gated
norm run on whole d_inner rows, (256, 8192), (254, 8192) and (256,
16384), drawn as ``chip_smoke.local_norm_check`` draws them (its
generator seeded with ``TP_MAMBA_NORM_SEED``, x, scale and upstream
gradient a shape in turn): the draws where a dscale column cancels.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def ordered(torch, t):
    bits = t.view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_bf16_steps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    _build.compile_all(["rmsnorm"])
    dev = torch.device("cuda")
    if "--tp-mamba" in sys.argv[1:]:
        g = torch.Generator(device=dev).manual_seed(cs.TP_MAMBA_NORM_SEED)
        shapes = [(256, 8192), (254, 8192), (256, 16384)]
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        shapes = [(r, d) for r, d, dtype, _, _ in cs.RMSNORM_SHAPES
                  if dtype == "bfloat16"]
    for rows, d in shapes:
        x = torch.randn((rows, d), device=dev, generator=g).bfloat16()
        s = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
        gy = torch.randn((rows, d), device=dev, generator=g).bfloat16()
        xg, sg = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
        dx, ds = torch.autograd.grad(ops.rmsnorm(xg, sg), (xg, sg), gy)
        dx_ref, ds_ref = ref.rmsnorm_bwd_ref(x, s, gy)
        xf, gf, sf = x.float(), gy.float(), s.float()
        r = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        mean = torch.mean(gf * sf * xf, -1, keepdim=True)
        terms = (r * gf * sf).abs() + (xf * r ** 3 * mean).abs()
        dx32 = r * gf * sf - xf * r ** 3 * mean
        x64, g64, s64 = x.double(), gy.double(), s.double()
        r64 = torch.rsqrt(torch.mean(x64 * x64, -1, keepdim=True) + 1e-6)
        dx64 = r64 * g64 * s64 - x64 * r64 ** 3 * torch.mean(
            g64 * s64 * x64, -1, keepdim=True)
        xr64 = x64 * r64
        ds64 = (g64 * xr64).sum(0)
        ds_terms = (g64 * xr64).abs().sum(0)
        ds32 = (gf * xf * r).sum(0)
        out = {"rows": rows, "d": d}
        for name, got, want in (("dx", dx, dx_ref), ("dscale", ds, ds_ref)):
            steps = (ordered(torch, got) - ordered(torch, want)).abs()
            i = int(steps.reshape(-1).argmax())
            row = {"max_steps": int(steps.max()),
                   "n_over_1": int((steps > 1).sum()),
                   "got": float(got.reshape(-1)[i]),
                   "want": float(want.reshape(-1)[i]),
                   "max_abs": float(want.float().abs().max())}
            if name == "dx":
                row.update(want_f32=float(dx32.reshape(-1)[i]),
                           f64=float(dx64.reshape(-1)[i]),
                           terms=float(terms.reshape(-1)[i]))
            else:
                row.update(
                    want_f32=float(ds32[i]), f64=float(ds64[i]),
                    terms=float(ds_terms[i]),
                    got_f64_err=float((got.double() - ds64).abs().max()),
                    want_f64_err=float((want.double() - ds64).abs().max()),
                    f64_steps_got=int((ordered(torch, got) - ordered(
                        torch, ds64.bfloat16())).abs().max()),
                    f64_steps_want=int((ordered(torch, want) - ordered(
                        torch, ds64.bfloat16())).abs().max()))
            out[name] = row
        print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
