"""Serving entry point on PyTorch: port of ``repro.launch.serve``.

Batched prefill, then a synchronous greedy (or temperature) decode loop over
the cache (KV slots for attention layers, the conv window and SSM state for
Mamba-2 layers, the latent for MLA layers).  The prefill runs on the kernel
route (``attn_impl="kernel"``): its attention on the flash-attention kernel
and a Mamba-2 layer's scan on the SSD-scan kernel on the card (``--device
cpu`` runs their plain versions on the CPU), every norm on the RMSNorm
kernel; MLA attention takes the reference route, as in the reference.  MoE
runs drop-free (``moe_no_drop``: every expert takes every token), as the
reference's ``serve`` sets it.  float32 matmuls run in full float32: TF32 is
switched off.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --full --batch 4 --prompt-len 1024 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --full --batch 4 --prompt-len 1024 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --device cpu          # also command-r-35b, internvl2-1b,
                              # seamless-m4t-large-v2, mixtral-8x22b,
                              # deepseek-v2-236b, jamba-1.5-large-398b
                              # (smoke configs)
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
from repro_torch.launch.train import resolve_device, set_full_f32
from repro_torch.models import transformer as tf


def sample_token(logits: torch.Tensor, gen: torch.Generator, *,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling from ``gen``.
    logits: (b, 1, v) -> (b, 1) int64."""
    if temperature <= 0.0:
        return torch.argmax(logits[:, -1], dim=-1)[:, None]
    probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch_id: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, max_len: Optional[int] = None,
          temperature: float = 0.0, seed: int = 0,
          cache_dtype=torch.float32, device: str = "cuda") -> Dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens each, with weights and prompts drawn from one generator
    seeded with ``seed`` (weights first).  An arch with a frontend gets its
    embeddings as the reference's ``serve`` makes them: ``num_tokens`` of
    them (``prompt_len`` where that is 0), normal times 0.02, as
    ``patch_embeds`` ahead of the tokens (vision) or as the encoder's
    ``frames`` (audio).  ``max_len`` defaults to ``prompt_len + gen`` as in
    the reference, so a vision prompt longer than that keeps only its last
    ``max_len`` positions in every layer's cache.  Returns the generated
    tokens (batch, gen), the prompt, and the prefill and decode seconds
    (host clock, the device synchronised before each read) with the decode
    rate in tokens per second."""
    dev = resolve_device(device)
    set_full_f32()
    cfg = get_smoke(arch_id) if smoke else get_arch(arch_id)
    max_len = max_len or (prompt_len + gen)
    rng = torch.Generator(device=dev).manual_seed(seed)
    params = tf.init_params(rng, cfg, device=dev)
    opts = tf.ApplyOptions(attn_impl="kernel", moe_no_drop=True)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=rng, device=dev)
    inputs = {"tokens": prompt}
    if cfg.frontend is not None:
        n = cfg.frontend.num_tokens or prompt_len
        name = ("patch_embeds" if cfg.frontend.kind == "vision_patches"
                else "frames")
        inputs[name] = torch.randn((batch, n, cfg.d_model), generator=rng,
                                   device=dev) * 0.02
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, cfg, inputs, max_len=max_len,
                               cache_dtype=cache_dtype, opts=opts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = [sample_token(logits, sampler, temperature=temperature)]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = tf.decode_step(params, cfg, tokens[-1], cache)
        tokens.append(sample_token(logits, sampler, temperature=temperature))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"generated": torch.cat(tokens, dim=1), "prompt": prompt,
            "inputs": inputs, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-1.7b",
                   help="an arch id, dashes or underscores: "
                        + ", ".join(ARCH_IDS))
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--full", dest="smoke", action="store_false")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    res = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                temperature=args.temperature, seed=args.seed,
                device=args.device)
    print(f"prefill: {res['prefill_s']:.2f}s   "  # repro: ignore[print-in-library]: CLI entry point
          f"decode: {res['decode_s']:.2f}s "
          f"({res['tok_per_s']:.1f} tok/s aggregate)")
    print("first generated row:", res["generated"][0].tolist())  # repro: ignore[print-in-library]: CLI entry point


if __name__ == "__main__":
    main()
