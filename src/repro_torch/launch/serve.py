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

``serve(..., mesh=)`` serves on one rank of the serve mesh ("data",
"model") (``launch.mesh.make_serve_mesh``, or a ``RankMesh(("data",
"model"), (D, T))`` of any size): the program the reference's
``build_prefill_lowering`` / ``build_decode_lowering`` partition over it.
Every rank draws the same whole weights and prompts from the seed as one
process does, keeps its pieces of the weights (``serve_pieces``:
``local_shard`` under ``serve_param_specs`` without FSDP over "data"; the
attention whole where the heads do not divide "model", ``attn_tp=False``;
where only the kv heads do not divide it, the kv heads its q heads read)
and its share of the batch over "data" where the batch divides it
(``batch_rows``); the ranks of a model group draw in turn, each freeing
the whole tree once it has cut its pieces (``draw_pieces``), so one card's
ranks hold one whole tree at a time.  It serves tensor parallel over
"model" (``launch.tp``): its heads (kernel 3 on them in the prefill; an
MLA layer's absorbed decode against the whole latent; a Mamba layer's
scan, kernel 9, and its SSM state on them), its d_ff columns, its experts
drop-free (or, where they do not divide "model", every expert's d_ff
columns), its vocab slice of the logits, all-gathered whole (site
``tp_logits``) before the token is sampled as one process samples it, so
every rank of a model group feeds the same token.  Every family runs so;
a Mamba or MLA head count that "model" does not divide is refused by name
(``models.transformer.serve_tp_refusal``).  There is no CLI flag for it,
as the reference's ``serve`` CLI has no mesh: start it under
``torch.distributed.run`` from a short Python entry::

    import torch.distributed as dist
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.serve import serve
    dist.init_process_group("gloo")          # or "nccl", one card a rank
    res = serve("qwen3-1.7b", smoke=False, batch=4, prompt_len=1024, gen=64,
                mesh=RankMesh(("data", "model"), (1, 4)))

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
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
from repro_torch.launch.train import resolve_device, set_full_f32
from repro_torch.models import transformer as tf
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map_with_path,
                               tree_unflatten)


def sample_token(logits: torch.Tensor, gen: torch.Generator, *,
                 temperature: float = 0.0,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling from ``gen``.
    logits: (b, 1, v) -> (b, 1) int64.  A temperature draw is
    ``torch.multinomial``'s one-sample draw, the exponential race: the
    argmax of p / q with q ~ Exp(1) drawn for every row of the batch.
    ``rows`` ``(lo, batch)``: ``logits`` are rows ``[lo, lo + b)`` of a
    batch of ``batch``, which take the draws those rows of the whole batch
    take, so a rank serving its rows samples what one process samples."""
    if temperature <= 0.0:
        return torch.argmax(logits[:, -1], dim=-1)[:, None]
    probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    b, v = probs.shape
    lo, batch = rows or (0, b)
    q = torch.empty((batch, v), device=probs.device).exponential_(
        generator=gen)
    return torch.argmax(probs / q[lo:lo + b], dim=-1)[:, None]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch_id: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, max_len: Optional[int] = None,
          temperature: float = 0.0, seed: int = 0,
          cache_dtype=torch.float32, device: str = "cuda",
          mesh=None, param_dtype=torch.float32) -> Dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens each, with weights and prompts drawn from one generator
    seeded with ``seed`` (weights first, in ``param_dtype``, ``draw``).
    An arch with a
    frontend gets its embeddings as the reference's ``serve`` makes them:
    ``num_tokens`` of them (``prompt_len`` where that is 0), normal times
    0.02, as ``patch_embeds`` ahead of the tokens (vision) or as the
    encoder's ``frames`` (audio).  ``max_len`` defaults to ``prompt_len +
    gen`` as in the reference, so a vision prompt longer than that keeps
    only its last ``max_len`` positions in every layer's cache.  With a
    serve ``mesh`` (a ``launch.mesh.RankMesh`` over ("data", "model"), its
    process group initialised) this process serves its rank's pieces
    (``draw_pieces``) and rows (``batch_rows``) tensor parallel over
    "model", each step's logits gathered whole before sampling.  Returns
    the generated tokens of the rows served (``rows``: (lo, hi)), the
    prompt and ``inputs`` (the whole batch's), and the prefill and decode
    seconds (host clock, the device synchronised before each read) with
    the decode rate of the rows served in tokens per second."""
    dev = resolve_device(device)
    set_full_f32()
    cfg = get_smoke(arch_id) if smoke else get_arch(arch_id)
    max_len = max_len or (prompt_len + gen)
    tp, lo, hi = None, 0, batch
    if mesh is None:
        params, inputs = draw(cfg, batch, prompt_len, seed, dev, param_dtype)
    else:
        params, tp, inputs = draw_pieces(cfg, batch, prompt_len, seed, dev,
                                         mesh, param_dtype)
        lo, hi = batch_rows(mesh, batch)
    mine = {k: v[lo:hi] for k, v in inputs.items()}
    opts = tf.ApplyOptions(attn_impl="kernel", moe_no_drop=True, tp=tp)
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)

    def sample(logits):
        if tp is not None:
            logits = tp.gather_logits(logits)
        return sample_token(logits, sampler, temperature=temperature,
                            rows=(lo, batch))

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, cfg, mine, max_len=max_len,
                               cache_dtype=cache_dtype, opts=opts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = [sample(logits)]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = tf.decode_step(params, cfg, tokens[-1], cache, tp=tp)
        tokens.append(sample(logits))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"generated": torch.cat(tokens, dim=1), "rows": (lo, hi),
            "prompt": inputs["tokens"], "inputs": inputs,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": (hi - lo) * (gen - 1) / max(t_decode, 1e-9)}


def draw(cfg, batch: int, prompt_len: int, seed: int, dev: torch.device,
         dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``serve``'s draws from one generator seeded with ``seed``: the whole
    weights in ``dtype``, then ``batch`` prompts of ``prompt_len`` tokens
    and a frontend's embeddings (``inputs``)."""
    rng = torch.Generator(device=dev).manual_seed(seed)
    params = tf.init_params(rng, cfg, dtype, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=rng, device=dev)
    inputs = {"tokens": prompt}
    if cfg.frontend is not None:
        n = cfg.frontend.num_tokens or prompt_len
        name = ("patch_embeds" if cfg.frontend.kind == "vision_patches"
                else "frames")
        inputs[name] = torch.randn((batch, n, cfg.d_model), generator=rng,
                                   device=dev) * 0.02
    return params, inputs


def draw_pieces(cfg, batch: int, prompt_len: int, seed: int,
                dev: torch.device, mesh, dtype=torch.float32
                ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """``(pieces, tp, inputs)``: ``draw``'s whole weights cut to this rank's
    pieces (``serve_pieces``) and the whole inputs.  The ranks of a model
    group draw in turn, in their order over "model", each freeing the
    whole tree once its pieces are cut, a barrier on the group between one
    rank's cut and the next rank's draw: ranks sharing a card hold one
    whole tree at a time beside their pieces."""
    import torch.distributed as dist
    group = mesh.group_over(("model",))     # every rank, before the turns
    pieces = tp = inputs = None
    for turn in range(mesh.shape["model"]):
        if turn == mesh.coords()["model"]:
            params, inputs = draw(cfg, batch, prompt_len, seed, dev, dtype)
            pieces, tp = serve_pieces(params, cfg, mesh)
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if group is not None:
            dist.barrier(group=group)
    return pieces, tp, inputs


#: the kv leaves a rank keeps as the kv heads its q heads read
_HELD_KV = ("w_k", "w_v", "b_k", "b_v")


def serve_pieces(params, cfg, mesh) -> Tuple[Any, Any]:
    """``(pieces, tp)``: this rank's pieces of the whole ``params`` on the
    serve ``mesh`` (``local_shard`` under ``serve_param_specs`` without
    FSDP over "data", each copied out of the whole leaf) and its
    ``launch.tp.ModelParallel`` over "model", with ``attn_tp`` false where
    the heads do not divide the axis (the attention leaves then whole).
    Where the q heads divide the axis and the kv heads do not, the
    reference's spec cuts ``w_k`` / ``w_v`` along the head dim
    (``launch.sharding.KV_HD_FALLBACK``), and every pass would gather them
    whole; the rank keeps instead the kv heads its q heads read
    (``models.modules.tp_kv_range``) of ``w_k`` / ``w_v`` / ``b_k`` /
    ``b_v``, cut once here from the whole leaves, as its cache keeps
    them."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.tp import ModelParallel
    from repro_torch.models import modules as nn
    why = tf.serve_tp_refusal(cfg, mesh.shape["model"])
    if why is not None:
        raise ValueError(why)
    attn_tp = cfg.num_heads % mesh.shape["model"] == 0
    tp = ModelParallel.of(mesh, attn_tp)
    held = (slice(*nn.tp_kv_range(cfg, tp))
            if attn_tp and cfg.num_kv_heads % tp.size else None)
    specs = shd.serve_param_specs(params, mesh, fsdp=False, attn_tp=attn_tp)
    names = tree_leaves(tree_map_with_path(
        lambda path, _: shd._leaf_name(path), params))
    leaves, treedef = tree_flatten(params)
    pieces = [(x[..., held, :] if held is not None and name in _HELD_KV
               else shd.local_shard(x, sp, mesh)).clone(
                   memory_format=torch.contiguous_format)
              for x, sp, name in zip(leaves, tree_leaves(specs), names)]
    return tree_unflatten(treedef, pieces), tp


def batch_rows(mesh, batch: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a ``batch`` this rank serves: its share
    over "data" where the batch divides it, else every row (the
    reference's ``_serve_split``)."""
    data = mesh.shape["data"]
    if batch % data:
        return 0, batch
    n = batch // data
    c = mesh.coords()["data"]
    return c * n, (c + 1) * n


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
