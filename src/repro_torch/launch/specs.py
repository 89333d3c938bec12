"""One device's program for every (arch x shape), with meta-tensor inputs
(port of ``repro.launch.specs``).

The reference pairs abstract inputs with a jitted step over a device mesh
and lets the partitioner cut it; the port builds, for one rank of the
plan's ``RankMesh``, the program that rank runs and its arguments as
``device="meta"`` tensors (shapes and dtypes, no storage), cut to the
rank's local shapes where the plan shards them.

Shape -> program:
    train_4k     the rank's piece of a client's local period (T_C SGD
                 steps at the device's batch) then the consensus period on
                 the rank's piece of its server's row, over the plan's mesh
    prefill_32k  prefill          (full prompt -> KV cache)
    decode_32k   decode_step      (ONE token against a 32k cache)
    long_500k    decode_step      (ONE token against a 524k cache/state)

A train program's local step is the rank's piece of its client: FSDP over
"replica", the batch over "replica" and, under ``batch_over_model``,
"model", and tensor parallelism over "model" for the dense decoders
(qwen3, gemma2, command_r), the encoder-decoder (seamless), the MoE and
MLA families (mixtral, deepseek_v2) and Mamba-2 (mamba2, jamba) run as the
rank-local epoch step runs them (``launch.fsdp``, ``launch.tp``: their
gathers and reductions against ``consensus.DryGroup``s); the vision
frontend's plan (internvl2, as smollm's) splits the batch over "model".
A serve program of every family runs the rank's "model" pieces, its
share of the batch over "data" and its cache (an MLA layer's latent
whole, a mamba layer's conv window with B and C whole beside its heads'
x channels), TP over a ``DryGroup``, as ``launch.serve.serve(mesh=)``
runs them, then the logits' gather.  Where the reference shards a
computation the port runs whole (the sequence-sharded long-context cache
at a batch of 1; a family ``transformer.serve_tp_refusal`` names) or
holds whole (the serving weights' FSDP over "data"),
``meta["unsharded"]`` names it; a computation run whole is divided by
``meta["compute_shards"]``, the plan's degree.
Modality carve-out: audio / vlm archs get precomputed frame / patch
embeddings as extra batch leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.comm.compressors import bucket_block
from repro_torch.configs import INPUT_SHAPES, ArchConfig, InputShape, get_arch
from repro_torch.core import FLTopology
from repro_torch.core import consensus as cns
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import RankMesh, make_fl_mesh, make_serve_mesh
from repro_torch.launch.plans import DeploymentPlan, plan_for
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

META = torch.device("meta")


@dataclasses.dataclass
class Stage:
    """One stage of a device program: ``fn(*args)`` on meta arguments at the
    device's shapes, which the program runs ``repeats`` times over (a
    client's local period is T_C x n_micro identical microbatch steps: the
    stage is one of them)."""

    name: str
    fn: Callable
    args: Tuple[Any, ...]
    repeats: int = 1
    #: whether the stage runs whole what the reference splits over
    #: ``meta["compute_shards"]`` ranks (the consensus stage is already
    #: the rank's piece)
    split: bool = True


@dataclasses.dataclass
class ProgramBundle:
    """Everything the dry run needs for one (arch, shape, mesh) program:
    its ``stages`` in order; ``arg_parts`` names the argument bytes a
    device holds by part (state, batch, cache, EF residual, wire
    references), each from the plan's local shapes."""

    name: str
    mesh: RankMesh
    stages: Tuple[Stage, ...]
    meta: Dict[str, Any]
    arg_parts: Dict[str, int]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _local_bytes(tree: Any, specs: Any, mesh: RankMesh) -> int:
    """Bytes of one rank's pieces of ``tree`` under ``specs``."""
    total = 0
    for x, s in zip(tree_leaves(tree), tree_leaves(specs)):
        n = int(np.prod(shd.local_shape(tuple(x.shape), s, mesh),
                        dtype=np.int64))
        total += n * x.element_size()
    return total


def local_meta(tree: Any, specs: Any, mesh: RankMesh) -> Any:
    """``tree``'s leaves as meta tensors of one rank's piece shapes."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        _meta(shd.local_shape(tuple(x.shape), s, mesh), x.dtype)
        for x, s in zip(leaves, tree_leaves(specs))])


def init_meta_params(cfg: ArchConfig, dtype) -> Any:
    """The full-size parameter tree on ``meta`` (no storage)."""
    return tf.init_params(torch.Generator(), cfg, dtype, device=META)


# ---------------------------------------------------------------------------
# batch specs (shared by train / prefill)
# ---------------------------------------------------------------------------


def token_batch_specs(cfg: ArchConfig, lead: Tuple[int, ...], seq_len: int,
                      embed_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Meta batch leaves for one microbatch with leading dims ``lead``.

    vlm: patch embeddings are prepended, tokens shrink so the total stays
    seq_len.  audio (enc-dec): encoder frames at encoder_len_ratio * seq.
    The embeddings are ``embed_dtype`` (the serving programs feed them in
    the deployment dtype, which the port's layers take as is).
    """
    batch: Dict[str, torch.Tensor] = {}
    tok_len = seq_len
    if cfg.frontend is not None and cfg.frontend.kind == "vision_patches":
        tok_len = seq_len - cfg.frontend.num_tokens
        batch["patch_embeds"] = _meta(
            lead + (cfg.frontend.num_tokens, cfg.frontend.embed_dim),
            embed_dtype)
    if cfg.encdec is not None:
        enc_len = int(seq_len * cfg.encdec.encoder_len_ratio)
        batch["frames"] = _meta(lead + (enc_len, cfg.d_model), embed_dtype)
    batch["tokens"] = _meta(lead + (tok_len,), torch.int32)
    return batch


def _tokens_on(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Token ids as int64 (the embedding's index dtype), the rest as is."""
    return {k: (v.long() if k == "tokens" else v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# train_4k: a client's local period and the consensus period
# ---------------------------------------------------------------------------


def client_local_period(loss_fn, optimizer, batch_group=None) -> Callable:
    """``run(params, opt_state, batches)``: one client's T_C SGD steps
    (``batches`` leaves ``(T_C, b, ...)``), each one gradient of its
    step's batch.  A plan's microbatches are identical steps of this one
    at the microbatch's size (``Stage.repeats``).  On a rank holding a
    piece of a client, ``params`` are its pieces and ``loss_fn`` takes its
    leaves through ``launch.fsdp.ClientShards``; with whole leaves and the
    batch split over ``batch_group``, the gradients are averaged over it
    after the backward, as the rank-local epoch step does.  Returns the
    new ``(params, opt_state, losses)``."""

    def run(params, opt_state, batches):
        t_c = tree_leaves(batches)[0].shape[0]
        losses = []
        for t in range(t_c):
            batch_t = tree_map(lambda x: x[t], batches)
            leaves, treedef = tree_flatten(params)
            live = [leaf.detach().requires_grad_(True) for leaf in leaves]
            with torch.enable_grad():
                loss, _aux = loss_fn(tree_unflatten(treedef, live),
                                     _tokens_on(batch_t), None)
                grads = torch.autograd.grad(loss, live,
                                            materialize_grads=True)
            if batch_group is not None:
                grads = [cns.reduce_to_pieces([g], [None], batch_group, 0,
                                              1)[0] for g in grads]
            with torch.no_grad():
                params, opt_state = optimizer.update(
                    tree_unflatten(treedef, list(grads)), opt_state,
                    tree_unflatten(treedef, [x.detach() for x in live]))
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return run


def consensus_program(backend, compressed: bool,
                      client_group=None) -> Callable:
    """``run(server_piece, residual)``: one consensus period of the rank's
    piece through ``backend`` (the physical wire with its EF residual when
    ``compressed``), after Eq. 4's sum over ``client_group`` (a server's
    clients on several ranks)."""

    def run(server, residual):
        with torch.no_grad():
            if client_group is not None:
                for x in tree_leaves(server):
                    cns.all_reduce_(x, client_group, site="client_mean")
            if compressed:
                return backend.mix_compressed(server, None,
                                              residual=residual,
                                              key=prng.key(0))
            return backend.mix(server), residual

    return run


def build_train_program(arch_id: str, shape: InputShape, *,
                        multi_pod: bool = False,
                        consensus_mode: Optional[str] = None,
                        plan: Optional[DeploymentPlan] = None,
                        graph_kind: str = "ring",
                        arch: Optional[ArchConfig] = None) -> ProgramBundle:
    """The train shape's device program on rank 0 of the plan's FL mesh
    (every rank's shapes are the same).  ``arch`` replaces the published
    config (a smoke config, for tests)."""
    cfg = arch or get_arch(arch_id)
    plan = plan or plan_for(arch_id)
    consensus_mode = consensus_mode or plan.consensus_backend
    spec = plan.fl_spec(multi_pod)
    mesh = make_fl_mesh(spec, multi_pod=multi_pod, rank=0, dry=True)
    m, n, r, tp = (spec.num_servers, spec.clients_per_server, spec.fsdp,
                   spec.tp)
    per_client = shape.global_batch // (m * n)
    assert per_client >= 1, (arch_id, shape.name, m, n)
    topo = FLTopology(num_servers=m, clients_per_server=n,
                      t_client=plan.t_client_dry, t_server=plan.t_server,
                      graph_kind=graph_kind, intra_client_replicas=r)
    dtype = plan.dtype()
    micro = plan.grad_microbatches if per_client % max(
        plan.grad_microbatches, 1) == 0 else 1
    tp_axis = None if plan.batch_over_model else "model"

    # the batch: (T_C, M, N, per_client, ...) over the plan's axes
    b_axes = []
    if r > 1 and per_client % r == 0:
        b_axes.append("replica")
    if plan.batch_over_model and per_client % (max(r, 1) * tp) == 0:
        b_axes.append("model")
    batch_shards = int(np.prod([mesh.shape[a] for a in b_axes],
                               dtype=np.int64))
    per_device = per_client // batch_shards
    # microbatches of the device's batch (the reference's accumulate the
    # client batch; each device then holds per_device / micro sequences)
    micro_dev = micro if per_device % micro == 0 else 1
    params = init_meta_params(cfg, dtype)
    client_abs = tree_map(lambda p: _meta((m, n) + tuple(p.shape), p.dtype),
                          params)
    server_abs = tree_map(lambda p: _meta((m,) + tuple(p.shape), p.dtype),
                          params)
    pspecs = shd.fl_param_specs(client_abs, mesh, tp_axis=tp_axis)
    sspecs = shd.fl_server_specs(server_abs, mesh, tp_axis=tp_axis)
    # the rank runs its client's FSDP, batch split and, where ported, TP
    # itself (launch.fsdp, launch.tp); the TP of the other families is
    # still run whole
    tp_ported = (tp_axis is not None and tp > 1
                 and tf.tp_refusal(cfg, tp) is None
                 and shd.tp_refusal(sspecs) is None)
    compute_shards = tp if tp_axis and not tp_ported else 1
    batch_full = token_batch_specs(cfg, (topo.t_client, m, n, per_client),
                                   shape.seq_len)
    bspec = shd.PartitionSpec(None, "server", "client",
                              tuple(b_axes) if b_axes else None)
    batch_specs = tree_map(lambda _: bspec, batch_full)
    optimizer = sgd(1e-3)
    # the rank's pieces of its client: FSDP over "replica", gathered and
    # reduced over DryGroups by launch.fsdp, and TP over "model" where
    # ported (else that part is run whole)
    piece_specs = shd.fl_server_specs(
        server_abs, mesh, tp_axis="model" if tp_ported else None)
    wspecs = [shd.layer_spec(x, 1) for x in tree_leaves(piece_specs)]
    gather_axes = tuple(a for a in mesh.axis_names if a != "model"
                        and any(a in x.used_axes() for x in wspecs))
    gather_group = mesh.group_over(gather_axes)
    batch_group = mesh.group_over(b_axes)
    pieces = tree_unflatten(tree_flatten(params)[1], [
        _meta(shd.local_shape(tuple(x.shape), sp, mesh), x.dtype)
        for x, sp in zip(tree_leaves(params), wspecs)])
    loss_fn = tf.make_loss_fn(cfg)
    if tp_ported:
        from repro_torch.launch.tp import ModelParallel
        loss_fn = loss_fn.with_tp(ModelParallel.of(mesh))
    if gather_axes:
        from repro_torch.launch.fsdp import ClientShards
        loss_fn = loss_fn.with_provider(ClientShards(
            mesh, tree_unflatten(tree_flatten(params)[1], wspecs),
            gather_group, batch_group, gather_axes))
    # one of the period's T_C x micro_dev identical microbatch steps
    local = client_local_period(
        loss_fn, optimizer, None if gather_axes else batch_group)
    micro_batch = token_batch_specs(cfg, (1, per_device // micro_dev),
                                    shape.seq_len)

    # the consensus period over the mesh's server axis
    compressed = plan.compression != "none" and consensus_mode == \
        "gossip_shardmap" and m > 1
    server_piece = local_meta(server_abs, sspecs, mesh)
    residual = None
    wire_refs = 0
    if consensus_mode == "gossip_shardmap":
        backend = shd.fl_consensus_backend(
            topo, mesh, server_abs, tp_axis=tp_axis,
            compression=plan.compression,
            error_feedback=plan.error_feedback, wire=plan.wire)
        if compressed and plan.error_feedback:
            residual = tree_map(torch.empty_like, server_piece)
        if compressed and plan.wire == "physical":
            d_tot = sum(x[0].numel() for x in tree_leaves(server_piece))
            blk, nb = bucket_block(
                d_tot, backend.inner.block, backend.compressor.chunk)
            # the bucket, the own reference row, the accumulator, the
            # dither: four f32 bucket rows a rank
            wire_refs = 4 * blk * nb * 4
        unsharded_mix = ()
        piece = server_piece
    else:
        backend = cns.make_backend(consensus_mode, topo.mixing_matrix(),
                                   topo.t_server)
        # the one-process backend over every server's piece on one device
        piece = tree_map(lambda x: _meta((m,) + tuple(x.shape[1:]), x.dtype),
                         server_piece)
        unsharded_mix = (f"consensus_mode={consensus_mode!r}: every "
                         f"server's piece mixed on one device",)
    mix = consensus_program(
        backend, compressed,
        mesh.group_over(("client",)) if consensus_mode == "gossip_shardmap"
        else None)
    opt_state = optimizer.init(pieces)

    unsharded = []
    if compute_shards > 1:
        unsharded.append(
            f"a client's layers tensor parallel over {tp} 'model' ranks "
            f"({tf.tp_refusal(cfg, tp) or shd.tp_refusal(sspecs)}): run whole "
            f"at the device's batch of {per_device}, and their reductions "
            f"inside a layer not run, not counted")
    unsharded.extend(unsharded_mix)
    arg_parts = {
        "state": _local_bytes(client_abs, pspecs, mesh),
        "batch": _local_bytes(batch_full, batch_specs, mesh),
        "ef_residual": (0 if residual is None else tree_bytes(residual)),
        "wire_refs": wire_refs,
    }
    return ProgramBundle(
        name=f"{arch_id}:{shape.name}:{'mp' if multi_pod else 'sp'}",
        mesh=mesh,
        stages=(Stage("local_step", local, (pieces, opt_state, micro_batch),
                      repeats=topo.t_client * micro_dev),
                Stage("consensus", mix, (piece, residual), split=False)),
        meta={"arch": arch_id, "shape": shape.name, "multi_pod": multi_pod,
              "M": m, "N": n, "R": r, "TP": tp,
              "per_client_batch": per_client, "t_client": topo.t_client,
              "t_server": topo.t_server, "dtype": plan.param_dtype,
              "grad_microbatches": micro,
              "consensus_mode": consensus_mode,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "per_device_batch": per_device, "compute_shards": compute_shards,
              "unsharded": unsharded},
        arg_parts=arg_parts)


# ---------------------------------------------------------------------------
# serve shapes: prefill / decode
# ---------------------------------------------------------------------------


def _serve_split(cfg: ArchConfig, mesh: RankMesh, batch: int
                 ) -> Tuple[int, int, bool]:
    """``(device batch, compute shards, batch split over data)``: the batch
    splits over "data" when it divides.  The families run their TP over
    "model" on the rank (``_serve_tp``), so only the sequence over "data"
    at a batch it does not divide (``long_500k``'s batch of 1) is left to
    divide the work evenly; a family ``transformer.serve_tp_refusal``
    names runs the layers whole, and the rest of the reference's cut (TP
    over "model", and without a batch split the sequence) divides it."""
    data = mesh.shape["data"]
    b_div = batch % data == 0
    b_dev = batch // data if b_div else batch
    if tf.serve_tp_refusal(cfg, mesh.shape["model"]) is None:
        return b_dev, (1 if b_div else data), b_div
    shards = mesh.size() // (data if b_div else 1)
    return b_dev, shards, b_div


def _serve_tp(cfg: ArchConfig, mesh: RankMesh, params):
    """``(pieces, tp, attn_tp)`` of rank 0 of the dry serve ``mesh``: its
    "model" pieces of ``params`` on meta and its
    ``launch.tp.ModelParallel`` over a ``consensus.DryGroup``, as
    ``launch.serve.serve_pieces`` cuts them; ``(params, None, True)`` for
    a family ``transformer.serve_tp_refusal`` names."""
    if tf.serve_tp_refusal(cfg, mesh.shape["model"]) is not None:
        return params, None, True
    from repro_torch.launch.serve import serve_pieces
    pieces, tp = serve_pieces(params, cfg, mesh)
    return pieces, tp, tp.attn_tp


def _serve_unsharded(cfg: ArchConfig, plan: DeploymentPlan, mesh: RankMesh,
                     tp, shards: int, b_dev: int, b_div: bool,
                     what: str) -> list:
    """``meta["unsharded"]`` of a serve program: what the reference shards
    and the program runs whole or holds at other shapes, each named."""
    if tp is None:
        return [f"the layers over {shards} ranks (TP over 'model'"
                + ("" if b_div else f", {what} over 'data'")
                + f"; {tf.serve_tp_refusal(cfg, mesh.shape['model'])}): run "
                f"whole at the device's batch of {b_dev}"]
    out = []
    if shards > 1:
        out.append(f"{what} over {shards} 'data' ranks at a batch of 1: "
                   f"run whole on the rank's 'model' pieces")
    if plan.serve_fsdp:
        out.append("the weights' FSDP over 'data' (serve_fsdp): the program "
                   "holds its 'model' pieces whole over 'data'; the state "
                   "bytes are the plan's pieces")
    return out


def _state_bytes(params, pspecs, mesh: RankMesh, pieces, tp,
                 plan: DeploymentPlan) -> int:
    """A rank's weight bytes: the plan's local shapes under
    ``serve_param_specs``, or under the port's serving TP the rank's own
    pieces (``launch.serve.serve_pieces``: where the kv heads do not divide
    "model", the kv heads its q heads read), unless the plan's FSDP over
    "data" is held as its arithmetic (``_serve_unsharded``)."""
    if tp is None or plan.serve_fsdp:
        return _local_bytes(params, pspecs, mesh)
    return tree_bytes(pieces)


def _cache_bytes(cfg: ArchConfig, mesh: RankMesh, tp, batch: int,
                 seq: int, attn_tp: bool) -> int:
    """A rank's cache bytes: the plan's local shapes under
    ``serve_cache_specs``, or under the port's serving TP the rank's own
    cache (``init_cache(tp=)``: the kv heads its q heads read, every head
    under ``attn_tp=False``; an MLA layer's latent whole; a mamba layer's
    conv window of its heads' x channels with B and C whole, the SSM state
    of its heads) split over "data" as the spec splits it."""
    if tp is None:
        whole = tf.init_cache(cfg, batch, seq, torch.bfloat16, device=META)
        return _local_bytes(whole, shd.serve_cache_specs(
            whole, mesh, batch, attn_tp=attn_tp), mesh)
    mine = tf.init_cache(cfg, batch, seq, torch.bfloat16, device=META,
                         tp=tp)
    data = RankMesh(("data", "model"), (mesh.shape["data"], 1), rank=0,
                    dry=True)
    return _local_bytes(mine, shd.serve_cache_specs(mine, data, batch),
                        data)


def build_prefill_program(arch_id: str, shape: InputShape, *,
                          multi_pod: bool = False,
                          plan: Optional[DeploymentPlan] = None,
                          arch: Optional[ArchConfig] = None) -> ProgramBundle:
    """The prefill on rank 0 of the serve mesh: the rank's "model" pieces
    and cache, TP over a ``DryGroup`` as ``launch.serve.serve(mesh=)``
    runs it, then the logits' gather (a family
    ``transformer.serve_tp_refusal`` names: the layers whole at the
    device's batch)."""
    cfg = arch or get_arch(arch_id)
    plan = plan or plan_for(arch_id)
    mesh = make_serve_mesh(multi_pod=multi_pod, rank=0, dry=True)
    dtype = plan.serve_dtype()
    b_dev, shards, b_div = _serve_split(cfg, mesh, shape.global_batch)
    params = init_meta_params(cfg, dtype)
    batch_full = token_batch_specs(cfg, (shape.global_batch,), shape.seq_len,
                                   dtype)
    attn_tp = cfg.num_heads % mesh.shape["model"] == 0
    pspecs = shd.serve_param_specs(params, mesh, fsdp=plan.serve_fsdp,
                                   attn_tp=attn_tp)
    b_axis = "data" if b_div else None
    batch_specs = tree_map(lambda _: shd.PartitionSpec(b_axis), batch_full)
    batch_dev = token_batch_specs(cfg, (b_dev,), shape.seq_len, dtype)
    pieces, mp, _ = _serve_tp(cfg, mesh, params)
    opts = dataclasses.replace(tf.DEFAULT_OPTS, tp=mp)

    def program(params, batch):
        logits, cache = tf.prefill(params, cfg, _tokens_on(batch),
                                   max_len=shape.seq_len,
                                   cache_dtype=torch.bfloat16, opts=opts)
        return (logits if mp is None else mp.gather_logits(logits)), cache

    return ProgramBundle(
        name=f"{arch_id}:{shape.name}:{'mp' if multi_pod else 'sp'}",
        mesh=mesh, stages=(Stage("prefill", program, (pieces, batch_dev)),),
        meta={"arch": arch_id, "shape": shape.name, "multi_pod": multi_pod,
              "batch": shape.global_batch, "seq": shape.seq_len,
              "dtype": "bfloat16", "serve_fsdp": plan.serve_fsdp,
              "attn_tp": attn_tp if mp is not None else None,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "per_device_batch": b_dev, "compute_shards": shards,
              "unsharded": _serve_unsharded(cfg, plan, mesh, mp, shards,
                                            b_dev, b_div, "the sequence")},
        arg_parts={"state": _state_bytes(params, pspecs, mesh, pieces, mp,
                                         plan),
                   "batch": _local_bytes(batch_full, batch_specs, mesh),
                   "cache": _cache_bytes(cfg, mesh, mp, shape.global_batch,
                                         shape.seq_len, attn_tp)})


def build_decode_program(arch_id: str, shape: InputShape, *,
                         multi_pod: bool = False,
                         plan: Optional[DeploymentPlan] = None,
                         arch: Optional[ArchConfig] = None) -> ProgramBundle:
    """One decode step on rank 0 of the serve mesh against a full cache:
    the rank's "model" pieces and its cache (``init_cache(tp=)``), TP over
    a ``DryGroup``, then the logits' gather; the attention runs whole
    where the heads do not divide "model", as in the prefill (the
    reference's decode lowering keeps ``attn_tp=True`` there: K/V cut
    along the head dim); a family ``transformer.serve_tp_refusal`` names
    runs the layers whole at the device's batch."""
    cfg = arch or get_arch(arch_id)
    plan = plan or plan_for(arch_id)
    mesh = make_serve_mesh(multi_pod=multi_pod, rank=0, dry=True)
    dtype = plan.serve_dtype()
    b = shape.global_batch
    b_dev, shards, b_div = _serve_split(cfg, mesh, b)
    params = init_meta_params(cfg, dtype)
    pieces, mp, attn_tp = _serve_tp(cfg, mesh, params)
    cache_dev = tf.init_cache(cfg, b_dev, shape.seq_len, torch.bfloat16,
                              device=META, tp=mp)
    # the step that fills the cache's last position
    cache_dev["position"] = torch.tensor(shape.seq_len - 1,
                                         dtype=torch.int32)
    token_dev = _meta((b_dev, 1), torch.int64)
    pspecs = shd.serve_param_specs(params, mesh, fsdp=plan.serve_fsdp,
                                   attn_tp=attn_tp)

    def program(params, token, cache):
        with torch.no_grad():
            logits, cache = tf.decode_step(params, cfg, token, cache, tp=mp)
            return (logits if mp is None else mp.gather_logits(logits)), \
                cache

    return ProgramBundle(
        name=f"{arch_id}:{shape.name}:{'mp' if multi_pod else 'sp'}",
        mesh=mesh,
        stages=(Stage("decode", program, (pieces, token_dev, cache_dev)),),
        meta={"arch": arch_id, "shape": shape.name, "multi_pod": multi_pod,
              "batch": b, "cache_len": shape.seq_len,
              "dtype": "bfloat16", "serve_fsdp": plan.serve_fsdp,
              "attn_tp": attn_tp if mp is not None else None,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "per_device_batch": b_dev, "compute_shards": shards,
              "unsharded": _serve_unsharded(cfg, plan, mesh, mp, shards,
                                            b_dev, b_div,
                                            "the cache's sequence")},
        arg_parts={"state": _state_bytes(params, pspecs, mesh, pieces, mp,
                                         plan),
                   "batch": b // (mesh.shape["data"] if b_div else 1) * 4,
                   "cache": _cache_bytes(cfg, mesh, mp, b, shape.seq_len,
                                         attn_tp)})


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def supported_pairs() -> Tuple[Tuple[str, str], ...]:
    """All (arch, shape) pairs this system runs (34: 10x3 + 4 long-context).
    long_500k only for archs with bounded or shardable-at-500k decode
    state."""
    from repro_torch.configs import ARCH_IDS
    pairs = []
    for arch_id in ARCH_IDS:
        cfg = get_arch(arch_id)
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            pairs.append((arch_id, shape_name))
        if cfg.supports_long_context:
            pairs.append((arch_id, "long_500k"))
    return tuple(pairs)


def build_program(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                  **kw) -> ProgramBundle:
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_program(arch_id, shape, multi_pod=multi_pod, **kw)
    if shape.kind == "prefill":
        return build_prefill_program(arch_id, shape, multi_pod=multi_pod,
                                     **kw)
    cfg = kw.get("arch") or get_arch(arch_id)
    if shape.name == "long_500k" and not cfg.supports_long_context:
        raise ValueError(
            f"{arch_id} skips long_500k: {cfg.long_context_skip_reason}")
    return build_decode_program(arch_id, shape, multi_pod=multi_pod, **kw)
