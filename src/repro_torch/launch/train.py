"""DFL trainer on PyTorch: port of ``repro.launch.train`` (``train`` and
``train_dynamic``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --full --servers 4 --clients 2 --t-client 2 --t-server 5 --epochs 2

Runs Algorithm 1 end to end on the card (``--device cpu`` runs it on the
CPU, with the kernels' plain versions): T_C local SGD steps per client on
per-client synthetic LM shards, per-server aggregation, T_S gossip rounds
(kernel 1), broadcast — printing the reference trainer's epoch record
(loss, disagreement, drift, participation, num_servers, sigma_prod) every
epoch.  float32 matmuls run in full float32: TF32 is switched off.

``--compression int8|int4[:C]|top_k:R|random_k:R [--error-feedback]``
compresses the gossip messages and adds the reference's wire ledger to the
record: ``wire_mb`` (on-wire megabytes of the epoch) and ``wire_ratio``
(cumulative float32 bytes over shipped bytes).  The default ``--wire
simulated`` compresses each server's message once a period (a quantizer's
round trip and first mix on kernel 4) and counts its unpadded payload;
``--wire physical`` (int8/int4) ships delta codes every round (kernels
5-8) and counts the per-leaf layout, as the reference's static trainer
does.

Dynamic federation (``train_dynamic``, through
``core.engine.DynamicFederationEngine``): ``--participation-rate``,
``--participation-kind``, ``--participation-trace``, ``--edge-drop-prob``,
``--straggler-weaken``, ``--asymmetric-drop-prob`` (with ``--mixing
push_sum`` or ``row_stochastic``) and ``--faults
drop:EPOCH:SERVER,rejoin:EPOCH:SERVER``.  Any of them away from its default
sends the run to ``train_dynamic``, as do ``--superepoch K > 1`` (K epochs
a dispatch) and ``--staleness s > 0`` (gossip round t mixes round t - s:
plain rounds through kernel 1, or the physical wire's codes through kernel
8).  Both drivers print the same epoch line.

``--mixing push_sum`` (either driver) is directed federation: the topology
takes row-stochastic out-degree weights, each period is ratio consensus
with ``P = A'`` (kernel 1 every round, or the wires under ``P``), and the
record adds ``psum_min_weight``, the smallest terminal push-sum weight.

``--byzantine "sign_flip:0.25"`` (``kind:FRAC[:SCALE]``, comma-separated;
kinds sign_flip, scaled_noise, inlier_shift) makes that share of the
ORIGINAL servers replace their aggregate before gossip (``train_dynamic``);
pair it with a robust ``--consensus-mode trimmed_mean[:f] | median |
clipped[:mult]``.  The record adds ``byzantine`` (the attacking share) and,
under a robust mode, ``screen_rejected`` (screened values per round).

``--ckpt-dir DIR`` saves the client parameters every epoch
(``checkpoint.Checkpointer``, the reference's format, the newest three
kept; under ``--superepoch K > 1`` at block boundaries) with the arch and
epoch (and the alive servers' original ids in ``train_dynamic``).
``--log-every N`` prints every N-th epoch line (and epoch 0's).

``--consensus-backend {auto,einsum,blocked,shard_map}`` picks the consensus
execution (``resolve_consensus_backend``): ``shard_map`` is the multi-process
wire, one process a server over a ``torch.distributed`` group, started as::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --consensus-backend shard_map \
        --servers 4 --compression int8 --wire physical --epochs 1

Each rank trains its own server's clients and crosses the group only
through the gossip's collectives (gloo; a rank's CUDA tensors are staged
through pinned host memory); ``--device cuda`` puts rank r on
``cuda:{local_rank % device_count}``.  Rank 0 alone prints and writes the
telemetry, the trace and the checkpoints (the client tree gathered to its
host leaf by leaf).

Telemetry (``repro_torch.obs``, the reference's stream formats): every
epoch record goes through one ``Observability`` bundle — the console lines
(``ConsoleSink``, the one print site; ``log=False`` drops it), the
convergence monitor's gauges and watchdogs, ``--telemetry-jsonl PATH``
(every metric event, schema v1) and ``--chrome-trace PATH`` (host spans:
the epoch and, through the dynamic engine, fault surgery, the local and
gossip periods split by the consensus-replay probe, host aggregation;
open the file in Perfetto).  The record adds ``epoch_s``, the epoch's host
seconds (the read-back included).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.comm import accounting, prng
from repro_torch.comm.compressors import (tree_message_elems,
                                          tree_wire_bytes_per_server)
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core import (DFLConfig, FLTopology, SigmaTracker,
                              build_dfl_epoch_step, init_dfl_state)
from repro_torch.core import consensus as cns
from repro_torch.core.dfl import active_compressor, active_wire, mesh_rows
from repro_torch.core.engine import make_engine
from repro_torch.core.schedule import (ByzantineSchedule, FaultSchedule,
                                       ParticipationSchedule,
                                       TopologySchedule,
                                       load_participation_trace)
from repro_torch.data import DataConfig, FLDataPipeline
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.obs import (ConsoleSink, JSONLSink, MetricsHub,
                             Observability, Tracer)
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves, tree_map

CONSENSUS_BACKENDS = ("auto", "einsum", "blocked", "shard_map")


def resolve_consensus_backend(backend: str, consensus_mode: str,
                              topo: FLTopology, params, *,
                              compression: str = "none",
                              error_feedback: bool = False,
                              wire: str = "simulated",
                              staleness: int = 0,
                              ) -> Tuple[str, Optional[object]]:
    """Map the ``--consensus-backend`` flag to the ``DFLConfig`` pair
    ``(consensus_mode, consensus_backend)``.

    ``auto`` keeps ``consensus_mode``; ``einsum`` forces the per-leaf path
    ('gossip'); ``blocked`` the streamed 'gossip_blocked' path;
    ``shard_map`` builds the multi-process wire's backend
    (``launch.sharding.fl_consensus_backend``) over the initialized default
    group, which must hold M ranks (``torch.distributed.run`` with
    ``--nproc-per-node M``).  ``compression`` / ``error_feedback`` / ``wire``
    / ``staleness`` matter only there (the wrap happens at construction);
    the string paths are wrapped by the epoch step from ``DFLConfig``."""
    if backend not in CONSENSUS_BACKENDS:
        raise ValueError(f"unknown consensus backend {backend!r}; choose "
                         f"one of {CONSENSUS_BACKENDS}")
    if backend == "auto":
        return consensus_mode, None
    if consensus_mode not in ("gossip", "gossip_blocked"):
        raise ValueError(
            f"--consensus-backend {backend} re-executes the T_S-round "
            f"gossip schedule and is undefined for consensus_mode="
            f"{consensus_mode!r}; use --consensus-backend auto there")
    if backend == "einsum":
        return "gossip", None
    if backend == "blocked":
        return "gossip_blocked", None
    m = topo.num_servers
    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else 1)
    if world != m:
        raise ValueError(
            f"the shard_map backend runs one process a server: M={m} "
            f"servers need a torch.distributed group of {m} ranks, found "
            f"{world}; launch with python -m torch.distributed.run "
            f"--nproc-per-node {m} -m repro_torch.launch.train "
            f"--consensus-backend shard_map --servers {m} ...")
    server_abs = [torch.empty((m,) + tuple(p.shape), device="meta")
                  for p in tree_leaves(params)]
    return "gossip", shd.fl_consensus_backend(
        topo, dist.group.WORLD, server_abs, compression=compression,
        error_feedback=error_feedback, wire=wire, staleness=staleness)


def _is_rank0(backend) -> bool:
    """Whether this process prints and writes files: always, but under the
    multi-process wire only rank 0."""
    return not getattr(backend, "mesh_bound", False) or dist.get_rank() == 0


def _rank_device(device: str, consensus_backend: str) -> str:
    """Under ``shard_map``, ``cuda`` is the rank's own card,
    ``cuda:{local_rank % device_count}`` (several ranks may share one)."""
    if consensus_backend != "shard_map" or device != "cuda" \
            or not torch.cuda.is_available():
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return f"cuda:{local % torch.cuda.device_count()}"


def _gathered_clients(cfg: DFLConfig, client_params):
    """The federation's client tree on the host: this process's own, or
    under the multi-process wire every rank's rows gathered leaf by leaf
    through the group (host tensors; gloo)."""
    local = mesh_rows(cfg)
    if local is None:
        return client_params
    return tree_map(lambda x: cns.all_gather_rows(
        x.detach().cpu(), local[2], site="checkpoint"), client_params)


def resolve_device(device: str) -> torch.device:
    """The run's device: CUDA unless the caller asks for the CPU.  Asking
    for CUDA on a host without it raises — nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            f"device='cpu' to run the plain versions on the CPU")
    return dev


def set_full_f32() -> None:
    """float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _make_observability(*, log: bool = True, log_every: int = 1,
                        telemetry_jsonl: Optional[str] = None,
                        chrome_trace: Optional[str] = None,
                        run_info: Optional[dict] = None) -> Observability:
    """The trainers' bundle: a ``ConsoleSink`` (unless ``log`` is False),
    an optional JSONL telemetry stream, an optional span tracer for a
    Chrome trace, and the convergence monitor."""
    hub = MetricsHub([ConsoleSink(log_every=log_every)] if log else [])
    if telemetry_jsonl:
        hub.add_sink(JSONLSink(telemetry_jsonl, run_info=run_info))
    return Observability(hub=hub,
                         tracer=Tracer() if chrome_trace else None,
                         monitor=True)


def _run_epochs(epochs: int, run_one: Callable[[int], dict],
                obs: Observability, *, observe: bool,
                ckpt_save: Optional[Callable[[int], None]] = None) -> dict:
    """The one epoch loop of both drivers: ``run_one(epoch)`` returns the
    epoch's record, which goes through the bundle, and the history maps
    each metric to its per-epoch list.  ``observe=False`` where
    ``run_one`` observes itself (the dynamic engine's ``run_epoch``, with
    its per-link and per-server labels and its spans)."""
    history: dict = {}
    for epoch in range(epochs):
        if observe:
            with obs.span("epoch", epoch=epoch):
                rec = run_one(epoch)
            obs.observe(epoch, rec)
        else:
            rec = run_one(epoch)
        for k, v in rec.items():
            history.setdefault(k, []).append(v)
        if ckpt_save is not None:
            ckpt_save(epoch)
    return history


def _finish(obs: Observability, chrome_trace: Optional[str]) -> None:
    obs.close()
    if chrome_trace:
        obs.tracer.save_chrome(chrome_trace)


def train(arch_id: str, *, smoke: bool = True, servers: int = 2,
          clients: int = 2, t_client: int = 4, t_server: int = 5,
          epochs: int = 3, seq_len: int = 128, per_client_batch: int = 2,
          gamma: float = 0.05, graph: str = "ring",
          consensus_mode: str = "gossip", mixing: str = "symmetric",
          compression: str = "none", error_feedback: bool = False,
          wire: str = "simulated", staleness: int = 0, seed: int = 0,
          device: str = "cuda", ckpt_dir: Optional[str] = None,
          log_every: int = 1,
          params: Optional[dict] = None, log: bool = True,
          telemetry_jsonl: Optional[str] = None,
          chrome_trace: Optional[str] = None,
          consensus_backend: str = "auto") -> dict:
    """Static Algorithm 1 on an LM.  ``params`` (optional) replaces the
    seeded random init, e.g. weights carried over by
    ``transformer.params_from_numpy``.  ``compression`` / ``error_feedback``
    / ``wire`` select the compressed wire, ``staleness`` the
    bounded-staleness rounds.  ``ckpt_dir`` saves the client parameters
    after every epoch.  ``telemetry_jsonl`` / ``chrome_trace`` write the
    metric stream and the epoch spans.  ``consensus_backend`` as the CLI's
    ``--consensus-backend`` (``shard_map``: this process is one rank of the
    multi-process wire, and the state holds its rows).  Returns the final
    state, the per-epoch history (metric name -> list), the obs bundle and
    the run's objects."""
    device = _rank_device(device, consensus_backend)
    dev, cfg, topo, loss_fn, optimizer, pipe, params = _setup_lm(
        arch_id, smoke, servers, clients, t_client, t_server, graph, gamma,
        seq_len, per_client_batch, seed, device, mixing, params)
    consensus_mode, backend = resolve_consensus_backend(
        consensus_backend, consensus_mode, topo, params,
        compression=compression, error_feedback=error_feedback, wire=wire,
        staleness=staleness)
    dfl_cfg = DFLConfig(topology=topo, consensus_mode=consensus_mode,
                        mixing=mixing, compression=compression,
                        error_feedback=error_feedback, wire=wire,
                        staleness=staleness, consensus_backend=backend)
    if not _is_rank0(backend):
        log, telemetry_jsonl, chrome_trace = False, None, None
    step = build_dfl_epoch_step(dfl_cfg, loss_fn, optimizer)
    ledger = _make_wire_ledger(dfl_cfg, params)
    # the wire key is the reference trainer's rng, jax.random.key(seed + 1)
    state = init_dfl_state(dfl_cfg, params, optimizer,
                           torch.Generator(device=dev).manual_seed(seed + 1),
                           wire_key=prng.key(seed + 1))
    del params
    sigma = SigmaTracker(topo.num_servers, staleness=staleness,
                         mode="push_sum" if mixing == "push_sum"
                         else "average")
    a_np = (topo.mixing_matrix() if topo.num_servers > 1
            else np.ones((1, 1)))
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    obs = _make_observability(
        log=log, log_every=log_every, telemetry_jsonl=telemetry_jsonl,
        chrome_trace=chrome_trace,
        run_info={"arch": cfg.name, "driver": "train", "servers": servers})

    def run_one(epoch: int) -> dict:
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step(state, pipe.epoch_batches(epoch))
        # the metrics are host tensors: reading them waited for the device
        rec = {
            "loss": float(metrics.loss[-1].mean()),
            "disagreement": float(metrics.server_disagreement),
            "drift": float(metrics.client_drift),
            "participation": 1.0,
            "num_servers": float(topo.num_servers),
            "sigma_prod": sigma.update(a_np, topo.t_server),
            "epoch_s": time.perf_counter() - t0,
        }
        if state.psum_weight is not None:
            rec["psum_min_weight"] = float(state.psum_weight.min())
        if ledger is not None:
            rec["wire_mb"] = ledger.update() / 1e6
            rec["wire_ratio"] = ledger.tracker.ratio()
        return rec

    def ckpt_save(epoch: int) -> None:
        if ckpt is not None:
            clients_all = _gathered_clients(dfl_cfg, state.client_params)
            if _is_rank0(backend):
                ckpt.save(epoch, clients_all,
                          meta={"arch": cfg.name, "epoch": epoch})

    history = _run_epochs(epochs, run_one, obs, observe=True,
                          ckpt_save=ckpt_save)
    _finish(obs, chrome_trace)
    return {"state": state, "history": history, "topology": topo,
            "cfg": cfg, "obs": obs}


def _setup_lm(arch_id, smoke, servers, clients, t_client, t_server, graph,
              gamma, seq_len, per_client_batch, seed, device, mixing,
              params):
    """What both drivers share: the device, arch config, topology (directed
    mixing takes row-stochastic out-degree weights, symmetric gossip
    Metropolis weights), loss, optimizer, data pipeline and the seeded
    weights (unless ``params`` is given)."""
    dev = resolve_device(device)
    set_full_f32()
    cfg = get_smoke(arch_id) if smoke else get_arch(arch_id)
    topo = FLTopology(num_servers=servers, clients_per_server=clients,
                      t_client=t_client, t_server=t_server, graph_kind=graph,
                      mixing="out_degree" if mixing != "symmetric"
                      else "metropolis")
    pipe = FLDataPipeline(topo, DataConfig(seq_len=seq_len,
                                           per_client_batch=per_client_batch,
                                           vocab_size=cfg.vocab_size,
                                           seed=seed), arch=cfg, device=dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = tf.init_params(gen, cfg, device=dev)
    return dev, cfg, topo, tf.make_loss_fn(cfg), sgd(gamma), pipe, params


def train_dynamic(arch_id: str, *, smoke: bool = True, servers: int = 2,
                  clients: int = 2, t_client: int = 4, t_server: int = 5,
                  epochs: int = 3, seq_len: int = 128,
                  per_client_batch: int = 2, gamma: float = 0.05,
                  graph: str = "ring", consensus_mode: str = "gossip",
                  mixing: str = "symmetric", compression: str = "none",
                  error_feedback: bool = False, wire: str = "simulated",
                  superepoch: int = 1, staleness: int = 0,
                  participation_rate: float = 1.0,
                  participation_kind: str = "bernoulli",
                  edge_drop_prob: float = 0.0,
                  straggler_weaken: float = 0.0,
                  asymmetric_drop_prob: float = 0.0, faults: str = "",
                  byzantine: str = "", participation_trace: str = "",
                  seed: int = 0, device: str = "cuda",
                  ckpt_dir: Optional[str] = None, log_every: int = 1,
                  params: Optional[dict] = None, log: bool = True,
                  telemetry_jsonl: Optional[str] = None,
                  chrome_trace: Optional[str] = None,
                  consensus_backend: str = "auto") -> dict:
    """Dynamic-federation LM training: Algorithm 1 driven by the scenario
    engine — partial participation (``participation_rate`` with
    ``participation_kind`` bernoulli | fixed_k | round_robin, or a JSONL
    ``participation_trace``), per-epoch degraded graphs
    (``edge_drop_prob``, ``straggler_weaken``, or ``asymmetric_drop_prob``
    with ``mixing="push_sum"`` or ``"row_stochastic"``), and scheduled
    server drop/rejoin
    (``faults``, ``"drop:EPOCH:SERVER,rejoin:EPOCH:SERVER"``), and Byzantine
    servers (``byzantine``, ``"sign_flip:0.25"``; the attackers are drawn
    with ``seed``).  ``superepoch=K`` runs blocks of K epochs a dispatch
    (the same history); ``staleness=s`` lets round t mix round t - s.
    ``ckpt_dir`` saves the client parameters after every epoch, or every
    block under ``superepoch > 1``.  The record of
    an epoch is the engine's, plus ``epoch_s`` (host seconds, the read-back
    included; a superepoch block's seconds split evenly over its epochs)
    and, on a GPU, ``alloc_gb``, the memory the run holds after it.  The
    engine observes itself through the trainer's bundle
    (``telemetry_jsonl`` / ``chrome_trace``: the engine's records, per-link
    wire bytes, the screens' histogram, its spans).  ``consensus_backend``
    as in ``train``.  Returns the final state, the history, the obs bundle
    and the run's objects."""
    byz = (ByzantineSchedule.parse(byzantine, seed=seed) if byzantine
           else None)
    device = _rank_device(device, consensus_backend)
    dev, cfg, topo, loss_fn, optimizer, pipe, params = _setup_lm(
        arch_id, smoke, servers, clients, t_client, t_server, graph, gamma,
        seq_len, per_client_batch, seed, device, mixing, params)
    consensus_mode, backend = resolve_consensus_backend(
        consensus_backend, consensus_mode, topo, params,
        compression=compression, error_feedback=error_feedback, wire=wire,
        staleness=staleness)
    if not _is_rank0(backend):
        log, telemetry_jsonl, chrome_trace = False, None, None
    if participation_trace:
        part = ParticipationSchedule(
            kind="trace", trace=load_participation_trace(participation_trace))
    elif participation_rate >= 1.0:
        part = ParticipationSchedule()                       # full
    elif participation_kind == "bernoulli":
        part = ParticipationSchedule(kind="bernoulli",
                                     rate=participation_rate, seed=seed)
    else:   # fixed_k / round_robin: the rate gives the clients an epoch
        part = ParticipationSchedule(
            kind=participation_kind,
            k=max(1, round(participation_rate * clients)), seed=seed)
    if asymmetric_drop_prob > 0.0 or (straggler_weaken > 0.0
                                      and mixing != "symmetric"):
        tsched = TopologySchedule(kind="asymmetric",
                                  drop_prob=asymmetric_drop_prob,
                                  weaken=straggler_weaken, seed=seed + 1)
    elif edge_drop_prob > 0.0:
        tsched = TopologySchedule(kind="edge_drop", drop_prob=edge_drop_prob,
                                  seed=seed + 1)
    elif straggler_weaken > 0.0:
        tsched = TopologySchedule(kind="straggler", weaken=straggler_weaken,
                                  seed=seed + 1)
    else:
        tsched = TopologySchedule()                          # static
    obs = _make_observability(
        log=log, log_every=log_every, telemetry_jsonl=telemetry_jsonl,
        chrome_trace=chrome_trace,
        run_info={"arch": cfg.name, "driver": "train_dynamic",
                  "servers": servers})
    engine = make_engine(topo, loss_fn, optimizer,
                         consensus_mode=consensus_mode, mixing=mixing,
                         compression=compression,
                         error_feedback=error_feedback, wire=wire,
                         participation=part, topology_schedule=tsched,
                         faults=FaultSchedule.parse(faults), byzantine=byz,
                         obs=obs, superepoch=superepoch,
                         staleness=staleness, consensus_backend=backend)
    # the wire key is the reference trainer's rng, jax.random.key(seed + 1)
    state = init_dfl_state(engine.cfg, params, optimizer,
                           torch.Generator(device=dev).manual_seed(seed + 1),
                           wire_key=prng.key(seed + 1))
    del params

    def batch_fn(epoch, alive):
        return pipe.epoch_batches(epoch, server_ids=alive)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None

    def timed(recs, t0: float, k: int) -> None:
        # the engine's read-back waited for the device; the old state is
        # released now that ``state`` is rebound
        block_s = time.perf_counter() - t0
        for rec in recs:
            rec["epoch_s"] = block_s / k
            if dev.type == "cuda":
                rec["alloc_gb"] = torch.cuda.memory_allocated(dev) / 1e9

    def run_one(epoch: int) -> dict:
        nonlocal state
        t0 = time.perf_counter()
        state, rec = engine.run_epoch(state, epoch, batch_fn)
        timed([rec], t0, 1)
        return rec

    def ckpt_save(epoch: int) -> None:
        if ckpt is not None:
            clients_all = _gathered_clients(engine.cfg, state.client_params)
            if _is_rank0(backend):
                ckpt.save(epoch, clients_all,
                          meta={"arch": cfg.name, "epoch": epoch,
                                "alive": list(engine.alive)})

    if superepoch > 1:
        # blocks of up to K epochs; the engine observes each epoch, and the
        # checkpoint is taken at a block's end (the state exists only there)
        history: dict = {}
        for epoch0, k in engine._plan_blocks(epochs):
            t0 = time.perf_counter()
            state, recs = engine.run_superepoch(state, epoch0, k, batch_fn)
            timed(recs, t0, k)
            for rec in recs:
                for key, v in rec.items():
                    history.setdefault(key, []).append(v)
            ckpt_save(epoch0 + k - 1)
    else:
        # observe=False: run_epoch observes itself
        history = _run_epochs(epochs, run_one, obs, observe=False,
                              ckpt_save=ckpt_save)
    _finish(obs, chrome_trace)
    return {"state": state, "history": history, "engine": engine,
            "cfg": cfg, "obs": obs}


class _StaticWireLedger:
    """The static trainer's wire ledger: a ``comm.accounting.BytesTracker``
    bound to the fixed topology and model shapes.  As the reference's
    static trainer does, the simulated wire counts the unpadded payload of
    one message (``tree_wire_bytes_per_server``) and the physical wire the
    PER-LEAF layout (``tree_physical_wire_bytes_per_server``), even though
    its rounds ship the bucketed one."""

    def __init__(self, dfl_cfg: DFLConfig, params, compressor):
        topo = dfl_cfg.topology
        server_abs = [torch.empty((topo.num_servers,) + tuple(p.shape),
                                  device="meta")
                      for p in tree_leaves(params)]
        wire, wire_block = active_wire(dfl_cfg)
        if wire == "physical":
            self._row = accounting.tree_physical_wire_bytes_per_server(
                compressor, server_abs, wire_block)
        else:
            self._row = tree_wire_bytes_per_server(compressor, server_abs)
        self._elems = tree_message_elems(server_abs)
        self._a = (topo.mixing_matrix() if topo.num_servers > 1
                   else np.ones((1, 1)))
        self._t_s = topo.t_server
        self.tracker = accounting.BytesTracker(
            compressor, push_sum=dfl_cfg.mixing == "push_sum")

    def update(self) -> float:
        return self.tracker.update(self._a, self._t_s, row_bytes=self._row,
                                   elems_per_row=self._elems)


def _make_wire_ledger(dfl_cfg: DFLConfig,
                      params) -> Optional[_StaticWireLedger]:
    compressor = active_compressor(dfl_cfg)
    if compressor is None:
        return None
    return _StaticWireLedger(dfl_cfg, params, compressor)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--full", dest="smoke", action="store_false",
                   help="the published-size config")
    p.add_argument("--servers", type=int, default=2)
    p.add_argument("--clients", type=int, default=2)
    p.add_argument("--t-client", type=int, default=4)
    p.add_argument("--t-server", type=int, default=5)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--gamma", type=float, default=0.05)
    p.add_argument("--graph", default="ring",
                   choices=("ring", "complete", "star", "line", "erdos_renyi",
                            "directed_ring", "random_orientation"))
    p.add_argument("--consensus-mode", default="gossip",
                   help="inter-server mixing: gossip | gossip_blocked | "
                        "collapsed | chebyshev | exact_mean | none, or a "
                        "robust screen trimmed_mean[:f] | median | "
                        "clipped[:mult] (validated by "
                        "consensus.make_backend)")
    p.add_argument("--consensus-backend", default="auto",
                   choices=CONSENSUS_BACKENDS,
                   help="consensus execution: auto (follow "
                        "--consensus-mode), einsum (per-leaf gossip), "
                        "blocked (fixed-block streaming) or shard_map (one "
                        "process a server over torch.distributed; launch "
                        "with python -m torch.distributed.run "
                        "--nproc-per-node M)")
    p.add_argument("--mixing", default="symmetric",
                   choices=("symmetric", "row_stochastic", "push_sum"),
                   help="symmetric doubly-stochastic gossip (the paper), "
                        "naive row-stochastic gossip (directed, biased) or "
                        "push-sum ratio consensus (directed, unbiased)")
    p.add_argument("--compression", default="none",
                   help="none | int8[:chunk] | int4[:chunk] | top_k:ratio | "
                        "random_k:ratio: compress the gossip messages")
    p.add_argument("--error-feedback", action="store_true",
                   help="carry each server's compression residual into the "
                        "next period's message")
    p.add_argument("--wire", default="simulated",
                   choices=("simulated", "physical"),
                   help="where --compression happens: 'simulated' "
                        "compresses once per period, 'physical' ships the "
                        "codes every round")
    p.add_argument("--superepoch", type=int, default=1,
                   help="epochs a dispatch of the dynamic engine; the "
                        "history is the same at any K")
    p.add_argument("--staleness", type=int, default=0,
                   help="bounded gossip staleness s: round t mixes the "
                        "neighbours' messages of round t-s (gossip and "
                        "gossip_blocked; on --wire physical their codes); "
                        "0 = the synchronous path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="save the client parameters here every epoch")
    p.add_argument("--log-every", type=int, default=1,
                   help="print every N-th epoch line (and epoch 0's)")
    p.add_argument("--telemetry-jsonl", default=None,
                   help="write every metric event (schema v1) to this "
                        "JSONL path")
    p.add_argument("--chrome-trace", default=None,
                   help="record host spans and write a Chrome trace-event "
                        "JSON (open in Perfetto) to this path")
    dyn = p.add_argument_group(
        "dynamic federation (any of these switches to the scenario engine)")
    dyn.add_argument("--participation-rate", type=float, default=1.0,
                     help="fraction of clients training each epoch (< 1 "
                          "enables partial participation)")
    dyn.add_argument("--participation-kind", default="bernoulli",
                     choices=("bernoulli", "fixed_k", "round_robin"))
    dyn.add_argument("--participation-trace", default="",
                     help="JSONL availability trace "
                          "(schedule.save_participation_trace) replayed "
                          "instead of sampled participation")
    dyn.add_argument("--edge-drop-prob", type=float, default=0.0,
                     help="per-epoch probability that each server link fails")
    dyn.add_argument("--straggler-weaken", type=float, default=0.0,
                     help="weight fraction removed from one random link an "
                          "epoch (with --mixing push_sum/row_stochastic: "
                          "from one link direction)")
    dyn.add_argument("--asymmetric-drop-prob", type=float, default=0.0,
                     help="per-epoch probability that each link DIRECTION "
                          "fails (with --mixing push_sum/row_stochastic)")
    dyn.add_argument("--faults", default="",
                     help="server fault schedule, e.g. 'drop:5:1,rejoin:9:1'")
    dyn.add_argument("--byzantine", default="",
                     help="Byzantine attack schedule, e.g. 'sign_flip:0.25' "
                          "or 'sign_flip:0.1,scaled_noise:0.1:10'; attacked "
                          "servers replace their aggregate before gossip "
                          "(pair with a robust --consensus-mode)")
    return p


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    kw = dict(smoke=args.smoke, servers=args.servers, clients=args.clients,
              t_client=args.t_client, t_server=args.t_server,
              epochs=args.epochs, seq_len=args.seq_len,
              per_client_batch=args.batch, gamma=args.gamma,
              graph=args.graph, consensus_mode=args.consensus_mode,
              mixing=args.mixing, compression=args.compression,
              error_feedback=args.error_feedback, wire=args.wire,
              staleness=args.staleness, device=args.device, seed=args.seed,
              ckpt_dir=args.ckpt_dir, log_every=args.log_every,
              telemetry_jsonl=args.telemetry_jsonl,
              chrome_trace=args.chrome_trace,
              consensus_backend=args.consensus_backend)
    dynamic = (args.participation_rate < 1.0 or args.edge_drop_prob > 0.0
               or args.straggler_weaken > 0.0
               or args.asymmetric_drop_prob > 0.0 or bool(args.faults)
               or bool(args.byzantine) or bool(args.participation_trace)
               or args.superepoch > 1 or args.staleness > 0)
    # torch.distributed.run sets the rendezvous in the environment; the
    # group is this run's to open and close
    own_group = (args.consensus_backend == "shard_map"
                 and "WORLD_SIZE" in os.environ and not dist.is_initialized())
    if own_group:
        dist.init_process_group("gloo")
    try:
        if dynamic:
            train_dynamic(args.arch, superepoch=args.superepoch,
                          participation_rate=args.participation_rate,
                          participation_kind=args.participation_kind,
                          edge_drop_prob=args.edge_drop_prob,
                          straggler_weaken=args.straggler_weaken,
                          asymmetric_drop_prob=args.asymmetric_drop_prob,
                          faults=args.faults, byzantine=args.byzantine,
                          participation_trace=args.participation_trace, **kw)
        else:
            train(args.arch, **kw)
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
