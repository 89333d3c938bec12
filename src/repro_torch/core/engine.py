"""The dynamic-federation engine: the host-side loop that drives the dynamic
epoch step through a scenario (port of ``repro.core.engine``).

Split of responsibilities, as in the reference:

* what keeps shapes fixed — participation masks, per-epoch mixing
  matrices — is an operand of the one dynamic epoch step built for the
  current federation size (``schedule.EpochSchedule``, moved to the
  state's device each epoch);
* what changes shapes — a server dropping out or rejoining — is host-side
  graph surgery between epochs: its row is cut out of (or appended to)
  every ``(M, N, *w)`` leaf, the topology is rebuilt through
  ``FLTopology.drop_server`` / ``rejoin_server``, and the step of the new M
  is built (cached per M: a drop/rejoin cycle builds two steps in all,
  ``compile_counts``).

The epoch step updates the state's buffers in place, so surgery allocates
new ``(M±1, ...)`` tensors and keeps no reference to the old ones: once the
caller drops the old state, its memory is free.  A rejoining server
re-enters at the last row with the survivors' mean model.  Surgery resets
the ``SigmaTracker`` (its product is over the old federation), the
error-feedback residual (wire state of the old federation) and, under
``mixing='push_sum'``, the push-sum weight to ones at the new M; the
``BytesTracker`` ledger runs on across it.

``superepoch=K > 1``: ``run`` plans blocks of up to K epochs, cut at fault
epochs (``_plan_blocks``), and dispatches each through
``overlap.build_dfl_superepoch_step``.  Every metric read-back, per epoch
or per block, is one call of the injectable ``_device_get``.

A Byzantine schedule (``DFLConfig.byzantine``) is validated at
construction (one honest server at least) and marks each epoch's attackers
by their ORIGINAL ids through the alive row order
(``EpochSchedule.byz``); the record adds ``byzantine`` (the attacking
share) and, under a robust backend, ``screen_rejected`` (screened values
per gossip round).

Left out until ``repro_torch.obs`` is ported: the reference's
observability bundle, its consensus-replay timing probes and the
per-server screen histogram.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.accounting import (BytesTracker,
                                         tree_bucketed_wire_bytes_per_server)
from repro_torch.comm.compressors import (tree_message_elems,
                                          tree_wire_bytes_per_server)
from repro_torch.core import dfl
from repro_torch.core import overlap
from repro_torch.core import topology as tp
from repro_torch.core.schedule import (EpochSchedule, FaultSchedule,
                                       ParticipationSchedule, SigmaTracker,
                                       TopologySchedule)
from repro_torch.core.topology import FLTopology
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

# batch_fn(epoch, alive_original_server_ids) -> batch pytree with leaves
# (T_C, M_alive, N, ...).  Data follows ORIGINAL server identity, so a
# server that drops and rejoins gets its own clients' shards back.
BatchFn = Callable[[int, Tuple[int, ...]], Any]


def device_get(tree: Any) -> Any:
    """``tree`` with every float tensor leaf that lies on a device brought
    to the host in ONE device-to-host copy (the leaves are concatenated on
    the device first); host leaves pass through."""
    leaves, treedef = tree_flatten(tree)
    on_dev = [i for i, x in enumerate(leaves)
              if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if on_dev:
        host = torch.cat([leaves[i].detach().reshape(-1).float()
                          for i in on_dev]).cpu()
        off = 0
        for i in on_dev:
            x = leaves[i]
            leaves[i] = host[off:off + x.numel()].reshape(x.shape).to(
                x.dtype)
            off += x.numel()
    return tree_unflatten(treedef, leaves)


@dataclasses.dataclass
class DynamicFederationEngine:
    """Drives DFL training under participation/topology/fault schedules."""

    cfg: dfl.DFLConfig
    loss_fn: dfl.LossFn
    optimizer: Optimizer
    participation: ParticipationSchedule = ParticipationSchedule()
    topology_schedule: TopologySchedule = TopologySchedule()
    faults: FaultSchedule = FaultSchedule()
    # superepoch length K: run() dispatches blocks of up to K epochs and
    # reads their metrics back once a block; 1 = the per-epoch loop
    superepoch: int = 1

    def __post_init__(self):
        if self.superepoch < 1:
            raise ValueError(
                f"superepoch must be >= 1, got {self.superepoch}")
        if not self.cfg.dynamic:
            self.cfg = dataclasses.replace(self.cfg, dynamic=True)
        if (self.topology_schedule.kind == "asymmetric"
                and self.cfg.mixing == "symmetric"):
            raise ValueError(
                "TopologySchedule(kind='asymmetric') emits row-stochastic "
                "A_p: the symmetric gossip path would silently converge to "
                "a biased average — use DFLConfig(mixing='push_sum') or "
                "mixing='row_stochastic'")
        self.topo: FLTopology = self.cfg.topology
        # fail at construction, not mid-run: every fault event must name an
        # ORIGINAL server id (data shards are keyed by original identity)
        self.faults.validate(self.topo.num_servers)
        # ... and the byzantine populations must leave at least one honest
        # server
        if self.cfg.byzantine is not None:
            self.cfg.byzantine.validate(self.topo.num_servers)
        # original server ids still alive, in row order of the state
        self.alive: List[int] = list(range(self.topo.num_servers))
        self._initial_m: int = self.topo.num_servers
        self._steps: Dict[int, Callable] = {}
        self._super_steps: Dict[Tuple[int, int], Callable] = {}
        # builds of the epoch step per M (and of the superepoch step per
        # (M, K)): the step is cached, so each count stays at 1
        self._builds: Dict[int, int] = {}
        self._super_builds: Dict[Tuple[int, int], int] = {}
        # ALL metric read-backs go through this hook, once per dispatch
        self._device_get: Callable = device_get
        self._tracker = self._fresh_tracker()
        # the wire ledger (None when the wire is exact): one across the whole
        # run, through fault surgery
        self._compressor = dfl.active_compressor(self.cfg)
        # push-sum's (M,) weight adds 4 bytes a message on the simulated
        # wire's ledger; on the physical wire it never crosses
        self._bytes = (BytesTracker(self._compressor,
                                    push_sum=self.cfg.mixing == "push_sum",
                                    wire=dfl.active_wire(self.cfg)[0])
                       if self._compressor is not None else None)
        self._row_bytes: Dict[int, Tuple[int, int]] = {}
        # spectral backends (chebyshev) take a host-side |lambda_2(A_p)|
        backend = dfl.resolve_backend(self.cfg)
        self._needs_spectral = bool(backend is not None
                                    and backend.needs_spectral)

    def _fresh_tracker(self) -> SigmaTracker:
        mode = "push_sum" if self.cfg.mixing == "push_sum" else "average"
        return SigmaTracker(self.topo.num_servers, mode=mode,
                            staleness=self.cfg.staleness)

    def _reset_psum_weight(self, state: dfl.DFLState) -> dfl.DFLState:
        """Push-sum weights are mass fractions of the CURRENT federation:
        after surgery they restart at one, a new tensor at the new M (every
        period starts from unit weight anyway)."""
        if self.cfg.mixing != "push_sum":
            return state
        device = tree_leaves(state.client_params)[0].device
        return state._replace(psum_weight=torch.ones(
            (self.topo.num_servers,), dtype=torch.float32, device=device))

    def _reset_ef_residual(self, state: dfl.DFLState) -> dfl.DFLState:
        """Error-feedback residuals are wire state of the old federation
        (what each server still owes its peers): after surgery they restart
        at zero at the new M."""
        if not dfl.wants_error_feedback(self.cfg):
            return state
        ef = tree_map(lambda x: torch.zeros_like(x[:, 0]),
                      state.client_params)
        return state._replace(ef_residual=ef)

    def _wire_row_bytes(self, state: dfl.DFLState) -> Tuple[int, int]:
        """(compressed bytes, elements) of one server's message at the
        current federation size, cached per M: the simulated wire's
        unpadded payload, or the physical wire's bucketed codes and
        scales."""
        m = self.topo.num_servers
        if m not in self._row_bytes:
            server_abs = [torch.empty((m,) + tuple(x.shape[2:]),
                                      device="meta")
                          for x in tree_leaves(state.client_params)]
            wire, wire_block = dfl.active_wire(self.cfg)
            if wire == "physical":
                row = tree_bucketed_wire_bytes_per_server(
                    self._compressor, server_abs, wire_block)
            else:
                row = tree_wire_bytes_per_server(self._compressor,
                                                 server_abs)
            self._row_bytes[m] = (row, tree_message_elems(server_abs))
        return self._row_bytes[m]

    # -- step cache ----------------------------------------------------------
    def _step(self) -> Callable:
        m = self.topo.num_servers
        if m not in self._steps:
            cfg = dataclasses.replace(self.cfg, topology=self.topo)
            self._steps[m] = dfl.build_dfl_epoch_step(cfg, self.loss_fn,
                                                      self.optimizer)
            self._builds[m] = self._builds.get(m, 0) + 1
        return self._steps[m]

    def _super_step(self, k: int) -> Callable:
        key = (self.topo.num_servers, k)
        if key not in self._super_steps:
            cfg = dataclasses.replace(self.cfg, topology=self.topo)
            self._super_steps[key] = overlap.build_dfl_superepoch_step(
                cfg, self.loss_fn, self.optimizer, k)
            self._super_builds[key] = self._super_builds.get(key, 0) + 1
        return self._super_steps[key]

    def compile_counts(self) -> Dict[int, int]:
        """Per federation size M, how many times its epoch step was built
        (the reference's per-M compile count): 1 for every M seen."""
        return dict(self._builds)

    def superepoch_compile_counts(self) -> Dict[Tuple[int, int], int]:
        """Per (M, K), how many times its superepoch step was built."""
        return dict(self._super_builds)

    # -- fault surgery -------------------------------------------------------
    def _drop(self, state: dfl.DFLState, server: int) -> dfl.DFLState:
        """Remove ORIGINAL server id ``server`` from the federation."""
        if server not in self.alive:
            raise ValueError(f"server {server} is not alive")
        pos = self.alive.index(server)
        self.topo, keep = self.topo.drop_server(pos)
        self.alive.pop(pos)
        keep = np.asarray(keep)

        def leaf(x):
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[0] == keep.size + 1:
                # index_select copies: no view keeps the old buffer alive
                return x.index_select(0, torch.as_tensor(keep,
                                                         device=x.device))
            return x
        state = dfl.DFLState(tree_map(leaf, state.client_params),
                             tree_map(leaf, state.opt_state), state.epoch,
                             state.rng, None, state.wire_key)
        self._tracker = self._fresh_tracker()
        return self._reset_ef_residual(self._reset_psum_weight(state))

    def _rejoin(self, state: dfl.DFLState,
                server: Optional[int]) -> dfl.DFLState:
        """ORIGINAL server ``server`` re-enters with the survivor-mean
        model.  Fresh ids are rejected: client data follows original
        identity (``BatchFn``), so a server that never existed has no
        shard."""
        if server is None or not 0 <= server < self._initial_m:
            raise ValueError(
                f"rejoin needs an ORIGINAL server id in [0, "
                f"{self._initial_m}) — got {server!r}; a fresh server has "
                f"no data shard (data follows original identity, see "
                f"FaultSchedule.validate)")
        if server in self.alive:
            raise ValueError(f"server {server} is already alive")
        self.topo, idx = self.topo.rejoin_server()
        self.alive.append(server)

        def leaf(x):
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[0] == idx:
                new_row = x.mean(dim=0, keepdim=True).to(x.dtype)
                return torch.cat([x, new_row], dim=0)
            return x
        state = dfl.DFLState(tree_map(leaf, state.client_params),
                             tree_map(leaf, state.opt_state), state.epoch,
                             state.rng, None, state.wire_key)
        self._tracker = self._fresh_tracker()
        return self._reset_ef_residual(self._reset_psum_weight(state))

    def apply_faults(self, state: dfl.DFLState, epoch: int) -> dfl.DFLState:
        for ev in self.faults.at(epoch):
            if ev.kind == "drop":
                state = self._drop(state, ev.server)
            else:
                state = self._rejoin(state, ev.server)
        return state

    # -- the loop ------------------------------------------------------------
    def _plan_epoch(self, epoch: int) -> Tuple[EpochSchedule, float]:
        """This epoch's host-side schedule (numpy) and the contraction
        after it."""
        m, n = self.topo.num_servers, self.topo.clients_per_server
        mask_np = self.participation.mask(epoch, m, n)
        a_np = self.topology_schedule.mixing(self.topo, epoch)
        sigma_prod = self._tracker.update(a_np, self.topo.t_server)
        lam2 = (np.float32(tp.lambda_2(a_np)) if self._needs_spectral
                else None)
        byz_np = None
        if self.cfg.byzantine is not None and self.cfg.byzantine.attacks:
            # per-row codes of the CURRENT federation: the attackers'
            # ORIGINAL ids (drawn over the original size, so stable across
            # surgery) through the alive row order; passed every epoch,
            # all-zero ones included
            byz_np = self.cfg.byzantine.codes(epoch, tuple(self.alive),
                                              self._initial_m)
        return EpochSchedule(mask_np, a_np, lam2, byz_np), sigma_prod

    def _record(self, mask_np: np.ndarray, loss_last, disagreement, drift,
                sigma_prod: float, psw=None, byz_np=None,
                screen=None) -> Dict[str, float]:
        # participant-weighted loss of the last local iteration
        last = np.asarray(loss_last, np.float32)
        w = mask_np if mask_np.sum() else np.ones_like(mask_np)
        record = {"loss": float((last * w).sum() / w.sum()),
                  "disagreement": float(disagreement),
                  "drift": float(drift),
                  "participation": float(mask_np.mean()),
                  "num_servers": float(self.topo.num_servers),
                  "sigma_prod": sigma_prod}
        if byz_np is not None:
            # the share of the CURRENT federation attacking this epoch
            record["byzantine"] = float((byz_np > 0).mean())
        if psw is not None:
            # ratio-consensus conditioning: a terminal weight near 0 means
            # that server's num / w read-out amplified rounding
            record["psum_min_weight"] = float(np.min(np.asarray(psw)))
        if screen is not None:
            # robust-screen activity, normalised per gossip round (the
            # per-server breakdown waits for the port's metrics hub)
            rounds = max(self.topo.t_server, 1)
            record["screen_rejected"] = float(
                (np.asarray(screen, np.float32) / rounds).sum())
        return record

    def run_epoch(self, state: dfl.DFLState, epoch: int,
                  batch_fn: BatchFn) -> Tuple[dfl.DFLState, Dict[str, float]]:
        state = self.apply_faults(state, epoch)
        plan, sigma_prod = self._plan_epoch(epoch)
        batches = batch_fn(epoch, tuple(self.alive))
        device = tree_leaves(state.client_params)[0].device
        sched = EpochSchedule(
            torch.as_tensor(plan.mask, dtype=torch.float32, device=device),
            torch.as_tensor(plan.mixing, dtype=torch.float32, device=device),
            None if plan.lam2 is None else torch.as_tensor(
                plan.lam2, dtype=torch.float32, device=device),
            None if plan.byz is None else torch.as_tensor(
                plan.byz, dtype=torch.int32, device=device))
        epoch_wire_bytes = None
        if self._bytes is not None:
            row_bytes, elems = self._wire_row_bytes(state)
            epoch_wire_bytes = self._bytes.update(
                plan.mixing, self.topo.t_server, row_bytes=row_bytes,
                elems_per_row=elems)
        state, metrics = self._step()(state, batches, sched)
        # ONE device-to-host transfer for the metrics and the push-sum
        # weight
        mh, psw_h = self._device_get((metrics, state.psum_weight))
        record = self._record(plan.mask, mh.loss[-1], mh.server_disagreement,
                              mh.client_drift, sigma_prod, psw_h, plan.byz,
                              mh.screen_rejected)
        if epoch_wire_bytes is not None:
            # this epoch's own bytes (0.0 for an epoch without rounds) and
            # the cumulative ratio
            record["wire_mb"] = epoch_wire_bytes / 1e6
            record["wire_ratio"] = self._bytes.ratio()
        return state, record

    # -- superepoch dispatch -------------------------------------------------
    def _plan_blocks(self, epochs: int) -> List[Tuple[int, int]]:
        """Cut ``[0, epochs)`` into dispatch blocks of at most
        ``self.superepoch`` epochs with no fault epoch in their interior:
        surgery changes shapes, so a fault epoch starts a block."""
        cuts = {0, epochs}
        cuts.update(ev.epoch for ev in self.faults.events
                    if 0 < ev.epoch < epochs)
        blocks: List[Tuple[int, int]] = []
        ordered = sorted(cuts)
        for lo, hi in zip(ordered[:-1], ordered[1:]):
            e = lo
            while e < hi:
                k = min(self.superepoch, hi - e)
                blocks.append((e, k))
                e += k
        return blocks

    def run_superepoch(
            self, state: dfl.DFLState, epoch0: int, k: int,
            batch_fn: BatchFn) -> Tuple[dfl.DFLState, List[Dict[str, float]]]:
        """Dispatch epochs ``[epoch0, epoch0 + k)`` as one block: the
        block's schedules, contractions and batches are planned on the host
        first, the K epochs run back to back, and the stacked metrics come
        back in one ``_device_get``.  The records use ``run_epoch``'s
        formulas, so ``run`` gives the same history at any K."""
        state = self.apply_faults(state, epoch0)
        plans: List[EpochSchedule] = []
        sigmas: List[float] = []
        batch_list: List[Any] = []
        for i in range(k):
            plan, sigma_prod = self._plan_epoch(epoch0 + i)
            plans.append(plan)
            sigmas.append(sigma_prod)
            batch_list.append(batch_fn(epoch0 + i, tuple(self.alive)))
        sb = overlap.stack_epoch_schedules(plans)
        device = tree_leaves(state.client_params)[0].device

        def on_device(x):
            return None if x is None else torch.as_tensor(x, device=device)

        sched = overlap.EpochScheduleBatch(*(on_device(x) for x in sb))
        batches = tree_map(lambda *xs: torch.stack(xs), *batch_list)
        del batch_list
        wire = None
        if self._bytes is not None:
            row_bytes, elems = self._wire_row_bytes(state)
            wire = self._bytes.update_many(
                [p.mixing for p in plans], self.topo.t_server,
                row_bytes=row_bytes, elems_per_row=elems)
        state, metrics, psw = self._super_step(k)(state, batches, sched)
        # the block's ONLY device-to-host transfer
        mh, psw_h = self._device_get((metrics, psw))
        records = []
        for i in range(k):
            record = self._record(
                plans[i].mask, mh.loss[i][-1], mh.server_disagreement[i],
                mh.client_drift[i], sigmas[i],
                None if psw_h is None else psw_h[i], plans[i].byz,
                None if mh.screen_rejected is None
                else mh.screen_rejected[i])
            if wire is not None:
                epoch_bytes, ratio_after, _ = wire[i]
                record["wire_mb"] = epoch_bytes / 1e6
                record["wire_ratio"] = ratio_after
            records.append(record)
        return state, records

    def run(self, state: dfl.DFLState, epochs: int,
            batch_fn: BatchFn) -> Tuple[dfl.DFLState, Dict[str, List[float]]]:
        history: Dict[str, List[float]] = {}
        for epoch0, k in self._plan_blocks(epochs):
            if self.superepoch <= 1:
                state, rec = self.run_epoch(state, epoch0, batch_fn)
                recs = [rec]
            else:
                state, recs = self.run_superepoch(state, epoch0, k, batch_fn)
            for rec in recs:
                for key, v in rec.items():
                    history.setdefault(key, []).append(v)
        return state, history


def make_engine(topology: FLTopology, loss_fn: dfl.LossFn,
                optimizer: Optimizer, *,
                consensus_mode: str = "gossip",
                participation: Optional[ParticipationSchedule] = None,
                topology_schedule: Optional[TopologySchedule] = None,
                faults: Optional[FaultSchedule] = None,
                superepoch: int = 1,
                **cfg_kw) -> DynamicFederationEngine:
    """Convenience constructor mirroring ``DFLConfig`` defaults; any extra
    keyword (``mixing``, ``metrics``, ``compression``, ``staleness``, ...)
    goes to ``DFLConfig``, and ``dynamic=True`` is always set.  On the
    paper's Sec.-IV regression::

        from repro_torch.core.engine import make_engine
        from repro_torch.core.schedule import (FaultSchedule,
                                               ParticipationSchedule,
                                               TopologySchedule)
        from repro_torch.core import FLTopology, init_dfl_state
        from repro_torch.data import make_regression_task
        from repro_torch.optim import sgd
        import torch

        topo = FLTopology(num_servers=5, clients_per_server=5,
                          t_client=25, t_server=10, graph_kind="ring")
        task = make_regression_task(topo, seed=0)
        engine = make_engine(
            topo, task["loss_fn"], sgd(1e-3),
            participation=ParticipationSchedule(kind="bernoulli", rate=0.5),
            topology_schedule=TopologySchedule(kind="edge_drop",
                                              drop_prob=0.3),
            faults=FaultSchedule.parse("drop:10:2,rejoin:25:2"))
        state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(1e-3))
        state, history = engine.run(state, 40, task["batch_fn"])

    ``history`` maps metric name -> per-epoch list (loss, disagreement,
    drift, participation, num_servers, sigma_prod, psum_min_weight under
    ``mixing="push_sum"``, wire_mb / wire_ratio under compression,
    byzantine under a Byzantine schedule, and screen_rejected under a
    robust backend).  ``superepoch=K`` is an engine knob:
    blocks of up to K epochs a dispatch, the same history at any K."""
    cfg = dfl.DFLConfig(topology=topology, consensus_mode=consensus_mode,
                        dynamic=True, **cfg_kw)
    return DynamicFederationEngine(
        cfg, loss_fn, optimizer,
        participation=participation or ParticipationSchedule(),
        topology_schedule=topology_schedule or TopologySchedule(),
        faults=faults or FaultSchedule(), superepoch=superepoch)
