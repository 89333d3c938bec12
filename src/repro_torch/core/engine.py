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

Observability (``obs``, a ``repro_torch.obs.Observability``; default
``OBS_OFF``): the reference's spans (``epoch``, ``fault-surgery``,
``local-period`` / ``gossip-period``, ``host-aggregation``; under
``superepoch`` a ``superepoch`` span with uniformly split ``epoch``
children, their calibrated periods and T_S ``gossip-round`` spans), compile
events when a step is built, and one ``obs.observe`` an epoch with the
per-link wire bytes and the robust screens' per-server histogram.  With a
tracer attached the engine synchronizes the state's device after each
step (through the injectable ``_sync``, never called without a tracer)
and times the consensus period alone (``dfl.build_consensus_replay``) on
a copy of the post-step server tree to split the step's wall time.  The
bundle never changes a number of the run.
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
from repro_torch.obs import OBS_OFF
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


def device_sync(tree: Any) -> None:
    """Wait for the device that ``tree``'s first tensor leaf lies on (a
    no-op for host tensors): the tracer's sync point after a step."""
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            return


@dataclasses.dataclass
class DynamicFederationEngine:
    """Drives DFL training under participation/topology/fault schedules."""

    cfg: dfl.DFLConfig
    loss_fn: dfl.LossFn
    optimizer: Optimizer
    participation: ParticipationSchedule = ParticipationSchedule()
    topology_schedule: TopologySchedule = TopologySchedule()
    faults: FaultSchedule = FaultSchedule()
    # observability bundle (repro_torch.obs.Observability), or None for the
    # no-op OBS_OFF.  Attaching one leaves every number of the run as it is:
    # the hooks read host values the engine computed anyway, the replay
    # probe works on copies, and the sync after a step exists only when a
    # tracer is attached
    obs: Any = None
    # superepoch length K: run() dispatches blocks of up to K epochs and
    # reads their metrics back once a block; 1 = the per-epoch loop
    superepoch: int = 1

    def __post_init__(self):
        if self.obs is None:
            self.obs = OBS_OFF
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
        # the tracer's device sync after a step: called only when a tracer
        # is attached (a test counts it)
        self._sync: Callable = device_sync
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
        # consensus-replay probes (dfl.build_consensus_replay), built per M
        # and only when a tracer is attached; the M whose probe has run its
        # untimed warm-up; and the per-M gossip-period time (ns) that the
        # superepoch spans are attributed from, measured once per M
        self._probes: Dict[int, Optional[Callable]] = {}
        self._probe_warm: set = set()
        self._probe_cal: Dict[int, Optional[int]] = {}
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

    # -- observability -------------------------------------------------------
    @staticmethod
    def _build_cause(cache: Dict) -> str:
        """The compile event's cause for a step just built into ``cache``:
        the run's first step, or the step of a new federation size (a
        superepoch block of a new K counts as one, as in the reference).
        Steps are cached per key, so the reference's ``retrace`` (a second
        program for a size already seen) cannot happen here."""
        return "first_trace" if len(cache) == 1 else "federation_size_change"

    def _consensus_probe(self, m: int) -> Optional[Callable]:
        """The consensus-replay probe for federation size ``m``
        (``dfl.build_consensus_replay``), or None when there is no
        consensus period to time.  Built lazily, and only ever reached when
        a tracer is attached."""
        if m not in self._probes:
            cfg = dataclasses.replace(self.cfg, topology=self.topo)
            self._probes[m] = dfl.build_consensus_replay(cfg)
        return self._probes[m]

    def _time_probe(self, probe: Callable, state: dfl.DFLState, a_np,
                    lam2) -> int:
        """Wall nanoseconds (the tracer's clock) of one probe run on a copy
        of the post-step server tree, so that no backend path, the kernels'
        in-place buffers included, can write the live state.  The copy is
        made and synchronized before the clock starts."""
        tracer = self.obs.tracer
        server = tree_map(lambda x: x[:, 0].clone(), state.client_params)
        device = tree_leaves(server)[0].device
        a_t = torch.as_tensor(a_np, dtype=torch.float32, device=device)
        lam2_t = (None if lam2 is None else
                  torch.as_tensor(lam2, dtype=torch.float32, device=device))
        self._sync(server)
        p0 = tracer.now()
        out = probe(server, a_t, lam2_t)
        self._sync(out)
        return int(tracer.now() - p0)

    def _trace_step(self, epoch_span, epoch: int, m: int, t0: int, t1: int,
                    state: dfl.DFLState, a_np, lam2) -> None:
        """Tracer-only post-step work: split the step's [t0, t1] wall
        interval into local-period / gossip-period spans through the
        consensus-replay probe (the consensus period run alone on a copy of
        the post-step server tree, warmed once per M untimed; its wall time
        estimates the gossip share of the step)."""
        tracer = self.obs.tracer
        probe = self._consensus_probe(m)
        if probe is None:
            tracer.add_span("local-period", t0, t1, parent=epoch_span,
                            epoch=epoch)
            return
        if m not in self._probe_warm:
            self._time_probe(probe, state, a_np, lam2)
            self._probe_warm.add(m)
        gossip_ns = min(self._time_probe(probe, state, a_np, lam2), t1 - t0)
        split = t1 - gossip_ns
        tracer.add_span("local-period", t0, split, parent=epoch_span,
                        epoch=epoch, method="consensus-replay")
        tracer.add_span("gossip-period", split, t1, parent=epoch_span,
                        epoch=epoch, method="consensus-replay",
                        t_server=self.topo.t_server)

    def _gossip_cal_ns(self, m: int, state: dfl.DFLState, a_np,
                       lam2) -> Optional[int]:
        """The gossip period's wall time at federation size ``m``, measured
        ONCE per M (the probe after an untimed warm-up) and cached: the
        superepoch spans attribute every epoch of every block at this M
        from it instead of running the probe K times a block.  ``None``
        when there is no consensus period to time."""
        if m not in self._probe_cal:
            probe = self._consensus_probe(m)
            if probe is None:
                self._probe_cal[m] = None
            else:
                self._time_probe(probe, state, a_np, lam2)
                self._probe_cal[m] = self._time_probe(probe, state, a_np,
                                                      lam2)
        return self._probe_cal[m]

    def _trace_superepoch(self, se_span, epoch0: int, k: int, m: int,
                          t0: int, t1: int, state: dfl.DFLState, a_np,
                          lam2) -> None:
        """Tracer-only attribution of one K-epoch block: the [t0, t1] wall
        interval split uniformly into K ``epoch`` spans, each split into
        local-period / gossip-period by the cached ``_gossip_cal_ns``, and
        the gossip period into T_S equal ``gossip-round`` spans
        (``method="calibrated-round"``: attribution, not a per-round
        measurement, the reference's taxonomy)."""
        tracer = self.obs.tracer
        gossip_ns = self._gossip_cal_ns(m, state, a_np, lam2)
        t_server = self.topo.t_server
        dt = max((t1 - t0) // k, 1)
        for i in range(k):
            e0 = min(t0 + i * dt, t1)
            e1 = t1 if i == k - 1 else min(t0 + (i + 1) * dt, t1)
            ep_span = tracer.add_span("epoch", e0, e1, parent=se_span,
                                      epoch=epoch0 + i,
                                      method="uniform-split")
            if gossip_ns is None:
                tracer.add_span("local-period", e0, e1, parent=ep_span,
                                epoch=epoch0 + i)
                continue
            g = min(gossip_ns, e1 - e0)
            split = e1 - g
            tracer.add_span("local-period", e0, split, parent=ep_span,
                            epoch=epoch0 + i, method="calibrated")
            gp = tracer.add_span("gossip-period", split, e1, parent=ep_span,
                                 epoch=epoch0 + i, method="calibrated",
                                 t_server=t_server)
            rdt = max(g // max(t_server, 1), 1)
            for r in range(t_server):
                r0 = min(split + r * rdt, e1)
                r1 = e1 if r == t_server - 1 else min(split + (r + 1) * rdt,
                                                      e1)
                tracer.add_span("gossip-round", r0, r1, parent=gp,
                                epoch=epoch0 + i, round=r,
                                method="calibrated-round")

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

    def _screen_per_round(self, screen) -> Optional[np.ndarray]:
        """The robust screens' per-server counts of an epoch, per gossip
        round (the hub's histogram; their sum is the record's column)."""
        if screen is None:
            return None
        return np.asarray(screen, np.float32) / max(self.topo.t_server, 1)

    def _record(self, mask_np: np.ndarray, loss_last, disagreement, drift,
                sigma_prod: float, psw=None, byz_np=None,
                screen_per_round=None) -> Dict[str, float]:
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
        if screen_per_round is not None:
            # robust-screen activity, normalised per gossip round; the
            # per-server breakdown goes to the hub as a histogram
            record["screen_rejected"] = float(screen_per_round.sum())
        return record

    def run_epoch(self, state: dfl.DFLState, epoch: int,
                  batch_fn: BatchFn) -> Tuple[dfl.DFLState, Dict[str, float]]:
        obs = self.obs
        tracer = obs.tracer
        with obs.span("epoch", epoch=epoch) as epoch_span:
            with obs.span("fault-surgery", epoch=epoch):
                state = self.apply_faults(state, epoch)
            plan, sigma_prod = self._plan_epoch(epoch)
            batches = batch_fn(epoch, tuple(self.alive))
            device = tree_leaves(state.client_params)[0].device
            sched = EpochSchedule(
                torch.as_tensor(plan.mask, dtype=torch.float32,
                                device=device),
                torch.as_tensor(plan.mixing, dtype=torch.float32,
                                device=device),
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
            m = self.topo.num_servers
            built = m not in self._steps
            step = self._step()
            if built:
                obs.compile_event(self._build_cause(self._steps), m=m,
                                  programs=self._builds[m], epoch=epoch)
            t0 = tracer.now() if tracer is not None else 0
            state, metrics = step(state, batches, sched)
            if tracer is not None:
                # the sync exists only when a tracer is attached: the
                # untraced path dispatches exactly as before
                self._sync(state.client_params)
                self._trace_step(epoch_span, epoch, m, t0, tracer.now(),
                                 state, plan.mixing, plan.lam2)
            with obs.span("host-aggregation", epoch=epoch):
                # ONE device-to-host transfer for the metrics and the
                # push-sum weight
                mh, psw_h = self._device_get((metrics, state.psum_weight))
                screen = self._screen_per_round(mh.screen_rejected)
                record = self._record(plan.mask, mh.loss[-1],
                                      mh.server_disagreement,
                                      mh.client_drift, sigma_prod, psw_h,
                                      plan.byz, screen)
                if epoch_wire_bytes is not None:
                    # this epoch's own bytes (0.0 for an epoch without
                    # rounds) and the cumulative ratio
                    record["wire_mb"] = epoch_wire_bytes / 1e6
                    record["wire_ratio"] = self._bytes.ratio()
            obs.observe(epoch, record, servers=tuple(self.alive),
                        per_link=(self._bytes.per_link
                                  if self._bytes is not None else None),
                        screen_rejected=screen)
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
        obs = self.obs
        tracer = obs.tracer
        with obs.span("superepoch", epoch=epoch0, k=k) as se_span:
            with obs.span("fault-surgery", epoch=epoch0):
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
                return (None if x is None
                        else torch.as_tensor(x, device=device))

            sched = overlap.EpochScheduleBatch(*(on_device(x) for x in sb))
            batches = tree_map(lambda *xs: torch.stack(xs), *batch_list)
            del batch_list
            wire = None
            if self._bytes is not None:
                row_bytes, elems = self._wire_row_bytes(state)
                wire = self._bytes.update_many(
                    [p.mixing for p in plans], self.topo.t_server,
                    row_bytes=row_bytes, elems_per_row=elems)
            m = self.topo.num_servers
            built = (m, k) not in self._super_steps
            step = self._super_step(k)
            if built:
                obs.compile_event(self._build_cause(self._super_steps), m=m,
                                  programs=self._super_builds[(m, k)],
                                  epoch=epoch0, superepoch=k)
            t0 = tracer.now() if tracer is not None else 0
            state, metrics, psw = step(state, batches, sched)
            if tracer is not None:
                self._sync(state.client_params)
                self._trace_superepoch(se_span, epoch0, k, m, t0,
                                       tracer.now(), state,
                                       plans[-1].mixing, plans[-1].lam2)
            records = []
            with obs.span("host-aggregation", epoch=epoch0, k=k):
                # the block's ONLY device-to-host transfer
                mh, psw_h = self._device_get((metrics, psw))
                for i in range(k):
                    screen = self._screen_per_round(
                        None if mh.screen_rejected is None
                        else mh.screen_rejected[i])
                    record = self._record(
                        plans[i].mask, mh.loss[i][-1],
                        mh.server_disagreement[i], mh.client_drift[i],
                        sigmas[i], None if psw_h is None else psw_h[i],
                        plans[i].byz, screen)
                    if wire is not None:
                        epoch_bytes, ratio_after, _ = wire[i]
                        record["wire_mb"] = epoch_bytes / 1e6
                        record["wire_ratio"] = ratio_after
                    records.append((record, screen))
            for i, (record, screen) in enumerate(records):
                obs.observe(epoch0 + i, record, servers=tuple(self.alive),
                            per_link=wire[i][2] if wire is not None else None,
                            screen_rejected=screen)
        return state, [r for r, _ in records]

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
                obs: Optional[Any] = None,
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
    blocks of up to K epochs a dispatch, the same history at any K;
    ``obs`` attaches a ``repro_torch.obs.Observability`` bundle."""
    cfg = dfl.DFLConfig(topology=topology, consensus_mode=consensus_mode,
                        dynamic=True, **cfg_kw)
    return DynamicFederationEngine(
        cfg, loss_fn, optimizer,
        participation=participation or ParticipationSchedule(),
        topology_schedule=topology_schedule or TopologySchedule(),
        faults=faults or FaultSchedule(), obs=obs, superepoch=superepoch)
