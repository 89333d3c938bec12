"""Dynamic-federation schedules (numpy only): port of
``repro.core.schedule``.

The host-side scenario generators of the dynamic epoch step
(``dfl.build_dfl_epoch_step`` with ``DFLConfig(dynamic=True)``), which
consumes their output as per-epoch operands on the state's device:

* ``ParticipationSchedule`` — a per-epoch ``(M, N)`` 0/1 mask (full,
  bernoulli, fixed_k, round_robin, or a replayed 0/1 or float-rate trace).
  Eq. 4 becomes a masked mean (``dfl.masked_server_mean``) and
  non-participants carry their broadcast model forward unchanged.
* ``TopologySchedule`` — a per-epoch mixing matrix ``A_p`` (edge drop,
  straggler-weakened links, or row-stochastic asymmetric links).
  ``SigmaTracker`` accumulates the product contraction
  ``||prod_p A_p^{T_S} - 11'/M||_2``.
* ``FaultSchedule`` — server drop/rejoin events, executed between epochs by
  the engine's graph surgery (``engine.DynamicFederationEngine``).
* ``diurnal_trace`` / ``save_participation_trace`` /
  ``load_participation_trace`` — availability traces and their JSONL log.
* ``ByzantineAttack`` / ``ByzantineSchedule`` — which ORIGINAL servers
  attack, with which attack, each epoch: per-row codes the dynamic step
  hands to ``dfl.apply_byzantine`` (the attackers' identities are one
  seeded permutation, as in the reference).

Every sampler draws from ``numpy.random.default_rng((seed, epoch))``, as
the reference does, so masks, matrices and traces equal the reference's
exactly.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import topology as tp
from repro_torch.core.topology import FLTopology


class EpochSchedule(NamedTuple):
    """The per-epoch operands of a dynamic epoch step: tensors on the
    state's device for the step (the engine moves them there), numpy
    arrays on the host while a superepoch block is being planned.

    ``mask``:   (M, N) float32 0/1 participation mask.
    ``mixing``: (M, M) float32 mixing matrix A_p.
    ``lam2``:   optional float32 scalar |lambda_2(A_p)| — the per-epoch
                spectral estimate (``topology.lambda_2``) that spectral
                backends (``consensus.ChebyshevBackend``) consume; ``None``
                for every other backend.
    ``byz``:    optional (M,) int32 per-row attack codes
                (``ByzantineSchedule.codes``: 0 honest, k + 1 attack k);
                ``None`` without a Byzantine schedule.
    """

    mask: Any
    mixing: Any
    lam2: Optional[Any] = None
    byz: Optional[Any] = None


# ---------------------------------------------------------------------------
# participation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParticipationSchedule:
    """Per-epoch client participation masks.

    kinds:
      ``full``        every client every epoch (the paper's setting).
      ``bernoulli``   each client participates independently w.p. ``rate``.
      ``fixed_k``     exactly ``k`` uniformly-sampled clients per server.
      ``round_robin`` deterministic rotation of ``k`` clients per server —
                      the scheduling-policy baseline of Abdelghany et al.
      ``trace``       replay an explicit ``(E, M, N)`` availability trace
                      (epoch ``p`` uses row ``p mod E``).  A 0/1 trace is
                      replayed VERBATIM — diurnal cycles and correlated
                      churn instead of i.i.d. masks.  A trace with ANY
                      fractional entry in [0, 1] is instead a per-epoch
                      per-client sampling-RATE schedule: epoch ``p`` draws
                      ``mask[i, j] ~ Bernoulli(trace[p mod E, i, j])``,
                      deterministic in ``(seed, epoch)`` — logged
                      availability PROBABILITIES (fleet telemetry exports
                      rates, not outcomes) drive participation directly.
                      Either way the trace is authoritative: no
                      min_per_server top-up is applied (a replayed 0/1 log
                      must reproduce bitwise —
                      ``load_participation_trace`` round-trip; a rate row
                      must realise its exact Bernoulli law), so a
                      fully-idle server simply carries its model.

    ``min_per_server`` forces at least that many participants per server
    (sampled uniformly from the idle ones) so the masked Eq. 4 mean stays
    well-defined; set it to 0 to allow fully-idle servers, which then simply
    carry their model through the epoch.
    """

    kind: str = "full"
    rate: float = 1.0
    k: Optional[int] = None
    min_per_server: int = 1
    seed: int = 0
    # the (E, M, N) availability trace of kind="trace" — excluded from
    # eq/hash (ndarray __eq__ is elementwise and would break the frozen
    # dataclass contract) and from repr (it can be thousands of epochs)
    trace: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.kind not in ("full", "bernoulli", "fixed_k", "round_robin",
                             "trace"):
            raise ValueError(f"unknown participation kind {self.kind!r}")
        if self.kind == "bernoulli" and not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        if self.kind in ("fixed_k", "round_robin") and not self.k:
            raise ValueError(f"kind={self.kind!r} needs k >= 1")
        if self.kind == "trace":
            if self.trace is None:
                raise ValueError("kind='trace' needs a trace array — "
                                 "generate one with diurnal_trace or load "
                                 "a log with load_participation_trace")
            t = np.asarray(self.trace)
            if t.ndim != 3 or t.shape[0] < 1:
                raise ValueError(f"trace must be (E, M, N) with E >= 1, "
                                 f"got shape {t.shape}")
            if t.min() < 0.0 or t.max() > 1.0:
                raise ValueError(
                    "trace entries must be 0/1 availability or Bernoulli "
                    "rates in [0, 1]")
        elif self.trace is not None:
            raise ValueError(f"kind={self.kind!r} does not take a trace")

    def mask(self, epoch: int, m: int, n: int) -> np.ndarray:
        """(M, N) float32 0/1 mask for ``epoch`` — deterministic in
        (seed, epoch), independent of call order."""
        if self.kind == "full":
            return np.ones((m, n), np.float32)
        if self.kind == "trace":
            t = np.asarray(self.trace)
            if t.shape[1:] != (m, n):
                raise ValueError(
                    f"participation trace is shaped for a "
                    f"({t.shape[1]}, {t.shape[2]}) federation but this run "
                    f"has (M, N) = ({m}, {n}) — traces replay availability "
                    f"of SPECIFIC clients and cannot be resized")
            row = t[epoch % t.shape[0]]
            if np.isin(t, (0, 1)).all():
                # binary availability log: replayed verbatim (bitwise)
                return row.astype(np.float32)
            # sampling-RATE trace: per-client Bernoulli draw against this
            # epoch's rate row, deterministic in (seed, epoch) like every
            # other sampled kind
            rng = np.random.default_rng((self.seed, epoch))
            return (rng.random((m, n)) < np.asarray(row, np.float64)
                    ).astype(np.float32)
        rng = np.random.default_rng((self.seed, epoch))
        if self.kind == "bernoulli":
            mask = (rng.random((m, n)) < self.rate)
        elif self.kind == "fixed_k":
            k = min(self.k, n)
            mask = np.zeros((m, n), bool)
            for i in range(m):
                mask[i, rng.choice(n, size=k, replace=False)] = True
        else:  # round_robin
            k = min(self.k, n)
            cols = (epoch * k + np.arange(k)) % n
            mask = np.zeros((m, n), bool)
            mask[:, cols] = True
        need = min(self.min_per_server, n)
        for i in range(m):
            short = need - int(mask[i].sum())
            if short > 0:
                idle = np.nonzero(~mask[i])[0]
                mask[i, rng.choice(idle, size=short, replace=False)] = True
        return mask.astype(np.float32)

    def expected_rate(self, n: int) -> float:
        """Mean fraction of participating clients (for reporting).  For
        kind='trace' this is EXACT — the empirical mean of a replayed 0/1
        trace, and the exact Bernoulli expectation (mean of the rates) of
        a sampling-rate trace — since the trace is authoritative (no
        top-up)."""
        if self.kind == "full":
            return 1.0
        if self.kind == "trace":
            return float(np.asarray(self.trace, np.float64).mean())
        if self.kind == "bernoulli":
            return max(self.rate, self.min_per_server / n)
        return min(self.k, n) / n


def diurnal_trace(epochs: int, m: int, n: int, *, period: int = 24,
                  base: float = 0.6, amplitude: float = 0.4,
                  min_per_server: int = 1, seed: int = 0) -> np.ndarray:
    """Synthesise an ``(epochs, M, N)`` uint8 availability trace with a
    diurnal cycle: server ``i``'s clients are available w.p.
    ``clip(base + amplitude * sin(2 pi (p + phase_i) / period), 0, 1)`` at
    epoch ``p``, with a uniformly-random per-server phase — correlated
    within a server (its whole fleet sees the same local time-of-day) and
    staggered across servers (time zones), the two structures i.i.d.
    Bernoulli masks cannot express.  ``min_per_server`` participants are
    topped up deterministically HERE, at generation time, so the emitted
    trace is replayable verbatim (``ParticipationSchedule(kind='trace')``
    applies no further top-up)."""
    if epochs < 1 or m < 1 or n < 1:
        raise ValueError("diurnal_trace needs epochs, m, n >= 1")
    rng = np.random.default_rng((seed, 0))
    phase = rng.uniform(0.0, period, size=m)
    trace = np.zeros((epochs, m, n), np.uint8)
    need = min(min_per_server, n)
    for p in range(epochs):
        rate = np.clip(base + amplitude
                       * np.sin(2.0 * np.pi * (p + phase) / period),
                       0.0, 1.0)                              # (M,)
        row = rng.random((m, n)) < rate[:, None]
        for i in range(m):
            short = need - int(row[i].sum())
            if short > 0:
                idle = np.nonzero(~row[i])[0]
                row[i, rng.choice(idle, size=short, replace=False)] = True
        trace[p] = row
    return trace


def save_participation_trace(path: str, trace: np.ndarray) -> None:
    """Write an availability trace as a JSONL log: one line per epoch,
    ``{"epoch": p, "mask": [[0/1 x N] x M]}`` — the interchange format for
    replaying real fleet availability logs through
    ``ParticipationSchedule(kind="trace")``.  A 0/1 trace serialises as
    integer lists (the original format, byte-stable); a sampling-RATE
    trace (any fractional entry) serialises its rates as f32-exact floats,
    so the round trip through ``load_participation_trace`` reproduces the
    float32 rates bitwise."""
    t = np.asarray(trace)
    if t.ndim != 3:
        raise ValueError(f"trace must be (E, M, N), got shape {t.shape}")
    binary = np.isin(t, (0, 1)).all()
    with open(path, "w") as f:
        for p in range(t.shape[0]):
            row = (t[p].astype(int) if binary
                   else t[p].astype(np.float32)).tolist()
            f.write(json.dumps({"epoch": p, "mask": row}) + "\n")


def load_participation_trace(path: str) -> np.ndarray:
    """Read a JSONL availability log back into an ``(E, M, N)`` trace —
    uint8 for a 0/1 availability log, float32 for a sampling-rate log
    (any fractional entry; see ``ParticipationSchedule`` kind='trace').
    Lines must cover epochs 0..E-1 contiguously and in order (a replayed
    log with a hole would silently shift every later epoch), and every
    mask must share one (M, N) shape."""
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(filter(str.strip, f)):
            rec = json.loads(line)
            if rec.get("epoch") != lineno:
                raise ValueError(
                    f"availability log {path!r} is not contiguous: line "
                    f"{lineno} carries epoch {rec.get('epoch')!r} (expected "
                    f"{lineno}) — a hole would shift every later epoch")
            rows.append(np.asarray(rec["mask"], np.float64))
    if not rows:
        raise ValueError(f"availability log {path!r} is empty")
    if any(r.shape != rows[0].shape or r.ndim != 2 for r in rows):
        raise ValueError(f"availability log {path!r} mixes mask shapes")
    stack = np.stack(rows)
    if np.isin(stack, (0, 1)).all():
        return stack.astype(np.uint8)
    return stack.astype(np.float32)


# ---------------------------------------------------------------------------
# time-varying graphs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """Per-epoch mixing matrices A_p over a degrading server network.

    kinds:
      ``static``    A_p = A for all p (the paper; bitwise-reproduces the
                    fixed-graph run).
      ``edge_drop`` each epoch, every edge of the base graph fails
                    independently w.p. ``drop_prob`` (repaired back to
                    connectivity when ``ensure_connected``).
      ``straggler`` each epoch, ``n_weak`` uniformly-chosen links carry only
                    ``(1 - weaken)`` of their weight (the rest returns to the
                    endpoint self-loops) — slow links, not dead ones.
      ``asymmetric`` each epoch, every DIRECTION of every base-graph edge
                    fails independently w.p. ``drop_prob`` (repaired back to
                    strong connectivity when ``ensure_connected``), and the
                    emitted A_p is the ROW-stochastic
                    ``topology.out_degree_weights`` of the surviving
                    digraph.  With ``weaken > 0``, additionally the
                    directed counterpart of ``straggler``: ``n_weak``
                    uniformly-chosen surviving link DIRECTIONS keep only
                    ``(1 - weaken)`` of their weight, the rest returning to
                    the SENDER's self-loop
                    (``topology.weaken_directed_links``) — one-sided slow
                    links, not dead ones.  Legal only with a directed
                    mixing: ``DFLConfig(mixing="push_sum")`` (unbiased) or
                    ``"row_stochastic"`` (the biased baseline).

    Under the first three kinds every emitted A_p is symmetric doubly
    stochastic (Eq. 6 without the fixed-support clause), so each epoch's
    gossip preserves the server mean; under ``asymmetric`` the A_p are only
    row stochastic and plain gossip is biased (push-sum's ratio read-out
    restores the mean).  Contraction over a run is
    tracked by ``SigmaTracker``.
    """

    kind: str = "static"
    drop_prob: float = 0.0
    weaken: float = 0.0
    n_weak: int = 1
    ensure_connected: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("static", "edge_drop", "straggler", "asymmetric"):
            raise ValueError(f"unknown topology schedule kind {self.kind!r}")

    def mixing(self, topo: FLTopology, epoch: int) -> np.ndarray:
        """float64 (M, M) mixing matrix for ``epoch`` (full precision so
        ``SigmaTracker`` products stay meaningful; the engine casts it to
        f32 when it moves it to the state's device)."""
        if topo.num_servers == 1:
            return np.ones((1, 1))
        if self.kind == "static":
            return topo.mixing_matrix()
        rng = np.random.default_rng((self.seed, epoch))
        if self.kind == "asymmetric":
            adj = tp.random_direction_drop(
                topo.adjacency(), self.drop_prob, rng,
                ensure_strong=self.ensure_connected)
            a = tp.out_degree_weights(adj)
            if self.weaken > 0.0 and self.n_weak:
                # directed straggler: weaken individual link DIRECTIONS
                di, dj = np.nonzero(adj)
                off = di != dj
                di, dj = di[off], dj[off]
                if di.size:
                    pick = rng.choice(di.size,
                                      size=min(self.n_weak, di.size),
                                      replace=False)
                    a = tp.weaken_directed_links(
                        a, list(zip(di[pick], dj[pick])), self.weaken)
            tp.check_row_stochastic(a, adj)
            return a
        if self.kind == "edge_drop":
            adj = tp.random_edge_drop(topo.adjacency(), self.drop_prob, rng,
                                      ensure_connected=self.ensure_connected)
            a = (tp.metropolis_weights(adj) if topo.mixing == "metropolis"
                 else tp.uniform_weights(adj))
            tp.check_mixing_matrix(a, adj)
            return a
        # straggler: weaken n_weak random links of the base matrix
        a = topo.mixing_matrix()
        iu, ju = np.nonzero(np.triu(topo.adjacency(), 1))
        if iu.size:
            pick = rng.choice(iu.size, size=min(self.n_weak, iu.size),
                              replace=False)
            a = tp.weaken_links(a, list(zip(iu[pick], ju[pick])), self.weaken)
        return a


class SigmaTracker:
    """Host-side product-contraction tracking for time-varying gossip.

    ``mode="average"`` (symmetric, doubly-stochastic gossip): accumulates
    ``P <- A_p^{T_S} P`` across epochs; ``sigma()`` is ``||P - 11'/M||_2``,
    the factor by which the initial server disagreement has provably
    contracted so far (Lemma 1 with a matrix product in place of a power).

    ``mode="push_sum"`` (directed, row-stochastic A_p): accumulates the
    column-stochastic ``P <- (A_p')^{T_S} P``; ``sigma()`` is
    ``topology.push_sum_deviation(P)``, the contraction of the ratio
    read-out, which goes to 0 under joint strong connectivity although P
    itself tends to a skewed rank-one ``v 1'``.

    ``staleness`` is the bounded-staleness depth s of the consensus period:
    only one round in every s + 1 advances the chain, so an epoch
    contributes ``A_p^(T_S // (s + 1))``.  Reset on topology surgery (M
    changes)."""

    def __init__(self, m: int, mode: str = "average", *, staleness: int = 0):
        if mode not in ("average", "push_sum"):
            raise ValueError(f"unknown SigmaTracker mode {mode!r}")
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        self.m = m
        self.mode = mode
        self.staleness = staleness
        self.prod = np.eye(m)

    def update(self, a: np.ndarray, t_server: int) -> float:
        op = np.asarray(a, np.float64)
        if self.mode == "push_sum":
            op = op.T
        rounds = t_server // (self.staleness + 1)
        self.prod = np.linalg.matrix_power(op, rounds) @ self.prod
        return self.sigma()

    def sigma(self) -> float:
        if self.mode == "push_sum":
            return tp.push_sum_deviation(self.prod)
        return tp.consensus_deviation(self.prod)


# ---------------------------------------------------------------------------
# fault schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at the START of ``epoch``, ``server`` (an
    ORIGINAL server index, stable across surgeries) drops out or rejoins."""

    epoch: int
    kind: str          # "drop" | "rejoin"
    server: int

    def __post_init__(self):
        if self.kind not in ("drop", "rejoin"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.epoch < 0 or self.server < 0:
            raise ValueError("epoch and server must be non-negative")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    events: Tuple[FaultEvent, ...] = ()

    @staticmethod
    def parse(spec: str) -> "FaultSchedule":
        """Parse the CLI fault grammar of ``launch/train.py --faults``.

        Grammar (comma-separated events, whitespace around events ignored)::

            spec   ::= "" | event ("," event)*
            event  ::= kind ":" EPOCH ":" SERVER
            kind   ::= "drop" | "rejoin"

        where ``EPOCH`` and ``SERVER`` are non-negative decimal integers:
        the event fires at the START of epoch ``EPOCH`` (before that
        epoch's local period), and ``SERVER`` is an ORIGINAL server index —
        stable across surgeries, so ``"drop:5:2,rejoin:9:2"`` drops server
        2 at epoch 5 and re-admits the SAME server (with its own clients'
        data shards) at epoch 9.  A rejoined server re-enters at the last
        row position with the survivors' mean model.  Events need not be
        sorted; several events may share an epoch and are applied in spec
        order.  The empty string parses to an empty schedule.  Malformed
        events (wrong field count, non-numeric epoch/server, unknown kind)
        raise ``ValueError``; ids outside the ORIGINAL federation (>= M)
        are rejected by ``FaultSchedule.validate`` when the engine is
        constructed."""
        events = []
        for part in filter(None, (s.strip() for s in spec.split(","))):
            fields = part.split(":")
            if len(fields) != 3 or not fields[1].isdigit() \
                    or not fields[2].isdigit():
                raise ValueError(
                    f"bad fault spec {part!r}: expected "
                    f"'drop:EPOCH:SERVER' or 'rejoin:EPOCH:SERVER'")
            kind, epoch, server = fields
            events.append(FaultEvent(int(epoch), kind, int(server)))
        return FaultSchedule(tuple(events))

    def validate(self, num_servers: int) -> None:
        """Reject events naming servers the federation never had.

        ``SERVER`` ids are ORIGINAL indices: client data ownership is keyed
        by original identity (``engine.BatchFn`` / the data pipelines), so
        an id >= the initial federation size has no data shard — a
        ``rejoin`` for it would crash (or silently alias another server's
        shard) mid-run at the first batch fetch.  The engine calls this at
        construction so a bad schedule fails before any training."""
        for ev in self.events:
            if ev.server >= num_servers:
                raise ValueError(
                    f"fault event {ev.kind}:{ev.epoch}:{ev.server} names "
                    f"server {ev.server}, but the federation has only "
                    f"{num_servers} ORIGINAL servers (ids 0.."
                    f"{num_servers - 1}); fresh-id rejoin is undefined — "
                    f"data shards are keyed by original identity")

    def at(self, epoch: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.epoch == epoch)

    @property
    def last_epoch(self) -> int:
        return max((e.epoch for e in self.events), default=-1)

    @staticmethod
    def from_trace(trace: np.ndarray, *,
                   min_down_epochs: int = 1) -> "FaultSchedule":
        """Derive correlated drop/rejoin churn from an ``(E, M, N)``
        availability trace — the SAME JSONL logs
        ``ParticipationSchedule(kind="trace")`` replays
        (``load_participation_trace`` / ``diurnal_trace``), so one fleet
        log drives both participation masks and server-level surgery.

        Server ``i`` is DOWN at epoch ``p`` iff its whole client row is
        zero (no client of that server reported in).  Each maximal outage
        ``[p0, p1)`` becomes ``drop`` at epoch ``p0`` and ``rejoin`` at
        epoch ``p1`` (events fire at the START of an epoch, matching the
        engine's surgery point); an outage still running at the end of
        the trace gets no rejoin.  Outages shorter than
        ``min_down_epochs`` are ignored as logging blips — raise it to
        keep transient gaps from thrashing the step cache with drop/rejoin
        resizes.  Rejects a trace with an epoch where EVERY server is
        down (the surgery would leave an empty federation); round-trip:
        replaying the events reproduces the trace's (blip-filtered)
        down-timeline exactly (``tests/test_torch_dynamic.py``)."""
        t = np.asarray(trace)
        if t.ndim != 3 or t.shape[0] < 1:
            raise ValueError(f"trace must be (E, M, N) with E >= 1, got "
                             f"shape {t.shape}")
        if not np.isin(t, (0, 1)).all():
            raise ValueError("trace entries must be 0/1 availability")
        if min_down_epochs < 1:
            raise ValueError("min_down_epochs must be >= 1")
        epochs, m, _ = t.shape
        down = t.sum(axis=2) == 0                          # (E, M)
        # blip filter BEFORE the all-down check: a one-epoch global gap
        # below the threshold never becomes surgery, so it is survivable
        kept = np.zeros_like(down)
        events = []
        for i in range(m):
            p = 0
            while p < epochs:
                if not down[p, i]:
                    p += 1
                    continue
                q = p
                while q < epochs and down[q, i]:
                    q += 1
                if q - p >= min_down_epochs:
                    kept[p:q, i] = True
                    events.append(FaultEvent(p, "drop", i))
                    if q < epochs:
                        events.append(FaultEvent(q, "rejoin", i))
                p = q
        all_down = np.nonzero(kept.all(axis=1))[0]
        if all_down.size:
            raise ValueError(
                f"availability trace has every server down at epoch(s) "
                f"{all_down.tolist()[:5]} — the derived surgery would "
                f"leave an empty federation; raise min_down_epochs or "
                f"clean the log")
        events.sort(key=lambda e: (e.epoch, e.kind == "drop", e.server))
        return FaultSchedule(tuple(events))


# ---------------------------------------------------------------------------
# Byzantine (adversarial-server) schedules
# ---------------------------------------------------------------------------

ATTACK_KINDS = ("sign_flip", "scaled_noise", "inlier_shift")


@dataclasses.dataclass(frozen=True)
class ByzantineAttack:
    """One attack population: a ``frac`` fraction of the ORIGINAL servers
    runs attack ``kind`` with strength ``scale``.

    kinds (the injection itself is ``dfl.apply_byzantine``):
      ``sign_flip``    transmit ``-scale * w`` — the classic
                       gradient/model reversal; drags plain gossip's
                       average toward the mirrored model.
      ``scaled_noise`` transmit ``w + scale * N(0, I)`` — a noise flooder;
                       keeps every honest neighbor's post-mix state jittery
                       so disagreement never reaches tolerance.
      ``inlier_shift`` COLLUSION that stays inside the honest coordinate
                       range: transmit ``h_min + scale * (h_max - h_min)``
                       per coordinate (the honest envelope's ``scale``
                       quantile corner, computed over the true honest
                       servers) — undetectable by range checks, biases
                       plain averaging toward the envelope edge.
    """

    kind: str
    frac: float
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown byzantine attack kind {self.kind!r}; "
                             f"choose from {ATTACK_KINDS}")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError("attack frac must be in [0, 1]")
        if self.kind == "inlier_shift" and not 0.0 <= self.scale <= 1.0:
            raise ValueError("inlier_shift scale is an envelope quantile "
                             "and must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class ByzantineSchedule:
    """Which servers attack, when — the adversarial sibling of
    ``FaultSchedule``.

    Attacker identities are drawn over ORIGINAL server ids (one seeded
    permutation of ``range(M)``, carved into disjoint per-attack sets), so
    they are stable across drop/rejoin surgery: a server that is both
    scheduled to attack and currently dropped simply isn't there to
    attack, and resumes attacking when it rejoins.  With ``resample=True``
    a fresh permutation is drawn every epoch (a roaming adversary);
    default is the fixed-adversary model every breakdown-point statement
    assumes.

    The schedule only MARKS attackers (host-side, ``codes``); the attacks
    themselves are a pure function applied to the pre-gossip server tree
    by ``dfl.apply_byzantine``, so one epoch step per federation size
    serves every epoch's attacker set."""

    attacks: Tuple[ByzantineAttack, ...] = ()
    seed: int = 0
    resample: bool = False

    @staticmethod
    def parse(spec: str, *, seed: int = 0,
              resample: bool = False) -> "ByzantineSchedule":
        """Parse the CLI grammar of ``launch/train.py --byzantine``.

        Grammar (comma-separated attacks, whitespace ignored)::

            spec   ::= "" | attack ("," attack)*
            attack ::= kind ":" FRAC [":" SCALE]
            kind   ::= "sign_flip" | "scaled_noise" | "inlier_shift"

        e.g. ``"sign_flip:0.125"`` (1 of 8 servers flips its sign at the
        default scale 1.0) or ``"sign_flip:0.1,scaled_noise:0.1:10"``.
        The empty string parses to an empty (all-honest) schedule."""
        attacks = []
        for part in filter(None, (s.strip() for s in spec.split(","))):
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(f"bad byzantine spec {part!r}: expected "
                                 f"'kind:FRAC[:SCALE]'")
            try:
                frac = float(fields[1])
                scale = float(fields[2]) if len(fields) == 3 else 1.0
            except ValueError:
                raise ValueError(f"bad byzantine spec {part!r}: FRAC and "
                                 f"SCALE must be numbers")
            attacks.append(ByzantineAttack(fields[0], frac, scale))
        return ByzantineSchedule(tuple(attacks), seed=seed,
                                 resample=resample)

    def counts(self, m: int) -> Tuple[int, ...]:
        """Attackers per attack at federation size ``m`` (rounded)."""
        return tuple(int(round(a.frac * m)) for a in self.attacks)

    def validate(self, num_servers: int) -> None:
        """Fail at engine construction when the attack populations don't
        fit: the per-attack sets are disjoint, so their total size must
        leave at least one honest server (an all-attacker federation has
        no honest envelope, no honest metric, and nothing to defend)."""
        total = sum(self.counts(num_servers))
        if total >= num_servers and total > 0:
            raise ValueError(
                f"byzantine schedule marks {total} attackers but the "
                f"federation has only {num_servers} servers — at least one "
                f"honest server must remain")

    def attacker_sets(self, epoch: int, m: int) -> Tuple[frozenset, ...]:
        """Disjoint per-attack sets of ORIGINAL server ids for ``epoch``:
        one seeded permutation of ``range(m)`` carved sequentially (a
        fixed permutation unless ``resample``)."""
        if not self.attacks:
            return ()
        key = (self.seed, epoch) if self.resample else (self.seed,)
        perm = np.random.default_rng(key).permutation(m)
        sets, lo = [], 0
        for cnt in self.counts(m):
            sets.append(frozenset(int(s) for s in perm[lo:lo + cnt]))
            lo += cnt
        return tuple(sets)

    def codes(self, epoch: int, alive: Tuple[int, ...],
              num_servers: int) -> np.ndarray:
        """Per-CURRENT-ROW attack codes for ``epoch``: 0 = honest, k+1 =
        ``attacks[k]``.  ``alive`` is the engine's original-id row order,
        so the codes line up with the state arrays after any surgery;
        ``num_servers`` is the ORIGINAL federation size — the permutation
        is always drawn over it, so attacker identities don't shift when
        a server drops."""
        sets = self.attacker_sets(epoch, num_servers)
        out = np.zeros(len(alive), np.int32)
        for row, orig in enumerate(alive):
            for k, ids in enumerate(sets):
                if orig in ids:
                    out[row] = k + 1
                    break
        return out
