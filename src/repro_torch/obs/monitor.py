"""Live convergence monitoring against the paper's quantities (port of
``repro.obs.monitor``).

Turns each epoch record into derived gauges and watchdog checks:

- ``contraction_bound`` — Theorem 1 bounds the consensus error by the
  running product of per-epoch gossip contraction factors,
  ``sigma_prod * d0`` with ``d0`` the first observed disagreement: a
  measured disagreement far ABOVE this curve means gossip is not
  delivering the contraction the mixing matrices promise.
- ``tolerance_gap`` — the measured server disagreement relative to the
  fig-3 consensus tolerance (1e-3): ``disagreement / tol``; below 1 the
  run is inside the paper's reproduction band.

Watchdog rules (each fires a structured ``warning`` event through the hub,
at most once per rule per run):

- ``nan-loss``                — loss or disagreement went NaN/inf.
- ``disagreement-divergence`` — disagreement grew by more than
  ``divergence_factor``x over the last ``divergence_window`` epochs
  (consensus is losing to drift: wrong sigma, partition, attack).
- ``wire-ratio-regression``   — the compressed wire's savings collapsed:
  ``wire_ratio`` fell below ``wire_ratio_drop`` x its best observed value
  (e.g. the wire fell back to float payloads).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from .metrics import MetricsHub

FIG3_TOLERANCE = 1e-3

__all__ = ["FIG3_TOLERANCE", "WatchdogEvent", "ConvergenceMonitor"]


@dataclasses.dataclass
class WatchdogEvent:
    rule: str
    epoch: int
    message: str
    value: float


class ConvergenceMonitor:
    """Stateful per-run monitor; feed it every epoch record through
    ``observe`` and it emits derived gauges and watchdog warnings through
    the hub.  It only reads floats already computed on the host, so it
    cannot perturb training numerics."""

    def __init__(self, hub: MetricsHub, *,
                 disagreement_tol: float = FIG3_TOLERANCE,
                 divergence_factor: float = 10.0,
                 divergence_window: int = 5,
                 wire_ratio_drop: float = 0.5):
        self.hub = hub
        self.disagreement_tol = disagreement_tol
        self.divergence_factor = divergence_factor
        self.divergence_window = divergence_window
        self.wire_ratio_drop = wire_ratio_drop
        self.events: List[WatchdogEvent] = []
        self._d0: Optional[float] = None
        self._dis: List[float] = []
        self._best_ratio: float = 0.0
        self._fired: Dict[str, bool] = {}

    def _fire(self, rule: str, epoch: int, message: str,
              value: float) -> None:
        if self._fired.get(rule):
            return
        self._fired[rule] = True
        self.events.append(WatchdogEvent(rule, epoch, message, value))
        self.hub.warning(rule, message, epoch=epoch, value=value)

    def observe(self, epoch: int, record: Dict[str, float]) -> None:
        loss = record.get("loss")
        dis = record.get("disagreement")
        sigma = record.get("sigma_prod")
        ratio = record.get("wire_ratio")

        # derived gauges: the paper's quantities as live signals
        if dis is not None and math.isfinite(dis):
            if self._d0 is None:
                self._d0 = max(dis, self.disagreement_tol)
            self._dis.append(dis)
            self.hub.gauge("tolerance_gap", dis / self.disagreement_tol,
                           epoch=epoch)
            if sigma is not None and math.isfinite(sigma):
                self.hub.gauge("contraction_bound", sigma * self._d0,
                               epoch=epoch)

        # watchdog: nan-loss
        for key, val in (("loss", loss), ("disagreement", dis)):
            if val is not None and not math.isfinite(val):
                self._fire("nan-loss", epoch,
                           f"{key} is non-finite ({val}) — training has "
                           f"diverged or a kernel produced NaN", float("nan"))

        # watchdog: disagreement-divergence over a trailing window
        w = self.divergence_window
        if len(self._dis) > w:
            past = self._dis[-w - 1]
            now = self._dis[-1]
            if (math.isfinite(past) and math.isfinite(now) and past > 0
                    and now > self.divergence_factor * past
                    and now > self.disagreement_tol):
                self._fire(
                    "disagreement-divergence", epoch,
                    f"server disagreement grew {now / past:.1f}x over "
                    f"{w} epochs ({past:.3e} -> {now:.3e}) — consensus is "
                    f"losing to drift", now)

        # watchdog: wire-ratio regression (compressed runs only)
        if ratio is not None and math.isfinite(ratio) and ratio > 0:
            if ratio >= self._best_ratio:
                self._best_ratio = ratio
            elif ratio < self.wire_ratio_drop * self._best_ratio:
                self._fire(
                    "wire-ratio-regression", epoch,
                    f"wire compression ratio fell to {ratio:.2f}x from a "
                    f"best of {self._best_ratio:.2f}x — the wire may have "
                    f"fallen back to uncompressed payloads", ratio)
