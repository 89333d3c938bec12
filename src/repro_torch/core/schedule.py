"""Host-side consensus bookkeeping of the static trainer (numpy only).

Port of ``repro.core.schedule.SigmaTracker`` in its ``"average"`` mode —
the trainer's ``sigma_prod``.  Participation, topology and fault schedules
arrive with the dynamic-federation slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology as tp


class SigmaTracker:
    """Product contraction of symmetric gossip across epochs.

    Accumulates ``P <- A_p^{T_S} P``; ``sigma()`` is ``||P - 11'/M||_2``, the
    factor by which the initial server disagreement has provably contracted
    so far (Lemma 1 with a matrix product in place of a power).

    ``staleness`` is the bounded-staleness depth s of the period: only one
    round in every s + 1 advances the chain, so an epoch contributes
    ``A_p^(T_S // (s + 1))``."""

    def __init__(self, m: int, mode: str = "average", *, staleness: int = 0):
        if mode == "push_sum":
            raise NotImplementedError(
                "SigmaTracker(mode='push_sum') arrives with directed "
                "federation in the dynamic-federation slice (ROADMAP.md)")
        if mode != "average":
            raise ValueError(f"unknown SigmaTracker mode {mode!r}")
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        self.m = m
        self.mode = mode
        self.staleness = staleness
        self.prod = np.eye(m)

    def update(self, a: np.ndarray, t_server: int) -> float:
        op = np.asarray(a, np.float64)
        rounds = t_server // (self.staleness + 1)
        self.prod = np.linalg.matrix_power(op, rounds) @ self.prod
        return self.sigma()

    def sigma(self) -> float:
        return tp.consensus_deviation(self.prod)
