"""Error feedback (EF) for compressed gossip: port of
``repro.comm.error_feedback``.

Each server keeps its compression residual and folds it into the next
period's message::

    msg_i = C(x_i + e_i)                    (crosses the wire)
    e_i'  = (x_i + e_i) - D(msg_i)          (stays local)

On the physical wire the tracked transmission is round 0 of the period
(``core.consensus.CompressedBackend``).  The residual tree (leaves
``(M, *w)``) rides across epochs in ``core.dfl.DFLState.ef_residual``.
The simulated wire's ``ef_roundtrip`` arrives with the simulated-wire slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map


def init_ef_residual(server_tree: Any) -> Any:
    """Zero residual, shaped like the server aggregates (leaves (M, *w))."""
    return tree_map(torch.zeros_like, server_tree)

