"""Server-side consensus updates (Eq. 5/7): port of ``repro.core.consensus``.

A consensus round is ``W <- A W`` over the leading server axis of every
leaf.  The plain functions (``mix_pytree``, ``gossip_scan``,
``gossip_collapsed``) mirror the reference leaf by leaf and serve as the
port's own reference.  The backends — what the epoch step runs — flatten
the server tree ONCE per period to an ``(M, D)`` matrix and run each round
through ``repro_torch.kernels.ops.consensus_mix``: the CUDA kernel on the
card, its plain version on the CPU.  Leaves gossip independently
(``gossip_scan`` in the reference), so mixing the concatenation is the same
operator.

One difference from the reference: the reference's ``_mix_leaf`` contracts
in the leaf dtype, and its core never calls the Pallas kernel; here the
backends go through the f32 kernel, which takes f32 leaves only (bf16 leaves
are a later slice, see ROADMAP.md).

This slice ports ``gossip``, ``gossip_blocked``, ``collapsed``,
``exact_mean`` and ``none``; every other mode raises ``NotImplementedError``
naming the slice that brings it.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map

DEFAULT_GOSSIP_BLOCK = 4_194_304


def _mix_leaf(a: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """new[i] = sum_j a[i, j] * leaf[j, ...], contracted in the leaf dtype."""
    return torch.tensordot(a.to(device=leaf.device, dtype=leaf.dtype), leaf,
                           dims=([1], [0]))


def mix_pytree(a: torch.Tensor, tree: Any) -> Any:
    """One consensus round ``W <- A W`` applied to every leaf."""
    return tree_map(lambda leaf: _mix_leaf(a, leaf), tree)


def gossip_scan(a: torch.Tensor, tree: Any, t_server: int) -> Any:
    """Faithful T_S-round consensus, leaf by leaf (the plain reference)."""
    def leaf_loop(leaf):
        for _ in range(t_server):
            leaf = _mix_leaf(a, leaf)
        return leaf
    return tree_map(leaf_loop, tree)


def gossip_scan_blocked(a: torch.Tensor, tree: Any, t_server: int,
                        block: int = DEFAULT_GOSSIP_BLOCK) -> Any:
    """T_S rounds streamed over fixed-size column blocks of the flattened
    ``(M, D)`` server matrix: block-major, round-minor, which is the same
    operator since blocks mix independently, with a working set of one
    block.  Each round goes through ``ops.consensus_mix``."""
    return kops.consensus_mix_pytree(a, tree, rounds=t_server, block=block)


def collapse_mixing(a: np.ndarray, t_server: int) -> np.ndarray:
    """A_eff = A^{T_S} (host-side, float64). Doubly stochastic by closure."""
    return np.linalg.matrix_power(np.asarray(a, dtype=np.float64), t_server)


def gossip_collapsed(a_eff: torch.Tensor, tree: Any) -> Any:
    """Single-round application of the collapsed operator A^{T_S}."""
    return mix_pytree(a_eff, tree)


# ---------------------------------------------------------------------------
# consensus backends: one interface over every execution strategy
# ---------------------------------------------------------------------------


class ConsensusBackend:
    """One consensus period behind one interface: ``mix(tree, a_p)`` runs it
    on a server-leading pytree.  ``a_p`` is an optional per-epoch ``(M, M)``
    mixing matrix; ``None`` selects the static matrix the backend was built
    with.  ``supports_directed`` says whether the update is the literal
    ``W <- A W`` (so a row-stochastic A is well defined)."""

    name = "?"
    supports_directed = True

    def __init__(self, a_static: Optional[np.ndarray], t_server: int):
        self.a_static = (None if a_static is None
                         else torch.as_tensor(np.asarray(a_static),
                                              dtype=torch.float32))
        self.t_server = t_server

    def _resolve(self, a_p: Optional[torch.Tensor]) -> torch.Tensor:
        if a_p is not None:
            return a_p
        if self.a_static is None:
            raise ValueError(f"{self.name!r} backend was built without a "
                             f"static mixing matrix; pass a per-epoch A_p")
        return self.a_static

    def mix(self, tree: Any, a_p: Optional[torch.Tensor] = None) -> Any:
        """T_S rounds of ``W <- A W`` over the leading server axis."""
        return self._mix(tree, self._resolve(a_p))

    def _mix(self, tree: Any, a: torch.Tensor) -> Any:
        raise NotImplementedError


class GossipBackend(ConsensusBackend):
    """T_S rounds on the tree flattened once to ``(M, D)``: each round one
    ``ops.consensus_mix`` (one kernel launch on the card)."""

    name = "gossip"

    def _mix(self, tree, a):
        return kops.consensus_mix_pytree(a, tree, rounds=self.t_server)


class BlockedGossipBackend(ConsensusBackend):
    """``gossip_scan_blocked``: the rounds streamed over fixed-size column
    blocks (one kernel launch per block per round on the card)."""

    name = "gossip_blocked"

    def __init__(self, a_static, t_server, *,
                 block: int = DEFAULT_GOSSIP_BLOCK):
        super().__init__(a_static, t_server)
        self.block = block

    def _mix(self, tree, a):
        return gossip_scan_blocked(a, tree, self.t_server, block=self.block)


class CollapsedBackend(ConsensusBackend):
    """One round with ``A_eff = A^{T_S}``: host-side float64 collapse of the
    static matrix, in-program collapse of a per-epoch ``A_p``."""

    name = "collapsed"

    def __init__(self, a_static, t_server):
        super().__init__(a_static, t_server)
        self._eff_static = (None if a_static is None else torch.as_tensor(
            collapse_mixing(np.asarray(a_static), t_server),
            dtype=torch.float32))

    def _eff(self, a_p: Optional[torch.Tensor]) -> torch.Tensor:
        if a_p is None:
            if self._eff_static is None:
                raise ValueError("'collapsed' backend was built without a "
                                 "static mixing matrix; pass a per-epoch A_p")
            return self._eff_static
        eff = torch.eye(a_p.shape[0], dtype=a_p.dtype, device=a_p.device)
        for _ in range(self.t_server):
            eff = a_p @ eff
        return eff

    def mix(self, tree, a_p=None):
        return kops.consensus_mix_pytree(self._eff(a_p), tree, rounds=1)


class ExactMeanBackend(ConsensusBackend):
    """The idealised sigma_A = 0 limit (hierarchical FL with a root
    aggregator): ignores the mixing matrix, so directed mixing is undefined
    for it."""

    name = "exact_mean"
    supports_directed = False

    def _mix(self, tree, a):
        return tree_map(lambda x: x.mean(dim=0, keepdim=True).expand(x.shape),
                        tree)


_LATER = {
    "chebyshev": "Chebyshev gossip arrives with the dynamic-federation "
                 "slice",
    "trimmed_mean": "the robust screens arrive with the robust-gossip slice",
    "median": "the robust screens arrive with the robust-gossip slice",
    "clipped": "the robust screens arrive with the robust-gossip slice",
}


def make_backend(mode: str, a_static: Optional[np.ndarray], t_server: int, *,
                 block: int = DEFAULT_GOSSIP_BLOCK,
                 compression: str = "none",
                 staleness: int = 0) -> Optional[ConsensusBackend]:
    """Map a ``DFLConfig.consensus_mode`` string to a backend (``None`` for
    ``"none"``: no inter-server communication)."""
    base = mode.partition(":")[0]
    if base in _LATER:
        raise NotImplementedError(
            f"consensus mode {mode!r} is not ported yet: {_LATER[base]} "
            f"(ROADMAP.md, Queue 1)")
    if compression != "none":
        raise NotImplementedError(
            "compressed gossip arrives with the compressed-wire slice "
            "(ROADMAP.md, Queue 1)")
    if staleness:
        raise NotImplementedError(
            "bounded staleness arrives with the overlap work of the "
            "dynamic-federation slice (ROADMAP.md, Queue 1)")
    if mode == "none":
        return None
    if mode == "gossip":
        return GossipBackend(a_static, t_server)
    if mode == "gossip_blocked":
        return BlockedGossipBackend(a_static, t_server, block=block)
    if mode == "collapsed":
        return CollapsedBackend(a_static, t_server)
    if mode == "exact_mean":
        return ExactMeanBackend(a_static, t_server)
    raise ValueError(f"unknown consensus mode {mode!r}")
