"""On-wire byte accounting for the compressed-gossip layer: port of
``repro.comm.accounting`` (host-side, exact).

During one consensus period every live DIRECTED link carries one message per
round, so

    epoch bytes = sum over links (i <- j) of  T_S * row_bytes
    link (i <- j) is live iff  A[i, j] != 0, i != j

``BytesTracker`` accumulates that per epoch beside the float32 baseline of
the same traffic.  On the simulated wire ``row_bytes`` is the unpadded
payload of one message (``compressors.tree_wire_bytes_per_server``), and
push-sum's f32 weight adds 4 bytes a message.  On the physical wire
``row_bytes`` is the padded code + scale layout the rounds actually move:
``tree_bucketed_wire_bytes_per_server`` for the bucketed layout,
``tree_physical_wire_bytes_per_server`` for the per-leaf one.  The reference's ``hlo_collective_bytes`` reads XLA's compiled
HLO and has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.comm import compressors as cp
from repro_torch.tree import tree_leaves


def uncompressed_row_bytes(d: int, bytes_per_elem: int = 4) -> int:
    """Baseline: one float32 (by default) replica row on the wire."""
    return d * bytes_per_elem


def analytic_row_bytes(compressor: cp.Compressor, d: int) -> int:
    """Closed-form on-wire bytes of one compressed d-element row, written
    independently of ``Compressor.wire_bytes_per_row``."""
    if isinstance(compressor, cp.IdentityCompressor):
        return 4 * d
    if isinstance(compressor, cp.StochasticQuantizer):
        nc = -(-d // compressor.chunk)
        return int(np.ceil(d * compressor.bits / 8)) + 4 * nc
    if isinstance(compressor, cp.TopKCompressor):
        return compressor.k_for(d) * (4 + 4)              # values + indices
    if isinstance(compressor, cp.RandomKCompressor):
        return compressor.k_for(d) * 4                    # seed-shared idx
    raise ValueError(f"no analytic byte count for {compressor!r}")


def analytic_leaf_bytes(compressor: cp.Compressor, shape) -> int:
    """Closed form of ``Compressor.wire_bytes_per_leaf``: quantizers chunk
    the leaf's LAST axis per row."""
    shape = tuple(shape)
    d = int(np.prod(shape[1:]))
    if isinstance(compressor, cp.StochasticQuantizer):
        rows = int(np.prod(shape[1:-1])) if len(shape) > 2 else 1
        length = shape[-1] if len(shape) > 1 else 1
        nc = rows * -(-length // compressor.chunk)
        return int(np.ceil(d * compressor.bits / 8)) + 4 * nc
    return analytic_row_bytes(compressor, d)


def _need_quantizer(quantizer) -> None:
    if not isinstance(quantizer, cp.StochasticQuantizer):
        raise ValueError(
            f"the physical wire has a byte layout only for the int8/int4 "
            f"quantizers, got {quantizer!r}")


def physical_leaf_bytes(quantizer: cp.StochasticQuantizer, shape,
                        block: int) -> int:
    """Per-round bytes of one server's per-leaf physical-wire message for
    one leaf: its row flattened and padded to ``nb`` blocks of ``min(block,
    d)`` elements, each block's codes + scales."""
    _need_quantizer(quantizer)
    d = int(np.prod(tuple(shape)[1:]))
    blk = min(block, d)
    nb = -(-d // blk)
    code_bytes, scale_bytes = quantizer.wire_block_bytes(blk)
    return nb * (code_bytes + scale_bytes)


def tree_physical_wire_bytes_per_server(quantizer: cp.StochasticQuantizer,
                                        tree, block: int) -> int:
    """Per-round bytes of one server's whole message in the per-leaf layout
    (``core.consensus.gossip_scan_wire``); leaves need only ``.shape``."""
    return sum(physical_leaf_bytes(quantizer, leaf.shape, block)
               for leaf in tree_leaves(tree))


def tree_bucketed_wire_bytes_per_server(quantizer: cp.StochasticQuantizer,
                                        tree, block: int) -> int:
    """Per-round bytes of one server's whole message in the BUCKETED layout
    (``comm.compressors.bucket_block``): ``nb`` blocks of ``blk`` codes plus
    one f32 scale per chunk."""
    _need_quantizer(quantizer)
    d_tot = sum(int(np.prod(tuple(leaf.shape)[1:]))
                for leaf in tree_leaves(tree))
    blk, nb = cp.bucket_block(d_tot, block, quantizer.chunk)
    code_bytes, scale_bytes = quantizer.wire_block_bytes(blk)
    return nb * (code_bytes + scale_bytes)


class BytesTracker:
    """Host-side on-wire byte accumulator for compressed consensus.

    ``update`` takes an epoch's mixing matrix (its off-diagonal support is
    the live directed links), the round count, the per-row compressed bytes
    and the per-row element count, and returns the epoch's total;
    ``per_link`` holds the last epoch's (M, M) byte matrix (entry [i, j] =
    bytes shipped j -> i).  ``ratio()`` is cumulative float32 bytes over
    shipped bytes."""

    def __init__(self, compressor: cp.Compressor, *, push_sum: bool = False,
                 wire: str = "simulated",
                 baseline_bytes_per_elem: int = 4):
        self.compressor = compressor
        self.push_sum = push_sum
        self.wire = wire
        self.baseline_bytes_per_elem = baseline_bytes_per_elem
        self.total_bytes = 0
        self.baseline_bytes = 0
        self.per_link: Optional[np.ndarray] = None
        self.history: List[Dict[str, float]] = []

    def _msg_bytes(self, row_bytes: int) -> int:
        # push-sum's f32 weight rides every message on the simulated wire
        # only; on the physical wire it never crosses the wire
        if self.push_sum and self.wire != "physical":
            return row_bytes + 4
        return row_bytes

    def epoch_link_bytes(self, a_np: np.ndarray, t_server: int,
                         row_bytes: int) -> np.ndarray:
        """(M, M) int64 matrix of this epoch's per-link bytes."""
        a = np.asarray(a_np)
        live = (a != 0) & ~np.eye(a.shape[0], dtype=bool)
        return live.astype(np.int64) * (t_server * self._msg_bytes(row_bytes))

    def update(self, a_np: np.ndarray, t_server: int, *, row_bytes: int,
               elems_per_row: int) -> float:
        """Account one epoch; returns its total on-wire bytes."""
        self.per_link = self.epoch_link_bytes(a_np, t_server, row_bytes)
        epoch_bytes = int(self.per_link.sum())
        n_msgs = int((self.per_link > 0).sum()) * t_server
        base_row = self._msg_bytes(uncompressed_row_bytes(
            elems_per_row, self.baseline_bytes_per_elem))
        epoch_baseline = n_msgs * base_row
        self.total_bytes += epoch_bytes
        self.baseline_bytes += epoch_baseline
        self.history.append({"bytes": float(epoch_bytes),
                             "baseline": float(epoch_baseline)})
        return float(epoch_bytes)

    def update_many(self, a_stack, t_server: int, *, row_bytes: int,
                    elems_per_row: int) -> List[tuple]:
        """K sequential ``update``s: ``[(epoch_bytes, cumulative ratio,
        per-link matrix), ...]``."""
        out = []
        for a_np in a_stack:
            b = self.update(a_np, t_server, row_bytes=row_bytes,
                            elems_per_row=elems_per_row)
            out.append((b, self.ratio(), self.per_link))
        return out

    def ratio(self) -> float:
        """Cumulative compression ratio: float32 bytes of the same traffic
        over shipped bytes."""
        if self.total_bytes == 0:
            return float("inf") if self.baseline_bytes else 1.0
        return self.baseline_bytes / self.total_bytes
