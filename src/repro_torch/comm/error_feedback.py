"""Error feedback (EF) for compressed gossip: port of
``repro.comm.error_feedback``.

Each server keeps its compression residual and folds it into the next
period's message::

    msg_i = C(x_i + e_i)                    (crosses the wire)
    e_i'  = (x_i + e_i) - D(msg_i)          (stays local)

On the simulated wire the transmission is the period's one message
(``ef_roundtrip``); on the physical wire it is round 0 of the period
(``core.consensus.CompressedBackend``).  The residual tree (leaves
``(M, *w)``) rides across epochs in ``core.dfl.DFLState.ef_residual``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.comm.compressors import Compressor, roundtrip_tree
from repro_torch.tree import tree_map


def init_ef_residual(server_tree: Any) -> Any:
    """Zero residual, shaped like the server aggregates (leaves (M, *w))."""
    return tree_map(torch.zeros_like, server_tree)



def ef_roundtrip(compressor: Compressor, tree: Any, residual: Any,
                 key=None) -> Tuple[Any, Any]:
    """One error-compensated transmission of a server tree: ``(decompressed
    message tree, new residual)``.  ``corrected = x + e`` leaf by leaf, the
    message is ``roundtrip_tree(corrected)``, and the new residual is
    ``corrected - message`` as the reference's jitted program rounds it
    (``Compressor.residual``).  On a bf16 leaf that program encodes the sum
    ``x + e`` before it is rounded to bf16 (XLA keeps the fused add in f32)
    and rounds the message to bf16; the residual subtracts the rounded
    message from the rounded sum.  The port does the same."""
    corrected = tree_map(lambda x, e: x + e, tree, residual)
    sent = tree_map(lambda x, e, c: c if c.dtype == torch.float32
                    else x.float() + e.float(), tree, residual, corrected)
    msg = tree_map(lambda q, c: q.to(c.dtype),
                   roundtrip_tree(compressor, sent, key), corrected)
    return msg, tree_map(compressor.residual, corrected, msg)
