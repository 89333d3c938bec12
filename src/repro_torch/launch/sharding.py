"""Process-group-aware consensus construction: port of
``repro.launch.sharding.fl_consensus_backend`` (the rest of the reference's
module, the mesh shardings and deployment plans, is not ported).

One process is one server: a ``torch.distributed`` group of M ranks stands
for the reference's ``('server',)`` mesh, rank r for device r.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.core import consensus as cns
from repro_torch.tree import tree_leaves


def fl_consensus_backend(topo: Any, group, server_tree: Any, *,
                         block: Optional[int] = None,
                         compression: str = "none",
                         error_feedback: bool = False,
                         wire: str = "simulated",
                         staleness: int = 0) -> Any:
    """A ``consensus.ShardMapBackend`` gossiping ``server_tree``-shaped
    aggregates (leaves ``(M, *w)``; only their shapes are read) over
    ``group``, one rank a server, seeded with the topology's static mixing
    matrix (a per-epoch ``A_p`` still overrides it).  A ``compression``
    other than ``"none"`` wraps it in a ``consensus.CompressedBackend``;
    ``wire="physical"`` makes every round gather the int8 / packed-int4
    codes of the rank's whole tree as one bucket (one int8 and one f32
    ``all_gather`` a round).  ``staleness=s > 0`` pipelines the wire rounds
    and needs ``wire="physical"`` with a quantizer (the backends raise
    otherwise).  Inject the result through ``DFLConfig.consensus_backend``;
    the epoch step then runs rank-locally."""
    m = topo.num_servers
    lead = {int(leaf.shape[0]) for leaf in tree_leaves(server_tree)}
    if lead != {m}:
        raise ValueError(f"server_tree leaves must lead with M={m} servers, "
                         f"got leading sizes {sorted(lead)}")
    a_np = topo.mixing_matrix() if m > 1 else np.ones((1, 1))
    kw = {} if block is None else {"block": block}
    backend = cns.ShardMapBackend(group, a_np, topo.t_server,
                                  staleness=staleness, **kw)
    if compression != "none":
        from repro_torch.comm.compressors import make_compressor
        backend = cns.CompressedBackend(
            backend, make_compressor(compression),
            error_feedback=error_feedback, wire=wire)
    return backend
