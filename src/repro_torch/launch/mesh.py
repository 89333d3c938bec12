"""Production meshes and their FL refinement over ranks (port of
``repro.launch.mesh``).

A mesh here is a ``RankMesh``: named axes over the row-major grid of
process ranks (rank ``r`` sits at ``np.unravel_index(r, shape)``), the
counterpart of a ``jax.sharding.Mesh`` over devices.  It builds no process
group until ``group(axis)`` asks for one.

``make_production_mesh`` is the 16x16 single-pod (256 ranks) or 2x16x16
two-pod mesh with axes ("data", "model") / ("pod", "data", "model").

``make_fl_mesh`` refines the replica axes (pod x data) into the paper's
("server", "client", "replica") structure and keeps "model" as the
tensor-parallel axis: M*N*R == pod*data.  The rank order is the production
mesh's: a server's clients are contiguous, and in multi-pod no server
straddles a pod, so all cross-pod traffic is consensus traffic.

Everything here is a function or a plain object: importing this module
touches no ``torch.distributed`` state.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class RankMesh:
    """Named axes over a row-major grid of ``prod(shape)`` ranks.

    ``rank`` is this process's rank in the grid (default: the default
    group's rank, read when first needed); ``dry=True`` makes every group
    a ``consensus.DryGroup`` that records collectives and moves nothing
    (the dry run's stand-in, no ``torch.distributed`` needed).
    ``devices`` is the grid of rank ids (``devices.shape`` is the mesh's
    shape, as a ``jax.sharding.Mesh`` has it)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], *,
                 rank: Optional[int] = None, dry: bool = False):
        if len(axis_names) != len(shape):
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{len(shape)}-d grid")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = np.arange(int(np.prod(shape, dtype=np.int64))
                                 ).reshape(tuple(shape))
        self.dry = dry
        self._rank = rank
        self._groups: Dict[object, object] = {}

    def __repr__(self) -> str:
        return f"RankMesh({self.shape})"

    @property
    def rank(self) -> int:
        if self._rank is None:
            import torch.distributed as dist
            self._rank = dist.get_rank()
        return self._rank

    def size(self, axis: Optional[str] = None) -> int:
        """The length of ``axis``, or the mesh's number of ranks."""
        return int(self.devices.size) if axis is None else self.shape[axis]

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: coordinate}`` of ``rank`` (default: this process)."""
        r = self.rank if rank is None else rank
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            r, self.devices.shape))))

    def ranks_along(self, axis: str, rank: Optional[int] = None
                    ) -> List[int]:
        """The ranks that share every other coordinate with ``rank``, in
        order along ``axis``."""
        c = self.coords(rank)
        ax = self.axis_names.index(axis)
        idx = [c[a] for a in self.axis_names]
        out = []
        for k in range(self.shape[axis]):
            idx[ax] = k
            out.append(int(self.devices[tuple(idx)]))
        return out

    def other_index(self, axis: str, rank: Optional[int] = None
                    ) -> Tuple[int, int]:
        """``(sub, n_other)``: ``rank``'s row-major position over every
        axis but ``axis``, and their number of positions."""
        c = self.coords(rank)
        sub, n_other = 0, 1
        for a in self.axis_names:
            if a != axis:
                sub = sub * self.shape[a] + c[a]
                n_other *= self.shape[a]
        return sub, n_other

    def _lines(self, axis: str) -> List[List[int]]:
        """Every subgroup along ``axis``, in one fixed order."""
        others = [a for a in self.axis_names if a != axis]
        lines = []
        for pos in itertools.product(*(range(self.shape[a])
                                       for a in others)):
            c = dict(zip(others, pos))
            c[axis] = 0
            r0 = int(self.devices[tuple(c[a] for a in self.axis_names)])
            lines.append(self.ranks_along(axis, r0))
        return lines

    def group(self, axis: str):
        """The process group of this rank's ranks along ``axis``, made once.
        Every rank calls ``torch.distributed.new_group`` for every
        subgroup along the axis in the same order (gloo requires it); an
        axis that spans the whole world is its default group."""
        if axis not in self._groups:
            self._groups[axis] = self._make_group(axis)
        return self._groups[axis]

    def world_group(self):
        """The group of every rank of the mesh."""
        if None not in self._groups:
            if self.dry:
                from repro_torch.core.consensus import DryGroup
                self._groups[None] = DryGroup(self.size(), self.rank)
            else:
                import torch.distributed as dist
                self._check_world(dist)
                self._groups[None] = dist.group.WORLD
        return self._groups[None]

    def _check_world(self, dist) -> None:
        if dist.get_world_size() != self.size():
            raise ValueError(f"{self} needs a world of {self.size()} ranks, "
                             f"the default group has "
                             f"{dist.get_world_size()}")

    def _make_group(self, axis: str):
        if self.dry:
            from repro_torch.core.consensus import DryGroup
            return DryGroup(self.shape[axis], self.coords()[axis])
        import torch.distributed as dist
        self._check_world(dist)
        if self.shape[axis] == self.size():
            return dist.group.WORLD
        mine = None
        for ranks in self._lines(axis):
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine


def make_production_mesh(*, multi_pod: bool = False, **kw) -> RankMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankMesh(axes, shape, **kw)


@dataclasses.dataclass(frozen=True)
class FLMeshSpec:
    """How the replica axes factor into the FL structure for one arch.

    M*N*R must equal the product of the production mesh's replica axes
    (pod*data); tp must equal its "model" axis.
    """

    num_servers: int        # M
    clients_per_server: int  # N
    fsdp: int               # R — intra-client weight-shard degree
    tp: int                 # tensor-parallel degree

    @property
    def devices_per_client(self) -> int:
        return self.fsdp * self.tp

    def total_devices(self) -> int:
        return self.num_servers * self.clients_per_server * self.devices_per_client


FL_AXES = ("server", "client", "replica", "model")


def fl_rank_mesh(spec: FLMeshSpec, **kw) -> RankMesh:
    """The (M, N, R, TP) grid of ``spec`` with the FL axis names and no
    production-mesh checks (a mesh of any size, e.g. four ranks on one
    card)."""
    return RankMesh(FL_AXES, (spec.num_servers, spec.clients_per_server,
                              spec.fsdp, spec.tp), **kw)


def make_fl_mesh(spec: FLMeshSpec, *, multi_pod: bool = False,
                 **kw) -> RankMesh:
    """(M, N, R, TP) mesh with axes ("server","client","replica","model").

    Keeps the production mesh's rank order: its leading (pod, data) block
    reshapes to (M, N, R).  M must be a multiple of the pod count in
    multi-pod so each server's block lives inside one pod."""
    prod = make_production_mesh(multi_pod=multi_pod)
    tp = prod.devices.shape[-1]
    replicas = prod.size() // tp
    if spec.tp != tp:
        raise ValueError(f"plan tp={spec.tp} != mesh model axis {tp}")
    if spec.num_servers * spec.clients_per_server * spec.fsdp != replicas:
        raise ValueError(
            f"M*N*R={spec.num_servers}*{spec.clients_per_server}*{spec.fsdp}"
            f" != replica slots {replicas}")
    if multi_pod:
        pods = prod.devices.shape[0]
        if spec.num_servers % pods:
            raise ValueError(
                f"M={spec.num_servers} must be a multiple of pods={pods} so "
                "servers do not straddle pod boundaries")
    return fl_rank_mesh(spec, **kw)


def make_serve_mesh(*, multi_pod: bool = False, **kw) -> RankMesh:
    """Serving mesh: (pod, data) collapsed into one "data" axis — batched
    requests shard over it; weights shard over ("data","model") 2-D."""
    prod = make_production_mesh(multi_pod=multi_pod)
    tp = prod.devices.shape[-1]
    return RankMesh(("data", "model"), (prod.size() // tp, tp), **kw)


def describe(mesh: RankMesh) -> str:
    return f"mesh {mesh.shape} ({mesh.size()} devices)"
