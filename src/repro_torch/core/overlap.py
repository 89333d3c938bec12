"""The superepoch: K epochs of Algorithm 1 in one dispatch (port of
``repro.core.overlap``).

The barrier engine (``engine.DynamicFederationEngine.run_epoch``) reads each
epoch's metrics back before it plans the next.  ``build_dfl_superepoch_step``
runs K epochs of the UNCHANGED dynamic epoch step back to back on the
device, with the schedules of the whole block planned on the host first
(``EpochScheduleBatch``, built by ``stack_epoch_schedules``), and returns
the K epochs' metrics stacked on the device, so the engine reads them back
once a block.  The body is the per-epoch step itself, so a run at any K is
bitwise the per-epoch loop (``tests/test_torch_overlap.py``).

The reference fuses the K epochs into one compiled ``lax.scan``; PyTorch
runs eagerly, so here the block is a Python loop over the same step, and
what the superepoch saves is the metrics' read-back and the planning
between epochs (the dynamic step still reads its participation mask to
the host at the start of each epoch).  Bounded staleness
(``DFLConfig.staleness``) lives inside the consensus period and composes
with it unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dfl
from repro_torch.core.schedule import EpochSchedule
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_map


class EpochScheduleBatch(NamedTuple):
    """K stacked ``schedule.EpochSchedule`` operands: field for field the
    per-epoch tuple with a leading K axis; ``lam2``/``byz`` are ``None``
    exactly when the per-epoch schedules carry ``None``.

    ``mask``:   (K, M, N) float32 participation masks.
    ``mixing``: (K, M, M) float32 mixing matrices A_p.
    ``lam2``:   optional (K,) float32 per-epoch spectral estimates.
    ``byz``:    optional (K, M) int32 attack codes.
    """

    mask: Any
    mixing: Any
    lam2: Optional[Any] = None
    byz: Optional[Any] = None

    @property
    def k(self) -> int:
        return int(self.mask.shape[0])


def stack_epoch_schedules(
        scheds: Sequence[EpochSchedule]) -> EpochScheduleBatch:
    """Stack K host-side (numpy) ``EpochSchedule`` tuples into one
    ``EpochScheduleBatch``.  Optional fields must be all ``None`` or all
    present across the block, as the reference requires."""
    if not scheds:
        raise ValueError("cannot stack an empty schedule block")
    for field in ("lam2", "byz"):
        vals = [getattr(s, field) for s in scheds]
        if any(v is None for v in vals) and not all(v is None for v in vals):
            raise ValueError(
                f"EpochSchedule.{field} is set for some epochs of the block "
                f"but not others — one superepoch step needs a uniform "
                f"operand structure")
    return EpochScheduleBatch(
        mask=np.stack([np.asarray(s.mask, np.float32) for s in scheds]),
        mixing=np.stack([np.asarray(s.mixing, np.float32) for s in scheds]),
        lam2=(None if scheds[0].lam2 is None else
              np.stack([np.asarray(s.lam2, np.float32) for s in scheds])),
        byz=(None if scheds[0].byz is None else
             np.stack([np.asarray(s.byz, np.int32) for s in scheds])))


def build_dfl_superepoch_step(
    cfg: dfl.DFLConfig,
    loss_fn: dfl.LossFn,
    optimizer: Optimizer,
    k: int,
) -> Callable[[dfl.DFLState, Any, EpochScheduleBatch],
              Tuple[dfl.DFLState, dfl.DFLMetrics,
                    Optional[torch.Tensor]]]:
    """Return ``superepoch_step(state, batches, sched_batch) -> (state,
    stacked_metrics, psum_weights)``: K epochs of the dynamic epoch step in
    one call.

    ``batches`` leaves are ``(K, T_C, M, N, *per_client_batch)``;
    ``sched_batch`` is the matching ``EpochScheduleBatch`` of tensors on the
    state's device.  ``stacked_metrics`` is ``dfl.DFLMetrics`` with a
    leading K axis on every leaf, left on the device; ``psum_weights`` is
    the ``(K, M)`` per-epoch terminal push-sum weight under
    ``mixing='push_sum'`` (the state keeps only the last), else ``None``."""
    if k < 1:
        raise ValueError(f"superepoch length must be >= 1, got {k}")
    if not cfg.dynamic:
        raise ValueError("build_dfl_superepoch_step needs "
                         "DFLConfig(dynamic=True) — its body consumes "
                         "per-epoch EpochSchedule operands")
    epoch_step = dfl.build_dfl_epoch_step(cfg, loss_fn, optimizer)

    def superepoch_step(state: dfl.DFLState, batches: Any,
                        sched_batch: EpochScheduleBatch):
        per_epoch, weights = [], []
        for i in range(k):
            sched = EpochSchedule(
                sched_batch.mask[i], sched_batch.mixing[i],
                None if sched_batch.lam2 is None else sched_batch.lam2[i],
                None if sched_batch.byz is None else sched_batch.byz[i])
            state, metrics = epoch_step(
                state, tree_map(lambda x, i=i: x[i], batches), sched)
            per_epoch.append(metrics)
            weights.append(state.psum_weight)
        stacked = dfl.DFLMetrics(*(None if xs[0] is None else torch.stack(xs)
                                   for xs in zip(*per_epoch)))
        psw = None if weights[0] is None else torch.stack(weights)
        return state, stacked, psw

    return superepoch_step
