"""Optimizers over tensor pytrees (port of ``repro.optim.optimizers``).

Every rule is elementwise over leaves, so a leaf of shape ``(M, N, *w)``
with matching state behaves as M*N independent optimizers — and, equally,
``update`` may be called on one client's slice at a time (the port's local
period does that, see ``repro_torch.core.dfl``).  ``update`` is functional:
it returns new tensors and never writes into ``params``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                    # params -> state
    update: Callable[[Any, Any, Any], tuple]      # (grads, state, params) -> (new_params, new_state)


def _lr_at(lr: ScalarOrSchedule, count: torch.Tensor):
    return lr(count) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=count.device)


def _count0(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


class SGDState(NamedTuple):
    count: torch.Tensor


def sgd(lr: ScalarOrSchedule) -> Optimizer:
    """Eq. (3): w <- w - gamma * grad."""

    def init(params):
        return SGDState(_count0(params))

    def update(grads, state, params):
        g = _lr_at(lr, state.count)
        # in the PARAM dtype, as the reference does
        new = tree_map(lambda p, dg: p - g.to(p.dtype) * dg.to(p.dtype),
                       params, grads)
        return new, SGDState(state.count + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    count: torch.Tensor
    velocity: Any


def momentum(lr: ScalarOrSchedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(_count0(params), tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(grads, state, params):
        g = _lr_at(lr, state.count)
        vel = tree_map(lambda v, dg: beta * v + dg.float(), state.velocity,
                       grads)
        step = (tree_map(lambda v, dg: beta * v + dg.float(), vel, grads)
                if nesterov else vel)
        new = tree_map(lambda p, s: (p - g * s).to(p.dtype), params, step)
        return new, MomentumState(state.count + 1, vel)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamState(_count0(params), tree_map(z, params),
                         tree_map(z, params))

    def update(grads, state, params):
        count = state.count + 1
        g = _lr_at(lr, state.count)
        mu = tree_map(lambda m, dg: b1 * m + (1 - b1) * dg.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, dg: b2 * v + (1 - b2) * torch.square(
            dg.float()), state.nu, grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def leaf(p, m, v):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (p - g * step).to(p.dtype)

        return tree_map(leaf, params, mu, nu), AdamState(count, mu, nu)

    return Optimizer(init, update)
