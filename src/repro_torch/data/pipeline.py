"""Data pipeline for DFL training (port of ``repro.data.pipeline``).

Every batch is indexed by (server, client) and stacked as
``(T_C, M, N, per_client_batch, ...)`` — one microbatch per client per local
iteration — which is what ``repro_torch.core.dfl.build_dfl_epoch_step``
consumes.

* ``make_regression_data`` is numpy and returns the reference's arrays
  exactly; ``make_regression_task`` wraps them with a torch loss.
* ``FLDataPipeline`` draws tokens from a seeded ``numpy.random.Generator``
  under the reference's zipf + bigram law.  The reference draws from
  ``jax.random``, whose stream numpy cannot reproduce, so parity tests hand
  both sides the same tokens instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.topology import FLTopology


# ---------------------------------------------------------------------------
# the paper's Sec.-IV regression task
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegressionSpec:
    w_star: Tuple[float, ...] = (5.0, 2.0)   # paper: w* = (5, 2) (slope, intercept)
    points_per_client: int = 100             # paper: D = 100
    noise_std: float = 0.5
    x_range: Tuple[float, float] = (-5.0, 5.0)
    heterogeneity: float = 0.0               # per-client covariate shift
    # per-SERVER concept shift: server i's data comes from w_star + delta_i
    concept_shift: float = 0.0


def make_regression_data(topo: FLTopology, spec: RegressionSpec,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """Returns {'x': (M, N, D, d), 'y': (M, N, D), 'w_server': (M, d)} with
    d = len(w_star); the last feature is the constant 1 (intercept)."""
    rng = np.random.default_rng(seed)
    m, n, d_pts = topo.num_servers, topo.clients_per_server, spec.points_per_client
    d = len(spec.w_star)
    lo, hi = spec.x_range
    xs = rng.uniform(lo, hi, size=(m, n, d_pts, d - 1))
    if spec.heterogeneity:
        shift = rng.normal(scale=spec.heterogeneity, size=(m, n, 1, d - 1))
        xs = xs + shift
    feats = np.concatenate([xs, np.ones((m, n, d_pts, 1))], axis=-1)
    w = np.broadcast_to(np.asarray(spec.w_star), (m, d)).copy()
    if spec.concept_shift:
        w = w + rng.normal(scale=spec.concept_shift, size=(m, d))
    y = (np.einsum("mncd,md->mnc", feats, w)
         + rng.normal(scale=spec.noise_std, size=(m, n, d_pts)))
    return {"x": feats.astype(np.float32), "y": y.astype(np.float32),
            "w_server": w}


def regression_loss(w: torch.Tensor, batch, rng=None):
    """0.5 * MSE of the linear model ``w`` on ``batch = (x, y)``."""
    del rng
    xx, yy = batch
    return 0.5 * torch.mean((xx @ w - yy) ** 2), {}


def make_regression_task(topo: FLTopology,
                         spec: Optional[RegressionSpec] = None,
                         seed: int = 0, device="cpu") -> Dict[str, object]:
    """The Sec.-IV harness: the 0.5*MSE loss, full-batch per-iteration
    batches of shape ``(T_C, M, N, D, d)`` on ``device``, the global
    least-squares ``w_star``, and a ``batch_fn(epoch, alive_server_ids)``
    for the dynamic-federation engine (rows by ORIGINAL server identity)."""
    spec = spec or RegressionSpec()
    data = make_regression_data(topo, spec, seed=seed)
    x = torch.as_tensor(data["x"], device=device)
    y = torch.as_tensor(data["y"], device=device)
    bx = x.expand((topo.t_client,) + tuple(x.shape))
    by = y.expand((topo.t_client,) + tuple(y.shape))
    w_star = np.linalg.lstsq(data["x"].reshape(-1, data["x"].shape[-1]),
                             data["y"].reshape(-1), rcond=None)[0]

    def batch_fn(epoch, alive):
        ids = _server_ids(alive, topo.num_servers)
        return bx[:, ids], by[:, ids]

    return {"loss_fn": regression_loss, "batches": (bx, by),
            "batch_fn": batch_fn, "w_star": w_star, "x": x, "y": y}


def _server_ids(alive, m: int) -> torch.Tensor:
    """ORIGINAL server ids as an index tensor, checked against the original
    federation size: an out-of-range id would otherwise alias another
    server's shard or fail mid-run."""
    ids = np.asarray(alive, dtype=np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= m):
        raise ValueError(f"server ids {tuple(alive)} out of range for M={m}")
    return torch.as_tensor(ids)


def perron_ideal(x, y, pi: np.ndarray) -> np.ndarray:
    """Minimiser of the pi-weighted server objective ``sum_i pi_i f_i(w)``:
    the biased target of naive row-stochastic gossip on this task."""
    x, y = np.asarray(x), np.asarray(y)
    d = x.shape[-1]
    gram, moment = np.zeros((d, d)), np.zeros(d)
    for i in range(x.shape[0]):
        xi, yi = x[i].reshape(-1, d), y[i].reshape(-1)
        gram += pi[i] * xi.T @ xi / len(yi)
        moment += pi[i] * xi.T @ yi / len(yi)
    return np.linalg.solve(gram, moment)


# ---------------------------------------------------------------------------
# synthetic LM token streams
# ---------------------------------------------------------------------------


def synthetic_lm_tokens(rng: np.random.Generator, vocab: int,
                        shape: Tuple[int, ...],
                        alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids with a learnable bigram: with p=0.5 a
    token is ``(prev * 7 + 3) % vocab`` (the reference's law)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs = probs / probs.sum()
    base = rng.choice(vocab, size=shape, p=probs)
    mix = rng.random(shape) < 0.5
    rolled = (np.roll(base, 1, axis=-1) * 7 + 3) % vocab
    return np.where(mix, rolled, base).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    per_client_batch: int
    vocab_size: int
    seed: int = 0


class FLDataPipeline:
    """Per-epoch stacked LM batches for DFL: ``{"tokens": (T_C, M, N, b, s)}``
    int64 on ``device``, drawn from ``numpy.random.default_rng([seed,
    epoch])`` so each epoch is reproducible on its own.  An arch with a
    frontend adds its precomputed embeddings, as the reference does:
    ``patch_embeds`` (..., num_tokens, embed_dim) for a vision frontend,
    whose text tokens shrink to ``seq_len - num_tokens`` so the sequence
    stays ``seq_len``, or ``frames`` (..., num_tokens, embed_dim) for an
    audio one; standard normal f32 from ``default_rng([seed, epoch, 1])``."""

    def __init__(self, topo: FLTopology, cfg: DataConfig,
                 arch: Optional[ArchConfig] = None, device="cpu"):
        self.arch = arch
        self.topo = topo
        self.cfg = cfg
        self.device = torch.device(device)
        self._epoch = 0

    def epoch_batches(self, epoch: Optional[int] = None,
                      server_ids: Optional[Tuple[int, ...]] = None
                      ) -> Dict[str, torch.Tensor]:
        """``{"tokens": (T_C, M, N, b, s)}``.  ``server_ids`` (ORIGINAL
        server indices) keeps only those servers' shards, in that order:
        after fault surgery only the alive servers train, and a server that
        rejoins gets its own clients' streams back."""
        e = self._epoch if epoch is None else epoch
        topo, cfg = self.topo, self.cfg
        shape = (topo.t_client, topo.num_servers, topo.clients_per_server,
                 cfg.per_client_batch, cfg.seq_len)
        rng = np.random.default_rng([cfg.seed, e])
        batch = {"tokens": synthetic_lm_tokens(rng, cfg.vocab_size, shape)}
        fe = None if self.arch is None else self.arch.frontend
        if fe is not None:
            name = ("patch_embeds" if fe.kind == "vision_patches"
                    else "frames")
            batch[name] = np.random.default_rng([cfg.seed, e, 1]) \
                .standard_normal(shape[:-1] + (fe.num_tokens, fe.embed_dim),
                                 dtype=np.float32)
            if fe.kind == "vision_patches":
                batch["tokens"] = batch["tokens"][
                    ..., :cfg.seq_len - fe.num_tokens]
        if server_ids is not None:
            ids = _server_ids(server_ids, topo.num_servers).numpy()
            batch = {k: v[:, ids] for k, v in batch.items()}
        self._epoch = e + 1
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}
