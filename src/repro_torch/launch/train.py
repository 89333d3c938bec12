"""DFL trainer on PyTorch: port of the static ``repro.launch.train.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --full --servers 4 --clients 2 --t-client 2 --t-server 5 --epochs 2

Runs Algorithm 1 end to end on the card (``--device cpu`` runs it on the
CPU, with the kernels' plain versions): T_C local SGD steps per client on
per-client synthetic LM shards, per-server aggregation, T_S gossip rounds
(kernel 1), broadcast — printing the reference trainer's epoch record
(loss, disagreement, drift, participation, num_servers, sigma_prod) every
epoch.  float32 matmuls run in full float32: TF32 is switched off.

``--compression int8|int4[:C]|top_k:R|random_k:R [--error-feedback]``
compresses the gossip messages and adds the reference's wire ledger to the
record: ``wire_mb`` (on-wire megabytes of the epoch) and ``wire_ratio``
(cumulative float32 bytes over shipped bytes).  The default ``--wire
simulated`` compresses each server's message once a period (a quantizer's
round trip and first mix on kernel 4) and counts its unpadded payload;
``--wire physical`` (int8/int4) ships delta codes every round (kernels
5-8) and counts the per-leaf layout, as the reference's static trainer
does.  ``--staleness s`` (physical wire only) lets gossip round t mix the
neighbours' codes of round t - s (kernel 8).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import accounting, prng
from repro_torch.comm.compressors import (tree_message_elems,
                                          tree_wire_bytes_per_server)
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core import (DFLConfig, FLTopology, SigmaTracker,
                              build_dfl_epoch_step, init_dfl_state)
from repro_torch.core.dfl import active_compressor, active_wire
from repro_torch.data import DataConfig, FLDataPipeline
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves

_ORDER = ("loss", "disagreement", "drift", "sigma_prod", "num_servers",
          "wire_mb", "wire_ratio")
_FMT = {"loss": ".4f", "disagreement": ".3e", "drift": ".3e",
        "sigma_prod": ".3f", "num_servers": ".0f", "wire_mb": ".1f",
        "wire_ratio": ".2f"}


def resolve_device(device: str) -> torch.device:
    """The run's device: CUDA unless the caller asks for the CPU.  Asking
    for CUDA on a host without it raises — nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            f"device='cpu' to run the plain versions on the CPU")
    return dev


def set_full_f32() -> None:
    """float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def format_record(epoch: int, rec: dict) -> str:
    parts = [f"epoch {epoch:4d}"]
    parts += [f"{k}={rec[k]:{_FMT[k]}}" for k in _ORDER if k in rec]
    parts.append(f"({rec['epoch_s']:.2f}s)")
    return "  ".join(parts)


def train(arch_id: str, *, smoke: bool = True, servers: int = 2,
          clients: int = 2, t_client: int = 4, t_server: int = 5,
          epochs: int = 3, seq_len: int = 128, per_client_batch: int = 2,
          gamma: float = 0.05, graph: str = "ring",
          consensus_mode: str = "gossip", mixing: str = "symmetric",
          compression: str = "none", error_feedback: bool = False,
          wire: str = "simulated", staleness: int = 0, seed: int = 0,
          device: str = "cuda",
          params: Optional[dict] = None, log: bool = True) -> dict:
    """Static Algorithm 1 on an LM.  ``params`` (optional) replaces the
    seeded random init, e.g. weights carried over by
    ``transformer.params_from_numpy``.  ``compression`` / ``error_feedback``
    / ``wire`` select the compressed wire, ``staleness`` the physical
    wire's bounded-staleness rounds.  Returns the final
    state, the per-epoch history (metric name -> list) and the run's
    objects."""
    dev = resolve_device(device)
    set_full_f32()
    cfg = get_smoke(arch_id) if smoke else get_arch(arch_id)
    topo = FLTopology(num_servers=servers, clients_per_server=clients,
                      t_client=t_client, t_server=t_server, graph_kind=graph,
                      mixing="out_degree" if mixing != "symmetric"
                      else "metropolis")
    loss_fn = tf.make_loss_fn(cfg)
    optimizer = sgd(gamma)
    pipe = FLDataPipeline(topo, DataConfig(seq_len=seq_len,
                                           per_client_batch=per_client_batch,
                                           vocab_size=cfg.vocab_size,
                                           seed=seed), arch=cfg, device=dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = tf.init_params(gen, cfg, device=dev)
    dfl_cfg = DFLConfig(topology=topo, consensus_mode=consensus_mode,
                        mixing=mixing, compression=compression,
                        error_feedback=error_feedback, wire=wire,
                        staleness=staleness)
    step = build_dfl_epoch_step(dfl_cfg, loss_fn, optimizer)
    ledger = _make_wire_ledger(dfl_cfg, params)
    # the wire key is the reference trainer's rng, jax.random.key(seed + 1)
    state = init_dfl_state(dfl_cfg, params, optimizer,
                           torch.Generator(device=dev).manual_seed(seed + 1),
                           wire_key=prng.key(seed + 1))
    del params
    sigma = SigmaTracker(topo.num_servers, staleness=staleness)
    a_np = (topo.mixing_matrix() if topo.num_servers > 1
            else np.ones((1, 1)))
    history: dict = {}
    for epoch in range(epochs):
        t0 = time.perf_counter()
        state, metrics = step(state, pipe.epoch_batches(epoch))
        # the metrics are host tensors: reading them waited for the device
        rec = {
            "loss": float(metrics.loss[-1].mean()),
            "disagreement": float(metrics.server_disagreement),
            "drift": float(metrics.client_drift),
            "participation": 1.0,
            "num_servers": float(topo.num_servers),
            "sigma_prod": sigma.update(a_np, topo.t_server),
            "epoch_s": time.perf_counter() - t0,
        }
        if ledger is not None:
            rec["wire_mb"] = ledger.update() / 1e6
            rec["wire_ratio"] = ledger.tracker.ratio()
        for k, v in rec.items():
            history.setdefault(k, []).append(v)
        if log:
            print(format_record(epoch, rec))
    return {"state": state, "history": history, "topology": topo,
            "cfg": cfg}


class _StaticWireLedger:
    """The static trainer's wire ledger: a ``comm.accounting.BytesTracker``
    bound to the fixed topology and model shapes.  As the reference's
    static trainer does, the simulated wire counts the unpadded payload of
    one message (``tree_wire_bytes_per_server``) and the physical wire the
    PER-LEAF layout (``tree_physical_wire_bytes_per_server``), even though
    its rounds ship the bucketed one."""

    def __init__(self, dfl_cfg: DFLConfig, params, compressor):
        topo = dfl_cfg.topology
        server_abs = [torch.empty((topo.num_servers,) + tuple(p.shape),
                                  device="meta")
                      for p in tree_leaves(params)]
        wire, wire_block = active_wire(dfl_cfg)
        if wire == "physical":
            self._row = accounting.tree_physical_wire_bytes_per_server(
                compressor, server_abs, wire_block)
        else:
            self._row = tree_wire_bytes_per_server(compressor, server_abs)
        self._elems = tree_message_elems(server_abs)
        self._a = (topo.mixing_matrix() if topo.num_servers > 1
                   else np.ones((1, 1)))
        self._t_s = topo.t_server
        self.tracker = accounting.BytesTracker(
            compressor, push_sum=dfl_cfg.mixing == "push_sum")

    def update(self) -> float:
        return self.tracker.update(self._a, self._t_s, row_bytes=self._row,
                                   elems_per_row=self._elems)


def _make_wire_ledger(dfl_cfg: DFLConfig,
                      params) -> Optional[_StaticWireLedger]:
    compressor = active_compressor(dfl_cfg)
    if compressor is None:
        return None
    return _StaticWireLedger(dfl_cfg, params, compressor)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--full", dest="smoke", action="store_false",
                   help="the published-size config")
    p.add_argument("--servers", type=int, default=2)
    p.add_argument("--clients", type=int, default=2)
    p.add_argument("--t-client", type=int, default=4)
    p.add_argument("--t-server", type=int, default=5)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--gamma", type=float, default=0.05)
    p.add_argument("--graph", default="ring",
                   choices=("ring", "complete", "star", "line"))
    p.add_argument("--consensus-mode", default="gossip",
                   choices=("gossip", "gossip_blocked", "collapsed",
                            "exact_mean", "none"))
    p.add_argument("--compression", default="none",
                   help="none | int8[:chunk] | int4[:chunk] | top_k:ratio | "
                        "random_k:ratio: compress the gossip messages")
    p.add_argument("--error-feedback", action="store_true",
                   help="carry each server's compression residual into the "
                        "next period's message")
    p.add_argument("--wire", default="simulated",
                   choices=("simulated", "physical"),
                   help="where --compression happens: 'simulated' "
                        "compresses once per period, 'physical' ships the "
                        "codes every round")
    p.add_argument("--staleness", type=int, default=0,
                   help="bounded gossip staleness s: round t mixes the "
                        "neighbours' codes of round t-s (--wire physical "
                        "only); 0 = the synchronous path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    train(args.arch, smoke=args.smoke, servers=args.servers,
          clients=args.clients, t_client=args.t_client,
          t_server=args.t_server, epochs=args.epochs, seq_len=args.seq_len,
          per_client_batch=args.batch, gamma=args.gamma, graph=args.graph,
          consensus_mode=args.consensus_mode, compression=args.compression,
          error_feedback=args.error_feedback, wire=args.wire,
          staleness=args.staleness, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
