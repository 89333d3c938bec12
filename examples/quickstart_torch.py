"""Quickstart on the PyTorch port: the DFL algorithm on the paper's own
problem, as ``examples/quickstart.py`` runs it on the JAX package.

    PYTHONPATH=src python examples/quickstart_torch.py              # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds the Sec.-IV setup (5 servers x 5 clients, linear regression with
w* = (5, 2)), runs the DFL epoch loop (every gossip round through kernel 1
on the GPU, its plain version on the CPU), and prints how each server's
model converges to w* while the servers agree with each other.
"""
import argparse

import torch

from repro_torch.core import (DFLConfig, FLTopology, build_dfl_epoch_step,
                              init_dfl_state)
from repro_torch.data import RegressionSpec, make_regression_task
from repro_torch.launch.train import resolve_device, set_full_f32
from repro_torch.optim import sgd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--epochs", type=int, default=101)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    set_full_f32()
    topo = FLTopology(num_servers=5, clients_per_server=5,
                      t_client=50, t_server=25, graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(w_star=(5.0, 2.0)),
                                device=dev)
    gamma = 0.4 / (9.0 * topo.t_client)          # < 1/(L T_C)  (Thm. 1)
    optimizer = sgd(gamma)
    cfg = DFLConfig(topology=topo, consensus_mode="gossip")
    step = build_dfl_epoch_step(cfg, task["loss_fn"], optimizer)
    state = init_dfl_state(cfg, torch.zeros(2, device=dev), optimizer)
    w_star = torch.tensor([5.0, 2.0], device=dev)
    print(f"sigma_A = {topo.sigma():.4f}   gamma = {gamma:.2e}   "
          f"device = {dev}")
    for epoch in range(args.epochs):
        state, metrics = step(state, task["batches"])
        if epoch % 20 == 0:
            servers = state.client_params[:, 0]          # (M, 2)
            err = torch.linalg.vector_norm(servers - w_star, dim=-1)
            print(f"epoch {epoch:3d}  "
                  f"loss={float(metrics.loss[-1].mean()):.4f}  "
                  f"max|w_i - w*|={float(err.max()):.4f}  "
                  f"disagreement={float(metrics.server_disagreement):.2e}")
    print("final server models:")
    for i, w in enumerate(state.client_params[:, 0]):
        print(f"  server {i}: w = ({float(w[0]):.4f}, {float(w[1]):.4f})")


if __name__ == "__main__":
    main()
