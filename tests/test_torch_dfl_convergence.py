"""The paper's claims on the PyTorch port: a twin of every case of
``tests/test_dfl_convergence.py`` — Sec. IV, Theorem 1, Lemmas 1 and 3,
the baselines, the beyond-paper consensus modes and a server drop — with
the same setups, the same epochs and the same bounds, run on the port
alone (these are claims about the port).

The regression task is Sec. IV's: M=5 servers x N=5 clients, D=100
points a client, w* = (5, 2), 0.5*MSE (mu-strongly convex and L-smooth
with known constants).  The Lemma diagnostics sit on an f32 rounding
floor (ROADMAP Queue 3); the bounds are the reference's, unloosened.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DFLConfig, FLTopology,  # noqa: E402
                              build_dfl_epoch_step, init_dfl_state)
from repro_torch.data import (RegressionSpec,  # noqa: E402
                              make_regression_data, regression_loss)
from repro_torch.optim import sgd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These runs are many small ops: one intra-op thread, so that parallel
    test workers do not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(m=5, n=5, t_c=50, t_s=25, seed=0, heterogeneity=0.0,
           graph="ring"):
    topo = FLTopology(num_servers=m, clients_per_server=n, t_client=t_c,
                      t_server=t_s, graph_kind=graph)
    data = make_regression_data(topo, RegressionSpec(
        heterogeneity=heterogeneity), seed=seed)
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    # full-batch gradient each local iteration (the paper's Eq. 3 setting)
    batches = (x.expand((t_c,) + tuple(x.shape)),
               y.expand((t_c,) + tuple(y.shape)))
    # optimal w*: global least squares over all 2500 points
    w_star = np.linalg.lstsq(data["x"].reshape(-1, 2),
                             data["y"].reshape(-1), rcond=None)[0]
    # smoothness constants of the per-client quadratic risks
    grams = [data["x"][i, j].T @ data["x"][i, j] / data["x"].shape[2]
             for i in range(m) for j in range(n)]
    lmax = max(float(np.linalg.eigvalsh(g).max()) for g in grams)
    mumin = min(float(np.linalg.eigvalsh(g).min()) for g in grams)
    return topo, regression_loss, batches, w_star, mumin, lmax


def _run(topo, loss_fn, batches, gamma, epochs, mode="gossip"):
    cfg = DFLConfig(topology=topo, consensus_mode=mode)
    opt = sgd(gamma)
    step = build_dfl_epoch_step(cfg, loss_fn, opt)
    state = init_dfl_state(cfg, torch.zeros(2), opt)
    metrics = None
    for _ in range(epochs):
        state, metrics = step(state, batches)
    return state, metrics


def _servers(state) -> np.ndarray:
    return state.client_params[:, 0].numpy()          # (M, 2), post-broadcast


def _max_err(state, w_star) -> float:
    return float(np.linalg.norm(_servers(state) - w_star, axis=-1).max())


def test_paper_sec4_reproduction():
    """5x5, w*=(5,2): servers reach consensus and land near w*."""
    topo, loss_fn, batches, w_star, mu, lsm = _setup(t_c=50, t_s=25)
    gamma = 0.4 / (lsm * topo.t_client)          # < 1/(L T_C) (Thm 1)
    state, _ = _run(topo, loss_fn, batches, gamma, epochs=60)
    servers = _servers(state)
    # (a) consensus: max pairwise distance between server models is tiny
    pair = np.linalg.norm(servers[:, None] - servers[None], axis=-1)
    assert float(pair.max()) < 1e-3
    # (b) accuracy: all servers within the Thm-1 epsilon of w*
    eps = topo.epsilon_bound(gamma, mu, lsm, theta=60.0)
    err = _max_err(state, w_star)
    assert err < max(eps, 0.05), (err, eps)
    # near-perfect fit in absolute terms too
    assert err < 0.2


def test_lemma1_disagreement_bound():
    """||w_p^i - wbar_p|| <= sigma^p ||W_0 - 1 wbar_0|| + sqrt(M) T_C th g s/(1-s)."""
    topo, loss_fn, batches, w_star, mu, lsm = _setup(t_c=20, t_s=5,
                                                     heterogeneity=1.0)
    gamma = 0.4 / (lsm * topo.t_client)
    theta = 80.0  # loose gradient bound for this data
    cfg = DFLConfig(topology=topo)
    opt = sgd(gamma)
    step = build_dfl_epoch_step(cfg, loss_fn, opt)
    state = init_dfl_state(cfg, torch.zeros(2), opt)
    s = topo.sigma()
    bound_tail = np.sqrt(topo.num_servers) * topo.t_client * theta * gamma \
        * s / (1 - s)
    for p in range(1, 8):
        state, _ = step(state, batches)
        servers = _servers(state)
        lhs = float(np.linalg.norm(servers - servers.mean(0), axis=-1).max())
        # W_0 identical across servers => sigma^p term vanishes
        assert lhs <= bound_tail + 1e-6, (p, lhs, bound_tail)


def test_lemma3_client_drift_bound():
    """||w_s^{ij} - w_p^i|| <= gamma T_C theta within every epoch."""
    topo, loss_fn, batches, *_, lsm = _setup(t_c=30, t_s=10)
    gamma = 0.2 / (lsm * topo.t_client)
    cfg = DFLConfig(topology=topo)
    opt = sgd(gamma)
    step = build_dfl_epoch_step(cfg, loss_fn, opt)
    state = init_dfl_state(cfg, torch.zeros(2), opt)
    theta = 80.0
    for _ in range(5):
        state, metrics = step(state, batches)
        assert float(metrics.client_drift) <= gamma * topo.t_client * theta


def test_fedavg_baseline_beats_dfl_slightly():
    """exact_mean (the hierarchical/FedAvg idealisation, sigma=0) ends at
    least as close to w* as ring-gossip DFL: Thm 1's epsilon is monotone
    in sigma_A."""
    topo, loss_fn, batches, w_star, mu, lsm = _setup(t_c=25, t_s=2,
                                                     heterogeneity=1.5)
    gamma = 0.3 / (lsm * topo.t_client)
    s_dfl, _ = _run(topo, loss_fn, batches, gamma, 40, mode="gossip")
    s_fed, _ = _run(topo, loss_fn, batches, gamma, 40, mode="exact_mean")
    assert _max_err(s_fed, w_star) <= _max_err(s_dfl, w_star) + 1e-3


def test_local_only_ablation_disagrees():
    """No consensus + heterogeneous clients -> servers drift apart."""
    topo, loss_fn, batches, *_, lsm = _setup(t_c=25, t_s=2,
                                             heterogeneity=2.0)
    gamma = 0.3 / (lsm * topo.t_client)
    _, m_loc = _run(topo, loss_fn, batches, gamma, 40, mode="none")
    _, m_dfl = _run(topo, loss_fn, batches, gamma, 40, mode="gossip")
    assert float(m_loc.server_disagreement) > 10 * float(
        m_dfl.server_disagreement)


@pytest.mark.parametrize("mode", ["collapsed", "chebyshev"])
def test_beyond_paper_consensus_modes_converge(mode):
    topo, loss_fn, batches, w_star, mu, lsm = _setup(t_c=25, t_s=25)
    gamma = 0.4 / (lsm * topo.t_client)
    state, metrics = _run(topo, loss_fn, batches, gamma, 150, mode=mode)
    err = _max_err(state, w_star)
    assert err < 0.2, err
    assert float(metrics.server_disagreement) < 1e-2


def test_collapsed_bitwise_matches_gossip():
    """collapsed is the same operator as T_S gossip rounds (within fp32)."""
    topo, loss_fn, batches, *_ = _setup(t_c=10, t_s=8)
    g = 1e-4
    s1, _ = _run(topo, loss_fn, batches, g, 3, mode="gossip")
    s2, _ = _run(topo, loss_fn, batches, g, 3, mode="collapsed")
    np.testing.assert_allclose(s1.client_params.numpy(),
                               s2.client_params.numpy(),
                               rtol=5e-5, atol=5e-6)


def test_fault_tolerance_drop_server():
    """Graph surgery mid-training: drop a server, keep converging."""
    topo, loss_fn, batches, w_star, mu, lsm = _setup(m=5, t_c=20, t_s=10)
    gamma = 0.3 / (lsm * topo.t_client)
    state, _ = _run(topo, loss_fn, batches, gamma, 10)
    new_topo, keep = topo.drop_server(2)
    keep_t = torch.as_tensor(np.asarray(keep))
    # re-shard: drop the failed server's row everywhere
    new_params = state.client_params[keep_t]
    cfg2 = DFLConfig(topology=new_topo)
    opt = sgd(gamma)
    step2 = build_dfl_epoch_step(cfg2, loss_fn, opt)
    state2 = init_dfl_state(cfg2, torch.zeros(2), opt)
    state2 = state2._replace(client_params=new_params)
    nb = tuple(b[:, keep_t] for b in batches)
    for _ in range(80):
        state2, m2 = step2(state2, nb)
    # the survivors' optimum (dropping a server drops its clients' data)
    xs = nb[0][0].numpy().reshape(-1, 2)
    ys = nb[1][0].numpy().reshape(-1)
    w_star2 = np.linalg.lstsq(xs, ys, rcond=None)[0]
    err = _max_err(state2, w_star2)
    assert err < 0.25, err
    assert float(m2.server_disagreement) < 1e-2
