"""Port parity: ``repro_torch.core.dfl`` against ``repro.core.dfl`` on the
paper's Sec.-IV regression (the quickstart: M = N = 5 ring, T_C = 50,
T_S = 25), same numpy data on both sides.

Tolerances: per-epoch parameters and losses rtol 1e-5 (f32 SGD and gossip,
summed in another order; the dynamics contract, so the two stay close).
The Lemma-1/Lemma-3 diagnostics use a sum-of-squares formula whose f32
rounding floor is about sqrt(eps_f32 * sum ||w||^2); they are compared with
an absolute tolerance of 8x that floor (``_floor``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dfl as jdfl  # noqa: E402
from repro.core.topology import FLTopology as JTopology  # noqa: E402
from repro.data import RegressionSpec as JSpec  # noqa: E402
from repro.data import make_regression_data as j_make_data  # noqa: E402
from repro.data import perron_ideal as j_perron_ideal  # noqa: E402
from repro.optim import momentum as j_momentum  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.core.topology import perron_weights as topo_perron  # noqa: E402
from repro_torch.data import (RegressionSpec, make_regression_data,  # noqa: E402
                              make_regression_task, perron_ideal)
from repro_torch.optim import momentum, sgd  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _floor(w: np.ndarray) -> float:
    return 8.0 * np.sqrt(EPS32 * float(np.sum(np.square(w))))


def _j_loss(w, batch, rng):
    xx, yy = batch
    return 0.5 * jnp.mean((xx @ w - yy) ** 2), {}


def _setup(m=5, n=5, t_c=50, t_s=25, graph="ring", weights="metropolis"):
    kw = dict(num_servers=m, clients_per_server=n, t_client=t_c,
              t_server=t_s, graph_kind=graph, mixing=weights)
    return FLTopology(**kw), JTopology(**kw)


def _run_both(topo, jtopo, mode="gossip", epochs=3, opt="sgd",
              micro=1, metrics="full", mixing="symmetric", baseline=None):
    """Run both packages side by side; ``baseline`` ("fedavg" or
    "local_only") builds the step with ``build_<baseline>_epoch_step``."""
    task = make_regression_task(topo)
    gamma = 0.4 / (9.0 * topo.t_client)
    t_opt, j_opt = ((sgd(gamma), j_sgd(gamma)) if opt == "sgd"
                    else (momentum(gamma), j_momentum(gamma)))
    jx, jy = jnp.asarray(task["x"].numpy()), jnp.asarray(task["y"].numpy())
    jb = (jnp.broadcast_to(jx, (topo.t_client,) + jx.shape),
          jnp.broadcast_to(jy, (topo.t_client,) + jy.shape))
    jcfg = jdfl.DFLConfig(topology=jtopo, consensus_mode=mode, mixing=mixing,
                          grad_microbatches=micro, metrics=metrics)
    tcfg = tdfl.DFLConfig(topology=topo, consensus_mode=mode, mixing=mixing,
                          grad_microbatches=micro, metrics=metrics)
    if baseline is None:
        jstep = jax.jit(jdfl.build_dfl_epoch_step(jcfg, _j_loss, j_opt))
        tstep = tdfl.build_dfl_epoch_step(tcfg, task["loss_fn"], t_opt)
    else:
        build = f"build_{baseline}_epoch_step"
        jstep = jax.jit(getattr(jdfl, build)(jtopo, _j_loss, j_opt))
        tstep = getattr(tdfl, build)(topo, task["loss_fn"], t_opt)
    jstate = jdfl.init_dfl_state(jcfg, jnp.zeros((2,)), j_opt,
                                 jax.random.key(0))
    tstate = tdfl.init_dfl_state(tcfg, torch.zeros(2), t_opt)
    out = []
    for _ in range(epochs):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, task["batches"])
        out.append((np.asarray(jstate.client_params), jm,
                    tstate.client_params.numpy().copy(), tm))
    return out


def test_regression_data_identical():
    topo, jtopo = _setup()
    ours = make_regression_data(topo, RegressionSpec(concept_shift=0.3,
                                                     heterogeneity=0.2), 7)
    ref = j_make_data(jtopo, JSpec(concept_shift=0.3, heterogeneity=0.2), 7)
    for k in ("x", "y", "w_server"):
        np.testing.assert_array_equal(ours[k], ref[k])


def test_quickstart_epochs_match_reference():
    topo, jtopo = _setup()
    for jp, jm, tp, tm in _run_both(topo, jtopo):
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-5, atol=1e-6)
        assert tm.loss.shape == (50, 5, 5)
        np.testing.assert_allclose(float(tm.server_disagreement),
                                   float(jm.server_disagreement),
                                   rtol=0, atol=_floor(tp[:, 0]))
        np.testing.assert_allclose(float(tm.client_drift),
                                   float(jm.client_drift), rtol=1e-4,
                                   atol=_floor(tp[:, 0]))
        np.testing.assert_allclose(float(tm.grad_norm),
                                   float(jm.grad_norm), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["gossip_blocked", "collapsed",
                                  "exact_mean", "none"])
def test_other_consensus_modes_match_reference(mode):
    topo, jtopo = _setup(m=4, n=2, t_c=10, t_s=5)
    for jp, jm, tp, tm in _run_both(topo, jtopo, mode=mode, epochs=2):
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("baseline", ["fedavg", "local_only"])
def test_baselines_match_reference(baseline):
    topo, jtopo = _setup(m=4, n=2, t_c=10, t_s=5)
    for jp, jm, tp, tm in _run_both(topo, jtopo, epochs=2,
                                    baseline=baseline):
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-5, atol=1e-6)


def test_row_stochastic_mixing_matches_reference():
    """Naive directed gossip: a star's out-degree weights are row- but not
    doubly stochastic, so the servers drift to the Perron-weighted mean."""
    topo, jtopo = _setup(m=4, n=2, t_c=10, t_s=5, graph="star",
                         weights="out_degree")
    a = topo.mixing_matrix()
    assert not np.allclose(a.sum(0), 1.0)
    data = make_regression_data(topo, RegressionSpec(), 0)
    pi = topo_perron(a)
    np.testing.assert_array_equal(perron_ideal(data["x"], data["y"], pi),
                                  j_perron_ideal(data["x"], data["y"], pi))
    for jp, jm, tp, tm in _run_both(topo, jtopo, epochs=2,
                                    mixing="row_stochastic"):
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-5, atol=1e-6)


def test_microbatches_momentum_and_light_metrics_match_reference():
    topo, jtopo = _setup(m=3, n=2, t_c=8, t_s=4)
    for jp, jm, tp, tm in _run_both(topo, jtopo, epochs=2, opt="momentum",
                                    micro=4, metrics="light"):
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-5, atol=1e-6)
        assert float(tm.server_disagreement) == 0.0
        assert float(tm.client_drift) == 0.0


def test_builder_refuses_what_the_slice_does_not_port():
    topo, _ = _setup(m=3, n=2, t_c=2, t_s=2)
    loss = make_regression_task(topo)["loss_fn"]
    # push-sum builds, as the reference's does, and refuses staleness and
    # a backend whose update is not W <- A W (the reference's refusals)
    tdfl.build_dfl_epoch_step(
        tdfl.DFLConfig(topology=topo, mixing="push_sum"), loss, sgd(0.1))
    with pytest.raises(ValueError, match="push_sum"):
        tdfl.build_dfl_epoch_step(
            tdfl.DFLConfig(topology=topo, mixing="push_sum", staleness=1),
            loss, sgd(0.1))
    with pytest.raises(ValueError, match="undefined"):
        tdfl.build_dfl_epoch_step(
            tdfl.DFLConfig(topology=topo, mixing="push_sum",
                           consensus_mode="chebyshev"), loss, sgd(0.1))
    with pytest.raises(ValueError, match="directed"):
        tdfl.build_dfl_epoch_step(
            tdfl.DFLConfig(topology=topo, consensus_mode="exact_mean",
                           mixing="row_stochastic"), loss, sgd(0.1))


def test_layout_helpers_match_reference():
    """replicate / server_mean / broadcast / the diagnostics on a random
    (M, N, ...) tree (f32 means: rtol 1e-6; diagnostics at their floor)."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    clients = rng.standard_normal((3, 2, 3, 4)).astype(np.float32)
    rep = tdfl.replicate_to_clients({"w": torch.from_numpy(w)}, 3, 2)
    np.testing.assert_array_equal(
        rep["w"].numpy(),
        np.asarray(jdfl.replicate_to_clients({"w": jnp.asarray(w)}, 3,
                                             2)["w"]))
    mean = tdfl.server_mean({"w": torch.from_numpy(clients)})["w"]
    jmean = jdfl.server_mean({"w": jnp.asarray(clients)})["w"]
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6)
    np.testing.assert_array_equal(
        tdfl.broadcast_to_clients({"w": mean}, 2)["w"].numpy(),
        np.asarray(jdfl.broadcast_to_clients({"w": jmean}, 2)["w"]))
    np.testing.assert_allclose(
        float(tdfl.disagreement_norm({"w": mean})),
        float(jdfl.disagreement_norm({"w": jmean})), rtol=1e-5,
        atol=_floor(mean.numpy()))
    np.testing.assert_allclose(
        float(tdfl.max_client_drift({"w": torch.from_numpy(clients)},
                                    {"w": mean})),
        float(jdfl.max_client_drift({"w": jnp.asarray(clients)},
                                    {"w": jmean})), rtol=1e-5,
        atol=_floor(clients))
