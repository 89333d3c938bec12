"""Port twins of the rows of ``tests/test_overlap.py`` that the
dynamic-federation slice covers: superepoch parity, the block plan, one
read-back a dispatch, and bounded-staleness gossip off the wire.

* degeneration — ``superepoch=1`` and ``staleness=0`` ARE the per-epoch
  and synchronous paths: history and final state bitwise equal, within the
  port, under partial participation, edge drops and drop/rejoin churn;
* parity — the K-epoch dispatch reproduces the per-epoch engine's history
  element for element at K in {1, 2, 4}, through fault surgery and on the
  compressed physical wire (bitwise, within the port);
* semantics — ``gossip_scan_stale`` is the operator ``A^{T_S // (s+1)}``
  (atol 1e-5 against float32 numpy, as the reference's test; rtol/atol 2e-5
  against the reference's function), s = 1 converges on the M = 8
  regression within the fig-3 tolerance, and the engine reads metrics
  back once a dispatch.

The shard_map wire's rows (its bounded staleness included) are twinned in
``tests/test_torch_shard_map.py``, on one world of 4 gloo ranks; the
Pallas kernel rows are left out (kernel 8 and its row form have their own
CUDA tests).  The push-sum rows are twinned in
``tests/test_torch_directed.py``, the Byzantine row in
``tests/test_torch_robust.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import consensus as jcns  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.obs import FIG3_TOLERANCE  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.comm.compressors import StochasticQuantizer  # noqa: E402
from repro_torch.core import (DFLConfig, FaultSchedule, FLTopology,  # noqa: E402
                              ParticipationSchedule, TopologySchedule,
                              build_dfl_epoch_step,
                              build_dfl_superepoch_step, init_dfl_state,
                              make_backend, make_engine,
                              stack_epoch_schedules)
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core import topology as tp  # noqa: E402
from repro_torch.core.schedule import EpochSchedule, SigmaTracker  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

M, N, GAMMA = 4, 3, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These runs are many small ops: one intra-op thread, so that parallel
    test workers do not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(superepoch=1, staleness=0, *, m=M, n=N, t_client=3, t_server=4,
            faults="drop:3:2,rejoin:5:2", seed=0, **cfg_kw):
    """A churny scenario: Bernoulli participation + per-epoch edge drops +
    a drop/rejoin cycle."""
    topo = FLTopology(num_servers=m, clients_per_server=n,
                      t_client=t_client, t_server=t_server,
                      graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.3),
                                seed=seed)
    eng = make_engine(
        topo, task["loss_fn"], sgd(GAMMA),
        participation=ParticipationSchedule(kind="bernoulli", rate=0.6,
                                            seed=seed + 3),
        topology_schedule=TopologySchedule(kind="edge_drop", drop_prob=0.3,
                                           seed=seed + 5),
        faults=FaultSchedule.parse(faults),
        superepoch=superepoch, staleness=staleness, **cfg_kw)
    state = init_dfl_state(eng.cfg, torch.zeros(2), sgd(GAMMA),
                           wire_key=prng.key(seed))
    return eng, state, task["batch_fn"]


def _assert_tree_equal(a, b):
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(la.numpy(), lb.numpy())


# ---------------------------------------------------------------------------
# superepoch: history + state parity with the per-epoch engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_superepoch_history_parity_bitwise(k):
    """K-epoch dispatch == per-epoch loop, element-bitwise, through
    participation + edge drops + drop/rejoin churn (blocks split at the
    fault epochs)."""
    eng1, st1, bf1 = _engine(1)
    st1, h1 = eng1.run(st1, 7, bf1)
    engk, stk, bfk = _engine(k)
    stk, hk = engk.run(stk, 7, bfk)
    assert set(h1) == set(hk)
    for key in h1:
        assert h1[key] == hk[key], key
    _assert_tree_equal(st1.client_params, stk.client_params)


def test_superepoch_parity_compressed_wire():
    """wire_mb / wire_ratio match per epoch: the block ledger snapshots the
    cumulative ratio after each epoch, not after the block."""
    kw = dict(compression="int8:8", error_feedback=True, wire="physical")
    eng1, st1, bf1 = _engine(1, **kw)
    st1, h1 = eng1.run(st1, 6, bf1)
    eng2, st2, bf2 = _engine(2, **kw)
    st2, h2 = eng2.run(st2, 6, bf2)
    assert "wire_mb" in h1 and "wire_ratio" in h1
    for key in h1:
        assert h1[key] == h2[key], key
    _assert_tree_equal(st1.client_params, st2.client_params)
    _assert_tree_equal(st1.ef_residual, st2.ef_residual)


def test_superepoch_compile_once_per_m_k():
    """One superepoch step built per (M, K), however the masks and
    matrices vary across blocks."""
    eng, st, bf = _engine(4)
    eng.run(st, 12, bf)
    counts = eng.superepoch_compile_counts()
    assert counts and all(c == 1 for c in counts.values()), counts
    # blocks split at fault epochs 3 and 5 -> K in {4, 3, 2, 1} appear
    assert {k for (_, k) in counts} >= {2, 3}


def test_plan_blocks_cuts_at_faults():
    eng, _, _ = _engine(4)
    blocks = eng._plan_blocks(10)
    # faults at 3 and 5: [0,3) [3,5) [5,10) chunked by <= 4
    assert blocks == [(0, 3), (3, 2), (5, 4), (9, 1)]
    assert sum(k for _, k in blocks) == 10
    starts = [e for e, _ in blocks]
    assert 3 in starts and 5 in starts


def test_stack_epoch_schedules_validation():
    a = np.eye(2, dtype=np.float32)
    mask = np.ones((2, 3), np.float32)
    with pytest.raises(ValueError, match="empty"):
        stack_epoch_schedules([])
    mixed = [EpochSchedule(mask, a, None, np.zeros(2, np.int32)),
             EpochSchedule(mask, a, None, None)]
    with pytest.raises(ValueError, match="uniform operand structure"):
        stack_epoch_schedules(mixed)
    sb = stack_epoch_schedules([EpochSchedule(mask, a)] * 3)
    assert sb.k == 3 and sb.mask.shape == (3, 2, 3)
    assert sb.lam2 is None and sb.byz is None
    jsb = jsched.EpochSchedule(mask, a, np.float32(0.5))
    ours = stack_epoch_schedules([EpochSchedule(mask, a, np.float32(0.5))])
    from repro.core.overlap import stack_epoch_schedules as j_stack
    theirs = j_stack([jsb])
    for x, y in zip(ours, theirs):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_superepoch_step_refuses_static_and_k0():
    topo = FLTopology(num_servers=2, clients_per_server=2, t_client=1,
                      t_server=1, graph_kind="complete")
    task = make_regression_task(topo, seed=0)
    with pytest.raises(ValueError, match="dynamic"):
        build_dfl_superepoch_step(DFLConfig(topology=topo),
                                  task["loss_fn"], sgd(GAMMA), 2)
    with pytest.raises(ValueError, match=">= 1"):
        build_dfl_superepoch_step(DFLConfig(topology=topo, dynamic=True),
                                  task["loss_fn"], sgd(GAMMA), 0)
    with pytest.raises(ValueError, match=">= 1"):
        _engine(0)


# ---------------------------------------------------------------------------
# the read-back ledger
# ---------------------------------------------------------------------------


def test_one_device_get_per_dispatch():
    """EVERY metric read-back goes through the injectable ``_device_get``:
    once an epoch on the per-epoch path, once a block at K > 1."""
    for superepoch, epochs, dispatches in ((1, 6, 6), (3, 6, 2), (6, 6, 1)):
        eng, st, bf = _engine(superepoch, faults="")
        calls = []
        real = eng._device_get
        eng._device_get = lambda x: (calls.append(1), real(x))[1]
        eng.run(st, epochs, bf)
        assert len(calls) == dispatches, (superepoch, len(calls))


def test_device_get_is_one_transfer_and_passes_host_leaves():
    from repro_torch.core.engine import device_get
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": (torch.tensor(2.5),
                                                       None)}
    out = device_get(tree)
    assert out["b"][1] is None
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"].numpy())


# ---------------------------------------------------------------------------
# bounded staleness: semantics, degeneration, convergence
# ---------------------------------------------------------------------------


def _stale_tree():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (5, 2, 3)).astype(np.float32))}


def test_gossip_scan_stale_zero_is_gossip_scan():
    a = torch.as_tensor(tp.metropolis_weights(tp.ring_graph(5)),
                        dtype=torch.float32)
    tree = _stale_tree()
    _assert_tree_equal(cns.gossip_scan_stale(a, tree, 6, 0),
                       cns.gossip_scan(a, tree, 6))
    # and the backend's default construction is its synchronous rounds
    _assert_tree_equal(
        cns.GossipBackend(a.numpy(), 6, staleness=0).mix(tree),
        cns.GossipBackend(a.numpy(), 6).mix(tree))


@pytest.mark.parametrize("s,t_server", [(1, 2), (1, 5), (1, 8), (2, 7)])
def test_gossip_scan_stale_exact_operator(s, t_server):
    """T_S stale rounds apply A^{floor(T_S/(s+1))}, the contraction
    SigmaTracker budgets for; and the reference's stale rounds within f32."""
    a = tp.metropolis_weights(tp.ring_graph(5)).astype(np.float32)
    w = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    out = cns.gossip_scan_stale(torch.from_numpy(a),
                                {"w": torch.from_numpy(w)}, t_server, s)
    want = np.linalg.matrix_power(a, t_server // (s + 1)) @ w
    np.testing.assert_allclose(out["w"].numpy(), want, atol=1e-5)
    ref = jcns.gossip_scan_stale(jnp.asarray(a), {"w": jnp.asarray(w)},
                                 t_server, s)
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(ref["w"]),
                               rtol=2e-5, atol=2e-5)
    for mode in ("gossip", "gossip_blocked"):
        be = make_backend(mode, a, t_server, staleness=s)
        np.testing.assert_array_equal(
            be.mix({"w": torch.from_numpy(w)})["w"].numpy(),
            out["w"].numpy())


def test_sigma_tracker_staleness_contraction():
    a = tp.metropolis_weights(tp.ring_graph(5))
    sync = SigmaTracker(5).update(a, 6)
    stale = SigmaTracker(5, staleness=1).update(a, 6)
    ref = SigmaTracker(5).update(a, 3)          # A^3 == 6 rounds at s=1
    assert stale == pytest.approx(ref)
    assert stale > sync                         # weaker contraction
    assert stale == jsched.SigmaTracker(5, staleness=1).update(a, 6)


def test_staleness0_engine_bitwise_degeneration():
    """DFLConfig(staleness=0) IS the synchronous path — bitwise, through
    participation + edge drops + churn, on both the flat and the blocked
    backend."""
    for mode in ("gossip", "gossip_blocked"):
        eng0, st0, bf0 = _engine(1, consensus_mode=mode)
        st0, h0 = eng0.run(st0, 7, bf0)
        engz, stz, bfz = _engine(1, 0, consensus_mode=mode)
        stz, hz = engz.run(stz, 7, bfz)
        for key in h0:
            assert h0[key] == hz[key], (mode, key)
        _assert_tree_equal(st0.client_params, stz.client_params)


def test_staleness1_converges_fig3_m8():
    """s=1 on the m=8 regression: consensus still contracts (operator
    A^{floor(T_S/2)} an epoch) and the run lands within the fig-3
    disagreement tolerance."""
    eng, st, bf = _engine(2, 1, m=8, n=2, t_client=10, t_server=10,
                          faults="")
    st, hist = eng.run(st, 40, bf)
    assert hist["disagreement"][-1] < FIG3_TOLERANCE
    # and the s=0 twin agrees on the final loss to fig-3 precision
    eng0, st0, bf0 = _engine(2, 0, m=8, n=2, t_client=10, t_server=10,
                             faults="")
    st0, hist0 = eng0.run(st0, 40, bf0)
    assert abs(hist["loss"][-1] - hist0["loss"][-1]) < FIG3_TOLERANCE


def test_staleness_refusal_matrix():
    topo = FLTopology(num_servers=3, clients_per_server=2, t_client=1,
                      t_server=2, graph_kind="complete")
    task = make_regression_task(topo, seed=0)
    with pytest.raises(ValueError, match="staleness"):
        make_backend("collapsed", topo.mixing_matrix(), 2, staleness=1)
    with pytest.raises(ValueError, match="staleness"):
        make_backend("chebyshev", topo.mixing_matrix(), 2, staleness=1)
    with pytest.raises(ValueError, match="negative|>= 0"):
        make_backend("gossip", topo.mixing_matrix(), 2, staleness=-1)
    # push-sum's exact weight recursion has no stale twin (the reference's
    # refusal, tests/test_overlap.py)
    with pytest.raises(ValueError, match="push_sum"):
        build_dfl_epoch_step(
            DFLConfig(topology=topo, mixing="push_sum", staleness=1),
            task["loss_fn"], sgd(GAMMA))
    with pytest.raises(ValueError, match="none"):
        build_dfl_epoch_step(
            DFLConfig(topology=topo, consensus_mode="none", staleness=1),
            task["loss_fn"], sgd(GAMMA))
    # simulated-wire compression + staleness is incoherent
    inner = cns.GossipBackend(topo.mixing_matrix(), 2, staleness=1)
    with pytest.raises(ValueError, match="physical"):
        cns.CompressedBackend(inner, StochasticQuantizer(bits=8, chunk=4),
                              wire="simulated")


# ---------------------------------------------------------------------------
# the dynamic trainer: superepoch blocks and the CLI's routing
# ---------------------------------------------------------------------------

LM = dict(smoke=True, servers=4, clients=2, t_client=1, t_server=3,
          epochs=3, seq_len=16, device="cpu", log=False,
          participation_rate=0.5, edge_drop_prob=0.3,
          faults="drop:1:2,rejoin:2:2")


def test_train_dynamic_superepoch_is_the_per_epoch_history():
    one = ttrain.train_dynamic("smollm-360m", **LM)
    two = ttrain.train_dynamic("smollm-360m", superepoch=2, **LM)
    assert one["history"]["num_servers"] == [4.0, 3.0, 4.0]
    for key in one["history"]:
        if key != "epoch_s":
            assert one["history"][key] == two["history"][key], key
    _assert_tree_equal(one["state"].client_params,
                       two["state"].client_params)
    assert one["engine"].compile_counts() == {4: 1, 3: 1}


def test_cli_routes_dynamic_flags_to_train_dynamic(capsys, monkeypatch):
    calls = []
    monkeypatch.setattr(ttrain, "train_dynamic",
                        lambda arch, **kw: calls.append(("dynamic", kw)))
    monkeypatch.setattr(ttrain, "train",
                        lambda arch, **kw: calls.append(("static", kw)))
    base = ["--device", "cpu", "--epochs", "1"]
    for flags, want in (([], "static"), (["--compression", "int8"], "static"),
                        (["--participation-rate", "0.5"], "dynamic"),
                        (["--edge-drop-prob", "0.1"], "dynamic"),
                        (["--straggler-weaken", "0.5"], "dynamic"),
                        (["--asymmetric-drop-prob", "0.1", "--mixing",
                          "row_stochastic"], "dynamic"),
                        (["--faults", "drop:1:0"], "dynamic"),
                        (["--byzantine", "sign_flip:0.25"], "dynamic"),
                        (["--participation-trace", "t.jsonl"], "dynamic"),
                        (["--superepoch", "2"], "dynamic"),
                        (["--staleness", "1"], "dynamic")):
        calls.clear()
        ttrain.main(base + flags)
        assert calls[0][0] == want, flags
    # --mixing push_sum reaches the dynamic driver with its flags
    calls.clear()
    ttrain.main(base + ["--faults", "drop:1:0", "--mixing", "push_sum"])
    assert calls[0][0] == "dynamic"
    assert calls[0][1]["mixing"] == "push_sum"
    assert calls[0][1]["faults"] == "drop:1:0"
    # --byzantine reaches the dynamic driver, which parses it as the
    # reference does (a malformed spec fails there)
    calls.clear()
    ttrain.main(base + ["--byzantine", "sign_flip:0.25", "--consensus-mode",
                        "trimmed_mean:1"])
    assert calls[0][1]["byzantine"] == "sign_flip:0.25"
    assert calls[0][1]["consensus_mode"] == "trimmed_mean:1"
    monkeypatch.undo()
    with pytest.raises(ValueError, match="byzantine"):
        ttrain.main(base + ["--byzantine", "warp:0.25"])
