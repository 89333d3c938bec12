"""Port parity for dynamic federation: a twin of every case of
``tests/test_dynamic_federation.py`` on ``repro_torch`` — partial
participation, time-varying graphs, fault schedules, Chebyshev on a
per-epoch A_p, data by original server identity — plus parity against the
reference on the same numpy-made inputs.

Tolerances:
* schedules, masks, mixing matrices, traces, fault events and the engine's
  ``num_servers`` / ``participation`` / ``sigma_prod`` columns: exact (numpy
  on both sides, the same generators);
* the masked step, engine runs with drop and rejoin, and Chebyshev on a
  per-epoch A_p: rtol 1e-5, atol 1e-6, the regression tolerances of
  ``tests/test_torch_dfl.py`` (f32 SGD and gossip summed in another order);
  the Lemma diagnostics at 8x their f32 rounding floor (ROADMAP Queue 3);
* one LM-smoke engine epoch: rtol/atol 1e-4, ``tests/test_torch_train.py``'s;
* the reference's all-ones-mask case, which its own package fails in the
  last bit (two different means, ROADMAP Queue 3): bitwise within the port,
  ``allclose`` against the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import RegressionSpec as JSpec  # noqa: E402
from repro.data import make_regression_task as j_task  # noqa: E402
from repro.optim import momentum as j_momentum  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.core import (DFLConfig, EpochSchedule, FaultEvent,  # noqa: E402
                              FaultSchedule, FLTopology,
                              ParticipationSchedule, SigmaTracker,
                              TopologySchedule, build_dfl_epoch_step,
                              carry_forward, init_dfl_state, make_engine,
                              masked_server_mean)
from repro_torch.comm import prng  # noqa: E402
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import topology as tp  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.optim import momentum, sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These runs are many small ops: one intra-op thread, so that parallel
    test workers do not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _floor(w: np.ndarray) -> float:
    return 8.0 * np.sqrt(EPS32 * float(np.sum(np.square(w))))


def _setup(m=5, n=5, t_c=15, t_s=8, seed=0, heterogeneity=0.0):
    topo = FLTopology(num_servers=m, clients_per_server=n, t_client=t_c,
                      t_server=t_s, graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(
        heterogeneity=heterogeneity), seed=seed)
    return topo, task["loss_fn"], task["batches"], task["w_star"]


def _sched(mask, a, lam2=None):
    return EpochSchedule(torch.as_tensor(np.asarray(mask),
                                         dtype=torch.float32),
                         torch.as_tensor(np.asarray(a), dtype=torch.float32),
                         lam2)


def _tree(m, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((m, 7)).astype(np.float32)}


# ---------------------------------------------------------------------------
# exact degeneration to the static paper setting
# ---------------------------------------------------------------------------


def test_all_ones_mask_static_graph_reproduces_gossip_bitwise():
    """Dynamic step with full participation + the static A is the static
    step, bitwise within the port (its two means share one operation); the
    reference's two means differ in the last bit, so against the reference
    the comparison is ``allclose``."""
    topo, loss_fn, batches, _ = _setup()
    opt = sgd(1e-3)
    step_s = build_dfl_epoch_step(DFLConfig(topology=topo), loss_fn, opt)
    step_d = build_dfl_epoch_step(DFLConfig(topology=topo, dynamic=True),
                                  loss_fn, opt)
    st_s = init_dfl_state(DFLConfig(topology=topo), torch.zeros(2), opt)
    st_d = init_dfl_state(DFLConfig(topology=topo), torch.zeros(2), opt)
    sched = _sched(np.ones((5, 5)), topo.mixing_matrix())
    jtopo = J.FLTopology(num_servers=5, clients_per_server=5, t_client=15,
                         t_server=8, graph_kind="ring")
    jt = j_task(jtopo, JSpec(), seed=0)
    jstep = jax.jit(J.build_dfl_epoch_step(
        J.DFLConfig(topology=jtopo, dynamic=True), jt["loss_fn"],
        j_sgd(1e-3)))
    jst = J.init_dfl_state(J.DFLConfig(topology=jtopo), jnp.zeros((2,)),
                           j_sgd(1e-3), jax.random.key(0))
    jsched_ = J.EpochSchedule(jnp.ones((5, 5), jnp.float32),
                              jnp.asarray(jtopo.mixing_matrix(), jnp.float32))
    for _ in range(4):
        st_s, m_s = step_s(st_s, batches)
        st_d, m_d = step_d(st_d, batches, sched)
        jst, jm = jstep(jst, jt["batches"], jsched_)
    np.testing.assert_array_equal(st_s.client_params.numpy(),
                                  st_d.client_params.numpy())
    np.testing.assert_array_equal(m_s.loss.numpy(), m_d.loss.numpy())
    np.testing.assert_allclose(st_d.client_params.numpy(),
                               np.asarray(jst.client_params), **TOL)
    np.testing.assert_allclose(m_d.loss.numpy(), np.asarray(jm.loss), **TOL)


def test_constant_tv_schedule_matches_gossip_scan():
    """gossip_scan_tv with T_S copies of A is T_S rounds of A: bitwise the
    flattened kernel-1 rounds of the gossip backend, and the reference's
    ``gossip_scan_tv`` within f32."""
    m, t_s = 6, 9
    a = tp.metropolis_weights(tp.ring_graph(m)).astype(np.float32)
    tree = _tree(m, 0)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    stack = torch.from_numpy(np.broadcast_to(a, (t_s,) + a.shape).copy())
    out_tv = cns.gossip_scan_tv(stack, tt)
    out_ref = kops.consensus_mix_pytree(torch.from_numpy(a), tt, rounds=t_s)
    for key in tree:
        np.testing.assert_array_equal(out_tv[key].numpy(),
                                      out_ref[key].numpy())
    jout = jcns.gossip_scan_tv(jnp.asarray(stack.numpy()),
                               {k: jnp.asarray(v) for k, v in tree.items()})
    for key in tree:
        np.testing.assert_allclose(out_tv[key].numpy(),
                                   np.asarray(jout[key]), rtol=2e-5,
                                   atol=2e-5)


def test_tv_gossip_preserves_mean_under_varying_graphs():
    """Each round's A_t is doubly stochastic, so any schedule of distinct
    graphs still fixes the server mean."""
    m = 5
    mats = [tp.metropolis_weights(tp.ring_graph(m)),
            tp.metropolis_weights(tp.line_graph(m)),
            tp.metropolis_weights(tp.complete_graph(m))]
    stack = torch.as_tensor(np.stack(mats), dtype=torch.float32)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (m, 11)).astype(np.float32))
    out = cns.gossip_scan_tv(stack, {"w": w})["w"]
    np.testing.assert_allclose(w.mean(0).numpy(), out.mean(0).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# masked aggregation (Eq. 4 over the participating set)
# ---------------------------------------------------------------------------


def test_masked_mean_is_subset_mean():
    m, n = 4, 6
    x = np.random.default_rng(2).standard_normal((m, n, 3)).astype(
        np.float32)
    mask_np = (np.random.default_rng(0).random((m, n)) < 0.5)
    mask_np[:, 0] = True                       # keep every server non-empty
    out = masked_server_mean({"w": torch.from_numpy(x)},
                             torch.as_tensor(mask_np, dtype=torch.float32))
    for i in range(m):
        ref = x[i][mask_np[i]].mean(axis=0)
        np.testing.assert_allclose(out["w"][i].numpy(), ref, rtol=1e-6,
                                   atol=1e-6)
    jout = J.masked_server_mean({"w": jnp.asarray(x)},
                                jnp.asarray(mask_np, jnp.float32))
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(jout["w"]),
                               rtol=1e-6, atol=1e-6)


def test_masked_mean_iid_participants_preserve_server_mean():
    """When every client of a server holds the SAME model (the broadcast
    state), the masked mean equals the server mean for every mask."""
    m, n = 3, 5
    base = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (m, 1, 4)).astype(np.float32))
    x = base.expand(m, n, 4)
    for seed in range(3):
        mask = (np.random.default_rng(seed).random((m, n)) < 0.4)
        out = masked_server_mean({"w": x}, torch.as_tensor(
            mask, dtype=torch.float32))["w"]
        np.testing.assert_allclose(out.numpy(), base[:, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_fully_idle_server_carries_model_through_epoch():
    """A mask row of zeros: the server's aggregate falls back to the
    broadcast model it started the epoch with."""
    topo, loss_fn, batches, _ = _setup(m=3, n=2, t_c=5, t_s=4)
    opt = sgd(1e-3)
    cfg = DFLConfig(topology=topo, dynamic=True, consensus_mode="none")
    step = build_dfl_epoch_step(cfg, loss_fn, opt)
    state = init_dfl_state(cfg, torch.ones(2), opt)
    before = state.client_params.clone()
    mask = np.ones((3, 2), np.float32)
    mask[1] = 0.0                                # server 1 fully idle
    new_state, _ = step(state, batches, _sched(mask, topo.mixing_matrix()))
    # with consensus off, idle server 1 must still hold w_0 exactly
    np.testing.assert_array_equal(new_state.client_params[1].numpy(),
                                  before[1].numpy())
    # the training servers moved
    assert (new_state.client_params[0] - before[0]).abs().max() > 1e-6


def test_non_participant_data_never_influences_result():
    """Masking client (0, 1) out makes its batch contents irrelevant."""
    topo, loss_fn, (bx, by), _ = _setup(m=2, n=3, t_c=5, t_s=4)
    opt = sgd(1e-3)
    cfg = DFLConfig(topology=topo, dynamic=True)
    step = build_dfl_epoch_step(cfg, loss_fn, opt)
    mask = np.ones((2, 3), np.float32)
    mask[0, 1] = 0.0
    sched = _sched(mask, topo.mixing_matrix())
    out1, _ = step(init_dfl_state(cfg, torch.zeros(2), opt), (bx, by), sched)
    bad_bx, bad_by = bx.clone(), by.clone()
    bad_bx[:, 0, 1] = 1e6                        # garbage in masked slot
    bad_by[:, 0, 1] = -1e6
    out2, _ = step(init_dfl_state(cfg, torch.zeros(2), opt),
                   (bad_bx, bad_by), sched)
    np.testing.assert_array_equal(out1.client_params.numpy(),
                                  out2.client_params.numpy())


def test_carry_forward_preserves_optimizer_state():
    """Stateful optimizers: a non-participant's momentum buffer freezes
    while the shared step count still advances."""
    topo, loss_fn, batches, _ = _setup(m=2, n=2, t_c=3, t_s=2)
    opt = momentum(1e-3)
    cfg = DFLConfig(topology=topo, dynamic=True)
    step = build_dfl_epoch_step(cfg, loss_fn, opt)
    state = init_dfl_state(cfg, torch.zeros(2), opt)
    vel_old = state.opt_state.velocity.clone()
    mask = np.asarray([[1.0, 0.0], [1.0, 1.0]], np.float32)
    new_state, _ = step(state, batches, _sched(mask, topo.mixing_matrix()))
    vel_new = new_state.opt_state.velocity
    np.testing.assert_array_equal(vel_new[0, 1].numpy(),
                                  vel_old[0, 1].numpy())          # frozen
    assert (vel_new[0, 0] - vel_old[0, 0]).abs().max() > 0        # trained
    assert int(new_state.opt_state.count) == topo.t_client


def test_carry_forward_matches_reference():
    rng = np.random.default_rng(4)
    new, old = (rng.standard_normal((3, 2, 5)).astype(np.float32)
                for _ in range(2))
    mask = np.asarray([[1, 0], [0, 0], [1, 1]], np.float32)
    got = carry_forward(torch.from_numpy(mask),
                        {"w": torch.from_numpy(new), "c": torch.tensor(3)},
                        {"w": torch.from_numpy(old), "c": torch.tensor(2)})
    want = J.carry_forward(jnp.asarray(mask),
                           {"w": jnp.asarray(new), "c": jnp.asarray(3)},
                           {"w": jnp.asarray(old), "c": jnp.asarray(2)})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert int(got["c"]) == 3


def test_masked_epoch_matches_reference():
    """One dynamic epoch with a partial mask and an edge-dropped A_p, with
    momentum (the carried optimizer state), against the reference."""
    kw = dict(num_servers=4, clients_per_server=3, t_client=6, t_server=5,
              graph_kind="ring")
    topo, jtopo = FLTopology(**kw), J.FLTopology(**kw)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    jt = j_task(jtopo, JSpec(heterogeneity=0.5))
    mask = ParticipationSchedule(kind="bernoulli", rate=0.5,
                                 seed=1).mask(0, 4, 3)
    a = TopologySchedule(kind="edge_drop", drop_prob=0.4,
                         seed=2).mixing(topo, 0)
    opt, jopt = momentum(1e-2), j_momentum(1e-2)
    step = build_dfl_epoch_step(DFLConfig(topology=topo, dynamic=True),
                                task["loss_fn"], opt)
    jstep = jax.jit(J.build_dfl_epoch_step(
        J.DFLConfig(topology=jtopo, dynamic=True), jt["loss_fn"], jopt))
    st = init_dfl_state(DFLConfig(topology=topo), torch.zeros(2), opt)
    jst = J.init_dfl_state(J.DFLConfig(topology=jtopo), jnp.zeros((2,)),
                           jopt, jax.random.key(0))
    for _ in range(2):
        st, mt = step(st, task["batches"], _sched(mask, a))
        jst, jm = jstep(jst, jt["batches"], J.EpochSchedule(
            jnp.asarray(mask), jnp.asarray(a, jnp.float32)))
        np.testing.assert_allclose(st.client_params.numpy(),
                                   np.asarray(jst.client_params), **TOL)
        np.testing.assert_allclose(st.opt_state.velocity.numpy(),
                                   np.asarray(jst.opt_state.velocity), **TOL)
        np.testing.assert_allclose(mt.loss.numpy(), np.asarray(jm.loss),
                                   **TOL)
        floor = _floor(st.client_params[:, 0].numpy())
        np.testing.assert_allclose(float(mt.server_disagreement),
                                   float(jm.server_disagreement), rtol=0,
                                   atol=floor)
        np.testing.assert_allclose(float(mt.client_drift),
                                   float(jm.client_drift), rtol=1e-4,
                                   atol=floor)


# ---------------------------------------------------------------------------
# participation / topology schedules (host side): exact against the
# reference
# ---------------------------------------------------------------------------


def test_participation_schedules_shapes_and_determinism():
    specs = (dict(), dict(kind="bernoulli", rate=0.3, seed=3),
             dict(kind="fixed_k", k=2, seed=3), dict(kind="round_robin", k=2))
    for kw in specs:
        sched, ref = ParticipationSchedule(**kw), \
            jsched.ParticipationSchedule(**kw)
        m1 = sched.mask(7, 4, 5)
        m2 = sched.mask(7, 4, 5)
        np.testing.assert_array_equal(m1, m2)       # deterministic in epoch
        assert m1.shape == (4, 5) and m1.dtype == np.float32
        assert set(np.unique(m1)) <= {0.0, 1.0}
        assert (m1.sum(axis=1) >= 1).all()          # min_per_server=1
        for epoch in range(6):
            np.testing.assert_array_equal(sched.mask(epoch, 4, 5),
                                          ref.mask(epoch, 4, 5))
        assert sched.expected_rate(5) == ref.expected_rate(5)
    with pytest.raises(ValueError):
        ParticipationSchedule(kind="bogus")
    with pytest.raises(ValueError):
        ParticipationSchedule(kind="fixed_k")        # k missing


def test_round_robin_covers_all_clients():
    sched = ParticipationSchedule(kind="round_robin", k=2)
    seen = np.zeros(6, bool)
    for e in range(3):
        seen |= sched.mask(e, 2, 6)[0].astype(bool)
    assert seen.all()


def test_traces_match_reference_exactly(tmp_path):
    """diurnal traces, their JSONL log (both ways between the packages),
    binary and float-rate trace replay, expected rates and the churn
    derived from a trace."""
    kw = dict(period=6, base=0.5, amplitude=0.6, seed=4)
    trace = tsched.diurnal_trace(10, 3, 4, **kw)
    np.testing.assert_array_equal(trace, jsched.diurnal_trace(10, 3, 4,
                                                              **kw))
    rates = np.random.default_rng(5).random((4, 3, 4)).astype(np.float32)
    for t in (trace, rates):
        ours, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
        tsched.save_participation_trace(str(ours), t)
        jsched.save_participation_trace(str(theirs), t)
        assert ours.read_bytes() == theirs.read_bytes()
        back = tsched.load_participation_trace(str(theirs))
        np.testing.assert_array_equal(back, jsched.load_participation_trace(
            str(ours)))
        assert back.dtype == t.dtype
        np.testing.assert_array_equal(back, t)
        sched = ParticipationSchedule(kind="trace", trace=back, seed=2)
        ref = jsched.ParticipationSchedule(kind="trace", trace=back, seed=2)
        for epoch in range(12):
            np.testing.assert_array_equal(sched.mask(epoch, 3, 4),
                                          ref.mask(epoch, 3, 4))
        assert sched.expected_rate(4) == ref.expected_rate(4)
    churn = np.ones((8, 3, 2), np.uint8)
    churn[2:5, 1] = 0
    churn[6:, 2] = 0
    churn[3, 0] = 0
    for blip in (1, 2):
        ours = tsched.FaultSchedule.from_trace(churn, min_down_epochs=blip)
        theirs = jsched.FaultSchedule.from_trace(churn, min_down_epochs=blip)
        assert [(e.epoch, e.kind, e.server) for e in ours.events] == \
            [(e.epoch, e.kind, e.server) for e in theirs.events]
    with pytest.raises(ValueError, match="every server down"):
        tsched.FaultSchedule.from_trace(np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(ValueError, match="shaped for"):
        ParticipationSchedule(kind="trace", trace=trace).mask(0, 2, 4)


def test_topology_schedule_emits_valid_mixing():
    topo = FLTopology(num_servers=6, clients_per_server=2, t_client=5,
                      t_server=3, graph_kind="ring")
    jtopo = J.FLTopology(num_servers=6, clients_per_server=2, t_client=5,
                         t_server=3, graph_kind="ring")
    for kw in (dict(), dict(kind="edge_drop", drop_prob=0.5, seed=1),
               dict(kind="straggler", weaken=0.9, n_weak=2, seed=1)):
        sched, ref = TopologySchedule(**kw), jsched.TopologySchedule(**kw)
        for epoch in range(4):
            a = sched.mixing(topo, epoch)
            np.testing.assert_array_equal(a, ref.mixing(jtopo, epoch))
            tp.check_mixing_matrix(a)                # doubly stochastic
            # a degraded graph contracts slower but must still contract
            assert tp.sigma_a(a, 50) < 0.1
    asym = dict(kind="asymmetric", drop_prob=0.4, weaken=0.5, seed=3)
    for epoch in range(3):
        np.testing.assert_array_equal(
            TopologySchedule(**asym).mixing(topo, epoch),
            jsched.TopologySchedule(**asym).mixing(jtopo, epoch))
    with pytest.raises(ValueError):
        TopologySchedule(kind="bogus")


def test_sigma_tracker_matches_matrix_power():
    a = tp.metropolis_weights(tp.ring_graph(5))
    tr = SigmaTracker(5)
    for p in range(1, 4):
        got = tr.update(a, 6)
        assert got == pytest.approx(tp.sigma_a(a, 6 * p), abs=1e-12)
    mats = [a, tp.metropolis_weights(tp.line_graph(5))]
    tr2, ref = SigmaTracker(5), jsched.SigmaTracker(5)
    for mat in mats:
        last = tr2.update(mat, 3)
        assert last == ref.update(mat, 3)
    assert last == pytest.approx(tp.sigma_product(mats, 3), abs=1e-12)


def test_fault_schedule_parse_and_validation():
    fs = FaultSchedule.parse("drop:5:2, rejoin:9:2")
    assert fs.at(5) == (FaultEvent(5, "drop", 2),)
    assert fs.at(9) == (FaultEvent(9, "rejoin", 2),)
    assert fs.at(7) == ()
    assert fs.last_epoch == 9
    assert FaultSchedule.parse("").events == ()
    with pytest.raises(ValueError):
        FaultEvent(1, "explode", 0)
    with pytest.raises(ValueError, match="bad fault spec"):
        FaultSchedule.parse("drop:x:1")
    with pytest.raises(ValueError, match="ORIGINAL"):
        FaultSchedule.parse("rejoin:1:4").validate(4)


def test_later_slices_are_refused_by_name():
    # the Byzantine injection is ported: the schedule parses as the
    # reference's and marks the same rows
    byz = tsched.ByzantineSchedule.parse("sign_flip:0.25", seed=3)
    jbyz = jsched.ByzantineSchedule.parse("sign_flip:0.25", seed=3)
    assert byz.counts(8) == jbyz.counts(8)
    np.testing.assert_array_equal(byz.codes(0, tuple(range(8)), 8),
                                  jbyz.codes(0, tuple(range(8)), 8))
    assert tsched.ByzantineAttack("sign_flip", 0.25).scale == 1.0
    # directed federation is ported: the push-sum tracker builds and
    # tracks the transpose product, as the reference's
    a = tp.out_degree_weights(tp.directed_ring(3))
    tr, jtr = SigmaTracker(3, mode="push_sum"), jsched.SigmaTracker(
        3, mode="push_sum")
    assert tr.mode == "push_sum"
    assert tr.update(a, 4) == jtr.update(a, 4)
    np.testing.assert_array_equal(tr.prod, jtr.prod)
    # ... and, as in the reference, it needs the dynamic step
    topo, loss_fn, _, _ = _setup(m=3, n=2, t_c=1, t_s=1)
    with pytest.raises(ValueError, match="dynamic"):
        build_dfl_epoch_step(DFLConfig(topology=topo, byzantine=byz),
                             loss_fn, sgd(0.1))


# ---------------------------------------------------------------------------
# end-to-end scenarios
# ---------------------------------------------------------------------------


def _scenario_run(**engine_kw):
    topo, loss_fn, batches, w_star = _setup(t_c=20, t_s=10)
    gamma = engine_kw.pop("gamma", 0.4 / (9.0 * topo.t_client))

    def batch_fn(epoch, alive):
        ids = torch.as_tensor(alive)
        return batches[0][:, ids], batches[1][:, ids]

    engine = make_engine(topo, loss_fn, sgd(gamma), **engine_kw)
    state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(gamma))
    state, hist = engine.run(state, 60, batch_fn)
    servers = state.client_params[:, 0].numpy()
    err = float(np.linalg.norm(servers - w_star, axis=-1).max())
    return engine, hist, err


def test_partial_participation_converges():
    """Bernoulli(0.5) sampling still lands near w* (slower, not broken)."""
    _, hist, err = _scenario_run(participation=ParticipationSchedule(
        kind="bernoulli", rate=0.5, seed=3))
    assert err < 0.3, err
    assert 0.2 < np.mean(hist["participation"]) < 0.8


def test_edge_drop_schedule_converges():
    """Per-epoch degraded (repaired-to-connected) graphs still reach
    consensus near w*."""
    _, hist, err = _scenario_run(topology_schedule=TopologySchedule(
        kind="edge_drop", drop_prob=0.4, seed=5))
    assert err < 0.3, err
    assert hist["disagreement"][-1] < 1e-2
    assert hist["sigma_prod"][-1] < 1e-6


def test_fault_drop_and_rejoin_converges():
    """Drop server 2 at epoch 8, rejoin at 20 (survivor mean, its own
    clients' data): the federation still converges to the full-data w*."""
    engine, hist, err = _scenario_run(
        gamma=0.35 / (9.0 * 20), faults=FaultSchedule(
            (FaultEvent(8, "drop", 2), FaultEvent(20, "rejoin", 2))))
    assert engine.alive == [0, 1, 3, 4, 2]
    assert hist["num_servers"][7] == 5.0
    assert hist["num_servers"][8] == 4.0
    assert hist["num_servers"][20] == 5.0
    assert err < 0.3, err
    assert hist["disagreement"][-1] < 1e-2
    assert engine.compile_counts() == {5: 1, 4: 1}


def _engines(mode="gossip", epochs=8, **kw):
    """Both packages' engines through participation, edge drops and a
    drop/rejoin cycle on the same regression data."""
    shape = dict(num_servers=5, clients_per_server=3, t_client=4,
                 t_server=6, graph_kind="ring")
    scen = dict(participation=dict(kind="bernoulli", rate=0.5, seed=3),
                topology=dict(kind="edge_drop", drop_prob=0.4, seed=5),
                faults="drop:2:1,drop:3:3,rejoin:5:1")
    topo = FLTopology(**shape)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    eng = make_engine(topo, task["loss_fn"], sgd(1e-2), consensus_mode=mode,
                      participation=ParticipationSchedule(
                          **scen["participation"]),
                      topology_schedule=TopologySchedule(**scen["topology"]),
                      faults=FaultSchedule.parse(scen["faults"]), **kw)
    st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(1e-2),
                        wire_key=prng.key(0))
    st, hist = eng.run(st, epochs, task["batch_fn"])
    jtopo = J.FLTopology(**shape)
    jt = j_task(jtopo, JSpec(heterogeneity=0.5))
    jeng = J.make_engine(
        jtopo, jt["loss_fn"], j_sgd(1e-2), consensus_mode=mode,
        participation=jsched.ParticipationSchedule(**scen["participation"]),
        topology_schedule=jsched.TopologySchedule(**scen["topology"]),
        faults=jsched.FaultSchedule.parse(scen["faults"]), **kw)
    jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(1e-2),
                           jax.random.key(0))
    jst, jhist = jeng.run(jst, epochs, jt["batch_fn"])
    return eng, st, hist, jeng, jst, jhist


@pytest.mark.parametrize("mode", ["gossip", "chebyshev", "collapsed"])
def test_engine_with_drop_and_rejoin_matches_reference(mode):
    eng, st, hist, jeng, jst, jhist = _engines(mode)
    assert set(hist) == set(jhist)
    for key in ("num_servers", "participation", "sigma_prod"):
        assert hist[key] == jhist[key], key
    assert eng.alive == jeng.alive == [0, 2, 4, 1]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], **TOL)
    np.testing.assert_allclose(st.client_params.numpy(),
                               np.asarray(jst.client_params), **TOL)
    floor = _floor(st.client_params[:, 0].numpy())
    np.testing.assert_allclose(hist["disagreement"], jhist["disagreement"],
                               rtol=0, atol=floor)
    np.testing.assert_allclose(hist["drift"], jhist["drift"], rtol=1e-4,
                               atol=floor)
    assert eng.compile_counts() == {5: 1, 4: 1, 3: 1}


def test_engine_on_the_compressed_wire_matches_reference():
    """The wire ledger runs on across surgery, the EF residual restarts at
    each; int8 on the simulated wire with error feedback."""
    eng, st, hist, jeng, jst, jhist = _engines(
        epochs=6, compression="int8:8", error_feedback=True)
    for key in ("wire_mb", "wire_ratio", "num_servers", "sigma_prod"):
        assert hist[key] == jhist[key], key
    assert st.ef_residual.shape == (4, 2)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4,
                               atol=1e-4)


def test_engine_rejects_bad_fault_events():
    topo, loss_fn, batches, _ = _setup(m=3, n=2, t_c=3, t_s=2)
    task = make_regression_task(topo)
    gamma = 1e-3
    # ids outside the ORIGINAL federation fail at CONSTRUCTION
    for kind in ("drop", "rejoin"):
        with pytest.raises(ValueError, match="ORIGINAL"):
            make_engine(topo, loss_fn, sgd(gamma),
                        faults=FaultSchedule((FaultEvent(0, kind, 7),)))
    # dropping a server twice is a runtime liveness error
    engine = make_engine(topo, loss_fn, sgd(gamma),
                         faults=FaultSchedule((FaultEvent(0, "drop", 2),
                                               FaultEvent(0, "drop", 2))))
    state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(gamma))
    with pytest.raises(ValueError, match="not alive"):
        engine.run(state, 1, task["batch_fn"])
    # rejoin of an alive server is also rejected
    engine2 = make_engine(topo, loss_fn, sgd(gamma),
                          faults=FaultSchedule((FaultEvent(0, "rejoin", 1),)))
    state2 = init_dfl_state(engine2.cfg, torch.zeros(2), sgd(gamma))
    with pytest.raises(ValueError, match="already alive"):
        engine2.run(state2, 1, task["batch_fn"])
    engine3 = make_engine(topo, loss_fn, sgd(gamma))
    state3 = init_dfl_state(engine3.cfg, torch.zeros(2), sgd(gamma))
    with pytest.raises(ValueError, match="ORIGINAL"):
        engine3._rejoin(state3, None)
    with pytest.raises(ValueError, match="ORIGINAL"):
        engine3._rejoin(state3, 5)
    with pytest.raises(ValueError, match="row_stochastic"):
        make_engine(topo, loss_fn, sgd(gamma),
                    topology_schedule=TopologySchedule(kind="asymmetric"))


def test_surgery_allocates_new_rows_and_keeps_no_old_buffer():
    """The step updates buffers in place, so surgery must hand back new
    (M-1, ...) and (M+1, ...) tensors sharing no storage with the old."""
    topo, loss_fn, _, _ = _setup(m=4, n=2, t_c=1, t_s=1)
    eng = make_engine(topo, loss_fn, momentum(1e-3))
    st = init_dfl_state(eng.cfg, torch.arange(2.0), momentum(1e-3))
    old = st.client_params
    dropped = eng._drop(st, 1)
    assert dropped.client_params.shape == (3, 2, 2)
    assert dropped.opt_state.velocity.shape == (3, 2, 2)
    assert dropped.client_params.untyped_storage().data_ptr() != \
        old.untyped_storage().data_ptr()
    rejoined = eng._rejoin(dropped, 1)
    assert eng.alive == [0, 2, 3, 1]
    np.testing.assert_allclose(rejoined.client_params[3].numpy(),
                               dropped.client_params.mean(0).numpy())
    assert rejoined.client_params.untyped_storage().data_ptr() != \
        dropped.client_params.untyped_storage().data_ptr()


def test_dynamic_chebyshev_consumes_per_epoch_a_p():
    """Chebyshev rides the dynamic engine: the per-epoch spectral estimate
    (``EpochSchedule.lam2``, host-side ``topology.lambda_2``) comes with each
    epoch's A_p."""
    topo = FLTopology(num_servers=4, clients_per_server=2, t_client=3,
                      t_server=9, graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5),
                                seed=0)
    engine = make_engine(topo, task["loss_fn"], sgd(1e-3),
                         consensus_mode="chebyshev",
                         topology_schedule=TopologySchedule(
                             kind="edge_drop", drop_prob=0.3, seed=5))
    assert engine._needs_spectral
    state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(1e-3))
    state, hist = engine.run(state, 4, task["batch_fn"])
    assert np.isfinite(hist["loss"]).all()
    # the accelerated rounds still contract server disagreement
    assert hist["disagreement"][-1] < 5e-2


def test_chebyshev_backend_traced_matches_reference():
    """ChebyshevBackend.mix with a per-epoch (A_p, lam2) equals the
    reference's, for matrices the backend was NOT built with, and falls
    back to ``lambda2_traced`` without a lam2."""
    m, t_s = 5, 9
    base = tp.metropolis_weights(tp.ring_graph(m))
    backend = cns.make_backend("chebyshev", base, t_s)
    jbackend = jcns.make_backend("chebyshev", base, t_s)
    assert backend.needs_spectral
    assert backend.rounds == jbackend.rounds == 3
    w = np.random.default_rng(1).standard_normal((m, 6)).astype(np.float32)
    for a_np in (base, tp.metropolis_weights(tp.complete_graph(m)),
                 tp.metropolis_weights(tp.line_graph(m))):
        lam2 = tp.lambda_2(a_np)
        a = torch.as_tensor(a_np, dtype=torch.float32)
        out = backend.mix({"w": torch.from_numpy(w)}, a,
                          lam2=torch.tensor(lam2, dtype=torch.float32))
        ref = jcns.gossip_chebyshev(jnp.asarray(a_np, jnp.float32),
                                    {"w": jnp.asarray(w)}, 3, lam2)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(ref["w"]),
                                   rtol=2e-5, atol=2e-5)
        out_fb = backend.mix({"w": torch.from_numpy(w)}, a)
        np.testing.assert_allclose(out_fb["w"].numpy(), np.asarray(ref["w"]),
                                   rtol=2e-4, atol=2e-4)


def test_regression_task_batch_fn_validates_ids():
    """An out-of-range id must raise, not feed another server's shard."""
    topo = FLTopology(num_servers=3, clients_per_server=2, t_client=2,
                      t_server=1)
    task = make_regression_task(topo)
    bx, _ = task["batch_fn"](0, (0, 2))             # valid subset is fine
    np.testing.assert_array_equal(bx.numpy(),
                                  task["batches"][0][:, [0, 2]].numpy())
    with pytest.raises(ValueError, match="out of range"):
        task["batch_fn"](0, (0, 1, 2, 7))


@pytest.mark.parametrize("mode", ["collapsed", "exact_mean"])
def test_dynamic_consensus_modes_agree_with_static(mode):
    """Dynamic 'collapsed' builds A^{T_S} from the per-epoch matrix; with
    the static A it matches the static step (f32 tolerance)."""
    topo, loss_fn, batches, _ = _setup(m=4, n=3, t_c=6, t_s=5)
    opt = sgd(1e-3)
    step_s = build_dfl_epoch_step(
        DFLConfig(topology=topo, consensus_mode=mode), loss_fn, opt)
    step_d = build_dfl_epoch_step(
        DFLConfig(topology=topo, consensus_mode=mode, dynamic=True),
        loss_fn, opt)
    out_s, _ = step_s(init_dfl_state(DFLConfig(topology=topo),
                                     torch.zeros(2), opt), batches)
    out_d, _ = step_d(init_dfl_state(DFLConfig(topology=topo),
                                     torch.zeros(2), opt), batches,
                      _sched(np.ones((4, 3)), topo.mixing_matrix()))
    np.testing.assert_allclose(out_s.client_params.numpy(),
                               out_d.client_params.numpy(),
                               rtol=2e-5, atol=2e-6)


def test_pipeline_server_ids_slicing():
    """FLDataPipeline emits only the alive servers' shards, keyed by
    ORIGINAL identity (a rejoined server gets its own streams back)."""
    from repro_torch.data import DataConfig, FLDataPipeline
    topo = FLTopology(num_servers=4, clients_per_server=2, t_client=3,
                      t_server=1)
    cfg = DataConfig(seq_len=16, per_client_batch=2, vocab_size=64, seed=0)
    pipe = FLDataPipeline(topo, cfg)
    full = pipe.epoch_batches(0)
    sub = pipe.epoch_batches(0, server_ids=(0, 2, 3))
    np.testing.assert_array_equal(full["tokens"][:, [0, 2, 3]].numpy(),
                                  sub["tokens"].numpy())
    with pytest.raises(ValueError, match="out of range"):
        pipe.epoch_batches(0, server_ids=(0, 9))


def test_lm_smoke_engine_epoch_matches_reference():
    """One engine epoch of the SmolLM smoke config (M = 3 ring, N = 2)
    with a drop at epoch 0, partial participation and an edge-dropped A_p,
    on carried weights and the port's tokens, against the reference's
    engine (test_torch_train.py's tolerance)."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import transformer as jtf
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, FLDataPipeline
    from repro_torch.models import transformer as ttf
    arch = "smollm-360m"
    shape = dict(num_servers=4, clients_per_server=2, t_client=2,
                 t_server=3, graph_kind="ring")
    scen = dict(participation=dict(kind="bernoulli", rate=0.5, seed=1),
                topology=dict(kind="edge_drop", drop_prob=0.3, seed=2),
                faults="drop:0:2")
    jcfg = j_get_smoke(arch)
    jparams = jtf.init_params(jax.random.key(7), jcfg)
    pipe = FLDataPipeline(FLTopology(**shape), DataConfig(
        seq_len=16, per_client_batch=2, vocab_size=jcfg.vocab_size, seed=0))

    def batch_fn(epoch, alive):
        return pipe.epoch_batches(epoch, server_ids=alive)

    topo = FLTopology(**shape)
    eng = make_engine(topo, ttf.make_loss_fn(get_smoke(arch)), sgd(0.05),
                      participation=ParticipationSchedule(
                          **scen["participation"]),
                      topology_schedule=TopologySchedule(**scen["topology"]),
                      faults=FaultSchedule.parse(scen["faults"]))
    st = init_dfl_state(eng.cfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jparams)), sgd(0.05))
    st, hist = eng.run(st, 1, batch_fn)
    jtopo = J.FLTopology(**shape)
    jeng = J.make_engine(
        jtopo, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)),
        j_sgd(0.05),
        participation=jsched.ParticipationSchedule(**scen["participation"]),
        topology_schedule=jsched.TopologySchedule(**scen["topology"]),
        faults=jsched.FaultSchedule.parse(scen["faults"]))
    jst = J.init_dfl_state(jeng.cfg, jparams, j_sgd(0.05), jax.random.key(1))
    jst, jhist = jeng.run(jst, 1, lambda e, alive: {
        "tokens": jnp.asarray(batch_fn(e, alive)["tokens"].numpy())})
    for key in ("num_servers", "participation", "sigma_prod"):
        assert hist[key] == jhist[key] == hist[key], key
    assert hist["num_servers"] == [3.0]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4,
                               atol=1e-4)
    for g, w in zip(tree_leaves(st.client_params),
                    jax.tree.leaves(jst.client_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
