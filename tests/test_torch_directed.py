"""Port parity for directed federation (push-sum): twins of the push-sum
rows of ``tests/test_directed_federation.py``, ``tests/test_consensus_
backends.py`` and ``tests/test_overlap.py`` on ``repro_torch``, plus the
reference on the same numpy-made inputs.  The topology rows are twinned in
``tests/test_torch_topology.py``.

The port mixes the numerator through kernel 1's plain version (on the
card, the kernel) with ``P = A'``; the ``(M,)`` weight is an f32 matvec.

Tolerances:
* schedules, topologies, ``SigmaTracker`` and the engine's ``num_servers``
  / ``sigma_prod`` columns: exact (numpy on both sides);
* push-sum primitives and backends: rtol/atol 2e-5 against the reference
  (its own tests' tolerance: f32 sums in another order); weights rtol
  2e-5 (a sum of M products each round);
* regression epoch steps and engines: rtol 1e-5, atol 1e-6 (the tolerance
  of ``tests/test_torch_dfl.py``), over more epochs 1e-4;
* the wires: codes are the reference's given the same dither, so the
  simulated wire's period is held at rtol 1e-5 / atol 1e-6 and the
  physical wire's bitwise; the EF residual within one rounding of ``q s``
  (the reference's push-sum program leaves ``c - q s`` unfused for some
  elements); the byte ledger exactly;
* bf16 leaves: ``ratio()``'s cast and division bitwise (one rounding in
  both); a bf16 period within T_S bf16 steps of the largest value of the
  reference's (kernel 1 keeps P in f32, the reference rounds P to bf16 —
  ROADMAP Queue 3), the bound ``tests/test_torch_consensus.py`` holds the
  bf16 backends to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro.data import RegressionSpec as JSpec  # noqa: E402
from repro.data import make_regression_task as j_task  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.core import (DFLConfig, EpochSchedule, FaultEvent,  # noqa: E402
                              FaultSchedule, FLTopology,
                              ParticipationSchedule, SigmaTracker,
                              TopologySchedule, build_dfl_epoch_step,
                              init_dfl_state, make_engine)
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core import topology as tp  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

M, T_S = 5, 7
CLOSE = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed_digraph(m=5):
    """Directed ring + a chord out of node 0: strongly connected, unequal
    out-degrees, so the out-degree matrix is row- but not doubly
    stochastic."""
    adj = tp.directed_ring(m)
    adj[0, 2] = True
    return adj


def _tree(m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, 4, 3)).astype(dtype),
            "b": rng.standard_normal((m, 7)).astype(dtype)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_tree_close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


def _assert_tree_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# push-sum primitives
# ---------------------------------------------------------------------------


def test_push_sum_unbiased_under_directed_weakening():
    """30 epochs of push-sum over weakened row-stochastic matrices: weights
    positive and summing to M every epoch, the ratio at the exact mean, and
    values and weights within 2e-5 of the reference's on the same trees."""
    topo = FLTopology(num_servers=5, clients_per_server=2, t_client=2,
                      t_server=6, graph_kind="ring", mixing="out_degree")
    sched = TopologySchedule(kind="asymmetric", drop_prob=0.4, weaken=0.8,
                             n_weak=3, seed=9)
    tree = _tree(5, 0)
    state, jstate = cns.init_push_sum(_t(tree)), jcns.init_push_sum(_j(tree))
    jpush = jax.jit(jcns.gossip_push_sum, static_argnums=2)
    for epoch in range(30):
        a = sched.mixing(topo, epoch)
        state = cns.gossip_push_sum(torch.tensor(a, dtype=torch.float32),
                                    state, topo.t_server)
        jstate = jpush(jnp.asarray(a, jnp.float32), jstate, topo.t_server)
        w = state.weight.numpy()
        assert (w > 0).all()
        np.testing.assert_allclose(w.sum(), 5.0, rtol=1e-5)
    np.testing.assert_allclose(state.weight.numpy(),
                               np.asarray(jstate.weight), rtol=2e-5)
    ratio = state.ratio()
    _assert_tree_close(ratio, jstate.ratio(), **CLOSE)
    for k in tree:
        want = np.broadcast_to(tree[k].mean(0), tree[k].shape)
        np.testing.assert_allclose(ratio[k].numpy(), want, rtol=2e-4,
                                   atol=2e-4)


def test_push_sum_matches_gossip_on_doubly_stochastic():
    """With Eq.-6 weights the weight stays 1 and the ratio is plain gossip;
    and the port's ratio is the reference's."""
    a = tp.metropolis_weights(tp.ring_graph(M))
    at = torch.tensor(a, dtype=torch.float32)
    tree = _tree(M, 1)
    ps = cns.gossip_push_sum(at, cns.init_push_sum(_t(tree)), 9)
    ref = cns.gossip_scan(at, _t(tree), 9)
    np.testing.assert_allclose(ps.weight.numpy(), 1.0, rtol=1e-5)
    _assert_tree_close(ps.ratio(), ref, **CLOSE)
    jps = jcns.gossip_push_sum(jnp.asarray(a, jnp.float32),
                               jcns.init_push_sum(_j(tree)), 9)
    _assert_tree_close(ps.ratio(), jps.ratio(), **CLOSE)


def test_push_sum_unbiased_where_naive_row_stochastic_is_biased():
    """On a skewed digraph naive gossip lands on the Perron-weighted pi'x,
    push-sum's ratio on the exact mean (200 rounds)."""
    a_np = tp.out_degree_weights(_skewed_digraph())
    pi = tp.perron_weights(a_np)
    a = torch.tensor(a_np, dtype=torch.float32)
    x = np.random.default_rng(2).standard_normal((5, 11)).astype(np.float32)
    mean, biased = x.mean(0), pi @ x
    gap = np.abs(biased - mean).max()
    assert gap > 0.01
    naive = cns.gossip_scan(a, {"w": torch.from_numpy(x)}, 200)["w"].numpy()
    np.testing.assert_allclose(naive, np.broadcast_to(biased, naive.shape),
                               atol=1e-4)
    assert np.abs(naive - mean).max() > 0.5 * gap
    ps = cns.gossip_push_sum(a, cns.init_push_sum({"w": torch.from_numpy(x)}),
                             200)
    ratio = ps.ratio()["w"].numpy()
    np.testing.assert_allclose(ratio, np.broadcast_to(mean, ratio.shape),
                               atol=1e-4)
    jps = jcns.gossip_push_sum(jnp.asarray(a_np, jnp.float32),
                               jcns.init_push_sum({"w": jnp.asarray(x)}), 200)
    np.testing.assert_allclose(ratio, np.asarray(jps.ratio()["w"]), **CLOSE)


def test_push_sum_weight_invariants_across_rounds():
    """Weights positive and summing to M, and the numerator's column sums
    kept, after every round count; weights as the reference's."""
    a_np = tp.out_degree_weights(_skewed_digraph())
    a = torch.tensor(a_np, dtype=torch.float32)
    x = np.random.default_rng(3).standard_normal((M, 3)).astype(np.float32)
    for t in range(1, 12):
        ps = cns.gossip_push_sum(a, cns.init_push_sum(
            {"w": torch.from_numpy(x)}), t)
        w = ps.weight.numpy()
        assert (w > 0).all(), (t, w)
        np.testing.assert_allclose(w.sum(), M, rtol=1e-5)
        np.testing.assert_allclose(ps.values["w"].numpy().sum(0), x.sum(0),
                                   rtol=1e-4, atol=1e-4)
        jw = jcns.gossip_push_sum(jnp.asarray(a_np, jnp.float32),
                                  jcns.init_push_sum({"w": jnp.asarray(x)}),
                                  t).weight
        np.testing.assert_allclose(w, np.asarray(jw), rtol=2e-5)


def test_push_sum_tv_matches_fixed_and_stays_unbiased():
    """A constant stack is the fixed-matrix period bitwise; 60 rounds of
    three alternating digraphs read out the exact mean."""
    a = torch.tensor(tp.out_degree_weights(_skewed_digraph()),
                     dtype=torch.float32)
    x = np.random.default_rng(4).standard_normal((M, 7)).astype(np.float32)
    tree = {"w": torch.from_numpy(x)}
    tv = cns.gossip_push_sum_tv(a.expand(6, M, M), cns.init_push_sum(tree))
    fixed = cns.gossip_push_sum(a, cns.init_push_sum(tree), 6)
    assert torch.equal(tv.weight, fixed.weight)
    assert torch.equal(tv.values["w"], fixed.values["w"])
    mats = [tp.out_degree_weights(_skewed_digraph()),
            tp.out_degree_weights(tp.directed_ring(M)),
            tp.out_degree_weights(tp.random_orientation(
                tp.complete_graph(M), np.random.default_rng(1)))]
    stack = np.stack([mats[i % 3] for i in range(60)])
    out = cns.gossip_push_sum_tv(torch.tensor(stack, dtype=torch.float32),
                                 cns.init_push_sum(tree))
    np.testing.assert_allclose(out.ratio()["w"].numpy(),
                               np.broadcast_to(x.mean(0), (M, 7)), atol=1e-4)
    jout = jcns.gossip_push_sum_tv(jnp.asarray(stack, jnp.float32),
                                   jcns.init_push_sum({"w": jnp.asarray(x)}))
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(jout.weight),
                               rtol=2e-5)
    np.testing.assert_allclose(out.ratio()["w"].numpy(),
                               np.asarray(jout.ratio()["w"]), **CLOSE)
    # an empty stack is the identity
    assert cns.gossip_push_sum_tv(a[None][:0], cns.init_push_sum(tree)) \
        .values is tree


def test_sigma_tracker_push_sum_mode():
    a = tp.out_degree_weights(_skewed_digraph())
    tr, jtr = SigmaTracker(5, mode="push_sum"), J.SigmaTracker(
        5, mode="push_sum")
    sig = [tr.update(a, 10) for _ in range(3)]
    assert sig == [jtr.update(a, 10) for _ in range(3)]
    assert sig[0] > sig[1] > sig[2]
    assert sig[-1] == pytest.approx(tp.sigma_push_sum(a, 30), abs=1e-9)
    assert SigmaTracker(5, mode="average").update(a, 30) > 0.1
    with pytest.raises(ValueError, match="mode"):
        SigmaTracker(5, mode="bogus")


def test_ratio_casts_the_weight_to_a_bf16_leaf():
    """``ratio()`` casts the weight to the leaf dtype before it divides, as
    the reference's: bitwise on bf16 numerators; the cast matters (an f32
    weight gives another rounding)."""
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((M, 33)).astype(np.float32)
    weight = (0.3 + rng.random(M)).astype(np.float32)
    got = cns.PushSumState({"w": torch.from_numpy(vals).to(torch.bfloat16)},
                           torch.from_numpy(weight)).ratio()["w"]
    want = jcns.PushSumState({"w": jnp.asarray(vals, jnp.bfloat16)},
                             jnp.asarray(weight)).ratio()["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    uncast = (torch.from_numpy(vals).to(torch.bfloat16).float()
              / torch.from_numpy(weight)[:, None]).to(torch.bfloat16)
    assert not torch.equal(got, uncast)


def test_bf16_push_sum_period_within_t_s_bf16_steps():
    """A bf16 tree through push-sum: the numerator within T_S bf16 steps of
    the reference's (P kept in f32 by kernel 1, rounded to bf16 by the
    reference), the weights equal (f32 in both)."""
    a = tp.out_degree_weights(_skewed_digraph())
    tree = _tree(M, 6)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tree.items()}
    ps = cns.gossip_push_sum(torch.tensor(a, dtype=torch.float32),
                             cns.init_push_sum(bf), T_S)
    jps = jcns.gossip_push_sum(
        jnp.asarray(a, jnp.float32),
        jcns.init_push_sum({k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in tree.items()}), T_S)
    np.testing.assert_allclose(ps.weight.numpy(), np.asarray(jps.weight),
                               rtol=2e-5)
    want = {k: np.asarray(v.astype(jnp.float32))
            for k, v in jps.values.items()}
    top = max(float(np.abs(x).max()) for x in [*tree.values(),
                                                 *want.values()])
    for k in tree:
        assert ps.values[k].dtype == torch.bfloat16
        np.testing.assert_allclose(ps.values[k].float().numpy(), want[k],
                                   rtol=0, atol=T_S * 2.0 ** -8 * top,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the backends
# ---------------------------------------------------------------------------


def _backends(a_np):
    return {
        "gossip": cns.make_backend("gossip", a_np, T_S),
        "gossip_blocked": cns.make_backend("gossip_blocked", a_np, T_S,
                                           block=5),
        "collapsed": cns.make_backend("collapsed", a_np, T_S),
        "compressed_identity": cns.make_backend(
            "gossip", a_np, T_S, compression="identity",
            error_feedback=True),
    }


def test_backends_push_sum_match_reference_asymmetric():
    """``mix_push_sum`` of every backend under the asymmetric schedule's
    row-stochastic A_p (and under the static matrix) against the
    reference's ``gossip_push_sum``: weights, ratio, invariants."""
    topo = FLTopology(num_servers=M, clients_per_server=2, t_client=2,
                      t_server=T_S, graph_kind="ring", mixing="out_degree")
    sched = TopologySchedule(kind="asymmetric", drop_prob=0.4, seed=5)
    tree = _tree(M, 7)
    backends = _backends(tp.out_degree_weights(_skewed_digraph()))
    mats = [(sched.mixing(topo, e), True) for e in range(3)] + [
        (tp.out_degree_weights(_skewed_digraph()), False)]
    for a_np, per_epoch in mats:
        tp.check_row_stochastic(a_np, atol=1e-6)
        ref = jcns.gossip_push_sum(jnp.asarray(a_np, jnp.float32),
                                   jcns.init_push_sum(_j(tree)), T_S)
        a_p = torch.tensor(a_np, dtype=torch.float32) if per_epoch else None
        for name, backend in backends.items():
            out = backend.mix_push_sum(cns.init_push_sum(_t(tree)), a_p)
            np.testing.assert_allclose(out.weight.numpy(),
                                       np.asarray(ref.weight), rtol=2e-5,
                                       atol=2e-6, err_msg=name)
            _assert_tree_close(out.ratio(), ref.ratio(), **CLOSE)
            w = out.weight.numpy()
            assert (w > 0).all(), (name, w)
            np.testing.assert_allclose(w.sum(), M, rtol=1e-5)


def test_gossip_push_sum_blocked_function():
    """The blocked function (blocks of 3 over leaves of 12 and 7) against
    the reference's and the unblocked period; T_S = 0 is the identity."""
    a_np = tp.out_degree_weights(tp.directed_ring(M))
    a = torch.tensor(a_np, dtype=torch.float32)
    tree = _tree(M, 8)
    out = cns.gossip_push_sum_blocked(a, cns.init_push_sum(_t(tree)), T_S,
                                      block=3)
    flat = cns.gossip_push_sum(a, cns.init_push_sum(_t(tree)), T_S)
    _assert_tree_close(out.values, flat.values, **CLOSE)
    jout = jcns.gossip_push_sum_blocked(jnp.asarray(a_np, jnp.float32),
                                        jcns.init_push_sum(_j(tree)), T_S,
                                        block=3)
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(jout.weight),
                               rtol=2e-5)
    _assert_tree_close(out.values, jout.values, **CLOSE)
    same = cns.gossip_push_sum_blocked(a, cns.init_push_sum(_t(tree)), 0)
    np.testing.assert_array_equal(same.values["w"].numpy(), tree["w"])


def test_push_sum_refusals_match_reference():
    """Chebyshev and exact_mean have no ratio-consensus analogue; staleness
    has no push-sum form (the reference's ValueErrors)."""
    a_np = tp.metropolis_weights(tp.ring_graph(3))
    state = cns.init_push_sum({"w": torch.zeros((3, 2))})
    for mode in ("chebyshev", "exact_mean"):
        backend = cns.make_backend(mode, a_np, 2)
        assert not backend.supports_directed
        with pytest.raises(ValueError, match="ratio-consensus"):
            backend.mix_push_sum(state)
        with pytest.raises(ValueError, match="ratio-consensus"):
            cns.make_backend(mode, a_np, 2, compression="int8") \
                .mix_push_sum(state)
    with pytest.raises(ValueError, match="staleness"):
        cns.make_backend("gossip", a_np, 2, staleness=1).mix_push_sum(state)
    with pytest.raises(ValueError, match="staleness"):
        jcns.make_backend("gossip", a_np, 2, staleness=1).mix_push_sum(
            jcns.init_push_sum({"w": jnp.zeros((3, 2))}))


@pytest.mark.parametrize("wire,ef", [("simulated", False),
                                     ("simulated", True),
                                     ("physical", True)])
def test_compressed_push_sum_matches_reference(wire, ef):
    """``mix_push_sum_compressed`` on both wires (int8, chunk 16) against
    the reference's: the numerator's message rides the wire under P (the
    simulated wire's kernel 4 fuses its round trip with P), the weight is
    exact.  Simulated: values at rtol 1e-5, the EF residual within one
    rounding of ``q s``; physical: values and residual bitwise."""
    m = 4
    a_np = tp.out_degree_weights(tp.build_graph("random_orientation", m))
    tree = _tree(m, 9)
    res0 = {k: v * 0.01 for k, v in _tree(m, 10).items()}
    kw = dict(compression="int8:16", error_feedback=ef, wire=wire,
              block=1024)
    jbe = jcns.make_backend("gossip", a_np, 3, **kw)
    tbe = cns.make_backend("gossip", a_np, 3, **kw)
    assert tbe.name == jbe.name
    jres = _j(res0) if ef else None
    tres = _t(res0) if ef else None
    (jps, jnew) = jax.jit(lambda t, r: jbe.mix_push_sum_compressed(
        jcns.init_push_sum(t), residual=r, key=jax.random.key(4)))(
        _j(tree), jres)
    ps, tnew = tbe.mix_push_sum_compressed(cns.init_push_sum(_t(tree)),
                                           residual=tres, key=prng.key(4))
    np.testing.assert_array_equal(ps.weight.numpy(), np.asarray(jps.weight))
    eps = float(np.finfo(np.float32).eps)
    if ef:
        # inside this program XLA leaves ``c - q s`` unfused for some
        # elements (the port rounds it once): one rounding of q s
        for k in tree:
            np.testing.assert_allclose(
                tnew[k].numpy(), np.asarray(jnew[k]), rtol=0,
                atol=eps * float(np.abs(tree[k] + res0[k]).max()))
    if wire == "physical":
        for k in tree:
            np.testing.assert_array_equal(ps.values[k].numpy(),
                                          np.asarray(jps.values[k]))
        return
    _assert_tree_close(ps.values, jps.values, **TOL)
    # the plain interface is the period without EF and with deterministic
    # rounding
    plain = tbe.mix_push_sum(cns.init_push_sum(_t(tree)))
    jplain = jbe.mix_push_sum(jcns.init_push_sum(_j(tree)))
    _assert_tree_close(plain.values, jplain.values, **TOL)


def test_simulated_push_sum_fuses_p_into_kernel_4():
    """On the simulated wire the quantizer's round trip and the first
    operator P run as one kernel-4 pass a leaf (then T_S - 1 rounds of
    P), which equals the unfused period: the decoded message, then T_S
    rounds of P."""
    m = 4
    a_np = tp.out_degree_weights(tp.build_graph("random_orientation", m))
    tree = _tree(m, 11)
    be = cns.make_backend("gossip", a_np, 3, compression="int8:16")
    seen = []
    real = ops.quantized_consensus_mix

    def spy(a, w, *args, **kw):
        seen.append(a.clone())
        return real(a, w, *args, **kw)

    ops.quantized_consensus_mix = spy
    try:
        ps = be.mix_push_sum(cns.init_push_sum(_t(tree)))
    finally:
        ops.quantized_consensus_mix = real
    p = torch.tensor(a_np, dtype=torch.float32).T
    assert len(seen) == len(tree)
    assert all(torch.equal(s.to(p.dtype), p) for s in seen)
    from repro_torch.comm.compressors import roundtrip_tree
    msg = roundtrip_tree(be.compressor, _t(tree), None)
    want = cns.gossip_scan(p.contiguous(), msg, 3)
    _assert_tree_close(ps.values, want, **TOL)


# ---------------------------------------------------------------------------
# DFLConfig(mixing="push_sum"): the epoch steps
# ---------------------------------------------------------------------------


def _directed_topo(t_c=5, t_s=8, j=False):
    kw = dict(num_servers=5, clients_per_server=3, t_client=t_c,
              t_server=t_s, graph_kind="random_orientation",
              mixing="out_degree")
    return J.FLTopology(**kw) if j else FLTopology(**kw)


def test_mixing_validation():
    topo = _directed_topo()
    loss = make_regression_task(topo)["loss_fn"]
    with pytest.raises(ValueError, match="unknown mixing"):
        build_dfl_epoch_step(DFLConfig(topology=topo, mixing="bogus"), loss,
                             sgd(1e-3))
    with pytest.raises(ValueError, match="Perron-weighted"):
        build_dfl_epoch_step(DFLConfig(topology=topo), loss, sgd(1e-3))
    for mode in ("chebyshev", "exact_mean"):
        with pytest.raises(ValueError, match="undefined"):
            build_dfl_epoch_step(DFLConfig(topology=topo, mixing="push_sum",
                                           consensus_mode=mode), loss,
                                 sgd(1e-3))
    with pytest.raises(ValueError, match="asymmetric"):
        make_engine(FLTopology(num_servers=3, clients_per_server=2,
                               t_client=2, t_server=2), loss, sgd(1e-3),
                    topology_schedule=TopologySchedule(kind="asymmetric",
                                                       drop_prob=0.3))


def _j_steps(jtopo, mixing, mode="gossip", dynamic=False, **kw):
    jt = j_task(jtopo, JSpec(**kw.pop("spec", {})), seed=kw.pop("seed", 0))
    gamma = kw.pop("gamma", 1e-3)
    cfg = J.DFLConfig(topology=jtopo, mixing=mixing, consensus_mode=mode,
                      dynamic=dynamic, **kw)
    step = jax.jit(J.build_dfl_epoch_step(cfg, jt["loss_fn"], j_sgd(gamma)))
    state = J.init_dfl_state(cfg, jnp.zeros((2,)), j_sgd(gamma),
                             jax.random.key(0))
    return step, state, jt


def test_push_sum_epoch_step_matches_symmetric_on_undirected():
    """mixing='push_sum' over a doubly-stochastic topology is the symmetric
    step with unit weights; and the port's push-sum step is the
    reference's."""
    kw = dict(num_servers=4, clients_per_server=3, t_client=5, t_server=6,
              graph_kind="ring")
    topo = FLTopology(**kw)
    task = make_regression_task(topo, seed=0)
    opt = sgd(1e-3)
    step_sym = build_dfl_epoch_step(DFLConfig(topology=topo),
                                    task["loss_fn"], opt)
    cfg_ps = DFLConfig(topology=topo, mixing="push_sum")
    step_ps = build_dfl_epoch_step(cfg_ps, task["loss_fn"], opt)
    st_sym = init_dfl_state(DFLConfig(topology=topo), torch.zeros(2), opt)
    st_ps = init_dfl_state(cfg_ps, torch.zeros(2), opt)
    assert tuple(st_ps.psum_weight.shape) == (4,) and st_sym.psum_weight \
        is None
    jstep, jst, jt = _j_steps(J.FLTopology(**kw), "push_sum")
    for _ in range(3):
        st_sym, _ = step_sym(st_sym, task["batches"])
        st_ps, _ = step_ps(st_ps, task["batches"])
        jst, _ = jstep(jst, jt["batches"])
    np.testing.assert_allclose(st_ps.client_params.numpy(),
                               st_sym.client_params.numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(st_ps.psum_weight.numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(st_ps.client_params.numpy(),
                               np.asarray(jst.client_params), **TOL)
    np.testing.assert_allclose(st_ps.psum_weight.numpy(),
                               np.asarray(jst.psum_weight), rtol=1e-5)


def test_push_sum_collapsed_matches_gossip_rounds():
    """consensus_mode='collapsed' (one round of A^{T_S}) equals the T_S
    rounds under push-sum, on a directed topology; each against the
    reference's step."""
    topo = _directed_topo()
    task = make_regression_task(topo, seed=1)
    opt = sgd(1e-3)
    outs = {}
    for mode in ("gossip", "collapsed"):
        cfg = DFLConfig(topology=topo, mixing="push_sum", consensus_mode=mode)
        st = init_dfl_state(cfg, torch.zeros(2), opt)
        st, _ = build_dfl_epoch_step(cfg, task["loss_fn"], opt)(
            st, task["batches"])
        outs[mode] = st
        jstep, jst, jt = _j_steps(_directed_topo(j=True), "push_sum", mode,
                                  seed=1)
        jst, _ = jstep(jst, jt["batches"])
        np.testing.assert_allclose(st.client_params.numpy(),
                                   np.asarray(jst.client_params), **TOL)
        np.testing.assert_allclose(st.psum_weight.numpy(),
                                   np.asarray(jst.psum_weight), rtol=2e-5)
    np.testing.assert_allclose(outs["gossip"].client_params.numpy(),
                               outs["collapsed"].client_params.numpy(),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(outs["gossip"].psum_weight.numpy(),
                               outs["collapsed"].psum_weight.numpy(),
                               rtol=2e-5)


def test_dfl_bias_end_to_end():
    """Through the whole step with per-server concept shift (60 epochs):
    naive row-stochastic training is biased away from w*, push-sum is not;
    the push-sum run's servers within 1e-4 of the reference's."""
    topo = FLTopology(num_servers=5, clients_per_server=3, t_client=15,
                      t_server=25, graph_kind="random_orientation",
                      mixing="out_degree")
    task = make_regression_task(topo, RegressionSpec(concept_shift=2.0),
                                seed=0)
    gamma = 0.4 / (9.0 * topo.t_client)
    errs, finals = {}, {}
    for mixing in ("push_sum", "row_stochastic"):
        cfg = DFLConfig(topology=topo, mixing=mixing)
        step = build_dfl_epoch_step(cfg, task["loss_fn"], sgd(gamma))
        st = init_dfl_state(cfg, torch.zeros(2), sgd(gamma))
        for _ in range(60):
            st, _ = step(st, task["batches"])
        finals[mixing] = st.client_params[:, 0].numpy()
        errs[mixing] = float(np.linalg.norm(
            finals[mixing] - task["w_star"], axis=-1).max())
    assert errs["row_stochastic"] > 1.5 * errs["push_sum"], errs
    assert errs["push_sum"] < 0.2, errs
    jtopo = J.FLTopology(num_servers=5, clients_per_server=3, t_client=15,
                         t_server=25, graph_kind="random_orientation",
                         mixing="out_degree")
    jstep, jst, jt = _j_steps(jtopo, "push_sum", gamma=gamma,
                              spec=dict(concept_shift=2.0))
    for _ in range(60):
        jst, _ = jstep(jst, jt["batches"])
    np.testing.assert_allclose(finals["push_sum"],
                               np.asarray(jst.client_params[:, 0]),
                               rtol=1e-4, atol=1e-5)


def test_compressed_push_sum_epoch_steps_match_reference():
    """The static push-sum step on each wire (int8; simulated and physical
    with error feedback) against the reference's, two epochs: parameters,
    weights, the EF residual."""
    kw = dict(num_servers=4, clients_per_server=2, t_client=3, t_server=4,
              graph_kind="random_orientation", mixing="out_degree")
    topo = FLTopology(**kw)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    for wire in ("simulated", "physical"):
        wkw = dict(compression="int8", error_feedback=True, wire=wire)
        cfg = DFLConfig(topology=topo, mixing="push_sum", **wkw)
        step = build_dfl_epoch_step(cfg, task["loss_fn"], sgd(1e-2))
        st = init_dfl_state(cfg, torch.zeros(2), sgd(1e-2),
                            wire_key=prng.key(0))
        jstep, jst, jt = _j_steps(J.FLTopology(**kw), "push_sum",
                                  gamma=1e-2, spec=dict(heterogeneity=0.5),
                                  **wkw)
        for _ in range(2):
            st, _ = step(st, task["batches"])
            jst, _ = jstep(jst, jt["batches"])
        np.testing.assert_allclose(st.client_params.numpy(),
                                   np.asarray(jst.client_params), **TOL,
                                   err_msg=wire)
        np.testing.assert_allclose(st.psum_weight.numpy(),
                                   np.asarray(jst.psum_weight), rtol=1e-6,
                                   err_msg=wire)
        np.testing.assert_allclose(st.ef_residual.numpy(),
                                   np.asarray(jst.ef_residual), rtol=1e-5,
                                   atol=1e-6, err_msg=wire)


@pytest.mark.parametrize("mixing", ["symmetric", "push_sum"])
def test_dynamic_blocked_epoch_step_matches_gossip(mixing):
    """The dynamic step on gossip_blocked agrees with gossip under per-epoch
    A_p (asymmetric under push-sum); each against the reference's."""
    kw = dict(num_servers=4, clients_per_server=3, t_client=5, t_server=6,
              graph_kind="ring")
    topo = FLTopology(**kw)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    kind = "asymmetric" if mixing == "push_sum" else "edge_drop"
    base = FLTopology(**{**kw, "mixing": "out_degree" if kind == "asymmetric"
                         else "metropolis"})
    mats = [TopologySchedule(kind=kind, drop_prob=0.4, seed=2).mixing(base, e)
            for e in range(3)]
    mask = np.ones((4, 3), np.float32)
    states = {}
    for mode in ("gossip", "gossip_blocked"):
        cfg = DFLConfig(topology=topo, consensus_mode=mode, dynamic=True,
                        mixing=mixing)
        step = build_dfl_epoch_step(cfg, task["loss_fn"], sgd(1e-3))
        st = init_dfl_state(cfg, torch.zeros(2), sgd(1e-3))
        jstep, jst, jt = _j_steps(J.FLTopology(**kw), mixing, mode,
                                  dynamic=True, spec=dict(heterogeneity=0.5))
        for a in mats:
            st, _ = step(st, task["batches"], EpochSchedule(
                torch.from_numpy(mask), torch.tensor(a, dtype=torch.float32)))
            jst, _ = jstep(jst, jt["batches"], J.EpochSchedule(
                jnp.asarray(mask), jnp.asarray(a, jnp.float32)))
        np.testing.assert_allclose(st.client_params.numpy(),
                                   np.asarray(jst.client_params), **TOL)
        if mixing == "push_sum":
            np.testing.assert_allclose(st.psum_weight.numpy(),
                                       np.asarray(jst.psum_weight),
                                       rtol=2e-5)
        states[mode] = st
    np.testing.assert_allclose(states["gossip_blocked"].client_params.numpy(),
                               states["gossip"].client_params.numpy(),
                               rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the engine: asymmetric schedules, weight reset on surgery, the superepoch
# ---------------------------------------------------------------------------


def test_engine_asymmetric_push_sum_converges():
    """60 epochs under per-epoch direction drops: near w*, the push-sum
    tracker, weights in (0, 1]; history and servers as the reference's."""
    kw = dict(num_servers=5, clients_per_server=3, t_client=15, t_server=12,
              graph_kind="ring")
    base = FLTopology(**kw)
    task = make_regression_task(base, seed=0)
    gamma = 0.4 / (9.0 * base.t_client)
    engine = make_engine(base, task["loss_fn"], sgd(gamma),
                         mixing="push_sum",
                         topology_schedule=TopologySchedule(
                             kind="asymmetric", drop_prob=0.4, seed=7))
    state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(gamma))
    state, hist = engine.run(state, 60, task["batch_fn"])
    servers = state.client_params[:, 0].numpy()
    err = float(np.linalg.norm(servers - task["w_star"], axis=-1).max())
    assert err < 0.3, err
    assert hist["sigma_prod"][-1] < 1e-6
    assert 0.0 < hist["psum_min_weight"][-1] <= 1.0 + 1e-6
    jt = j_task(J.FLTopology(**kw), seed=0)
    jeng = J.make_engine(J.FLTopology(**kw), jt["loss_fn"], j_sgd(gamma),
                         mixing="push_sum",
                         topology_schedule=J.TopologySchedule(
                             kind="asymmetric", drop_prob=0.4, seed=7))
    jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(gamma),
                           jax.random.key(0))
    jst, jhist = jeng.run(jst, 60, jt["batch_fn"])
    assert hist["sigma_prod"] == jhist["sigma_prod"]
    np.testing.assert_allclose(hist["psum_min_weight"],
                               jhist["psum_min_weight"], rtol=1e-5)
    np.testing.assert_allclose(servers, np.asarray(jst.client_params[:, 0]),
                               rtol=1e-4, atol=1e-5)


def test_engine_drop_rejoin_resets_push_sum_weight():
    """Surgery resets the weights to ones at the new M (new tensors), the
    tracker is rebuilt in push_sum mode; after the rejoin the weights are
    positive and sum to M; the whole run as the reference's."""
    kw = dict(num_servers=4, clients_per_server=2, t_client=4, t_server=6,
              graph_kind="ring")
    base = FLTopology(**kw)
    task = make_regression_task(base, seed=0)
    faults = ((2, "drop", 1), (4, "rejoin", 1))
    engine = make_engine(base, task["loss_fn"], sgd(1e-3),
                         mixing="push_sum",
                         topology_schedule=TopologySchedule(
                             kind="asymmetric", drop_prob=0.5, seed=3),
                         faults=FaultSchedule(tuple(FaultEvent(*f)
                                                    for f in faults)))
    state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(1e-3))
    for epoch in range(2):
        state, _ = engine.run_epoch(state, epoch, task["batch_fn"])
    assert tuple(state.psum_weight.shape) == (4,)
    surgically = engine.apply_faults(state, 2)
    assert tuple(surgically.psum_weight.shape) == (3,)
    assert torch.equal(surgically.psum_weight, torch.ones(3))
    assert engine.alive == [0, 2, 3]
    assert engine._tracker.mode == "push_sum" and engine._tracker.m == 3
    for epoch in range(3, 6):
        state, _ = engine.run_epoch(surgically if epoch == 3 else state,
                                    epoch, task["batch_fn"])
    assert engine.alive == [0, 2, 3, 1]
    w = state.psum_weight.numpy()
    assert w.shape == (4,) and (w > 0).all()
    np.testing.assert_allclose(w.sum(), 4.0, rtol=1e-5)
    jt = j_task(J.FLTopology(**kw), seed=0)
    jeng = J.make_engine(J.FLTopology(**kw), jt["loss_fn"], j_sgd(1e-3),
                         mixing="push_sum",
                         topology_schedule=J.TopologySchedule(
                             kind="asymmetric", drop_prob=0.5, seed=3),
                         faults=J.FaultSchedule(tuple(J.FaultEvent(*f)
                                                      for f in faults)))
    jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(1e-3),
                           jax.random.key(0))
    for epoch in range(6):      # the same epochs: 2 is surgery alone
        if epoch == 2:
            jst = jeng.apply_faults(jst, 2)
        else:
            jst, _ = jeng.run_epoch(jst, epoch, jt["batch_fn"])
    np.testing.assert_allclose(w, np.asarray(jst.psum_weight), rtol=1e-5)
    np.testing.assert_allclose(state.client_params.numpy(),
                               np.asarray(jst.client_params), **TOL)


def test_engine_push_sum_blocked_weight_invariants_across_surgery():
    """On gossip_blocked through drop and rejoin: weights of the live M,
    positive, summing to M after every epoch, ``psum_min_weight`` > 0;
    surgery resets doubled weights to ones."""
    topo = FLTopology(num_servers=4, clients_per_server=2, t_client=3,
                      t_server=6, graph_kind="ring")
    task = make_regression_task(topo, seed=0)
    engine = make_engine(
        topo, task["loss_fn"], sgd(1e-3), consensus_mode="gossip_blocked",
        mixing="push_sum",
        topology_schedule=TopologySchedule(kind="asymmetric", drop_prob=0.5,
                                           seed=3),
        faults=FaultSchedule((FaultEvent(1, "drop", 2),
                              FaultEvent(3, "rejoin", 2))))
    state = init_dfl_state(engine.cfg, torch.zeros(2), sgd(1e-3))
    for epoch in range(5):
        state, rec = engine.run_epoch(state, epoch, task["batch_fn"])
        m_live = engine.topo.num_servers
        w = state.psum_weight.numpy()
        assert w.shape == (m_live,)
        assert (w > 0).all(), (epoch, w)
        np.testing.assert_allclose(w.sum(), m_live, rtol=1e-5)
        assert rec["psum_min_weight"] > 0
    fresh = engine.apply_faults(
        state._replace(psum_weight=state.psum_weight * 2.0), 1)
    assert torch.equal(fresh.psum_weight, torch.ones(engine.topo.num_servers))


def test_engine_push_sum_blocked_and_gossip_agree_with_reference():
    """The reference's mesh-backend scenario on the port's single-process
    backends: push-sum over asymmetric A_p with Bernoulli(0.7)
    participation, gossip and gossip_blocked against the reference's gossip
    engine (3 epochs, M = 4)."""
    kw = dict(num_servers=4, clients_per_server=2, t_client=4, t_server=5,
              graph_kind="ring", mixing="out_degree")
    task = make_regression_task(FLTopology(**kw),
                                RegressionSpec(heterogeneity=0.5), seed=0)
    scen = dict(participation=dict(kind="bernoulli", rate=0.7, seed=1),
                topology=dict(kind="asymmetric", drop_prob=0.4, seed=3))
    jt = j_task(J.FLTopology(**kw), JSpec(heterogeneity=0.5), seed=0)
    jeng = J.make_engine(
        J.FLTopology(**kw), jt["loss_fn"], j_sgd(1e-3), mixing="push_sum",
        participation=J.ParticipationSchedule(**scen["participation"]),
        topology_schedule=J.TopologySchedule(**scen["topology"]))
    jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(1e-3),
                           jax.random.key(0))
    jst, jhist = jeng.run(jst, 3, jt["batch_fn"])
    for mode in ("gossip", "gossip_blocked"):
        eng = make_engine(
            FLTopology(**kw), task["loss_fn"], sgd(1e-3), mixing="push_sum",
            consensus_mode=mode,
            participation=ParticipationSchedule(**scen["participation"]),
            topology_schedule=TopologySchedule(**scen["topology"]))
        st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(1e-3))
        st, hist = eng.run(st, 3, task["batch_fn"])
        w = st.psum_weight.numpy()
        assert (w > 0).all() and abs(w.sum() - 4) < 1e-3, w
        assert hist["sigma_prod"] == jhist["sigma_prod"]
        assert hist["participation"] == jhist["participation"]
        np.testing.assert_allclose(st.client_params.numpy(),
                                   np.asarray(jst.client_params), **TOL,
                                   err_msg=mode)
        np.testing.assert_allclose(hist["psum_min_weight"],
                                   jhist["psum_min_weight"], rtol=1e-5)


def test_engine_wire_ledger_counts_the_weight_on_the_simulated_wire():
    """Under push-sum the simulated wire's ledger counts each message's f32
    weight (+4 bytes), the physical wire's does not; both as the
    reference's engine counts them."""
    kw = dict(num_servers=4, clients_per_server=2, t_client=2, t_server=3,
              graph_kind="ring")
    task = make_regression_task(FLTopology(**kw), seed=0)
    jt = j_task(J.FLTopology(**kw), seed=0)
    tsched = dict(kind="asymmetric", drop_prob=0.3, seed=1)
    for wire in ("simulated", "physical"):
        mb = {}
        for mixing in ("row_stochastic", "push_sum"):
            wkw = dict(compression="int8", wire=wire, mixing=mixing)
            eng = make_engine(FLTopology(**kw), task["loss_fn"], sgd(1e-3),
                              topology_schedule=TopologySchedule(**tsched),
                              **wkw)
            st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(1e-3),
                                wire_key=prng.key(0))
            _, hist = eng.run(st, 2, task["batch_fn"])
            jeng = J.make_engine(J.FLTopology(**kw), jt["loss_fn"],
                                 j_sgd(1e-3),
                                 topology_schedule=J.TopologySchedule(
                                     **tsched), **wkw)
            jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(1e-3),
                                   jax.random.key(0))
            _, jhist = jeng.run(jst, 2, jt["batch_fn"])
            assert hist["wire_mb"] == jhist["wire_mb"], (wire, mixing)
            assert hist["wire_ratio"] == jhist["wire_ratio"], (wire, mixing)
            mb[mixing] = hist["wire_mb"]
        if wire == "simulated":
            assert all(p > r for p, r in zip(mb["push_sum"],
                                              mb["row_stochastic"]))
        else:
            assert mb["push_sum"] == mb["row_stochastic"]


def _superepoch_engine(k, kind, seed=0):
    topo = FLTopology(num_servers=4, clients_per_server=3, t_client=3,
                      t_server=4, graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.3),
                                seed=seed)
    eng = make_engine(
        topo, task["loss_fn"], sgd(1e-2), mixing="push_sum",
        participation=ParticipationSchedule(kind="bernoulli", rate=0.6,
                                            seed=seed + 3),
        topology_schedule=TopologySchedule(kind=kind, drop_prob=0.3,
                                           seed=seed + 5),
        superepoch=k)
    return eng, init_dfl_state(eng.cfg, torch.zeros(2), sgd(1e-2)), \
        task["batch_fn"]


@pytest.mark.parametrize("kind", ["edge_drop", "asymmetric"])
def test_superepoch_parity_push_sum(kind):
    """The K-epoch dispatch carries the per-epoch push-sum weight: K = 3
    gives the per-epoch history (psum_min_weight included) and state
    bitwise, and the (K, M) trace's last row is the state's weight."""
    eng1, st1, bf1 = _superepoch_engine(1, kind)
    st1, h1 = eng1.run(st1, 6, bf1)
    eng3, st3, bf3 = _superepoch_engine(3, kind)
    st3, h3 = eng3.run(st3, 6, bf3)
    assert set(h1) == set(h3) and "psum_min_weight" in h1
    for key in h1:
        assert h1[key] == h3[key], key
    _assert_tree_equal(st1.client_params, st3.client_params)
    assert torch.equal(st1.psum_weight, st3.psum_weight)
    step = eng3._super_step(3)
    sb_state = init_dfl_state(eng3.cfg, torch.zeros(2), sgd(1e-2))
    plans = [eng3._plan_epoch(e)[0] for e in range(3)]
    from repro_torch.core.overlap import (EpochScheduleBatch,
                                          stack_epoch_schedules)
    sched = EpochScheduleBatch(*(None if x is None else torch.as_tensor(x)
                                 for x in stack_epoch_schedules(plans)))
    batches = tuple(torch.stack([bf3(e, tuple(eng3.alive))[i]
                                 for e in range(3)]) for i in range(2))
    out, _, psw = step(sb_state, batches, sched)
    assert tuple(psw.shape) == (3, 4)
    assert torch.equal(psw[-1], out.psum_weight)


def test_one_device_get_per_dispatch_under_push_sum():
    """The metrics and the push-sum weight come back in ONE read-back a
    dispatch: once an epoch, once a K-epoch block."""
    for superepoch, epochs, dispatches in ((1, 6, 6), (3, 6, 2), (6, 6, 1)):
        eng, st, bf = _superepoch_engine(superepoch, "asymmetric")
        calls = []
        real = eng._device_get
        eng._device_get = lambda x: (calls.append(1), real(x))[1]
        eng.run(st, epochs, bf)
        assert len(calls) == dispatches, (superepoch, len(calls))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


LM = dict(smoke=True, servers=4, clients=2, t_client=1, t_server=3,
          seq_len=16, device="cpu", log=False, mixing="push_sum",
          graph="random_orientation")


def test_train_push_sum_records_the_weight_and_tracks_the_transpose():
    """``train(mixing="push_sum")`` on the LM smoke config over a directed
    graph: the record's ``psum_min_weight`` is the state's smallest weight,
    the weights sum to M, ``sigma_prod`` is the push-sum tracker's."""
    out = ttrain.train("smollm-360m", epochs=2, **LM)
    hist, state = out["history"], out["state"]
    w = state.psum_weight
    assert hist["psum_min_weight"][-1] == float(w.min())
    np.testing.assert_allclose(float(w.sum()), 4.0, rtol=1e-5)
    assert float(w.min()) < 0.99            # a skewed digraph: not all 1
    a = out["topology"].mixing_matrix()
    tr = J.SigmaTracker(4, mode="push_sum")
    assert hist["sigma_prod"] == [tr.update(a, 3) for _ in range(2)]
    assert all(np.isfinite(hist["loss"]))


def test_train_dynamic_push_sum_resets_the_weight_on_surgery():
    """``train_dynamic`` with ``--mixing push_sum``, direction drops and a
    server out at epoch 1 and back at 2: M 4 -> 3 -> 4, the weight's shape
    follows M and sums to it."""
    out = ttrain.train_dynamic("smollm-360m", epochs=3, graph="ring",
                               asymmetric_drop_prob=0.3,
                               faults="drop:1:2,rejoin:2:2",
                               **{k: v for k, v in LM.items()
                                  if k != "graph"})
    hist = out["history"]
    assert hist["num_servers"] == [4.0, 3.0, 4.0]
    assert all(0.0 < v <= 1.0 + 1e-6 for v in hist["psum_min_weight"])
    w = out["state"].psum_weight
    assert tuple(w.shape) == (4,)
    np.testing.assert_allclose(float(w.sum()), 4.0, rtol=1e-5)
