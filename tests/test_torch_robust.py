"""Port parity for robust gossip and the Byzantine injection: twins of
``tests/test_robust.py`` and of the robust rows of ``tests/test_property.py``
and ``tests/test_overlap.py`` on ``repro_torch``, each held against the
reference on the same numpy-made inputs.

Tolerances:
* ``ByzantineSchedule`` (parse, counts, validation, attacker sets, codes
  through drop and rejoin), the screens' keep sets and their per-source
  ``_stats`` counts, the engine's ``byzantine`` and rank-screen
  ``screen_rejected`` columns: exact;
* ``apply_byzantine``: sign_flip and inlier_shift bitwise against the
  reference's jitted function, in float32 (XLA fuses inlier_shift's ``h_min
  + s * (h_max - h_min)`` into one rounding, as the port does) and bfloat16
  (the scale rounded to bf16 first, as JAX rounds a weak scalar); float32
  scaled_noise within 4 ulps of the noise (``prng.normal``: torch's
  ``log1p`` is not XLA's in the last bit) plus one ulp of the sum, bfloat16
  bitwise;
* the rank screens' values: median bitwise, the trimmed mean within one
  float32 rounding of the kept sum (rtol 1e-6); clipped gossip at rtol /
  atol 1e-5 (its Gram products are summed in another order) and its counts
  exactly only away from the clip edge;
* engine runs with an attack: rtol 1e-5 / atol 1e-6, clipped atol 1e-4 (its
  honest distances sit at the Gram identity's f32 floor, so clip factors
  near 1 flip between the packages);
* within the port: trimmed_mean:0 bitwise plain gossip, permutation
  equivariance bitwise, superepoch parity bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.comm.compressors import make_compressor as j_make_compressor  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.data import RegressionSpec as JSpec  # noqa: E402
from repro.data import make_regression_task as j_task  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.comm.compressors import make_compressor  # noqa: E402
from repro_torch.core import (DFLConfig, EpochSchedule,  # noqa: E402
                              FLTopology, ParticipationSchedule, TopologySchedule,
                              build_dfl_epoch_step, init_dfl_state,
                              make_engine)
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.schedule import (ByzantineAttack,  # noqa: E402
                                       ByzantineSchedule, FaultSchedule)
from repro_torch.core import topology as tp  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# fig-3 tolerance: honest servers within 0.05 of w* and in consensus
FIG3_ERR = 0.05
FIG3_DIS = 1e-3
# the reference suite's sizes: one sign-flip attacker in eight
M, N, T_C, T_S, EPOCHS = 8, 3, 15, 8, 40
GAMMA = 1.5 / (9.0 * T_C)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: one intra-op thread, so that parallel test workers
    do not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (an order-preserving map of the bits)."""
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


def _both(tree):
    return (tree_map(lambda x: torch.from_numpy(np.array(x)), tree),
            jax.tree.map(jnp.asarray, tree))


def _to_j(spec, **kw):
    return jsched.ByzantineSchedule.parse(spec, **kw) if spec else None


def _to_t(spec, **kw):
    return ByzantineSchedule.parse(spec, **kw) if spec else None


# ---------------------------------------------------------------------------
# the schedule: host numpy, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,seed,resample", [
    ("sign_flip:0.125", 0, False), ("sign_flip:0.25", 7, False),
    ("sign_flip:0.1,scaled_noise:0.1:10", 3, False),
    ("inlier_shift:0.3:0.8,sign_flip:0.2", 1, True), ("", 0, False)])
def test_byzantine_schedule_matches_reference(spec, seed, resample):
    byz = ByzantineSchedule.parse(spec, seed=seed, resample=resample)
    jbyz = jsched.ByzantineSchedule.parse(spec, seed=seed, resample=resample)
    assert [dataclasses.astuple(a) for a in byz.attacks] == [
        dataclasses.astuple(a) for a in jbyz.attacks]
    for m in (4, 5, 8, 10):
        assert byz.counts(m) == jbyz.counts(m)
        for epoch in (0, 3):
            assert byz.attacker_sets(epoch, m) == jbyz.attacker_sets(epoch,
                                                                     m)
    # codes through drop and rejoin: the alive row orders of surgery
    for alive in ((0, 1, 2, 3, 4, 5, 6, 7), (0, 1, 2, 4, 5, 6, 7),
                  (0, 2, 4, 5, 6, 7, 1), (7, 6, 5)):
        for epoch in (0, 2, 5):
            np.testing.assert_array_equal(byz.codes(epoch, alive, 8),
                                          jbyz.codes(epoch, alive, 8))


def test_parse_rejects_malformed_specs():
    for bad in ("warp:0.1", "sign_flip", "sign_flip:x",
                "sign_flip:0.1:y", "sign_flip:2.0",
                "inlier_shift:0.1:3.0"):
        with pytest.raises(ValueError):
            ByzantineSchedule.parse(bad)
    for bad_mode in ("trimmed_mean:x", "median:3", "clipped:0",
                     "clipped:x"):
        with pytest.raises(ValueError):
            cns.make_backend(bad_mode, np.ones((4, 4)) / 4, 2)


def test_schedule_validation_needs_an_honest_server():
    with pytest.raises(ValueError):
        ByzantineSchedule.parse("sign_flip:1.0").validate(4)
    ByzantineSchedule.parse("sign_flip:0.5").validate(4)  # 2 of 4 is fine


def test_attacker_codes_follow_original_ids_through_surgery():
    """codes() is keyed to ORIGINAL server ids: dropping an unrelated
    server does not shift which physical server attacks."""
    byz = ByzantineSchedule.parse("sign_flip:0.25", seed=7)
    full = tuple(range(M))
    base = byz.codes(0, full, M)
    attackers = {full[i] for i in range(M) if base[i] != 0}
    victim = next(i for i in full if i not in attackers)
    alive = tuple(i for i in full if i != victim)
    after = byz.codes(0, alive, M)
    assert {alive[i] for i in range(len(alive)) if after[i] != 0} == attackers


# ---------------------------------------------------------------------------
# the injection
# ---------------------------------------------------------------------------


def test_prng_normal_matches_jax_random_normal():
    for seed, shape in ((0, (4, 300, 7)), (5, (3, 1000))):
        k = jax.random.fold_in(jax.random.key(seed), 2)
        kd = np.asarray(jax.random.key_data(k))
        want = np.asarray(jax.random.normal(k, shape, jnp.float32))
        got = prng.normal(kd, shape).numpy()
        assert _ulps(got, want).max() <= 4
        # a run of whole rows from its flat offset, as the injection draws
        row = prng.normal(kd, shape[1:], start=2 * int(np.prod(shape[1:])))
        np.testing.assert_array_equal(row.numpy(), got[2])
        k16 = jax.random.fold_in(jax.random.key(seed), 3)
        want16 = np.asarray(jax.random.normal(k16, shape, jnp.bfloat16)
                            .astype(jnp.float32))
        got16 = prng.normal(np.asarray(jax.random.key_data(k16)), shape,
                            dtype=torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got16, want16)
    u = torch.tensor([0.0, 0.5, -0.25, 0.999, -0.9999, 1.0, -1.0])
    np.testing.assert_allclose(prng.erf_inv(u).numpy(),
                               np.asarray(jax.lax.erf_inv(
                                   jnp.asarray(u.numpy()))), rtol=3e-7)


ATTACKS = {"sign_flip": 1.7, "scaled_noise": 10.0, "inlier_shift": 0.8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(ATTACKS))
def test_apply_byzantine_matches_reference(kind, dtype):
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((6, 40, 7)).astype(np.float32),
            "b": rng.standard_normal((6, 33)).astype(np.float32)}
    codes = np.array([1, 0, 2, 0, 1, 0], np.int32)
    # the kind under test is attack 1; attack 2 a sign flip at another scale
    j_atk = (jsched.ByzantineAttack(kind, 0.3, ATTACKS[kind]),
             jsched.ByzantineAttack("sign_flip", 0.2, 0.5))
    t_atk = tuple(ByzantineAttack(a.kind, a.frac, a.scale) for a in j_atk)
    key = jax.random.key(9)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jtree = jax.tree.map(lambda x: jnp.asarray(x, jd), tree)
    ttree = tree_map(lambda x: torch.from_numpy(x).to(td), tree)
    want = jax.jit(J.apply_byzantine, static_argnums=3)(
        jtree, jnp.asarray(codes), key, j_atk)
    got = tdfl.apply_byzantine(ttree, torch.from_numpy(codes),
                               np.asarray(jax.random.key_data(key)), t_atk)
    for k in tree:
        g = got[k].float().numpy()
        w = np.asarray(want[k].astype(jnp.float32))
        x = ttree[k].float().numpy()
        # honest rows pass through untouched, the second attack bitwise
        np.testing.assert_array_equal(g[codes == 0], x[codes == 0])
        np.testing.assert_array_equal(g[codes == 2], w[codes == 2])
        if kind == "scaled_noise" and dtype == "float32":
            noise_ulp = 4 * 10.0 * np.spacing(np.abs((w - x) / 10.0))
            lim = noise_ulp + np.spacing(np.abs(w))
            assert np.all(np.abs(g - w)[codes == 1] <= lim[codes == 1])
        else:
            np.testing.assert_array_equal(g[codes == 1], w[codes == 1])
    # no attacker this epoch: the very same tree comes back
    none = tdfl.apply_byzantine(ttree, np.zeros(6, np.int32), None, t_atk)
    assert all(a is b for a, b in zip(tree_leaves(none), tree_leaves(ttree)))


def test_inlier_shift_stays_inside_honest_envelope():
    """The colluding inlier shift lands INSIDE the coordinatewise honest
    envelope, and so does the trimmed mean of the attacked tree."""
    w = np.array(jax.random.normal(jax.random.key(3), (M, 5)))
    codes = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.int32)
    atk = (ByzantineAttack("inlier_shift", 0.25, scale=0.8),)
    attacked = tdfl.apply_byzantine({"w": torch.from_numpy(w)}, codes,
                                    None, atk)
    honest = codes == 0
    out = attacked["w"].numpy()
    hmin, hmax = w[honest].min(axis=0), w[honest].max(axis=0)
    np.testing.assert_array_equal(out[honest], w[honest])
    assert np.all(out[~honest] >= hmin - 1e-6)
    assert np.all(out[~honest] <= hmax + 1e-6)
    assert np.any(out[~honest] != w[~honest])  # it did act
    a = torch.full((M, M), 1.0 / M)
    mixed = cns.trimmed_mean_mix(a, attacked, 1)["w"].numpy()
    assert np.all(mixed >= hmin - 1e-6) and np.all(mixed <= hmax + 1e-6)


# ---------------------------------------------------------------------------
# the screens against the reference
# ---------------------------------------------------------------------------


def _screen_tree(m, seed):
    """Normal values with ties planted (a constant column, two equal
    sources, a repeated value across three), which the keep sets break by
    source index."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((m, 6, 3)).astype(np.float32),
            "b": rng.standard_normal((m, 9)).astype(np.float32)}
    tree["b"][:, 0] = 1.0
    tree["b"][1, 1] = tree["b"][2, 1]
    tree["w"][: min(m, 3), 0, 0] = -0.5
    return tree


GRAPHS = [("ring", 5), ("complete", 4), ("complete", 8), ("star", 5),
          ("line", 4), ("erdos_renyi", 6)]


def _graph(kind, m):
    adj = (jtp.erdos_renyi_graph(m, 0.5, seed=2) if kind == "erdos_renyi"
           else jtp.build_graph(kind, m))
    return jtp.metropolis_weights(adj)


@pytest.mark.parametrize("kind,m", GRAPHS)
def test_rank_screens_match_reference(kind, m):
    a = _graph(kind, m)
    ta, ja = torch.tensor(a, dtype=torch.float32), jnp.asarray(a, jnp.float32)
    tt, jt = _both(_screen_tree(m, seed=m))
    cnt = int(((a > 0) | np.eye(m, dtype=bool)).sum(axis=1).min())
    cases = [("median", cns.gossip_scan_median_stats(ta, tt, 3),
              jcns.gossip_scan_median_stats(ja, jt, 3))]
    for f in (0, 1, 2):
        if f == 0 or cnt > 2 * f:
            cases.append((f"trimmed:{f}",
                          cns.gossip_scan_trimmed_stats(ta, tt, 3, f),
                          jcns.gossip_scan_trimmed_stats(ja, jt, 3, f)))
    for name, (got, rej), (want, jrej) in cases:
        np.testing.assert_array_equal(rej.numpy(), np.asarray(jrej))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            if name == "median":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
    # one round: the functions the reference exports
    for g, w in zip(tree_leaves(cns.median_mix(ta, tt)),
                    jax.tree.leaves(jcns.median_mix(ja, jt))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rank_screen_blocks_and_a_bf16_leaf():
    """Blocking the columns is the same screen; a bf16 leaf screens in its
    dtype, the kept sum rounded once from f32, as the reference's."""
    a = _graph("complete", 5)
    ta, ja = torch.tensor(a, dtype=torch.float32), jnp.asarray(a, jnp.float32)
    tt, jt = _both(_screen_tree(5, seed=1))
    whole, rej = cns._rank_scan_stats(ta, tt, 4, cns._trim_rule(1))
    blocked, rej_b = cns._rank_scan_stats(ta, tt, 4, cns._trim_rule(1),
                                          block=4)
    np.testing.assert_array_equal(rej.numpy(), rej_b.numpy())
    for x, y in zip(tree_leaves(whole), tree_leaves(blocked)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    tb = tree_map(lambda x: x.to(torch.bfloat16), tt)
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jt)
    for fn, jfn in ((lambda t: cns.gossip_scan_median(ta, t, 2),
                     lambda t: jcns.gossip_scan_median(ja, t, 2)),
                    (lambda t: cns.gossip_scan_trimmed(ta, t, 2, 1),
                     lambda t: jcns.gossip_scan_trimmed(ja, t, 2, 1))):
        for g, w in zip(tree_leaves(fn(tb)), jax.tree.leaves(jfn(jb))):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("kind,m", GRAPHS)
def test_clipped_gossip_matches_reference(kind, m):
    a = _graph(kind, m)
    ta, ja = torch.tensor(a, dtype=torch.float32), jnp.asarray(a, jnp.float32)
    tree = _screen_tree(m, seed=m + 1)
    tree["w"][0] *= 20.0          # a far sender: its links clip clearly
    tt, jt = _both(tree)
    c, hit = cns.clip_weights_stats(ta, tt, 1.0)
    jc, jhit = jcns.clip_weights_stats(ja, jt, 1.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.sum(dim=1).numpy(), 1.0, atol=1e-6)
    got, rej = cns.gossip_scan_clipped_stats(ta, tt, 3, 1.5)
    want, jrej = jcns.gossip_scan_clipped_stats(ja, jt, 3, 1.5)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # away from the clip edge (the far sender's first round), the counts
    np.testing.assert_array_equal(hit.numpy()[0], np.asarray(jhit)[0])
    assert rej.shape == (m,)
    # an agreed tree is a fixed point: C == A
    same = {"w": torch.ones((m, 3)), "b": torch.full((m, 2), 2.0)}
    np.testing.assert_allclose(cns.clip_weights(ta, same).numpy(), a,
                               rtol=1e-6, atol=1e-7)


def test_clipped_on_a_mixed_dtype_tree_mixes_leaf_by_leaf():
    a = torch.tensor(_graph("complete", 4), dtype=torch.float32)
    tree = _screen_tree(4, seed=3)
    tt = {"w": torch.from_numpy(tree["w"]),
          "b": torch.from_numpy(tree["b"]).to(torch.bfloat16)}
    got = cns.gossip_scan_clipped(a, tt, 2)
    assert got["b"].dtype == torch.bfloat16 and got["w"].dtype == \
        torch.float32
    want = cns.gossip_scan_clipped(a, tree_map(lambda x: x.float(), tt), 2)
    np.testing.assert_allclose(got["w"].numpy(), want["w"].numpy(),
                               rtol=1e-2, atol=1e-2)


# -- the property rows (test_property.py), on seeded cases -----------------


def _distinct_int_tree(seed, m, d):
    """(m, d) float32 of DISTINCT small integers: sums are exact and ties
    impossible, so the screens are testable bitwise."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(4096, size=m * d, replace=False).astype(np.float32)
    return torch.from_numpy((vals - 2048.0).reshape(m, d))


@pytest.mark.parametrize("seed,m,d,f,kind,perm_seed", [
    (0, 3, 1, 0, "ring", 1), (1, 5, 4, 1, "complete", 2),
    (2, 8, 6, 1, "star", 3), (3, 6, 3, 0, "ring", 4),
    (4, 7, 5, 1, "ring", 5), (5, 4, 2, 1, "complete", 6)])
def test_robust_screens_are_permutation_equivariant(seed, m, d, f, kind,
                                                    perm_seed):
    a = torch.tensor(tp.metropolis_weights(tp.build_graph(kind, m)),
                     dtype=torch.float32)
    w = _distinct_int_tree(seed, m, d)
    perm = torch.from_numpy(np.random.default_rng(perm_seed).permutation(m))
    pa, pw = a[perm][:, perm], w[perm]
    cnt = int((a > 0).sum(dim=1).min())
    if cnt > 2 * f:
        out = cns.trimmed_mean_mix(a, {"w": w}, f)["w"]
        pout = cns.trimmed_mean_mix(pa, {"w": pw}, f)["w"]
        np.testing.assert_array_equal(pout.numpy(), out[perm].numpy())
    out = cns.median_mix(a, {"w": w})["w"]
    pout = cns.median_mix(pa, {"w": pw})["w"]
    np.testing.assert_array_equal(pout.numpy(), out[perm].numpy())


@pytest.mark.parametrize("seed,m,d,kind", [
    (0, 2, 1, "line"), (1, 5, 8, "ring"), (2, 8, 3, "complete"),
    (3, 6, 5, "star"), (4, 4, 2, "line")])
def test_trimmed_f0_is_masked_neighbor_mean_bitwise(seed, m, d, kind):
    a = tp.metropolis_weights(tp.build_graph(kind, m))
    w = torch.from_numpy(np.array(jax.random.normal(jax.random.key(seed),
                                                    (m, d))))
    out = cns.trimmed_mean_mix(torch.tensor(a, dtype=torch.float32),
                               {"w": w}, 0)["w"]
    sup = (a > 0) | np.eye(m, dtype=bool)
    for i in range(m):
        acc = torch.zeros(d)
        for j in range(m):        # in source order, non-neighbours as 0
            acc = acc + (w[j] if sup[i, j] else torch.zeros(d))
        np.testing.assert_array_equal(out[i].numpy(),
                                      (acc / float(sup[i].sum())).numpy())
    # and it is the reference's function bitwise
    want = jcns.trimmed_mean_mix(jnp.asarray(a, jnp.float32),
                                 {"w": jnp.asarray(w.numpy())}, 0)["w"]
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,m,d,n_atk,atk_scale", [
    (0, 4, 1, 0, 0.0), (1, 5, 3, 1, 1e6), (2, 9, 5, 1, -1e6),
    (3, 6, 2, 1, 3.5), (4, 7, 4, 0, 0.0), (5, 8, 5, 1, -123.0)])
def test_robust_outputs_stay_in_honest_envelope(seed, m, d, n_atk,
                                                atk_scale):
    a = torch.tensor(tp.metropolis_weights(tp.complete_graph(m)),
                     dtype=torch.float32)
    w = _distinct_int_tree(seed, m, d).numpy().copy()
    attackers = np.zeros(m, bool)
    attackers[:n_atk] = True
    w[attackers] = np.float32(atk_scale)
    hmin, hmax = w[~attackers].min(axis=0), w[~attackers].max(axis=0)
    wt = torch.from_numpy(w)
    for mixed in (cns.trimmed_mean_mix(a, {"w": wt}, 1)["w"],
                  cns.median_mix(a, {"w": wt})["w"]):
        out = mixed.numpy()[~attackers]
        assert np.all(out >= hmin - 1e-4 * np.maximum(1, np.abs(hmin)))
        assert np.all(out <= hmax + 1e-4 * np.maximum(1, np.abs(hmax)))


# ---------------------------------------------------------------------------
# backends, refusals, the simulated wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["trimmed_mean:1", "trimmed_mean:0",
                                  "median", "clipped:2.0"])
def test_backends_mix_stats_match_reference(mode):
    a = _graph("complete", 5)
    be, jbe = cns.make_backend(mode, a, 4), jcns.make_backend(mode, a, 4)
    assert (be.name, be.robust, be.supports_directed) == (
        jbe.name, jbe.robust, jbe.supports_directed)
    tree = _screen_tree(5, seed=8)
    tree["w"][2] *= -30.0
    tt, jt = _both(tree)
    got, rej = be.mix_stats(tt)
    want, jrej = jbe.mix_stats(jt)
    if mode.startswith("clipped"):
        np.testing.assert_allclose(rej.numpy(), np.asarray(jrej), atol=1.0)
    else:
        np.testing.assert_array_equal(rej.numpy(), np.asarray(jrej))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    for g, w in zip(tree_leaves(be.mix(tt)), tree_leaves(got)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # a per-epoch A_p in place of the static matrix
    a_p = _graph("ring", 5)
    got_p = be.mix(tt, torch.tensor(a_p, dtype=torch.float32))
    want_p = jbe.mix(jt, jnp.asarray(a_p, jnp.float32))
    for g, w in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_trimmed_f0_backend_is_plain_gossip_bitwise():
    a = _graph("ring", 5)
    tt, _ = _both(_screen_tree(5, seed=2))
    got, rej = cns.make_backend("trimmed_mean:0", a, 6).mix_stats(tt)
    want = cns.make_backend("gossip", a, 6).mix(tt)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not rej.any()
    be = cns.make_backend("trimmed_mean:0", a, 6)
    gb = cns.make_backend("gossip", a, 6)
    for (f1, _), (f2, _) in ((be.first_round(None, 5),
                              gb.first_round(None, 5)),):
        np.testing.assert_array_equal(f1.numpy(), f2.numpy())


@pytest.mark.parametrize("mode", ["trimmed_mean:1", "median", "clipped"])
def test_simulated_wire_over_a_robust_inner(mode):
    """The simulated wire decodes each message on A = I (kernel 4's plain
    version here) and the screen runs the whole period, as the reference's
    ``CompressedBackend`` around the same inner backend."""
    a = _graph("complete", 4)
    be = cns.make_backend(mode, a, 3, compression="int8:8")
    jbe = jcns.make_backend(mode, a, 3, compression="int8:8")
    first, _ = be.inner.first_round(None, 4)
    np.testing.assert_array_equal(first.numpy(), np.eye(4))
    tt, jt = _both(_screen_tree(4, seed=6))
    key = jax.random.key(5)
    got, _ = be.mix_compressed(tt, key=np.asarray(jax.random.key_data(key)))
    want, _ = jbe.mix_compressed(jt, key=key)
    # clipped: the clip factors of the decoded honest messages sit near 1,
    # where the Gram products' order decides them (as in the engine runs)
    tol = 1e-4 if mode == "clipped" else 1e-5
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


def test_physical_wire_refuses_robust_inner():
    a = _graph("complete", 8)
    inner = cns.make_backend("trimmed_mean:1", a, T_S)
    with pytest.raises(ValueError, match="plaintext"):
        cns.CompressedBackend(inner, make_compressor("int8"),
                              wire="physical")
    # the reference refuses the same pair
    with pytest.raises(ValueError, match="plaintext"):
        jcns.CompressedBackend(jcns.make_backend("trimmed_mean:1", a, T_S),
                               j_make_compressor("int8"), wire="physical")


def _setup(seed=0):
    topo = FLTopology(num_servers=M, clients_per_server=N, t_client=T_C,
                      t_server=T_S, graph_kind="complete")
    return topo, make_regression_task(topo, RegressionSpec(
        heterogeneity=0.0), seed=seed)


def test_push_sum_refuses_robust_modes():
    topo, task = _setup()
    for mode in ("trimmed_mean:1", "median", "clipped"):
        cfg = DFLConfig(topology=topo, consensus_mode=mode,
                        mixing="push_sum")
        with pytest.raises(ValueError, match="ratio-consensus"):
            build_dfl_epoch_step(cfg, task["loss_fn"], sgd(GAMMA))


def test_byzantine_requires_dynamic_engine():
    topo, task = _setup()
    cfg = DFLConfig(topology=topo, consensus_mode="gossip",
                    byzantine=ByzantineSchedule.parse("sign_flip:0.125"))
    with pytest.raises(ValueError, match="dynamic"):
        build_dfl_epoch_step(cfg, task["loss_fn"], sgd(GAMMA))
    # a scaled_noise injection needs the key stream
    eng = make_engine(topo, task["loss_fn"], sgd(GAMMA),
                      byzantine=ByzantineSchedule.parse(
                          "scaled_noise:0.125:10"))
    state = init_dfl_state(eng.cfg, torch.zeros(2), sgd(GAMMA))
    with pytest.raises(ValueError, match="key"):
        eng.run_epoch(state, 0, task["batch_fn"])


def test_trimmed_mean_breakdown_point_fails_fast():
    """On a 3-server line the endpoints see only 2 values; f=1 discards 2
    per coordinate: past the breakdown point at build time."""
    topo = FLTopology(num_servers=3, clients_per_server=2, t_client=2,
                      t_server=2, graph_kind="line")
    with pytest.raises(ValueError, match="breakdown"):
        cns.make_backend("trimmed_mean:1", topo.mixing_matrix(), 2)
    cns.make_backend("trimmed_mean:0", topo.mixing_matrix(), 2)


def test_screen_readout_only_under_robust_full_metrics():
    topo, task = _setup()
    for mode, metrics, kw, want in (
            ("trimmed_mean:1", "full", {}, True),
            ("trimmed_mean:1", "light", {}, False),
            ("gossip", "full", {}, False),
            ("median", "full", dict(compression="int8"), False)):
        cfg = DFLConfig(topology=topo, consensus_mode=mode, metrics=metrics,
                        dynamic=True, **kw)
        step = build_dfl_epoch_step(cfg, task["loss_fn"], sgd(GAMMA))
        state = init_dfl_state(cfg, torch.zeros(2), sgd(GAMMA),
                               wire_key=prng.key(0))
        sched = EpochSchedule(torch.ones((M, N)), torch.tensor(
            topo.mixing_matrix(), dtype=torch.float32))
        _, mt = step(state, task["batch_fn"](0, tuple(range(M))), sched)
        assert (mt.screen_rejected is not None) == want, (mode, metrics, kw)


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------


def _run_port(mode, byz, *, epochs, seed=0, faults=None, superepoch=1,
              **cfg_kw):
    topo, task = _setup(seed)
    eng = make_engine(topo, task["loss_fn"], sgd(GAMMA),
                      consensus_mode=mode, byzantine=byz,
                      faults=faults or FaultSchedule(),
                      superepoch=superepoch, **cfg_kw)
    state = init_dfl_state(eng.cfg, torch.zeros(2), sgd(GAMMA),
                           wire_key=prng.key(seed))
    state, hist = eng.run(state, epochs, task["batch_fn"])
    return state, hist, task["w_star"]


def _honest_error(state, byz, w_star):
    servers = state.client_params[:, 0].numpy()
    honest = np.ones(M, bool)
    if byz is not None:
        honest = byz.codes(0, tuple(range(M)), M) == 0
    h = servers[honest]
    return (float(np.linalg.norm(h - w_star, axis=-1).max()),
            float(np.linalg.norm(h - h.mean(0), axis=-1).max()), servers)


@pytest.mark.parametrize("mode,spec,faults", [
    ("gossip", "sign_flip:0.125", ""),
    ("trimmed_mean:1", "sign_flip:0.125", "drop:2:3,rejoin:4:3"),
    ("median", "scaled_noise:0.125:10", ""),
    ("clipped", "sign_flip:0.125", ""),
    ("trimmed_mean:1", "inlier_shift:0.25:0.8", "drop:1:5"),
    ("gossip", "", "")])
def test_engine_with_byzantine_matches_reference(mode, spec, faults):
    epochs = 6
    st, hist, _ = _run_port(mode, _to_t(spec, seed=1), epochs=epochs,
                            faults=FaultSchedule.parse(faults))
    jtopo = J.FLTopology(num_servers=M, clients_per_server=N, t_client=T_C,
                         t_server=T_S, graph_kind="complete")
    jt = j_task(jtopo, JSpec(heterogeneity=0.0), seed=0)
    jeng = J.make_engine(jtopo, jt["loss_fn"], j_sgd(GAMMA),
                         consensus_mode=mode, byzantine=_to_j(spec, seed=1),
                         faults=jsched.FaultSchedule.parse(faults))
    jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(GAMMA),
                           jax.random.key(0))
    jst, jhist = jeng.run(jst, epochs, jt["batch_fn"])
    assert set(hist) == set(jhist)
    for key in ("num_servers", "participation", "sigma_prod"):
        assert hist[key] == jhist[key], key
    if spec:
        assert hist["byzantine"] == jhist["byzantine"]
    tol = dict(rtol=1e-4, atol=1e-4) if mode == "clipped" else TOL
    if "screen_rejected" in hist and mode != "clipped":
        assert hist["screen_rejected"] == jhist["screen_rejected"]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], **tol)
    np.testing.assert_allclose(st.client_params.numpy(),
                               np.asarray(jst.client_params), **tol)


def test_superepoch_parity_with_byzantine_and_a_screen():
    """The stacked attack codes ride the superepoch block: the same history
    (with ``byzantine`` and ``screen_rejected``) and state at K = 3 as the
    per-epoch loop, bitwise, under participation and edge drops."""
    kw = dict(participation=ParticipationSchedule(kind="bernoulli",
                                                  rate=0.6, seed=3),
              topology_schedule=TopologySchedule(kind="edge_drop",
                                                 drop_prob=0.3, seed=5))
    byz = ByzantineSchedule.parse("sign_flip:0.3", seed=7)
    runs = [_run_port("trimmed_mean:1", byz, epochs=6, superepoch=k, **kw)
            for k in (1, 3)]
    (s1, h1, _), (s3, h3, _) = runs
    assert {"byzantine", "screen_rejected"} <= set(h1) == set(h3)
    for key in h1:
        assert h1[key] == h3[key], key
    np.testing.assert_array_equal(s1.client_params.numpy(),
                                  s3.client_params.numpy())


# ---------------------------------------------------------------------------
# headline: attacks break plain gossip, not the robust variants (port only)
# ---------------------------------------------------------------------------


def test_sign_flip_breaks_plain_gossip_but_not_trimmed_or_clipped():
    byz = ByzantineSchedule.parse("sign_flip:0.125")
    st, _, w_star = _run_port("gossip", byz, epochs=EPOCHS)
    err_plain = _honest_error(st, byz, w_star)[0]
    assert err_plain > FIG3_ERR, err_plain
    for mode in ("trimmed_mean:1", "clipped"):
        st, _, w_star = _run_port(mode, byz, epochs=EPOCHS)
        err, dis, _ = _honest_error(st, byz, w_star)
        assert err < FIG3_ERR, f"{mode} under sign-flip: err={err}"
        assert dis < FIG3_DIS, f"{mode} under sign-flip: dis={dis}"


def test_scaled_noise_breaks_plain_gossip_but_not_median():
    byz = ByzantineSchedule.parse("scaled_noise:0.125:10.0")
    st, _, w_star = _run_port("gossip", byz, epochs=EPOCHS)
    assert _honest_error(st, byz, w_star)[0] > FIG3_ERR
    st, _, w_star = _run_port("median", byz, epochs=EPOCHS)
    err, dis, _ = _honest_error(st, byz, w_star)
    assert err < FIG3_ERR and dis < FIG3_DIS


def test_no_attack_baselines_converge():
    for mode in ("gossip", "trimmed_mean:1", "median", "clipped"):
        st, _, w_star = _run_port(mode, None, epochs=EPOCHS)
        err, dis, _ = _honest_error(st, None, w_star)
        assert err < FIG3_ERR, f"{mode} no-attack err={err}"
        assert dis < FIG3_DIS, f"{mode} no-attack dis={dis}"


def test_trimmed_f0_engine_bitwise_identical_to_plain_gossip():
    s_plain = _run_port("gossip", None, epochs=6)[0]
    s_trim = _run_port("trimmed_mean:0", None, epochs=6)[0]
    np.testing.assert_array_equal(s_plain.client_params.numpy(),
                                  s_trim.client_params.numpy())


def test_engine_run_with_byzantine_and_surgery_is_deterministic():
    byz = ByzantineSchedule.parse("sign_flip:0.125", seed=1)
    faults = FaultSchedule.parse("drop:2:3,rejoin:4:3")
    s1 = _run_port("trimmed_mean:1", byz, epochs=6, faults=faults)[0]
    s2 = _run_port("trimmed_mean:1", byz, epochs=6, faults=faults)[0]
    np.testing.assert_array_equal(s1.client_params.numpy(),
                                  s2.client_params.numpy())


# ---------------------------------------------------------------------------
# the trainer on the LM smoke config
# ---------------------------------------------------------------------------


def test_train_dynamic_byzantine_on_the_smoke_config(capsys):
    from repro_torch.launch import train as ttrain
    ttrain.main(["--device", "cpu", "--servers", "4", "--clients", "2",
                 "--t-client", "1", "--t-server", "3", "--epochs", "2",
                 "--seq-len", "16", "--graph", "complete",
                 "--consensus-mode", "trimmed_mean:1",
                 "--byzantine", "sign_flip:0.25", "--log-every", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch")]
    assert len(lines) == 1                      # epoch 0 only, at --log-every 5
    assert "byzantine=0.250" in lines[0] and "screen_rejected=" in lines[0]
    run = ttrain.train_dynamic(
        "smollm-360m", servers=4, clients=2, t_client=1, t_server=3,
        epochs=1, seq_len=16, graph="complete", consensus_mode="median",
        byzantine="scaled_noise:0.25:10", device="cpu", log=False)
    hist = run["history"]
    assert hist["byzantine"] == [0.25]
    assert np.isfinite(hist["loss"]).all()
    # median at M = 4 keeps the middle two of four values: two of every
    # coordinate's four discarded per receiver and round
    d = sum(x[0, 0].numel() for x in tree_leaves(
        run["state"].client_params))
    assert hist["screen_rejected"] == [2 * 4 * d]
