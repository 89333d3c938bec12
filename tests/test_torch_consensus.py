"""Port parity: ``repro_torch.core.consensus`` backends and plain functions
against ``repro.core.consensus`` on random (M, ...) f32 trees built from a
numpy seed.  Tolerance rtol/atol 2e-5: f32 contractions summed in another
order, up to 25 rounds deep (the rounds contract, so errors do not grow)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import consensus as jc  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro_torch.core import consensus as tc  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _tree(m, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((m, 7, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((m, 11)).astype(np.float32)},
            "d": (rng.standard_normal((m,)).astype(np.float32),)}


def _compare(port_tree, jax_tree):
    got = [t.numpy() for t in tree_leaves(port_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("mode", ["gossip", "gossip_blocked", "collapsed",
                                  "exact_mean"])
@pytest.mark.parametrize("kind,m,t_s", [("ring", 5, 25), ("line", 4, 3),
                                        ("complete", 3, 1)])
def test_backends_match_reference(mode, kind, m, t_s):
    a = jtp.metropolis_weights(jtp.build_graph(kind, m))
    tree = _tree(m, seed=m * 31 + t_s)
    kw = {"block": 8} if mode == "gossip_blocked" else {}
    ref = jc.make_backend(mode, a, t_s, **kw).mix(
        jax.tree.map(jnp.asarray, tree))
    port = tc.make_backend(mode, a, t_s, **kw).mix(
        tree_map(torch.from_numpy, tree))
    _compare(port, ref)


@pytest.mark.parametrize("mode", ["gossip", "collapsed"])
def test_backends_take_a_per_epoch_matrix(mode):
    a_static = jtp.metropolis_weights(jtp.ring_graph(4))
    a_p = jtp.metropolis_weights(jtp.line_graph(4)).astype(np.float32)
    tree = _tree(4, seed=9)
    ref = jc.make_backend(mode, a_static, 3).mix(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(a_p))
    port = tc.make_backend(mode, a_static, 3).mix(
        tree_map(torch.from_numpy, tree), torch.from_numpy(a_p))
    _compare(port, ref)


def test_plain_functions_match_reference():
    a = jtp.metropolis_weights(jtp.ring_graph(5)).astype(np.float32)
    tree = _tree(5, seed=1)
    jt, tt = jax.tree.map(jnp.asarray, tree), tree_map(torch.from_numpy, tree)
    ta = torch.from_numpy(a)
    _compare(tc.mix_pytree(ta, tt), jc.mix_pytree(jnp.asarray(a), jt))
    _compare(tc.gossip_scan(ta, tt, 6), jc.gossip_scan(jnp.asarray(a), jt, 6))
    _compare(tc.gossip_scan_blocked(ta, tt, 6, block=5),
             jc.gossip_scan_blocked(jnp.asarray(a), jt, 6, block=5))
    eff = tc.collapse_mixing(a, 6)
    np.testing.assert_array_equal(eff, jc.collapse_mixing(a, 6))
    _compare(tc.gossip_collapsed(torch.from_numpy(eff.astype(np.float32)),
                                 tt),
             jc.gossip_collapsed(jnp.asarray(eff, jnp.float32), jt))


def test_gossip_preserves_mean_and_contracts():
    a = jtp.metropolis_weights(jtp.ring_graph(6))
    tree = tree_map(torch.from_numpy, _tree(6, seed=4))
    mixed = tc.make_backend("gossip", a, 10).mix(tree)
    sig = jtp.sigma_a(a, 10)
    for x, y in zip(tree_leaves(tree), tree_leaves(mixed)):
        torch.testing.assert_close(y.mean(0), x.mean(0), rtol=1e-5,
                                   atol=1e-5)
        dev_x = torch.linalg.vector_norm(x - x.mean(0))
        dev_y = torch.linalg.vector_norm(y - y.mean(0))
        assert dev_y <= sig * dev_x * (1 + 1e-4) + 1e-6


@pytest.mark.parametrize("mode", ["trimmed_mean:1", "median", "clipped"])
def test_later_modes_raise_not_implemented(mode):
    """The robust screens were the last modes the port refused: they now
    build the reference's backend (its name and flags), and mix as it
    does (``tests/test_torch_robust.py`` holds them in full)."""
    a = jtp.metropolis_weights(jtp.complete_graph(4))
    be, jbe = tc.make_backend(mode, a, 3), jc.make_backend(mode, a, 3)
    assert (be.name, be.robust, be.supports_directed) == (
        jbe.name, jbe.robust, jbe.supports_directed)
    tree = _tree(4, seed=5)
    _compare(be.mix(tree_map(torch.from_numpy, tree)),
             jbe.mix(jax.tree.map(jnp.asarray, tree)))


def test_later_options_and_bad_modes_raise():
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    # compression wraps the backend in the simulated wire, as the reference
    from repro.core import consensus as jc
    be = tc.make_backend("gossip", a, 3, compression="int8")
    assert be.compressed and be.wire == "simulated"
    assert be.name == jc.make_backend("gossip", a, 3,
                                      compression="int8").name
    # uncompressed bounded staleness runs gossip_scan_stale
    stale = tc.make_backend("gossip", a, 3, staleness=1)
    tree = _tree(4, seed=2)
    _compare(stale.mix(tree_map(torch.from_numpy, tree)),
             jc.make_backend("gossip", a, 3, staleness=1).mix(
                 jax.tree.map(jnp.asarray, tree)))
    with pytest.raises(ValueError, match="unknown"):
        tc.make_backend("bogus", a, 3)
    assert tc.make_backend("none", a, 3) is None


# ---------------------------------------------------------------------------
# Chebyshev: the static backend, a per-epoch A_p with and without lam2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,m,t_s", [("ring", 5, 25), ("line", 4, 9),
                                        ("complete", 3, 2)])
def test_chebyshev_static_matches_reference(kind, m, t_s):
    a = jtp.metropolis_weights(jtp.build_graph(kind, m))
    tree = _tree(m, seed=m + t_s)
    port = tc.make_backend("chebyshev", a, t_s)
    ref = jc.make_backend("chebyshev", a, t_s)
    assert port.rounds == ref.rounds and port.lam2 == ref.lam2
    _compare(port.mix(tree_map(torch.from_numpy, tree)),
             ref.mix(jax.tree.map(jnp.asarray, tree)))
    assert tc.chebyshev_coefficients(a, port.rounds) == \
        jc.chebyshev_coefficients(a, ref.rounds)


def test_chebyshev_per_epoch_matrix_with_lam2_matches_reference():
    a_static = jtp.metropolis_weights(jtp.ring_graph(6))
    a_p = jtp.metropolis_weights(jtp.random_edge_drop(
        jtp.ring_graph(6), 0.4, np.random.default_rng(3)))
    lam2 = jtp.lambda_2(a_p)
    tree = _tree(6, seed=5)
    port = tc.make_backend("chebyshev", a_static, 16).mix(
        tree_map(torch.from_numpy, tree),
        torch.as_tensor(a_p, dtype=torch.float32),
        lam2=torch.tensor(lam2, dtype=torch.float32))
    ref = jc.make_backend("chebyshev", a_static, 16).mix(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(a_p, jnp.float32),
        lam2=jnp.float32(lam2))
    _compare(port, ref)
    # the plain function with a host lam2, and lam2 <= 0: one plain round
    ta = torch.as_tensor(a_p, dtype=torch.float32)
    _compare(tc.gossip_chebyshev(ta, tree_map(torch.from_numpy, tree), 4,
                                 lam2),
             jc.gossip_chebyshev(jnp.asarray(a_p, jnp.float32),
                                 jax.tree.map(jnp.asarray, tree), 4, lam2))
    _compare(tc.gossip_chebyshev(ta, tree_map(torch.from_numpy, tree), 4,
                                 0.0),
             jc.gossip_chebyshev(jnp.asarray(a_p, jnp.float32),
                                 jax.tree.map(jnp.asarray, tree), 4, 0.0))


def test_chebyshev_per_epoch_matrix_without_lam2_matches_reference():
    """No spectral estimate with a per-epoch A_p: both fall back to an
    eigendecomposition of the matrix (f32 on both sides: 2e-4)."""
    a_static = jtp.metropolis_weights(jtp.ring_graph(5))
    a_p = jtp.metropolis_weights(jtp.line_graph(5)).astype(np.float32)
    tree = _tree(5, seed=6)
    np.testing.assert_allclose(
        float(tc.lambda2_traced(torch.from_numpy(a_p))),
        float(jc.lambda2_traced(jnp.asarray(a_p))), rtol=1e-6)
    port = tc.make_backend("chebyshev", a_static, 9).mix(
        tree_map(torch.from_numpy, tree), torch.from_numpy(a_p))
    ref = jc.make_backend("chebyshev", a_static, 9).mix(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(a_p))
    for g, w in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    assert float(tc.lambda2_traced(torch.ones((1, 1)))) == 0.0


@pytest.mark.parametrize("compression", ["int8", "top_k:0.5"])
def test_chebyshev_on_the_simulated_wire_matches_reference(compression):
    """Kernel 4 decodes on A = I, then the whole recursion; the codes are
    the reference's (the same dither key)."""
    from repro.core import consensus as jcns
    from repro_torch.comm import prng
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    tree = _tree(4, seed=8)
    port = tc.make_backend("chebyshev", a, 9, compression=compression)
    ref = jcns.make_backend("chebyshev", a, 9, compression=compression)
    assert port.needs_spectral and port.name == ref.name
    got, _ = port.mix_compressed(tree_map(torch.from_numpy, tree),
                                 key=prng.key(3))
    want, _ = ref.mix_compressed(jax.tree.map(jnp.asarray, tree),
                                 key=jax.random.key(3))
    _compare(got, want)


# ---------------------------------------------------------------------------
# bf16 leaves: kernel 1's bf16 instance and the backends
# ---------------------------------------------------------------------------


def _bf16(x: np.ndarray):
    """``x`` rounded to bf16, as (JAX array, torch tensor) with equal bits."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


@pytest.mark.parametrize("m,d", [(4, 1000), (5, 2048), (1, 7)])
def test_consensus_mix_bf16_plain_matches_pallas_kernel(m, d):
    """Kernel 1's bf16 instance loads bf16, sums A·w in f32 and stores
    bf16, as the Pallas ``_mix_kernel`` does (run here in interpret mode):
    its plain version equals that kernel bit for bit (an f32 sum of M
    products rounds once to bf16; the sums differ in order only within an
    f32 ulp, far below the bf16 rounding, and no tie was hit)."""
    from repro.kernels import consensus_mix as jk
    from repro_torch.kernels import ops
    rng = np.random.default_rng(m * d)
    a = (jtp.metropolis_weights(jtp.ring_graph(m)) if m > 1
         else np.ones((1, 1))).astype(np.float32)
    jw, tw = _bf16(rng.standard_normal((m, d)).astype(np.float32) * 3)
    want = jk.consensus_mix_2d(jnp.asarray(a), jw, block_d=512)
    got = ops.consensus_mix(torch.from_numpy(a), tw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


BF16_MODES = ["gossip", "gossip_blocked", "collapsed", "exact_mean",
              "chebyshev"]


@pytest.mark.parametrize("mode", BF16_MODES)
def test_backends_mix_bf16_leaves_near_the_reference(mode):
    """A bf16 tree mixes as one bf16 (M, D) slab through kernel 1 (its plain
    version here) and comes back bf16.  The reference contracts with
    ``tensordot`` in bf16, A rounded to bf16 first (``_mix_leaf``), and never
    calls its kernel; the port keeps A in f32 (the kernel's rule).  Each
    round's output then differs by at most about one bf16 step of the
    largest value (2^-8 of it: A's rounding is 2^-9 of an entry, the output
    rounding half a step), and the rounds contract, so a period of T_S
    rounds stays within T_S steps.  Exact mean: no A, equal."""
    m, t_s = 4, 5
    a = jtp.metropolis_weights(jtp.ring_graph(m))
    tree = jax.tree.map(lambda v: v * 3, _tree(m, seed=21))
    jt = jax.tree.map(lambda x: _bf16(x)[0], tree)
    tt = tree_map(lambda x: _bf16(x)[1], tree)
    kw = {"block": 8} if mode == "gossip_blocked" else {}
    want = jc.make_backend(mode, a, t_s, **kw).mix(jt)
    got = tc.make_backend(mode, a, t_s, **kw).mix(tt)
    top = max(float(np.abs(x).max()) for x in jax.tree.leaves(tree))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0,
                                   atol=t_s * 2.0 ** -8 * top)


def test_stale_and_time_varying_gossip_on_bf16_and_mixed_trees():
    """Uncompressed bounded staleness and the per-round matrix stack on a
    bf16 slab, within the same bound as the backends; a tree of mixed
    dtypes (bf16 and f32 leaves) mixes leaf by leaf, each leaf in its own
    dtype, as the reference's ``_mix_leaf`` does (the f32 leaf to 2e-5)."""
    m, t_s = 4, 5
    a = jtp.metropolis_weights(jtp.ring_graph(m)).astype(np.float32)
    tree = jax.tree.map(lambda v: v * 3, _tree(m, seed=22))
    top = max(float(np.abs(x).max()) for x in jax.tree.leaves(tree))
    jt = jax.tree.map(lambda x: _bf16(x)[0], tree)
    tt = tree_map(lambda x: _bf16(x)[1], tree)
    stack = np.stack([a] * t_s)
    for want, got in (
            (jc.gossip_scan_stale(jnp.asarray(a), jt, t_s, 1),
             tc.gossip_scan_stale(torch.from_numpy(a), tt, t_s, 1)),
            (jc.gossip_scan_tv(jnp.asarray(stack), jt),
             tc.gossip_scan_tv(torch.from_numpy(stack), tt))):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=0,
                                       atol=t_s * 2.0 ** -8 * top)
    jmix = {"a": jt["a"], "b": jnp.asarray(tree["b"]["c"])}
    tmix = {"a": tt["a"], "b": torch.from_numpy(tree["b"]["c"])}
    for mode in ("gossip", "chebyshev"):
        want = jc.make_backend(mode, a, t_s).mix(jmix)
        got = tc.make_backend(mode, a, t_s).mix(tmix)
        assert got["a"].dtype == torch.bfloat16
        assert got["b"].dtype == torch.float32
        np.testing.assert_allclose(_f32(got["a"]), _f32(want["a"]), rtol=0,
                                   atol=t_s * 2.0 ** -8 * top)
        np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                                   **TOL)
