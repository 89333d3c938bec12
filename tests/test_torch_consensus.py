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


@pytest.mark.parametrize("mode", ["chebyshev", "trimmed_mean:1", "median",
                                  "clipped"])
def test_later_modes_raise_not_implemented(mode):
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tc.make_backend(mode, a, 3)


def test_later_options_and_bad_modes_raise():
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    # compression wraps the backend in the simulated wire, as the reference
    from repro.core import consensus as jc
    be = tc.make_backend("gossip", a, 3, compression="int8")
    assert be.compressed and be.wire == "simulated"
    assert be.name == jc.make_backend("gossip", a, 3,
                                      compression="int8").name
    with pytest.raises(NotImplementedError, match="staleness"):
        tc.make_backend("gossip", a, 3, staleness=1)
    with pytest.raises(ValueError, match="unknown"):
        tc.make_backend("bogus", a, 3)
    assert tc.make_backend("none", a, 3) is None
