"""Port parity: ``repro_torch.core.topology`` (and the trainer's
``SigmaTracker``) against ``repro.core.topology``.  Host-side numpy code:
every comparison is EXACT equality (tolerance 0)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import schedule as jsched  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import topology as ttp  # noqa: E402

KINDS = ["ring", "complete", "star", "line", "torus", "directed_ring",
         "erdos_renyi", "random_orientation"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [2, 5, 8])
def test_graph_builders_equal(kind, m):
    np.testing.assert_array_equal(ttp.build_graph(kind, m),
                                  jtp.build_graph(kind, m))


@pytest.mark.parametrize("weights", ["metropolis_weights", "uniform_weights",
                                     "out_degree_weights"])
@pytest.mark.parametrize("kind", ["ring", "star", "line", "complete"])
def test_mixing_weights_and_spectra_equal(weights, kind):
    adj = jtp.build_graph(kind, 6)
    a_ref = getattr(jtp, weights)(adj)
    a = getattr(ttp, weights)(adj)
    np.testing.assert_array_equal(a, a_ref)
    for t_s in (1, 5, 25):
        assert ttp.sigma_a(a, t_s) == jtp.sigma_a(a_ref, t_s)
    assert ttp.sigma_product([a, a.T @ a], 3) == \
        jtp.sigma_product([a_ref, a_ref.T @ a_ref], 3)
    if weights != "out_degree_weights":
        assert ttp.lambda_2(a) == jtp.lambda_2(a_ref)


@pytest.mark.parametrize("kind,mixing", [("ring", "metropolis"),
                                         ("star", "uniform"),
                                         ("directed_ring", "out_degree")])
def test_fltopology_equal(kind, mixing):
    kw = dict(num_servers=5, clients_per_server=3, t_client=4, t_server=7,
              graph_kind=kind, mixing=mixing)
    t, r = ttp.FLTopology(**kw), jtp.FLTopology(**kw)
    np.testing.assert_array_equal(t.mixing_matrix(), r.mixing_matrix())
    assert t.sigma() == r.sigma()
    assert t.max_step_size(0.5, 9.0) == r.max_step_size(0.5, 9.0)
    if mixing != "out_degree":
        assert t.epsilon_bound(0.01, 0.5, 9.0, 1.0) == \
            r.epsilon_bound(0.01, 0.5, 9.0, 1.0)
    t2, keep_t = t.drop_server(1)
    r2, keep_r = r.drop_server(1)
    np.testing.assert_array_equal(keep_t, keep_r)
    np.testing.assert_array_equal(t2.mixing_matrix(), r2.mixing_matrix())
    assert (t2.graph_kind, t2.num_servers) == (r2.graph_kind, r2.num_servers)


def _degrade(tp, name):
    """``name``'s helper of module ``tp`` on fixed inputs (a fresh seeded
    generator per call, so both modules draw the same numbers)."""
    ring = tp.ring_graph(6)
    a = tp.metropolis_weights(ring)
    rng = np.random.default_rng(5)
    return {
        "drop_edges": lambda: tp.drop_edges(ring, [(0, 1), (2, 3)]),
        "random_edge_drop": lambda: tp.random_edge_drop(ring, 0.5, rng),
        "random_direction_drop": lambda: tp.random_direction_drop(
            ring, 0.5, rng),
        "weaken_links": lambda: tp.weaken_links(a, [(0, 1)], 0.5),
        "weaken_directed_links": lambda: tp.weaken_directed_links(
            a, [(0, 1), (3, 2)], 0.25),
        "perron_weights": lambda: tp.perron_weights(
            tp.out_degree_weights(tp.star_graph(5))),
        "sigma_push_sum": lambda: tp.sigma_push_sum(
            tp.out_degree_weights(tp.directed_ring(5)), 4),
        "spectral_gap": lambda: tp.spectral_gap(a),
    }[name]()


@pytest.mark.parametrize("name", ["drop_edges", "random_edge_drop",
                                  "random_direction_drop", "weaken_links",
                                  "weaken_directed_links", "perron_weights",
                                  "sigma_push_sum", "spectral_gap"])
def test_degradation_and_spectral_helpers_equal(name):
    np.testing.assert_array_equal(_degrade(ttp, name), _degrade(jtp, name))


def test_fltopology_validation_matches():
    for kw in (dict(num_servers=0, clients_per_server=1, t_client=1,
                    t_server=1),
               dict(num_servers=3, clients_per_server=1, t_client=1,
                    t_server=1, graph_kind="directed_ring")):
        with pytest.raises(ValueError):
            jtp.FLTopology(**kw)
        with pytest.raises(ValueError):
            ttp.FLTopology(**kw)


def test_sigma_tracker_average_equal():
    a = jtp.metropolis_weights(jtp.ring_graph(5))
    b = jtp.metropolis_weights(jtp.line_graph(5))
    ref, port = jsched.SigmaTracker(5), tsched.SigmaTracker(5)
    for mat in (a, b, a):
        assert port.update(mat, 4) == ref.update(mat, 4)
    np.testing.assert_array_equal(port.prod, ref.prod)


@pytest.mark.parametrize("staleness", [1, 2])
def test_sigma_tracker_stale_equal(staleness):
    a = jtp.metropolis_weights(jtp.ring_graph(5))
    ref = jsched.SigmaTracker(5, staleness=staleness)
    port = tsched.SigmaTracker(5, staleness=staleness)
    for t_server in (5, 2, 6):
        assert port.update(a, t_server) == ref.update(a, t_server)
    np.testing.assert_array_equal(port.prod, ref.prod)


def test_sigma_tracker_later_modes_raise():
    # push_sum is ported (directed federation): the transpose product, as
    # the reference's; a mode neither package has still raises
    a = jtp.out_degree_weights(jtp.directed_ring(3))
    a[0, 1], a[0, 0] = 0.25, 0.75
    ref = jsched.SigmaTracker(3, mode="push_sum")
    port = tsched.SigmaTracker(3, mode="push_sum")
    assert port.update(a, 4) == ref.update(a, 4)
    np.testing.assert_array_equal(port.prod, ref.prod)
    with pytest.raises(ValueError, match="mode"):
        tsched.SigmaTracker(3, mode="bogus")
    with pytest.raises(ValueError, match="staleness"):
        tsched.SigmaTracker(3, staleness=-1)
