"""Kernel 8 (the bounded-staleness wire round) at the chunks that pick its
narrowest and widest bodies on the card: the plain version
(``repro_torch.kernels.ref.bucketed_gossip_round_pipelined_ref``), reached
through ``ops`` on CPU tensors as the square call and the row form, against
the reference's Pallas ``bucketed_gossip_round_pipelined_2d`` in interpret
mode.  At chunk 4 one 16-byte load of a thread holds a whole chunk on the
card; chunk 2048 is wider than the square call's tile (the two-pass body).

Tolerance: bitwise (codes, scales and every f32 output), as
``tests/test_torch_wire.py`` holds one call: the plain version rounds each
multiply-add as the reference's jitted programs do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import topology as jtp  # noqa: E402
from repro.kernels import consensus_mix as jk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, d, chunk, bits, seed):
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    f = lambda s: (rng.standard_normal((m, d)) * s).astype(np.float32)  # noqa: E731
    x = dict(w=f(1.0), ref=f(0.5), acc=f(0.5),
             u=rng.random((m, d)).astype(np.float32),
             codes=rng.integers(-qmax, qmax + 1, size=(m, d)).astype(np.int8),
             scales=(rng.random((m, d // chunk)) * 0.02 + 1e-3).astype(
                 np.float32))
    x["w"][:, :chunk] = x["ref"][:, :chunk]     # a zero delta: scale 1
    return x


def _equal(got, want):
    for name, g, w in zip(("acc", "ref", "codes", "scales"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk,nc", [(4, 24), (2048, 2)])
def test_kernel8_plain_matches_pallas(chunk, nc, bits):
    m = 4
    d = chunk * nc
    x = _inputs(m, d, chunk, bits, seed=chunk + bits)
    a = jtp.metropolis_weights(jtp.ring_graph(m)).astype(np.float32)
    pk = dict(bits=bits, chunk=chunk, block_d=max(chunk, 16),
              interpret=True)
    want = jk.bucketed_gossip_round_pipelined_2d(
        a, x["codes"], x["scales"], x["w"], x["ref"], x["acc"], x["u"], **pk)
    want_w = jk.bucketed_gossip_round_pipelined_2d(
        a, x["codes"], x["scales"], x["w"], x["ref"], x["w"], x["u"], **pk)
    kw = dict(bits=bits, chunk=chunk)

    # the square call, in place; then with acc the iterate itself
    st = [T(x[k].copy()) for k in ("codes", "scales", "ref", "acc")]
    got = ops.bucketed_gossip_round_pipelined(T(a), st[0], st[1], T(x["w"]),
                                              st[2], st[3], T(x["u"]), **kw)
    assert got[0] is st[3] and got[2] is st[0]
    _equal(got, want)
    st = [T(x[k].copy()) for k in ("codes", "scales", "ref", "w")]
    _equal(ops.bucketed_gossip_round_pipelined(
        T(a), st[0], st[1], st[3], st[2], st[3], T(x["u"]), **kw), want_w)

    # the row form: row r of the square call, the gathered codes untouched
    r = 1
    own = slice(r, r + 1)
    codes, scales = T(x["codes"].copy()), T(x["scales"].copy())
    got = ops.bucketed_gossip_round_pipelined_rows(
        T(a[own].copy()), codes, scales, T(x["w"][own].copy()),
        T(x["ref"][own].copy()), T(x["acc"][own].copy()),
        T(x["u"][own].copy()), torch.empty((1, d), dtype=torch.int8),
        torch.empty((1, nc)), **kw)
    _equal(got, [np.asarray(t)[own] for t in want])
    _equal((codes, scales), (x["codes"], x["scales"]))
