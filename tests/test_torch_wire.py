"""Port parity for the physical wire: the plain versions of kernels 5-8
(``repro_torch.kernels.ref``) against the Pallas kernels in interpret mode,
the port's wire periods against ``repro.core.consensus``, the compressed
backend and the epoch step against the reference, and the trainer's CLI.

Tolerances, and why:
* One kernel call: bitwise (codes, scales and every f32 output).  The plain
  versions round each multiply-add as the reference's jitted programs do
  (``ref.fma`` where XLA fuses).  ``bucketed_gossip_round_2d`` rounds
  ``fma(a, round(q s), acc)`` where the bucketed wire that users run rounds
  ``fma(round(a s), q, acc)``; the port follows the wire.  The two agree
  when both products are exact, so that Pallas kernel is compared on a
  dyadic A with power-of-two input scales, and the wire's jnp round body
  on a Metropolis A with any scales.
* Per-leaf wire and the synchronous bucketed wire over several rounds:
  bitwise.
* The bounded-staleness wire over several rounds: XLA leaves the encode's
  multiply-add unfused for some elements of its stale loop body (ROADMAP
  Queue 3), so an int8 code may sit one step off the port's (fused)
  rounding; its chunk then carries another reference and scale for the
  rounds after.  Asserted: int4 bitwise; int8 at most three such events
  (3 * M * chunk elements differ), each by at most 2% of the iterate's
  range.
* The epoch step: the local period's f32 sums run in another order, so the
  wire's inputs differ by ~1e-7 and a code near a rounding edge can move by
  one step.  Asserted: losses rtol 1e-4; parameters and EF residual within
  one int8 step of the round-0 scale (atol 2e-3 on weights of scale 0.02)
  and at most 0.1% of the entries beyond rtol/atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import compressors as jcp  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.kernels import consensus_mix as jk  # noqa: E402
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

T = torch.from_numpy


def _metropolis(m: int) -> np.ndarray:
    if m == 1:
        return np.ones((1, 1), np.float32)
    return jtp.metropolis_weights(jtp.ring_graph(m)).astype(np.float32)


def _dyadic(m: int) -> np.ndarray:
    if m == 1:
        return np.ones((1, 1), np.float32)
    a = np.eye(m, dtype=np.float32) * 0.5
    for i in range(m):
        a[i, (i + 1) % m] += 0.25
        a[i, (i - 1) % m] += 0.25
    return a


def _inputs(m, d, chunk, bits, seed):
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    f = lambda s: (rng.standard_normal((m, d)) * s).astype(np.float32)  # noqa: E731
    return dict(
        w=f(1.0), ref=f(0.5), acc=f(0.5),
        u=rng.random((m, d)).astype(np.float32),
        codes=rng.integers(-qmax, qmax + 1, size=(m, d)).astype(np.int8),
        scales=(rng.random((m, d // chunk)) * 0.02 + 1e-3).astype(
            np.float32))


def _equal(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(
            g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g),
            np.asarray(w), err_msg=name)


OUT4 = ("acc/mixed", "ref", "codes", "scales")


# ---------------------------------------------------------------------------
# one call: plain version vs Pallas kernel (interpret mode), bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,chunk", [(1, 16), (4, 16), (5, 256)])
def test_plain_versions_match_pallas_kernels(m, chunk, bits):
    d = 2048
    x = _inputs(m, d, chunk, bits, seed=m * 31 + chunk + bits)
    kw = dict(bits=bits, chunk=chunk)
    pk = dict(bits=bits, chunk=chunk, block_d=512, interpret=True)
    a, ad = _metropolis(m), _dyadic(m)

    _equal(ref.quantized_gossip_encode_ref(T(x["w"]), T(x["ref"]),
                                           T(x["u"]), **kw),
           jk.quantized_gossip_encode_2d(x["w"], x["ref"], x["u"], **pk),
           ("codes", "scales"))
    _equal(ref.quantized_gossip_round_ref(T(a), T(x["codes"]),
                                          T(x["scales"]), T(x["ref"]),
                                          T(x["u"]), **kw),
           jk.quantized_gossip_round_2d(a, x["codes"], x["scales"], x["ref"],
                                        x["u"], **pk), OUT4)
    _equal(ref.bucketed_gossip_round_pipelined_ref(
               T(a), T(x["codes"]), T(x["scales"]), T(x["w"]), T(x["ref"]),
               T(x["acc"]), T(x["u"]), **kw),
           jk.bucketed_gossip_round_pipelined_2d(
               a, x["codes"], x["scales"], x["w"], x["ref"], x["acc"],
               x["u"], **pk), OUT4)
    s2 = np.exp2(np.round(np.log2(x["scales"]))).astype(np.float32)
    _equal(ref.bucketed_gossip_round_ref(T(ad), T(x["codes"]), T(s2),
                                         T(x["ref"]), T(x["acc"]),
                                         T(x["u"]), **kw),
           jk.bucketed_gossip_round_2d(ad, x["codes"], s2, x["ref"],
                                       x["acc"], x["u"], **pk),
           OUT4)


@pytest.mark.parametrize("bits", [8, 4])
def test_bucketed_round_matches_the_wire_body_on_metropolis(bits):
    """The bucketed round against the synchronous body of the reference's
    ``gossip_scan_wire_bucketed`` (folded ``(a s) q`` order), jitted, on a
    non-dyadic A."""
    m, d, chunk = 4, 4096, 16
    x = _inputs(m, d, chunk, bits, seed=bits)
    a = _metropolis(m)
    codec = jcp.StochasticQuantizer(bits=bits, chunk=chunk)

    @jax.jit
    def body(codes, scales, r, acc, u):
        c3 = codes.astype(jnp.float32).reshape(m, -1, chunk)
        r = r + (c3 * scales[..., None]).reshape(m, d)
        ws = a[:, :, None] * scales
        acc3 = acc.reshape(m, -1, chunk)
        for j in range(m):
            acc3 = acc3 + ws[:, j, :, None] * c3[j]
        acc = acc3.reshape(m, d)
        comp = codec.compress(acc - r, dither=u)
        return acc, r, comp.data, comp.scale

    _equal(ref.bucketed_gossip_round_ref(T(a), T(x["codes"]),
                                         T(x["scales"]), T(x["ref"]),
                                         T(x["acc"]), T(x["u"]), bits=bits,
                                         chunk=chunk),
           body(x["codes"], x["scales"], x["ref"], x["acc"], x["u"]), OUT4)


def test_ops_dispatch_on_cpu_runs_plain_and_counts_nothing():
    """On the CPU each wire entry point runs its plain version and, as on
    the card, writes the results into the state operands and output
    buffers it was given."""
    m, d, chunk = 4, 512, 16
    x = {k: T(v) for k, v in _inputs(m, d, chunk, 8, seed=0).items()}
    a = T(_metropolis(m))
    ops.reset_launch_counts()

    def state(*names):
        return [x[k].clone() for k in names]

    st = state("codes", "scales", "ref", "acc")
    out = ops.bucketed_gossip_round(a, *st, x["u"], chunk=chunk)
    assert out[0] is st[3] and out[1] is st[2] and out[2] is st[0] \
        and out[3] is st[1]
    _equal(out, ref.bucketed_gossip_round_ref(
        a, x["codes"], x["scales"], x["ref"], x["acc"], x["u"], chunk=chunk),
        OUT4)
    st = state("codes", "scales", "ref", "acc")
    pipe = ops.bucketed_gossip_round_pipelined(
        a, st[0], st[1], x["w"], st[2], st[3], x["u"], chunk=chunk)
    assert pipe[0] is st[3] and pipe[2] is st[0]
    _equal(pipe, ref.bucketed_gossip_round_pipelined_ref(
        a, x["codes"], x["scales"], x["w"], x["ref"], x["acc"], x["u"],
        chunk=chunk), OUT4)
    st = state("codes", "scales")
    enc = ops.quantized_gossip_encode(x["w"], x["ref"], x["u"], *st,
                                      chunk=chunk)
    assert enc[0] is st[0] and enc[1] is st[1]
    _equal(enc, ref.quantized_gossip_encode_ref(x["w"], x["ref"], x["u"],
                                                chunk=chunk),
           ("codes", "scales"))
    st = state("codes", "scales", "ref")
    mixed = torch.empty_like(x["ref"])
    leaf = ops.quantized_gossip_round(a, *st, mixed, x["u"], chunk=chunk)
    assert leaf[0] is mixed and leaf[1] is st[2]
    _equal(leaf, ref.quantized_gossip_round_ref(
        a, x["codes"], x["scales"], x["ref"], x["u"], chunk=chunk), OUT4)
    counts = ops.launch_counts()
    assert all(v == 0 for v in counts.values()), counts
    assert {"quantized_gossip_encode", "bucketed_gossip_round",
            "bucketed_gossip_round_pipelined",
            "quantized_gossip_round"} <= set(counts)
    with pytest.raises(ValueError, match="divide D"):
        ref.quantized_gossip_encode_ref(x["w"][:, :100], x["ref"][:, :100],
                                        x["u"][:, :100], chunk=32)
    with pytest.raises(ValueError, match="bits"):
        ref.quantized_gossip_encode_ref(x["w"], x["ref"], x["u"], bits=3)


def test_fma_rounds_once():
    """``ref.fma`` is the correctly rounded a*b+c: checked in exact
    rational arithmetic on the cases where it differs from the
    two-rounding form, and it does differ on some."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.standard_normal(100_000).astype(np.float32)
    b = rng.standard_normal(100_000).astype(np.float32)
    c = rng.standard_normal(100_000).astype(np.float32)
    got = ref.fma(T(a), T(b), T(c)).numpy()
    idx = np.flatnonzero(got != a * b + c)
    assert idx.size > 0
    for i in idx[:300]:
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        err = abs(Fraction(float(got[i])) - exact)
        for nb in (np.nextafter(got[i], np.float32(np.inf)),
                   np.nextafter(got[i], np.float32(-np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact)


# ---------------------------------------------------------------------------
# wire periods: port vs reference
# ---------------------------------------------------------------------------


def _tree(m, seed, shapes=((6, 33), (960,), (5, 7))):
    rng = np.random.default_rng(seed)
    return {f"l{i}": (rng.standard_normal((m,) + s) * 2).astype(np.float32)
            for i, s in enumerate(shapes)}


def _run_ref(fn, tree, **kw):
    out = jax.jit(lambda t: fn(t, **kw))({k: jnp.asarray(v)
                                          for k, v in tree.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("t_server", [1, 2, 5])
def test_gossip_scan_wire_matches_reference(bits, t_server):
    m, chunk, block = 4, 16, 256
    tree = _tree(m, seed=t_server)
    a = _metropolis(m)
    jc = jcp.StochasticQuantizer(bits=bits, chunk=chunk)
    tc = tcp.StochasticQuantizer(bits=bits, chunk=chunk)
    want = _run_ref(lambda t: jcns.gossip_scan_wire(
        jnp.asarray(a), t, t_server, jc, jax.random.key(5), block=block),
        tree)
    got = tcns.gossip_scan_wire(T(a), {k: T(v) for k, v in tree.items()},
                                t_server, tc, prng.key(5), block=block)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("staleness,t_server", [(0, 2), (0, 5), (1, 5),
                                                (2, 5)])
def test_gossip_scan_wire_bucketed_matches_reference(bits, staleness,
                                                     t_server):
    m, chunk, block = 4, 16, 1024
    tree = _tree(m, seed=staleness)
    a = _metropolis(m)
    jc = jcp.StochasticQuantizer(bits=bits, chunk=chunk)
    tc = tcp.StochasticQuantizer(bits=bits, chunk=chunk)
    want = _run_ref(lambda t: jcns.gossip_scan_wire_bucketed(
        jnp.asarray(a), t, t_server, jc, jax.random.key(3), block=block,
        staleness=staleness), tree)
    got = tcns.gossip_scan_wire_bucketed(
        T(a), {k: T(v) for k, v in tree.items()}, t_server, tc,
        prng.key(3), block=block, staleness=staleness)
    g = np.concatenate([got[k].numpy().reshape(m, -1) for k in tree], 1)
    w = np.concatenate([want[k].reshape(m, -1) for k in tree], 1)
    if staleness == 0 or bits == 4:
        np.testing.assert_array_equal(g, w)
        return
    # one code off by one step spreads over its chunk and, through A, to the
    # neighbours' rows: at most three such events in the period
    diff = g != w
    span = float(np.abs(w).max())
    assert diff.sum() <= 3 * m * chunk, diff.sum()
    assert np.abs(g - w).max() <= 0.02 * span, np.abs(g - w).max()


def test_wire_rounds_freeze_until_a_delayed_buffer_lands():
    m, chunk = 4, 16
    tree = {k: T(v) for k, v in _tree(m, seed=9).items()}
    tc = tcp.StochasticQuantizer(bits=8, chunk=chunk)
    a = T(_metropolis(m))
    same = tcns.gossip_scan_wire_bucketed(a, tree, 2, tc, prng.key(1),
                                          staleness=2)
    for k in tree:
        assert torch.equal(same[k], tree[k])
    assert tcns.gossip_scan_wire_bucketed(a, tree, 0, tc) is tree
    with pytest.raises(ValueError, match="staleness"):
        tcns.gossip_scan_wire_bucketed(a, tree, 2, tc, staleness=-1)
    with pytest.raises(TypeError, match="float32"):
        tcns.gossip_scan_wire_bucketed(a, {"w": tree["l0"].double()}, 2, tc)


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_trees_match_reference(bits):
    m, chunk = 3, 16
    tree = _tree(m, seed=bits)
    jc = jcp.StochasticQuantizer(bits=bits, chunk=chunk)
    tc = tcp.StochasticQuantizer(bits=bits, chunk=chunk)
    tt = {k: T(v) for k, v in tree.items()}
    for t_fn, j_fn in ((tcns.bucketed_roundtrip_tree,
                        jcns.bucketed_roundtrip_tree),
                       (tcns.wire_roundtrip_tree, jcns.wire_roundtrip_tree)):
        for key, jkey in ((prng.key(2), jax.random.key(2)), (None, None)):
            want = _run_ref(lambda t: j_fn(jc, t, jkey, block=256, rnd=1),
                            tree)
            got = t_fn(tc, tt, key, block=256, rnd=1)
            for k in tree:
                np.testing.assert_array_equal(got[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# the compressed backend, error feedback, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("staleness", [0, 1])
def test_compressed_backend_with_error_feedback(staleness):
    """The port's physical-wire period with EF against the reference's,
    bitwise (mixed tree and residual); the residual, computed from round
    0's own codes, against ``corrected - bucketed_roundtrip_tree``."""
    m = 4
    a = jtp.metropolis_weights(jtp.ring_graph(m))
    tree = _tree(m, seed=11)
    res0 = {k: v * 0.01 for k, v in _tree(m, seed=12).items()}
    jbe = jcns.make_backend("gossip", a, 3, compression="int8:16",
                            error_feedback=True, wire="physical",
                            staleness=staleness, block=1024)
    tbe = tcns.make_backend("gossip", a, 3, compression="int8:16",
                            error_feedback=True, wire="physical",
                            staleness=staleness, block=1024)
    assert tbe.name == jbe.name and tbe.staleness == staleness
    jmix, jres = jax.jit(lambda t, r: jbe.mix_compressed(
        t, residual=r, key=jax.random.key(4)))(
        {k: jnp.asarray(v) for k, v in tree.items()},
        {k: jnp.asarray(v) for k, v in res0.items()})
    tt = {k: T(v) for k, v in tree.items()}
    tres = {k: T(v).clone() for k, v in res0.items()}
    tmix, tnew = tbe.mix_compressed(tt, residual=tres, key=prng.key(4))
    assert tnew is tres                      # updated in place
    for k in tree:
        np.testing.assert_array_equal(tmix[k].numpy(), np.asarray(jmix[k]))
        np.testing.assert_array_equal(tnew[k].numpy(), np.asarray(jres[k]))
    # the residual reuses round 0's codes: it is what the round-trip of the
    # corrected tree ships, up to the residual's one rounding
    corrected = {k: T(tree[k] + res0[k]) for k in tree}
    shipped = tcns.bucketed_roundtrip_tree(tbe.compressor, corrected,
                                           prng.key(4), block=1024)
    eps = float(np.finfo(np.float32).eps)
    for k in tree:
        torch.testing.assert_close(
            tnew[k], corrected[k] - shipped[k], rtol=0,
            atol=eps * float(corrected[k].abs().max()))
    # the plain ConsensusBackend interface: deterministic rounding, no EF
    jplain = jax.jit(jbe.mix)({k: jnp.asarray(v) for k, v in tree.items()})
    tplain = tbe.mix(tt)
    for k in tree:
        np.testing.assert_array_equal(tplain[k].numpy(),
                                      np.asarray(jplain[k]))


def test_backend_refusals():
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    q = tcp.StochasticQuantizer()
    wire = dict(compression="int8", wire="physical")
    # the simulated wire is the default; the physical one takes quantizers
    sim = tcns.make_backend("gossip", a, 3, compression="int8")
    assert sim.wire == "simulated" and sim.name == \
        jcns.make_backend("gossip", a, 3, compression="int8").name
    with pytest.raises(ValueError, match="quantizers"):
        tcns.make_backend("gossip", a, 3, compression="top_k:0.1",
                          wire="physical")
    for mode in ("collapsed", "exact_mean"):
        with pytest.raises(ValueError, match="per-round"):
            tcns.make_backend(mode, a, 3, **wire)
        with pytest.raises(ValueError, match="staleness"):
            tcns.make_backend(mode, a, 3, staleness=1, **wire)
    with pytest.raises(ValueError, match="wire must be"):
        tcns.make_backend("gossip", a, 3, compression="int8", wire="pigeon")
    with pytest.raises(ValueError, match="quantizers"):
        tcns.make_backend("gossip", a, 3, compression="identity",
                          wire="physical")
    with pytest.raises(ValueError, match=">= 0"):
        tcns.make_backend("gossip", a, 3, staleness=-1, **wire)
    # without compression staleness runs the plain stale rounds
    assert tcns.make_backend("gossip_blocked", a, 3, staleness=2).staleness \
        == 2
    inner = tcns.GossipBackend(a, 3)
    be = tcns.CompressedBackend(inner, q, wire="physical")
    with pytest.raises(ValueError, match="already-compressed"):
        tcns.CompressedBackend(be, q, wire="physical")
    with pytest.raises(ValueError, match="incoherent"):
        tcns.CompressedBackend(tcns.GossipBackend(a, 3, staleness=1), q)
    assert tcns.make_backend("none", a, 3, **wire) is None
    blocked = tcns.make_backend("gossip_blocked", a, 3, staleness=1, **wire)
    assert blocked.wire_block == tcns.DEFAULT_GOSSIP_BLOCK


# ---------------------------------------------------------------------------
# the slice end to end: the epoch step and the trainer's CLI
# ---------------------------------------------------------------------------

ARCH = "smollm-360m"
TOPO = dict(num_servers=4, clients_per_server=2, t_client=2, t_server=3,
            graph_kind="ring")
SEQ, BATCH, GAMMA = 16, 2, 0.05
WIRE = dict(compression="int8", error_feedback=True, wire="physical")


def _close_but_for_codes(got, want):
    """rtol/atol 1e-4 for all but 0.1% of the entries, and those within one
    int8 step of the round-0 scale (weights of scale 0.02: atol 2e-3)."""
    far = ~np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert far.mean() <= 1e-3, far.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("staleness", [0, 1])
def test_epoch_step_with_physical_wire_matches_reference(staleness):
    from repro.configs import get_smoke as j_get_smoke
    from repro.core import dfl as jdfl
    from repro.core.topology import FLTopology as JTopology
    from repro.models import transformer as jtf
    from repro.optim import sgd as j_sgd
    from repro_torch.configs import get_smoke
    from repro_torch.core import dfl as tdfl
    from repro_torch.core.topology import FLTopology
    from repro_torch.data import DataConfig, FLDataPipeline
    from repro_torch.models import transformer as ttf
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves

    jcfg = j_get_smoke(ARCH)
    jparams = jtf.init_params(jax.random.key(7), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    pipe = FLDataPipeline(FLTopology(**TOPO), DataConfig(
        seq_len=SEQ, per_client_batch=BATCH, vocab_size=jcfg.vocab_size,
        seed=0))
    jtopo = JTopology(**TOPO)
    cfg = jdfl.DFLConfig(topology=jtopo, staleness=staleness, **WIRE)
    opt = j_sgd(GAMMA)
    jstep = jax.jit(jdfl.build_dfl_epoch_step(
        cfg, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)), opt))
    jstate = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))

    tcfg = tdfl.DFLConfig(topology=FLTopology(**TOPO), staleness=staleness,
                          **WIRE)
    topt = sgd(GAMMA)
    tstep = tdfl.build_dfl_epoch_step(tcfg, ttf.make_loss_fn(get_smoke(ARCH)),
                                      topt)
    tstate = tdfl.init_dfl_state(tcfg, ttf.params_from_numpy(np_params),
                                 topt, wire_key=prng.key(1))
    for epoch in range(2):
        tokens = pipe.epoch_batches(epoch)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens.numpy())})
        tstate, tm = tstep(tstate, {"tokens": tokens})
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-4, atol=1e-4)
        for g, w in zip(tree_leaves(tstate.client_params),
                        jax.tree.leaves(jstate.client_params)):
            _close_but_for_codes(g.numpy(), np.asarray(w))
        for g, w in zip(tree_leaves(tstate.ef_residual),
                        jax.tree.leaves(jstate.ef_residual)):
            _close_but_for_codes(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            tstate.wire_key, np.asarray(jax.random.key_data(jstate.rng)))
    assert tstate.epoch == 2


def test_epoch_step_refusals():
    from repro_torch.core import dfl as tdfl
    from repro_torch.core.topology import FLTopology
    from repro_torch.data import make_regression_task
    from repro_torch.optim import sgd
    topo = FLTopology(num_servers=3, clients_per_server=2, t_client=2,
                      t_server=2)
    loss = make_regression_task(topo)["loss_fn"]
    for bad, err in ((dict(staleness=-1), ValueError),
                     (dict(staleness=1, consensus_mode="none"), ValueError),
                     (dict(compression="int8", staleness=1), ValueError),
                     (dict(compression="int8", wire="physical",
                           consensus_mode="collapsed"), ValueError)):
        with pytest.raises(err):
            tdfl.build_dfl_epoch_step(tdfl.DFLConfig(topology=topo, **bad),
                                      loss, sgd(0.1))
    # the default wire is the simulated one, which builds and runs
    from repro.core import dfl as jdfl
    from repro.core.topology import FLTopology as JTopology
    sim = tdfl.DFLConfig(topology=topo, compression="int8")
    jsim = jdfl.DFLConfig(topology=JTopology(
        num_servers=3, clients_per_server=2, t_client=2, t_server=2),
        compression="int8")
    assert tdfl.active_wire(sim) == jdfl.active_wire(jsim) == (
        "simulated", tcns.DEFAULT_GOSSIP_BLOCK)
    tdfl.build_dfl_epoch_step(sim, loss, sgd(0.1))
    cfg = tdfl.DFLConfig(topology=topo, **WIRE)
    with pytest.raises(ValueError, match="wire_key"):
        tdfl.init_dfl_state(cfg, {"w": torch.zeros(3)}, sgd(0.1))
    state = tdfl.init_dfl_state(cfg, {"w": torch.zeros(3)}, sgd(0.1),
                                wire_key=prng.key(0))
    assert state.ef_residual["w"].shape == (3, 3)
    assert tdfl.active_compressor(cfg).name == "int8"
    assert tdfl.active_wire(cfg) == ("physical", tcns.DEFAULT_GOSSIP_BLOCK)


@pytest.mark.parametrize("staleness", [0, 1])
def test_cli_trains_on_the_physical_wire_on_cpu(capsys, staleness):
    from repro.core import schedule as jsched
    from repro_torch.launch import train as ttrain
    ttrain.main(["--device", "cpu", "--servers", "3", "--clients", "2",
                 "--t-client", "1", "--t-server", "2", "--epochs", "2",
                 "--seq-len", "16", "--compression", "int8", "--wire",
                 "physical", "--error-feedback", "--staleness",
                 str(staleness)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch")]
    assert len(lines) == 2 and all("wire_mb=" in ln for ln in lines)
    out = ttrain.train(ARCH, smoke=True, servers=3, clients=2, t_client=1,
                       t_server=2, epochs=1, seq_len=16, device="cpu",
                       log=False, staleness=staleness, **WIRE)
    # the stale period advances the chain T_S // (s + 1) rounds an epoch
    sigma = jsched.SigmaTracker(3, staleness=staleness).update(
        jtp.metropolis_weights(jtp.ring_graph(3)), 2)
    assert out["history"]["sigma_prod"] == [sigma]
    from repro.launch.train import _StaticWireLedger
    from repro.configs import get_smoke as j_get_smoke
    from repro.core import dfl as jdfl
    from repro.core.topology import FLTopology as JTopology
    from repro.models import transformer as jtf
    jcfg = jdfl.DFLConfig(topology=JTopology(
        num_servers=3, clients_per_server=2, t_client=1, t_server=2,
        graph_kind="ring"), **WIRE)
    ledger = _StaticWireLedger(jcfg, jtf.init_params(
        jax.random.key(0), j_get_smoke(ARCH)), jdfl.active_compressor(jcfg))
    assert out["history"]["wire_mb"] == [ledger.update() / 1e6]
    assert out["history"]["wire_ratio"] == [ledger.tracker.ratio()]
    assert np.isfinite(out["history"]["loss"]).all()


# ---------------------------------------------------------------------------
# bf16 leaves on the wires: the kernels stay f32, the bf16 values ride in
# f32 (exactly), rounded to bf16 where the reference stores them
# ---------------------------------------------------------------------------


def _bf16_tree(m, seed, scale=1.0):
    """A tree rounded to bf16: (JAX tree, port tree) with equal bits."""
    tree = {k: v * np.float32(scale) for k, v in _tree(m, seed=seed).items()}
    j = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in tree.items()}
    t = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(
        torch.bfloat16) for k, v in j.items()}
    return j, t


def _assert_bits(got, want):
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype))
        np.testing.assert_array_equal(
            got[k].float().numpy(),
            np.asarray(jnp.asarray(want[k]).astype(jnp.float32)), err_msg=k)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout,staleness", [("bucketed", 0),
                                              ("bucketed", 1),
                                              ("per_leaf", 0)])
def test_bf16_wire_periods_match_reference_exactly(bits, layout, staleness):
    """A bf16 tree on the physical wire: every round's iterate is rounded to
    bf16 before the next encode (kernel 6 re-encodes after kernel 7 or 5;
    kernel 8 encodes a rounded copy), the output leaves are bf16, and the
    period is the reference's bit for bit, so every code and scale it
    shipped was the reference's."""
    m, chunk, t_s = 4, 16, 5
    jt, tt = _bf16_tree(m, seed=30 + bits)
    a = _metropolis(m)
    jc = jcp.StochasticQuantizer(bits=bits, chunk=chunk)
    tc = tcp.StochasticQuantizer(bits=bits, chunk=chunk)
    if layout == "bucketed":
        want = jax.jit(lambda t: jcns.gossip_scan_wire_bucketed(
            jnp.asarray(a), t, t_s, jc, jax.random.key(3), block=1024,
            staleness=staleness))(jt)
        got = tcns.gossip_scan_wire_bucketed(
            T(a), tt, t_s, tc, prng.key(3), block=1024, staleness=staleness)
    else:
        want = jax.jit(lambda t: jcns.gossip_scan_wire(
            jnp.asarray(a), t, t_s, jc, jax.random.key(3), block=256))(jt)
        got = tcns.gossip_scan_wire(T(a), tt, t_s, tc, prng.key(3),
                                    block=256)
    _assert_bits(got, want)


def test_mixed_dtype_bucket_rides_in_the_first_leafs_dtype():
    """A tree of bf16 and f32 leaves is one bucket in the FIRST leaf's
    dtype: the f32 leaves round to bf16 on the way in and come back f32,
    as the reference's ``_bucket_flat`` / ``_bucket_split`` do."""
    m = 4
    jt, tt = _bf16_tree(m, seed=35)
    f32 = _tree(m, seed=36)
    jt["l2"], tt["l2"] = jnp.asarray(f32["l2"]), T(f32["l2"])
    a = _metropolis(m)
    jc = jcp.StochasticQuantizer(bits=8, chunk=16)
    tc = tcp.StochasticQuantizer(bits=8, chunk=16)
    want = jax.jit(lambda t: jcns.gossip_scan_wire_bucketed(
        jnp.asarray(a), t, 3, jc, jax.random.key(3), block=1024))(jt)
    got = tcns.gossip_scan_wire_bucketed(T(a), tt, 3, tc, prng.key(3),
                                         block=1024)
    _assert_bits(got, want)
    assert got["l2"].dtype == torch.float32


@pytest.mark.parametrize("staleness", [0, 1])
def test_bf16_physical_wire_with_error_feedback(staleness):
    """EF on a bf16 tree: the correction ``x + e`` and the residual
    ``c - q`` in bf16, q the round-0 decode rounded to bf16; the mixed tree
    and the residual are the reference's bit for bit."""
    m = 4
    a = jtp.metropolis_weights(jtp.ring_graph(m))
    jt, tt = _bf16_tree(m, seed=37)
    jr, tr = _bf16_tree(m, seed=38, scale=0.01)
    kw = dict(compression="int8:16", error_feedback=True, wire="physical",
              staleness=staleness, block=1024)
    jbe = jcns.make_backend("gossip", a, 3, **kw)
    tbe = tcns.make_backend("gossip", a, 3, **kw)
    jmix, jres = jax.jit(lambda t, r: jbe.mix_compressed(
        t, residual=r, key=jax.random.key(4)))(jt, jr)
    tmix, tnew = tbe.mix_compressed(tt, residual=tr, key=prng.key(4))
    assert tnew is tr
    _assert_bits(tmix, jmix)
    _assert_bits(tnew, jres)


@pytest.mark.parametrize("spec", ["int8:16", "int4:16", "random_k:0.5"])
def test_bf16_simulated_wire_messages_and_residual(spec):
    """The simulated wire on a bf16 tree: the message is rounded to bf16
    before the inner period mixes it (so kernel 4 decodes on A = I and
    kernel 1's bf16 instance mixes; nothing is fused), bitwise the
    reference's message; with EF the jitted reference encodes ``x + e``
    before rounding it to bf16 (XLA keeps the fused add in f32) and the
    residual subtracts the rounded message from the rounded sum, and the
    port does the same, bitwise.  The mixed tree is within the bf16 gossip
    bound of ``test_torch_consensus.py`` (T_S steps of 2^-8 of the largest
    value), since the reference contracts with A rounded to bf16.  (Top-k
    is left out: bf16 magnitudes tie often, and ``jax.lax.top_k`` and
    ``torch.topk`` break ties differently; ROADMAP Queue 3.)"""
    from repro.comm import error_feedback as jef
    from repro_torch.comm import error_feedback as tef
    m, t_s = 4, 3
    a = jtp.metropolis_weights(jtp.ring_graph(m))
    jt, tt = _bf16_tree(m, seed=39)
    jr, tr = _bf16_tree(m, seed=40, scale=0.01)
    jc = jcp.make_compressor(spec)
    tc = tcp.make_compressor(spec)
    jmsg = jax.jit(lambda t: jcp.roundtrip_tree(jc, t, jax.random.key(6)))(jt)
    _assert_bits(tcp.roundtrip_tree(tc, tt, prng.key(6)), jmsg)
    jmsg, jres = jax.jit(lambda t, r: jef.ef_roundtrip(
        jc, t, r, jax.random.key(6)))(jt, jr)
    tmsg, tres = tef.ef_roundtrip(tc, tt, tr, prng.key(6))
    _assert_bits(tmsg, jmsg)
    _assert_bits(tres, jres)
    jbe = jcns.make_backend("gossip", a, t_s, compression=spec)
    tbe = tcns.make_backend("gossip", a, t_s, compression=spec)
    want = jax.jit(lambda t: jbe.mix_compressed(t, key=jax.random.key(7)))(
        jt)[0]
    got = tbe.mix_compressed(tt, key=prng.key(7))[0]
    top = max(float(np.abs(np.asarray(v, np.float32)).max())
              for v in jt.values())
    for k in jt:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_allclose(
            got[k].float().numpy(),
            np.asarray(want[k].astype(jnp.float32)), rtol=0,
            atol=t_s * 2.0 ** -8 * top)
