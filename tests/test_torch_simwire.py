"""Port parity for the simulated wire (quantize once per period): threefry
bits and ``uniform`` against ``jax.random``, ``keyed_index_sample``, the
top-k / random-k / quantizer round trips and ``ef_roundtrip`` against the
JAX package's jitted programs, kernel 4's plain version against the Pallas
kernel in interpret mode, ``CompressedBackend(wire="simulated")`` over every
ported inner backend, the epoch step, and the trainer's CLI and ledger.

Tolerances, and why:
* Random bits, uniform floats, sampled indices, byte counts: bitwise or
  exact (integer arithmetic).
* Round trips and EF residuals: bitwise.  The inputs are made so that a
  fused ``fma(x, 1/s, u)`` and an unfused ``x * (1/s) + u`` give other
  codes in about a tenth of the elements, and likewise the residual's
  ``fma(-q, s, c)`` against ``c - round(q s)``; every program of the
  reference fuses the encode, and fuses the residual except where a row is
  longer than a chunk and not a multiple of it.  So any code one step off
  would show; none is allowed.
* Kernel 4's plain version against the Pallas kernel: rtol 1e-6, atol
  1e-5, the reference's own test of that kernel (its contraction is a dot,
  the port's a left-to-right fma chain).
* Simulated periods and epoch steps: rtol/atol 2e-5, the float-gossip
  parity tolerance of the port (the contraction runs in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import accounting as jacc  # noqa: E402
from repro.comm import compressors as jcp  # noqa: E402
from repro.comm import error_feedback as jef  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.kernels import consensus_mix as jk  # noqa: E402
from repro_torch.comm import accounting as tacc  # noqa: E402
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.comm import error_feedback as tef  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

T = torch.from_numpy
PARITY = dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# threefry bits, uniform, keyed_index_sample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape,block", [
    (0, (7,), 4), (3, (4, 33, 5), 64), (5, (), 8)])
def test_random_bits_and_uniform_match_jax(seed, shape, block):
    """Bitwise, including shapes larger than one block of rows."""
    kd = prng.key(seed)
    want_bits = np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                           jnp.uint32))
    got_bits = prng.random_bits(kd, shape, block=block).numpy()
    np.testing.assert_array_equal(got_bits, want_bits.astype(np.int64))
    # the same key again: uniform's bits ARE these bits, as in jax.random
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
    got = prng.uniform(kd, shape, block=block).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_into_padded_rows_and_offsets():
    """``out=`` fills the real columns of a padded buffer; ``start`` offsets
    the flat index (server s of a leaf starts at s * prod(w))."""
    want = np.asarray(jax.random.uniform(jax.random.key(2), (3, 10, 7)))
    buf = torch.full((3, 10, 8), -1.0)
    for s in range(3):
        prng.uniform(prng.key(2), (10, 7), out=buf[s, :, :7], start=s * 70,
                     block=16)
    np.testing.assert_array_equal(buf[..., :7].numpy(), want)
    assert bool((buf[..., 7] == -1.0).all())
    with pytest.raises(ValueError, match="shape"):
        prng.uniform(prng.key(0), (3, 7), out=torch.empty(3, 8))


@pytest.mark.parametrize("d,k,seed", [(2, 1, 0), (1000, 50, 5),
                                      (4097, 4097, 0), (123_457, 6_000, 5)])
def test_keyed_index_sample_matches_reference(d, k, seed):
    want = np.asarray(jcp.keyed_index_sample(jax.random.key(seed), d, k))
    got = tcp.keyed_index_sample(prng.key(seed), d, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) == k


def test_keyed_index_sample_refusals():
    with pytest.raises(ValueError, match="0 < k <= d"):
        tcp.keyed_index_sample(prng.key(0), 5, 6)
    with pytest.raises(ValueError, match="2\\^31"):
        tcp.keyed_index_sample(prng.key(0), 2 ** 31, 5)


# ---------------------------------------------------------------------------
# round trips: top-k, random-k, the quantizers, error feedback
# ---------------------------------------------------------------------------


def _crafted(rng, shape, bits, chunk):
    """Inputs on which fused and unfused roundings of the quantizer part:
    ``x`` such that ``x * (1/s) + u`` lands within an ulp of an integer, for
    the dither ``u`` the reference draws for leaf 0."""
    qmax = 2 ** (bits - 1) - 1
    n = shape[-1] if shape else 1
    rows = int(np.prod(shape)) // n
    kc = n if n <= chunk else chunk
    u = np.asarray(jax.random.uniform(jax.random.fold_in(KEY, 0), shape))
    u = u.reshape(rows, n).astype(np.float64)
    nc = -(-n // kc)
    am = (rng.uniform(0.5, 1.0, (rows, nc)) * 0.05).astype(np.float32)
    inv = np.float32(1) / (am * np.float32(1.0 / qmax)).astype(np.float32)
    inv_e = np.repeat(inv, kc, axis=-1)[:, :n].astype(np.float64)
    q = rng.integers(-qmax + 2, qmax - 1, (rows, n))
    am_e = np.repeat(am, kc, axis=-1)[:, :n]
    x = np.clip(((q - u) / inv_e).astype(np.float32), -am_e, am_e)
    x[:, ::kc] = am_e[:, ::kc]
    return x.reshape(shape)


KEY = jax.random.key(3)
# last axes: head-dim 64 (under a chunk), 960-like ragged (over a chunk, not
# a multiple), 2560-like (a chunk multiple), a 1-D parameter, and a scalar
# parameter (one value a server: the reference chunks it across servers)
TREE_SHAPES = {"a_q": (4, 3, 64), "b_ragged": (4, 5, 300),
               "c_mlp": (4, 2, 512), "d_norm": (4, 96), "e_scalar": (4,)}


def _tree(rng, bits=8, chunk=256, crafted=True):
    return {k: (_crafted(rng, s, bits, chunk) if crafted else
                (rng.standard_normal(s) * 0.05).astype(np.float32))
            for k, s in TREE_SHAPES.items()}


@pytest.mark.parametrize("spec", ["int8", "int4:32", "top_k:0.1",
                                  "random_k:0.2"])
def test_roundtrip_tree_and_ef_roundtrip_match_jitted_reference(spec):
    rng = np.random.default_rng(0)
    jq, tq = jcp.make_compressor(spec), tcp.make_compressor(spec)
    bits = getattr(tq, "bits", 8)
    chunk = getattr(tq, "chunk", 256)
    tree = _tree(rng, bits, chunk, crafted=spec.startswith("int"))
    res = {k: (0.002 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    jr = {k: jnp.asarray(v) for k, v in res.items()}
    tt = {k: T(v) for k, v in tree.items()}
    tr = {k: T(v) for k, v in res.items()}
    want = jax.jit(lambda t: jcp.roundtrip_tree(jq, t, KEY))(jt)
    got = tcp.roundtrip_tree(tq, tt, prng.key(3))
    jmsg, jres = jax.jit(
        lambda t, r: jef.ef_roundtrip(jq, t, r, KEY))(jt, jr)
    tmsg, tres = tef.ef_roundtrip(tq, tt, tr, prng.key(3))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(tmsg[k].numpy(), np.asarray(jmsg[k]))
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
    assert tcp.tree_wire_bytes_per_server(tq, tt) == \
        jcp.tree_wire_bytes_per_server(jq, jt)


def test_crafted_inputs_tell_the_roundings_apart():
    """The inputs above do discriminate: an unfused encode would move about
    a tenth of the codes by one step."""
    rng = np.random.default_rng(0)
    x = _crafted(rng, (4, 3, 64), 8, 256)
    got = tcp.roundtrip_tree(tcp.StochasticQuantizer(), {"a": T(x)},
                             prng.key(3))["a"].numpy()
    u = prng.uniform(prng.fold_in(prng.key(3), 0), x.shape).numpy()
    s = np.abs(x).max(-1, keepdims=True) * np.float32(1 / 127)
    unfused = np.floor((x * (np.float32(1) / s)).astype(np.float32) + u) * s
    assert np.mean(unfused != got) > 0.05


@pytest.mark.parametrize("spec", ["top_k:0.05", "random_k:0.3"])
def test_sparsifier_compress_matches_reference(spec):
    rng = np.random.default_rng(1)
    x = rng.permutation(4 * 700).reshape(4, 700).astype(np.float32) - 1400
    jq, tq = jcp.make_compressor(spec), tcp.make_compressor(spec)
    jc = jq.compress(jnp.asarray(x), key=jax.random.key(5))
    tc = tq.compress(T(x), key=prng.key(5))
    order = np.argsort(np.asarray(jc.idx), axis=-1)
    torder = np.argsort(tc.idx.numpy(), axis=-1)
    np.testing.assert_array_equal(
        np.take_along_axis(tc.idx.numpy(), torder, -1),
        np.take_along_axis(np.asarray(jc.idx), order, -1))
    np.testing.assert_array_equal(tq.decompress(tc, 700).numpy(),
                                  np.asarray(jq.decompress(jc, 700)))
    for d in (1, 700, 49_152_000):
        assert tq.wire_bytes_per_row(d) == jq.wire_bytes_per_row(d)
        assert tacc.analytic_row_bytes(tq, d) == \
            jacc.analytic_row_bytes(jq, d)


def test_make_compressor_grammar():
    for spec in ("top_k:0.05", "random_k:0.1", "int4:64", "identity"):
        assert tcp.make_compressor(spec) == tcp.make_compressor(spec)
        assert tcp.make_compressor(spec).name == \
            jcp.make_compressor(spec).name
    for bad in ("top_k", "random_k:", "top_k:0", "random_k:1.5"):
        with pytest.raises(ValueError):
            tcp.make_compressor(bad)
    with pytest.raises(ValueError, match="shared rng key"):
        tcp.make_compressor("random_k:0.5").compress(torch.ones(2, 4))


# ---------------------------------------------------------------------------
# kernel 4: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,d,bits,chunk,block", [
    (5, 1024, 8, 128, 512),     # multi-tile, multi-chunk per tile
    (4, 1000, 8, 256, 512),     # ragged tail
    (3, 130, 4, 64, 128),       # int4
    (6, 37, 8, 256, 2048),      # single partial chunk
])
def test_quantized_consensus_mix_plain_matches_pallas(m, d, bits, chunk,
                                                      block):
    """The shapes of ``tests/test_kernels_misc.py``; the plain version takes
    whole chunks, so the ragged tail is zero-padded as the Pallas wrapper
    pads it (a zero codes to 0 and mixes to 0)."""
    from repro.core.consensus import collapse_mixing
    a = collapse_mixing(jtp.metropolis_weights(jtp.ring_graph(m)),
                        7).astype(np.float32)
    rng = np.random.default_rng(d)
    w = (rng.standard_normal((m, d)) * 3).astype(np.float32)
    u = rng.uniform(0, 1, (m, d)).astype(np.float32)
    want = np.asarray(jk.quantized_consensus_mix_2d(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(u), bits=bits,
        chunk=chunk, block_d=block))
    pad = -(-d // chunk) * chunk - d
    wp, up = (torch.nn.functional.pad(T(x), (0, pad)) for x in (w, u))
    got = ops.quantized_consensus_mix(T(a), wp, up, bits=bits, chunk=chunk)
    np.testing.assert_allclose(got[:, :d].numpy(), want, rtol=1e-6,
                               atol=1e-5)
    assert not bool(got[:, d:].any())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_consensus_mix_identity_is_the_round_trip(bits):
    """With A = I the chain is exact: the output is D(C(w)) bitwise, the
    reference quantizer's decompress(compress(w, dither=u))."""
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((4, 512)) * 0.1).astype(np.float32)
    u = rng.uniform(0, 1, (4, 512)).astype(np.float32)
    jq = jcp.StochasticQuantizer(bits=bits, chunk=64)
    want = jax.jit(lambda x, v: jq.decompress(jq.compress(x, dither=v),
                                              512))(w, u)
    got = ops.quantized_consensus_mix(torch.eye(4), T(w), T(u), bits=bits,
                                      chunk=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_consensus_mix_refusals_and_counter():
    a, w = torch.eye(2), torch.ones(2, 8)
    with pytest.raises(ValueError, match="bits"):
        ops.quantized_consensus_mix(a, w, w * 0.5, bits=3, chunk=4)
    with pytest.raises(ValueError, match="divide"):
        ops.quantized_consensus_mix(a, w, w * 0.5, chunk=3)
    with pytest.raises(TypeError, match="float32"):
        ops.quantized_consensus_mix(a, w.double(), w * 0.5, chunk=4)
    ops.reset_launch_counts()
    out = torch.empty(2, 8)
    assert ops.quantized_consensus_mix(a, w, w * 0.5, chunk=4,
                                       out=out) is out
    assert ops.launch_counts()["quantized_consensus_mix"] == 0  # CPU


# ---------------------------------------------------------------------------
# CompressedBackend(wire="simulated")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,spec,ef", [
    *[(mode, "int8", False) for mode in ("gossip", "gossip_blocked",
                                         "collapsed", "exact_mean")],
    *[(mode, "int4:32", True) for mode in ("gossip", "gossip_blocked",
                                           "collapsed", "exact_mean")],
    ("gossip", "top_k:0.2", True), ("collapsed", "random_k:0.3", False)])
def test_simulated_backend_matches_reference(mode, spec, ef):
    """The period at the parity tolerance; the EF residual within one
    rounding of ``q s`` (XLA fuses ``c - q s`` inside some backends'
    programs where ``ef_roundtrip`` alone leaves it unfused)."""
    rng = np.random.default_rng(7)
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    tree = _tree(rng, crafted=False)
    res = {k: (0.002 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    jbe = jcns.make_backend(mode, a, 4, compression=spec, error_feedback=ef,
                            block=256)
    tbe = tcns.make_backend(mode, a, 4, compression=spec, error_feedback=ef,
                            block=256)
    assert tbe.name == jbe.name
    jres = {k: jnp.asarray(v) for k, v in res.items()} if ef else None
    tres = {k: T(v) for k, v in res.items()} if ef else None
    jout, jnew = jax.jit(lambda t, r: jbe.mix_compressed(
        t, residual=r, key=KEY))({k: jnp.asarray(v) for k, v in tree.items()},
                                 jres)
    tout, tnew = tbe.mix_compressed({k: T(v) for k, v in tree.items()},
                                    residual=tres, key=prng.key(3))
    eps = float(np.finfo(np.float32).eps)
    for k in tree:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   **PARITY)
        if ef:
            np.testing.assert_allclose(
                tnew[k].numpy(), np.asarray(jnew[k]), rtol=0,
                atol=eps * float(np.abs(tree[k] + res[k]).max()))
    if not ef:
        assert tnew is None and jnew is None


def test_simulated_backend_launches_and_plain_mix():
    """On the CPU every route runs the plain versions (no launch counted);
    ``mix`` is the period without EF and with deterministic rounding."""
    rng = np.random.default_rng(2)
    a = jtp.metropolis_weights(jtp.ring_graph(4))
    tree = _tree(rng, crafted=False)
    jbe = jcns.make_backend("gossip", a, 3, compression="int8")
    tbe = tcns.make_backend("gossip", a, 3, compression="int8")
    ops.reset_launch_counts()
    got = tbe.mix({k: T(v) for k, v in tree.items()})
    assert all(v == 0 for v in ops.launch_counts().values())
    want = jax.jit(jbe.mix)({k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **PARITY)


# ---------------------------------------------------------------------------
# the epoch step: twins of tests/test_comm.py:271-352
# ---------------------------------------------------------------------------


def _regression(t_s=6):
    from repro.core.topology import FLTopology as JTopology
    from repro_torch.core.topology import FLTopology
    from repro_torch.data import RegressionSpec, make_regression_task
    kw = dict(num_servers=4, clients_per_server=2, t_client=3, t_server=t_s,
              graph_kind="ring")
    topo = FLTopology(**kw)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5),
                                seed=0)
    return topo, JTopology(**kw), task


def _run(topo, task, epochs, **cfg):
    from repro_torch.core import dfl as tdfl
    from repro_torch.optim import sgd
    opt = sgd(1e-3)
    c = tdfl.DFLConfig(topology=topo, **cfg)
    step = tdfl.build_dfl_epoch_step(c, task["loss_fn"], opt)
    state = tdfl.init_dfl_state(c, torch.zeros(2), opt, wire_key=prng.key(0))
    for _ in range(epochs):
        state, _ = step(state, task["batches"])
    return state


def test_compression_none_is_bitwise_the_default_path():
    topo, _, task = _regression()
    s0 = _run(topo, task, 2)
    s1 = _run(topo, task, 2, compression="none", error_feedback=True)
    assert s1.ef_residual is None
    np.testing.assert_array_equal(s0.client_params.numpy(),
                                  s1.client_params.numpy())


def test_identity_compression_epoch_step_is_exact():
    topo, _, task = _regression()
    s0 = _run(topo, task, 2)
    s1 = _run(topo, task, 2, compression="identity", error_feedback=True)
    np.testing.assert_array_equal(s0.client_params.numpy(),
                                  s1.client_params.numpy())
    assert float(s1.ef_residual.abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["gossip", "gossip_blocked", "collapsed"])
def test_int8_ef_epoch_step_converges_near_uncompressed(mode):
    """int8 + EF: finite, within 5% of the exact path's scale after four
    epochs, the residual live -- and each epoch at the port's parity
    tolerance of the reference's jitted epoch step on the same inputs."""
    from repro.core import dfl as jdfl
    from repro.optim import sgd as j_sgd
    from repro_torch.core import dfl as tdfl
    from repro_torch.optim import sgd
    topo, jtopo, task = _regression(t_s=8)
    s_ref = _run(topo, task, 4, consensus_mode=mode)
    cfg = dict(consensus_mode=mode, compression="int8:16",
               error_feedback=True)
    jcfg = jdfl.DFLConfig(topology=jtopo, **cfg)
    tcfg = tdfl.DFLConfig(topology=topo, **cfg)

    def j_loss(w, batch, rng):
        xx, yy = batch
        return 0.5 * jnp.mean((xx @ w - yy) ** 2), {}

    jstep = jax.jit(jdfl.build_dfl_epoch_step(jcfg, j_loss, j_sgd(1e-3)))
    tstep = tdfl.build_dfl_epoch_step(tcfg, task["loss_fn"], sgd(1e-3))
    jstate = jdfl.init_dfl_state(jcfg, jnp.zeros((2,)), j_sgd(1e-3),
                                 jax.random.key(0))
    tstate = tdfl.init_dfl_state(tcfg, torch.zeros(2), sgd(1e-3),
                                 wire_key=prng.key(0))
    jb = tuple(jnp.asarray(b.numpy()) for b in task["batches"])
    for _ in range(4):
        jstate, _ = jstep(jstate, jb)
        tstate, _ = tstep(tstate, task["batches"])
        np.testing.assert_allclose(tstate.client_params.numpy(),
                                   np.asarray(jstate.client_params),
                                   **PARITY)
        np.testing.assert_array_equal(
            tstate.wire_key, np.asarray(jax.random.key_data(jstate.rng)))
    out, want = tstate.client_params.numpy(), s_ref.client_params.numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - want).max() < 0.05 * np.abs(want).max(), mode
    assert float(tstate.ef_residual.abs().max()) > 0


# ---------------------------------------------------------------------------
# the trainer: CLI and ledger
# ---------------------------------------------------------------------------


def _j_ledger(jtopo_kw, compression, arch_params, wire="simulated"):
    from repro.core import dfl as jdfl
    from repro.core.topology import FLTopology as JTopology
    from repro.launch.train import _StaticWireLedger
    jcfg = jdfl.DFLConfig(topology=JTopology(**jtopo_kw),
                          compression=compression, wire=wire)
    return _StaticWireLedger(jcfg, arch_params, jdfl.active_compressor(jcfg))


def test_cli_trains_on_the_simulated_wire_on_cpu(capsys):
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import transformer as jtf
    from repro_torch.launch import train as ttrain
    ttrain.main(["--device", "cpu", "--servers", "4", "--clients", "2",
                 "--t-client", "2", "--t-server", "5", "--epochs", "2",
                 "--seq-len", "16", "--compression", "int8"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch")]
    assert len(lines) == 2
    ledger = _j_ledger(dict(num_servers=4, clients_per_server=2, t_client=2,
                            t_server=5, graph_kind="ring"), "int8",
                       jtf.init_params(jax.random.key(0),
                                       j_get_smoke("smollm-360m")))
    for ln in lines:
        mb = ledger.update() / 1e6
        assert f"wire_mb={mb:.1f}" in ln
        assert f"wire_ratio={ledger.tracker.ratio():.2f}" in ln


@pytest.mark.parametrize("spec", ["int4", "top_k:0.05", "random_k:0.05"])
def test_train_runs_every_simulated_compressor(spec):
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import transformer as jtf
    from repro_torch.launch import train as ttrain
    out = ttrain.train("smollm-360m", smoke=True, servers=4, clients=2,
                       t_client=1, t_server=3, epochs=1, seq_len=16,
                       compression=spec, error_feedback=True, device="cpu",
                       log=False)
    ledger = _j_ledger(dict(num_servers=4, clients_per_server=2, t_client=1,
                            t_server=3, graph_kind="ring"), spec,
                       jtf.init_params(jax.random.key(0),
                                       j_get_smoke("smollm-360m")))
    assert out["history"]["wire_mb"] == [ledger.update() / 1e6]
    assert out["history"]["wire_ratio"] == [ledger.tracker.ratio()]
    assert np.isfinite(out["history"]["loss"]).all()


def test_full_size_ledger_matches_reference():
    """Full SmolLM-360M shapes, nothing allocated (meta tensors against
    ``jax.eval_shape``): 369,940,432 bytes a server a round, 14,797.62 MB an
    epoch over 8 live links x 5 rounds, ratio 3.9122 (int8, chunk 256)."""
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as jtf
    from repro_torch.configs import get_arch
    from repro_torch.core import dfl as tdfl
    from repro_torch.core.topology import FLTopology
    from repro_torch.launch.train import _StaticWireLedger
    from repro_torch.models import transformer as ttf
    kw = dict(num_servers=4, clients_per_server=2, t_client=2, t_server=5,
              graph_kind="ring")
    jparams = jax.eval_shape(lambda k: jtf.init_params(
        k, j_get_arch("smollm-360m")), jax.random.key(0))
    tparams = ttf.init_params(torch.Generator(), get_arch("smollm-360m"),
                              device="meta")
    for wire in ("simulated", "physical"):
        jl = _j_ledger(kw, "int8", jparams, wire=wire)
        tcfg = tdfl.DFLConfig(topology=FLTopology(**kw), compression="int8",
                              wire=wire)
        tl = _StaticWireLedger(tcfg, tparams, tdfl.active_compressor(tcfg))
        assert tl._row == jl._row and tl._elems == jl._elems == 361_821_120
        assert tl.update() == jl.update()
        assert tl.tracker.ratio() == jl.tracker.ratio()
        if wire == "simulated":
            assert tl._row == 361_821_120 + 4 * 2_029_828
            assert round(tl.tracker.total_bytes / 1e6, 2) == 14_797.62
            assert round(tl.tracker.ratio(), 4) == 3.9122
