"""Port parity for ``repro_torch.comm`` against ``repro.comm`` and
``jax.random``: int4 packing, the bucket layout, the threefry keys and the
wire dither, the quantizer's encode/decode, the byte accounting.

Tolerance: none.  Every comparison here is bitwise (codes, scales, dither,
keys) or exact integer equality (bytes): the quantizer rounds its
multiply-add as one fused rounding, as the reference's jitted encoder does,
and the dither hash is integer arithmetic."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import accounting as jacc  # noqa: E402
from repro.comm import compressors as jcp  # noqa: E402
from repro_torch.comm import accounting as tacc  # noqa: E402
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.comm import error_feedback as tef  # noqa: E402
from repro_torch.comm import prng  # noqa: E402


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# int4 packing, bucket layout, keys, dither
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (3, 7), (2, 5, 9)])
def test_pack_unpack_int4_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(-8, 8, size=shape).astype(np.int8)
    packed = tcp.pack_int4(torch.from_numpy(codes))
    want = _np(jcp.pack_int4(jnp.asarray(codes)))
    np.testing.assert_array_equal(packed.numpy(), want)
    back = tcp.unpack_int4(packed, shape[-1])
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), _np(jcp.unpack_int4(jnp.asarray(want), shape[-1])))


def test_bucket_block_matches_reference():
    for d_tot in (1, 7, 960, 4099, 361_821_120):
        for block in (32, 4096, 4_194_304):
            for chunk in (1, 15, 16, 256, 960):
                assert tcp.bucket_block(d_tot, block, chunk) == \
                    jcp.bucket_block(d_tot, block, chunk)


def test_prng_matches_jax_random():
    for seed in (0, 1, 7, 2 ** 31 - 1):
        k = jax.random.key(seed)
        np.testing.assert_array_equal(prng.key(seed),
                                      _np(jax.random.key_data(k)))
        for data in (0, 3, 2 ** 32 - 1):
            np.testing.assert_array_equal(
                prng.fold_in(prng.key(seed), data),
                _np(jax.random.key_data(jax.random.fold_in(k, data))))
        np.testing.assert_array_equal(
            prng.split(prng.key(seed), 3),
            _np(jax.random.key_data(jax.random.split(k, 3))))
        # the epoch's chain: split, keep the first, split again
        a, b = prng.split(prng.split(prng.key(seed))[0])
        j1, j2 = jax.random.split(jax.random.split(k)[0])
        np.testing.assert_array_equal(a, _np(jax.random.key_data(j1)))
        np.testing.assert_array_equal(b, _np(jax.random.key_data(j2)))


def test_mix32_matches_reference():
    x = np.random.default_rng(0).integers(0, 2 ** 32, size=4096,
                                          dtype=np.uint64)
    got = tcp._mix32(torch.from_numpy(x.astype(np.int64)))
    want = _np(jcp._mix32(jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("cell", [(0, 0, 0, 0), (2, 5, 3, 1), (0, 4, 1, 0)])
def test_wire_dither_matches_reference(cell):
    leaf, rnd, server, block = cell
    n = 5000
    for seed in (0, 3):
        got = tcp.wire_dither(prng.key(seed), n, leaf=leaf, rnd=rnd,
                              server=server, block=block)
        want = _np(jcp.wire_dither(jax.random.key(seed), (n,), leaf=leaf,
                                   rnd=rnd, server=server, block=block))
        np.testing.assert_array_equal(got.numpy(), want)
        # a column slab of the cell is the same slice of it
        part = tcp.wire_dither(prng.key(seed), n, leaf=leaf, rnd=rnd,
                               server=server, block=block, start=1234,
                               stop=4321)
        np.testing.assert_array_equal(part.numpy(), want[1234:4321])


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,chunk", [((4, 4096), 16), ((3, 1000), 256),
                                         ((2, 6, 50), 16)])
def test_encode_decode_bitwise(bits, shape, chunk):
    rng = np.random.default_rng(bits + chunk)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, ..., :chunk] = 0.0                       # an all-zero chunk
    u = rng.random(shape).astype(np.float32)
    tq = tcp.StochasticQuantizer(bits=bits, chunk=chunk)
    jq = jcp.StochasticQuantizer(bits=bits, chunk=chunk)
    codes, scales = tq.encode_block(torch.from_numpy(x), torch.from_numpy(u))
    jcodes, jscales = jax.jit(jq.encode_block)(jnp.asarray(x),
                                               jnp.asarray(u))
    np.testing.assert_array_equal(codes.numpy(), _np(jcodes))
    np.testing.assert_array_equal(scales.numpy(), _np(jscales))
    d = shape[-1]
    np.testing.assert_array_equal(
        tq.decode_block(codes, scales, d).numpy(),
        _np(jq.decode_block(jcodes, jscales, d)))
    # deterministic rounding (no dither): u = 0.5
    np.testing.assert_array_equal(
        tq.compress(torch.from_numpy(x)).data.numpy(),
        _np(jax.jit(jq.compress)(jnp.asarray(x)).data))
    if d % chunk == 0:
        np.testing.assert_array_equal(
            tq.code_chunks(codes, d).numpy(),
            _np(jq.code_chunks(jcodes, d)))
    else:
        with pytest.raises(ValueError, match="chunk-multiple"):
            tq.code_chunks(codes, d)


def test_quantizer_bytes_and_specs_match_reference():
    for spec in ("int8", "int4", "int8:64", "int4:960", "identity"):
        tq, jq = tcp.make_compressor(spec), jcp.make_compressor(spec)
        assert tq.name == jq.name and tq.wire_bits_data == jq.wire_bits_data
        for shape in ((4, 960), (4, 33, 7), (2, 49152, 960), (3, 1)):
            assert tq.wire_bytes_per_leaf(shape) == \
                jq.wire_bytes_per_leaf(shape), (spec, shape)
            assert tacc.analytic_leaf_bytes(tq, shape) == \
                jacc.analytic_leaf_bytes(jq, shape)
        assert tq.wire_bytes_per_row(1001) == jq.wire_bytes_per_row(1001)
        assert tacc.analytic_row_bytes(tq, 1001) == \
            jacc.analytic_row_bytes(jq, 1001)
        if spec != "identity":
            assert tq.wire_block_bytes(4099) == jq.wire_block_bytes(4099)
    with pytest.raises(ValueError, match="disables"):
        tcp.make_compressor("none")
    with pytest.raises(ValueError, match="unknown"):
        tcp.make_compressor("int16")
    for spec in ("top_k:0.05", "random_k:0.1"):     # the simulated wire's
        tq, jq = tcp.make_compressor(spec), jcp.make_compressor(spec)
        assert tq.name == jq.name and tq.ratio == jq.ratio
        for shape in ((4, 960), (4, 33, 7), (2, 49152, 960)):
            assert tq.wire_bytes_per_leaf(shape) == \
                jq.wire_bytes_per_leaf(shape), (spec, shape)
    with pytest.raises(ValueError, match="bits"):
        tcp.StochasticQuantizer(bits=3)
    # a key draws the simulated wire's threefry uniform dither, bitwise
    x = np.random.default_rng(0).standard_normal((2, 300)).astype(np.float32)
    got = tcp.StochasticQuantizer().compress(torch.from_numpy(x),
                                             key=prng.key(0))
    want = jcp.StochasticQuantizer().compress(jnp.asarray(x),
                                              key=jax.random.key(0))
    np.testing.assert_array_equal(got.data.numpy(), _np(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), _np(want.scale))


def test_simulated_wire_pieces_raise_and_ef_init():
    """The simulated wire's pieces run (they raised before their slice):
    ``roundtrip_tree`` without a key rounds to nearest, as the reference's;
    the EF residual starts at zero."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((3, 2, 2)).astype(np.float32)}
    got = tcp.roundtrip_tree(tcp.StochasticQuantizer(),
                             {k: torch.from_numpy(v) for k, v in tree.items()})
    want = jcp.roundtrip_tree(jcp.StochasticQuantizer(),
                              {k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
    res = tef.init_ef_residual(got)
    assert all(torch.equal(res[k], torch.zeros_like(got[k])) for k in tree)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def test_physical_byte_layouts_match_reference():
    shapes = [(4, 49152, 960), (4, 960), (4, 32, 960, 2560), (4, 7)]
    jtree = {f"l{i}": jax.ShapeDtypeStruct(s, jnp.float32)
             for i, s in enumerate(shapes)}
    ttree = {f"l{i}": torch.empty(s, device="meta")
             for i, s in enumerate(shapes)}
    for spec in ("int8", "int4", "int8:16"):
        tq, jq = tcp.make_compressor(spec), jcp.make_compressor(spec)
        for block in (4_194_304, 1000):
            for s in shapes:
                assert tacc.physical_leaf_bytes(tq, s, block) == \
                    jacc.physical_leaf_bytes(jq, s, block)
            assert tacc.tree_physical_wire_bytes_per_server(
                tq, ttree, block) == \
                jacc.tree_physical_wire_bytes_per_server(jq, jtree, block)
            assert tacc.tree_bucketed_wire_bytes_per_server(
                tq, ttree, block) == \
                jacc.tree_bucketed_wire_bytes_per_server(jq, jtree, block)
        assert tcp.tree_message_elems(ttree) == \
            jcp.tree_message_elems(jtree)
    with pytest.raises(ValueError, match="quantizers"):
        tacc.physical_leaf_bytes(tcp.IdentityCompressor(), (4, 8), 16)


@pytest.mark.parametrize("push_sum,wire", [(False, "physical"),
                                           (True, "simulated"),
                                           (True, "physical")])
def test_bytes_tracker_matches_reference(push_sum, wire):
    from repro.core import topology as jtp
    tq, jq = tcp.make_compressor("int8"), jcp.make_compressor("int8")
    t = tacc.BytesTracker(tq, push_sum=push_sum, wire=wire)
    j = jacc.BytesTracker(jq, push_sum=push_sum, wire=wire)
    assert t.ratio() == j.ratio() == 1.0
    a_ring = jtp.metropolis_weights(jtp.ring_graph(4))
    a_line = jtp.metropolis_weights(jtp.line_graph(4))
    for a in (a_ring, a_line):
        assert t.update(a, 5, row_bytes=1234, elems_per_row=1000) == \
            j.update(a, 5, row_bytes=1234, elems_per_row=1000)
        np.testing.assert_array_equal(t.per_link, j.per_link)
        assert t.ratio() == j.ratio()
    many_t = t.update_many([a_ring, a_line], 3, row_bytes=99,
                           elems_per_row=50)
    many_j = j.update_many([a_ring, a_line], 3, row_bytes=99,
                           elems_per_row=50)
    for (bt, rt, lt), (bj, rj, lj) in zip(many_t, many_j):
        assert (bt, rt) == (bj, rj)
        np.testing.assert_array_equal(lt, lj)
    assert t.history == j.history
    assert (t.total_bytes, t.baseline_bytes) == (j.total_bytes,
                                                 j.baseline_bytes)
