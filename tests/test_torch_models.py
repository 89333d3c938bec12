"""Port parity: ``repro_torch.models`` against ``repro.models`` on the
SmolLM smoke config (2 layers, d = 120, 3/1 heads), the reference's
``init_params`` carried over with ``params_from_numpy``, tokens from a numpy
seed.  Tolerances: logits and loss atol 1e-4 (f32 matmuls over d = 120 and
a 512-way softmax, summed in another order); gradients rtol/atol 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.models import modules as tnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_unflatten)

ARCH = "smollm-360m"
REF_OPTS = jtf.ApplyOptions(remat=False)


@pytest.fixture(scope="module")
def carried():
    jcfg = j_get_smoke(ARCH)
    jparams = jtf.init_params(jax.random.key(3), jcfg)
    tparams = ttf.params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 16))
    return jcfg, jparams, tparams, tokens


def test_config_copy_matches_reference():
    cfg, jcfg = get_smoke(ARCH), j_get_smoke(ARCH)
    assert cfg.__dict__ == jcfg.__dict__
    assert get_arch(ARCH).param_count() == 361_821_120
    # the MoE/MLA families resolve too, to the reference's configs
    assert dataclasses.asdict(get_arch("mixtral-8x22b")) == \
        dataclasses.asdict(j_get_arch("mixtral-8x22b"))


def test_params_carry_over_with_same_key_paths(carried):
    jcfg, jparams, tparams, _ = carried
    jleaves = jax.tree.leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert [tuple(x.shape) for x in jleaves] == \
        [tuple(t.shape) for t in tleaves]
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    own = ttf.init_params(torch.Generator().manual_seed(0), get_smoke(ARCH))
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tleaves]
    assert sum(t.numel() for t in tree_leaves(own)) == \
        get_smoke(ARCH).param_count()


def test_logits_and_loss_match_reference(carried):
    jcfg, jparams, tparams, tokens = carried
    jlogits, _ = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                             opts=REF_OPTS)
    tlogits, _ = ttf.forward(tparams, get_smoke(ARCH),
                             {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    jloss, _ = jtf.make_loss_fn(jcfg, REF_OPTS)(
        jparams, {"tokens": jnp.asarray(tokens)}, None)
    tloss, aux = ttf.make_loss_fn(get_smoke(ARCH))(
        tparams, {"tokens": torch.from_numpy(tokens)}, None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-4)
    assert float(aux["aux"]) == 0.0


def test_chunked_loss_matches_one_chunk(carried):
    _, _, tparams, tokens = carried
    batch = {"tokens": torch.from_numpy(tokens)}
    whole = ttf.make_loss_fn(get_smoke(ARCH))(tparams, batch, None)[0]
    chunked = ttf.make_loss_fn(get_smoke(ARCH), loss_chunk=4)(
        tparams, batch, None)[0]
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_grads_match_jax_grad(carried):
    jcfg, jparams, tparams, tokens = carried
    jgrads = jax.grad(lambda p: jtf.make_loss_fn(jcfg, REF_OPTS)(
        p, {"tokens": jnp.asarray(tokens)}, None)[0])(jparams)
    leaves = tree_leaves(tparams)
    live = [t.clone().requires_grad_(True) for t in leaves]
    treedef = tree_flatten(tparams)[1]
    loss, _ = ttf.make_loss_fn(get_smoke(ARCH))(
        tree_unflatten(treedef, live), {"tokens": torch.from_numpy(tokens)},
        None)
    grads = tree_unflatten(treedef, list(torch.autograd.grad(loss, live)))
    for path in (("embed",), ("stack", 0, "ffn", "down"),
                 ("stack", 0, "ln1", "scale")):
        g, jg = grads, jgrads
        for key in path:
            g, jg = g[key], jg[key]
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_rope_and_attention_match_reference():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    np.testing.assert_allclose(
        tnn.apply_rope(torch.from_numpy(q), torch.from_numpy(pos.copy()),
                       1e4).numpy(),
        np.asarray(jnn.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        rtol=0, atol=1e-5)
    for window, cap in ((None, None), (3, 5.0)):
        got = tnn.dispatch_attend(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window, attn_softcap=cap)
        want = jnn.dispatch_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, attn_softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        got = tnn.dispatch_attend(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window, attn_softcap=cap,
                                  attn_impl="kernel")
        want = jnn.dispatch_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, attn_softcap=cap,
                                   attn_impl="pallas")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="'kernel'"):
        tnn.dispatch_attend(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, window=None,
                            attn_softcap=None, attn_impl="pallas")


@pytest.mark.parametrize("shape", ["bqk", "b1qk"])
def test_mha_attend_takes_batched_masks(shape):
    """(b, sq, sk) and (b, 1, sq, sk) masks broadcast over the batch axis,
    as in the reference — here a different key mask per sequence."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    k = rng.standard_normal((3, 5, 1, 8)).astype(np.float32)
    v = rng.standard_normal((3, 5, 1, 8)).astype(np.float32)
    mask = rng.random((3, 4, 5)) < 0.7
    mask[..., 0] = True
    if shape == "b1qk":
        mask = mask[:, None]
    got = tnn.mha_attend(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(mask),
                         attn_softcap=None)
    want = jnn.mha_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), attn_softcap=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,cap", [(True, None, None),
                                               (True, 12, 25.0),
                                               (False, None, None)])
def test_attend_chunked_matches_reference_forward_and_grads(causal, window,
                                                            cap):
    """The port's chunked attention (online softmax forward, backward
    recomputed chunk by chunk from the saved lse) against the reference's
    ``attend_chunked`` (its custom VJP), with chunk 16 < sk = 40 so the loop
    runs three steps, the last one ragged.  rtol/atol 1e-4: gradients sum
    over chunks in another order."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    g = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, attn_softcap=cap, chunk=16)

    def jloss(qq, kk, vv):
        return jnp.sum(jnn.attend_chunked(qq, kk, vv, **kw) * g)

    jout = jnn.attend_chunked(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tnn.attend_chunked(*leaves, **kw)
    assert out.dtype == torch.float32
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_reference_route_goes_chunked_above_1024_keys():
    """Above ``FULL_ATTEND_MAX_KEYS`` keys the reference route runs
    ``attend_chunked`` (no (b, h, s, s) scores), as the reference's does."""
    assert tnn.FULL_ATTEND_MAX_KEYS == jnn.FULL_ATTEND_MAX_KEYS == 1024
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1100, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 1100, 1, 8)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tnn.dispatch_attend(tq, tk, tv, causal=True, window=None,
                              attn_softcap=None)
    want = jnn.dispatch_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=None,
                               attn_softcap=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got, tnn.attend_chunked(
        tq, tk, tv, causal=True, window=None, attn_softcap=None),
        rtol=0, atol=0)


def test_tree_helpers_leave_no_reference_cycle():
    """Flattening and unflattening a tree keeps no tensor alive past its last
    reference (a self-recursive closure would, until the cyclic collector
    ran: at full size, tens of GB of freed buffers held on the card)."""
    import gc
    import weakref
    from repro_torch.tree import tree_unflatten
    t = torch.zeros(8)
    alive = weakref.ref(t)
    gc.disable()
    try:
        leaves, treedef = tree_flatten({"a": t, "b": (t, [None, t])})
        out = tree_unflatten(treedef, leaves)
        assert out["b"][1][1] is t
        del t, leaves, out
        assert alive() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the Mamba-2 path (mamba2-780m smoke: 2 layers, d = 128, d_state 16)
# ---------------------------------------------------------------------------

MAMBA = "mamba2-780m"


@pytest.fixture(scope="module")
def mamba_carried():
    jcfg = j_get_smoke(MAMBA)
    jparams = jtf.init_params(jax.random.key(4), jcfg)
    tparams = ttf.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 24))
    return jcfg, jparams, tparams, tokens


def test_mamba_params_have_reference_key_paths(mamba_carried):
    """The port's own init has the reference tree's key paths and shapes:
    ``ln2`` kept though a mamba block never reads it, no ``ffn``."""
    _, jparams, _, _ = mamba_carried
    own = ttf.init_params(torch.Generator().manual_seed(0), get_smoke(MAMBA))
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves = tree_leaves(own)
    assert len(leaves) == len(jflat)
    for leaf, (path, want) in zip(leaves, jflat):
        assert tuple(leaf.shape) == want.shape, jax.tree_util.keystr(path)
    assert sorted(own["stack"][0]) == sorted(jparams["stack"][0]) == \
        ["ln1", "ln2", "mixer"]
    assert sorted(own["stack"][0]["mixer"]) == \
        sorted(jparams["stack"][0]["mixer"])


@pytest.mark.parametrize("t_impl,j_impl", [("reference", "reference"),
                                           ("kernel", "pallas")])
def test_mamba_forward_matches_reference(mamba_carried, t_impl, j_impl):
    """Logits at atol 1e-4 (a 512-way head over d = 128 after two mixers
    whose scans sum in another order); ``attn_impl="kernel"`` takes kernel
    9's plain version here, the reference's ``"pallas"`` its SSD kernel in
    interpret mode."""
    jcfg, jparams, tparams, tokens = mamba_carried
    jlogits, _ = jtf.forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)},
        opts=jtf.ApplyOptions(remat=False, attn_impl=j_impl))
    with torch.no_grad():
        tlogits, aux = ttf.forward(
            tparams, get_smoke(MAMBA), {"tokens": torch.from_numpy(tokens)},
            opts=ttf.ApplyOptions(attn_impl=t_impl))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)
    assert float(aux) == 0.0


def _on_dense_base(jname: str, field: str, cls):
    """The dense SmolLM smoke config with the reference's ``field`` (its MoE
    or MLA section) of ``jname``'s smoke config."""
    jcfg = j_get_smoke(jname)
    return dataclasses.replace(
        get_smoke(ARCH), name=jcfg.name,
        **{field: cls(**dataclasses.asdict(getattr(jcfg, field)))})


def test_moe_and_mla_blocks_build_on_a_dense_base():
    """An MoE FFN (with its router) and an MLA mixer (with its latent
    down-projection) build on the dense SmolLM base and run a prefill.  The
    registry and the stack plans are held against the reference's in
    ``tests/test_torch_moe_mla.py``."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, get_smoke(ARCH).vocab_size, size=(1, 8)))
    for jname, field, cls in (("mixtral_8x22b", "moe", tcfg.MoEConfig),
                              ("deepseek_v2_236b", "mla", tcfg.MLAConfig)):
        cfg = _on_dense_base(jname, field, cls)
        params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
        block = params["stack"][0]
        assert ("router" in block["ffn"]) == (field == "moe")
        assert ("w_dkv" in block["mixer"]) == (field == "mla")
        logits, _ = ttf.prefill(params, cfg, {"tokens": tokens}, max_len=8)
        assert logits.shape == (1, 1, cfg.padded_vocab_size)
        assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


def test_mla_prefill_longer_than_its_cache_raises():
    """An MLA prefill whose prompt outgrows its latent cache raises, where
    the reference needs ``max_len`` to cover the prompt."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, get_smoke(ARCH).vocab_size, size=(1, 8)))
    cfg = _on_dense_base("deepseek_v2_236b", "mla", tcfg.MLAConfig)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="cannot hold an? 8-position"):
        ttf.prefill(params, cfg, {"tokens": tokens}, max_len=7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gemma_embedding_scale_is_bitwise_the_reference(dtype):
    """The Gemma family scales embeddings by sqrt(d_model) rounded to the
    activation dtype (``repro.models.transformer._embed``).  At d = 4608 in
    bf16, sqrt(d) = 67.88 rounds to 68.0, so an unrounded scale changes a
    third of the products; the port's ``_embed`` must equal the reference
    bit for bit in bf16 and in f32."""
    d, vocab = 4608, 96
    jcfg = dataclasses.replace(j_get_smoke(ARCH), d_model=d,
                               vocab_size=vocab, final_logit_softcap=30.0)
    cfg = dataclasses.replace(get_smoke(ARCH), d_model=d, vocab_size=vocab,
                              final_logit_softcap=30.0)
    rng = np.random.default_rng(16)
    table = jnp.asarray(rng.standard_normal((vocab, d)).astype(np.float32)
                        ).astype(getattr(jnp, dtype))
    tokens = rng.integers(0, vocab, size=(2, 24))
    want = np.asarray(jtf._embed({"embed": table}, jcfg,
                                 jnp.asarray(tokens)))
    bits = np.asarray(table).view(np.int16 if dtype == "bfloat16"
                                  else np.int32)
    ttable = torch.from_numpy(bits.copy()).view(getattr(torch, dtype))
    got = ttf._embed({"embed": ttable}, cfg, torch.from_numpy(tokens))
    assert got.dtype == getattr(torch, dtype)
    int_t = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(got.view(int_t).numpy(),
                                  want.view(bits.dtype))
