"""Port parity for the serving path: ``repro_torch`` prefill, KV cache and
decode against ``repro.models.transformer`` on smoke configs (the dense
archs and Mamba2, whose cache is a conv window and an SSM state).

The reference's ``init_params`` is carried over with ``params_from_numpy``
and the prompts are numpy-made.  The reference prefills with
``attn_impl="pallas"`` (its flash-attention kernel, in interpret mode on the
CPU); the port with ``attn_impl="kernel"`` (on a CPU tensor: the kernel's
plain version, ``attention_ref``).  A mamba layer's prefill runs the
reference's ``ssd_chunked`` in the reference and, on the port's kernel
route, kernel 9's plain version.  Tolerances: logits 1e-4 (f32 matmuls and
softmaxes summed in another order), cache k/v and the conv window 1e-5 (a
few f32 products deep), the SSM state 1e-4 (a chunked scan whose sums run
in another order), ``pos`` and ``position`` exact; decode against a full
forward 2e-3, as ``tests/test_decode.py`` holds the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.launch.serve import sample_token, serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

ARCHS = ["qwen3_1_7b", "smollm_360m", "mamba2_780m"]
J_OPTS = jtf.ApplyOptions(remat=False, attn_impl="pallas")
T_OPTS = ttf.ApplyOptions(attn_impl="kernel")
F32 = dict(rtol=1e-4, atol=1e-4)


def _carry(jcfg, seed, b, s):
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    tparams = ttf.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (b, s))
    return jparams, tparams, tokens


def _assert_caches_match(tcache, jcache):
    assert int(tcache["position"]) == int(jcache["position"])
    assert tcache["position"].dtype == torch.int32
    leaves, _ = tree_flatten(tcache["stack"])
    jleaves = jax.tree_util.tree_flatten_with_path(jcache["stack"])[0]
    assert len(leaves) == len(jleaves)
    for got, (path, want) in zip(leaves, jleaves):
        name = jax.tree_util.keystr(path)
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        if name.endswith("['pos']"):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        elif name.endswith("['ssm']"):
            np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def _prefill_decode_vs_reference(jcfg, tcfg, jparams, tparams, tokens,
                                 max_len, steps=3):
    jlogits, jcache = jax.jit(lambda p, t: jtf.prefill(
        p, jcfg, {"tokens": t}, max_len=max_len, cache_dtype=jnp.float32,
        opts=J_OPTS))(jparams, jnp.asarray(tokens, jnp.int32))
    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
    tlogits, tcache = ttf.prefill(tparams, tcfg,
                                  {"tokens": torch.from_numpy(tokens)},
                                  max_len=max_len, cache_dtype=torch.float32,
                                  opts=T_OPTS)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    _assert_caches_match(tcache, jcache)
    for _ in range(steps):
        nxt = np.array(jnp.argmax(jlogits[:, -1], -1))[:, None]
        jlogits, jcache = jdecode(jparams, jnp.asarray(nxt, jnp.int32),
                                  jcache)
        tlogits, tcache = ttf.decode_step(tparams, tcfg,
                                          torch.from_numpy(nxt), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **F32)
        _assert_caches_match(tcache, jcache)


def test_qwen3_config_copy_matches_reference():
    for get, jget in ((get_smoke, j_get_smoke), (get_arch, j_get_arch)):
        assert get("qwen3-1.7b").__dict__ == jget("qwen3-1.7b").__dict__
    shapes = jax.eval_shape(lambda: jtf.init_params(
        jax.random.key(0), j_get_arch("qwen3-1.7b")))
    assert sum(x.size for x in jax.tree.leaves(shapes)) == 1_720_574_976


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg = j_get_smoke(arch)
    jparams, tparams, tokens = _carry(jcfg, 1, 2, 24)
    _prefill_decode_vs_reference(jcfg, get_smoke(arch), jparams, tparams,
                                 tokens, max_len=28)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own twin of the reference's ``test_decode_matches_forward``:
    greedy-decode 3 tokens; each step's logits match a full forward over the
    extended sequence."""
    cfg = get_smoke(arch)
    _, tparams, tokens = _carry(j_get_smoke(arch), 2, 2, 24)
    toks = torch.from_numpy(tokens)
    logits, cache = ttf.prefill(tparams, cfg, {"tokens": toks}, max_len=28,
                                cache_dtype=torch.float32, opts=T_OPTS)
    for _ in range(3):
        nxt = sample_token(logits, None)
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = ttf.decode_step(tparams, cfg, nxt, cache)
        with torch.no_grad():
            full, _ = ttf.forward(tparams, cfg, {"tokens": toks})
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_sliding_window_ring_cache_matches_reference():
    """A local/global smoke model with a 16-key window: a 40-token prompt
    wraps the local layer's ring, then decode runs on it."""
    over = dict(layer_pattern=("local", "global"), sliding_window=16)
    jcfg = dataclasses.replace(j_get_smoke("smollm_360m"), **over)
    tcfg = dataclasses.replace(get_smoke("smollm_360m"), **over)
    jparams, tparams, tokens = _carry(jcfg, 3, 2, 40)
    _prefill_decode_vs_reference(jcfg, tcfg, jparams, tparams, tokens,
                                 max_len=48)


@pytest.mark.parametrize("n", [16, 7])
def test_ring_pack_matches_reference_exactly(n):
    rng = np.random.default_rng(n)
    k = rng.standard_normal((2, 40, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want = jtf._ring_pack(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                          n, jnp.float32)
    got = ttf._ring_pack(torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pos.copy()), n, torch.float32)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["pos"].dtype == torch.int32


def test_serve_entry_point_runs():
    res = serve("qwen3-1.7b", batch=2, prompt_len=16, gen=4, device="cpu")
    assert tuple(res["generated"].shape) == (2, 4)
    assert res["tok_per_s"] > 0 and res["prefill_s"] > 0
    sampled = serve("qwen3-1.7b", batch=2, prompt_len=8, gen=3,
                    temperature=1.0, device="cpu")["generated"]
    assert tuple(sampled.shape) == (2, 3)
    assert int(sampled.max()) < get_smoke("qwen3-1.7b").vocab_size


def test_serve_entry_point_runs_mamba():
    res = serve("mamba2-780m", batch=2, prompt_len=16, gen=4, device="cpu")
    assert tuple(res["generated"].shape) == (2, 4)
    assert res["tok_per_s"] > 0 and res["prefill_s"] > 0
    assert int(res["generated"].max()) < get_smoke("mamba2-780m").vocab_size


def test_mamba_config_copy_matches_reference():
    """The copied config, and the tree size serving loads at full width:
    780,259,584 parameters (``param_count()`` reports 780,060,672 in both
    packages: it counts the unpadded vocab and leaves out ``conv_b`` and
    ``dt_bias``)."""
    for get, jget in ((get_smoke, j_get_smoke), (get_arch, j_get_arch)):
        assert dataclasses.asdict(get("mamba2-780m")) == \
            dataclasses.asdict(jget("mamba2-780m"))
    cfg = get_arch("mamba2-780m")
    shapes = jax.eval_shape(lambda: jtf.init_params(
        jax.random.key(0), j_get_arch("mamba2-780m")))
    meta = ttf.init_params(torch.Generator(), cfg, device="meta")
    assert sum(x.size for x in jax.tree.leaves(shapes)) == 780_259_584
    assert sum(t.numel() for t in tree_flatten(meta)[0]) == 780_259_584
    assert cfg.param_count() == j_get_arch("mamba2-780m").param_count() \
        == 780_060_672
    assert cfg.padded_vocab_size == 50304


def test_serve_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("qwen3-1.7b", batch=1, prompt_len=4, gen=2)
