"""Port parity for the dense zoo families: Gemma-2 (local/global windows,
attention and final softcaps, post-norms, tanh-gelu, tied embeddings),
Command-R (a GQA group of 4 at smoke size, ``rope_theta`` 8e6),
InternVL2 (patch embeddings ahead of the tokens, qkv biases) and
Seamless-M4T-v2 (``encode`` over frame embeddings, cross-attention, the
cross K/V cache), each on its smoke config, against ``repro.models``.

The reference's ``init_params`` is carried over with ``params_from_numpy``;
tokens and frontend embeddings are numpy-made.  The reference prefills with
``attn_impl="pallas"`` (its flash kernel in interpret mode), the port with
``attn_impl="kernel"`` (on a CPU tensor the kernel's plain version); the
reference is jitted once per function and arch (module fixtures).

Tolerances, and why: logits, loss and the prefill's logits 1e-4 (f32
matmuls and softmaxes summed in another order; Gemma's final softcap 30
only shrinks differences); gradients rtol/atol 1e-4; cache k/v 1e-5 (a few
f32 products deep); ``pos`` and ``position`` exact; decode against a full
forward 2e-3, as ``tests/test_decode.py`` holds the reference.  In bf16
(Gemma-2 against the reference in bf16): every op rounds to bf16 in both
packages but in other places (XLA fuses elementwise chains in f32), and
two layers deep the roundings add up: a logit may differ by up to four
bf16 steps of the largest logit (2^-6 of it; two were seen), the mean
difference under one step (2^-8 of it).
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
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten  # noqa: E402

ARCHS = ["gemma2_27b", "command_r_35b", "internvl2_1b",
         "seamless_m4t_large_v2"]
J_OPTS = jtf.ApplyOptions(remat=False, attn_impl="pallas")
J_REF = jtf.ApplyOptions(remat=False)
T_OPTS = ttf.ApplyOptions(attn_impl="kernel")
F32 = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed, b=B, s=S):
    """Numpy inputs as the reference's tests shape them: tokens, plus the
    frontend's embeddings (``num_tokens`` of them, ``s`` where that is 0)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.frontend is not None:
        name = ("patch_embeds" if cfg.frontend.kind == "vision_patches"
                else "frames")
        n = cfg.frontend.num_tokens or s
        batch[name] = (rng.standard_normal((b, n, cfg.d_model)) * 0.02
                       ).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
            for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _extra(cfg) -> int:
    """Positions the prefill holds ahead of the tokens (vision patches)."""
    fe = cfg.frontend
    return fe.num_tokens if fe is not None and fe.kind == "vision_patches" \
        else 0


class _Carried:
    """One arch's smoke config, the reference's params carried over, its
    jitted functions, and a numpy batch."""

    def __init__(self, arch, seed=1):
        self.arch = arch
        self.jcfg, self.cfg = j_get_smoke(arch), get_smoke(arch)
        self.jparams = jtf.init_params(jax.random.key(seed), self.jcfg)
        self.tparams = ttf.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams))
        self.batch = _batch(self.jcfg, seed)
        jcfg = self.jcfg
        self.fwd = jax.jit(lambda p, b: jtf.forward(p, jcfg, b,
                                                    opts=J_REF)[0])
        self.decode = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))

    def jprefill(self, batch, max_len):
        jcfg = self.jcfg
        return jax.jit(lambda p, b: jtf.prefill(
            p, jcfg, b, max_len=max_len, cache_dtype=jnp.float32,
            opts=J_OPTS))(self.jparams, _j(batch))


_CACHE = {}


def _carried(arch) -> _Carried:
    if arch not in _CACHE:
        _CACHE[arch] = _Carried(arch)
    return _CACHE[arch]


def _assert_caches_match(tcache, jcache):
    assert int(tcache["position"]) == int(jcache["position"])
    leaves, _ = tree_flatten(tcache["stack"])
    jleaves = jax.tree_util.tree_flatten_with_path(jcache["stack"])[0]
    assert len(leaves) == len(jleaves)
    for got, (path, want) in zip(leaves, jleaves):
        name = jax.tree_util.keystr(path)
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        if name.endswith("['pos']"):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_tree_match_reference(arch):
    """The copied configs field by field, and the full-size tree: the same
    key paths, shapes and parameter count as the reference's (on the meta
    device, nothing allocated)."""
    for get, jget in ((get_smoke, j_get_smoke), (get_arch, j_get_arch)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
            jget(arch))
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.key(0),
                                                    j_get_arch(arch)))
    meta = ttf.init_params(torch.Generator(), get_arch(arch), device="meta")
    jl = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tl = tree_leaves(meta)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == _key_paths(meta)
    assert [x.shape for _, x in jl] == [tuple(t.shape) for t in tl]


def _key_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (tuple, list)):
        return [p for i, c in enumerate(tree)
                for p in _key_paths(c, f"{prefix}[{i}]")]
    return [prefix]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_and_own_init_has_reference_paths(arch):
    c = _carried(arch)
    jl = jax.tree_util.tree_flatten_with_path(c.jparams)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == _key_paths(c.tparams)
    for (_, j), t in zip(jl, tree_leaves(c.tparams)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    own = ttf.init_params(torch.Generator().manual_seed(0), c.cfg)
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(c.tparams)]


def _old_stacking(gen, cfg):
    """``init_params`` as it stacked before: every per-layer tree kept, then
    ``torch.stack`` (the encoder, new, stacked the same way)."""
    plan = ttf.stack_plan(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab_size
    nn = ttf.nn
    params = {"embed": nn._dense_init(gen, (vp, d), torch.float32, "cpu",
                                      scale=0.02),
              "final_norm": nn.rmsnorm_init(d)}
    if not cfg.tie_embeddings:
        params["head"] = nn._dense_init(gen, (d, vp), torch.float32, "cpu")
    cross = cfg.encdec is not None

    def stack(blocks):
        return ttf.tree_map(lambda *layers: torch.stack(layers), *blocks)

    periods = [[ttf.block_init(gen, cfg, cfg.pattern_for_layer(i),
                               cross=cross) for i in range(plan.period)]
               for _ in range(plan.n_periods)]
    params["stack"] = tuple(stack([periods[p][i]
                                   for p in range(plan.n_periods)])
                            for i in range(plan.period))
    if cross:
        enc = [ttf.block_init(gen, cfg, "global")
               for _ in range(cfg.encdec.num_encoder_layers)]
        params["encoder"] = {"stack": (stack(enc),),
                             "final_norm": nn.rmsnorm_init(d)}
    return params


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma2_27b",
                                  "seamless_m4t_large_v2"])
def test_init_params_is_bitwise_the_old_stacking(arch):
    """Each stacked leaf is now allocated once and filled layer by layer;
    the generator is drawn in the same order, so the tree is bitwise what
    stacking the per-layer trees gave for the same seed."""
    cfg = dataclasses.replace(get_smoke(arch), num_layers=4)
    got = ttf.init_params(torch.Generator().manual_seed(7), cfg)
    want = _old_stacking(torch.Generator().manual_seed(7), cfg)
    assert _key_paths(got) == _key_paths(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# training forward: logits, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_reference(arch):
    c = _carried(arch)
    jlogits = c.fwd(c.jparams, _j(c.batch))
    tlogits, aux = ttf.forward(c.tparams, c.cfg, _t(c.batch))
    assert tlogits.shape[1] == S            # the token positions only
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **F32)
    assert float(aux) == 0.0
    jloss_fn = jtf.make_loss_fn(c.jcfg, J_REF)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, _j(c.batch), None)[0])(c.jparams)
    leaves, treedef = tree_flatten(c.tparams)
    live = [t.clone().requires_grad_(True) for t in leaves]
    loss, _ = ttf.make_loss_fn(c.cfg)(tree_unflatten(treedef, live),
                                      _t(c.batch), None)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    grads = torch.autograd.grad(loss, live)
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# serving: prefill, the cache, decode
# ---------------------------------------------------------------------------


def _prefill_decode_vs_reference(c, batch, max_len, steps=2):
    jlogits, jcache = c.jprefill(batch, max_len)
    tlogits, tcache = ttf.prefill(c.tparams, c.cfg, _t(batch),
                                  max_len=max_len, cache_dtype=torch.float32,
                                  opts=T_OPTS)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    _assert_caches_match(tcache, jcache)
    for _ in range(steps):
        nxt = np.array(jnp.argmax(jlogits[:, -1], -1))[:, None]
        jlogits, jcache = c.decode(c.jparams, jnp.asarray(nxt, jnp.int32),
                                   jcache)
        tlogits, tcache = ttf.decode_step(c.tparams, c.cfg,
                                          torch.from_numpy(nxt), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **F32)
        _assert_caches_match(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_reference(arch):
    c = _carried(arch)
    _prefill_decode_vs_reference(c, c.batch,
                                 max_len=S + _extra(c.cfg) + 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's twin of the reference's ``test_decode_matches_forward``:
    greedy-decode 3 tokens; each step's logits match a full forward over
    the extended sequence (the frontend's embeddings unchanged)."""
    c = _carried(arch)
    batch = _t(c.batch)
    logits, cache = ttf.prefill(c.tparams, c.cfg, batch,
                                max_len=S + _extra(c.cfg) + 4,
                                cache_dtype=torch.float32, opts=T_OPTS)
    toks = batch["tokens"]
    for _ in range(3):
        nxt = sample_token(logits, None)
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = ttf.decode_step(c.tparams, c.cfg, nxt, cache)
        with torch.no_grad():
            full, _ = ttf.forward(c.tparams, c.cfg, {**batch, "tokens": toks})
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_gemma_ring_cache_past_the_window():
    """A 40-token prompt past Gemma-2's smoke window of 32: the local
    layer's ring wraps (``_ring_pack``) and decode runs on it, against the
    reference; then decode against a full forward."""
    c = _carried("gemma2_27b")
    batch = _batch(c.jcfg, 5, b=1, s=40)
    _prefill_decode_vs_reference(c, batch, max_len=48, steps=2)
    logits, cache = ttf.prefill(c.tparams, c.cfg, _t(batch), max_len=48,
                                cache_dtype=torch.float32, opts=T_OPTS)
    assert cache["stack"][0]["mixer"]["k"].shape[2] == 32    # local: window
    assert cache["stack"][1]["mixer"]["k"].shape[2] == 48    # global
    nxt = sample_token(logits, None)
    logits, _ = ttf.decode_step(c.tparams, c.cfg, nxt, cache)
    full, _ = ttf.forward(c.tparams, c.cfg, {
        "tokens": torch.cat([_t(batch)["tokens"], nxt], 1)})
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_internvl_default_max_len_truncates_as_the_reference():
    """Without ``max_len`` the cache holds the token count (the reference's
    default), shorter than the patches plus tokens the prefill runs: every
    layer, global ones too, keeps its last ``max_len`` positions in ring
    order, and decode sees only those.  The port matches the reference's
    cache and decode step; a caveat of the reference (ROADMAP Queue 3)."""
    c = _carried("internvl2_1b")
    jcfg = c.jcfg
    jlogits, jcache = jax.jit(lambda p, b: jtf.prefill(
        p, jcfg, b, cache_dtype=jnp.float32, opts=J_OPTS))(
        c.jparams, _j(c.batch))
    tlogits, tcache = ttf.prefill(c.tparams, c.cfg, _t(c.batch),
                                  cache_dtype=torch.float32, opts=T_OPTS)
    assert tcache["stack"][0]["mixer"]["k"].shape[2] == S
    assert int(tcache["position"]) == S + c.cfg.frontend.num_tokens
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    _assert_caches_match(tcache, jcache)
    nxt = np.array(jnp.argmax(jlogits[:, -1], -1))[:, None]
    jlogits, _ = c.decode(c.jparams, jnp.asarray(nxt, jnp.int32), jcache)
    tlogits, _ = ttf.decode_step(c.tparams, c.cfg, torch.from_numpy(nxt),
                                 tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)


def test_gemma_bf16_matches_reference_bf16():
    """Gemma-2's published dtype: bf16 weights and activations in both
    packages, the port's embedding scale rounded as the reference's."""
    c = _carried("gemma2_27b")
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), c.jparams)
    tp16 = jax.tree.map(
        lambda x: torch.from_numpy(np.asarray(x).view(np.int16).copy())
        .view(torch.bfloat16), jp16)
    tp16 = _tree_like(c.tparams, tp16)
    jcfg = c.jcfg
    jlogits = np.asarray(jax.jit(lambda p, b: jtf.forward(
        p, jcfg, b, opts=J_REF)[0])(jp16, _j(c.batch))).astype(np.float32)
    tlogits, _ = ttf.forward(tp16, c.cfg, _t(c.batch))
    assert tlogits.dtype == torch.bfloat16
    diff = np.abs(tlogits.float().numpy() - jlogits)
    top = float(np.abs(jlogits).max())
    assert diff.max() <= 2.0 ** -6 * top, (diff.max(), top)
    assert diff.mean() <= 2.0 ** -8 * top, (diff.mean(), top)


def _tree_like(like, jtree):
    """The port tree of ``like``'s structure with ``jtree``'s leaves (a JAX
    tree of torch tensors, walked in JAX's leaf order)."""
    return tree_unflatten(tree_flatten(like)[1], jax.tree.leaves(jtree))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu(arch):
    res = serve(arch, batch=2, prompt_len=12, gen=3, device="cpu")
    cfg = get_smoke(arch)
    assert tuple(res["generated"].shape) == (2, 3)
    assert int(res["generated"].max()) < cfg.vocab_size
    if cfg.frontend is not None:
        name = ("patch_embeds" if cfg.frontend.kind == "vision_patches"
                else "frames")
        assert res["inputs"][name].shape == (
            2, cfg.frontend.num_tokens or 12, cfg.d_model)


@pytest.mark.parametrize("arch", ["internvl2_1b", "seamless_m4t_large_v2"])
def test_pipeline_makes_frontend_batches_and_trains(arch):
    """The LM pipeline emits the frontend's embeddings with the reference
    pipeline's names and shapes (vision: the text tokens shrink so the
    sequence stays ``seq_len``; audio: ``num_tokens`` frames, 0 for
    Seamless's smoke and full configs), and one epoch of Algorithm 1 trains
    on them (finite loss)."""
    from repro.core import topology as jtp
    from repro.data import pipeline as jpipe
    from repro_torch.core import topology as ttp
    from repro_torch.data import DataConfig, FLDataPipeline
    from repro_torch.launch import train as ttrain
    cfg = get_smoke(arch)
    kw = dict(num_servers=2, clients_per_server=2, t_client=1, t_server=1)
    dcfg = dict(seq_len=24, per_client_batch=2, vocab_size=cfg.vocab_size)
    want = jpipe.FLDataPipeline(jtp.FLTopology(**kw),
                                jpipe.DataConfig(**dcfg),
                                arch=j_get_smoke(arch)).epoch_batches(0)
    got = FLDataPipeline(ttp.FLTopology(**kw), DataConfig(**dcfg),
                         arch=cfg).epoch_batches(0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    assert got["tokens"].dtype == torch.int64
    run = ttrain.train(arch, servers=2, clients=1, t_client=1, t_server=1,
                       epochs=1, seq_len=24, device="cpu", log=False)
    assert np.isfinite(run["history"]["loss"]).all()
