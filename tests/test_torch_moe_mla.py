"""Port parity for the MoE and MLA families: Mixtral-8x22B (top-2 of 8
experts on every layer, sliding-window attention), DeepSeek-V2 (MLA, a
dense first layer, routed plus shared experts) and Jamba-1.5-Large (a
period of mamba and attention layers, MoE on every other one), each on its
smoke config, and ``moe_apply`` / the MLA functions alone, against
``repro.models``.

The reference's ``init_params`` is carried over with ``params_from_numpy``;
tokens and activations are numpy-made.  The reference prefills with
``attn_impl="pallas"`` (its flash kernel in interpret mode) and
``moe_no_drop``, as its serving and decode tests do; the port with
``attn_impl="kernel"`` (on a CPU tensor the kernel's plain version).  The
training forward runs the default capacity (1.25, drops possible) in both.
The reference is jitted once per function and arch (module cache).

Tolerances, and why:
* routing (expert indices, ``keep``, the slot table) exactly: the router is
  one f32 matmul, a softmax and a sort, and these inputs' top-k margins are
  far above f32 rounding;
* ``moe_apply``'s output and aux, the MLA functions 1e-5, of the largest
  |value| for the MoE's output (f32 products a few deep, summed in another
  order; its rounding scales with the terms summed, not with each output);
* logits, loss, the prefill's logits 1e-4; gradients rtol/atol 1e-4; cache
  latents / k / v / states 1e-5; ``pos`` and ``position`` exact (as
  ``tests/test_torch_zoo.py``);
* decode against a full forward 2e-3, and the absorbed MLA decode against
  the expanded one 2e-4, as ``tests/test_decode.py`` holds the reference;
* ``moe_apply`` in bf16: each op rounds to bf16 in both packages, but XLA
  fuses the gate, activation and product in f32 where the port rounds
  between them: the output within four bf16 steps of its largest value
  (2^-6 of it), the mean difference within one (2^-8).  The routing is held
  exactly where the reference's top-k margin (k-th against (k+1)-th
  probability) exceeds 2^-8 of the k-th, and the rest are counted.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke  # noqa: E402
from repro_torch.launch.serve import sample_token, serve  # noqa: E402
from repro_torch.models import modules as tnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten  # noqa: E402

ARCHS = ["mixtral_8x22b", "deepseek_v2_236b", "jamba_1_5_large_398b"]
J_OPTS = jtf.ApplyOptions(remat=False, attn_impl="pallas", moe_no_drop=True)
J_REF = jtf.ApplyOptions(remat=False)
T_OPTS = ttf.ApplyOptions(attn_impl="kernel", moe_no_drop=True)
T_NO_DROP = ttf.ApplyOptions(moe_no_drop=True)
F32 = dict(rtol=1e-4, atol=1e-4)
SAME = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tokens(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}


def _to_torch(tree):
    return ttf.params_from_numpy(jax.tree.map(np.asarray, tree))


class _Carried:
    """One arch's smoke config, the reference's params carried over, its
    jitted functions, and a numpy batch."""

    def __init__(self, arch, seed=1):
        self.jcfg, self.cfg = j_get_smoke(arch), get_smoke(arch)
        jcfg = self.jcfg
        # jitted: the same values as eager init, in a third of the time
        self.jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(
            jax.random.key(seed))
        self.tparams = _to_torch(self.jparams)
        self.batch = _tokens(self.jcfg, seed)
        self.decode = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
        self._prefills = {}

    def jprefill(self, batch, max_len):
        if max_len not in self._prefills:
            jcfg = self.jcfg
            self._prefills[max_len] = jax.jit(lambda p, b: jtf.prefill(
                p, jcfg, b, max_len=max_len, cache_dtype=jnp.float32,
                opts=J_OPTS))
        return self._prefills[max_len](self.jparams, _j(batch))


_CACHE = {}


def _carried(arch) -> _Carried:
    if arch not in _CACHE:
        _CACHE[arch] = _Carried(arch)
    return _CACHE[arch]


def _assert_caches_match(tcache, jcache):
    assert int(tcache["position"]) == int(jcache["position"])
    for part in ("prefix", "stack"):
        leaves, _ = tree_flatten(tcache[part])
        jleaves = jax.tree_util.tree_flatten_with_path(jcache[part])[0]
        assert len(leaves) == len(jleaves), part
        for got, (path, want) in zip(leaves, jleaves):
            name = part + jax.tree_util.keystr(path)
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape, name
            if name.endswith("['pos']"):
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=name)
            else:
                np.testing.assert_allclose(got.numpy(), want, **SAME,
                                           err_msg=name)


def _key_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (tuple, list)):
        return [p for i, c in enumerate(tree)
                for p in _key_paths(c, f"{prefix}[{i}]")]
    return [prefix]


# ---------------------------------------------------------------------------
# the registry, configs, trees and stack plans
# ---------------------------------------------------------------------------


def test_registry_holds_every_reference_arch():
    """The port resolves every arch id of the reference, full and smoke,
    to the same config, and no other."""
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    for arch in J_ARCH_IDS:
        for get, jget in ((get_smoke, j_get_smoke), (get_arch, j_get_arch)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch)), arch
            assert get(arch.replace("_", "-")) == get(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_tree_match_reference(arch):
    """The full-size tree (meta device, nothing allocated): the same key
    paths (``prefix`` included) and shapes as the reference's; and the stack
    plans, full and smoke, equal."""
    for get, jget in ((get_smoke, j_get_smoke), (get_arch, j_get_arch)):
        assert dataclasses.asdict(ttf.stack_plan(get(arch))) == \
            dataclasses.asdict(jtf.stack_plan(jget(arch)))
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.key(0),
                                                    j_get_arch(arch)))
    meta = ttf.init_params(torch.Generator(), get_arch(arch), device="meta")
    jl = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == _key_paths(meta)
    assert [x.shape for _, x in jl] == [tuple(t.shape)
                                        for t in tree_leaves(meta)]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_and_own_init_has_reference_paths(arch):
    """``params_from_numpy`` carries every leaf, DeepSeek's ``prefix``
    too; the port's own init has the same paths and shapes."""
    c = _carried(arch)
    jl = jax.tree_util.tree_flatten_with_path(c.jparams)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == _key_paths(c.tparams)
    for (_, j), t in zip(jl, tree_leaves(c.tparams)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert ("prefix" in c.tparams) == (arch == "deepseek_v2_236b")
    own = ttf.init_params(torch.Generator().manual_seed(0), c.cfg)
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(c.tparams)]


def test_jamba_cut_period_keeps_the_published_pairings():
    """The 4-layer Jamba period the card serves (``chip_smoke.py``): MoE
    only on mamba layers, a dense FFN on the attention layer and on a mamba
    layer, mamba ahead of attention; one period, as the reference plans
    it."""
    cfg = dataclasses.replace(get_arch("jamba_1_5_large_398b"), num_layers=4,
                              layer_pattern=("mamba", "mamba", "global",
                                             "mamba"))
    jcfg = dataclasses.replace(j_get_arch("jamba_1_5_large_398b"),
                               num_layers=4,
                               layer_pattern=cfg.layer_pattern)
    assert dataclasses.asdict(ttf.stack_plan(cfg)) == \
        dataclasses.asdict(jtf.stack_plan(jcfg)) == \
        {"num_prefix": 0, "period": 4, "n_periods": 1}
    assert [ttf._layer_flags(cfg, i) for i in range(4)] == [
        ("mamba", False), ("mamba", True), ("global", False),
        ("mamba", True)]


def test_depth_off_the_period_raises():
    """A depth whose layers after the prefix do not fill whole periods
    raises (the reference asserts; without asserts it would truncate)."""
    cfg = dataclasses.replace(get_smoke("jamba_1_5_large_398b"),
                              num_layers=3)
    with pytest.raises(ValueError, match="periods of 2"):
        ttf.stack_plan(cfg)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _ref_moe(params, x, cfg, capacity_factor=1.25, no_drop=False, groups=1):
    """``repro.models.modules.moe_apply`` (modules.py:608-672) line for
    line in JAX, returning its routing too: (y, aux, gate_idx, keep,
    slot_token, probs)."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    t = b * s
    g = groups if (not no_drop and t % max(groups, 1) == 0) else 1
    tg = t // g
    tokens = x.reshape(g, tg, d)
    logits = jnp.einsum("gtd,de->gte", tokens.astype(jnp.float32),
                        params["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdims=True) + 1e-9)
    me = probs.mean((0, 1))
    ce = jnp.zeros((e,), jnp.float32).at[gate_idx.reshape(-1)].add(1.0) / (
        t * k)
    aux = e * jnp.sum(me * ce) * moe.router_aux_weight
    capacity = tg if no_drop else max(1, int(capacity_factor * tg * k / e))
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32)
    flat = onehot.reshape(g, tg * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(g, tg, k, e)
           * onehot).sum(-1)
    keep = pos < capacity
    gate_vals = gate_vals * keep
    safe_pos = jnp.where(keep, pos, capacity)
    grange = jnp.arange(g)[:, None]
    token_ids = jnp.broadcast_to(jnp.arange(tg), (g, tg))
    slot_token = jnp.full((g, e, capacity + 1), tg, jnp.int32)
    for slot in range(k):
        slot_token = slot_token.at[
            grange, gate_idx[:, :, slot], safe_pos[:, :, slot]].set(token_ids)
    slot_token = slot_token[:, :, :capacity]
    tokens_pad = jnp.pad(tokens, ((0, 0), (0, 1), (0, 0)))
    expert_in = jnp.take_along_axis(
        tokens_pad, slot_token.reshape(g, e * capacity)[..., None],
        axis=1).reshape(g, e, capacity, d)
    h = jnn._act(jnp.einsum("gecd,edf->gecf", expert_in, params["w_gate"]),
                 cfg.act)
    h = h * jnp.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    expert_out = jnp.pad(jnp.einsum("gecf,efd->gecd", h, params["w_down"]),
                         ((0, 0), (0, 0), (0, 1), (0, 0)))
    flat_out = expert_out.reshape(g, e * (capacity + 1), d)
    y = jnp.zeros((g, tg, d), x.dtype)
    for slot in range(k):
        idx = gate_idx[:, :, slot] * (capacity + 1) + safe_pos[:, :, slot]
        picked = jnp.take_along_axis(flat_out, idx[..., None], axis=1)
        y = y + picked * gate_vals[:, :, slot, None].astype(x.dtype)
    if "shared" in params:
        y = y + jnn.mlp_apply(params["shared"], tokens, cfg.act)
    return y.reshape(b, s, d), aux, gate_idx, keep, slot_token, probs


def _moe_case(arch, skew):
    """An MoE layer's params (the reference's init) and numpy activations
    (b 2, s 24); with ``skew``, 80% of the tokens carry a feature the router
    maps to expert 0, so expert 0 overflows its capacity."""
    jcfg = j_get_smoke(arch)
    params = jnn.moe_init(jax.random.key(5), jcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if skew:
        x[..., 0] = np.where(rng.random((B, S)) < 0.8, 3.0, 0.0)
        params = dict(params, router=params["router"].at[0, 0].set(2.0))
    return jcfg, params, x


MOE_CASES = {"no_drop": dict(no_drop=True),
             "capacity_drops": dict(capacity_factor=1.25),
             "groups_2": dict(groups=2)}


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_236b"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_routing_is_exactly_the_reference(arch, case):
    kw = MOE_CASES[case]
    jcfg, jparams, x = _moe_case(arch, skew=case == "capacity_drops")
    want_y, want_aux = jnn.moe_apply(jparams, jnp.asarray(x), jcfg, **kw)
    y, aux, gate_idx, keep, slot_token, _ = _ref_moe(jparams, jnp.asarray(x),
                                                     jcfg, **kw)
    # the transcription above is the reference's function
    np.testing.assert_allclose(np.asarray(y), np.asarray(want_y), rtol=0,
                               atol=1e-6)
    assert float(aux) == float(want_aux)
    cfg, params = get_smoke(arch), _to_torch(jparams)
    xt = torch.from_numpy(x)
    got_y, got_aux = tnn.moe_apply(params, xt, cfg, **kw)
    top = float(np.abs(np.asarray(want_y)).max())
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-5 * top)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **SAME)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    g = kw.get("groups", 1)
    tg = B * S // g
    _, _, t_idx = tnn.moe_route(params, xt.reshape(g, tg, -1), cfg)
    capacity = tg if kw.get("no_drop") else int(1.25 * tg * k / e)
    _, t_keep, t_slots = tnn.moe_dispatch(t_idx, e, capacity)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(slot_token))
    n_dropped = int((~np.asarray(keep)).sum())
    if case == "capacity_drops":
        assert n_dropped > 0          # the forced overflow drops pairs
    elif case == "no_drop":
        assert n_dropped == 0


def test_moe_apply_bf16_within_bf16_steps_of_reference():
    """Mixtral's MoE layer in its published dtype, drop-free."""
    jcfg, jparams, x = _moe_case("mixtral_8x22b", skew=False)
    j16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    want, _, gate_idx, _, _, probs = _ref_moe(j16, x16, jcfg, no_drop=True)
    want = np.asarray(want).astype(np.float32)
    cfg = get_smoke("mixtral_8x22b")
    params = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a).view(np.int16).copy()).view(torch.bfloat16), j16)
    xt = torch.from_numpy(np.asarray(x16).view(np.int16).copy()).view(
        torch.bfloat16)
    got, _ = tnn.moe_apply(params, xt, cfg, no_drop=True)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    top = float(np.abs(want).max())
    assert diff.max() <= 2.0 ** -6 * top, (diff.max(), top)
    assert diff.mean() <= 2.0 ** -8 * top, (diff.mean(), top)
    # routing, where the reference's top-k margin exceeds bf16 rounding
    k = cfg.moe.top_k
    p = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    clear = (p[..., k - 1] - p[..., k]) > 2.0 ** -8 * p[..., k - 1]
    _, _, t_idx = tnn.moe_route(params, xt.reshape(1, B * S, -1), cfg)
    same = (t_idx.numpy() == np.asarray(gate_idx)).all(-1)
    print(f"bf16 routing: {int((~clear).sum())} of {clear.size} tokens "
          f"within bf16 rounding of a tie; {int((~same).sum())} differ")
    assert same[clear].all()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla():
    """DeepSeek's smoke MLA layer (the reference's init) and activations."""
    jcfg = j_get_smoke("deepseek_v2_236b")
    jparams = jnn.mla_init(jax.random.key(9), jcfg)
    x = (np.random.default_rng(13).standard_normal((B, S, jcfg.d_model))
         * 0.5).astype(np.float32)
    return jcfg, jparams, _to_torch(jparams), x


def test_mla_qkv_and_apply_match_reference(mla):
    jcfg, jparams, tparams, x = mla
    cfg = get_smoke("deepseek_v2_236b")
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = jnn._mla_qkv(jparams, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tnn._mla_qkv(tparams, torch.from_numpy(x), cfg,
                       torch.from_numpy(np.array(pos)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SAME)
    want = jnn.mla_apply(jparams, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = tnn.mla_apply(tparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_step_matches_reference(mla, absorbed):
    """Five decode steps into a cache of 4: the fifth position lies past
    ``max_len`` and is written to the last slot (the reference's
    ``dynamic_update_slice`` clamps), not to a ring slot."""
    jcfg, jparams, tparams, x = mla
    cfg = get_smoke("deepseek_v2_236b")
    jcache = jnn.mla_cache_init(jcfg, B, 4, jnp.float32)
    tcache = tnn.mla_cache_init(cfg, B, 4, torch.float32)
    step = jax.jit(lambda p, xx, c, pos: jnn.mla_decode_step(
        p, xx, c, pos, jcfg, absorbed=absorbed))
    for pos in range(5):
        xs = x[:, pos:pos + 1]
        want, jcache = step(jparams, jnp.asarray(xs), jcache,
                            jnp.asarray(pos, jnp.int32))
        got, tcache = tnn.mla_decode_step(tparams, torch.from_numpy(xs),
                                          tcache, pos, cfg,
                                          absorbed=absorbed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), **SAME)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert tcache["pos"][0].tolist() == [0, 1, 2, 4]


def test_mla_absorbed_decode_matches(mla):
    """The port's twin of the reference's ``test_mla_absorbed_decode_
    matches``: absorbed decode equals the naive latent expansion."""
    _, _, tparams, x = mla
    cfg = get_smoke("deepseek_v2_236b")
    xs = torch.from_numpy(x[:, :1] * 0.6)
    y1, _ = tnn.mla_decode_step(tparams, xs, tnn.mla_cache_init(
        cfg, B, 8, torch.float32), 0, cfg, absorbed=False)
    y2, _ = tnn.mla_decode_step(tparams, xs, tnn.mla_cache_init(
        cfg, B, 8, torch.float32), 0, cfg, absorbed=True)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# whole models: forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_reference(arch):
    """The training forward at the default capacity: logits, the loss
    (nll + aux, each) and every gradient against ``jax.grad``."""
    c = _carried(arch)
    jcfg = c.jcfg
    jlogits, jaux = jax.jit(lambda p, b: jtf.forward(p, jcfg, b,
                                                     opts=J_REF))(
        c.jparams, _j(c.batch))
    with torch.no_grad():
        tlogits, aux = ttf.forward(c.tparams, c.cfg, _t(c.batch))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **SAME)
    assert float(aux) > 0
    jloss_fn = jtf.make_loss_fn(jcfg, J_REF)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, None), has_aux=True))(c.jparams,
                                                          _j(c.batch))
    leaves, treedef = tree_flatten(c.tparams)
    live = [t.clone().requires_grad_(True) for t in leaves]
    loss, parts = ttf.make_loss_fn(c.cfg)(tree_unflatten(treedef, live),
                                          _t(c.batch), None)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    for key in ("nll", "aux"):
        np.testing.assert_allclose(float(parts[key].detach()),
                                   float(jparts[key]), **F32)
    grads = torch.autograd.grad(loss, live)
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    """The port's twin of ``tests/test_models_smoke.py``'s
    ``test_forward_shapes_and_finite`` (b 2, s 32, default options)."""
    cfg = get_smoke(arch)
    assert cfg.num_layers <= 3 and cfg.d_model <= 512
    assert cfg.moe.num_experts <= 4
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _t(_tokens(cfg, 2, s=32))
    with torch.no_grad():
        logits, aux = ttf.forward(params, cfg, batch)
    assert tuple(logits.shape) == (B, 32, cfg.padded_vocab_size)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    assert bool(torch.isfinite(aux))


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
    return tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_reference(arch):
    """Prefill (the latent c_kv / k_rope / pos of DeepSeek's prefix and
    stack, Jamba's conv / ssm and k / v, Mixtral's k / v) and two decode
    steps against the reference's."""
    c = _carried(arch)
    cache = _prefill_decode_vs_reference(c, c.batch, max_len=S + 4)
    if arch == "deepseek_v2_236b":
        assert cache["prefix"][0]["mixer"]["c_kv"].shape[1] == S + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's twin of the reference's ``test_decode_matches_forward``:
    greedy-decode 3 tokens; each step's logits match a drop-free full
    forward over the extended sequence."""
    c = _carried(arch)
    batch = _t(c.batch)
    logits, cache = ttf.prefill(c.tparams, c.cfg, batch, max_len=S + 4,
                                cache_dtype=torch.float32, opts=T_OPTS)
    toks = batch["tokens"]
    for _ in range(3):
        nxt = sample_token(logits, None)
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = ttf.decode_step(c.tparams, c.cfg, nxt, cache)
        with torch.no_grad():
            full, _ = ttf.forward(c.tparams, c.cfg, {"tokens": toks},
                                  opts=T_NO_DROP)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_mixtral_ring_cache_past_the_window():
    """The port's twin of ``test_sliding_window_ring_cache``: a 40-token
    prompt past Mixtral's smoke window of 32, cache of 64; every layer is
    local, so every cache is a ring of 32 that has wrapped.  Prefill and
    decode against the reference, then decode against a full forward."""
    c = _carried("mixtral_8x22b")
    batch = _tokens(c.jcfg, 5, b=1, s=40)
    _prefill_decode_vs_reference(c, batch, max_len=64, steps=1)
    logits, cache = ttf.prefill(c.tparams, c.cfg, _t(batch), max_len=64,
                                cache_dtype=torch.float32, opts=T_OPTS)
    assert cache["stack"][0]["mixer"]["k"].shape[2] == 32
    nxt = sample_token(logits, None)
    logits, _ = ttf.decode_step(c.tparams, c.cfg, nxt, cache)
    with torch.no_grad():
        full, _ = ttf.forward(c.tparams, c.cfg, {
            "tokens": torch.cat([_t(batch)["tokens"], nxt], 1)},
            opts=T_NO_DROP)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu(arch):
    res = serve(arch, batch=2, prompt_len=12, gen=3, device="cpu")
    assert tuple(res["generated"].shape) == (2, 3)
    assert int(res["generated"].max()) < get_smoke(arch).vocab_size


# ---------------------------------------------------------------------------
# training (CPU): Algorithm 1 on Mixtral's smoke config
# ---------------------------------------------------------------------------


def _dfl_batch(cfg, lead, seed=3, seq=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, lead + (seq,))}


def test_dfl_train_step_mixtral():
    """The port's twin of ``test_dfl_train_step[mixtral_8x22b]``: one DFL
    epoch (2 servers x 2 clients, T_C = 2, T_S = 3, the default capacity,
    the loss nll + aux): losses finite, parameters moved, a server's client
    copies identical after the broadcast; and the same epoch of the
    reference on the same weights and tokens within 1e-4."""
    from repro.core import DFLConfig as JDFLConfig
    from repro.core import FLTopology as JTopology
    from repro.core import build_dfl_epoch_step as j_build
    from repro.core import init_dfl_state as j_init
    from repro.optim import sgd as j_sgd
    from repro_torch.core import dfl as tdfl
    from repro_torch.core.topology import FLTopology
    from repro_torch.optim import sgd
    c = _carried("mixtral_8x22b")
    topo = dict(num_servers=2, clients_per_server=2, t_client=2, t_server=3)
    batch = _dfl_batch(c.cfg, (2, 2, 2, B))
    jcfg = JDFLConfig(topology=JTopology(**topo))
    step = jax.jit(j_build(jcfg, jtf.make_loss_fn(c.jcfg, J_REF,
                                                  loss_chunk=16),
                           j_sgd(1e-2)))
    jstate, jm = step(j_init(jcfg, c.jparams, j_sgd(1e-2),
                             jax.random.key(1)), _j(batch))
    cfg = tdfl.DFLConfig(topology=FLTopology(**topo))
    tstep = tdfl.build_dfl_epoch_step(
        cfg, ttf.make_loss_fn(c.cfg, loss_chunk=16), sgd(1e-2))
    state = tdfl.init_dfl_state(cfg, _to_torch(c.jparams), sgd(1e-2))
    before = [t.clone() for t in tree_leaves(state.client_params)]
    state, m = tstep(state, _t(batch))
    assert bool(torch.isfinite(m.loss).all())
    assert bool(torch.isfinite(m.server_disagreement))
    after = tree_leaves(state.client_params)
    assert sum(float((a - b).abs().sum()) for a, b in zip(after, before)) > 0
    assert torch.equal(after[0][:, 0], after[0][:, 1])
    np.testing.assert_allclose(m.loss.numpy(), np.asarray(jm.loss), **F32)
    for got, want in zip(after, jax.tree.leaves(jstate.client_params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_grad_microbatching_matches_full_batch_mixtral():
    """The port's twin of ``test_grad_microbatching_matches_full_batch
    [mixtral_8x22b]``: two microbatches give the full batch's update
    (drop-free MoE, whose routing does not depend on the batch split), at
    the reference test's tolerance."""
    from repro_torch.core import dfl as tdfl
    from repro_torch.core.topology import FLTopology
    from repro_torch.optim import sgd
    cfg = get_smoke("mixtral_8x22b")
    topo = FLTopology(num_servers=2, clients_per_server=1, t_client=1,
                      t_server=1)
    loss_fn = ttf.make_loss_fn(cfg, T_NO_DROP, loss_chunk=16)
    params = ttf.init_params(torch.Generator().manual_seed(1), cfg)
    batch = _t(_dfl_batch(cfg, (1, 2, 1, 4)))
    outs = []
    for micro in (1, 2):
        dcfg = tdfl.DFLConfig(topology=topo, grad_microbatches=micro)
        state = tdfl.init_dfl_state(dcfg, params, sgd(1e-2))
        state, _ = tdfl.build_dfl_epoch_step(dcfg, loss_fn, sgd(1e-2))(
            state, batch)
        outs.append(tree_leaves(state.client_params))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
