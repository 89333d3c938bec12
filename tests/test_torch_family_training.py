"""Port parity for Algorithm 1 on the Mamba-2 family, and for the
reference's ``mamba_only`` block kind, each on a smoke config against
``repro``.

* Mamba-2: the twin of ``tests/test_models_smoke.py::test_dfl_train_step``
  for ``mamba2_780m`` (one DFL epoch, 2 servers x 2 clients, T_C = 2,
  T_S = 3) on the reference's weights carried over and the same numpy
  tokens; training takes the reference route (``ssd_chunked`` under
  autograd: kernel 9 has no backward in either package).  Then the same
  epoch through ``launch.train.train`` on the pipeline's tokens.
* ``mamba_only``: the reference's code builds the ATTENTION mixer (global:
  only ``"local"`` is windowed) and no FFN for it (``repro/models/
  transformer.py:113, 121``), whatever its name says.  Held on Gemma-2's
  smoke config with the pattern ``("local", "mamba_only")``: key paths,
  forward and loss, prefill and its cache past the window, two decode
  steps.

Tolerances: parameters, losses, logits and the prefill 1e-4 (f32
forward and backward in another summation order, then SGD and gossip);
cache k/v 1e-5; ``pos`` and ``position`` exact — as
``tests/test_torch_moe_mla.py`` and ``tests/test_torch_zoo.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.core import DFLConfig as JDFLConfig  # noqa: E402
from repro.core import FLTopology as JTopology  # noqa: E402
from repro.core import build_dfl_epoch_step as j_build  # noqa: E402
from repro.core import init_dfl_state as j_init  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.data import DataConfig, FLDataPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
SAME = dict(rtol=1e-5, atol=1e-5)
TOPO = dict(num_servers=2, clients_per_server=2, t_client=2, t_server=3)
B, S, GAMMA = 2, 32, 1e-2
J_REF = jtf.ApplyOptions(remat=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return ttf.params_from_numpy(jax.tree.map(np.asarray, tree))


def _key_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (tuple, list)):
        return [p for i, c in enumerate(tree)
                for p in _key_paths(c, f"{prefix}[{i}]")]
    return [prefix]


def _j_key_paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# Mamba-2: Algorithm 1 on the reference route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    """Mamba-2's smoke config, the reference's weights and one epoch of its
    DFL step on numpy tokens."""
    jcfg = j_get_smoke("mamba2_780m")
    jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(jax.random.key(1))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (TOPO["t_client"], TOPO["num_servers"],
                             TOPO["clients_per_server"], B, S))
    cfg = JDFLConfig(topology=JTopology(**TOPO))
    step = jax.jit(j_build(cfg, jtf.make_loss_fn(jcfg, J_REF, loss_chunk=16),
                           j_sgd(GAMMA)))
    jstate, jm = step(j_init(cfg, jparams, j_sgd(GAMMA), jax.random.key(1)),
                      {"tokens": jnp.asarray(tokens, jnp.int32)})
    return jparams, tokens, jstate, jm


def test_dfl_train_step_mamba2(mamba):
    """One DFL epoch of the Mamba-2 smoke config: losses finite, parameters
    moved, a server's client copies equal after the broadcast, no kernel
    launched (CPU tensors: the plain versions); values, losses and the
    grad norm as the reference's."""
    jparams, tokens, jstate, jm = mamba
    cfg = tdfl.DFLConfig(topology=FLTopology(**TOPO))
    step = tdfl.build_dfl_epoch_step(
        cfg, ttf.make_loss_fn(get_smoke("mamba2_780m"), loss_chunk=16),
        sgd(GAMMA))
    state = tdfl.init_dfl_state(cfg, _to_torch(jparams), sgd(GAMMA))
    before = [t.clone() for t in tree_leaves(state.client_params)]
    ops.reset_launch_counts()
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    assert all(v == 0 for v in ops.launch_counts().values())
    assert bool(torch.isfinite(m.loss).all())
    assert bool(torch.isfinite(m.server_disagreement))
    after = tree_leaves(state.client_params)
    assert sum(float((a - b).abs().sum()) for a, b in zip(after, before)) > 0
    assert torch.equal(after[0][:, 0], after[0][:, 1])
    np.testing.assert_allclose(m.loss.numpy(), np.asarray(jm.loss), **F32)
    np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm),
                               **F32)
    for got, want in zip(after, jax.tree.leaves(jstate.client_params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_train_entry_point_trains_mamba2():
    """``launch.train.train("mamba2-780m")`` runs that epoch end to end on
    the CPU (the pipeline's tokens, carried weights): the same parameters as
    the reference's epoch step handed those tokens."""
    jcfg = j_get_smoke("mamba2_780m")
    jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(jax.random.key(2))
    topo = FLTopology(**TOPO, graph_kind="ring")
    pipe = FLDataPipeline(topo, DataConfig(seq_len=S, per_client_batch=B,
                                           vocab_size=jcfg.vocab_size,
                                           seed=0))
    tokens = pipe.epoch_batches(0)["tokens"].numpy()
    cfg = JDFLConfig(topology=JTopology(**TOPO))
    step = jax.jit(j_build(cfg, jtf.make_loss_fn(jcfg, J_REF), j_sgd(GAMMA)))
    jstate, jm = step(j_init(cfg, jparams, j_sgd(GAMMA), jax.random.key(1)),
                      {"tokens": jnp.asarray(tokens, jnp.int32)})
    out = ttrain.train("mamba2-780m", smoke=True, epochs=1, seq_len=S,
                       per_client_batch=B, gamma=GAMMA, seed=0,
                       device="cpu", log=False, params=_to_torch(jparams),
                       servers=TOPO["num_servers"],
                       clients=TOPO["clients_per_server"],
                       t_client=TOPO["t_client"], t_server=TOPO["t_server"])
    np.testing.assert_allclose(out["history"]["loss"][0],
                               float(jm.loss[-1].mean()), **F32)
    for got, want in zip(tree_leaves(out["state"].client_params),
                         jax.tree.leaves(jstate.client_params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# the reference's mamba_only kind
# ---------------------------------------------------------------------------


PATTERN = ("local", "mamba_only")


@pytest.fixture(scope="module")
def mamba_only():
    """Gemma-2's smoke config (window 32) with a ``mamba_only`` layer in
    place of its global one, in both packages, and the reference's
    weights."""
    jcfg = dataclasses.replace(j_get_smoke("gemma2_27b"),
                               layer_pattern=PATTERN)
    cfg = dataclasses.replace(get_smoke("gemma2_27b"), layer_pattern=PATTERN)
    jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(jax.random.key(4))
    return jcfg, cfg, jparams, _to_torch(jparams)


def test_mamba_only_block_is_attention_without_ffn(mamba_only):
    """The tree: a ``mamba_only`` block holds the attention mixer (q/k/v/o)
    and ``ln1``/``ln2`` but no ``ffn``, on the reference's key paths, from
    the port's own init as from the carried weights."""
    jcfg, cfg, jparams, tparams = mamba_only
    own = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    want = _j_key_paths(jparams)
    assert _key_paths(own) == _key_paths(tparams) == want
    local, mixed = own["stack"]
    assert "ffn" in local and "ffn" not in mixed
    assert set(mixed["mixer"]) == set(local["mixer"])
    assert {"ln1", "ln2"} <= set(mixed)
    for got, (path, ref) in zip(tree_leaves(own),
                                jax.tree_util.tree_flatten_with_path(
                                    jparams)[0]):
        assert tuple(got.shape) == np.asarray(ref).shape, path


def test_mamba_only_forward_prefill_and_decode_match_reference(mamba_only):
    """Forward logits and loss, then a 40-token prefill (past the local
    layer's window of 32: the ``mamba_only`` layer's cache holds all 44
    positions, global) and two decode steps, against the reference."""
    jcfg, cfg, jparams, tparams = mamba_only
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, 40))
    jlogits, _ = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             opts=J_REF)
    with torch.no_grad():
        tlogits, _ = ttf.forward(tparams, cfg, {"tokens": torch.from_numpy(
            toks)})
        tloss, _ = ttf.make_loss_fn(cfg)(tparams, {"tokens": torch.from_numpy(
            toks)}, None)
    jloss, _ = jtf.make_loss_fn(jcfg, J_REF)(
        jparams, {"tokens": jnp.asarray(toks)}, None)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    max_len = 44
    jp, jcache = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             max_len=max_len, cache_dtype=jnp.float32,
                             opts=J_REF)
    tp_, tcache = ttf.prefill(tparams, cfg, {"tokens": torch.from_numpy(
        toks)}, max_len=max_len, cache_dtype=torch.float32,
        opts=ttf.ApplyOptions(attn_impl="kernel"))
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), **F32)
    local, mixed = tcache["stack"]
    assert local["mixer"]["k"].shape[2] == cfg.sliding_window
    assert mixed["mixer"]["k"].shape[2] == max_len
    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
    for _ in range(2):
        leaves, _ = tree_flatten(tcache["stack"])
        jleaves = jax.tree_util.tree_flatten_with_path(jcache["stack"])[0]
        assert len(leaves) == len(jleaves)
        for got, (path, want) in zip(leaves, jleaves):
            name = jax.tree_util.keystr(path)
            if name.endswith("['pos']"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=name)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           **SAME, err_msg=name)
        nxt = np.array(jnp.argmax(jp[:, -1], -1))[:, None]
        jp, jcache = jdecode(jparams, jnp.asarray(nxt, jnp.int32), jcache)
        tp_, tcache = ttf.decode_step(tparams, cfg, torch.from_numpy(nxt),
                                      tcache)
        np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), **F32)
    assert int(tcache["position"]) == int(jcache["position"]) == 42
