"""Tensor parallelism over "model" on the encoder-decoder (Seamless-M4T)
and the vision frontend (InternVL2): the rank-local epoch step on
``RankMesh`` meshes whose model axis cuts a client's layers
(``launch.sharding.fl_consensus_backend(..., tp_axis="model")``,
``launch.tp``), one spawned world of 4 gloo ranks, held against the JAX
package's epoch step and the port's one-process step on the same inputs.

One epoch of T_C = 2, T_S = 3 on each case:

* ``seamless_tp2``: seamless-smoke on (2, 1, 1, 2), its 4 heads cut 2 a
  rank in the encoder's self-attention and in the decoder's self- and
  cross-attention, ``b_q`` / ``b_k`` / ``b_v`` with their heads;
* ``seamless_tp4``: seamless-smoke on (1, 1, 1, 4), one head a rank;
* ``internvl2_tp2``: internvl2-smoke with its 16 patch embeddings ahead of
  the tokens, on (2, 1, 1, 2);
* ``cross_control``: ``seamless_tp2`` with the memory passed to the cross
  K/V without ``copy`` (site ``tp_memory``): the encoder's gradient then
  lacks the other ranks' cross-attention terms, and the case must miss
  the one-process step by more than ``REL``.

Each plain case's assembled state (``launch.sharding.assemble``) is held
to the reference's ``build_dfl_epoch_step`` and to the port's one-process
step within ``REL`` of each leaf's largest |w| (the row-parallel sums
regroup f32 contractions).  One leaf is held to an absolute ``FLOOR``
instead: the cross-attention's ``b_k``, whose gradient is zero in exact
arithmetic (a key bias without rope shifts every score of a query alike,
and the softmax does not see it), so both runs hold rounding noise of
~1e-10 there.  In every plain case: replicated leaves bitwise across each
TP group, each rank's pieces ``local_shard`` of the assembled state, the
consensus bitwise the one-process gossip on the (M * S)-row problem under
A ⊗ I_S, and the TP sites' calls and bytes to the byte.  Outside the
world: the refusals that remain, by name, and the TP dims of the
encoder-decoder's leaves.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.core import dfl as jdfl  # noqa: E402
from repro.core.topology import FLTopology as JTopology  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, \
    tree_map_with_path  # noqa: E402

T_C, T_S, SEQ, ENC, B, GAMMA = 2, 3, 24, 20, 2, 0.05
#: each leaf against the reference's and the one-process port's epoch,
#: as a share of its largest |w| (measured <= 1.5e-6 against either)
REL = 1e-5
#: the cross-attention's b_k: rounding noise in both runs (see above)
FLOOR = 1e-8
SEAMLESS, INTERNVL = "seamless-m4t-large-v2", "internvl2-1b"
# case -> (arch, mesh shape (M, N, R, TP), the memory through copy)
CASES = {
    "seamless_tp2": (SEAMLESS, (2, 1, 1, 2), True),
    "seamless_tp4": (SEAMLESS, (1, 1, 1, 4), True),
    "internvl2_tp2": (INTERNVL, (2, 1, 1, 2), True),
    "cross_control": (SEAMLESS, (2, 1, 1, 2), False),
}
PLAIN = [c for c in CASES if CASES[c][2]]


def batch_for(arch: str, m: int) -> dict:
    """Numpy batch leaves (T_C, M, 1, B, ...): tokens, and the frontend's
    embeddings (the encoder's frames, or the patches ahead of the
    tokens)."""
    cfg = get_smoke(arch)
    rng = np.random.default_rng([m, len(arch)])
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(T_C, m, 1, B, SEQ)).astype(np.int64)}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (T_C, m, 1, B, ENC, cfg.d_model)).astype(np.float32)
    else:
        out["patch_embeds"] = (rng.standard_normal(
            (T_C, m, 1, B, cfg.frontend.num_tokens, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return out


def topo_kw(m: int) -> dict:
    return dict(num_servers=m, clients_per_server=1, t_client=T_C,
                t_server=T_S)


# the script the ranks run: torch and repro_torch only
WORLD = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def main(rank, out, rdv, spec):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdv,
                                world_size=4, rank=rank)
        try:
            res = {name: run_case(spec, *case)
                   for name, case in spec["cases"].items()}
            assert not [n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")]
            torch.save(res, out + f".{rank}")
        finally:
            dist.destroy_process_group()


    def run_case(spec, arch, shape, memory_copy):
        from repro_torch.configs import get_smoke
        from repro_torch.core import (DFLConfig, FLTopology,
                                      build_dfl_epoch_step, init_dfl_state)
        from repro_torch.core import consensus as cns
        from repro_torch.launch import mesh as lm
        from repro_torch.launch import sharding as shd
        from repro_torch.launch import tp as ltp
        from repro_torch.models import transformer as tf
        from repro_torch.optim import sgd
        from repro_torch.tree import tree_leaves, tree_map
        cfg = get_smoke(arch)
        mesh = lm.fl_rank_mesh(lm.FLMeshSpec(*shape))
        m = shape[0]
        topo = FLTopology(num_servers=m, clients_per_server=1,
                          t_client=spec["t_c"], t_server=spec["t_s"])
        params = tf.params_from_numpy(spec["params"][arch])
        server_abs = tree_map(lambda x: torch.empty(
            (m,) + tuple(x.shape), device="meta"), params)
        backend = shd.fl_consensus_backend(topo, mesh, server_abs,
                                           tp_axis="model")
        dcfg = DFLConfig(topology=topo, consensus_backend=backend)
        opt = sgd(spec["gamma"])
        step = build_dfl_epoch_step(dcfg, tf.make_loss_fn(cfg), opt)
        state = init_dfl_state(dcfg, params, opt)
        rec = {}
        inner_mix = backend.mix

        def spy(tree, *a, **kw):
            rec["pre"] = [x.clone() for x in tree_leaves(tree)]
            out = inner_mix(tree, *a, **kw)
            rec["post"] = [x.clone() for x in tree_leaves(out)]
            return out

        backend.mix = spy
        copy = ltp.ModelParallel.copy
        if not memory_copy:
            # the control: the memory reaches the cross K/V as it is
            ltp.ModelParallel.copy = (
                lambda self, x, site="tp_backward": x if site == "tp_memory"
                else copy(self, x, site))
        cns.reset_collective_counts()
        batch = {k: torch.from_numpy(v)
                 for k, v in spec["batches"][(arch, m)].items()}
        try:
            state, mt = step(state, batch)
        finally:
            ltp.ModelParallel.copy = copy
        return dict(
            rec, coords=mesh.coords(),
            clients=[x.clone() for x in tree_leaves(state.client_params)],
            loss=mt.loss.clone(), collectives=cns.collective_counts())


    if __name__ == "__main__":
        spec = torch.load(sys.argv[3], weights_only=False)
        mp.spawn(main, args=(sys.argv[1], sys.argv[2], spec), nprocs=4)
''')


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def np_params(arch: str) -> dict:
    """The seeded weights both packages start from (numpy leaves)."""
    jparams = jtf.init_params(jax.random.key(7), j_get_smoke(arch))
    return jax.tree.map(np.asarray, jparams)


def port_params(arch: str) -> dict:
    return ttf.params_from_numpy(np_params(arch))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks; each rank's own
    results, by rank.  The references (the JAX package's epochs and the
    port's one-process ones) are computed while the world runs."""
    d = tmp_path_factory.mktemp("tensor_parallel_encdec_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    keys = {(a, s[0]) for a, s, _ in CASES.values()}
    spec = dict(t_c=T_C, t_s=T_S, gamma=GAMMA,
                batches={k: batch_for(*k) for k in keys},
                params={a: np_params(a) for a, _ in keys}, cases=CASES)
    torch.save(spec, spec_path)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(script), str(out),
                             str(d / "rdv"), str(spec_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        for key in sorted(keys):
            reference(*key)
            one_process(*key)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(4)]


def mesh_of(shape, rank=0):
    return tmesh.fl_rank_mesh(tmesh.FLMeshSpec(*shape), rank=rank, dry=True)


def client_specs(case: str) -> list:
    """Each client leaf's ``(M, N, *w)`` spec on the case's mesh."""
    arch, shape, _ = CASES[case]
    abs_tree = tree_map(lambda x: torch.empty((shape[0], 1) + tuple(x.shape),
                                              device="meta"),
                        port_params(arch))
    return tree_leaves(shd.fl_param_specs(abs_tree, mesh_of(shape),
                                          tp_axis="model"))


def leaf_names(arch: str) -> list:
    names = []
    tree_map_with_path(lambda p, _: names.append("/".join(
        str(getattr(e, "key", getattr(e, "idx", ""))) for e in p)),
        port_params(arch))
    return names


def assembled(world, case: str, key: str = "clients") -> list:
    """The federation's leaves from every rank's pieces."""
    mesh = mesh_of(CASES[case][1])
    return [shd.assemble([w[case][key][i] for w in world], sp, mesh)
            for i, sp in enumerate(client_specs(case))]


@functools.lru_cache(maxsize=None)
def one_process(arch: str, m: int):
    """The port's one-process epoch: (state leaves, metrics, the backend's
    pre-consensus rows)."""
    topo = FLTopology(**topo_kw(m))
    rec = {}
    inner = tcns.GossipBackend(topo.mixing_matrix() if m > 1
                               else np.ones((1, 1)), T_S)
    mix = inner.mix

    def spy(tree, *a, **kw):
        rec["pre"] = [x.clone() for x in tree_leaves(tree)]
        return mix(tree, *a, **kw)

    inner.mix = spy
    cfg = tdfl.DFLConfig(topology=topo, consensus_backend=inner)
    opt = sgd(GAMMA)
    step = tdfl.build_dfl_epoch_step(cfg, ttf.make_loss_fn(get_smoke(arch)),
                                     opt)
    state = tdfl.init_dfl_state(cfg, port_params(arch), opt)
    state, mt = step(state, {k: torch.from_numpy(v)
                             for k, v in batch_for(arch, m).items()})
    return [x.clone() for x in tree_leaves(state.client_params)], mt, rec


@functools.lru_cache(maxsize=None)
def reference(arch: str, m: int):
    """The JAX package's static epoch on the same weights and batch."""
    jcfg = j_get_smoke(arch)
    cfg = jdfl.DFLConfig(topology=JTopology(**topo_kw(m)))
    opt = j_sgd(GAMMA)
    step = jax.jit(jdfl.build_dfl_epoch_step(
        cfg, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)), opt))
    jparams = jax.tree.map(jnp.asarray, np_params(arch))
    state = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))
    batch = {k: jnp.asarray(v) for k, v in batch_for(arch, m).items()}
    state, mt = step(state, batch)
    return ([np.asarray(x) for x in jax.tree.leaves(state.client_params)],
            mt)


def worst_rel(arch: str, got, want) -> float:
    """The largest distance of a leaf over its largest |w|, the
    cross-attention's ``b_k`` asserted within ``FLOOR`` instead."""
    worst = 0.0
    for name, g, w in zip(leaf_names(arch), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = float(np.abs(g - w).max())
        if name.endswith("cross_attn/b_k"):
            assert err <= FLOOR, (name, err)
            continue
        worst = max(worst, err / float(np.abs(w).max()))
    return worst


@pytest.mark.parametrize("case", PLAIN)
def test_tp_epoch_matches_the_reference(world, case):
    arch, shape, _ = CASES[case]
    got = assembled(world, case)
    want, jm = reference(arch, shape[0])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert worst_rel(arch, [g.numpy() for g in got], want) <= REL
    for w in world:
        np.testing.assert_allclose(w[case]["loss"].numpy(),
                                   np.asarray(jm.loss), rtol=REL, atol=0)


@pytest.mark.parametrize("case", PLAIN)
def test_tp_epoch_matches_the_one_process_port(world, case):
    arch, shape, _ = CASES[case]
    got = assembled(world, case)
    want, mt, _ = one_process(arch, shape[0])
    assert worst_rel(arch, [g.numpy() for g in got],
                     [w.numpy() for w in want]) <= REL
    for w in world:
        np.testing.assert_allclose(w[case]["loss"].numpy(), mt.loss.numpy(),
                                   rtol=REL, atol=0)


def test_cross_control_misses_the_one_process_port(world):
    """Without ``copy`` on the memory the encoder's gradient lacks the
    other ranks' cross-attention terms: the encoder's leaves (and through
    them the rest) miss the one-process step by more than REL, while the
    plain case on the same mesh holds it."""
    arch, shape, _ = CASES["cross_control"]
    want = [w.numpy() for w in one_process(arch, shape[0])[0]]
    got = [g.numpy() for g in assembled(world, "cross_control")]
    enc = [i for i, n in enumerate(leaf_names(arch))
           if n.startswith("encoder/")]
    miss = worst_rel(arch, [got[i] for i in enc], [want[i] for i in enc])
    assert miss > 10 * REL, miss
    assert "tp_memory" not in world[0]["cross_control"]["collectives"][
        "sites"]


def _tp_groups(shape) -> list:
    """The ranks of each TP group (the ranks along "model")."""
    mesh = mesh_of(shape)
    seen = []
    for r in range(4):
        g = mesh.ranks_along("model", r)
        if g not in seen:
            seen.append(g)
    return seen


@pytest.mark.parametrize("case", PLAIN)
def test_replicated_leaves_are_bitwise_across_the_tp_group(world, case):
    """A leaf not cut over "model" (the norms, ``b_o``, the encoder's
    final norm) is the same on every rank of a TP group, before the
    consensus and after it."""
    shape = CASES[case][1]
    keys = (["pre"] if shape[0] > 1 else []) + ["clients"]
    server = [shd.PartitionSpec(sp[0], *sp.dims[2:])
              for sp in client_specs(case)]
    checked = 0
    for key in keys:
        specs = client_specs(case) if key == "clients" else server
        for i, sp in enumerate(specs):
            if shd.model_dim(sp) is not None:
                continue
            for group in _tp_groups(shape):
                first = world[group[0]][case][key][i]
                for r in group[1:]:
                    assert torch.equal(world[r][case][key][i], first), \
                        (key, i, r)
                    checked += 1
    assert checked


@pytest.mark.parametrize("case", PLAIN)
def test_each_rank_holds_its_pieces(world, case):
    """Each rank's pieces are ``local_shard`` of the assembled state; the
    encoder's stack and final norm, the cross-attention and its biases
    among them."""
    shape = CASES[case][1]
    full = assembled(world, case)
    for r, w in enumerate(world):
        mesh = mesh_of(shape, r)
        for x, sp, piece in zip(full, client_specs(case), w[case]["clients"]):
            np.testing.assert_array_equal(
                piece.numpy(), shd.local_shard(x, sp, mesh).numpy())


def server_rows(world, case: str, key: str) -> list:
    """The (M * S)-row problem of a consensus period: row r = rank r's
    pieces (a rank's index is ``server * S + sub``)."""
    return [torch.cat([w[case][key][i] for w in world])
            for i in range(len(world[0][case][key]))]


@pytest.mark.parametrize("case", [c for c in PLAIN if CASES[c][1][0] > 1])
def test_tp_consensus_is_the_kron_emulation(world, case):
    """The plain program on the pieces the local period produced: bitwise
    the one-process gossip on the (M * S)-row problem under A ⊗ I_S."""
    shape = CASES[case][1]
    m, s = shape[0], 4 // shape[0]
    a = FLTopology(**topo_kw(m)).mixing_matrix().astype(np.float32)
    want = tcns.GossipBackend(np.kron(a, np.eye(s, dtype=np.float32)),
                              T_S).mix(server_rows(world, case, "pre"))
    for g, w in zip(server_rows(world, case, "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def predicted_tp_sites(case: str) -> dict:
    """Calls and bytes by TP site on one rank for the case's epoch.  A
    client step: ``tp_forward`` the embedding's reduce of (b, s, d), each
    encoder layer's two row-parallel blocks on (b, s_enc, d) and each
    decoder layer's three (self-attention, cross-attention, MLP) on the
    decoder's (b, s, d), with a vision frontend's patches counted in s;
    ``tp_backward`` each column-parallel block's input once (two a layer
    in the encoder and in a decoder without cross-attention, three with
    it) and the head's on (b, s - 1, d); ``tp_memory`` the memory once
    (b, s_enc, d); ``tp_vocab`` two calls of 3 values a position."""
    arch, shape, _ = CASES[case]
    cfg = get_smoke(arch)
    L, d, f = cfg.num_layers, cfg.d_model, 4
    s = SEQ + (cfg.frontend.num_tokens if cfg.encdec is None else 0)
    tok, enc = B * SEQ * d * f, B * ENC * d * f
    act = B * s * d * f
    per_dec = 3 if cfg.encdec is not None else 2
    le = cfg.encdec.num_encoder_layers if cfg.encdec is not None else 0
    fwd = (1 + 2 * le + per_dec * L, tok + 2 * le * enc + per_dec * L * act)
    bwd = (2 * le + per_dec * L + 1,
           2 * le * enc + per_dec * L * act + B * (SEQ - 1) * d * f)
    out = {"tp_forward": fwd, "tp_backward": bwd,
           "tp_vocab": (2, 3 * B * (SEQ - 1) * f)}
    if cfg.encdec is not None:
        out["tp_memory"] = (1, enc)
    return {k: (T_C * c, T_C * n) for k, (c, n) in out.items()}


@pytest.mark.parametrize("case", PLAIN)
def test_tp_collectives_by_site(world, case):
    """The TP sites' calls and bytes to the byte: no whole gather
    (``tp_kv_gather``), no ``fsdp_gather``."""
    want = predicted_tp_sites(case)
    for w in world:
        c = w[case]["collectives"]
        got = {k: (v, c["site_bytes"][k]) for k, v in c["sites"].items()
               if k.startswith("tp_")}
        assert got == want
        assert "fsdp_gather" not in c["sites"]


# ---------------------------------------------------------------------------
# outside the world
# ---------------------------------------------------------------------------


def _backend(cfg, shape, rank: int = 0):
    params = ttf.init_params(torch.Generator(), cfg, device="meta")
    topo = FLTopology(**topo_kw(shape[0]))
    mesh = mesh_of(shape, rank=rank)
    backend = shd.fl_consensus_backend(topo, mesh, tree_map(
        lambda x: torch.empty((shape[0],) + tuple(x.shape), device="meta"),
        params), tp_axis="model")
    return topo, backend


def _build(cfg, shape):
    topo, backend = _backend(cfg, shape)
    return tdfl.build_dfl_epoch_step(
        tdfl.DFLConfig(topology=topo, consensus_backend=backend),
        ttf.make_loss_fn(cfg), sgd(GAMMA))


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_encdec_and_vision_frontend_build_under_tp(arch):
    """The step builds on a (1, 1, 2, 2) mesh (FSDP x TP), and neither
    resolver refuses the family."""
    cfg = get_smoke(arch)
    assert callable(_build(cfg, (1, 1, 2, 2)))
    assert ttf.tp_refusal(cfg, 2) is None
    assert ttf.tp_refusal(get_arch(arch), 16) is None


def test_a_cut_leaf_beside_a_whole_one_is_refused_by_name():
    """3 heads on 2 model ranks leave the attention leaves whole beside
    the cut MLP and vocab: refused, naming the leaves."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke(SEAMLESS), num_heads=3,
                              num_kv_heads=3)
    with pytest.raises(ValueError, match=r"multiplies pieces of \['w_o', "
                       r"'w_q'\]"):
        _build(cfg, (1, 1, 1, 2))


def test_encdec_tp_dims():
    """The encoder's attention and both decoder attentions cut over heads
    (their biases too), ``b_o`` and the norms whole, at the plan's TP 16
    on the full config."""
    params = ttf.init_params(torch.Generator(), get_arch(SEAMLESS),
                             device="meta")
    dims = shd.tp_dims(params, 16)
    enc = dims["encoder"]["stack"][0]["mixer"]
    cross = dims["stack"][0]["cross_attn"]
    for blk in (enc, cross):
        assert (blk["w_q"], blk["w_k"], blk["w_o"], blk["b_q"], blk["b_k"],
                blk["b_o"]) == (-2, -2, -3, -2, -2, None)
    assert dims["encoder"]["final_norm"]["scale"] is None
    assert dims["stack"][0]["cross_ln"]["scale"] is None
    assert dims["embed"] == -2 and dims["head"] == -1
