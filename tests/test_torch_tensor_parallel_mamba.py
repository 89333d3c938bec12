"""Tensor parallelism over "model" on Mamba-2 and the Jamba hybrid: the
rank-local epoch step on ``RankMesh`` meshes whose model axis cuts a
Mamba2 or Jamba client's layers
(``launch.sharding.fl_consensus_backend(..., tp_axis="model")``,
``launch.tp``, ``models.mamba.mamba_apply`` under ``tp``), one spawned
world of 4 gloo ranks, held against the JAX package's epoch step and the
port's one-process step on the same inputs.

The cases (f32, smoke configs, one epoch of T_C = 2, T_S = 3):

* ``mamba_tp2``: mamba2-smoke on (2, 1, 1, 2), its 8 heads 4 a rank;
* ``mamba_tp4``: mamba2-smoke on (1, 1, 1, 4): ``in_proj``'s 552 columns
  in blocks of 138, which straddle z / x and x / B / C / dt;
* ``jamba_tp2``: jamba-smoke on (2, 1, 1, 2): a mamba layer with a dense
  MLP, then a global attention layer with an MoE FFN (4 experts, 2 a
  rank);
* ``norm_control``: ``mamba_tp4`` with Megatron's grouped gated norm (one
  norm over each rank's heads: ``norm`` normalises the rank's piece by
  its own mean square, no sum over "model"), a different function.

Each plain case's assembled state (``launch.sharding.assemble``) is held
to the reference's ``build_dfl_epoch_step`` and to the port's one-process
step within ``REL`` of each leaf's largest |w|; the control must miss the
one-process step by more than ``REL``.  In every case: replicated leaves
(the norms, ``a_log``, ``dt_bias``, ``d_skip``, ``ln1``) bitwise across
each TP group, each rank's pieces ``local_shard`` of the assembled state,
the consensus bitwise the one-process backend on the (M * S)-row problem
under A ⊗ I_S, the TP sites' calls and bytes to the byte.  The weights'
per-head and per-channel leaves that the initializer sets to constants
(``dt_bias``, ``d_skip``, ``conv_b``, the norm scales) are drawn from a
numpy seed, so a rank reading another rank's heads shows.  Outside the
world: the refusals by name (a head count the axis does not divide,
mamba2-smoke at TP 16, whose ``in_proj`` the axis then leaves whole) and
``launch.sharding.tp_dims`` on the full configs (meta).
"""
import functools
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

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
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              tree_map_with_path)

T_C, T_S, SEQ, B, GAMMA, SEED = 2, 3, 40, 2, 0.05, 0
#: a leaf's largest difference from the reference's and from the
#: one-process port's, over its largest |w|: the TP sums regroup f32
#: contractions (``in_proj``'s column blocks, ``out_proj``'s row blocks,
#: the scan's per-head einsums), carried through two SGD steps and the
#: gossip
REL = 1e-5
# case -> (arch, mesh shape (M, N, R, TP), the grouped-norm control)
CASES = {
    "mamba_tp2": ("mamba2-780m", (2, 1, 1, 2), False),
    "mamba_tp4": ("mamba2-780m", (1, 1, 1, 4), False),
    "jamba_tp2": ("jamba-1.5-large-398b", (2, 1, 1, 2), False),
    "norm_control": ("mamba2-780m", (1, 1, 1, 4), True),
}
PLAIN = [c for c in CASES if not CASES[c][2]]
#: the leaves the initializer sets to constants, drawn here instead
DRAWN = ("dt_bias", "d_skip", "conv_b", "scale")


def tokens_for(arch: str, m: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, m])
    return rng.integers(0, get_smoke(arch).vocab_size,
                        size=(T_C, m, 1, B, SEQ)).astype(np.int64)


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
            res = {name: run_case(rank, spec, *case)
                   for name, case in spec["cases"].items()}
            assert not [n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")]
            torch.save(res, out + f".{rank}")
        finally:
            dist.destroy_process_group()


    class GroupedNorm:
        """A ModelParallel whose gated norm runs over the rank's heads
        alone (the control): the piece normalised by its own mean
        square."""

        def __init__(self, tp):
            self.tp = tp

        def __getattr__(self, name):
            return getattr(self.tp, name)

        def norm(self, piece, scale, eps):
            from repro_torch.models.modules import rmsnorm_apply
            return rmsnorm_apply({"scale": scale}, piece, eps)


    def run_case(rank, spec, arch, shape, control):
        from repro_torch.configs import get_smoke
        from repro_torch.core import (DFLConfig, FLTopology,
                                      build_dfl_epoch_step, init_dfl_state)
        from repro_torch.core import consensus as cns
        from repro_torch.launch import mesh as lm
        from repro_torch.launch import sharding as shd
        from repro_torch.models import mamba as mm
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
        apply = mm.mamba_apply

        def grouped(params, x, cfg, impl="reference", tp=None):
            return apply(params, x, cfg, impl, tp=GroupedNorm(tp))

        if control:
            mm.mamba_apply = grouped
        try:
            cns.reset_collective_counts()
            toks = torch.from_numpy(spec["tokens"][(arch, m)])
            state, mt = step(state, {"tokens": toks})
        finally:
            mm.mamba_apply = apply
        return dict(
            rec, coords=mesh.coords(),
            clients=[x.clone() for x in tree_leaves(state.client_params)],
            metrics={k: getattr(mt, k).clone() for k in
                     ("loss", "server_disagreement", "client_drift",
                      "grad_norm")},
            collectives=cns.collective_counts())


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


def _drawn(tree, rng, name=""):
    """``tree`` (numpy leaves under dicts and tuples) with the DRAWN
    leaves replaced: a norm scale 1 + 0.1 N(0, 1), the others 0.1 N(0, 1)
    added."""
    if isinstance(tree, dict):
        return {k: _drawn(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_drawn(v, rng, name) for v in tree)
    if name not in DRAWN:
        return tree
    noise = 0.1 * rng.standard_normal(tree.shape)
    return (1.0 + noise if name == "scale" else tree + noise).astype(
        tree.dtype)


@functools.lru_cache(maxsize=None)
def np_params(arch: str) -> dict:
    """The seeded weights both packages start from (numpy leaves)."""
    jparams = jtf.init_params(jax.random.key(7), j_get_smoke(arch))
    return _drawn(jax.tree.map(np.asarray, jparams),
                  np.random.default_rng([SEED, 31]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks; each rank's own
    results, by rank.  The references (the JAX package's epochs and the
    port's one-process ones) are computed while the world runs."""
    d = tmp_path_factory.mktemp("tensor_parallel_mamba_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    toks = {(a, s[0]): tokens_for(a, s[0]) for a, s, _ in CASES.values()}
    spec = dict(t_c=T_C, t_s=T_S, gamma=GAMMA, tokens=toks,
                params={a: np_params(a) for a, _, _ in CASES.values()},
                cases=CASES)
    torch.save(spec, spec_path)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(script), str(out),
                             str(d / "rdv"), str(spec_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        keys = sorted({(a, s[0]) for a, s, _ in CASES.values()})
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda k: reference(*k), keys))
        for case in CASES:
            one(case)
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
                        ttf.params_from_numpy(np_params(arch)))
    return tree_leaves(shd.fl_param_specs(abs_tree, mesh_of(shape),
                                          tp_axis="model"))


def leaf_names(case: str) -> list:
    """Each client leaf's key path, '/'-joined (tree order)."""
    out = []
    tree_map_with_path(
        lambda p, x: out.append("/".join(str(getattr(e, "key", getattr(
            e, "idx", e))) for e in p)),
        ttf.params_from_numpy(np_params(CASES[case][0])))
    return out


def assembled(world, case: str) -> list:
    """The federation's leaves from every rank's pieces."""
    mesh = mesh_of(CASES[case][1])
    return [shd.assemble([w[case]["clients"][i] for w in world], sp, mesh)
            for i, sp in enumerate(client_specs(case))]


@functools.lru_cache(maxsize=None)
def one_process(arch: str, m: int):
    """The port's one-process epoch of a federation: (state leaves,
    metrics)."""
    topo = FLTopology(**topo_kw(m))
    cfg = tdfl.DFLConfig(topology=topo)
    opt = sgd(GAMMA)
    step = tdfl.build_dfl_epoch_step(cfg, ttf.make_loss_fn(get_smoke(arch)),
                                     opt)
    state = tdfl.init_dfl_state(cfg, ttf.params_from_numpy(np_params(arch)),
                                opt)
    state, mt = step(state, {"tokens": torch.from_numpy(tokens_for(arch, m))})
    return [x.clone() for x in tree_leaves(state.client_params)], mt


def one(case: str):
    arch, shape, _ = CASES[case]
    return one_process(arch, shape[0])


@functools.lru_cache(maxsize=None)
def reference(arch: str, m: int):
    """The JAX package's static epoch on the same weights and tokens:
    (client leaves, losses)."""
    cfg = jdfl.DFLConfig(topology=JTopology(**topo_kw(m)))
    opt = j_sgd(GAMMA)
    step = jax.jit(jdfl.build_dfl_epoch_step(
        cfg, jtf.make_loss_fn(j_get_smoke(arch),
                              jtf.ApplyOptions(remat=False)), opt))
    jparams = jax.tree.map(jnp.asarray, np_params(arch))
    state = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))
    state, mt = step(state, {"tokens": jnp.asarray(tokens_for(arch, m))})
    return ([np.asarray(x) for x in jax.tree.leaves(state.client_params)],
            np.asarray(mt.loss))


def rel_diff(got, want) -> float:
    """The largest difference over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def worst_leaf(got: list, want: list, names: list) -> tuple:
    return max((rel_diff(g, w), name)
               for g, w, name in zip(got, want, names))


@pytest.mark.parametrize("case", PLAIN)
def test_tp_epoch_matches_the_reference(world, case):
    arch, shape, _ = CASES[case]
    got = assembled(world, case)
    want, loss = reference(arch, shape[0])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    worst = worst_leaf([g.numpy() for g in got], want, leaf_names(case))
    assert worst[0] <= REL, worst
    for w in world:
        assert rel_diff(w[case]["metrics"]["loss"].numpy(), loss) <= REL


@pytest.mark.parametrize("case", PLAIN)
def test_tp_epoch_matches_the_one_process_port(world, case):
    """Each leaf, the losses (every TP rank computes the same), the grad
    norm over each piece once."""
    got = assembled(world, case)
    want, mt = one(case)
    worst = worst_leaf([g.numpy() for g in got], [w.numpy() for w in want],
                       leaf_names(case))
    assert worst[0] <= REL, worst
    for w in world:
        mw = w[case]["metrics"]
        assert rel_diff(mw["loss"].numpy(), mt.loss.numpy()) <= REL
        np.testing.assert_allclose(float(mw["grad_norm"]),
                                   float(mt.grad_norm), rtol=1e-5)


def test_grouped_norm_control_misses(world):
    """Megatron's grouped gated norm (one norm a rank's heads) is another
    function: the control's state misses the one-process step by more
    than ``REL`` where ``mamba_tp4``'s is within it, and its ``out_proj``
    and the norm's scale (what the norm's output reaches first) miss."""
    names = leaf_names("norm_control")
    want = [w.numpy() for w in one("norm_control")[0]]
    ctl = [g.numpy() for g in assembled(world, "norm_control")]
    good = [g.numpy() for g in assembled(world, "mamba_tp4")]
    assert worst_leaf(good, want, names)[0] <= REL
    assert worst_leaf(ctl, want, names)[0] > REL
    for suffix in ("mixer/out_proj", "mixer/norm/scale"):
        idx = [i for i, n in enumerate(names) if n.endswith(suffix)]
        assert idx and min(rel_diff(ctl[i], want[i]) for i in idx) > REL


def _tp_groups(shape) -> list:
    """The ranks of each TP group (the ranks along "model")."""
    mesh = mesh_of(shape)
    seen = []
    for r in range(4):
        g = mesh.ranks_along("model", r)
        if g not in seen:
            seen.append(g)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_are_bitwise_across_the_tp_group(world, case):
    """A leaf not cut over "model" (the norms, ``a_log``, ``dt_bias``,
    ``d_skip``, the router) is the same on every rank of a TP group:
    before the consensus and after it."""
    shape = CASES[case][1]
    keys = (["pre"] if shape[0] > 1 else []) + ["clients"]
    server = [shd.PartitionSpec(sp[0], *sp.dims[2:])
              for sp in client_specs(case)]
    names = leaf_names(case)
    replicated = {names[i] for i, sp in enumerate(server)
                  if shd.model_dim(sp) is None}
    for leaf in ("a_log", "dt_bias", "d_skip", "mixer/norm/scale",
                 "ln1/scale"):
        assert any(n.endswith(leaf) for n in replicated), leaf
    for key in keys:
        specs = client_specs(case) if key == "clients" else server
        for i, sp in enumerate(specs):
            if shd.model_dim(sp) is not None:
                continue
            for group in _tp_groups(shape):
                first = world[group[0]][case][key][i]
                for r in group[1:]:
                    assert torch.equal(world[r][case][key][i], first), \
                        (key, names[i], r)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_pieces(world, case):
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
    m = CASES[case][1][0]
    a = FLTopology(**topo_kw(m)).mixing_matrix().astype(np.float32)
    want = tcns.GossipBackend(np.kron(a, np.eye(4 // m, dtype=np.float32)),
                              T_S).mix(server_rows(world, case, "pre"))
    for g, w in zip(server_rows(world, case, "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def predicted_tp_sites(case: str) -> dict:
    """Calls and bytes by TP site on one rank for the case's epoch (f32),
    per client step: ``tp_forward`` the embedding's, each mixer's
    (``out_proj``, ``w_o``), a dense MLP's ``down`` and an MoE layer's
    routed sum ((b, s, d)); ``tp_backward`` each mixer's input, a dense
    MLP's, an MoE layer's experts' and the head's (on the s - 1 positions
    the loss reads); ``tp_gates`` an MoE layer's (b s, k) gates;
    ``tp_vocab`` two (3 values a position); a mamba layer's
    ``tp_replicated`` (the norm's scale, ``dt_bias``, ``a_log``,
    ``d_skip``: d_inner + 3 nh values), ``tp_ssm_gather`` (the rank's
    (b, s, W / TP) block of in_proj's output and its (d_conv + 1, ch / TP)
    conv pieces), ``tp_ssm_reduce`` (their whole gradients), and, but in
    the control, ``tp_ssm_norm`` (the gated norm's (b, s) f32 sums of
    squares) and ``tp_ssm_norm_reduce`` (its (b, s) f32 sums of
    g * scale * x)."""
    arch, shape, control = CASES[case]
    cfg = get_smoke(arch)
    tp = shape[3]
    mc = cfg.mamba
    di, nh = mc.d_inner(cfg.d_model), mc.num_heads(cfg.d_model)
    ch = di + 2 * mc.d_state
    width = 2 * di + 2 * mc.d_state + nh
    kinds = [cfg.pattern_for_layer(i) for i in range(cfg.num_layers)]
    mamba = kinds.count("mamba")
    moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    dense = sum(1 for i, k in enumerate(kinds) if not cfg.is_moe_layer(i)
                and cfg.d_ff > 0 and k != "mamba_only")
    steps, tok = T_C, B * SEQ
    act = tok * cfg.d_model * 4
    fwd = 1 + cfg.num_layers + dense + moe
    bwd = cfg.num_layers + dense + moe
    out = {"tp_forward": (steps * fwd, steps * fwd * act),
           "tp_backward": (steps * (bwd + 1), steps * (
               bwd * act + B * (SEQ - 1) * cfg.d_model * 4)),
           "tp_vocab": (steps * 2, steps * 3 * B * (SEQ - 1) * 4),
           "tp_replicated": (steps * mamba,
                             steps * mamba * (di + 3 * nh) * 4),
           "tp_ssm_gather": (steps * mamba, steps * mamba * (
               tok * width + (mc.d_conv + 1) * ch) // tp * 4),
           "tp_ssm_reduce": (steps * mamba, steps * mamba * (
               tok * width + (mc.d_conv + 1) * ch) * 4)}
    if moe:
        out["tp_gates"] = (steps * moe, steps * moe * tok * cfg.moe.top_k
                           * 4)
    if not control:
        out["tp_ssm_norm"] = (steps * mamba, steps * mamba * tok * 4)
        out["tp_ssm_norm_reduce"] = (steps * mamba, steps * mamba * tok * 4)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_tp_collectives_by_site(world, case):
    """The TP sites' calls and bytes to the byte; no ``fsdp_gather``, no
    kv fallback's gather (jamba-smoke's 2 kv heads divide 2)."""
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


def _meta_dims(arch: str, tp: int) -> dict:
    params = ttf.init_params(torch.Generator(), get_arch(arch),
                             device="meta")
    return shd.tp_dims(params, tp)


def _backend(arch: str, shape):
    params = ttf.init_params(torch.Generator(), get_smoke(arch),
                             device="meta")
    topo = FLTopology(**topo_kw(shape[0]))
    return topo, shd.fl_consensus_backend(topo, mesh_of(shape), tree_map(
        lambda x: torch.empty((shape[0],) + tuple(x.shape), device="meta"),
        params), tp_axis="model")


def test_tp_refuses_a_head_count_the_axis_does_not_divide():
    """mamba2-smoke at TP 16: 8 heads over 16 ranks, and ``in_proj``'s
    552 columns, which 16 does not divide, left whole while ``out_proj`` is
    cut: each refusal names its cause; the step does not build."""
    cfg = get_smoke("mamba2-780m")
    assert ttf.tp_refusal(cfg, 2) is None and ttf.tp_refusal(cfg, 4) is None
    why = ttf.tp_refusal(cfg, 16)
    assert "8 heads do not divide over 16 model ranks" in why
    with pytest.raises(ValueError, match="8 heads do not divide"):
        ttf.make_loss_fn(cfg).with_tp(type("MP", (), {"size": 16})())
    topo, backend = _backend("mamba2-780m", (1, 1, 1, 16))
    why = shd.tp_refusal(backend.leaf_specs)
    assert "['in_proj']" in why and "leaves whole" in why
    with pytest.raises(ValueError, match=r"\['in_proj'\]"):
        tdfl.build_dfl_epoch_step(
            tdfl.DFLConfig(topology=topo, consensus_backend=backend),
            ttf.make_loss_fn(cfg), sgd(GAMMA))


@pytest.mark.parametrize("tp", [2, 4, 16])
def test_tp_dims_of_mamba2(tp):
    """Mamba2-780M's 48 heads, its in_proj width 6448 and xBC width 3328
    divide 2, 4 and 16: in_proj, conv_w and conv_b cut over their last
    dim, out_proj over d_inner; a_log, dt_bias, d_skip and the norms
    whole."""
    mix = _meta_dims("mamba2-780m", tp)["stack"][0]["mixer"]
    assert (mix["in_proj"], mix["conv_w"], mix["conv_b"], mix["out_proj"]) \
        == (-1, -1, -1, -2)
    assert mix["a_log"] is None and mix["dt_bias"] is None
    assert mix["d_skip"] is None and mix["norm"]["scale"] is None
    cfg = get_arch("mamba2-780m")
    assert ttf.tp_refusal(cfg, tp) is None


def test_tp_dims_of_jamba():
    """Jamba-1.5-Large at the plan's TP 16: a mamba layer cut as
    Mamba2's (width 33280, 256 heads), the attention layer at index 4
    over its 64 q / 8 kv heads (``w_k`` / ``w_v`` on the head-dim
    fallback), the odd layers' 16 experts by expert."""
    dims = _meta_dims("jamba-1.5-large-398b", 16)["stack"]
    cfg = get_arch("jamba-1.5-large-398b")
    assert ttf.tp_refusal(cfg, 16) is None
    for i, layer in enumerate(dims):
        mix = layer["mixer"]
        if cfg.pattern_for_layer(i) == "mamba":
            assert (mix["in_proj"], mix["conv_w"], mix["out_proj"]) == \
                (-1, -1, -2)
            assert mix["a_log"] is None and mix["norm"]["scale"] is None
        else:
            assert (mix["w_q"], mix["w_k"], mix["w_o"]) == (-2, -1, -3)
        ffn = layer["ffn"]
        if cfg.is_moe_layer(i):
            assert (ffn["w_gate"], ffn["w_down"], ffn["router"]) == \
                (-3, -3, None)
        else:
            assert (ffn["gate"], ffn["down"]) == (-1, -2)
