"""Tensor parallelism over "model" on the MoE and MLA families: the
rank-local epoch step on ``RankMesh`` meshes whose model axis cuts a
Mixtral or DeepSeek-V2 client's layers
(``launch.sharding.fl_consensus_backend(..., tp_axis="model")``,
``launch.tp``, ``models.modules.moe_apply`` / ``mla_apply`` under ``tp``),
one spawned world of 4 gloo ranks, held against the JAX package's epoch
step and the port's one-process step on the same inputs.

The cases (f32, smoke configs, one epoch of T_C = 2, T_S = 3):

* ``mixtral_tp2``: mixtral-smoke on (2, 1, 1, 2), its 4 experts cut 2 a
  rank (expert-parallel), 8 q / 2 kv heads 4 / 1 a rank;
* ``mixtral_tp4``: mixtral-smoke on (1, 1, 1, 4): one expert a rank, the
  kv heads on the head-dim fallback;
* ``deepseek_tp2`` / ``deepseek_tp4``: deepseek-smoke on (2, 1, 1, 2) and
  (1, 1, 1, 4): MLA (``w_dq`` over the q latent, gathered whole; ``w_uq``
  / ``w_ukv`` / ``w_o`` over heads), the routed experts expert-parallel,
  the shared experts and the dense prefix layer column / row parallel;
* ``mixtral_dff``: mixtral-smoke with 2 experts on (1, 1, 1, 4): 2
  experts do not divide 4, so every expert runs on the rank's d_ff
  columns (``launch.sharding.MOE_DFF_FALLBACK``);
* ``mixtral_wire``: mixtral-smoke on (2, 1, 1, 2), the int8 physical wire
  with error feedback (the plan's wire).

Each plain case's assembled state (``launch.sharding.assemble``) is held
to the reference's ``build_dfl_epoch_step`` and to the port's one-process
step within ``REL`` of each leaf's largest |w|: the row-parallel and the
per-rank expert sums regroup f32 contractions.  Each layer's expert
indices, recorded on every rank (``moe_route``), equal one process's:
every rank routes every token from the same input.  In every case:
replicated leaves (the norms, the router, ``w_dkv``) bitwise across each
TP group, each rank's pieces ``local_shard`` of the assembled state, the
consensus bitwise the one-process backend on the (M * S)-row problem under
A ⊗ I_S, and the collectives by site to the byte (the gates' all-reduce
``tp_gates``, MLA's latent gather ``tp_latent_gather`` /
``tp_latent_reduce``).

``router_control`` is ``mixtral_tp4`` with the router built the naive
way: through ``tp.replicated`` and its gates not through ``tp.copy``, so
its aux-loss gradient, whole on every rank, is summed four times; its
router must miss the one-process router by more than ``REL``.  Outside
the world: ``launch.sharding.tp_dims`` on the full configs (meta), and
``init_dfl_state`` copying a rank's pieces out of the whole params.
"""
import dataclasses
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
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import modules as tnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              tree_map_with_path)

T_C, T_S, SEQ, B, GAMMA, SEED = 2, 3, 40, 2, 0.05, 0
#: a leaf's largest difference from the reference's and from the
#: one-process port's, over its largest |w|: the TP sums regroup f32
#: contractions, carried through two SGD steps and the gossip
REL = 1e-5
CODEC = "int8:64"
# case -> (arch, mesh shape (M, N, R, TP), clients a server, compression,
# MoE overrides (a tuple of (field, value)), the router control)
CASES = {
    "mixtral_tp2": ("mixtral-8x22b", (2, 1, 1, 2), 1, "none", (), False),
    "mixtral_tp4": ("mixtral-8x22b", (1, 1, 1, 4), 1, "none", (), False),
    "deepseek_tp2": ("deepseek-v2-236b", (2, 1, 1, 2), 1, "none", (),
                     False),
    "deepseek_tp4": ("deepseek-v2-236b", (1, 1, 1, 4), 1, "none", (),
                     False),
    "mixtral_dff": ("mixtral-8x22b", (1, 1, 1, 4), 1, "none",
                    (("num_experts", 2),), False),
    "mixtral_wire": ("mixtral-8x22b", (2, 1, 1, 2), 1, CODEC, (), False),
    "router_control": ("mixtral-8x22b", (1, 1, 1, 4), 1, "none", (), True),
}
PLAIN = [c for c in CASES if CASES[c][3] == "none" and not CASES[c][5]]


def variant(cfg, moe: tuple):
    """``cfg`` with its MoE fields ``moe`` replaced (either package)."""
    if not moe:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **dict(moe)))


def tokens_for(arch: str, m: int, n: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, m, n])
    return rng.integers(0, get_smoke(arch).vocab_size,
                        size=(T_C, m, n, B, SEQ)).astype(np.int64)


def topo_kw(m: int, n: int) -> dict:
    return dict(num_servers=m, clients_per_server=n, t_client=T_C,
                t_server=T_S)


# the script the ranks run: torch and repro_torch only
WORLD = textwrap.dedent('''
    import dataclasses
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


    class NoGateCopy:
        """A ModelParallel whose gates skip ``copy`` (the control)."""

        def __init__(self, tp):
            self.tp = tp

        def __getattr__(self, name):
            return getattr(self.tp, name)

        def copy(self, x, site="tp_backward"):
            return x if site == "tp_gates" else self.tp.copy(x, site)


    def run_case(rank, spec, arch, shape, n, compression, moe, control):
        from repro_torch.comm import prng
        from repro_torch.configs import get_smoke
        from repro_torch.core import (DFLConfig, FLTopology,
                                      build_dfl_epoch_step, init_dfl_state)
        from repro_torch.core import consensus as cns
        from repro_torch.launch import mesh as lm
        from repro_torch.launch import sharding as shd
        from repro_torch.models import modules as nn
        from repro_torch.models import transformer as tf
        from repro_torch.optim import sgd
        from repro_torch.tree import tree_leaves, tree_map
        cfg = get_smoke(arch)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **dict(moe)))
        mesh = lm.fl_rank_mesh(lm.FLMeshSpec(*shape))
        m = shape[0]
        topo = FLTopology(num_servers=m, clients_per_server=n,
                          t_client=spec["t_c"], t_server=spec["t_s"])
        params = tf.params_from_numpy(spec["params"][(arch, moe)])
        server_abs = tree_map(lambda x: torch.empty(
            (m,) + tuple(x.shape), device="meta"), params)
        wire = compression != "none"
        backend = shd.fl_consensus_backend(
            topo, mesh, server_abs, tp_axis="model",
            compression=compression, error_feedback=wire,
            wire="physical" if wire else "simulated")
        dcfg = DFLConfig(topology=topo, consensus_backend=backend)
        opt = sgd(spec["gamma"])
        step = build_dfl_epoch_step(dcfg, tf.make_loss_fn(cfg), opt)
        state = init_dfl_state(dcfg, params, opt,
                               wire_key=prng.key(spec["seed"]))
        rec = {"routing": []}
        name = "mix_compressed" if wire else "mix"
        inner_mix = getattr(backend, name)

        def spy(tree, *a, **kw):
            rec["pre"] = [x.clone() for x in tree_leaves(tree)]
            if wire:
                rec["res_in"] = [x.clone() for x in
                                 tree_leaves(kw["residual"])]
                rec["key"] = kw["key"]
            out = inner_mix(tree, *a, **kw)
            mixed = out[0] if wire else out
            rec["post"] = [x.clone() for x in tree_leaves(mixed)]
            if wire:
                rec["res_out"] = [x.clone() for x in tree_leaves(out[1])]
            return out

        setattr(backend, name, spy)
        route, apply = nn.moe_route, nn.moe_apply

        def recorded(params, tokens, cfg):
            out = route(params, tokens, cfg)
            rec["routing"].append(out[2].clone())
            return out

        def naive(params, x, cfg, *a, tp=None, **kw):
            params = dict(params, router=tp.replicated(params["router"]))
            return apply(params, x, cfg, *a, tp=NoGateCopy(tp), **kw)

        nn.moe_route = recorded
        if control:
            nn.moe_apply = naive
        try:
            cns.reset_collective_counts()
            toks = torch.from_numpy(spec["tokens"][(arch, m, n)])
            state, mt = step(state, {"tokens": toks})
        finally:
            nn.moe_route, nn.moe_apply = route, apply
        return dict(
            rec, coords=mesh.coords(),
            clients=[x.clone() for x in tree_leaves(state.client_params)],
            ef=(None if state.ef_residual is None else
                [x.clone() for x in tree_leaves(state.ef_residual)]),
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


@functools.lru_cache(maxsize=None)
def np_params(arch: str, moe: tuple = ()) -> dict:
    """The seeded weights both packages start from (numpy leaves)."""
    jparams = jtf.init_params(jax.random.key(7),
                              variant(j_get_smoke(arch), moe))
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks; each rank's own
    results, by rank.  The references (the JAX package's epochs and the
    port's one-process ones) are computed while the world runs."""
    d = tmp_path_factory.mktemp("tensor_parallel_moe_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    toks = {(a, s[0], n): tokens_for(a, s[0], n)
            for a, s, n, *_ in CASES.values()}
    spec = dict(t_c=T_C, t_s=T_S, gamma=GAMMA, seed=SEED, tokens=toks,
                params={(a, moe): np_params(a, moe)
                        for a, _, _, _, moe, _ in CASES.values()},
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
        # the JAX references' traces and compiles, three at a time
        keys = sorted({(a, moe, s[0], n)
                       for a, s, n, _, moe, control in CASES.values()
                       if not control})
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


def port_config(case: str):
    arch, *_, moe, _ = CASES[case]
    return variant(get_smoke(arch), moe)


def client_specs(case: str) -> list:
    """Each client leaf's ``(M, N, *w)`` spec on the case's mesh."""
    arch, shape, n, _, moe, _ = CASES[case]
    abs_tree = tree_map(lambda x: torch.empty((shape[0], n) + tuple(x.shape),
                                              device="meta"),
                        ttf.params_from_numpy(np_params(arch, moe)))
    return tree_leaves(shd.fl_param_specs(abs_tree, mesh_of(shape),
                                          tp_axis="model"))


def leaf_names(case: str) -> list:
    """Each client leaf's key path, '/'-joined (tree order)."""
    arch, *_, moe, _ = CASES[case]
    out = []
    tree_map_with_path(
        lambda p, x: out.append("/".join(str(getattr(e, "key", getattr(
            e, "idx", e))) for e in p)),
        ttf.params_from_numpy(np_params(arch, moe)))
    return out


def assembled(world, case: str, key: str = "clients") -> list:
    """The federation's leaves from every rank's pieces."""
    mesh = mesh_of(CASES[case][1])
    return [shd.assemble([w[case][key][i] for w in world], sp, mesh)
            for i, sp in enumerate(client_specs(case))]


@functools.lru_cache(maxsize=None)
def one_process(arch: str, moe: tuple, m: int, n: int):
    """The port's one-process epoch of a federation: (state leaves,
    metrics, the backend's pre-consensus rows and the routing)."""
    topo = FLTopology(**topo_kw(m, n))
    rec = {"routing": []}
    inner = tcns.GossipBackend(topo.mixing_matrix() if m > 1
                               else np.ones((1, 1)), T_S)
    mix = inner.mix

    def spy(tree, *a, **kw):
        rec["pre"] = [x.clone() for x in tree_leaves(tree)]
        return mix(tree, *a, **kw)

    inner.mix = spy
    route = tnn.moe_route

    def recorded(params, tokens, cfg):
        out = route(params, tokens, cfg)
        rec["routing"].append(out[2].clone())
        return out

    cfg = tdfl.DFLConfig(topology=topo, consensus_backend=inner)
    opt = sgd(GAMMA)
    step = tdfl.build_dfl_epoch_step(
        cfg, ttf.make_loss_fn(variant(get_smoke(arch), moe)), opt)
    state = tdfl.init_dfl_state(cfg, ttf.params_from_numpy(
        np_params(arch, moe)), opt)
    tnn.moe_route = recorded
    try:
        state, mt = step(state, {"tokens": torch.from_numpy(
            tokens_for(arch, m, n))})
    finally:
        tnn.moe_route = route
    return [x.clone() for x in tree_leaves(state.client_params)], mt, rec


def one(case: str):
    arch, shape, n, _, moe, _ = CASES[case]
    return one_process(arch, moe, shape[0], n)


@functools.lru_cache(maxsize=None)
def reference(arch: str, moe: tuple, m: int, n: int):
    """The JAX package's static epoch on the same weights and tokens:
    (client leaves, losses)."""
    jcfg = variant(j_get_smoke(arch), moe)
    cfg = jdfl.DFLConfig(topology=JTopology(**topo_kw(m, n)))
    opt = j_sgd(GAMMA)
    step = jax.jit(jdfl.build_dfl_epoch_step(
        cfg, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)), opt))
    jparams = jax.tree.map(jnp.asarray, np_params(arch, moe))
    state = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))
    state, mt = step(state, {"tokens": jnp.asarray(tokens_for(arch, m, n))})
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
    arch, shape, n, _, moe, _ = CASES[case]
    got = assembled(world, case)
    want, loss = reference(arch, moe, shape[0], n)
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
    want, mt, _ = one(case)
    worst = worst_leaf([g.numpy() for g in got], [w.numpy() for w in want],
                       leaf_names(case))
    assert worst[0] <= REL, worst
    for w in world:
        mw = w[case]["metrics"]
        assert rel_diff(mw["loss"].numpy(), mt.loss.numpy()) <= REL
        np.testing.assert_allclose(float(mw["grad_norm"]),
                                   float(mt.grad_norm), rtol=1e-5)


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][5]])
def test_routing_equals_one_process(world, case):
    """Each MoE layer's expert indices on every rank of every step equal
    the one-process run's: every rank routes every token from the same
    input.  A flip here is a finding, reported, never re-seeded away."""
    want = one(case)[2]["routing"]
    m = CASES[case][1][0]
    for r, w in enumerate(world):
        got = w[case]["routing"]
        # the one-process run routes every server's client in turn; a
        # rank its own server's
        srv = w[case]["coords"]["server"]
        mine = [x for i, x in enumerate(want)
                if (i // (len(want) // (T_C * m))) % m == srv]
        assert len(got) == len(mine), (r, len(got), len(mine))
        flips = sum(int((a != b).any(-1).sum()) for a, b in zip(got, mine))
        assert flips == 0, f"rank {r}: {flips} routing flips against one " \
            f"process"


def _tp_groups(shape) -> list:
    """The ranks of each TP group (the ranks along "model")."""
    mesh = mesh_of(shape)
    seen = []
    for r in range(4):
        g = mesh.ranks_along("model", r)
        if g not in seen:
            seen.append(g)
    return seen


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][5]])
def test_replicated_leaves_are_bitwise_across_the_tp_group(world, case):
    """A leaf not cut over "model" (the norms, the router, ``w_dkv``) is
    the same on every rank of a TP group: before the consensus always,
    after it on the plain program."""
    shape = CASES[case][1]
    keys = (["pre"] if shape[0] > 1 else []) + (
        ["clients"] if CASES[case][3] == "none" else [])
    server = [shd.PartitionSpec(sp[0], *sp.dims[2:])
              for sp in client_specs(case)]
    names = leaf_names(case)
    replicated = [names[i] for i, sp in enumerate(server)
                  if shd.model_dim(sp) is None]
    assert any(n.endswith("router") for n in replicated)
    if CASES[case][0].startswith("deepseek"):
        assert any(n.endswith("w_dkv") for n in replicated)
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


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][5]])
def test_each_rank_holds_its_pieces(world, case):
    shape = CASES[case][1]
    full = assembled(world, case)
    for r, w in enumerate(world):
        mesh = mesh_of(shape, r)
        for x, sp, piece in zip(full, client_specs(case), w[case]["clients"]):
            if CASES[case][3] != "none" and shd.model_dim(sp) is None:
                continue
            np.testing.assert_array_equal(
                piece.numpy(), shd.local_shard(x, sp, mesh).numpy())


def server_rows(world, case: str, key: str) -> list:
    """The (M * S)-row problem of a consensus period: row r = rank r's
    pieces (a rank's index is ``server * S + sub``)."""
    return [torch.cat([w[case][key][i] for w in world])
            for i in range(len(world[0][case][key]))]


@pytest.mark.parametrize("case", [c for c in PLAIN if CASES[c][1][0] > 1])
def test_tp_consensus_is_the_kron_emulation(world, case):
    _, shape, n, *_ = CASES[case]
    m, s = shape[0], 4 // shape[0]
    a = FLTopology(**topo_kw(m, n)).mixing_matrix().astype(np.float32)
    want = tcns.GossipBackend(np.kron(a, np.eye(s, dtype=np.float32)),
                              T_S).mix(server_rows(world, case, "pre"))
    for g, w in zip(server_rows(world, case, "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_wire_local_period_is_the_plain_one_and_consensus_the_emulation(
        world):
    """The int8 physical wire with error feedback on (2, 1, 1, 2): its
    local period (the pre-consensus pieces) bitwise ``mixtral_tp2``'s; the
    mixed pieces and the new residual bitwise the one-process
    ``CompressedBackend`` on the (M * S)-row problem under A ⊗ I_S with the
    same consensus key; the state carries them."""
    for w in world:
        for x, y in zip(w["mixtral_wire"]["pre"], w["mixtral_tp2"]["pre"]):
            assert torch.equal(x, y)
    a = FLTopology(**topo_kw(2, 1)).mixing_matrix().astype(np.float32)
    keys = {tuple(np.asarray(w["mixtral_wire"]["key"]).tolist())
            for w in world}
    assert len(keys) == 1
    backend = tcns.CompressedBackend(
        tcns.GossipBackend(np.kron(a, np.eye(2, dtype=np.float32)), T_S),
        tcp.make_compressor(CODEC), error_feedback=True, wire="physical",
        wire_block=16_777_216)
    want, want_res = backend.mix_compressed(
        server_rows(world, "mixtral_wire", "pre"),
        residual=server_rows(world, "mixtral_wire", "res_in"),
        key=np.asarray(world[0]["mixtral_wire"]["key"]))
    for g, w in zip(server_rows(world, "mixtral_wire", "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(server_rows(world, "mixtral_wire", "res_out"), want_res):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for w in world:
        for c, p in zip(w["mixtral_wire"]["clients"],
                        w["mixtral_wire"]["post"]):
            np.testing.assert_array_equal(
                c.numpy(), p[:, None].expand_as(c).numpy())
        for e, p in zip(w["mixtral_wire"]["ef"], w["mixtral_wire"]["res_out"]):
            np.testing.assert_array_equal(e.numpy(), p.numpy())


def test_router_control_fails_the_router_check(world):
    """The naive router (``tp.replicated``, gates not through ``copy``)
    sums the aux loss's whole gradient over the four ranks: its router
    misses the one-process router by more than ``REL`` (at the config's
    ``router_aux_weight`` of 0.01), where ``mixtral_tp4``'s is within."""
    names = leaf_names("router_control")
    idx = [i for i, n in enumerate(names) if n.endswith("router")]
    want = one("router_control")[0]
    ctl = assembled(world, "router_control")
    good = assembled(world, "mixtral_tp4")
    assert get_smoke("mixtral-8x22b").moe.router_aux_weight == 0.01
    assert max(rel_diff(good[i].numpy(), want[i].numpy()) for i in idx) \
        <= REL
    assert min(rel_diff(ctl[i].numpy(), want[i].numpy()) for i in idx) \
        > REL


def predicted_tp_sites(case: str) -> dict:
    """Calls and bytes by TP site on one rank for the case's epoch, per
    client step: ``tp_forward`` the embedding's, each mixer's ``w_o``, a
    dense MLP's ``down``, an MoE layer's routed sum and its shared
    experts' (f32 (b, s, d)); ``tp_backward`` each mixer's input, a dense
    MLP's, an MoE layer's experts' and shared experts' inputs, the head's
    (on the s - 1 positions the loss reads); ``tp_gates`` an MoE layer's
    (g, tg, k) gates; ``tp_vocab`` two a loss chunk (3 values a position);
    under MLA ``tp_latent_gather`` the rank's (b, s, q_rank / TP) piece and
    ``tp_latent_reduce`` the whole latent's gradient a layer,
    ``tp_replicated`` ``q_norm``, ``kv_norm`` and ``w_dkv`` a layer; under
    the head-dim fallback one ``tp_kv_gather`` of a layer's ``w_k`` /
    ``w_v`` pieces and one ``tp_kv_reduce`` of their whole gradients."""
    cfg = port_config(case)
    shape = CASES[case][1]
    tp = shape[3]
    plan = ttf.stack_plan(cfg)
    layers = cfg.num_layers
    prefix = plan.num_prefix
    moe = sum(cfg.is_moe_layer(i) for i in range(layers))
    dense = layers - moe
    shared = moe if cfg.moe.num_shared_experts else 0
    steps = T_C
    act = B * SEQ * cfg.d_model * 4
    fwd = 1 + layers + dense + moe + shared
    bwd = layers + dense + moe + shared
    out = {"tp_forward": (steps * fwd, steps * fwd * act),
           "tp_backward": (steps * (bwd + 1),
                           steps * (bwd * act + B * (SEQ - 1)
                                    * cfg.d_model * 4)),
           "tp_gates": (steps * moe, steps * moe * B * SEQ
                        * cfg.moe.top_k * 4),
           "tp_vocab": (steps * 2, steps * 3 * B * (SEQ - 1) * 4)}
    if cfg.mla is not None:
        m = cfg.mla
        q = B * SEQ * m.q_lora_rank * 4
        out["tp_latent_gather"] = (steps * layers, steps * layers * q // tp)
        out["tp_latent_reduce"] = (steps * layers, steps * layers * q)
        rep = (m.q_lora_rank + m.kv_lora_rank + cfg.d_model
               * (m.kv_lora_rank + m.qk_rope_head_dim)) * 4
        out["tp_replicated"] = (steps * 3 * layers, steps * layers * rep)
    elif cfg.num_kv_heads % tp:
        hd = cfg.resolved_head_dim()
        piece = 2 * cfg.d_model * cfg.num_kv_heads * (hd // tp) * 4
        out["tp_kv_gather"] = (steps * layers, steps * layers * piece)
        out["tp_kv_reduce"] = (steps * layers, steps * layers * piece * tp)
    assert prefix == (1 if cfg.mla is not None else 0)
    return out


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][5]])
def test_tp_collectives_by_site(world, case):
    """The TP sites' calls and bytes to the byte; no ``fsdp_gather``."""
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


@pytest.mark.parametrize("tp,experts", [(2, -3), (4, -3), (16, None)])
def test_tp_dims_of_mixtral(tp, experts):
    """Mixtral's 8 experts cut by expert at TP 2 and 4; at the plan's 16
    they do not divide, so each expert's d_ff (16384) is cut instead
    (``MOE_DFF_FALLBACK``); the router stays whole."""
    ffn = _meta_dims("mixtral-8x22b", tp)["stack"][0]["ffn"]
    if experts is None:
        assert (ffn["w_gate"], ffn["w_up"], ffn["w_down"]) == (-1, -1, -2)
    else:
        assert (ffn["w_gate"], ffn["w_up"], ffn["w_down"]) == (-3,) * 3
    assert ffn["router"] is None
    assert shd.MOE_DFF_FALLBACK == ("w_gate", "w_up", "w_down")


@pytest.mark.parametrize("tp", [2, 4, 16])
def test_tp_dims_of_deepseek(tp):
    """DeepSeek-V2's 160 experts, 128 heads and q latent of 1536 divide 2,
    4 and 16: experts, heads and q_rank cut; ``w_dkv``, the router and the
    norms whole; the shared experts and the dense prefix's MLP over d_ff."""
    dims = _meta_dims("deepseek-v2-236b", tp)
    layer = dims["stack"][0]
    mix, ffn = layer["mixer"], layer["ffn"]
    assert (ffn["w_gate"], ffn["w_up"], ffn["w_down"]) == (-3,) * 3
    assert (mix["w_dq"], mix["w_uq"], mix["w_ukv"], mix["w_o"]) == \
        (-1, -2, -2, -3)
    assert mix["w_dkv"] is None and ffn["router"] is None
    assert mix["q_norm"]["scale"] is None and mix["kv_norm"]["scale"] is None
    assert (ffn["shared"]["gate"], ffn["shared"]["down"]) == (-1, -2)
    pre = dims["prefix"][0]
    assert (pre["ffn"]["gate"], pre["ffn"]["down"]) == (-1, -2)
    assert pre["mixer"]["w_uq"] == -2


def test_the_state_owns_its_pieces():
    """``init_dfl_state`` copies: a rank's pieces cut along a leaf's first
    dim (the experts, ``w_o``'s heads, the embedding's rows) share no
    storage with the whole params, so the caller can free them (each rank
    of ``chip_smoke.py``'s ``shard_tp_moe`` builds its client whole first);
    and at one client the local period leaves the caller's params as they
    were."""
    params = ttf.params_from_numpy(np_params("mixtral-8x22b"))
    topo = FLTopology(**topo_kw(1, 1))
    mesh = mesh_of((1, 1, 1, 4), rank=1)
    backend = shd.fl_consensus_backend(topo, mesh, tree_map(
        lambda x: torch.empty((1,) + tuple(x.shape), device="meta"), params),
        tp_axis="model")
    state = tdfl.init_dfl_state(tdfl.DFLConfig(
        topology=topo, consensus_backend=backend), params, sgd(GAMMA))
    whole = {x.untyped_storage().data_ptr() for x in tree_leaves(params)}
    assert not whole & {x.untyped_storage().data_ptr()
                        for x in tree_leaves(state.client_params)}
    before = [x.clone() for x in tree_leaves(params)]
    cfg = tdfl.DFLConfig(topology=topo)
    step = tdfl.build_dfl_epoch_step(
        cfg, ttf.make_loss_fn(get_smoke("mixtral-8x22b")), sgd(GAMMA))
    step(tdfl.init_dfl_state(cfg, params, sgd(GAMMA)), {
        "tokens": torch.from_numpy(tokens_for("mixtral-8x22b", 1, 1))})
    for x, y in zip(tree_leaves(params), before):
        assert torch.equal(x, y)
