"""Tensor parallelism over "model" on the dense decoders: the rank-local
epoch step on ``RankMesh`` meshes whose model axis cuts a client's layers
(``launch.sharding.fl_consensus_backend(..., tp_axis="model")``,
``launch.tp``), one spawned world of 4 gloo ranks, held against the JAX
package's epoch step and the port's one-process step on the same inputs.

Each case builds the backend on its mesh, the state with
``dfl.init_dfl_state`` (the rank's TP pieces of the same seeded weights)
and runs one epoch of ``dfl.build_dfl_epoch_step`` with the loss of
``transformer.make_loss_fn`` on the same numpy tokens:

* ``heads``: qwen3-smoke on (2, 1, 1, 2), its 4 q / 2 kv heads cut 2 / 1 a
  rank;
* ``hd_fallback``: qwen3-smoke on (1, 1, 1, 4): 2 kv heads do not divide
  4, so ``w_k`` / ``w_v`` are cut along the head dim and gathered whole
  (``launch.sharding.KV_HD_FALLBACK``);
* ``gemma2``: gemma2-smoke on (2, 1, 1, 2): softcaps, the local window of
  32 (the sequence is 40), post-norms, the sqrt(d) embedding scale;
* ``clients``: command-r-smoke on (1, 2, 1, 2): clients x TP;
* ``fsdp``: qwen3-smoke on (1, 1, 2, 2): FSDP over "replica" x TP, leaves
  cut along two dims (``launch.fsdp.ClientShards`` gathers over "replica"
  only);
* ``wire``: qwen3-smoke on (2, 1, 1, 2), the int8 physical wire with error
  feedback.

For each plain case: the assembled state (``launch.sharding.assemble``,
replicated leaves from their first copies) against the reference's
``build_dfl_epoch_step`` at the port's LM tolerance (rtol/atol 1e-4): that
unsharded step is the function GSPMD computes; against the port's
one-process step within ``TP_TOL``: the row-parallel sums (``w_o``,
``down``, the embedding, the logsumexp) regroup f32 contractions, so the
two differ by f32 rounding carried through two SGD steps of gamma 0.05
and the gossip.  The wire case's local period (its pre-consensus rows) is
the ``heads`` case's, held to the one-process rows within ``TP_TOL``; its
consensus is held to its emulation.  In every case: replicated leaves
bitwise equal across each TP group (before the consensus; after it too on
the plain program — the wire's dither is drawn per rank, so a replicated
leaf's copies differ after it, as on an FSDP mesh), each rank's pieces
``local_shard`` of the assembled state, the consensus bitwise the
one-process backend on the (M * S)-row problem under A ⊗ I_S, and the
collectives by site: 2L + 1 forward (``tp_forward``) and 2L + 1 backward
(``tp_backward``) all-reduces a client step, their bytes to the byte.
Outside the world: the vocab-parallel cross-entropy emulated over k
slices in one process, the role on a dry mesh and the families that once
were refused by name (the MoE and MLA families, Mamba, the
encoder-decoder and the vision frontend now build:
tests/test_torch_tensor_parallel_moe.py, tests/test_torch_tensor_parallel_mamba.py,
tests/test_torch_tensor_parallel_encdec.py).
"""
import functools
import os
import subprocess
import sys
import textwrap
import threading

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
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import tp as ttp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

T_C, T_S, SEQ, B, GAMMA, SEED = 2, 3, 40, 2, 0.05, 0
TOL = dict(rtol=1e-4, atol=1e-4)
#: the port's one-process step against the TP step: the row-parallel sums
#: regroup f32 contractions (measured ~1e-7 of the weights after the epoch)
TP_TOL = dict(rtol=1e-5, atol=2e-6)
CODEC = "int8:64"
# case -> (arch, mesh shape (M, N, R, TP), clients a server, compression)
CASES = {
    "heads": ("qwen3-1.7b", (2, 1, 1, 2), 1, "none"),
    "hd_fallback": ("qwen3-1.7b", (1, 1, 1, 4), 1, "none"),
    "gemma2": ("gemma2-27b", (2, 1, 1, 2), 1, "none"),
    "clients": ("command-r-35b", (1, 2, 1, 2), 2, "none"),
    "fsdp": ("qwen3-1.7b", (1, 1, 2, 2), 1, "none"),
    "wire": ("qwen3-1.7b", (2, 1, 1, 2), 1, CODEC),
}
PLAIN = [c for c in CASES if CASES[c][3] == "none"]


def tokens_for(arch: str, m: int, n: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, m, n])
    return rng.integers(0, get_smoke(arch).vocab_size,
                        size=(T_C, m, n, B, SEQ)).astype(np.int64)


def topo_kw(m: int, n: int) -> dict:
    return dict(num_servers=m, clients_per_server=n, t_client=T_C,
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


    def run_case(rank, spec, arch, shape, n, compression):
        from repro_torch.comm import prng
        from repro_torch.configs import get_smoke
        from repro_torch.core import (DFLConfig, FLTopology,
                                      build_dfl_epoch_step, init_dfl_state)
        from repro_torch.core import consensus as cns
        from repro_torch.launch import mesh as lm
        from repro_torch.launch import sharding as shd
        from repro_torch.models import transformer as tf
        from repro_torch.optim import sgd
        from repro_torch.tree import tree_leaves, tree_map
        cfg = get_smoke(arch)
        mesh = lm.fl_rank_mesh(lm.FLMeshSpec(*shape))
        m = shape[0]
        topo = FLTopology(num_servers=m, clients_per_server=n,
                          t_client=spec["t_c"], t_server=spec["t_s"])
        params = tf.params_from_numpy(spec["params"][arch])
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
        rec = {}
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
        cns.reset_collective_counts()
        toks = torch.from_numpy(spec["tokens"][(arch, m, n)])
        state, mt = step(state, {"tokens": toks})
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
    d = tmp_path_factory.mktemp("tensor_parallel_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    toks = {(a, s[0], n): tokens_for(a, s[0], n)
            for a, s, n, _ in CASES.values()}
    spec = dict(t_c=T_C, t_s=T_S, gamma=GAMMA, seed=SEED, tokens=toks,
                params={a: np_params(a) for a, _, _, _ in CASES.values()},
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
        for case in CASES:
            arch, shape, n, _ = CASES[case]
            reference(arch, shape[0], n)
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
    arch, shape, n, _ = CASES[case]
    abs_tree = tree_map(lambda x: torch.empty((shape[0], n) + tuple(x.shape),
                                              device="meta"),
                        port_params(arch))
    return tree_leaves(shd.fl_param_specs(abs_tree, mesh_of(shape),
                                          tp_axis="model"))


def assembled(world, case: str, key: str = "clients") -> list:
    """The federation's leaves from every rank's pieces."""
    mesh = mesh_of(CASES[case][1])
    return [shd.assemble([w[case][key][i] for w in world], sp, mesh)
            for i, sp in enumerate(client_specs(case))]


@functools.lru_cache(maxsize=None)
def one_process(arch: str, m: int, n: int):
    """The port's one-process epoch of a federation: (state leaves,
    metrics, the backend's pre-consensus rows)."""
    topo = FLTopology(**topo_kw(m, n))
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
    state, mt = step(state, {"tokens": torch.from_numpy(
        tokens_for(arch, m, n))})
    return [x.clone() for x in tree_leaves(state.client_params)], mt, rec


def one(case: str):
    arch, shape, n, _ = CASES[case]
    return one_process(arch, shape[0], n)


@functools.lru_cache(maxsize=None)
def reference(arch: str, m: int, n: int):
    """The JAX package's static epoch on the same weights and tokens."""
    jcfg = j_get_smoke(arch)
    cfg = jdfl.DFLConfig(topology=JTopology(**topo_kw(m, n)))
    opt = j_sgd(GAMMA)
    step = jax.jit(jdfl.build_dfl_epoch_step(
        cfg, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)), opt))
    jparams = jax.tree.map(jnp.asarray, np_params(arch))
    state = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))
    state, mt = step(state, {"tokens": jnp.asarray(tokens_for(arch, m, n))})
    return ([np.asarray(x) for x in jax.tree.leaves(state.client_params)],
            mt)


def floor(leaves) -> float:
    """8 sqrt(eps_f32 sum |w|^2): the f32 rounding floor of the
    diagnostics' sum-of-squares formula (``tests/test_torch_train.py``)."""
    eps = float(np.finfo(np.float32).eps)
    return 8.0 * np.sqrt(eps * sum(float((x.double() ** 2).sum())
                                   for x in leaves))


@pytest.mark.parametrize("case", PLAIN)
def test_tp_epoch_matches_the_reference(world, case):
    arch, shape, n, _ = CASES[case]
    got = assembled(world, case)
    want, jm = reference(arch, shape[0], n)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for w in world:
        np.testing.assert_allclose(w[case]["metrics"]["loss"].numpy(),
                                   np.asarray(jm.loss), **TOL)


@pytest.mark.parametrize("case", PLAIN)
def test_tp_epoch_matches_the_one_process_port(world, case):
    """Within TP_TOL: the row-parallel sums regroup f32 contractions.  The
    losses (one value a TP group: every TP rank computes the same), the
    grad norm over each piece once, the diagnostics."""
    got = assembled(world, case)
    want, mt, _ = one(case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TP_TOL)
    for w in world:
        mw = w[case]["metrics"]
        np.testing.assert_allclose(mw["loss"].numpy(), mt.loss.numpy(),
                                   **TP_TOL)
        np.testing.assert_allclose(float(mw["grad_norm"]),
                                   float(mt.grad_norm), rtol=1e-5)
        for k in ("client_drift", "server_disagreement"):
            np.testing.assert_allclose(float(mw[k]), float(getattr(mt, k)),
                                       rtol=0,
                                       atol=floor([x[:, 0] for x in want]))


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
    """A leaf not cut over "model" (the norms) is the same on every rank
    of a TP group: its gradient is the whole one everywhere (the norms
    before a column-parallel block see ``copy``'s summed gradient;
    ``q_norm`` / ``k_norm`` their partial ones summed).  Before the
    consensus always; after it on the plain program."""
    shape = CASES[case][1]
    # M = 1 runs no consensus period (nothing handed to it)
    keys = (["pre"] if shape[0] > 1 else []) + (
        ["clients"] if CASES[case][3] == "none" else [])
    server = [shd.PartitionSpec(sp[0], *sp.dims[2:])
              for sp in client_specs(case)]
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


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_pieces(world, case):
    """Each rank's pieces are ``local_shard`` of the assembled state (after
    the int8 wire, the leaves cut over "model"; a replicated leaf's copies
    then differ by their dither)."""
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
    """The plain program on the pieces the local period produced: bitwise
    the one-process gossip on the (M * S)-row problem under A ⊗ I_S."""
    _, shape, n, _ = CASES[case]
    m, s = shape[0], 4 // shape[0]
    a = FLTopology(**topo_kw(m, n)).mixing_matrix().astype(np.float32)
    want = tcns.GossipBackend(np.kron(a, np.eye(s, dtype=np.float32)),
                              T_S).mix(server_rows(world, case, "pre"))
    for g, w in zip(server_rows(world, case, "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("case", ["heads", "wire"])
def test_the_local_period_before_consensus_matches_one_process(world, case):
    """The Eq.-4 rows each rank hands the consensus period, assembled,
    against the one-process step's server rows within TP_TOL; the wire
    case's local period is the heads case's, bitwise."""
    _, _, rec = one(case)
    mesh = mesh_of(CASES[case][1])
    specs = [shd.PartitionSpec(sp[0], *sp.dims[2:])
             for sp in client_specs(case)]
    for i, (sp, w_row) in enumerate(zip(specs, rec["pre"])):
        got = shd.assemble([w[case]["pre"][i] for w in world], sp, mesh)
        np.testing.assert_allclose(got.numpy(), w_row.numpy(), **TP_TOL)
        for w in world:
            assert torch.equal(w[case]["pre"][i], w["heads"]["pre"][i])


def test_wire_consensus_is_the_kron_emulation(world):
    """The int8 physical wire with error feedback on (2, 1, 1, 2): the
    mixed pieces and the new residual bitwise the one-process
    ``CompressedBackend`` on the (M * S)-row problem under A ⊗ I_S with the
    same consensus key; the state carries them."""
    a = FLTopology(**topo_kw(2, 1)).mixing_matrix().astype(np.float32)
    keys = {tuple(np.asarray(w["wire"]["key"]).tolist()) for w in world}
    assert len(keys) == 1
    backend = tcns.CompressedBackend(
        tcns.GossipBackend(np.kron(a, np.eye(2, dtype=np.float32)), T_S),
        tcp.make_compressor(CODEC), error_feedback=True, wire="physical",
        wire_block=16_777_216)
    want, want_res = backend.mix_compressed(
        server_rows(world, "wire", "pre"),
        residual=server_rows(world, "wire", "res_in"),
        key=np.asarray(world[0]["wire"]["key"]))
    for g, w in zip(server_rows(world, "wire", "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(server_rows(world, "wire", "res_out"), want_res):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for w in world:
        for c, p in zip(w["wire"]["clients"], w["wire"]["post"]):
            np.testing.assert_array_equal(
                c.numpy(), p[:, None].expand_as(c).numpy())
        for e, p in zip(w["wire"]["ef"], w["wire"]["res_out"]):
            np.testing.assert_array_equal(e.numpy(), p.numpy())


def predicted_tp_sites(case: str) -> dict:
    """Calls and bytes by TP site on one rank for the case's epoch: per
    client step, 2L + 1 ``tp_forward`` all-reduces of a (b, s, d) f32
    activation (the embedding's and each layer's two row-parallel blocks;
    under FSDP each layer's two again in its recomputed forward) and
    2L + 1 ``tp_backward`` (each layer's two column-parallel blocks and the
    head's, on (b, s - 1, d)); ``tp_vocab`` two calls a loss chunk (the
    max, then the sums and target logits: 3 values a position);
    ``tp_replicated`` each layer's ``q_norm`` and ``k_norm`` gradient; under
    the head-dim fallback one ``tp_kv_gather`` of a layer's ``w_k`` and
    ``w_v`` pieces and one ``tp_kv_reduce`` of their whole gradients."""
    arch, shape, n, _ = CASES[case]
    cfg = get_smoke(arch)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim()
    tp, kvh = shape[3], cfg.num_kv_heads
    steps = T_C * (n // shape[1])
    b = B // shape[2]           # a rank's share of the batch under FSDP
    act = b * SEQ * d * 4
    fwd = 1 + 2 * L + (2 * L if shape[2] > 1 else 0)
    out = {"tp_forward": (steps * fwd, steps * (fwd * act)),
           "tp_backward": (steps * (2 * L + 1),
                           steps * (2 * L * act + b * (SEQ - 1) * d * 4)),
           "tp_vocab": (steps * 2, steps * 3 * b * (SEQ - 1) * 4)}
    if cfg.qk_norm:
        out["tp_replicated"] = (steps * 2 * L, steps * 2 * L * hd * 4)
    if kvh % tp:
        piece = 2 * d * kvh * (hd // tp) * 4
        # the gather sends the rank's pieces; under FSDP the recomputed
        # forward gathers again
        gathers = L * (2 if shape[2] > 1 else 1)
        out["tp_kv_gather"] = (steps * gathers, steps * gathers * piece)
        out["tp_kv_reduce"] = (steps * L, steps * L * piece * tp)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_tp_collectives_by_site(world, case):
    """The TP sites' calls and bytes to the byte; no ``fsdp_gather`` unless
    "replica" cuts the leaves (then its own counts, as without TP)."""
    arch, shape, n, _ = CASES[case]
    want = predicted_tp_sites(case)
    layers = get_smoke(arch).num_layers
    for w in world:
        c = w[case]["collectives"]
        got = {k: (v, c["site_bytes"][k]) for k, v in c["sites"].items()
               if k.startswith("tp_")}
        assert got == want
        if shape[2] > 1:
            steps = T_C * (n // shape[1])
            assert c["sites"]["fsdp_gather"] == steps * (1 + 2 * layers)
            assert c["sites"]["grad_reduce"] == steps * (1 + layers)
        else:
            assert "fsdp_gather" not in c["sites"]
            assert "grad_reduce" not in c["sites"]


# ---------------------------------------------------------------------------
# outside the world
# ---------------------------------------------------------------------------


class _ThreadGroup:
    """k threads standing for k model ranks: ``all_reduce_`` sums (or
    maxes) their tensors call by call, in place, as a group would."""

    def __init__(self, k: int):
        self.k = k
        self.barrier = threading.Barrier(k)
        self.slots: dict = {}

    def all_reduce_(self, x, group, op="sum", *, site=""):
        pos, calls = group
        key = (calls[0], op)
        calls[0] += 1
        self.slots.setdefault(key, [None] * self.k)[pos] = x.clone()
        self.barrier.wait()
        parts = torch.stack(self.slots[key])
        x.copy_(parts.sum(0) if op == "sum" else parts.amax(0))
        self.barrier.wait()
        return x


def test_vocab_parallel_cross_entropy_emulated(monkeypatch):
    """``ModelParallel.cross_entropy`` over k vocab slices, each in a
    thread standing for a rank: the values are ``logsumexp - target
    logit`` of the whole logits, and each slice's gradient the whole
    gradient's slice, with no collective in the backward."""
    k, v = 4, 64
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((2, 5, v), generator=g) * 3
    targets = torch.randint(0, v, (2, 5), generator=g)
    weights = torch.rand((2, 5), generator=g)
    whole = logits.clone().requires_grad_(True)
    want = torch.logsumexp(whole, -1) - torch.gather(
        whole, -1, targets[..., None])[..., 0]
    (want_grad,) = torch.autograd.grad((want * weights).sum(), whole)
    tg = _ThreadGroup(k)
    monkeypatch.setattr(ttp.cns, "all_reduce_", tg.all_reduce_)
    got, grads, errors = [None] * k, [None] * k, []

    def rank(p):
        try:
            mp = ttp.ModelParallel((p, [0]), p, k)
            piece = logits[..., p * v // k:(p + 1) * v // k].clone() \
                .requires_grad_(True)
            out = mp.cross_entropy(piece, targets)
            got[p] = out.detach()
            (grads[p],) = torch.autograd.grad((out * weights).sum(), piece)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(p,)) for p in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # the max then the sums: two reductions
    assert sorted(tg.slots) == [(0, "max"), (1, "sum")]
    for p in range(k):
        np.testing.assert_allclose(got[p].numpy(), want.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            grads[p].numpy(),
            want_grad[..., p * v // k:(p + 1) * v // k].numpy(),
            rtol=1e-6, atol=1e-7)


def _backend(arch: str, shape, rank: int = 0, **kw):
    params = ttf.init_params(torch.Generator(), get_smoke(arch),
                             device="meta")
    topo = FLTopology(**topo_kw(shape[0], shape[1]))
    mesh = mesh_of(shape, rank=rank)
    backend = shd.fl_consensus_backend(topo, mesh, tree_map(
        lambda x: torch.empty((shape[0],) + tuple(x.shape), device="meta"),
        params), tp_axis="model", **kw)
    return topo, backend


def test_role_on_a_dry_mesh():
    """The role on every rank of a dry (1, 1, 2, 2) mesh: its model axis,
    gathers over "replica" only, the first copies; the TP dims of the
    leaves with the head-dim fallback at TP 4."""
    for r in range(4):
        topo, backend = _backend("qwen3-1.7b", (1, 1, 2, 2), r)
        role = tdfl.rank_role(tdfl.DFLConfig(topology=topo,
                                             consensus_backend=backend))
        c = backend.mesh.coords()
        assert (role.tp.pos, role.tp.size) == (c["model"], 2)
        assert role.gather_axes == ("replica",)
        assert tuple(role.batch_spec) == (None, "server", "client",
                                          "replica")
        assert role.first == (c["replica"] == 0 and c["model"] == 0)
        # each piece counted once: a replicated one on its first copy
        for sp, cnt in zip(role.specs, role.counted):
            assert cnt == all(c[a] == 0 for a in ("replica", "model")
                              if a not in sp.used_axes())
    params = ttf.init_params(torch.Generator(), get_smoke("qwen3-1.7b"),
                             device="meta")
    at2 = shd.tp_dims(params, 2)["stack"][0]["mixer"]
    at4 = shd.tp_dims(params, 4)["stack"][0]["mixer"]
    assert (at2["w_q"], at2["w_k"], at2["w_o"]) == (-2, -2, -3)
    # 2 kv heads on 4 model ranks: the head dim (KV_HD_FALLBACK)
    assert (at4["w_q"], at4["w_k"], at4["w_v"]) == (-2, -1, -1)
    assert at4["q_norm"]["scale"] is None
    assert shd.KV_HD_FALLBACK == ("w_k", "w_v")
    assert shd.tp_dims(params, 4)["embed"] == -2


#: the families the rank-local step runs under TP beside the dense
#: decoders (tests/test_torch_tensor_parallel_moe.py,
#: tests/test_torch_tensor_parallel_mamba.py and
#: tests/test_torch_tensor_parallel_encdec.py train them): every family
TP_PORTED = ("MoE", "Mamba", "encoder-decoder", "vision frontend")


@pytest.mark.parametrize("arch,family", [
    ("mixtral-8x22b", "MoE"), ("deepseek-v2-236b", "MoE"),
    ("mamba2-780m", "Mamba"), ("seamless-m4t-large-v2", "encoder-decoder"),
    ("internvl2-1b", "vision frontend"),
    ("jamba-1.5-large-398b", "Mamba")])
def test_families_left_under_tp_are_refused_by_name(arch, family):
    """Every family once refused by name now builds on the same (1, 1, 2,
    2) mesh: Mixtral, DeepSeek-V2, Mamba2 and Jamba (mamba, attention and
    MoE layers), the encoder-decoder and the vision frontend; neither
    resolver names a family any more (what is still refused, a leaf cut
    beside a whole one and a Mamba head count the axis does not divide,
    is held by name in tests/test_torch_tensor_parallel_encdec.py and
    tests/test_torch_tensor_parallel_mamba.py)."""
    assert family in TP_PORTED
    topo, backend = _backend(arch, (1, 1, 2, 2))
    step = tdfl.build_dfl_epoch_step(
        tdfl.DFLConfig(topology=topo, consensus_backend=backend),
        ttf.make_loss_fn(get_smoke(arch)), sgd(GAMMA))
    assert callable(step)
    assert tdfl.rank_role(tdfl.DFLConfig(
        topology=topo, consensus_backend=backend)).tp.size == 2
    assert shd.tp_refusal(backend.leaf_specs) is None
    assert ttf.tp_refusal(get_smoke(arch), 2) is None


def test_tp_refuses_a_batch_over_model_and_a_dynamic_config():
    topo, backend = _backend("qwen3-1.7b", (2, 1, 1, 2),
                             batch_over_model=True)
    with pytest.raises(ValueError, match="batch split over 'model' too"):
        tdfl.rank_role(tdfl.DFLConfig(topology=topo,
                                      consensus_backend=backend))
    topo, backend = _backend("qwen3-1.7b", (2, 1, 1, 2))
    for kw in (dict(dynamic=True), dict(mixing="push_sum")):
        with pytest.raises(ValueError, match="dynamic, push-sum or robust"):
            tdfl.build_dfl_epoch_step(
                tdfl.DFLConfig(topology=topo, consensus_backend=backend,
                               **kw),
                ttf.make_loss_fn(get_smoke("qwen3-1.7b")), sgd(GAMMA))
