"""The local period of a client cut over ranks: the rank-local epoch step
on ``RankMesh`` meshes whose client, replica or model axis exceeds 1, one
spawned world of 4 gloo ranks, held against the JAX package's epoch step
and the port's one-process step on the same inputs.

Each case builds the backend with ``launch.sharding.fl_consensus_backend``
(``tp_axis=None``), the state with ``dfl.init_dfl_state`` (the rank's
pieces of the same seeded weights) and runs one epoch of
``dfl.build_dfl_epoch_step`` on the SmolLM smoke config (2 layers, d 120)
with the loss of ``transformer.make_loss_fn`` on the same numpy tokens:

* (2, 2, 1, 1): a server's two clients on two ranks; Eq. 4's sum crosses
  the client group.  Every rank's state is **bitwise** the one-process
  step's (one client a rank: the two-term sum is a + b either way).
* (2, 1, 2, 1): FSDP over "replica" (``launch.fsdp.ClientShards``), two
  clients a rank, the batch split over "replica"; also with two
  microbatches of each rank's share.
* (2, 1, 1, 2): ``batch_over_model``: the weights whole on every rank, the
  batch split over "model", the gradients averaged after the backward.
* (1, 2, 2, 1): client and replica axes together, M = 1 (no consensus).

For each: the assembled state (``launch.sharding.assemble``, replicated
leaves from their first copies) against the reference's
``build_dfl_epoch_step`` at the port's LM tolerance (rtol/atol 1e-4, as
``tests/test_torch_train.py``); against the port's one-process step,
bitwise on (2, 2, 1, 1) and within ``SPLIT_TOL`` where the batch splits:
a client's gradient is then the mean of its shares' mean gradients,
the same function regrouped, so the two differ by f32 rounding of the
gradient (~1e-7 of it) carried through two SGD steps of gamma 0.05 and the
mean; each rank's pieces equal to ``local_shard`` of the assembled state.
The consensus period on a sharded row is bitwise the one-process backend
on the (M * S)-row problem of every rank's pre-consensus pieces under
A ⊗ I_S (rank r's pieces are row r), as ``test_torch_shard_map_axes.py``
holds it; on (2, 1, 2, 1) also for the int8 physical wire with error
feedback.  The metrics against the one-process step's.  Outside the world:
the refusals of tensor parallelism over "model" of a family whose TP is
not ported (tests/test_torch_tensor_parallel.py runs the dense decoders'
TP, tests/test_torch_tensor_parallel_moe.py the MoE and MLA families',
tests/test_torch_tensor_parallel_mamba.py Mamba's and Jamba's) and
of a dynamic config on a sharded row, and the launch layer's
helpers."""
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
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "smollm-360m"
N, T_C, T_S, SEQ, GAMMA, SEED = 2, 2, 3, 16, 0.05, 0
TOL = dict(rtol=1e-4, atol=1e-4)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)
CODEC = "int8:64"
# case -> (mesh shape, batch_over_model, per-client batch, microbatches,
# compression)
CASES = {
    "clients": ((2, 2, 1, 1), False, 2, 1, "none"),
    "fsdp": ((2, 1, 2, 1), False, 2, 1, "none"),
    "fsdp_micro": ((2, 1, 2, 1), False, 4, 2, "none"),
    "batch_over_model": ((2, 1, 1, 2), True, 2, 1, "none"),
    "client_replica": ((1, 2, 2, 1), False, 2, 1, "none"),
    "wire": ((2, 1, 2, 1), False, 2, 1, CODEC),
}


def tokens_for(m: int, b: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, m, b])
    return rng.integers(0, get_smoke(ARCH).vocab_size,
                        size=(T_C, m, N, b, SEQ)).astype(np.int64)


def topo_kw(m: int) -> dict:
    return dict(num_servers=m, clients_per_server=N, t_client=T_C,
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
            res["tp_refused"] = tp_refusal(rank, spec)
            assert not [n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")]
            torch.save(res, out + f".{rank}")
        finally:
            dist.destroy_process_group()


    def run_case(rank, spec, shape, bom, b, micro, compression):
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
        cfg = get_smoke(spec["arch"])
        mesh = lm.fl_rank_mesh(lm.FLMeshSpec(shape[0], shape[1], shape[2],
                                             shape[3]))
        m = shape[0]
        topo = FLTopology(num_servers=m, clients_per_server=spec["n"],
                          t_client=spec["t_c"], t_server=spec["t_s"])
        params = tf.params_from_numpy(spec["params"])
        server_abs = tree_map(lambda x: torch.empty(
            (m,) + tuple(x.shape), device="meta"), params)
        wire = compression != "none"
        backend = shd.fl_consensus_backend(
            topo, mesh, server_abs, tp_axis=None, batch_over_model=bom,
            compression=compression, error_feedback=wire,
            wire="physical" if wire else "simulated")
        dcfg = DFLConfig(topology=topo, consensus_backend=backend,
                         grad_microbatches=micro)
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
        toks = torch.from_numpy(spec["tokens"][(m, b)])
        state, mt = step(state, {"tokens": toks})
        role = dict(coords=mesh.coords(), rows=backend.inner.rows
                    if wire else backend.rows)
        return dict(
            rec, role=role,
            clients=[x.clone() for x in tree_leaves(state.client_params)],
            ef=(None if state.ef_residual is None else
                [x.clone() for x in tree_leaves(state.ef_residual)]),
            metrics={k: getattr(mt, k).clone() for k in
                     ("loss", "server_disagreement", "client_drift",
                      "grad_norm")},
            collectives=cns.collective_counts())


    def tp_refusal(rank, spec):
        """On a (1, 1, 2, 2) mesh with tp_axis="model": the step refuses
        a client whose attention leaves the axis leaves whole beside its
        cut MLP and vocab (seamless-smoke at 3 heads), by name."""
        import dataclasses
        from repro_torch.configs import get_smoke
        from repro_torch.core import (DFLConfig, FLTopology,
                                      build_dfl_epoch_step)
        from repro_torch.launch import mesh as lm
        from repro_torch.launch import sharding as shd
        from repro_torch.models import transformer as tf
        from repro_torch.tree import tree_map
        mesh = lm.fl_rank_mesh(lm.FLMeshSpec(1, 1, 2, 2))
        cfg = dataclasses.replace(get_smoke("seamless-m4t-large-v2"),
                                  num_heads=3, num_kv_heads=3)
        params = tf.init_params(torch.Generator(), cfg, device="meta")
        topo = FLTopology(num_servers=1, clients_per_server=1, t_client=1,
                          t_server=1)
        backend = shd.fl_consensus_backend(topo, mesh, tree_map(
            lambda x: torch.empty((1,) + tuple(x.shape), device="meta"),
            params), tp_axis="model")
        try:
            build_dfl_epoch_step(DFLConfig(topology=topo,
                                           consensus_backend=backend),
                                 tf.make_loss_fn(cfg), None)
        except ValueError as e:
            return str(e)
        return None


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
def np_params() -> dict:
    """The seeded weights both packages start from (numpy leaves)."""
    jparams = jtf.init_params(jax.random.key(7), j_get_smoke(ARCH))
    return jax.tree.map(np.asarray, jparams)


def port_params() -> dict:
    return ttf.params_from_numpy(np_params())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks; each rank's own
    results, by rank."""
    d = tmp_path_factory.mktemp("sharded_local_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    toks = {(c[0][0], c[2]): tokens_for(c[0][0], c[2])
            for c in CASES.values()}
    spec = dict(arch=ARCH, n=N, t_c=T_C, t_s=T_S, gamma=GAMMA, seed=SEED,
                params=np_params(), tokens=toks, cases=CASES)
    torch.save(spec, spec_path)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(out),
                        str(d / "rdv"), str(spec_path)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(4)]


def mesh_of(shape, rank=0):
    return tmesh.fl_rank_mesh(tmesh.FLMeshSpec(*shape), rank=rank, dry=True)


def client_specs(shape) -> list:
    """Each client leaf's ``(M, N, *w)`` spec on the mesh of ``shape``."""
    m = shape[0]
    abs_tree = tree_map(lambda x: torch.empty((m, N) + tuple(x.shape),
                                              device="meta"), port_params())
    return tree_leaves(shd.fl_param_specs(abs_tree, mesh_of(shape),
                                          tp_axis=None))


def assembled(world, case: str, key: str = "clients") -> list:
    """The federation's leaves from every rank's pieces."""
    shape = CASES[case][0]
    mesh = mesh_of(shape)
    return [shd.assemble([w[case][key][i] for w in world], sp, mesh)
            for i, sp in enumerate(client_specs(shape))]


def one_process(case: str, *, backend=None):
    """The port's one-process epoch of a case's federation: (state leaves,
    metrics, the backend's pre- and post-consensus rows)."""
    shape, _, b, micro, _ = CASES[case]
    m = shape[0]
    topo = FLTopology(**topo_kw(m))
    rec = {}
    inner = tcns.GossipBackend(topo.mixing_matrix() if m > 1
                               else np.ones((1, 1)), T_S)
    mix = inner.mix

    def spy(tree, *a, **kw):
        rec["pre"] = [x.clone() for x in tree_leaves(tree)]
        out = mix(tree, *a, **kw)
        rec["post"] = [x.clone() for x in tree_leaves(out)]
        return out

    inner.mix = spy
    cfg = tdfl.DFLConfig(topology=topo, consensus_backend=inner,
                         grad_microbatches=micro)
    opt = sgd(GAMMA)
    step = tdfl.build_dfl_epoch_step(cfg, ttf.make_loss_fn(get_smoke(ARCH)),
                                     opt)
    state = tdfl.init_dfl_state(cfg, port_params(), opt)
    state, mt = step(state, {"tokens": torch.from_numpy(tokens_for(m, b))})
    return [x.clone() for x in tree_leaves(state.client_params)], mt, rec


_ONE: dict = {}


def one(case: str):
    key = (CASES[case][0][0], CASES[case][2], CASES[case][3])
    if key not in _ONE:
        _ONE[key] = one_process(case)
    return _ONE[key]


_REF: dict = {}


def reference(case: str):
    """The JAX package's static epoch on the same weights and tokens."""
    shape, _, b, micro, _ = CASES[case]
    m = shape[0]
    key = (m, b, micro)
    if key not in _REF:
        jcfg = j_get_smoke(ARCH)
        cfg = jdfl.DFLConfig(topology=JTopology(**topo_kw(m)),
                             grad_microbatches=micro)
        opt = j_sgd(GAMMA)
        step = jax.jit(jdfl.build_dfl_epoch_step(
            cfg, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)), opt))
        jparams = jax.tree.map(jnp.asarray, np_params())
        state = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))
        state, mt = step(state, {"tokens": jnp.asarray(tokens_for(m, b))})
        _REF[key] = ([np.asarray(x) for x in
                      jax.tree.leaves(state.client_params)], mt)
    return _REF[key]


PLAIN = [c for c in CASES if CASES[c][4] == "none"]


def floor(leaves) -> float:
    """8 sqrt(eps_f32 sum |w|^2): the f32 rounding floor of the
    diagnostics' sum-of-squares formula (``tests/test_torch_train.py``)."""
    eps = float(np.finfo(np.float32).eps)
    return 8.0 * np.sqrt(eps * sum(float((x.double() ** 2).sum())
                                   for x in leaves))


@pytest.mark.parametrize("case", PLAIN)
def test_sharded_epoch_matches_the_reference(world, case):
    got = assembled(world, case)
    want, jm = reference(case)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for w in world:
        np.testing.assert_allclose(w[case]["metrics"]["loss"].numpy(),
                                   np.asarray(jm.loss), **TOL)


@pytest.mark.parametrize("case", PLAIN)
def test_sharded_epoch_matches_the_one_process_port(world, case):
    """Bitwise where no batch splits ((2, 2, 1, 1)); within SPLIT_TOL
    where one does."""
    got = assembled(world, case)
    want, mt, _ = one(case)
    for g, w in zip(got, want):
        if case == "clients":
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), **SPLIT_TOL)
    for w in world:
        mw = w[case]["metrics"]
        if case == "clients":
            np.testing.assert_array_equal(mw["loss"].numpy(),
                                          mt.loss.numpy())
        else:
            np.testing.assert_allclose(mw["loss"].numpy(), mt.loss.numpy(),
                                       **SPLIT_TOL)
        np.testing.assert_allclose(float(mw["grad_norm"]),
                                   float(mt.grad_norm), **TOL)
        # the Lemma-1 / Lemma-3 diagnostics: differences of near-equal
        # f32 sums of squares, summed in another order over the ranks
        for k in ("client_drift", "server_disagreement"):
            np.testing.assert_allclose(float(mw[k]), float(getattr(mt, k)),
                                       rtol=0,
                                       atol=floor([x[:, 0] for x in want]))


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_pieces(world, case):
    """Each rank's pieces are ``local_shard`` of the assembled state: the
    copies of a replicated leaf agree (their averaged gradients are the
    same sums on every rank); after the int8 wire a replicated leaf's
    copies differ (each rank draws its own dither), so there the cut
    leaves only."""
    shape = CASES[case][0]
    full = assembled(world, case)
    specs = client_specs(shape)
    for r, w in enumerate(world):
        mesh = mesh_of(shape, r)
        for x, sp, piece in zip(full, specs, w[case]["clients"]):
            if case == "wire" and not set(sp.used_axes()) - {"server",
                                                             "client"}:
                continue
            np.testing.assert_array_equal(
                piece.numpy(), shd.local_shard(x, sp, mesh).numpy())


def server_rows(world, case: str, key: str) -> list:
    """The (M * S)-row problem of a consensus period: row r = rank r's
    pieces (a rank's index is ``server * S + sub``)."""
    return [torch.cat([w[case][key][i] for w in world])
            for i in range(len(world[0][case][key]))]


@pytest.mark.parametrize("case", [c for c in PLAIN
                                  if CASES[c][0][0] > 1])
def test_sharded_consensus_is_the_kron_emulation(world, case):
    """The plain program on the pieces the local period produced: bitwise
    the one-process gossip on the (M * S)-row problem under A ⊗ I_S."""
    m = CASES[case][0][0]
    s = 4 // m
    a = FLTopology(**topo_kw(m)).mixing_matrix().astype(np.float32)
    emul = server_rows(world, case, "pre")
    want = tcns.GossipBackend(np.kron(a, np.eye(s, dtype=np.float32)),
                              T_S).mix(emul)
    got = server_rows(world, case, "post")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_the_local_period_before_consensus_matches_one_process(world):
    """The Eq.-4 rows each rank hands the consensus period: on
    (2, 2, 1, 1) bitwise the one-process step's server rows, on
    (2, 1, 2, 1) (the int8 wire's mesh and local period) within
    SPLIT_TOL."""
    for case in ("clients", "fsdp", "wire"):
        shape = CASES[case][0]
        _, _, rec = one(case)
        mesh = mesh_of(shape)
        specs = [shd.PartitionSpec(sp[0], *sp.dims[2:])
                 for sp in client_specs(shape)]
        for i, (sp, w_row) in enumerate(zip(specs, rec["pre"])):
            got = shd.assemble([w[case]["pre"][i] for w in world], sp, mesh)
            if case == "clients":
                np.testing.assert_array_equal(got.numpy(), w_row.numpy())
            else:
                np.testing.assert_allclose(got.numpy(), w_row.numpy(),
                                           **SPLIT_TOL)


def test_wire_consensus_is_the_kron_emulation(world):
    """The int8 physical wire with error feedback on (2, 1, 2, 1): the
    mixed pieces and the new residual bitwise the one-process
    ``CompressedBackend`` on the (M * S)-row problem of the rows the local
    period produced, under A ⊗ I_S with the same consensus key."""
    a = FLTopology(**topo_kw(2)).mixing_matrix().astype(np.float32)
    emul = server_rows(world, "wire", "pre")
    res = server_rows(world, "wire", "res_in")
    keys = {tuple(np.asarray(w["wire"]["key"]).tolist()) for w in world}
    assert len(keys) == 1
    backend = tcns.CompressedBackend(
        tcns.GossipBackend(np.kron(a, np.eye(2, dtype=np.float32)), T_S),
        tcp.make_compressor(CODEC), error_feedback=True, wire="physical",
        wire_block=16_777_216)
    want, want_res = backend.mix_compressed(
        emul, residual=res, key=np.asarray(world[0]["wire"]["key"]))
    for g, w in zip(server_rows(world, "wire", "post"), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(server_rows(world, "wire", "res_out"), want_res):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the state: the mixed pieces broadcast to the rank's clients, the
    # residual carried
    for w in world:
        for c, p in zip(w["wire"]["clients"], w["wire"]["post"]):
            np.testing.assert_array_equal(
                c.numpy(), p[:, None].expand_as(c).numpy())
        for e, p in zip(w["wire"]["ef"], w["wire"]["res_out"]):
            np.testing.assert_array_equal(e.numpy(), p.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_intra_client_collectives_by_site(world, case):
    """The sites each mesh crosses: ``fsdp_gather`` (one all_gather a
    unit: forward, then again in the backward) and ``grad_reduce`` (one
    all_reduce a unit) where leaves are cut; ``grad_reduce`` a leaf a step
    where the batch splits over whole leaves; ``client_mean`` a leaf where
    a server's clients span ranks."""
    shape, bom, _, micro, _ = CASES[case]
    n_leaves = len(world[0][case]["clients"])
    layers = get_smoke(ARCH).num_layers
    # client gradients a rank takes: T_C steps of its clients' microbatches
    grads = T_C * micro * (N // shape[1])
    for w in world:
        sites = w[case]["collectives"]["sites"]
        if shape[2] > 1:
            # the top unit once, each layer forward and backward
            assert sites["fsdp_gather"] == grads * (1 + 2 * layers)
            assert sites["grad_reduce"] == grads * (1 + layers)
        elif bom:
            assert "fsdp_gather" not in sites
            assert sites["grad_reduce"] == grads // micro * n_leaves
        else:
            assert "fsdp_gather" not in sites and "grad_reduce" not in sites
        if shape[1] > 1:
            assert sites["client_mean"] == n_leaves
        else:
            assert "client_mean" not in sites


def test_tp_over_model_is_refused(world):
    for w in world:
        assert ("tensor parallelism over 'model' multiplies pieces of "
                "['w_o', 'w_q']") in w["tp_refused"]


# ---------------------------------------------------------------------------
# outside the world
# ---------------------------------------------------------------------------


def test_dynamic_config_on_a_sharded_row_is_refused():
    params = ttf.init_params(torch.Generator(), get_smoke(ARCH),
                             device="meta")
    topo = FLTopology(**topo_kw(2))
    mesh = mesh_of((2, 1, 2, 1), rank=1)
    backend = shd.fl_consensus_backend(topo, mesh, tree_map(
        lambda x: torch.empty((2,) + tuple(x.shape), device="meta"),
        params), tp_axis=None)
    for kw in (dict(dynamic=True), dict(mixing="push_sum")):
        with pytest.raises(ValueError, match="dynamic, push-sum or robust"):
            tdfl.build_dfl_epoch_step(
                tdfl.DFLConfig(topology=topo, consensus_backend=backend,
                               **kw), ttf.make_loss_fn(get_smoke(ARCH)),
                sgd(GAMMA))


def test_role_groups_and_batch_spec_on_a_dry_mesh():
    """The role on every rank of a dry (2, 2, 2, 1) mesh: its clients,
    groups' sizes and positions, the batch's spec and first copies."""
    params = ttf.init_params(torch.Generator(), get_smoke(ARCH),
                             device="meta")
    topo = FLTopology(num_servers=2, clients_per_server=4, t_client=1,
                      t_server=1)
    for r in range(8):
        mesh = mesh_of((2, 2, 2, 1), rank=r)
        backend = shd.fl_consensus_backend(topo, mesh, tree_map(
            lambda x: torch.empty((2,) + tuple(x.shape), device="meta"),
            params), tp_axis=None)
        role = tdfl.rank_role(tdfl.DFLConfig(topology=topo,
                                             consensus_backend=backend))
        c = mesh.coords()
        assert (role.lo, role.hi) == (c["server"], c["server"] + 1)
        assert (role.c_lo, role.c_hi) == (2 * c["client"],
                                         2 * c["client"] + 2)
        assert role.sharded and role.gather_axes == ("replica",)
        assert tuple(role.batch_spec) == (None, "server", "client",
                                          "replica")
        assert (role.client_group.size, role.client_group.rank) == (
            2, c["client"])
        assert role.batch_group.size == role.gather_group.size == 2
        # model is one rank wide: replica x model is the replica group
        assert role.shard_group is role.batch_group is role.gather_group
        assert role.first == (c["replica"] == 0)
        # the norm scales are replicated: counted on replica 0 only
        flags = dict(zip([str(x) for x in role.specs], role.counted))
        assert flags[str(shd.PartitionSpec(None))] == role.first
        assert mesh.ranks_over(("client", "replica")) == [
            4 * c["server"] + k for k in range(4)]


def test_gather_and_reduce_helpers_on_one_rank():
    """``gather_pieces`` / ``reduce_to_pieces`` without a group: the
    pieces as they are, and each gradient's piece at ``pos``."""
    x = torch.arange(24.0).reshape(4, 6)
    assert tcns.gather_pieces([x], [1], None)[0] is x
    got = tcns.reduce_to_pieces([x, x[0]], [1, None], None, 1, 2)
    np.testing.assert_array_equal(got[0].numpy(), x[:, 3:].numpy())
    np.testing.assert_array_equal(got[1].numpy(), x[0].numpy())
    assert shd.layer_spec(shd.PartitionSpec("server", "client", None,
                                            "replica"), 3) == ("replica",)
