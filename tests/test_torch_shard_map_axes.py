"""A server row sharded over ranks: ``make_gossip_shard_map`` and the
shard_map backends on a ``RankMesh`` (server=2, client=1, replica=2,
model=1), one world of 4 gloo ranks, held against the JAX package.

Rank (i, k) holds piece k of server i's row, cut by ``fl_server_specs``
(FSDP over "replica"; a leaf that does not split is replicated, one copy a
rank).  Piece k of server i mixes only with piece k of the other servers,
so the sharded programs equal the one-process programs on the
(M * S)-row problem whose row i * S + k is that piece, under the operator
A ⊗ I_S, with the wire's dither coordinate the row index:

* bitwise: the bucketed wire (int8, int4; A and Aᵀ; staleness 0 and 1;
  ``with_shipped``) against the reference's ``gossip_scan_wire_bucketed``
  on that problem, and ``CompressedBackend`` (physical wire, EF) against
  the port's one-process backend on it;
* the plain program bitwise against the port's one-process gossip on it
  (the operator's products are exact, so any summation order agrees) and
  within 2e-5 of the reference's ``gossip_scan``; push-sum's A' likewise;
* the ledger: each wire round one int8 and one f32 ``all_gather`` over the
  server subgroup (two ranks), of the rank's own bucket;
* the disagreement of the sharded row over the whole world against the
  assembled tree's (the first copy of a replicated leaf).

One module fixture spawns the world (``file://`` rendezvous, one intra-op
thread a rank, no JAX in the ranks); each rank saves its own results.
Outside the world: the refusals.  Slow tier: the reference's own shard_map
program on a forced (2, 2) host mesh, its host result against the port's
assembled one and each device's own copy against each rank's."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import compressors as jcp  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.comm.accounting import \
    tree_bucketed_wire_bytes_per_server  # noqa: E402
from repro_torch.core import (DFLConfig, FLTopology,  # noqa: E402
                              build_dfl_epoch_step, init_dfl_state)
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402

M, S = 2, 2                  # servers, pieces a server row
SHAPE = (M, 1, S, 1)
A = np.array([[0.5, 0.5], [1.0, 0.0]], np.float32)   # power-of-2 weights
T_WIRE, T_PLAIN, BLOCK = 4, 5, 1024
BITS = (8, 4)
OPS = ("A", "AT")
WIRE_MODES = ("physical", "with_shipped", "stale1")
PLAIN_TOL = dict(rtol=2e-5, atol=2e-5)
CODEC = "int8:16"


def server_tree(seed: int = 0) -> dict:
    """A server tree whose leaf names meet the resolver's rules: three
    split over "replica", two replicated."""
    shapes = {"embed": (12, 16), "w_q": (3, 16, 2, 4), "down": (6, 10),
              "scale": (40,), "head": (5, 7)}
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((M,) + s) * 2).astype(np.float32)
            for k, s in shapes.items()}


def mesh_for(rank=None, dry=False):
    return tmesh.fl_rank_mesh(tmesh.FLMeshSpec(*SHAPE), rank=rank, dry=dry)


def specs_of(tree: dict):
    abs_tree = {k: torch.empty(v.shape, device="meta")
                for k, v in tree.items()}
    return shd.fl_server_specs(abs_tree, mesh_for(rank=0), tp_axis=None)


def op_matrix(op: str) -> np.ndarray:
    return A if op == "A" else A.T.copy()


# the script the ranks run: torch and repro_torch only
WORLD = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    SHAPE = (2, 1, 2, 1)


    def main(rank, out, rdv, spec):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdv,
                                world_size=4, rank=rank)
        try:
            res = run_cases(rank, spec)
            assert not [n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")]
            torch.save(res, out + f".{rank}")
        finally:
            dist.destroy_process_group()


    def run_cases(rank, spec):
        from repro_torch.comm import compressors as cp
        from repro_torch.comm import prng
        from repro_torch.core import FLTopology
        from repro_torch.core import consensus as cns
        from repro_torch.launch import mesh as lm
        from repro_torch.launch import sharding as shd
        mesh = lm.fl_rank_mesh(lm.FLMeshSpec(*SHAPE))
        full = {k: torch.from_numpy(v) for k, v in spec["tree"].items()}
        specs = shd.fl_server_specs(full, mesh, tp_axis=None)

        def local():
            return {k: shd.local_shard(v, specs[k], mesh).contiguous()
                    for k, v in full.items()}

        res = {"coords": mesh.coords(),
               "server_group": dist.get_process_group_ranks(
                   mesh.group("server"))}
        ops = {"A": torch.from_numpy(spec["a"]),
               "AT": torch.from_numpy(spec["a"].T.copy())}
        for bits in (8, 4):
            codec = cp.StochasticQuantizer(bits=bits, chunk=16)
            for op, mat in ops.items():
                for mode in spec["wire_modes"]:
                    run = cns.make_gossip_shard_map(
                        mesh, spec["t_wire"], specs, block=spec["block"],
                        codec=codec, with_shipped=mode == "with_shipped",
                        staleness=1 if mode == "stale1" else 0)
                    cns.reset_collective_counts()
                    got = run(mat, local(), prng.key(3))
                    if mode == "with_shipped":
                        res[("wire", bits, op, mode)] = got[0]
                        res[("shipped", bits, op)] = got[1]
                    else:
                        res[("wire", bits, op, mode)] = got
                    if mode == "physical":
                        res[("ledger", bits, op)] = cns.collective_counts()
        for op, mat in ops.items():
            run = cns.make_gossip_shard_map(mesh, spec["t_plain"], specs,
                                            block=16)
            res[("plain", op)] = run(mat, local())
        # the backends on the mesh: the physical wire with EF, push-sum
        topo = FLTopology(num_servers=2, clients_per_server=1, t_client=1,
                          t_server=spec["t_wire"])
        backend = shd.fl_consensus_backend(
            topo, mesh, full, tp_axis=None, compression=spec["codec"],
            error_feedback=True, wire="physical")
        residual = {k: torch.zeros_like(v) for k, v in local().items()}
        mixed, residual = backend.mix_compressed(local(), residual=residual,
                                                 key=prng.key(5))
        res["compressed"] = (mixed, residual)
        res["disagreement"] = float(backend.inner.disagreement(mixed))
        res["counted"] = backend.inner.counted
        plain = shd.fl_consensus_backend(topo, mesh, full, tp_axis=None)
        ps = plain.mix_push_sum(cns.PushSumState(
            local(), torch.ones(2, dtype=torch.float32)),
            torch.from_numpy(spec["a"]))
        res["push_sum"] = (ps.values, ps.weight)
        res["rows"] = backend.inner.rows
        return res


    if __name__ == "__main__":
        spec = torch.load(sys.argv[3], weights_only=False)
        mp.spawn(main, args=(sys.argv[1], sys.argv[2], spec), nprocs=4)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks; each rank's own
    results, by rank."""
    d = tmp_path_factory.mktemp("axes_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    spec = dict(a=A, tree=server_tree(), t_wire=T_WIRE, t_plain=T_PLAIN,
                block=BLOCK, wire_modes=WIRE_MODES, codec=CODEC)
    torch.save(spec, spec_path)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(out),
                        str(d / "rdv"), str(spec_path)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(4)]


def emulated(tree: dict) -> dict:
    """The (M * S)-row problem: row r = rank r's pieces (r = i * S + k)."""
    specs, mesh = specs_of(tree), mesh_for(rank=0)
    return {k: np.stack([shd.local_shard(torch.from_numpy(v), specs[k],
                                         mesh, r)[0].numpy()
                         for r in range(M * S)])
            for k, v in tree.items()}


def kron(a: np.ndarray) -> np.ndarray:
    return np.kron(a, np.eye(S, dtype=np.float32))


def rows_of(world, key) -> dict:
    """The ranks' results of one case stacked as the emulated rows."""
    got = [w[key] for w in world]
    return {k: np.concatenate([g[k].numpy() for g in got]) for k in got[0]}


def _stack(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(M * S, -1)
                           for _, v in sorted(tree.items())], axis=1)


def test_mesh_layout_and_server_subgroups(world):
    """Rank r sits at (r // 2, 0, r % 2, 0); each server subgroup holds the
    two ranks with the same replica coordinate; a rank holds server rows
    [i, i + 1)."""
    for r, w in enumerate(world):
        assert w["coords"] == {"server": r // 2, "client": 0,
                               "replica": r % 2, "model": 0}
        assert w["server_group"] == [r % 2, 2 + r % 2]
        assert tuple(w["rows"]) == (r // 2, r // 2 + 1)


def test_resolver_shards_over_replica_and_replicates_the_rest():
    specs = specs_of(server_tree())
    assert tuple(specs["embed"]) == ("server", None, "replica")
    assert tuple(specs["w_q"]) == ("server", None, "replica", None, None)
    assert tuple(specs["down"]) == ("server", None, "replica")
    assert tuple(specs["scale"]) == ("server", None)
    assert tuple(specs["head"]) == ("server", None, None)   # 5 is odd


@pytest.mark.parametrize("mode", WIRE_MODES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits", BITS)
def test_sharded_wire_is_the_reference_on_the_kron_problem(world, bits, op,
                                                           mode):
    """Each rank's pieces are row i * S + k of the reference's bucketed wire
    on the (M * S)-row problem under A ⊗ I_S, bit for bit (and of the
    port's one-process period)."""
    staleness = 1 if mode == "stale1" else 0
    emul = emulated(server_tree())
    a = kron(op_matrix(op))
    codec = jcp.StochasticQuantizer(bits=bits, chunk=16)
    want = jax.jit(lambda t: jcns.gossip_scan_wire_bucketed(
        jnp.asarray(a), t, T_WIRE, codec, jax.random.key(3), block=BLOCK,
        staleness=staleness))({k: jnp.asarray(v) for k, v in emul.items()})
    got = rows_of(world, ("wire", bits, op, mode))
    np.testing.assert_array_equal(
        _stack(got), _stack({k: np.asarray(v) for k, v in want.items()}))
    one = tcns.gossip_scan_wire_bucketed(
        torch.from_numpy(a), {k: torch.from_numpy(v) for k, v in
                              emul.items()}, T_WIRE,
        tcp.StochasticQuantizer(bits=bits, chunk=16), prng.key(3),
        block=BLOCK, staleness=staleness)
    np.testing.assert_array_equal(
        _stack(got), _stack({k: v.numpy() for k, v in one.items()}))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits", BITS)
def test_sharded_with_shipped_is_the_round_zero_roundtrip(world, bits, op):
    codec = jcp.StochasticQuantizer(bits=bits, chunk=16)
    want = jax.jit(lambda t: jcns.bucketed_roundtrip_tree(
        codec, t, jax.random.key(3), block=BLOCK))(
        {k: jnp.asarray(v) for k, v in emulated(server_tree()).items()})
    np.testing.assert_array_equal(
        _stack(rows_of(world, ("shipped", bits, op))),
        _stack({k: np.asarray(v) for k, v in want.items()}))


@pytest.mark.parametrize("op", OPS)
def test_sharded_plain_program(world, op):
    """Bitwise the port's one-process gossip on the kron problem; within
    2e-5 of the reference's ``gossip_scan`` on it."""
    emul = emulated(server_tree())
    a = kron(op_matrix(op))
    got = _stack(rows_of(world, ("plain", op)))
    one = tcns.GossipBackend(a, T_PLAIN).mix(
        {k: torch.from_numpy(v) for k, v in emul.items()})
    np.testing.assert_array_equal(got, _stack({k: v.numpy()
                                               for k, v in one.items()}))
    want = jcns.gossip_scan(jnp.asarray(a), {k: jnp.asarray(v)
                                             for k, v in emul.items()},
                            T_PLAIN)
    np.testing.assert_allclose(got, _stack({k: np.asarray(v)
                                            for k, v in want.items()}),
                               **PLAIN_TOL)


@pytest.mark.parametrize("bits", BITS)
def test_each_round_is_one_int8_and_one_f32_gather_of_the_own_bucket(
        world, bits):
    """Per rank, T rounds of one int8 and one f32 ``all_gather`` (codes,
    scales) and nothing else, of the bytes of the rank's own bucket (its
    pieces, not the server's row)."""
    tree = server_tree()
    specs, mesh = specs_of(tree), mesh_for(rank=0)
    pieces = [torch.empty(shd.local_shape(v.shape, specs[k], mesh),
                          device="meta") for k, v in sorted(tree.items())]
    per_round = tree_bucketed_wire_bytes_per_server(
        tcp.StochasticQuantizer(bits=bits, chunk=16), pieces, BLOCK)
    whole = tree_bucketed_wire_bytes_per_server(
        tcp.StochasticQuantizer(bits=bits, chunk=16),
        [torch.empty(v.shape, device="meta") for v in tree.values()],
        BLOCK)
    assert per_round < whole
    for w in world:
        for op in OPS:
            c = w[("ledger", bits, op)]
            assert c["calls"] == {"all_gather:int8": T_WIRE,
                                  "all_gather:float32": T_WIRE}
            assert c["sites"] == {"codes": T_WIRE, "scales": T_WIRE}
            assert sum(c["bytes"].values()) == T_WIRE * per_round


def test_compressed_backend_on_the_mesh_is_the_one_process_backend(world):
    """``fl_consensus_backend`` over the mesh (int8 physical wire, error
    feedback): mixed pieces and residuals bitwise the one-process
    ``CompressedBackend`` on the kron problem with the same key."""
    emul = {k: torch.from_numpy(v) for k, v in
            emulated(server_tree()).items()}
    topo = FLTopology(num_servers=M, clients_per_server=1, t_client=1,
                      t_server=T_WIRE)
    one = tcns.CompressedBackend(
        tcns.GossipBackend(kron(topo.mixing_matrix().astype(np.float32)),
                           T_WIRE),
        tcp.make_compressor(CODEC), error_feedback=True, wire="physical",
        wire_block=16_777_216)
    want, want_res = one.mix_compressed(
        emul, residual={k: torch.zeros_like(v) for k, v in emul.items()},
        key=prng.key(5))
    got = {k: np.concatenate([w["compressed"][0][k].numpy() for w in world])
           for k in emul}
    got_res = {k: np.concatenate([w["compressed"][1][k].numpy()
                                  for w in world]) for k in emul}
    np.testing.assert_array_equal(_stack(got), _stack(
        {k: v.numpy() for k, v in want.items()}))
    np.testing.assert_array_equal(_stack(got_res), _stack(
        {k: v.numpy() for k, v in want_res.items()}))


def test_disagreement_sums_the_pieces_over_the_world(world):
    """Each rank's disagreement of the sharded mixed row equals the
    assembled tree's (replicated leaves from their first copies), within
    float32 rounding of the sums."""
    tree = server_tree()
    specs, mesh = specs_of(tree), mesh_for(rank=0)
    total = 0.0
    for k in sorted(tree):
        full = shd.assemble([w["compressed"][0][k] for w in world],
                            specs[k], mesh).double()
        total += float((full ** 2).sum() - M * (full.mean(0) ** 2).sum())
    want = np.sqrt(max(total, 0.0))
    for w in world:
        assert w["disagreement"] == pytest.approx(want, rel=1e-5)
    # the replicated leaves ("head", "scale") count on replica 0 only
    for r, w in enumerate(world):
        names = sorted(tree)
        flags = dict(zip(names, w["counted"]))
        assert flags["embed"] and flags["w_q"] and flags["down"]
        assert flags["head"] == flags["scale"] == (r % 2 == 0)


def test_push_sum_numerator_on_the_mesh(world):
    """A' = Aᵀ through the plain program on the pieces (bitwise the
    one-process numerator on the kron problem); the (M,) weight exact."""
    emul = {k: torch.from_numpy(v) for k, v in
            emulated(server_tree()).items()}
    topo = FLTopology(num_servers=M, clients_per_server=1, t_client=1,
                      t_server=T_WIRE)
    one = tcns.GossipBackend(kron(A), T_WIRE).mix_numerator(emul)
    got = {k: np.concatenate([w["push_sum"][0][k].numpy() for w in world])
           for k in emul}
    np.testing.assert_array_equal(_stack(got), _stack(
        {k: v.numpy() for k, v in one.items()}))
    w_want = tcns.GossipBackend(A, T_WIRE).push_weight(torch.ones(M))
    for w in world:
        np.testing.assert_array_equal(w["push_sum"][1].numpy(),
                                      w_want.numpy())
    del topo


# ---------------------------------------------------------------------------
# outside the world: the refusals
# ---------------------------------------------------------------------------


def test_epoch_step_and_simulated_wire_refuse_a_sharded_row():
    """Training a client whose weights span ranks needs the local period
    sharded (not ported): the rank-local step refuses the mesh; the
    simulated wire, whose chunks span whole leaves, refuses it too."""
    tree = {k: torch.empty(v.shape, device="meta")
            for k, v in server_tree().items()}
    mesh = mesh_for(rank=1, dry=True)
    topo = FLTopology(num_servers=M, clients_per_server=1, t_client=1,
                      t_server=3)
    backend = shd.fl_consensus_backend(topo, mesh, tree, tp_axis=None)
    assert backend.sharded and backend.rows == (0, 1)
    with pytest.raises(ValueError, match="local period sharded"):
        build_dfl_epoch_step(DFLConfig(topology=topo,
                                       consensus_backend=backend),
                             lambda p, b, r: (None, None), None)
    with pytest.raises(ValueError, match="local period sharded"):
        init_dfl_state(DFLConfig(topology=topo, consensus_backend=backend),
                       torch.zeros(2), None)
    with pytest.raises(ValueError, match="wire='physical'"):
        shd.fl_consensus_backend(topo, mesh, tree, tp_axis=None,
                                 compression="int8")
    # a (M, 1, 1, 1) mesh holds whole rows: not sharded
    whole = tmesh.fl_rank_mesh(tmesh.FLMeshSpec(M, 1, 1, 1), rank=1,
                               dry=True)
    assert not shd.fl_consensus_backend(topo, whole, tree).sharded


# ---------------------------------------------------------------------------
# slow tier: the reference's own mesh program
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_reference_mesh_program_matches_the_assembled_port(world, tmp_path):
    """The reference's ``make_gossip_shard_map`` on a forced (2, 2)
    ("server", "replica") host mesh, int8 wire: its host result is the
    port's assembled result (a replicated leaf from replica 0), and each
    device's own shard is the rank's own pieces, bit for bit — the copies
    of a replicated leaf differ between replicas, on both sides."""
    tree = server_tree()
    np.savez(tmp_path / "tree.npz", a=A, **tree)
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.comm.compressors import StochasticQuantizer
from repro.core import consensus as cns
from repro.launch import sharding as shd
z = np.load({str(tmp_path / 'tree.npz')!r})
tree = {{k: jnp.asarray(z[k]) for k in z.files if k != "a"}}
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("server", "replica"))
specs = shd.fl_server_specs(tree, mesh, tp_axis=None)
run = jax.jit(cns.make_gossip_shard_map(
    mesh, {T_WIRE}, specs, block={BLOCK},
    codec=StochasticQuantizer(bits=8, chunk=16)))
out = run(jnp.asarray(z["a"]), tree, jax.random.key(3))
host = {{k: np.asarray(v) for k, v in out.items()}}
dev = {{f"{{k}}@{{s.device.id}}": np.asarray(s.data)
        for k, v in out.items() for s in v.addressable_shards}}
np.savez({str(tmp_path / 'out.npz')!r}, **host, **dev)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=480,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stderr[-3000:]
    z = np.load(tmp_path / "out.npz")
    specs, mesh = specs_of(tree), mesh_for(rank=0)
    for k in tree:
        pieces = [w[("wire", 8, "A", "physical")][k] for w in world]
        np.testing.assert_array_equal(
            z[k], shd.assemble(pieces, specs[k], mesh).numpy(), err_msg=k)
        # device d of the (2, 2) mesh is rank d of (2, 1, 2, 1)
        for d in range(4):
            np.testing.assert_array_equal(z[f"{k}@{d}"], pieces[d].numpy(),
                                          err_msg=f"{k}@{d}")
    assert not np.array_equal(z["scale@0"], z["scale@1"])
