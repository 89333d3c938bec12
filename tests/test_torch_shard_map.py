"""The multi-process wire on the CPU: ``make_gossip_shard_map``,
``make_ring_gossip``, ``ShardMapBackend`` and the rank-local epoch step of
``repro_torch`` on one world of 4 gloo ranks, held against the JAX package.

One module fixture spawns the world once (``file://`` rendezvous in a
temporary directory, one intra-op thread a rank).  The ranks run a script
that imports torch and ``repro_torch`` only, never JAX; each rank holds one
server's rows, and the rows come back assembled through ``all_gather_rows``.
The parametrised tests compare them here with the reference on the same
numpy-made inputs:

* bitwise: the bucketed wire (int8, int4; A and Aᵀ of a dyadic, non-
  symmetric ring), its ``gather_codes=False`` twin, ``with_shipped`` (the
  shipped tree against ``bucketed_roundtrip_tree``) and staleness 1 and 2,
  each against ``gossip_scan_wire_bucketed`` on the same key and against
  the port's one-process period; the static and dynamic epoch steps on the
  physical wire against the port's one-process runs; ``inlier_shift``
  across ranks (the attack on each rank's rows against the one-process
  ``apply_byzantine``, and the engine with it on the physical wire);
* tolerance: the plain program against ``gossip_scan`` and the push-sum
  numerator (rtol/atol 2e-5), bf16 leaves (one bf16 step a round), the
  ring (plain and wire) against dense gossip and its own twin, the
  rank-local static step and the dynamic engine under edge drops and under
  push-sum against the reference (rtol 2e-4, atol 2e-5);
* the ledger: every wire round is one int8 and one f32 ``all_gather`` (1,
  3 or 7 leaves), their bytes ``tree_bucketed_wire_bytes_per_server``.

Outside the world: the ``--consensus-backend`` mappings and errors, the
engine's refusal of faults under a mesh-bound backend, and the programs'
refusals.  Slow tier: the ``torch.distributed.run`` CLI twin and the
reference's own shard_map program on a forced 4-device host mesh.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.comm import compressors as jcp  # noqa: E402
from repro.core import consensus as jcns  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import RegressionSpec as JSpec  # noqa: E402
from repro.data import make_regression_task as j_task  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.comm import compressors as tcp  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.comm.accounting import \
    tree_bucketed_wire_bytes_per_server  # noqa: E402
from repro_torch.core import (DFLConfig, FaultSchedule, FLTopology,  # noqa: E402
                              ParticipationSchedule, TopologySchedule,
                              build_dfl_epoch_step, init_dfl_state,
                              make_engine)
from repro_torch.core import consensus as tcns  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

M = 4
TOL = dict(rtol=2e-4, atol=2e-5)
PLAIN_TOL = dict(rtol=2e-5, atol=2e-5)
BITS = (8, 4)
OPS = ("A", "AT")
WIRE_MODES = ("physical", "gather_f32", "with_shipped", "stale1", "stale2")
STALE = {"stale1": 1, "stale2": 2}
ENGINE_SHAPE = dict(num_servers=M, clients_per_server=3, t_client=4,
                    t_server=5, graph_kind="ring")
GAMMA = 1e-2
SCEN = dict(participation=dict(kind="bernoulli", rate=0.5, seed=3),
            topology=dict(kind="edge_drop", drop_prob=0.4, seed=5))
PSUM_TOPOLOGY = dict(kind="asymmetric", drop_prob=0.4, seed=7)
# inlier_shift: the attacker sets of the direct cases (codes a row, 1 =
# the attack) and the engine's schedule (seed 1 marks server 0)
INLIER_CODES = {"one": [1, 0, 0, 0], "two": [0, 1, 0, 1]}
INLIER_SPEC = "inlier_shift:0.25:0.9"
# the trainer's smallest LM run on the int8 physical wire
TRAIN_KW = dict(device="cpu", servers=M, clients=2, t_client=1, t_server=2,
                epochs=1, seq_len=8, compression="int8", wire="physical",
                error_feedback=True)


def dyadic(m: int = M) -> np.ndarray:
    """A row-stochastic, non-symmetric ring with dyadic weights: every
    product with it is exact, so the reference's and the kernels' product
    orders agree bit for bit."""
    a = np.eye(m, dtype=np.float32) * 0.5
    for i in range(m):
        a[i, (i + 1) % m] += 0.375
        a[i, (i - 1) % m] += 0.125
    return a


def wire_tree(n_leaves: int = 3, seed: int = 0) -> dict:
    shapes = ((6, 33), (960,), (5, 7), (4,), (3, 2, 5), (17,), (8, 8))
    rng = np.random.default_rng(seed)
    return {f"l{i}": (rng.standard_normal((M,) + shapes[i]) * 2).astype(
        np.float32) for i in range(n_leaves)}


# the script the ranks run: torch and repro_torch only
WORLD = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    M = 4


    def main(rank, out, rdv, spec):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdv,
                                world_size=M, rank=rank)
        try:
            res = run_cases(rank, spec)
            # the ranks ran the port alone
            assert not [n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")]
            if rank == 0:
                torch.save(res, out)
        finally:
            dist.destroy_process_group()


    def run_cases(rank, spec):
        from repro_torch.comm import compressors as cp
        from repro_torch.comm import prng
        from repro_torch.core import (DFLConfig, FLTopology,
                                      ParticipationSchedule,
                                      TopologySchedule, build_dfl_epoch_step,
                                      init_dfl_state, make_engine)
        from repro_torch.core import consensus as cns
        from repro_torch.data import RegressionSpec, make_regression_task
        from repro_torch.optim import sgd
        group = dist.group.WORLD
        mine = slice(rank, rank + 1)

        def every(x):
            """The federation's (M, ...) from this rank's (1, ...) rows."""
            return cns.all_gather_rows(x.contiguous(), group,
                                       site="test").numpy()

        def local(tree):
            return {k: torch.from_numpy(v[mine].copy())
                    for k, v in tree.items()}

        def gathered(tree):
            return {k: every(v) for k, v in tree.items()}

        res = {}
        a = torch.from_numpy(spec["a"])
        ops = {"A": a, "AT": a.T.contiguous()}
        for bits in (8, 4):
            codec = cp.StochasticQuantizer(bits=bits, chunk=16)
            for op, mat in ops.items():
                for mode in spec["wire_modes"]:
                    run = cns.make_gossip_shard_map(
                        group, spec["t_wire"], block=1024, codec=codec,
                        gather_codes=mode != "gather_f32",
                        with_shipped=mode == "with_shipped",
                        staleness=spec["stale"].get(mode, 0))
                    got = run(mat, local(spec["tree"]), prng.key(3))
                    if mode == "with_shipped":
                        res[("wire", bits, op, mode)] = gathered(got[0])
                        res[("shipped", bits, op)] = gathered(got[1])
                    else:
                        res[("wire", bits, op, mode)] = gathered(got)
        for op, mat in ops.items():
            run = cns.make_gossip_shard_map(group, 5, block=16)
            res[("plain", op)] = gathered(run(mat, local(spec["tree"])))
            bf = {k: v.to(torch.bfloat16) for k, v in
                  local(spec["tree"]).items()}
            res[("plain_bf16", op)] = {
                k: every(v.float()) for k, v in run(mat, bf).items()}
        # the ring: 1/2 self, 1/4 each neighbour
        ring = cns.make_ring_gossip(group, 4, 0.5, 0.25)
        res[("ring", "plain")] = gathered(ring(local(spec["tree"])))
        for gather in (True, False):
            ring = cns.make_ring_gossip(
                group, 4, 0.5, 0.25, codec=cp.StochasticQuantizer(chunk=16),
                gather_codes=gather)
            res[("ring", gather)] = gathered(ring(local(spec["tree"]),
                                                 prng.key(7)))
        # the ledger: one int8 and one f32 all_gather a round
        for n_leaves, tree in spec["ledger_trees"].items():
            for bits in (8, 4):
                codec = cp.StochasticQuantizer(bits=bits, chunk=16)
                run = cns.make_gossip_shard_map(group, 3, block=1024,
                                                codec=codec)
                cns.reset_collective_counts()
                run(a, local(tree), prng.key(1))
                c = cns.collective_counts()
                row = torch.tensor([[c["calls"].get("all_gather:int8", 0),
                                     c["calls"].get("all_gather:float32", 0),
                                     c["bytes"].get("all_gather:int8", 0),
                                     c["bytes"].get("all_gather:float32", 0),
                                     len(c["calls"])]], dtype=torch.int64)
                res[("ledger", n_leaves, bits)] = every(row)
        # the rank-local epoch steps and the engine (regression task)
        topo = FLTopology(**spec["engine_shape"])
        task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
        a_np = topo.mixing_matrix()

        def backend(kind, staleness=0):
            inner = cns.ShardMapBackend(group, a_np, topo.t_server,
                                        staleness=staleness)
            if kind == "plain":
                return inner
            return cns.CompressedBackend(
                inner, cp.make_compressor("int8:8"), error_feedback=True,
                wire=kind)

        for name, kind, stale in (("plain", "plain", 0),
                                  ("physical", "physical", 0),
                                  ("physical_stale", "physical", 1),
                                  ("simulated", "simulated", 0)):
            cfg = DFLConfig(topology=topo, staleness=stale,
                            consensus_backend=backend(kind, stale))
            step = build_dfl_epoch_step(cfg, task["loss_fn"],
                                        sgd(spec["gamma"]))
            st = init_dfl_state(cfg, torch.zeros(2), sgd(spec["gamma"]),
                                wire_key=prng.key(0))
            metrics = []
            for _ in range(3):
                st, mt = step(st, task["batches"])
                metrics.append([float(mt.loss[-1].mean()),
                                float(mt.server_disagreement),
                                float(mt.client_drift),
                                float(mt.grad_norm)])
            res[("static", name)] = {
                "params": every(st.client_params), "metrics": metrics,
                "ef": (None if st.ef_residual is None
                       else every(st.ef_residual))}
        scen = spec["scenario"]
        for name, kind in (("plain", "plain"), ("physical", "physical")):
            eng = make_engine(
                topo, task["loss_fn"], sgd(spec["gamma"]),
                participation=ParticipationSchedule(**scen["participation"]),
                topology_schedule=TopologySchedule(**scen["topology"]),
                consensus_backend=backend(kind))
            st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(spec["gamma"]),
                                wire_key=prng.key(0))
            st, hist = eng.run(st, 4, task["batch_fn"])
            res[("engine", name)] = {"params": every(st.client_params),
                                     "hist": hist}
        eng = make_engine(topo, task["loss_fn"], sgd(spec["gamma"]),
                          mixing="push_sum",
                          topology_schedule=TopologySchedule(
                              **spec["psum_topology"]),
                          consensus_backend=backend("plain"))
        st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(spec["gamma"]))
        st, hist = eng.run(st, 4, task["batch_fn"])
        res[("engine", "push_sum")] = {"params": every(st.client_params),
                                       "hist": hist,
                                       "weight": st.psum_weight.numpy()}
        # inlier_shift across ranks: the attack on this rank's rows, and the
        # engine on the int8 physical wire
        from repro_torch.core import dfl
        from repro_torch.core.schedule import (ByzantineAttack,
                                               ByzantineSchedule)
        atk = (ByzantineAttack("inlier_shift", 0.5, 0.25),)
        for name, codes in spec["inlier_codes"].items():
            got = dfl.apply_byzantine(local(spec["tree"]), np.array(codes),
                                      None, atk, row0=rank, group=group)
            res[("inlier", name)] = gathered(got)
        eng = make_engine(
            topo, task["loss_fn"], sgd(spec["gamma"]),
            byzantine=ByzantineSchedule.parse(spec["inlier_spec"], seed=1),
            consensus_backend=backend("physical"))
        st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(spec["gamma"]),
                            wire_key=prng.key(0))
        cns.reset_collective_counts()
        st, hist = eng.run(st, 3, task["batch_fn"])
        res[("engine", "inlier")] = {
            "params": every(st.client_params), "hist": hist,
            "sites": cns.collective_counts()["sites"]}
        # the trainer on the default group, its checkpoint written by rank 0
        from repro_torch.launch import train as ttrain
        run = ttrain.train("smollm-360m", consensus_backend="shard_map",
                           ckpt_dir=spec["ckpt_dir"], log=False,
                           **spec["train_kw"])
        res[("train", "history")] = {k: v for k, v in run["history"].items()
                                     if k != "epoch_s"}
        return res


    if __name__ == "__main__":
        spec = torch.load(sys.argv[3], weights_only=False)
        mp.spawn(main, args=(sys.argv[1], sys.argv[2], spec), nprocs=M)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run every case on one spawned world of 4 gloo ranks; the assembled
    results by case."""
    d = tmp_path_factory.mktemp("shard_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    spec = dict(a=dyadic(), tree=wire_tree(), t_wire=4,
                wire_modes=WIRE_MODES, stale=STALE,
                ledger_trees={n: wire_tree(n, seed=n) for n in (1, 3, 7)},
                engine_shape=ENGINE_SHAPE, gamma=GAMMA, scenario=SCEN,
                psum_topology=PSUM_TOPOLOGY, ckpt_dir=str(d / "ckpt"),
                train_kw=TRAIN_KW, inlier_codes=INLIER_CODES,
                inlier_spec=INLIER_SPEC)
    torch.save(spec, spec_path)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(out),
                        str(d / "rdv"), str(spec_path)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    res = torch.load(out, weights_only=False)
    res["ckpt_dir"] = spec["ckpt_dir"]
    return res


def _stack(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(M, -1) for v in
                           tree.values()], axis=1)


_REF = {}


def _ref_wire(bits: int, op: str, staleness: int) -> dict:
    """The reference's bucketed wire period (jitted) on the world's inputs,
    cached across the tests that share it."""
    k = (bits, op, staleness)
    if k not in _REF:
        a = dyadic() if op == "A" else dyadic().T.copy()
        codec = jcp.StochasticQuantizer(bits=bits, chunk=16)
        out = jax.jit(lambda t: jcns.gossip_scan_wire_bucketed(
            jnp.asarray(a), t, 4, codec, jax.random.key(3), block=1024,
            staleness=staleness))({n: jnp.asarray(v)
                                   for n, v in wire_tree().items()})
        _REF[k] = {n: np.asarray(v) for n, v in out.items()}
    return _REF[k]


# ---------------------------------------------------------------------------
# the bucketed wire, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", WIRE_MODES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits", BITS)
def test_shard_map_wire_matches_reference_bitwise(world, bits, op, mode):
    """Each rank's rows of the wire period, assembled, are the reference's
    ``gossip_scan_wire_bucketed`` bit for bit, and the port's one-process
    period too (row r of the row forms is row r of the square kernels)."""
    got = world[("wire", bits, op, mode)]
    staleness = STALE.get(mode, 0)
    want = _ref_wire(bits, op, staleness)
    np.testing.assert_array_equal(_stack(got), _stack(want))
    a = dyadic() if op == "A" else dyadic().T.copy()
    one = tcns.gossip_scan_wire_bucketed(
        torch.from_numpy(a), {k: torch.from_numpy(v)
                              for k, v in wire_tree().items()}, 4,
        tcp.StochasticQuantizer(bits=bits, chunk=16), prng.key(3),
        block=1024, staleness=staleness)
    np.testing.assert_array_equal(_stack(got), _stack(
        {k: v.numpy() for k, v in one.items()}))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits", BITS)
def test_with_shipped_is_the_round_zero_roundtrip(world, bits, op):
    """``with_shipped``: the shipped tree is ``bucketed_roundtrip_tree`` of
    each rank's own model (the reference's EF oracle), bitwise."""
    codec = jcp.StochasticQuantizer(bits=bits, chunk=16)
    want = jax.jit(lambda t: jcns.bucketed_roundtrip_tree(
        codec, t, jax.random.key(3), block=1024))(
        {k: jnp.asarray(v) for k, v in wire_tree().items()})
    np.testing.assert_array_equal(
        _stack(world[("shipped", bits, op)]),
        _stack({k: np.asarray(v) for k, v in want.items()}))


# ---------------------------------------------------------------------------
# the plain program and the ring, within tolerance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_plain_program_matches_gossip_scan(world, op):
    """A for gossip, Aᵀ for a push-sum numerator; blocks of 16 with a
    zero-padded tail."""
    a = dyadic() if op == "A" else dyadic().T.copy()
    want = jcns.gossip_scan(jnp.asarray(a), {k: jnp.asarray(v) for k, v in
                                             wire_tree().items()}, 5)
    np.testing.assert_allclose(_stack(world[("plain", op)]),
                               _stack({k: np.asarray(v)
                                       for k, v in want.items()}),
                               **PLAIN_TOL)


@pytest.mark.parametrize("op", OPS)
def test_plain_program_on_bf16_leaves(world, op):
    """bf16 rides the wire as bf16; each round sums in f32 and rounds once
    to bf16: within one bf16 step a round of the port's one-process
    kernel-1 period."""
    a = dyadic() if op == "A" else dyadic().T.copy()
    tree = {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in wire_tree().items()}
    one = tcns.GossipBackend(a, 5).mix(tree)
    want = _stack({k: v.float().numpy() for k, v in one.items()})
    got = _stack(world[("plain_bf16", op)])
    step = np.abs(want).max() * 2.0 ** -8
    assert np.abs(got - want).max() <= 5 * step


def _ring_matrix() -> np.ndarray:
    a = np.eye(M, dtype=np.float32) * 0.5
    for i in range(M):
        a[i, (i + 1) % M] += 0.25
        a[i, (i - 1) % M] += 0.25
    return a


def test_ring_plain_matches_dense_gossip(world):
    want = jcns.gossip_scan(jnp.asarray(_ring_matrix()),
                            {k: jnp.asarray(v) for k, v in
                             wire_tree().items()}, 4)
    np.testing.assert_allclose(_stack(world[("ring", "plain")]),
                               _stack({k: np.asarray(v)
                                       for k, v in want.items()}),
                               **PLAIN_TOL)


def test_ring_wire_matches_its_twin_and_dense_gossip(world):
    """The codes at f32 width give the physical ring bit for bit; the
    delta-coded wire stays within int8 quantisation noise of dense
    gossip."""
    phys, twin = world[("ring", True)], world[("ring", False)]
    np.testing.assert_array_equal(_stack(phys), _stack(twin))
    dense = _stack({k: np.asarray(v) for k, v in jcns.gossip_scan(
        jnp.asarray(_ring_matrix()),
        {k: jnp.asarray(v) for k, v in wire_tree().items()}, 4).items()})
    span = np.abs(_stack(wire_tree())).max()
    assert np.abs(_stack(phys) - dense).max() <= 0.02 * span


# ---------------------------------------------------------------------------
# the ledger: one collective pair a round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n_leaves", [1, 3, 7])
def test_each_round_is_one_int8_and_one_f32_all_gather(world, n_leaves,
                                                       bits):
    """Whatever the leaf count, every rank's T_S = 3 rounds made 3 int8 and
    3 f32 ``all_gather`` calls and nothing else; the bytes a round are
    ``tree_bucketed_wire_bytes_per_server`` (the twin of the reference's
    HLO assertion)."""
    rows = world[("ledger", n_leaves, bits)]
    assert (rows == rows[0]).all(), rows
    calls8, calls32, bytes8, bytes32, kinds = rows[0].tolist()
    assert (calls8, calls32, kinds) == (3, 3, 2)
    tree = wire_tree(n_leaves, seed=n_leaves)
    per_round = tree_bucketed_wire_bytes_per_server(
        tcp.StochasticQuantizer(bits=bits, chunk=16),
        [torch.empty(v.shape, device="meta") for v in tree.values()], 1024)
    assert (bytes8 + bytes32) == 3 * per_round


# ---------------------------------------------------------------------------
# the rank-local epoch step and the engine
# ---------------------------------------------------------------------------


def _j_topo():
    return J.FLTopology(**ENGINE_SHAPE)


def _port_static(**cfg_kw):
    topo = FLTopology(**ENGINE_SHAPE)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    cfg = DFLConfig(topology=topo, **cfg_kw)
    step = build_dfl_epoch_step(cfg, task["loss_fn"], sgd(GAMMA))
    st = init_dfl_state(cfg, torch.zeros(2), sgd(GAMMA),
                        wire_key=prng.key(0))
    for _ in range(3):
        st, _ = step(st, task["batches"])
    return st


def test_rank_local_static_step_matches_reference(world):
    jtopo = _j_topo()
    jt = j_task(jtopo, JSpec(heterogeneity=0.5))
    jcfg = J.DFLConfig(topology=jtopo)
    jstep = jax.jit(J.build_dfl_epoch_step(jcfg, jt["loss_fn"],
                                           j_sgd(GAMMA)))
    jst = J.init_dfl_state(jcfg, jnp.zeros((2,)), j_sgd(GAMMA),
                           jax.random.key(0))
    jm = []
    for _ in range(3):
        jst, mt = jstep(jst, jt["batches"])
        jm.append([float(np.asarray(mt.loss)[-1].mean()),
                   float(mt.server_disagreement), float(mt.client_drift),
                   float(mt.grad_norm)])
    got = world[("static", "plain")]
    np.testing.assert_allclose(got["params"], np.asarray(jst.client_params),
                               **TOL)
    np.testing.assert_allclose(np.asarray(got["metrics"])[:, [0, 2, 3]],
                               np.asarray(jm)[:, [0, 2, 3]], **TOL)
    # the disagreement is a difference of near-equal sums: held at the
    # float32 floor of the models' squared norm
    floor = 1e-3 * float(np.sqrt((np.asarray(jst.client_params) ** 2).sum()))
    np.testing.assert_allclose(np.asarray(got["metrics"])[:, 1],
                               np.asarray(jm)[:, 1], rtol=0, atol=floor)


@pytest.mark.parametrize("name,staleness", [("physical", 0),
                                            ("physical_stale", 1)])
def test_rank_local_wire_step_is_the_one_process_step_bitwise(
        world, name, staleness):
    """The physical wire (int8, error feedback) through the rank-local
    step: clients and residual bitwise the port's one-process epochs; the
    losses arrive exactly, the drift's max too."""
    one = _port_static(compression="int8:8", error_feedback=True,
                       wire="physical", staleness=staleness)
    got = world[("static", name)]
    np.testing.assert_array_equal(got["params"], one.client_params.numpy())
    np.testing.assert_array_equal(got["ef"], one.ef_residual.numpy())


def test_rank_local_simulated_wire_step(world):
    """The simulated wire over shard_map: the rank's own message round-
    tripped with its rows of the federation's dither (error feedback), then
    the plain program; within float rounding of the one-process step."""
    one = _port_static(compression="int8:8", error_feedback=True)
    got = world[("static", "simulated")]
    np.testing.assert_allclose(got["params"], one.client_params.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["ef"], one.ef_residual.numpy(),
                               rtol=1e-4, atol=1e-5)


def _j_engine(**kw):
    jtopo = _j_topo()
    jt = j_task(jtopo, JSpec(heterogeneity=0.5))
    jeng = J.make_engine(jtopo, jt["loss_fn"], j_sgd(GAMMA), **kw)
    jst = J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(GAMMA),
                           jax.random.key(0))
    return jeng.run(jst, 4, jt["batch_fn"])


def test_engine_under_edge_drops_matches_reference(world):
    got = world[("engine", "plain")]
    jst, jhist = _j_engine(
        participation=jsched.ParticipationSchedule(**SCEN["participation"]),
        topology_schedule=jsched.TopologySchedule(**SCEN["topology"]))
    for key in ("participation", "num_servers", "sigma_prod"):
        assert got["hist"][key] == jhist[key], key
    np.testing.assert_allclose(got["hist"]["loss"], jhist["loss"], **TOL)
    np.testing.assert_allclose(got["params"], np.asarray(jst.client_params),
                               **TOL)


def test_engine_on_the_physical_wire_is_the_one_process_engine(world):
    """Edge drops and Bernoulli participation on the int8 physical wire:
    states bitwise, histories equal, the port's one-process engine."""
    topo = FLTopology(**ENGINE_SHAPE)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    eng = make_engine(
        topo, task["loss_fn"], sgd(GAMMA),
        participation=ParticipationSchedule(**SCEN["participation"]),
        topology_schedule=TopologySchedule(**SCEN["topology"]),
        compression="int8:8", error_feedback=True, wire="physical")
    st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(GAMMA),
                        wire_key=prng.key(0))
    st, hist = eng.run(st, 4, task["batch_fn"])
    got = world[("engine", "physical")]
    np.testing.assert_array_equal(got["params"], st.client_params.numpy())
    # the federation's ledger on every rank: at d = 2 both bucket layouts
    # pad to one chunk, so the bytes are the one-process run's
    for key in ("loss", "drift", "participation", "sigma_prod", "wire_mb",
                "wire_ratio"):
        assert got["hist"][key] == hist[key], key
    # the disagreement's sums, all-reduced in another order: held at the
    # float32 floor of the models' norm (a difference of near-equal sums)
    floor = 1e-4 * float(np.sqrt((got["params"] ** 2).sum()))
    np.testing.assert_allclose(got["hist"]["disagreement"],
                               hist["disagreement"], rtol=0, atol=floor)


def test_engine_push_sum_matches_reference(world):
    """Push-sum under per-epoch direction drops: the numerator through the
    plain program with Aᵀ, the (M,) weight replicated on every rank."""
    got = world[("engine", "push_sum")]
    jst, jhist = _j_engine(mixing="push_sum",
                           topology_schedule=jsched.TopologySchedule(
                               **PSUM_TOPOLOGY))
    np.testing.assert_allclose(got["params"], np.asarray(jst.client_params),
                               **TOL)
    np.testing.assert_allclose(got["hist"]["psum_min_weight"],
                               jhist["psum_min_weight"], rtol=1e-5)
    w = got["weight"]
    assert (w > 0).all() and abs(float(w.sum()) - M) < 1e-4, w


@pytest.mark.parametrize("name", sorted(INLIER_CODES))
def test_inlier_shift_across_ranks_is_the_one_process_attack(world, name):
    """Each rank attacks its own rows with the honest envelope reduced over
    the group (max and min, exact): the assembled tree is bitwise the
    one-process ``apply_byzantine`` of the whole federation."""
    from repro_torch.core import dfl as tdfl
    from repro_torch.core.schedule import ByzantineAttack
    one = tdfl.apply_byzantine(
        {k: torch.from_numpy(v) for k, v in wire_tree().items()},
        np.array(INLIER_CODES[name]), None,
        (ByzantineAttack("inlier_shift", 0.5, 0.25),))
    np.testing.assert_array_equal(
        _stack(world[("inlier", name)]),
        _stack({k: v.numpy() for k, v in one.items()}))


def test_engine_inlier_shift_on_the_wire_is_the_one_process_engine(world):
    """The dynamic engine with ``inlier_shift`` on server 0 over the int8
    physical wire (EF): states bitwise and histories equal to the port's
    one-process engine; the envelope's reductions are counted under their
    own site, two a leaf an epoch."""
    from repro_torch.core.schedule import ByzantineSchedule
    topo = FLTopology(**ENGINE_SHAPE)
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5))
    eng = make_engine(topo, task["loss_fn"], sgd(GAMMA),
                      byzantine=ByzantineSchedule.parse(INLIER_SPEC, seed=1),
                      compression="int8:8", error_feedback=True,
                      wire="physical")
    assert eng.cfg.byzantine.attacker_sets(0, M) == (frozenset({0}),)
    st = init_dfl_state(eng.cfg, torch.zeros(2), sgd(GAMMA),
                        wire_key=prng.key(0))
    st, hist = eng.run(st, 3, task["batch_fn"])
    got = world[("engine", "inlier")]
    np.testing.assert_array_equal(got["params"], st.client_params.numpy())
    for key in ("loss", "drift", "byzantine", "wire_mb"):
        assert got["hist"][key] == hist[key], key
    assert got["sites"]["inlier_shift"] == 2 * 3


# ---------------------------------------------------------------------------
# outside the world
# ---------------------------------------------------------------------------


def test_resolve_consensus_backend_mappings_and_errors():
    topo = FLTopology(num_servers=M, clients_per_server=2, t_client=1,
                      t_server=3)
    params = {"w": torch.zeros(3)}
    resolve = ttrain.resolve_consensus_backend
    assert resolve("auto", "chebyshev", topo, params) == ("chebyshev", None)
    assert resolve("einsum", "gossip_blocked", topo,
                   params) == ("gossip", None)
    assert resolve("blocked", "gossip", topo,
                   params) == ("gossip_blocked", None)
    with pytest.raises(ValueError, match="unknown consensus backend"):
        resolve("pjit", "gossip", topo, params)
    with pytest.raises(ValueError, match="undefined"):
        resolve("blocked", "exact_mean", topo, params)
    with pytest.raises(ValueError, match="torch.distributed.run "
                                         "--nproc-per-node 4"):
        resolve("shard_map", "gossip", topo, params)
    assert ttrain.build_parser().parse_args(
        ["--consensus-backend", "shard_map"]).consensus_backend == "shard_map"


def test_trainer_on_the_group_and_its_checkpoint(world, tmp_path):
    """``train(consensus_backend="shard_map")`` on the world: the history
    of the one-process run (the Lemma diagnostics at their float floor),
    and rank 0's checkpoint of the gathered client tree equal to the
    one-process run's file, array for array."""
    got = world[("train", "history")]
    one = ttrain.train("smollm-360m", ckpt_dir=str(tmp_path), log=False,
                       **TRAIN_KW)
    want = {k: v for k, v in one["history"].items() if k != "epoch_s"}
    assert set(got) == set(want)
    for key in set(want) - {"disagreement", "drift"}:
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["drift"], want["drift"], rtol=1e-5)
    files = sorted(os.listdir(tmp_path))
    assert files and files == sorted(os.listdir(world["ckpt_dir"]))
    for name in files:
        if name.endswith(".npz"):
            a = np.load(tmp_path / name)
            b = np.load(os.path.join(world["ckpt_dir"], name))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _FakeMeshBound(tcns.GossipBackend):
    mesh_bound = True


def test_engine_refuses_faults_under_a_mesh_bound_backend():
    topo = FLTopology(**ENGINE_SHAPE)
    task = make_regression_task(topo)
    a = topo.mixing_matrix()
    for backend in (_FakeMeshBound(a, topo.t_server),
                    tcns.CompressedBackend(_FakeMeshBound(a, topo.t_server),
                                           tcp.make_compressor("int8"))):
        with pytest.raises(ValueError, match="cannot survive fault "
                                             "surgery"):
            make_engine(topo, task["loss_fn"], sgd(GAMMA),
                        faults=FaultSchedule.parse("drop:1:1"),
                        consensus_backend=backend)
    # without events the mesh-bound backend is accepted
    make_engine(topo, task["loss_fn"], sgd(GAMMA),
                consensus_backend=_FakeMeshBound(a, topo.t_server))


def test_injected_backend_resolves_first():
    """``DFLConfig.consensus_backend`` wins over the config's strings in
    every resolver, and ``fl_consensus_backend`` checks the tree's lead."""
    from repro_torch.core import dfl as tdfl
    from repro_torch.launch.sharding import fl_consensus_backend
    topo = FLTopology(**ENGINE_SHAPE)
    a = topo.mixing_matrix()
    wrapped = tcns.CompressedBackend(_FakeMeshBound(a, topo.t_server),
                                     tcp.make_compressor("int4:32"),
                                     error_feedback=True)
    cfg = DFLConfig(topology=topo, consensus_backend=wrapped)
    assert tdfl.resolve_backend(cfg) is wrapped and wrapped.mesh_bound
    assert tdfl.active_compressor(cfg) is wrapped.compressor
    assert tdfl.wants_error_feedback(cfg)
    assert tdfl.active_wire(cfg) == ("simulated", wrapped.wire_block)
    bare = DFLConfig(topology=topo, compression="int8",
                     consensus_backend=_FakeMeshBound(a, topo.t_server))
    assert tdfl.active_compressor(bare) is None
    assert not tdfl.wants_error_feedback(bare)
    with pytest.raises(ValueError, match="lead with M=4"):
        fl_consensus_backend(topo, None, [torch.empty((3, 2),
                                                      device="meta")])


def test_program_refusals():
    with pytest.raises(ValueError, match="needs codec="):
        tcns.make_gossip_shard_map(None, 3, with_shipped=True)
    with pytest.raises(ValueError, match="delta-coded wire"):
        tcns.make_gossip_shard_map(None, 3, staleness=1)
    with pytest.raises(ValueError, match="staleness must be >= 0"):
        tcns.make_gossip_shard_map(None, 3, codec=tcp.StochasticQuantizer(),
                                   staleness=-1)
    with pytest.raises(ValueError, match="needs the rounding key"):
        tcns.make_gossip_shard_map(None, 3, codec=tcp.StochasticQuantizer())(
            torch.eye(M), {"w": torch.zeros(1, 4)})
    with pytest.raises(ValueError, match="int8/int4"):
        tcns.make_ring_gossip(None, 3, 0.5, 0.25,
                              codec=tcp.make_compressor("top_k:0.5"))


# ---------------------------------------------------------------------------
# slow tier: subprocess runs
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_cli_under_torch_distributed_run(tmp_path):
    """The trainer as users start it: four ranks through
    ``torch.distributed.run`` on the int8 physical wire; rank 0's history
    (its JSONL stream) equals the in-process one-process run's."""
    jl = tmp_path / "t.jsonl"
    env = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}
    args = ["--device", "cpu", "--servers", "4", "--clients", "2",
            "--t-client", "2", "--t-server", "3", "--epochs", "2",
            "--seq-len", "16", "--compression", "int8", "--wire",
            "physical", "--error-feedback"]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", "29547", "-m", "repro_torch.launch.train",
         "--consensus-backend", "shard_map", "--telemetry-jsonl", str(jl)]
        + args, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    from repro_torch.obs import load_jsonl
    recs = [x["value"] for x in load_jsonl(str(jl))
            if x.get("kind") == "epoch"]
    one = ttrain.train("smollm-360m", device="cpu", servers=4, clients=2,
                       t_client=2, t_server=3, epochs=2, seq_len=16,
                       compression="int8", wire="physical",
                       error_feedback=True, log=False)["history"]
    for key in ("loss", "drift", "wire_mb"):
        assert [r[key] for r in recs] == one[key], key


@pytest.mark.slow
def test_reference_shard_map_program_matches_the_port(tmp_path):
    """The reference's own ``make_gossip_shard_map`` wire program on a
    forced 4-device host mesh against the port's world result."""
    tree = wire_tree()
    np.savez(tmp_path / "tree.npz", a=dyadic(), **tree)
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.comm.compressors import StochasticQuantizer
from repro.core import consensus as cns
z = np.load({str(tmp_path / 'tree.npz')!r})
tree = {{k: jnp.asarray(z[k]) for k in z.files if k != "a"}}
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4), ("server",))
specs = {{k: P("server", *([None] * (v.ndim - 1))) for k, v in tree.items()}}
run = jax.jit(cns.make_gossip_shard_map(
    mesh, 4, specs, block=1024, codec=StochasticQuantizer(bits=8, chunk=16)))
out = run(jnp.asarray(z["a"]), tree, jax.random.key(3))
np.savez({str(tmp_path / 'out.npz')!r},
         **{{k: np.asarray(v) for k, v in out.items()}})
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=480,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stderr[-3000:]
    z = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(
        _stack({k: z[k] for k in tree}),
        _stack(world_free_port_result(tree)))


def world_free_port_result(tree: dict) -> dict:
    """The port's one-process bucketed period on the same inputs (row r of
    it is what rank r computes)."""
    out = tcns.gossip_scan_wire_bucketed(
        torch.from_numpy(dyadic()), {k: torch.from_numpy(v)
                                     for k, v in tree.items()}, 4,
        tcp.StochasticQuantizer(bits=8, chunk=16), prng.key(3), block=1024)
    return {k: v.numpy() for k, v in out.items()}
