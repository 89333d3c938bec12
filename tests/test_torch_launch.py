"""The port's launch layer against the JAX package's: deployment plans,
meshes over ranks, the partition-spec resolvers, the roofline's terms and
the supported pairs (twins of ``tests/test_launch.py``), and the meta-device
dry run (its FLOPs equal ``FlopCounterMode`` over the same program run on
the CPU at the smoke size).

The reference's resolvers run on the port's ``RankMesh`` (it has the
``axis_names`` and ``devices.shape`` they read), so no multi-device JAX is
needed; the reference's trees are ``jax.eval_shape`` of its
``init_params`` at the published sizes, the port's are meta tensors."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.launch import plans as jplans  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch.specs import supported_pairs as j_pairs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_arch, \
    get_smoke  # noqa: E402
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import plans as tplans  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def test_every_arch_has_a_plan_equal_to_the_reference():
    """Field for field, the meshes as (M, N, R, TP) and dtypes by name."""
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    assert sorted(tplans.PLANS) == sorted(jplans.PLANS)
    for arch_id in ARCH_IDS:
        got, want = tplans.plan_for(arch_id), jplans.plan_for(arch_id)
        assert got is not None
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(w):
                g, w = dataclasses.astuple(g), dataclasses.astuple(w)
            assert g == w, (arch_id, f.name)
        assert str(got.dtype()).split(".")[-1] == \
            np.dtype(want.dtype()).name
        assert got.serve_dtype() == torch.bfloat16


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plans_fill_the_mesh(multi_pod):
    target = 512 if multi_pod else 256
    for plan in tplans.PLANS.values():
        spec = plan.fl_spec(multi_pod)
        assert spec.total_devices() == target, plan.arch_id
        mesh = tmesh.make_fl_mesh(spec, multi_pod=multi_pod, rank=0)
        assert mesh.size() == target
        assert mesh.shape == {"server": spec.num_servers,
                              "client": spec.clients_per_server,
                              "replica": spec.fsdp, "model": spec.tp}
        if multi_pod:
            assert spec.num_servers % 2 == 0 or spec.num_servers == 2
            # no server straddles a pod: pod = rank // 256
            for s in range(spec.num_servers):
                ranks = mesh.devices[s].reshape(-1)
                assert len({int(r) // 256 for r in ranks}) == 1


def test_plans_param_budget():
    """Params a device (bf16 / f32 as the plan) fit alongside grads in one
    H100's 80 GB."""
    for arch_id in ARCH_IDS:
        plan = tplans.plan_for(arch_id)
        cfg = get_arch(arch_id)
        spec = plan.fl_spec(False)
        bytes_per = 2 if plan.param_dtype == "bfloat16" else 4
        per_dev = cfg.param_count() * bytes_per / (spec.fsdp * spec.tp)
        assert per_dev * 2 < rl.H100_HBM_BYTES, (arch_id, per_dev / 1e9)


def test_supported_pairs_count():
    pairs = specs.supported_pairs()
    assert len(pairs) == 34          # 10 x 3 + 4 long-context archs
    assert sorted(pairs) == sorted(j_pairs())
    longs = [a for a, s in pairs if s == "long_500k"]
    assert sorted(longs) == sorted([
        "mixtral_8x22b", "gemma2_27b", "jamba_1_5_large_398b",
        "mamba2_780m"])
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


def test_collective_bytes_on_a_synthetic_record():
    """A ``collective_counts()`` record by op:dtype: the reference's kinds,
    all-reduce x2, calls summed over dtypes."""
    counts = {"calls": {"all_gather:int8": 3, "all_gather:float32": 3,
                        "all_reduce:float32": 2, "ring_exchange:bfloat16": 4},
              "bytes": {"all_gather:int8": 3 * 1024,
                        "all_gather:float32": 3 * 64,
                        "all_reduce:float32": 2 * 16,
                        "ring_exchange:bfloat16": 4 * 2 * 256},
              "sites": {}, "op_seconds": {}, "seconds": 0.0,
              "staging_s": 0.0}
    stats = rl.collective_bytes(counts)
    assert stats.bytes_by_kind["all-gather"] == 3 * 1024 + 3 * 64
    assert stats.count_by_kind["all-gather"] == 6
    assert stats.bytes_by_kind["all-reduce"] == 2 * 16 * 2        # x2
    assert stats.bytes_by_kind["collective-permute"] == 4 * 2 * 256
    assert stats.bytes_by_kind["reduce-scatter"] == 0
    assert stats.total_bytes == sum(stats.bytes_by_kind.values())
    # the live ledger reads the same way
    cns.reset_collective_counts()
    g = cns.DryGroup(4, 1)
    cns.all_gather_rows(torch.zeros(2, 8, dtype=torch.int8), g)
    cns.all_reduce_(torch.zeros(3), g, "max", site="inlier_shift")
    live = rl.collective_bytes(cns.collective_counts())
    assert live.bytes_by_kind["all-gather"] == 16
    assert live.bytes_by_kind["all-reduce"] == 24
    assert cns.collective_counts()["sites"] == {"all_gather": 1,
                                                "inlier_shift": 1}


@pytest.mark.parametrize("meta", [
    {"arch": "qwen3_1_7b", "shape": "train_4k", "multi_pod": False,
     "M": 2, "N": 1, "R": 8, "TP": 16, "per_client_batch": 128,
     "t_client": 2, "t_server": 25, "params": int(2e9),
     "dtype": "bfloat16", "active_params": 1e9},
    {"arch": "smollm_360m", "shape": "train_4k", "multi_pod": False,
     "M": 4, "N": 4, "R": 1, "TP": 16, "per_client_batch": 16,
     "t_client": 2, "t_server": 25, "params": 361821120,
     "dtype": "float32", "active_params": 361821120,
     "grad_microbatches": 1},
    {"arch": "gemma2_27b", "shape": "prefill_32k", "multi_pod": True,
     "batch": 32, "seq": 32768, "serve_fsdp": True, "params": int(27e9),
     "dtype": "bfloat16", "active_params": int(27e9)},
    {"arch": "jamba_1_5_large_398b", "shape": "long_500k",
     "multi_pod": False, "batch": 1, "cache_len": 524288,
     "serve_fsdp": True, "params": int(398e9), "dtype": "bfloat16",
     "active_params": int(94e9)},
], ids=lambda m: f"{m['arch']}-{m['shape']}")
def test_analytic_terms_match_the_reference(meta):
    """Bytes and FLOPs are the reference's formulas; the seconds divide them
    by the H100 constants (the peak by the plan's dtype)."""
    chips = 512 if meta["multi_pod"] else 256
    got, want = rl.analytic_terms(meta, chips), jrl.analytic_terms(meta,
                                                                  chips)
    assert got["model_flops"] == want["model_flops"]
    assert got["mem_bytes_dev"] == want["mem_bytes_dev"]
    peak = (rl.H100_PEAK_BF16 if meta["dtype"] == "bfloat16"
            else rl.H100_PEAK_F32)
    assert got["compute_s"] == pytest.approx(
        want["model_flops"] / chips / peak, rel=1e-12)
    assert got["memory_s"] == pytest.approx(
        want["mem_bytes_dev"] / 3.35e12, rel=1e-12)
    coll = rl.CollectiveStats({"all-gather": int(2e10)}, {"all-gather": 3})
    rep = rl.roofline(meta, chips, {"flops": 1e12}, coll)
    assert rep.collective_s == pytest.approx(2e10 / 50e9)
    assert rep.program_flops_per_device == 1e12
    assert rep.dominant in ("compute", "memory", "collective")


def _ref_abstract(arch_id, lead=()):
    cfg = j_get_arch(arch_id)
    plan = jplans.plan_for(arch_id)
    p = jax.eval_shape(lambda: jtf.init_params(jax.random.key(0), cfg,
                                               plan.dtype()))
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        lead + x.shape, x.dtype), p)


def _port_abstract(arch_id, lead=()):
    plan = tplans.plan_for(arch_id)
    p = specs.init_meta_params(get_arch(arch_id), plan.dtype())
    return tree_map(lambda x: torch.empty(lead + tuple(x.shape),
                                          dtype=x.dtype, device="meta"), p)


def _same_specs(got_tree, got_specs, want_tree, want_specs):
    from jax.sharding import PartitionSpec as P
    g_leaves = tree_leaves(got_tree)
    w_leaves = jax.tree.leaves(want_tree)
    assert [tuple(x.shape) for x in g_leaves] == \
        [tuple(x.shape) for x in w_leaves]
    g = [tuple(s) for s in tree_leaves(got_specs)]
    w = [tuple(s) for s in jax.tree.leaves(
        want_specs, is_leaf=lambda x: isinstance(x, P))]
    assert g == w


@pytest.mark.parametrize("arch_id", sorted(ARCH_IDS))
def test_resolvers_match_the_reference_on_full_size_trees(arch_id):
    """Every resolver against the reference's on the arch's full-size tree
    over the plan's single-pod FL mesh and the serving mesh; the reference
    reads the port's ``RankMesh`` as it reads a device mesh."""
    plan = tplans.plan_for(arch_id)
    spec = plan.fl_spec(False)
    fl = tmesh.make_fl_mesh(spec, rank=0)
    m, n = spec.num_servers, spec.clients_per_server
    tp_axis = None if plan.batch_over_model else "model"
    for lead, port_fn, ref_fn in (
            ((m, n), shd.fl_param_specs, jshd.fl_param_specs),
            ((m,), shd.fl_server_specs, jshd.fl_server_specs)):
        got_t, want_t = _port_abstract(arch_id, lead), _ref_abstract(arch_id,
                                                                     lead)
        _same_specs(got_t, port_fn(got_t, fl, tp_axis=tp_axis), want_t,
                    ref_fn(want_t, fl, tp_axis=tp_axis))
    serve = tmesh.make_serve_mesh(rank=0)
    cfg = get_arch(arch_id)
    got_t, want_t = _port_abstract(arch_id), _ref_abstract(arch_id)
    for fsdp in (plan.serve_fsdp, not plan.serve_fsdp):
        for attn_tp in (True, cfg.num_heads % 16 == 0):
            _same_specs(got_t, shd.serve_param_specs(
                got_t, serve, fsdp=fsdp, attn_tp=attn_tp), want_t,
                jshd.serve_param_specs(want_t, serve, fsdp=fsdp,
                                       attn_tp=attn_tp))
    # the caches at a serving shape (the long one where the arch has it)
    shape = "long_500k" if cfg.supports_long_context else "decode_32k"
    b, seq = INPUT_SHAPES[shape].global_batch, INPUT_SHAPES[shape].seq_len
    got_c = tf.init_cache(cfg, b, seq, torch.bfloat16, device="meta")
    got_c = {k: v for k, v in got_c.items() if k != "position"}
    want_c = jax.eval_shape(lambda: jtf.init_cache(
        j_get_arch(arch_id), b, seq, jnp.bfloat16))
    want_c = {k: v for k, v in want_c.items() if k != "position"}
    _same_specs(got_c, shd.serve_cache_specs(got_c, serve, b), want_c,
                jshd.serve_cache_specs(want_c, serve, b))


def test_state_and_batch_specs_match_the_reference():
    """``fl_state_specs``: client leaves under ("server", "client"), the EF
    residual under ("server",), as the reference's; ``fl_batch_spec``."""
    from repro.core.dfl import DFLState as JState
    from repro_torch.core.dfl import DFLState
    spec = tplans.plan_for("mixtral_8x22b").fl_spec(False)
    mesh = tmesh.make_fl_mesh(spec, rank=0)
    client = _port_abstract("mixtral_8x22b", (2, 1))
    server = _port_abstract("mixtral_8x22b", (2,))
    st = DFLState(client, None, 0, None, server, None, None)
    got = shd.fl_state_specs(st, mesh)
    j_client = _ref_abstract("mixtral_8x22b", (2, 1))
    j_server = _ref_abstract("mixtral_8x22b", (2,))
    want = jshd.fl_state_specs(JState(j_client, None, None, None, None,
                                      j_server), mesh)
    _same_specs(client, got.client_params, j_client, want.client_params)
    _same_specs(server, got.ef_residual, j_server, want.ef_residual)
    for div, over in ((True, False), (False, True), (True, True),
                      (False, False)):
        assert tuple(shd.fl_batch_spec(mesh, div, over)) == tuple(
            jshd.fl_batch_spec(mesh, div, over))


def test_local_pieces_and_assembly():
    """``local_shape`` / ``shard_slices`` cut a leaf by its spec (a dim over
    two axes: the first major); ``assemble`` inverts the cut, a replicated
    piece from its first copy."""
    mesh = tmesh.RankMesh(("server", "replica", "model"), (2, 2, 2))
    spec = shd.PartitionSpec("server", ("replica", "model"), None)
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    assert shd.local_shape(x.shape, spec, mesh) == (1, 2, 3)
    pieces = [shd.local_shard(x, spec, mesh, r) for r in range(8)]
    # rank (s, r, m) holds rows s, columns 2 * (2 r + m) ...
    assert torch.equal(pieces[3], x[0:1, 6:8])
    assert torch.equal(shd.assemble(pieces, spec, mesh), x)
    rep = shd.PartitionSpec("server", None)
    y = torch.arange(10.).reshape(2, 5)
    copies = [shd.local_shard(y, rep, mesh, r) + r for r in range(8)]
    assert shd.first_copy(rep, mesh, 4) and not shd.first_copy(rep, mesh, 5)
    assert torch.equal(shd.assemble(copies, rep, mesh),
                       torch.cat([y[:1], y[1:] + 4]))
    with pytest.raises(ValueError, match="does not split"):
        shd.local_shape((2, 7), spec, mesh)


def test_mesh_specs_validate():
    spec = tmesh.FLMeshSpec(num_servers=4, clients_per_server=4, fsdp=1,
                            tp=16)
    assert spec.total_devices() == 256
    assert spec.devices_per_client == 16
    with pytest.raises(ValueError, match="tp=8"):
        tmesh.make_fl_mesh(dataclasses.replace(spec, tp=8))
    with pytest.raises(ValueError, match="replica slots"):
        tmesh.make_fl_mesh(dataclasses.replace(spec, fsdp=2))
    with pytest.raises(ValueError, match="straddle"):
        tmesh.make_fl_mesh(tmesh.FLMeshSpec(1, 32, 1, 16), multi_pod=True)
    mesh = tmesh.fl_rank_mesh(tmesh.FLMeshSpec(2, 1, 2, 1), rank=3)
    assert mesh.coords() == {"server": 1, "client": 0, "replica": 1,
                             "model": 0}
    assert mesh.ranks_along("server") == [1, 3]
    assert mesh.ranks_along("replica", 0) == [0, 1]
    assert mesh.other_index("server") == (1, 2)
    assert mesh._lines("server") == [[0, 2], [1, 3]]
    assert tmesh.describe(mesh) == (
        "mesh {'server': 2, 'client': 1, 'replica': 2, 'model': 1} "
        "(4 devices)")
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert tmesh.make_serve_mesh(multi_pod=True).shape == {"data": 32,
                                                           "model": 16}
    dry = tmesh.fl_rank_mesh(tmesh.FLMeshSpec(2, 1, 2, 1), rank=2, dry=True)
    g = dry.group("server")
    assert isinstance(g, cns.DryGroup) and (g.size, g.rank) == (2, 1)
    assert dry.world_group().size == 4


def _materialize(x):
    """A meta tensor as a CPU tensor of the same shape and dtype."""
    if isinstance(x, torch.Tensor) and x.is_meta:
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, generator=torch.Generator().
                               manual_seed(x.numel()), dtype=torch.float32
                               ).to(x.dtype) * 0.02
        return torch.zeros(x.shape, dtype=x.dtype)
    return x


@pytest.mark.parametrize("arch_id,shape", [("smollm_360m", "train_4k"),
                                           ("qwen3_1_7b", "decode_32k")])
def test_dry_run_flops_equal_the_cpu_program(arch_id, shape, tmp_path):
    """At the smoke size, the meta run's FLOPs are ``FlopCounterMode``'s
    over the same program on CPU tensors; the record's numbers all carry a
    label; the consensus period's collectives are counted."""
    cfg = get_smoke(arch_id)
    bundle = specs.build_program(arch_id, shape, arch=cfg)
    got = dryrun.measure(bundle)
    for st in bundle.stages:
        with FlopCounterMode(display=False) as fc:
            st.fn(*tree_map(_materialize, list(st.args)))
        assert got["stage_flops"][st.name] == fc.get_total_flops(), st.name
        assert got["stage_work"][st.name] > 0
    assert got["stage_flops"][bundle.stages[0].name] > 0
    assert got["args_bytes"] > 0
    rec = dryrun.run_one(arch_id, shape, arch=cfg, out_dir=str(tmp_path),
                         verbose=False)
    saved = json.loads(next(tmp_path.iterdir()).read_text())

    def labels(node):
        if isinstance(node, dict):
            if set(node) == {"value", "label"}:
                yield node["label"]
                return
            for v in node.values():
                yield from labels(v)

    found = set(labels(saved["memory"])) | set(labels(saved["cost"])) \
        | set(labels(saved["roofline"])) | set(labels(saved["collectives"]))
    assert found <= {"measured_meta", "analytic_split"} and found
    if shape == "train_4k":
        calls = rec["collectives"]["record"]["calls"]
        # the plain program: one f32 gather a block a round
        assert set(calls) == {"all_gather:float32"}
        assert rec["meta"]["unsharded"][-1].startswith("intra-client")


def test_dryrun_cli_refuses_without_a_pair():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "smollm-360m"])
