"""Port parity for checkpointing: twins of the checkpoint rows of
``tests/test_substrate.py`` and of ``tests/test_checkpoint_surgery.py`` on
``repro_torch.checkpoint``, the file format held against the reference's
both ways, and the trainers' ``ckpt_dir``.

Tolerances: round trips and files crossing between the packages are
bitwise (bf16 as its u16 bit pattern); the restore-after-drop continuation
is held to the engine's own drop surgery at the reference test's rtol
1e-6 / atol 1e-7 (both paths run the same operations on the same rows).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import restore_pytree as j_restore  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, restore_pytree,  # noqa: E402
                                    save_pytree)
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    _flatten_with_paths)
from repro_torch.core import (FaultEvent, FaultSchedule,  # noqa: E402
                              FLTopology, init_dfl_state, make_engine)
from repro_torch.core.dfl import DFLState  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.optim.optimizers import SGDState  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.tensor([1.0, -2.5, 3.25, 1e-3],
                                    dtype=torch.bfloat16)},
            "d": (torch.zeros((2,)), torch.tensor(3, dtype=torch.int32))}


def _equal(a, b):
    a = a.float() if isinstance(a, torch.Tensor) else np.asarray(a,
                                                                 np.float32)
    b = b.float() if isinstance(b, torch.Tensor) else np.asarray(b,
                                                                 np.float32)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    path = os.path.join(tmp_path, "t.npz")
    save_pytree(path, tree, meta={"epoch": 7})
    restored = restore_pytree(path, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert b.dtype == a.dtype and b.device == a.device
        _equal(a, b)
    manifest = json.load(open(path + ".json"))
    assert manifest["meta"] == {"epoch": 7}
    assert manifest["leaves"]["__bf16__b/c"] == {"shape": [4],
                                                 "dtype": "uint16"}
    # the reference's key paths: dict keys sorted, sequence items #i
    assert list(_flatten_with_paths(tree)) == ["a", "b/c", "d/#0", "d/#1"]


def test_checkpoint_files_cross_between_the_packages(tmp_path):
    tree = _tree()
    jtree = {"a": jnp.arange(6).reshape(2, 3).astype(jnp.float32),
             "b": {"c": jnp.asarray([1.0, -2.5, 3.25, 1e-3], jnp.bfloat16)},
             "d": (jnp.zeros((2,)), jnp.asarray(3))}
    ours, theirs = (os.path.join(tmp_path, f) for f in ("p.npz", "j.npz"))
    save_pytree(ours, tree, meta={"epoch": 2})
    j_save(theirs, jtree, meta={"epoch": 2})
    # the port's file in the reference, the reference's in the port
    for a, b in zip(jax.tree.leaves(jtree),
                    jax.tree.leaves(j_restore(ours, jtree))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    for a, b in zip(tree_leaves(tree),
                    tree_leaves(restore_pytree(theirs, tree))):
        assert a.dtype == b.dtype
        _equal(a, b)
    # the same archive entries and manifest
    with np.load(ours) as zp, np.load(theirs) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zp[k], zj[k])
    mp = json.load(open(ours + ".json"))
    mj = json.load(open(theirs + ".json"))
    assert mp["leaves"] == mj["leaves"] and mp["meta"] == mj["meta"]


def test_restore_to_the_template_dtype_and_device(tmp_path):
    path = os.path.join(tmp_path, "t.npz")
    save_pytree(path, {"w": torch.linspace(-1, 1, 7), "n": 4})
    out = restore_pytree(path, {"w": torch.zeros(7, dtype=torch.bfloat16),
                                "n": 0})
    assert out["w"].dtype == torch.bfloat16 and out["n"] == 4
    np.testing.assert_array_equal(
        out["w"].float().numpy(),
        torch.linspace(-1, 1, 7).to(torch.bfloat16).float().numpy())


def test_checkpointer_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.ones((3,))}
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(tree)
    for step in range(5):
        ck.save(step, {"w": torch.full((3,), float(step))})
    assert ck.latest_step() == 4
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_00000003.npz", "ckpt_00000004.npz"]
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".json")) \
        == [f + ".json" for f in files]
    restored, step = ck.restore(tree)
    assert step == 4 and torch.equal(restored["w"], torch.full((3,), 4.0))
    assert json.load(open(os.path.join(tmp_path, files[1] + ".json")))[
        "meta"]["step"] == 4
    # the reference's checkpointer reads the port's directory
    assert JCheckpointer(str(tmp_path)).latest_step() == 4


def test_checkpointer_restore_dropped(tmp_path):
    topo = FLTopology(num_servers=4, clients_per_server=1, t_client=1,
                      t_server=1)
    ck = Checkpointer(str(tmp_path))
    full = {"w": torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)}
    ck.save(0, full)
    restored, new_topo = ck.restore_dropped({"w": torch.zeros((3, 3))}, 1,
                                            topo)
    assert new_topo.num_servers == 3
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  full["w"].numpy()[[0, 2, 3]])
    # a file the reference wrote, restored with the drop in the port
    jck = JCheckpointer(str(tmp_path / "j"))
    jck.save(0, {"w": jnp.arange(4 * 3, dtype=jnp.float32).reshape(4, 3)})
    restored, _ = Checkpointer(str(tmp_path / "j")).restore_dropped(
        {"w": torch.zeros((3, 3))}, 2, topo)
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  full["w"].numpy()[[0, 1, 3]])


def test_restore_dropped_rejects_nothing_but_drops_row(tmp_path):
    m, n = 3, 2
    topo = FLTopology(num_servers=m, clients_per_server=n, t_client=2,
                      t_server=2, graph_kind="complete")
    tree = {"w": torch.arange(m * n * 2, dtype=torch.float32).reshape(m, n,
                                                                      2)}
    ck = Checkpointer(str(tmp_path))
    ck.save(0, tree)
    restored, new_topo = ck.restore_dropped({"w": torch.zeros((m - 1, n,
                                                               2))}, 1, topo)
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  tree["w"].numpy()[np.array([0, 2])])
    assert new_topo.num_servers == m - 1
    np.testing.assert_array_equal(
        new_topo.adjacency(),
        jtp.FLTopology(num_servers=m, clients_per_server=n, t_client=2,
                       t_server=2, graph_kind="complete")
        .drop_server(1)[0].adjacency())


def test_restore_dropped_continues_like_engine_surgery(tmp_path):
    """A checkpoint taken at M servers, restored onto the surviving M-1
    topology and trained onward agrees with the run in which the engine
    itself dropped the server."""
    m, n = 4, 2
    drop_epoch, dropped, total = 3, 1, 6
    topo = FLTopology(num_servers=m, clients_per_server=n, t_client=3,
                      t_server=5, graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5),
                                seed=0)
    opt = sgd(1e-3)
    eng1 = make_engine(topo, task["loss_fn"], opt,
                       faults=FaultSchedule((FaultEvent(drop_epoch, "drop",
                                                        dropped),)))
    s1 = init_dfl_state(eng1.cfg, torch.zeros(2), opt)
    for e in range(total):
        s1, _ = eng1.run_epoch(s1, e, task["batch_fn"])
    survivors = list(eng1.alive)
    assert survivors == [0, 2, 3]

    eng2 = make_engine(topo, task["loss_fn"], opt)
    s2 = init_dfl_state(eng2.cfg, torch.zeros(2), opt)
    for e in range(drop_epoch):
        s2, _ = eng2.run_epoch(s2, e, task["batch_fn"])
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(drop_epoch, {"params": s2.client_params,
                           "opt_count": s2.opt_state.count})
    keep = torch.tensor([i for i in range(m) if i != dropped])
    template = {"params": s2.client_params.index_select(0, keep),
                "opt_count": s2.opt_state.count}
    restored, new_topo = ckpt.restore_dropped(template, dropped, topo)
    assert new_topo.num_servers == m - 1
    np.testing.assert_array_equal(new_topo.adjacency(),
                                  eng1.topo.adjacency())

    eng3 = make_engine(new_topo, task["loss_fn"], opt)

    def batch_fn(epoch, alive):
        return task["batch_fn"](epoch, tuple(survivors[i] for i in alive))

    s3 = DFLState(restored["params"], SGDState(restored["opt_count"]),
                  s2.epoch, s2.rng)
    for e in range(drop_epoch, total):
        s3, _ = eng3.run_epoch(s3, e, batch_fn)
    np.testing.assert_allclose(s3.client_params.numpy(),
                               s1.client_params.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_trainers_save_checkpoints(tmp_path):
    """``train(ckpt_dir=)`` saves the client parameters every epoch with
    the arch and epoch; ``train_dynamic`` adds the alive servers, and under
    ``superepoch > 1`` it saves at block boundaries."""
    from repro_torch.launch import train as ttrain
    shape = dict(servers=3, clients=2, t_client=1, t_server=2, seq_len=16,
                 device="cpu", log=False)
    run = ttrain.train("smollm-360m", epochs=4, ckpt_dir=str(tmp_path / "s"),
                       **shape)
    ck = Checkpointer(str(tmp_path / "s"))
    assert ck.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "s")) == sorted(
        f"ckpt_{i:08d}.npz{x}" for i in (1, 2, 3) for x in ("", ".json"))
    restored, _ = ck.restore(run["state"].client_params)
    for a, b in zip(tree_leaves(run["state"].client_params),
                    tree_leaves(restored)):
        assert torch.equal(a, b)
    meta = json.load(open(tmp_path / "s" / "ckpt_00000003.npz.json"))["meta"]
    assert meta == {"step": 3, "arch": run["cfg"].name, "epoch": 3}

    run = ttrain.train_dynamic("smollm-360m", epochs=3, superepoch=2,
                               faults="drop:2:1",
                               ckpt_dir=str(tmp_path / "d"), **shape)
    # blocks [0, 2) and [2, 3): saves after epochs 1 and 2
    names = sorted(f for f in os.listdir(tmp_path / "d")
                   if f.endswith(".npz"))
    assert names == ["ckpt_00000001.npz", "ckpt_00000002.npz"]
    meta = json.load(open(tmp_path / "d" / "ckpt_00000002.npz.json"))["meta"]
    assert meta["alive"] == [0, 2] and meta["epoch"] == 2
    restored, _ = Checkpointer(str(tmp_path / "d")).restore(
        run["state"].client_params)
    for a, b in zip(tree_leaves(run["state"].client_params),
                    tree_leaves(restored)):
        assert torch.equal(a, b)
