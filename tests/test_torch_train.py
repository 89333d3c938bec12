"""Port parity for the slice as a whole: one static DFL epoch of the SmolLM
smoke config (M = 3 ring, N = 2, T_C = 2, T_S = 3, seq 16) through
``repro_torch.core.dfl`` and through ``repro_torch.launch.train.train``,
against ``repro.core.dfl`` on the same carried-over weights and the same
tokens (the port's pipeline draws them; the reference is handed them).

Tolerances: post-epoch parameters and per-client losses rtol/atol 1e-4
(f32 forward/backward of a 2-layer LM in another summation order, then
SGD and gossip).  The disagreement (the 3-ring's Metropolis A is the exact
mean, so it is pure rounding) and the drift use the reference's
sum-of-squares formula; they are compared with an absolute tolerance of
8 * sqrt(eps_f32 * sum ||w||^2), that formula's f32 rounding floor."""
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
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.topology import FLTopology  # noqa: E402
from repro_torch.data import DataConfig, FLDataPipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "smollm-360m"
TOPO = dict(num_servers=3, clients_per_server=2, t_client=2, t_server=3,
            graph_kind="ring")
SEQ, BATCH, GAMMA, SEED = 16, 2, 0.05, 0
EPS32 = float(np.finfo(np.float32).eps)
TOL = dict(rtol=1e-4, atol=1e-4)


def _floor(leaves) -> float:
    return 8.0 * np.sqrt(EPS32 * sum(float(np.sum(np.square(x)))
                                     for x in leaves))


@pytest.fixture(scope="module")
def reference():
    """The reference's epoch on carried weights and the port's tokens."""
    jcfg = j_get_smoke(ARCH)
    jparams = jtf.init_params(jax.random.key(7), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    pipe = FLDataPipeline(FLTopology(**TOPO), DataConfig(
        seq_len=SEQ, per_client_batch=BATCH, vocab_size=jcfg.vocab_size,
        seed=SEED))
    tokens = pipe.epoch_batches(0)["tokens"].numpy()
    jtopo = JTopology(**TOPO)
    cfg = jdfl.DFLConfig(topology=jtopo)
    opt = j_sgd(GAMMA)
    step = jax.jit(jdfl.build_dfl_epoch_step(
        cfg, jtf.make_loss_fn(jcfg, jtf.ApplyOptions(remat=False)), opt))
    state = jdfl.init_dfl_state(cfg, jparams, opt, jax.random.key(1))
    state, metrics = step(state, {"tokens": jnp.asarray(tokens)})
    return np_params, tokens, state, metrics


def _check_params(port_params, ref_state):
    got = [t.detach().numpy() for t in tree_leaves(port_params)]
    want = [np.asarray(x) for x in jax.tree.leaves(ref_state.client_params)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_epoch_step_matches_reference(reference):
    np_params, tokens, jstate, jm = reference
    cfg = tdfl.DFLConfig(topology=FLTopology(**TOPO))
    opt = sgd(GAMMA)
    step = tdfl.build_dfl_epoch_step(cfg, ttf.make_loss_fn(get_smoke(ARCH)),
                                     opt)
    state = tdfl.init_dfl_state(cfg, ttf.params_from_numpy(np_params), opt)
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    _check_params(state.client_params, jstate)
    assert state.epoch == 1
    np.testing.assert_allclose(m.loss.numpy(), np.asarray(jm.loss), **TOL)
    server = [np.asarray(x)[:, 0]
              for x in jax.tree.leaves(jstate.client_params)]
    np.testing.assert_allclose(float(m.server_disagreement),
                               float(jm.server_disagreement), rtol=0,
                               atol=_floor(server))
    np.testing.assert_allclose(float(m.client_drift), float(jm.client_drift),
                               rtol=1e-3, atol=_floor(server))
    np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm),
                               **TOL)


def test_train_entry_point_matches_reference(reference):
    np_params, _, jstate, jm = reference
    out = ttrain.train(ARCH, smoke=True, epochs=1, seq_len=SEQ,
                       per_client_batch=BATCH, gamma=GAMMA, seed=SEED,
                       device="cpu", log=False,
                       params=ttf.params_from_numpy(np_params),
                       servers=TOPO["num_servers"],
                       clients=TOPO["clients_per_server"],
                       t_client=TOPO["t_client"], t_server=TOPO["t_server"])
    _check_params(out["state"].client_params, jstate)
    hist = out["history"]
    np.testing.assert_allclose(hist["loss"][0],
                               float(jm.loss[-1].mean()), **TOL)
    assert set(hist) >= {"loss", "disagreement", "drift", "participation",
                         "num_servers", "sigma_prod"}
    assert hist["num_servers"] == [3.0] and hist["participation"] == [1.0]
    assert hist["sigma_prod"][0] == pytest.approx(
        FLTopology(**TOPO).sigma(), abs=1e-12)


def test_train_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(ARCH, device="cuda", epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.resolve_device("cuda")


def test_cli_parses_the_reference_flags():
    args = ttrain.build_parser().parse_args(
        ["--full", "--servers", "4", "--clients", "2", "--t-client", "2",
         "--t-server", "5", "--epochs", "2", "--seq-len", "128",
         "--batch", "2", "--gamma", "0.05", "--graph", "ring",
         "--consensus-mode", "gossip", "--device", "cpu"])
    assert (args.smoke, args.servers, args.device) == (False, 4, "cpu")
    assert ttrain.build_parser().parse_args([]).device == "cuda"
