"""Port parity for the Mamba-2 path: ``repro_torch.kernels`` (kernel 9's
plain versions and ``ops.ssd_scan`` on the CPU) and ``repro_torch.models.
mamba`` against ``repro.kernels`` (the Pallas SSD kernel in interpret mode,
``ssd_scan_ref``) and ``repro.models.mamba`` on the same numpy-made inputs.

Tolerances, each with its reason:
* 1e-5 of the largest |value| between two chunked forms of the same
  arithmetic (the port's plain kernel 9 or ``ssd_chunked`` against the
  Pallas kernel or JAX's ``ssd_chunked`` at the same chunk): f32 products
  summed in another order, whose rounding scales with the terms summed
  (|y| reaches ~60 here), not with each output (some are near 0);
* 2e-4 between different algorithms (a chunked form against the naive
  recurrence, or against a chunked form at another chunk), the tolerance the
  reference holds its own kernel to (``tests/test_kernels_ssd.py``): the
  chunked forms take ``exp(cum_t - cum_k)`` of cumulative sums that reach
  tens here, where the recurrence multiplies step decays;
* 1e-4 for a whole mixer or a decode step (projections over d = 128 and
  d_inner = 256, a gated RMSNorm), 2e-4 for decode against the full scan
  (the reference's ``test_mamba_decode_matches_scan``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as j_ssd_scan_ref  # noqa: E402
from repro.models import mamba as jmm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba as tmm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "mamba2_780m"
SAME = "same"                  # 1e-5 of the largest |value|
ALGO = dict(rtol=2e-4, atol=2e-4)
MIXER = dict(rtol=1e-4, atol=1e-4)

SWEEP = [
    (1, 128, 2, 32, 64, 64),
    (2, 256, 4, 64, 128, 128),
    (1, 200, 2, 32, 64, 64),      # ragged: s % chunk != 0
    (2, 64, 8, 64, 128, 64),      # single chunk
]


def _inputs(b, s, nh, hd, ds, seed=7):
    """The reference sweep's operands, made with numpy: x ~ N(0, 1), B and
    C ~ N(0, 0.25), dt = softplus(N(0, 1)), A = -exp(linspace(-1, 1))."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    bs = (rng.standard_normal((b, s, 1, ds)) * 0.5).astype(np.float32)
    cs = (rng.standard_normal((b, s, 1, ds)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0).astype(np.float32)
    a_coef = -np.exp(np.linspace(-1.0, 1.0, nh)).astype(np.float32)
    return xs, bs, cs, dt, a_coef


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _close(got, want, tol, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    if tol == SAME:
        assert got.shape == want.shape, (got.shape, want.shape)
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (msg, err)
    else:
        np.testing.assert_allclose(got, want, **tol, err_msg=msg)


@pytest.mark.parametrize("shape", SWEEP)
def test_ssd_plain_versions_match_reference(shape):
    b, s, nh, hd, ds, chunk = shape
    jin, tin = _both(*_inputs(b, s, nh, hd, ds))
    y_pl, st_pl = jops.ssd_scan(*jin, chunk=chunk)      # Pallas, interpret
    y_nv, st_nv = j_ssd_scan_ref(*jin)
    y_k, st_k = ref.ssd_scan_chunked_ref(*tin, chunk=chunk)
    y_op, st_op = ops.ssd_scan(*tin, chunk=chunk)
    y_r, st_r = ref.ssd_scan_ref(*tin)
    assert y_k.dtype == st_k.dtype == torch.float32
    assert tuple(st_k.shape) == (b, nh, ds, hd)
    for got, want, tol in ((y_k, y_pl, SAME), (st_k, st_pl, SAME),
                           (y_op, y_pl, SAME), (st_op, st_pl, SAME),
                           (y_r, y_nv, SAME), (st_r, st_nv, SAME),
                           (y_k, y_nv, ALGO), (st_k, st_nv, ALGO)):
        _close(got, want, tol)


@pytest.mark.parametrize("shape,decays", [(s, "exp") for s in SWEEP] + [
    ((1, 128, 48, 16, 32, 64), "serving")])
def test_ssd_passes_algebra_matches_reference(shape, decays):
    """Kernel 9's passes (a)-(e) in plain PyTorch against the Pallas kernel
    (interpret mode) and ``ssd_chunked``, with the reference sweep's decays
    and the serving path's A = -(1..48).  ALGO: the passes are another
    algorithm than the chunked form -- C.B' once per chunk, the state pass
    over chunks, and exp(cum_t - cum_r) exp(cum_r - cum_k) for the keys
    before a query tile in place of exp(cum_t - cum_k) -- so their f32
    sums and exponents round otherwise, as the reference's own kernel does
    against its oracle."""
    b, s, nh, hd, ds, chunk = shape
    xs, bs, cs, dt, a_coef = _inputs(b, s, nh, hd, ds)
    if decays == "serving":
        a_coef = -np.arange(1, nh + 1, dtype=np.float32)
    jin, tin = _both(xs, bs, cs, dt, a_coef)
    y, st = ref.ssd_scan_passes_ref(*tin, chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (b, s, nh, hd) and tuple(st.shape) == (b, nh,
                                                                     ds, hd)
    for y_want, st_want in (jops.ssd_scan(*jin, chunk=chunk),
                            jmm.ssd_chunked(*jin, chunk)):
        _close(y, y_want, ALGO)
        _close(st, st_want, ALGO)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_chunk_invariance(chunk):
    """The port's kernel-9 route at any chunk against the reference's
    ``ssd_chunked`` at 48, and the port's ``ssd_chunked`` against it at the
    same 48."""
    jin, tin = _both(*_inputs(1, 192, 2, 32, 64))
    y2, st2 = jmm.ssd_chunked(*jin, 48)
    y1, st1 = ops.ssd_scan(*tin, chunk=chunk)
    _close(y1, y2, ALGO)
    _close(st1, st2, ALGO)
    y3, st3 = tmm.ssd_chunked(*tin, 48)
    _close(y3, y2, SAME)
    _close(st3, st2, SAME)


def test_ssd_decay_extremes():
    """dt = 0 holds the (zero) state and gives y = 0 exactly; a very strong
    decay forgets the past, so each y_t is its own step's term, as the
    reference's kernel and oracle give it."""
    b, s, nh, hd, ds = 1, 64, 2, 16, 32
    xs, bs, cs, dt, _ = _inputs(b, s, nh, hd, ds)
    jin, tin = _both(xs, bs, cs, np.zeros_like(dt), -np.ones(nh, np.float32))
    for fn in (lambda *a: ops.ssd_scan(*a, chunk=32), ref.ssd_scan_ref):
        y, st = fn(*tin)
        assert float(y.abs().max()) == 0.0 and float(st.abs().max()) == 0.0
    strong = -np.full(nh, 1e4, np.float32)
    jin, tin = _both(xs, bs, cs, dt, strong)
    y, st = ops.ssd_scan(*tin, chunk=32)
    y_pl, st_pl = jops.ssd_scan(*jin, chunk=32)
    _close(y, y_pl, SAME)
    _close(st, st_pl, SAME)
    own = np.einsum("bsn,bsn,bsh,bshp->bshp", cs[:, :, 0], bs[:, :, 0], dt,
                    xs)
    _close(y, own, ALGO)


def test_ssd_chunked_ref_masks_a_nan_tail():
    """Kernel 9's plain version reads only the s real steps: NaN beyond
    them (as a TPU block's padding may hold) never reaches the result."""
    xs, bs, cs, dt, a = _inputs(1, 40, 2, 8, 16)
    full = [np.concatenate([t, np.full_like(t[:, :8], np.nan)], 1)
            for t in (xs, bs, cs, dt)]
    _, tin = _both(*full, a)
    y, st = ref.ssd_scan_chunked_ref(*(t[:, :40] for t in tin[:4]), tin[4],
                                     chunk=16)
    want_y, want_st = ref.ssd_scan_ref(*(torch.from_numpy(t)
                                         for t in (xs, bs, cs, dt, a)))
    _close(y, want_y, ALGO)
    _close(st, want_st, ALGO)


def test_ssd_chunked_matches_reference_ragged():
    jin, tin = _both(*_inputs(2, 50, 4, 16, 32, seed=3))
    y_j, st_j = jmm.ssd_chunked(*jin, 16)
    y_t, st_t = tmm.ssd_chunked(*tin, 16)
    _close(y_t, y_j, SAME)
    _close(st_t, st_j, SAME)
    np.testing.assert_allclose(tmm.segsum(tin[3][0].T).numpy(),
                               np.asarray(jmm.segsum(jin[3][0].T)),
                               rtol=1e-6, atol=1e-5)
    # -inf above the diagonal in both; below, differences of cumulative sums
    # that reach ~40, where one f32 ulp is 3.8e-6


def test_softplus_and_silu_follow_jax():
    """``jax.nn.softplus`` is logaddexp(x, 0) at every x (torch's
    ``F.softplus`` switches to x above 20); ``jax.nn.silu`` is
    x * sigmoid(x).  1e-6 relative: exp and log1p of two libraries; atol
    1e-37 because XLA flushes softplus(-100) = 3.8e-44, a subnormal, to 0."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [-100.0, 0.0, 19.99, 20.0, 20.01, 100.0]]
                       ).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tmm.softplus(tx).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=1e-37)
    np.testing.assert_allclose(tmm.silu(tx).numpy(),
                               np.asarray(jax.nn.silu(x)), rtol=1e-6,
                               atol=1e-37)


@pytest.fixture(scope="module")
def carried():
    """The reference's smoke-size mixer parameters (2 layers, d = 128,
    d_state 16, head_dim 32, chunk 8) as numpy, and x ~ 0.3 N(0, 1)."""
    jcfg = j_get_smoke(ARCH)
    jparams = jmm.mamba_init(jax.random.key(5), jcfg)
    tparams = ttf.params_from_numpy(jax.tree.map(np.asarray, jparams))
    x = (np.random.default_rng(5).standard_normal((2, 20, jcfg.d_model))
         * 0.3).astype(np.float32)
    return jcfg, jparams, tparams, x


def test_mamba_init_has_reference_leaves(carried):
    jcfg, jparams, _, _ = carried
    own = tmm.mamba_init(torch.Generator().manual_seed(0), get_smoke(ARCH))
    assert sorted(own) == sorted(jparams)
    for key, leaf in own.items():
        want = jparams[key]["scale"] if key == "norm" else jparams[key]
        got = leaf["scale"] if key == "norm" else leaf
        assert tuple(got.shape) == want.shape, key
        if key not in ("in_proj", "conv_w", "out_proj"):   # deterministic
            # a_log = log(1..nh): two libraries' log, one ulp apart at most
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1.2e-7, atol=0, err_msg=key)


@pytest.mark.parametrize("impl,jimpl", [("reference", "reference"),
                                        ("kernel", "pallas")])
def test_mamba_apply_matches_reference(carried, impl, jimpl):
    jcfg, jparams, tparams, x = carried
    want = jmm.mamba_apply(jparams, jnp.asarray(x), jcfg, impl=jimpl)
    with torch.no_grad():
        got = tmm.mamba_apply(tparams, torch.from_numpy(x), get_smoke(ARCH),
                              impl=impl)
    _close(got, want, MIXER)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_mamba_prefill_and_decode_match_reference(carried, impl):
    """Prefill (output, conv window, SSM state), then three decode steps,
    each against the reference's; the port's prefill on either route
    against the reference's (always ``ssd_chunked``)."""
    jcfg, jparams, tparams, x = carried
    cfg = get_smoke(ARCH)
    jout, jcache = jmm.mamba_prefill(jparams, jnp.asarray(x[:, :16]), jcfg,
                                     conv_cache_dtype=jnp.float32)
    with torch.no_grad():
        out, cache = tmm.mamba_prefill(tparams, torch.from_numpy(x[:, :16]),
                                       cfg, conv_cache_dtype=torch.float32,
                                       impl=impl)
    _close(out, jout, MIXER)
    assert sorted(cache) == sorted(jcache) == ["conv", "ssm"]
    _close(cache["conv"], jcache["conv"], SAME)
    _close(cache["ssm"], jcache["ssm"], MIXER)
    for t in range(16, 20):
        jy, jcache = jmm.mamba_decode_step(jparams, jnp.asarray(x[:, t:t + 1]),
                                           jcache, jcfg)
        with torch.no_grad():
            y, cache = tmm.mamba_decode_step(
                tparams, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        _close(y, jy, MIXER, f"step {t}")
        _close(cache["conv"], jcache["conv"], SAME, f"step {t}")
        _close(cache["ssm"], jcache["ssm"], MIXER, f"step {t}")


def test_mamba_decode_matches_scan():
    """Twin of the reference's test: the O(1) decode recurrence equals the
    full-sequence scan, step by step."""
    cfg = get_smoke(ARCH)
    params = tmm.mamba_init(torch.Generator().manual_seed(7), cfg)
    x = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)) * 0.3).astype(np.float32))
    with torch.no_grad():
        y_full = tmm.mamba_apply(params, x, cfg)
        cache = tmm.mamba_cache_init(cfg, 2, torch.float32)
        ys = [tmm.mamba_decode_step(params, x[:, t:t + 1], cache, cfg)[0]
              for t in range(16)]
    _close(torch.cat(ys, dim=1), y_full, ALGO)


def test_mamba_reference_route_is_differentiable(carried):
    """The reference route (``ssd_chunked``) runs under autograd: the route
    Mamba training will take, since kernel 9 has no backward."""
    _, _, tparams, x = carried
    params = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
                  else v) for k, v in tparams.items()}
    y = tmm.mamba_apply(params, torch.from_numpy(x), get_smoke(ARCH))
    y.square().sum().backward()
    assert all(torch.isfinite(params[k].grad).all()
               for k in ("in_proj", "conv_w", "a_log", "out_proj"))
