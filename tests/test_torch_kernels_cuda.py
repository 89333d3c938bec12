"""The port's Hopper kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU.  The
file imports neither JAX nor the JAX package, so it also runs on the GPU
machine, which has no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: 1e-5 forward (f32 sums in another order), 1e-4 backward (the
RMSNorm kernels' bf16 instances: one bf16 step forward, 2^-8 of the
largest value backward); the
flash-attention kernel 2e-5 in f32 (5e-5 with a softcap) and 2e-2 in bf16,
the tolerances the reference holds its Pallas kernel to, and its bf16 modes
per row at one bf16 step + 1e-3 (``BF16_ROW_LIMIT``); the SSD-scan
kernel 2e-4, the reference's SSD tolerance.  Kernel 1 at M = 3 on an
edge-dropped A_p and the dynamic path's gossip periods (per-epoch A_p,
per-round stack, staleness 1, Chebyshev) against the same periods on the
CPU: 1e-5.  The simulated
wire's kernel 4 and the physical wire's kernels (5-8), and the wire periods
built on the latter: bitwise, since kernel and plain version pin every
rounding to the same operations.  The simulated periods: 1e-5 (their
kernel-1 rounds sum in another order than the CPU's).  Push-sum: kernel 1
under a column-stochastic P as kernel 1 is held; push-sum periods on the
card against the CPU's, as the periods above (bf16: T_S bf16 steps of the
largest value).  Kernel 1 under clipped gossip's state-dependent C: as
kernel 1 is held; the robust periods on the card against the CPU's: the
rank screens bitwise, clipped gossip 1e-5; the Byzantine injection bitwise
but for scaled_noise (4 ulps of its noise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import topology as tp  # noqa: E402
from repro_torch.core.consensus import collapse_mixing  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels run only there")
    return torch.device("cuda")


def _mixing(m: int) -> np.ndarray:
    if m == 1:
        return np.ones((1, 1), np.float32)
    return collapse_mixing(tp.metropolis_weights(tp.ring_graph(m)),
                           3).astype(np.float32)


def _within_one_bf16_rounding(a, w, got) -> bool:
    """``got`` is A w summed in f32 and rounded once to bf16: within half a
    bf16 step of |A w| plus M f32 steps of sum |a| |w| (the sums run in
    another order; near a cancellation that may flip a rounding, so a count
    of bf16 steps is no measure there)."""
    exact = a.float() @ w.float()
    lim = exact.abs() * 2.0 ** -8 + (a.float().abs() @ w.float().abs()) \
        * (w.shape[0] * 2.0 ** -24)
    return bool(((got.float() - exact).abs() <= lim).all())


@pytest.mark.parametrize("m", [1, 4, 5, 16])
@pytest.mark.parametrize("d", [4096, 1_000_003])
def test_consensus_mix_bf16_instance_matches_plain(cuda, m, d):
    """Kernel 1's bf16 instance: an f32 sum rounded once to bf16, on aligned
    and misaligned column blocks."""
    g = torch.Generator(device=cuda).manual_seed(m + d + 1)
    a = torch.from_numpy(_mixing(m)).to(cuda)
    w = torch.randn((m, d), device=cuda, generator=g).bfloat16()
    before = ops.launch_counts()["consensus_mix"]
    for cols in (slice(0, d), slice(3, d - 5)):
        out = ops.consensus_mix(a, w[:, cols])
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16
        assert _within_one_bf16_rounding(a, w[:, cols], out)
    assert ops.launch_counts()["consensus_mix"] == before + 2


@pytest.mark.parametrize("m", [1, 4, 5, 16])
@pytest.mark.parametrize("d", [4096, 1_000_003])
def test_consensus_mix_kernel_matches_plain(cuda, m, d):
    g = torch.Generator(device=cuda).manual_seed(m + d)
    a = torch.from_numpy(_mixing(m)).to(cuda)
    w = torch.randn((m, d), device=cuda, generator=g)
    before = ops.launch_counts()["consensus_mix"]
    out = ops.consensus_mix(a, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["consensus_mix"] == before + 1
    torch.testing.assert_close(out, ref.consensus_mix_ref(a, w),
                               rtol=1e-5, atol=1e-5)


def test_consensus_mix_pytree_blocks_match_plain_rounds(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.from_numpy(_mixing(5)).to(cuda)
    tree = {"w": torch.randn((5, 33, 7), device=cuda, generator=g),
            "b": torch.randn((5, 1001), device=cuda, generator=g)}
    for block in (None, 64):
        got = ops.consensus_mix_pytree(a, tree, rounds=3, block=block)
        for key, leaf in tree.items():
            want = leaf.reshape(5, -1)
            for _ in range(3):
                want = ref.consensus_mix_ref(a, want)
            torch.testing.assert_close(got[key], want.reshape(leaf.shape),
                                       rtol=1e-5, atol=1e-5)


def _edge_dropped_m3() -> np.ndarray:
    """An edge-dropped A_p at M = 3 (the dynamic path after a drop): the
    first epoch whose graph lost an edge, so its Metropolis weights are not
    uniform."""
    from repro_torch.core.schedule import TopologySchedule
    topo = tp.FLTopology(num_servers=3, clients_per_server=2, t_client=1,
                         t_server=5, graph_kind="ring")
    sched = TopologySchedule(kind="edge_drop", drop_prob=0.3, seed=1)
    a = next(sched.mixing(topo, e) for e in range(100)
             if not np.array_equal(sched.mixing(topo, e),
                                   topo.mixing_matrix()))
    return a.astype(np.float32)


@pytest.mark.parametrize("d", [4096, 1_000_003])
def test_consensus_mix_m3_edge_dropped_matches_plain(cuda, d):
    """M = 3 runs through the kernel's 4-row instance with a zero-padded
    row in shared memory."""
    g = torch.Generator(device=cuda).manual_seed(d)
    a = torch.from_numpy(_edge_dropped_m3()).to(cuda)
    w = torch.randn((3, d), device=cuda, generator=g)
    before = ops.launch_counts()["consensus_mix"]
    out = ops.consensus_mix(a, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["consensus_mix"] == before + 1
    torch.testing.assert_close(out, ref.consensus_mix_ref(a, w),
                               rtol=1e-5, atol=1e-5)


def test_dynamic_gossip_periods_match_the_cpu(cuda):
    """The dynamic path's periods on the card against the same periods on
    the CPU (plain rounds): T_S rounds on an edge-dropped A_p, a per-round
    stack, staleness 1 and Chebyshev with a per-epoch lam2 (1e-5: kernel 1
    sums in another order than the CPU)."""
    from repro_torch.core import consensus as cns
    a_np = _edge_dropped_m3()
    lam2 = tp.lambda_2(a_np)
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 33, 7)).astype(np.float32),
            "b": rng.standard_normal((3, 1001)).astype(np.float32)}
    periods = {
        "gossip": (5, lambda a, t: cns.make_backend("gossip", a_np, 5).mix(
            t, a)),
        "tv": (3, lambda a, t: cns.gossip_scan_tv(torch.stack([a] * 3), t)),
        # rounds 1..6 mix (round 0 holds): A^(7 // 2) in exact arithmetic
        "stale": (6, lambda a, t: cns.gossip_scan_stale(a, t, 7, 1)),
        "chebyshev": (3, lambda a, t: cns.make_backend(
            "chebyshev", a_np, 5).mix(t, a, lam2=torch.tensor(
                lam2, dtype=torch.float32, device=a.device))),
    }
    for name, (launches, period) in periods.items():
        cpu = period(torch.from_numpy(a_np), {k: torch.from_numpy(v)
                                              for k, v in tree.items()})
        before = ops.launch_counts()["consensus_mix"]
        got = period(torch.from_numpy(a_np).to(cuda),
                     {k: torch.from_numpy(v).to(cuda)
                      for k, v in tree.items()})
        torch.cuda.synchronize()
        assert ops.launch_counts()["consensus_mix"] == before + launches, \
            name
        for k in tree:
            torch.testing.assert_close(got[k].cpu(), cpu[k], rtol=1e-5,
                                       atol=1e-5, msg=name)


def _push_operator(m: int) -> np.ndarray:
    """Push-sum's P = A' for a random orientation of K_m with out-degree
    weights: column stochastic, its rows not summing to 1."""
    a = tp.out_degree_weights(tp.build_graph("random_orientation", m))
    return np.ascontiguousarray(a.T).astype(np.float32)


@pytest.mark.parametrize("m", [4, 5, 16])
@pytest.mark.parametrize("d", [4096, 1_000_003])
def test_consensus_mix_under_a_column_stochastic_p(cuda, m, d):
    """Kernel 1 takes any (M, M) f32 matrix: under push-sum's P (rows not
    summing to 1) the f32 instance is within 1e-5 of its plain version and
    the bf16 instance one rounding of an f32 sum (the P kept in f32)."""
    p = torch.from_numpy(_push_operator(m)).to(cuda)
    assert not torch.allclose(p.sum(1), torch.ones(m, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(m * 7 + d)
    w = torch.randn((m, d), device=cuda, generator=g)
    before = ops.launch_counts()["consensus_mix"]
    out = ops.consensus_mix(p, w)
    out16 = ops.consensus_mix(p, w.bfloat16())
    torch.cuda.synchronize()
    assert ops.launch_counts()["consensus_mix"] == before + 2
    torch.testing.assert_close(out, ref.consensus_mix_ref(p, w), rtol=1e-5,
                               atol=1e-5)
    assert out16.dtype == torch.bfloat16
    assert _within_one_bf16_rounding(p, w.bfloat16(), out16)


def _clipped_operator(m: int) -> np.ndarray:
    """The clipped-gossip effective matrix ``C`` of a complete graph whose
    server 0 sits far from the rest: row-stochastic, not symmetric, its
    diagonal not 1/M (the clipped mass returns to the self-loops)."""
    from repro_torch.core import consensus as cns
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 64)).astype(np.float32)
    x[0] *= 40.0
    a = torch.from_numpy(tp.metropolis_weights(tp.complete_graph(m))
                         .astype(np.float32))
    return cns.clip_weights(a, {"x": torch.from_numpy(x)}).numpy()


@pytest.mark.parametrize("m", [4, 5, 8])
@pytest.mark.parametrize("d", [4096, 1_000_003])
def test_consensus_mix_under_a_clipped_matrix(cuda, m, d):
    """Kernel 1 under clipped gossip's state-dependent ``C``: the f32
    instance within 1e-5 of its plain version, the bf16 instance one
    rounding of an f32 sum (``C`` kept in f32)."""
    c = torch.from_numpy(_clipped_operator(m)).to(cuda)
    torch.testing.assert_close(c.sum(1), torch.ones(m, device=cuda),
                               rtol=0, atol=1e-6)
    assert not torch.allclose(c, c.T)
    assert not torch.allclose(torch.diagonal(c),
                              torch.full((m,), 1.0 / m, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(m * 11 + d)
    w = torch.randn((m, d), device=cuda, generator=g)
    before = ops.launch_counts()["consensus_mix"]
    out = ops.consensus_mix(c, w)
    out16 = ops.consensus_mix(c, w.bfloat16())
    torch.cuda.synchronize()
    assert ops.launch_counts()["consensus_mix"] == before + 2
    torch.testing.assert_close(out, ref.consensus_mix_ref(c, w), rtol=1e-5,
                               atol=1e-5)
    assert out16.dtype == torch.bfloat16
    assert _within_one_bf16_rounding(c, w.bfloat16(), out16)


def test_robust_periods_and_attacks_match_the_cpu(cuda):
    """The robust periods on the card against the same periods on the CPU:
    the rank screens (plain tensor ops, the same comparisons and source-
    order sums on either device) bitwise, with their counts; clipped gossip
    (kernel 1 under a new ``C`` every round, the Gram products in another
    order) within 1e-5 and T_S launches.  The injection: sign_flip and
    inlier_shift bitwise, scaled_noise within 4 ulps of the noise."""
    from repro_torch.core import consensus as cns
    from repro_torch.core import dfl
    from repro_torch.core.schedule import ByzantineAttack
    m, t_s = 5, 4
    a_np = tp.metropolis_weights(tp.complete_graph(m))
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((m, 33, 7)).astype(np.float32),
            "b": rng.standard_normal((m, 1001)).astype(np.float32)}
    tree["w"][1] *= -25.0
    cpu_t = {k: torch.from_numpy(v) for k, v in tree.items()}
    gpu_t = {k: v.to(cuda) for k, v in cpu_t.items()}
    for mode in ("trimmed_mean:1", "median", "clipped"):
        be = cns.make_backend(mode, a_np, t_s)
        want, wrej = be.mix_stats(cpu_t)
        before = ops.launch_counts()["consensus_mix"]
        got, rej = be.mix_stats(gpu_t)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["consensus_mix"] - before
        assert launches == (t_s if mode == "clipped" else 0), mode
        for k in tree:
            if mode == "clipped":
                torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                           atol=1e-5, msg=mode)
            else:
                assert torch.equal(got[k].cpu(), want[k]), mode
                assert torch.equal(rej.cpu(), wrej), mode
    codes = np.array([1, 0, 2, 0, 3], np.int32)
    attacks = (ByzantineAttack("sign_flip", 0.2, 1.5),
               ByzantineAttack("inlier_shift", 0.2, 0.7),
               ByzantineAttack("scaled_noise", 0.2, 10.0))
    key = np.array([0, 7], np.uint32)
    want = dfl.apply_byzantine(cpu_t, codes, key, attacks)
    got = dfl.apply_byzantine(gpu_t, torch.from_numpy(codes).to(cuda), key,
                              attacks)
    for k in tree:
        g, w = got[k].cpu(), want[k]
        assert torch.equal(g[:4], w[:4]), k
        noise = (w[4] - cpu_t[k][4]) / 10.0
        lim = 4 * 10.0 * torch.abs(torch.nextafter(noise, 2 * noise) - noise) \
            + torch.abs(torch.nextafter(w[4], 2 * w[4]) - w[4])
        assert bool(((g[4] - w[4]).abs() <= lim).all()), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_push_sum_periods_match_the_cpu(cuda, dtype):
    """Push-sum periods on the card (kernel 1 under P every round) against
    the same periods on the CPU: ``gossip_push_sum`` and the gossip,
    gossip_blocked and collapsed backends' ``mix_push_sum``.  f32 values
    1e-5 (kernel 1 sums in another order); bf16 within T_S bf16 steps of
    the largest value (one rounding a round); the weights, an f32 matvec,
    1e-6."""
    from repro_torch.core import consensus as cns
    m, t_s = 5, 5
    a_np = np.ascontiguousarray(_push_operator(m).T)
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((m, 33, 7)).astype(np.float32),
            "b": rng.standard_normal((m, 1001)).astype(np.float32)}
    dt = getattr(torch, dtype)
    periods = {
        "gossip_push_sum": (t_s, lambda a, st: cns.gossip_push_sum(
            a, st, t_s)),
        "gossip": (t_s, lambda a, st: cns.make_backend(
            "gossip", a_np, t_s).mix_push_sum(st, a)),
        "gossip_blocked": (2 * t_s, lambda a, st: cns.make_backend(
            "gossip_blocked", a_np, t_s, block=1000).mix_push_sum(st, a)),
        "collapsed": (1, lambda a, st: cns.make_backend(
            "collapsed", a_np, t_s).mix_push_sum(st, a)),
    }
    for name, (launches, period) in periods.items():
        cpu = period(torch.from_numpy(a_np), cns.init_push_sum(
            {k: torch.from_numpy(v).to(dt) for k, v in tree.items()}))
        before = ops.launch_counts()["consensus_mix"]
        got = period(torch.from_numpy(a_np).to(cuda), cns.init_push_sum(
            {k: torch.from_numpy(v).to(dt).to(cuda)
             for k, v in tree.items()}))
        torch.cuda.synchronize()
        assert ops.launch_counts()["consensus_mix"] == before + launches, \
            name
        torch.testing.assert_close(got.weight.cpu(), cpu.weight, rtol=1e-6,
                                   atol=1e-6, msg=name)
        for k in tree:
            if dtype == "float32":
                torch.testing.assert_close(got.values[k].cpu(),
                                           cpu.values[k], rtol=1e-5,
                                           atol=1e-5, msg=name)
            else:
                top = float(cpu.values[k].float().abs().max())
                err = float((got.values[k].cpu().float()
                             - cpu.values[k].float()).abs().max())
                assert got.values[k].dtype == torch.bfloat16
                assert err <= t_s * 2.0 ** -8 * top, (name, k, err, top)


@pytest.mark.parametrize("wire", ["simulated", "physical"])
def test_compressed_push_sum_periods_match_the_cpu(cuda, wire):
    """Both wires under P on the card against the same periods on the CPU:
    the simulated wire's kernel-4 pass fuses P (then kernel 1), the
    physical wire's kernels 6 and 7 carry P (error feedback on).  Physical:
    values and residual bitwise (kernels and plain versions pin the same
    roundings); simulated: 1e-5 (its kernel-1 rounds sum in another order);
    the weights exact-ish (1e-6)."""
    from repro_torch.comm import prng
    from repro_torch.core import consensus as cns
    m = 4
    a_np = np.ascontiguousarray(_push_operator(m).T)
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((m, 64, 9)).astype(np.float32),
            "b": rng.standard_normal((m, 1000)).astype(np.float32)}
    res = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    kw = dict(compression="int8:16", error_feedback=wire == "physical",
              wire=wire, block=1024)
    backend = cns.make_backend("gossip", a_np, 3, **kw)
    runs = []
    for dev in ("cpu", cuda):
        residual = ({k: torch.from_numpy(v.copy()).to(dev)
                     for k, v in res.items()} if wire == "physical" else None)
        before = dict(ops.launch_counts())
        ps, new = backend.mix_push_sum_compressed(
            cns.init_push_sum({k: torch.from_numpy(v).to(dev)
                               for k, v in tree.items()}),
            residual=residual, key=prng.key(5))
        torch.cuda.synchronize()
        runs.append((ps, new, {k: v - before[k]
                               for k, v in ops.launch_counts().items()}))
    (cpu, cpu_res, _), (got, got_res, launches) = runs
    if wire == "physical":
        assert launches["quantized_gossip_encode"] == 1
        assert launches["bucketed_gossip_round"] == 3
    else:
        assert launches["quantized_consensus_mix"] == len(tree)
        assert launches["consensus_mix"] == 2
    torch.testing.assert_close(got.weight.cpu(), cpu.weight, rtol=1e-6,
                               atol=1e-6)
    for k in tree:
        if wire == "physical":
            assert torch.equal(got.values[k].cpu(), cpu.values[k]), k
            assert torch.equal(got_res[k].cpu(), cpu_res[k]), k
        else:
            torch.testing.assert_close(got.values[k].cpu(), cpu.values[k],
                                       rtol=1e-5, atol=1e-5)


# (rows, d) of the paths' norms, rows cut: a SmolLM client step (256 x 960),
# Qwen3's ln and final norms (2048), its q_norm / k_norm (128), Mamba2's ln
# (1536) and gated norm (3072), a decode step's 4 rows; and 1000 x 960
RMSNORM_SHAPES = [(256, 960), (1000, 960), (512, 2048), (4, 2048),
                  (4096, 128), (64, 128), (32, 128), (512, 1536), (4, 1536),
                  (512, 3072), (4, 3072)]


def _bf16_steps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Most bf16 steps between two bf16 tensors."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(got) - ordered(want)).abs().max())


def _rms_inputs(cuda, rows, d, dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(rows * 131 + d + seed)
    x = torch.randn((rows, d), device=cuda, generator=g).to(dtype)
    s = (1 + 0.1 * torch.randn(d, device=cuda, generator=g)).to(dtype)
    gy = torch.randn((rows, d), device=cuda, generator=g).to(dtype)
    return x, s, gy


def _check_rmsnorm(cuda, x, s, gy):
    """Forward (through ``ops.rmsnorm`` under autograd, so one launch each
    way) and backward against the plain version and its autograd.  f32:
    1e-5 forward, 1e-4 backward (sums in another order); bf16: the forward
    within one bf16 step (one rounding of f32 values a few f32 ulps
    apart), the backward within 2^-8 of the largest value (dx cancels, so
    a per-element step count near 0 says nothing)."""
    x = x.detach().requires_grad_(True)
    s = s.detach().requires_grad_(True)
    before = dict(ops.launch_counts())
    y = ops.rmsnorm(x, s)
    dx, ds = torch.autograd.grad(y, (x, s), gy)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    rows = x.shape[0]
    assert after["rmsnorm_fwd"] == before["rmsnorm_fwd"] + (rows > 0)
    assert after["rmsnorm_bwd"] == before["rmsnorm_bwd"] + (rows > 0)
    yr = ref.rmsnorm_ref(x, s)
    dxr, dsr = ref.rmsnorm_bwd_ref(x.detach(), s.detach(), gy)
    assert y.dtype == dx.dtype == x.dtype and ds.dtype == s.dtype
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx, dxr, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ds, dsr, rtol=1e-4, atol=1e-4)
        return
    if rows:
        assert _bf16_steps(y.detach(), yr.detach()) <= 1
    for got, want in ((dx, dxr), (ds, dsr)):
        err = (got.float() - want.float()).abs().max() if got.numel() else 0
        top = want.float().abs().max() if want.numel() else 0
        assert err <= 2 ** -8 * top, (float(err), float(top))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", RMSNORM_SHAPES,
                         ids=[f"{r}x{d}" for r, d in RMSNORM_SHAPES])
def test_rmsnorm_kernels_match_plain(cuda, rows, d, dtype):
    _check_rmsnorm(cuda, *_rms_inputs(cuda, rows, d, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(4, 130), (7, 1001), (0, 960), (1, 960),
                                    (4, 960), (1, 16384), (3, 5000)])
def test_rmsnorm_kernels_ragged_and_edge_shapes(cuda, rows, d, dtype):
    """A d that fills no whole 16-byte vector (the scalar path), 0, 1 and 4
    rows (one block, idle row groups; 0 rows launch nothing and give a zero
    dscale), and the widest rows (blocks of up to 1024 threads)."""
    _check_rmsnorm(cuda, *_rms_inputs(cuda, rows, d, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rmsnorm_kernels_strided_and_misaligned_views(cuda, dtype):
    """x and g as views: a row stride wider than d (vector path), and a
    start 2 elements into the storage, not 16-byte aligned (scalar path)."""
    rows, d = 48, 960
    g = torch.Generator(device=cuda).manual_seed(7)
    wide = torch.randn((rows, d + 64), device=cuda, generator=g).to(dtype)
    flat = torch.randn(rows * d + 2, device=cuda, generator=g).to(dtype)
    shifted = flat[2:].view(rows, d)
    assert shifted.data_ptr() % 16 and wide.stride(0) != d
    s = (1 + 0.1 * torch.randn(d, device=cuda, generator=g)).to(dtype)
    for x in (wide[:, :d], shifted):
        gy = torch.randn((rows, d + 64), device=cuda, generator=g
                         ).to(dtype)[:, 32:32 + d]
        _check_rmsnorm(cuda, x, s, gy)
    with torch.no_grad():                # serving: the ops' reshape, no copy
        for x in (wide[:, :d], shifted):
            got = ops.rmsnorm(x.reshape(4, 12, d), s).reshape(rows, d)
            want = ref.rmsnorm_ref(x, s)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            else:
                assert _bf16_steps(got, want) <= 1


@pytest.mark.parametrize("rows,d", [(256, 960), (4096, 128), (3, 1001)])
def test_rmsnorm_backward_is_bitwise_run_to_run(cuda, rows, d):
    """dscale sums its rows in an order fixed by the shape: two calls on
    the same inputs agree bit for bit (no float atomics)."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, gy = _rms_inputs(cuda, rows, d)
    _, rstd = rn.rmsnorm_fwd_cuda(x, s, 1e-6)
    dx1, ds1 = rn.rmsnorm_bwd_cuda(x, s, rstd, gy)
    dx2, ds2 = rn.rmsnorm_bwd_cuda(x, s, rstd, gy)
    torch.cuda.synchronize()
    assert torch.equal(ds1, ds2) and torch.equal(dx1, dx2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d,tp", [(256, 3072, 2), (256, 16384, 4),
                                       (5, 1000, 4)])
def test_rmsnorm_cut_rows_match_whole_rows(cuda, rows, d, tp, dtype):
    """Rows cut over ``tp`` pieces (Mamba's gated norm under tensor
    parallelism; 250 columns a piece take the scalar path): the statistics
    launches, summed over the pieces, and the given-statistics passes
    against the plain whole-row norm: f32 1e-5 forward, 1e-4 backward;
    bf16 y within one step, dx and dscale within 2^-8 of their largest
    value, as ``_check_rmsnorm``.  Two launches a piece each way."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, gy = _rms_inputs(cuda, rows, d, dtype)
    xs, ss_, gs = x.chunk(tp, dim=1), s.chunk(tp), gy.chunk(tp, dim=1)
    xs, gs = [t.contiguous() for t in xs], [t.contiguous() for t in gs]
    before = dict(ops.launch_counts())
    sq = sum(rn.rmsnorm_sumsq_cuda(xp, sp) for xp, sp in zip(xs, ss_))
    fwd = [rn.rmsnorm_fwd_cuda(xp, sp, 1e-6, ss=sq, d_norm=d)
           for xp, sp in zip(xs, ss_)]
    dot = sum(rn.rmsnorm_dot_cuda(xp, sp, r, gp)
              for xp, sp, gp, (_, r) in zip(xs, ss_, gs, fwd))
    bwd = [rn.rmsnorm_bwd_cuda(xp, sp, r, gp, dot=dot, d_norm=d)
           for xp, sp, gp, (_, r) in zip(xs, ss_, gs, fwd)]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["rmsnorm_fwd"] == before["rmsnorm_fwd"] + 2 * tp
    assert after["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 2 * tp
    y = torch.cat([y_ for y_, _ in fwd], dim=1)
    dx = torch.cat([dx_ for dx_, _ in bwd], dim=1)
    ds = torch.cat([ds_ for _, ds_ in bwd])
    yr = ref.rmsnorm_ref(x, s)
    dxr, dsr = ref.rmsnorm_bwd_ref(x, s, gy)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx, dxr, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ds, dsr, rtol=1e-4, atol=1e-4)
        return
    assert _bf16_steps(y, yr) <= 1
    for got, want in ((dx, dxr), (ds, dsr)):
        err = (got.float() - want.float()).abs().max()
        assert err <= 2 ** -8 * want.float().abs().max(), float(err)


def test_rmsnorm_serving_forward_skips_rstd(cuda):
    """Without autograd the forward writes no rstd and is the same y."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, _ = _rms_inputs(cuda, 64, 128)
    y, rstd = rn.rmsnorm_fwd_cuda(x, s, 1e-6, need_rstd=False)
    assert rstd is None
    with torch.no_grad():
        assert torch.equal(ops.rmsnorm(x, s), y)
    assert torch.equal(rn.rmsnorm_fwd_cuda(x, s, 1e-6)[0], y)


def test_rmsnorm_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import rmsnorm as rn
    x, s, gy = _rms_inputs(cuda, 8, 64)
    _, rstd = rn.rmsnorm_fwd_cuda(x, s, 1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rn.rmsnorm_fwd_cuda(x.half(), s.half(), 1e-6)
    with pytest.raises(TypeError, match="one dtype"):
        rn.rmsnorm_fwd_cuda(x, s.bfloat16(), 1e-6)
    with pytest.raises(ValueError, match=r"scale \(d,\)"):
        rn.rmsnorm_fwd_cuda(x, s[:63], 1e-6)
    wide = torch.zeros((2, rn.MAX_D + 1), device=cuda)
    with pytest.raises(ValueError, match="d <= 16384"):
        rn.rmsnorm_fwd_cuda(wide, torch.ones(rn.MAX_D + 1, device=cuda),
                            1e-6)
    with pytest.raises(ValueError, match="one device"):
        rn.rmsnorm_fwd_cuda(x, s.cpu(), 1e-6)
    with pytest.raises(ValueError, match="one device"):
        rn.rmsnorm_bwd_cuda(x, s.cpu(), rstd, gy)
    with pytest.raises(ValueError, match="g must match"):
        rn.rmsnorm_bwd_cuda(x, s, rstd, gy.cpu())
    with pytest.raises(ValueError, match="unit column stride"):
        rn.rmsnorm_fwd_cuda(x.t(), torch.ones(8, device=cuda), 1e-6)
    with pytest.raises(ValueError, match="rstd"):
        rn.rmsnorm_bwd_cuda(x, s, rstd[:4], gy)


def test_kernels_refuse_what_they_do_not_take(cuda):
    w = torch.zeros((4, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        ops.consensus_mix(torch.eye(4, device=cuda), w)
    from repro_torch.kernels.consensus_mix import consensus_mix_cuda
    with pytest.raises(TypeError, match="one dtype"):
        consensus_mix_cuda(torch.eye(4, device=cuda), w.float(),
                           torch.empty_like(w, dtype=torch.bfloat16))
    w32 = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="overlap"):
        ops.consensus_mix(torch.eye(4, device=cuda), w32, out=w32)
    with pytest.raises(ValueError, match="M <= 64"):
        ops.consensus_mix(torch.eye(65, device=cuda),
                          torch.zeros((65, 8), device=cuda))


# (b, sq, sk, h, kvh, hd) and options: the reference's sweep
# (tests/test_kernels_attention.py) plus hd 40 and the serving shape
FLASH_CASES = [
    ((1, 128, 128, 4, 4, 64), {}),                         # MHA
    ((2, 128, 128, 8, 2, 64), {}),                         # GQA 4:1
    ((1, 256, 256, 4, 1, 128), {}),                        # MQA, hd 128
    ((2, 64, 192, 4, 2, 64), {}),                          # sq < sk
    ((1, 100, 100, 3, 3, 32), {}),                         # ragged, hd 32
    ((1, 128, 130, 4, 4, 64), {}),                         # ragged keys
    ((1, 128, 128, 4, 2, 64), {"window": 16}),
    ((1, 128, 128, 4, 2, 64), {"window": 64}),
    ((1, 128, 128, 4, 2, 64), {"window": 4096}),
    ((1, 128, 128, 4, 4, 64), {"softcap": 20.0}),
    ((1, 128, 128, 4, 4, 64), {"softcap": 50.0}),
    ((1, 128, 128, 4, 4, 64), {"causal": False}),
    ((1, 128, 128, 4, 2, 64), {"window": 48, "softcap": 30.0}),
    ((2, 1, 512, 8, 2, 64), {}),                           # sq = 1
    ((1, 96, 96, 3, 1, 40), {}),                           # hd 40
    ((4, 1024, 1024, 16, 8, 128), {}),                     # serving prefill
    ((1, 256, 256, 8, 1, 128), {}),                        # a group of 8
    ((1, 256, 256, 4, 2, 128), {"window": 64, "softcap": 50.0}),  # Gemma-2
    ((1, 300, 300, 14, 2, 64), {}),                        # InternVL: group 7
    ((2, 200, 200, 4, 4, 64), {"causal": False}),          # Seamless encoder
]


# the zoo's bf16 modes and the edges of the bf16 instance: (b, sq, sk, h,
# kvh, hd), options; "view" (not an option of the kernel) hands it q, k and
# v as views in the model layout: "fused" slices one (b, s, h + 2 kvh, hd)
# projection, "bhsd" transposes k and v out of (b, kvh, s, hd) storage
FLASH_BF16_CASES = [
    # Gemma-2's local layers at its 6144-token prompt: the window masks keys
    # for the last third of the queries
    ((1, 6144, 6144, 4, 2, 128), {"window": 4096, "softcap": 50.0}),
    # a short window: it masks keys for 7 of 8 queries
    ((1, 1024, 1024, 4, 2, 128), {"window": 128, "softcap": 50.0}),
    ((1, 1024, 1024, 4, 2, 128), {"softcap": 50.0}),       # Gemma-2 global
    ((1, 512, 512, 16, 2, 128), {}),                       # Command-R: group 8
    # Mixtral's group of 6 (two heads a block), a window that cuts tiles
    ((1, 640, 640, 12, 2, 128), {"window": 200}),
    ((2, 384, 384, 4, 2, 64), {}),                         # hd 64
    ((1, 300, 300, 6, 3, 32), {"softcap": 50.0}),          # hd 32, padded
    # hd past 64: the second 64-column box is read partly past hd (zeros)
    ((1, 300, 300, 4, 2, 96), {}),
    ((1, 256, 256, 6, 2, 72), {"softcap": 50.0}),
    ((1, 256, 300, 4, 2, 128), {}),                        # sk past a tile
    ((1, 300, 200, 4, 2, 128), {}),                        # 100 rows see none
    ((1, 512, 512, 4, 2, 128), {"window": 100}),           # window < a tile
    ((2, 256, 256, 4, 4, 64), {"causal": False}),          # non-causal
    ((2, 384, 384, 8, 2, 128), {"view": "fused"}),
    ((1, 384, 384, 8, 2, 128), {"view": "bhsd", "window": 300}),
]
# each side rounds its f32 output once to bf16.  Before that the two differ
# by the order of the f32 sums and by the kernel's P, rounded to bf16 for the
# tensor cores: up to 2^-8 of each weight, with l summing the rounded P so
# that the weights stay normalised, which moves an output by up to 2^-8 of a
# weighted spread of v around it -- below 2^-8 of the row's largest |value|
# (the CPU emulation in tests/test_torch_kernels.py measures up to 3.6e-3).
# Two f32 values that close round at most one bf16 step apart, 2^-7 of the
# row's largest |value|; 1e-3 more for the f32 sums' order
BF16_ROW_LIMIT = 2.0 ** -7 + 1e-3


def _row_rel_err(got, want) -> float:
    """Largest error of a row (one query of one head) over that row's
    largest |value|: rows that average thousands of keys have small values,
    and a fault in the window or the softcap may show only there.  A row
    that sees no key is 0 on both sides (any other value fails)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def _flash_views(cuda, shape, view):
    """q, k, v of ``shape`` in bf16 as views of larger storage (see
    FLASH_BF16_CASES)."""
    b, sq, sk, h, kvh, hd = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    if view == "fused":
        qkv = torch.randn((b, sq, h + 2 * kvh, hd), device=cuda,
                          generator=g).bfloat16()
        return qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    q = torch.randn((b, sq, h, hd), device=cuda, generator=g).bfloat16()
    k, v = (torch.randn((b, kvh, sk, hd), device=cuda, generator=g)
            .bfloat16().transpose(1, 2) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("shape,kw", FLASH_BF16_CASES,
                         ids=["x".join(map(str, s)) + "".join(
                             f"-{k}{v}" for k, v in kw.items())
                             for s, kw in FLASH_BF16_CASES])
def test_flash_attention_kernel_bf16_zoo_modes(cuda, shape, kw):
    """bf16 operands at the zoo's modes and the instance's edges, held per
    row against the plain version; with a softcap q is scaled by 8 so that
    the scores reach the cap's bend.  The kernel run without its window or
    softcap must fail the same check, so the check can see either fault.
    Rows that see no key are exactly 0."""
    kw = dict(kw)
    view = kw.pop("view", None)
    if view is None:
        q, k, v = _flash_inputs(cuda, shape, torch.bfloat16)
    else:
        q, k, v = _flash_views(cuda, shape, view)
        assert not (q.is_contiguous() and k.is_contiguous())
    if "softcap" in kw:
        q = (q.float() * 8.0).bfloat16()
    before = ops.flash_attention_mode_counts()
    out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == torch.bfloat16
    want = ref.attention_ref(q, k, v, **kw)
    assert _row_rel_err(out, want) <= BF16_ROW_LIMIT
    sq, sk = shape[1], shape[2]
    if sq > sk and kw.get("causal", True):
        assert not out[:, :sq - sk].any()
    for opt in ("window", "softcap"):
        if opt in kw:
            wrong = ops.flash_attention(q, k, v, **{**kw, opt: None})
            assert _row_rel_err(wrong, want) > 4 * BF16_ROW_LIMIT, opt
    key = fa.mode_key(torch.bfloat16, shape[3] // shape[4], shape[5],
                      kw.get("causal", True), kw.get("window"),
                      kw.get("softcap"))
    after = ops.flash_attention_mode_counts()
    assert after[key] == before.get(key, 0) + 1


def _flash_inputs(cuda, shape, dtype=torch.float32):
    b, sq, sk, h, kvh, hd = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    return (torch.randn((b, sq, h, hd), device=cuda, generator=g).to(dtype),
            torch.randn((b, sk, kvh, hd), device=cuda, generator=g).to(dtype),
            torch.randn((b, sk, kvh, hd), device=cuda, generator=g).to(dtype))


@pytest.mark.parametrize("shape,kw", FLASH_CASES,
                         ids=["x".join(map(str, s)) + "".join(
                             f"-{k}{v}" for k, v in kw.items())
                             for s, kw in FLASH_CASES])
def test_flash_attention_kernel_matches_plain(cuda, shape, kw):
    q, k, v = _flash_inputs(cuda, shape)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    tol = 5e-5 if "softcap" in kw else 2e-5
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, **kw),
                               rtol=tol, atol=tol)


def test_flash_attention_kernel_bf16_and_masked_rows(cuda):
    q, k, v = _flash_inputs(cuda, (1, 128, 128, 4, 2, 64), torch.bfloat16)
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)
    # sq > sk: the first 24 queries see no key and come out 0
    q, k, v = _flash_inputs(cuda, (1, 88, 64, 2, 1, 32))
    out = ops.flash_attention(q, k, v)
    assert not out[:, :24].any()
    torch.testing.assert_close(out, ref.attention_ref(q, k, v), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(cuda, (1, 8, 8, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="CUDA tensors"):   # mixed devices
        ops.flash_attention(q, k.cpu(), v)
    for hd in (36, 136):
        bad = _flash_inputs(cuda, (1, 8, 8, 2, 1, hd))
        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(*bad)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    # bf16 goes through TMA: strides in multiples of 8 elements (16 bytes)
    # and a 16-byte-aligned start; f32 takes the first view (multiples of 4)
    wide = torch.randn((1, 8, 2, 36), device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_attention(wide.bfloat16()[..., :32], k.bfloat16(),
                            v.bfloat16())
    ops.flash_attention(wide[..., :32], k.float(), v.float())
    shifted = torch.randn((1, 8, 2, 40), device=cuda).bfloat16()[..., 4:36]
    with pytest.raises(ValueError, match="16-byte-aligned start"):
        ops.flash_attention(shifted, k.bfloat16(), v.bfloat16())


# ---------------------------------------------------------------------------
# kernel 9: the SSD scan (2e-4 against its plain version, the tolerance the
# reference holds its own SSD kernel to: f32 sums in another order, and
# exp(cum_t - cum_k) of cumulative decays that cancel most of their digits)
# ---------------------------------------------------------------------------

SSD_SWEEP = [                       # (b, s, nh, hd, ds, chunk)
    (1, 128, 2, 32, 64, 64),
    (2, 256, 4, 64, 128, 128),
    (1, 200, 2, 32, 64, 64),        # ragged: s % chunk != 0
    (2, 64, 8, 64, 128, 64),        # single chunk
    (1, 192, 2, 32, 64, 48),        # chunk not a multiple of a tile
    (2, 96, 3, 128, 16, 256),       # hd 128, chunk cut to s
    (1, 1024, 48, 64, 128, 256, "serving"),  # 4 chunks, A = -(1..48)
    (1, 200, 3, 64, 128, 48),       # ragged, chunk 48 over two key tiles
]


def _ssd_inputs(cuda, b, s, nh, hd, ds, seed=0, dtype=torch.float32,
                decays=None):
    """x ~ N(0, 1), B and C ~ N(0, 0.25), dt = softplus(N(0, 1)); A =
    -exp(linspace(-1, 1)), or the serving path's -(1..nh) with
    ``decays="serving"``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xs = torch.randn((b, s, nh, hd), device=cuda, generator=g)
    bs = torch.randn((b, s, 1, ds), device=cuda, generator=g) * 0.5
    cs = torch.randn((b, s, 1, ds), device=cuda, generator=g) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), device=cuda, generator=g))
    a_coef = -torch.exp(torch.linspace(-1.0, 1.0, nh, device=cuda))
    if decays == "serving":
        a_coef = -torch.arange(1, nh + 1, device=cuda, dtype=torch.float32)
    return xs.to(dtype), bs.to(dtype), cs.to(dtype), dt, a_coef


def _ssd_close(got, want):
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        torch.testing.assert_close(g_, w_, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", SSD_SWEEP)
def test_ssd_scan_kernel_matches_plain(cuda, shape):
    *dims, chunk = shape[:6]
    args = _ssd_inputs(cuda, *dims, seed=sum(shape[:6]),
                       decays=shape[6] if len(shape) > 6 else None)
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    _ssd_close(got, ref.ssd_scan_chunked_ref(*args, chunk=chunk))


def test_ssd_scan_kernel_bf16_strided_and_extremes(cuda):
    # bf16 x, B and C, cast on load as the plain version casts them
    args = _ssd_inputs(cuda, 2, 160, 4, 64, 128, dtype=torch.bfloat16)
    _ssd_close(ops.ssd_scan(*args, chunk=64),
               ref.ssd_scan_chunked_ref(*args, chunk=64))
    # the model's layout: x, B and C are views into one (b, s, conv) tensor
    b, s, nh, hd, ds = 2, 100, 4, 32, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    xbc = torch.randn((b, s, nh * hd + 2 * ds), device=cuda, generator=g)
    xs = xbc[..., :nh * hd].view(b, s, nh, hd)
    bs = xbc[..., nh * hd:nh * hd + ds].view(b, s, 1, ds)
    cs = xbc[..., nh * hd + ds:].view(b, s, 1, ds)
    _, _, _, dt, a_coef = _ssd_inputs(cuda, b, s, nh, hd, ds)
    assert not xs.is_contiguous()
    _ssd_close(ops.ssd_scan(xs, bs, cs, dt, a_coef, chunk=32),
               ref.ssd_scan_chunked_ref(xs, bs, cs, dt, a_coef, chunk=32))
    # dt = 0: y = 0 and state = 0, exactly
    y, st = ops.ssd_scan(xs, bs, cs, torch.zeros_like(dt), a_coef, chunk=32)
    assert not y.any() and not st.any()
    # the serving shape's decays: A = -(1..48), cum in the thousands
    args = _ssd_inputs(cuda, 1, 512, 48, 64, 128, seed=2)
    a48 = -torch.arange(1, 49, device=cuda, dtype=torch.float32)
    _ssd_close(ops.ssd_scan(*args[:4], a48, chunk=256),
               ref.ssd_scan_chunked_ref(*args[:4], a48, chunk=256))


def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    xs, bs, cs, dt, a = _ssd_inputs(cuda, 1, 16, 2, 32, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_cuda(xs.cpu(), bs.cpu(), cs.cpu(), dt.cpu(), a.cpu(),
                      chunk=8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssd_scan(xs.double(), bs.double(), cs.double(), dt, a, chunk=8)
    with pytest.raises(TypeError, match="float32 dt"):
        ops.ssd_scan(xs, bs, cs, dt.bfloat16(), a, chunk=8)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(xs, bs[..., :60], cs[..., :60], dt, a, chunk=8)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.ssd_scan(xs.requires_grad_(True), bs, cs, dt, a, chunk=8)


# ---------------------------------------------------------------------------
# the physical wire: kernels 5-8 (bitwise against their plain versions)
# ---------------------------------------------------------------------------

WIRE_NAMES = ("quantized_gossip_encode", "bucketed_gossip_round",
              "bucketed_gossip_round_pipelined", "quantized_gossip_round")


def _wire_inputs(cuda, m, d, chunk, bits, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qmax = 2 ** (bits - 1) - 1

    def f(scale):
        return torch.randn((m, d), device=cuda, generator=g) * scale

    return dict(
        a=torch.from_numpy(_mixing(m)).to(cuda), w=f(1.0), ref=f(0.5),
        acc=f(0.5), u=torch.rand((m, d), device=cuda, generator=g),
        codes=torch.randint(-qmax, qmax + 1, (m, d), device=cuda,
                            generator=g, dtype=torch.int8),
        scales=torch.rand((m, d // chunk), device=cuda, generator=g)
        * 0.02 + 1e-3)


def _assert_same(got, want):
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        assert torch.equal(g_, w_), int((g_ != w_).sum())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk", [16, 256, 960])
@pytest.mark.parametrize("m", [1, 4, 5, 16])
def test_wire_kernels_match_plain(cuda, m, chunk, bits):
    d = chunk * 37          # 37 chunks: the last slab of a block is ragged
    x = _wire_inputs(cuda, m, d, chunk, bits, seed=m * chunk + bits)
    kw = dict(bits=bits, chunk=chunk)

    def st(*names):         # the kernels update their state in place
        return [x[k].clone() for k in names]

    before = ops.launch_counts()
    _assert_same(ops.quantized_gossip_encode(x["w"], x["ref"], x["u"],
                                             *st("codes", "scales"), **kw),
                 ref.quantized_gossip_encode_ref(x["w"], x["ref"], x["u"],
                                                 **kw))
    state = (x["codes"], x["scales"], x["ref"], x["acc"])
    _assert_same(ops.bucketed_gossip_round(
        x["a"], *st("codes", "scales", "ref", "acc"), x["u"], **kw),
        ref.bucketed_gossip_round_ref(x["a"], *state, x["u"], **kw))
    c, s_, r, acc = st("codes", "scales", "ref", "acc")
    _assert_same(ops.bucketed_gossip_round_pipelined(
        x["a"], c, s_, x["w"], r, acc, x["u"], **kw),
        ref.bucketed_gossip_round_pipelined_ref(
            x["a"], x["codes"], x["scales"], x["w"], x["ref"], x["acc"],
            x["u"], **kw))
    _assert_same(ops.quantized_gossip_round(
        x["a"], *st("codes", "scales", "ref"), torch.empty_like(x["ref"]),
        x["u"], **kw),
        ref.quantized_gossip_round_ref(x["a"], x["codes"], x["scales"],
                                       x["ref"], x["u"], **kw))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert all(after[n] == before[n] + 1 for n in WIRE_NAMES), after


def test_wire_kernels_in_place_and_aliased(cuda):
    """In place, as the wire periods call them: the pipelined round with
    ``acc`` the iterate itself, the round kernels overwriting the codes
    they consume, and the per-leaf round mixing into its own iterate."""
    m, d, chunk = 4, 256 * 40, 256
    x = _wire_inputs(cuda, m, d, chunk, 8, seed=1)
    want = ref.bucketed_gossip_round_pipelined_ref(
        x["a"], x["codes"], x["scales"], x["acc"], x["ref"], x["acc"],
        x["u"], chunk=chunk)
    st = [t.clone() for t in (x["codes"], x["scales"], x["ref"], x["acc"])]
    got = ops.bucketed_gossip_round_pipelined(
        x["a"], st[0], st[1], st[3], st[2], st[3], x["u"], chunk=chunk)
    assert got[0] is st[3] and got[2] is st[0]
    _assert_same(got, want)
    st = [t.clone() for t in (x["codes"], x["scales"], x["ref"], x["acc"])]
    got = ops.bucketed_gossip_round(x["a"], *st, x["u"], chunk=chunk)
    assert got[0] is st[3] and got[1] is st[2]
    _assert_same(got, ref.bucketed_gossip_round_ref(
        x["a"], x["codes"], x["scales"], x["ref"], x["acc"], x["u"],
        chunk=chunk))
    st = [t.clone() for t in (x["codes"], x["scales"], x["ref"], x["w"])]
    got = ops.quantized_gossip_round(x["a"], *st, x["u"], chunk=chunk)
    assert got[0] is st[3] and got[1] is st[2]
    _assert_same(got, ref.quantized_gossip_round_ref(
        x["a"], x["codes"], x["scales"], x["ref"], x["u"], chunk=chunk))


def test_wire_kernels_refuse_what_they_do_not_take(cuda):
    x = _wire_inputs(cuda, 4, 1024, 256, 8, seed=2)
    out = (x["codes"], x["scales"])
    with pytest.raises(ValueError, match="divide D"):
        ops.quantized_gossip_encode(x["w"], x["ref"], x["u"], *out,
                                    chunk=1000)
    with pytest.raises(ValueError, match="bits"):
        ops.quantized_gossip_encode(x["w"], x["ref"], x["u"], *out, bits=3)
    with pytest.raises(TypeError, match="float32"):
        ops.quantized_gossip_encode(x["w"].double(), x["ref"], x["u"], *out)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bucketed_gossip_round(x["a"], x["codes"], x["scales"],
                                  x["ref"].cpu(), x["acc"], x["u"])


def test_wire_dither_on_the_card_matches_the_cpu(cuda):
    from repro_torch.comm import compressors as cp
    from repro_torch.comm import prng
    for n in (1000, (1 << 24) + 17):
        kw = dict(leaf=0, rnd=3, server=2, block=0)
        gpu = cp.wire_dither(prng.key(5), n, device=cuda, **kw)
        assert torch.equal(gpu.cpu(), cp.wire_dither(prng.key(5), n, **kw))


@pytest.mark.parametrize("staleness", [0, 1, 2])
def test_wire_periods_on_the_card_match_the_cpu(cuda, staleness):
    """The port's wire periods with the kernels (card) and with the plain
    versions (CPU), bitwise: bucketed at every staleness, per-leaf too."""
    from repro_torch.comm import compressors as cp
    from repro_torch.comm import prng
    from repro_torch.core import consensus as cns
    g = torch.Generator().manual_seed(staleness)
    tree = {"w": torch.randn((4, 33, 70), generator=g),
            "b": torch.randn((4, 960), generator=g)}
    a = torch.from_numpy(tp.metropolis_weights(tp.ring_graph(4))).float()
    q = cp.StochasticQuantizer(bits=8, chunk=256)
    on_card = {k: v.to(cuda) for k, v in tree.items()}
    for fn, kw in ((cns.gossip_scan_wire_bucketed,
                    dict(staleness=staleness, block=1024)),
                   (cns.gossip_scan_wire, dict(block=1000))):
        if fn is cns.gossip_scan_wire and staleness:
            continue
        want = fn(a, tree, 5, q, prng.key(9), **kw)
        got = fn(a.to(cuda), on_card, 5, q, prng.key(9), **kw)
        for k in tree:
            assert torch.equal(got[k].cpu(), want[k]), k
    # bf16 leaves: the iterate rounded to bf16 each round, bitwise too
    tree16 = {k: v.bfloat16() for k, v in tree.items()}
    want = cns.gossip_scan_wire_bucketed(a, tree16, 5, q, prng.key(9),
                                         staleness=staleness, block=1024)
    got = cns.gossip_scan_wire_bucketed(
        a.to(cuda), {k: v.to(cuda) for k, v in tree16.items()}, 5, q,
        prng.key(9), staleness=staleness, block=1024)
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].cpu(), want[k]), k


# ---------------------------------------------------------------------------
# the simulated wire: kernel 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk", [16, 64, 256, 960])
@pytest.mark.parametrize("m", [1, 4, 5, 16])
def test_quantized_consensus_mix_matches_plain(cuda, m, chunk, bits):
    """Bitwise, on a mixing matrix and on A = I (the round trip itself)."""
    d = chunk * 37          # the last slab of a block is ragged
    x = _wire_inputs(cuda, m, d, chunk, bits, seed=m * chunk + bits + 1)
    before = ops.launch_counts()["quantized_consensus_mix"]
    for a in (x["a"], torch.eye(m, device=cuda)):
        got = ops.quantized_consensus_mix(a, x["w"], x["u"], bits=bits,
                                          chunk=chunk)
        want = ref.quantized_consensus_mix_ref(a, x["w"], x["u"], bits=bits,
                                               chunk=chunk)
        _assert_same((got,), (want,))
    torch.cuda.synchronize()
    assert ops.launch_counts()["quantized_consensus_mix"] == before + 2


def test_quantized_consensus_mix_in_place_and_refusals(cuda):
    x = _wire_inputs(cuda, 4, 256 * 40, 256, 8, seed=3)
    want = ref.quantized_consensus_mix_ref(x["a"], x["w"], x["u"])
    for target in ("w", "u"):
        w, u = x["w"].clone(), x["u"].clone()
        out = w if target == "w" else u
        assert ops.quantized_consensus_mix(x["a"], w, u, out=out) is out
        _assert_same((out,), (want,))
    with pytest.raises(ValueError, match="divide D"):
        ops.quantized_consensus_mix(x["a"], x["w"], x["u"], chunk=1000)
    with pytest.raises(ValueError, match="bits"):
        ops.quantized_consensus_mix(x["a"], x["w"], x["u"], bits=2)
    with pytest.raises(TypeError, match="float32"):
        ops.quantized_consensus_mix(x["a"], x["w"].double(), x["u"])
    buf = torch.zeros(4 * 256 * 40 + 256, device=cuda)
    w = buf[:4 * 256 * 40].view(4, -1)
    with pytest.raises(ValueError, match="overlap"):
        ops.quantized_consensus_mix(x["a"], w, x["u"],
                                    out=buf[256:].view(4, -1))


@pytest.mark.parametrize("mode,spec,ef", [
    ("gossip", "int8", False), ("gossip_blocked", "int4:32", True),
    ("collapsed", "int8", True), ("exact_mean", "int8:64", False),
    ("gossip", "top_k:0.1", True), ("gossip", "random_k:0.2", False)])
def test_simulated_periods_on_the_card_match_the_cpu(cuda, mode, spec, ef):
    """The simulated wire's period with the kernels (card) and the plain
    versions (CPU): kernel 4 and the plain version are bitwise, kernel 1
    sums in another order (1e-5)."""
    from repro_torch.comm import prng
    from repro_torch.core import consensus as cns
    g = torch.Generator().manual_seed(7)
    tree = {"q": torch.randn((4, 6, 64), generator=g) * 0.05,
            "o": torch.randn((4, 5, 300), generator=g) * 0.05,
            "up": torch.randn((4, 2, 512), generator=g) * 0.05,
            "scalar": torch.randn((4,), generator=g)}
    res = ({k: torch.randn(v.shape, generator=g) * 1e-3
            for k, v in tree.items()} if ef else None)
    a = tp.metropolis_weights(tp.ring_graph(4))
    be = cns.make_backend(mode, a, 4, compression=spec, error_feedback=ef,
                          block=512)
    want, want_res = be.mix_compressed(tree, residual=res, key=prng.key(4))
    ops.reset_launch_counts()
    got, got_res = be.mix_compressed(
        {k: v.to(cuda) for k, v in tree.items()},
        residual=None if res is None else {k: v.to(cuda)
                                           for k, v in res.items()},
        key=prng.key(4))
    torch.cuda.synchronize()
    n = ops.launch_counts()["quantized_consensus_mix"]
    assert n == (len(tree) if spec.startswith("int") else 0), n
    for k in tree:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                   atol=1e-6)
        if ef:
            torch.testing.assert_close(got_res[k].cpu(), want_res[k],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["float", "physical_int8_ef"])
def test_replay_probe_launches_on_the_card(cuda, path, tmp_path):
    """The consensus-replay probe of a traced ``train_dynamic`` on the
    card: each epoch launches the step's period and the probe's timed one,
    and each new M one untimed warm-up period (kernel 1 T_S times a
    period; on the physical wire kernel 6 once and kernel 7 T_S times);
    the histories equal the untraced run's bit for bit."""
    from repro_torch.launch import train as ttrain
    t_s = 3
    kw = dict(servers=4, clients=2, t_client=1, t_server=t_s, seq_len=16,
              device="cuda", log=False)
    if path == "float":
        kw.update(epochs=3, participation_rate=0.5, edge_drop_prob=0.3,
                  faults="drop:1:2,rejoin:2:2")
        periods = 3 + 3 + 2             # warm-ups at M = 4 and M = 3
    else:
        kw.update(epochs=2, compression="int8", wire="physical",
                  error_feedback=True)
        periods = 2 + 2 + 1
    plain = ttrain.train_dynamic("smollm-360m", **kw)
    ops.reset_launch_counts()
    traced = ttrain.train_dynamic(
        "smollm-360m", chrome_trace=str(tmp_path / "t.json"), **kw)
    torch.cuda.synchronize()
    n = ops.launch_counts()
    if path == "float":
        assert n["consensus_mix"] == periods * t_s, n
    else:
        assert n["quantized_gossip_encode"] == periods, n
        assert n["bucketed_gossip_round"] == periods * t_s, n
    for k in ("loss", "disagreement", "drift"):
        assert plain["history"][k] == traced["history"][k], k


# ---------------------------------------------------------------------------
# the row forms of kernels 1, 7 and 8 (the multi-process wire): row r of a
# row form is bitwise row r of the square call, and bitwise its plain version
# (kernel 1: within 1e-5 of it, as the square kernel)
# ---------------------------------------------------------------------------

ROW_NAMES = ("consensus_mix_rows", "bucketed_gossip_round_rows",
             "bucketed_gossip_round_pipelined_rows")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 5, 16])
@pytest.mark.parametrize("d", [4096, 1_000_003])
def test_consensus_mix_row_form_is_row_r_of_the_square_call(cuda, m, d,
                                                            dtype):
    g = torch.Generator(device=cuda).manual_seed(m + d)
    dt = getattr(torch, dtype)
    a = torch.from_numpy(_mixing(m)).to(cuda)
    w = torch.randn((m, d), device=cuda, generator=g).to(dt)
    square = ops.consensus_mix(a, w)
    # the bf16 instance counts on its own
    key = ("consensus_mix_rows" if dt == torch.float32
           else "consensus_mix_rows_bf16")
    before = ops.launch_counts()[key]
    spans = [(r, r + 1) for r in range(m)] + ([(1, m)] if m > 2 else [])
    for lo, hi in spans:
        got = ops.consensus_mix_rows(a[lo:hi].contiguous(), w)
        assert got.shape == (hi - lo, d) and got.dtype == dt
        assert torch.equal(got, square[lo:hi]), (lo, hi)
        plain = ref.consensus_mix_ref(a[lo:hi], w)
        if dt == torch.float32:
            assert torch.allclose(got, plain, rtol=1e-5, atol=1e-5)
        else:
            assert _within_one_bf16_rounding(a[lo:hi], w, got)
    torch.cuda.synchronize()
    assert ops.launch_counts()[key] == before + len(spans)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk", [16, 256])
@pytest.mark.parametrize("m", [1, 4, 5, 16])
def test_wire_row_forms_are_row_r_of_the_square_calls(cuda, m, chunk, bits):
    """Kernels 7 and 8 on a rank's row: the gathered codes and scales stay
    as they were, the own state rows and the separate code outputs are the
    square call's row r and the plain versions', bit for bit."""
    d = chunk * 37
    x = _wire_inputs(cuda, m, d, chunk, bits, seed=3 * m + chunk + bits)
    kw = dict(bits=bits, chunk=chunk)

    def st(*names):
        return [x[k].clone() for k in names]

    sq7 = ops.bucketed_gossip_round(x["a"], *st("codes", "scales", "ref",
                                                "acc"), x["u"], **kw)
    sq8 = ops.bucketed_gossip_round_pipelined(
        x["a"], *st("codes", "scales"), x["w"], *st("ref", "acc"), x["u"],
        **kw)
    codes0, scales0 = st("codes", "scales")
    before = ops.launch_counts()
    for r in range(m):
        own = slice(r, r + 1)
        a_r = x["a"][own].contiguous()
        out_c = torch.empty((1, d), dtype=torch.int8, device=cuda)
        out_s = torch.empty((1, d // chunk), device=cuda)
        got = ops.bucketed_gossip_round_rows(
            a_r, x["codes"], x["scales"], x["ref"][own].clone(),
            x["acc"][own].clone(), x["u"][own], out_c, out_s, row0=r, **kw)
        _assert_same(got, [t[own] for t in sq7])
        _assert_same(got, ref.bucketed_gossip_round_rows_ref(
            a_r, x["codes"], x["scales"], x["ref"][own], x["acc"][own],
            x["u"][own], row0=r, **kw))
        got = ops.bucketed_gossip_round_pipelined_rows(
            a_r, x["codes"], x["scales"], x["w"][own],
            x["ref"][own].clone(), x["acc"][own].clone(), x["u"][own],
            torch.empty_like(out_c), torch.empty_like(out_s), **kw)
        _assert_same(got, [t[own] for t in sq8])
        _assert_same(got, ref.bucketed_gossip_round_pipelined_ref(
            a_r, x["codes"], x["scales"], x["w"][own], x["ref"][own],
            x["acc"][own], x["u"][own], **kw))
    _assert_same((x["codes"], x["scales"]), (codes0, scales0))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["bucketed_gossip_round_rows"] == \
        before["bucketed_gossip_round_rows"] + m
    assert after["bucketed_gossip_round_pipelined_rows"] == \
        before["bucketed_gossip_round_pipelined_rows"] + m
    assert all(after[n] == before[n] for n in WIRE_NAMES), after


# ---------------------------------------------------------------------------
# kernel 8's bodies: the resident one (VEC = 4 or 1 columns a thread, one or
# up to four own rows) and the two-pass
# one (more than four own rows, or a chunk wider than a tile), bitwise the
# plain version, the row form bitwise row r of the square call
# ---------------------------------------------------------------------------

K8_CHUNKS = (4, 6, 16, 256, 960, 2048)


def _k8_instance(m_out: int, chunk: int, vec4: bool = True) -> str:
    """The instance ``wire_pipelined_round*_f32`` picks (its C rule)."""
    own = 1 if m_out == 1 else 4
    vec = 4 if vec4 and chunk % 4 == 0 else 1
    tile = 256 * vec * (2 if own == 1 else 1)
    if m_out > 4 or chunk > tile:
        return "twopass"
    return f"vec{vec}.own{own}"


def _k8_square(x, kw, acc_is_w=False):
    c, s_, r = (x[k].clone() for k in ("codes", "scales", "ref"))
    w = x["w"].clone()
    acc = w if acc_is_w else x["acc"].clone()
    got = ops.bucketed_gossip_round_pipelined(x["a"], c, s_, w, r, acc,
                                              x["u"], **kw)
    assert got[0] is acc and got[2] is c and got[3] is s_
    return got


def _k8_counts():
    torch.cuda.synchronize()
    return ops.wire_pipelined_instance_counts()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk", K8_CHUNKS)
@pytest.mark.parametrize("m", [1, 4, 5, 16, 64])
def test_pipelined_round_bodies_match_plain(cuda, m, chunk, bits):
    """Kernel 8 square and row form, in place and with ``acc`` the iterate
    itself, over every instance; one launch a call, counted by instance."""
    nc = max(37, 3 * (2048 // chunk) + 1)   # three slabs or more, ragged
    d = chunk * nc
    x = _wire_inputs(cuda, m, d, chunk, bits, seed=7 * m + chunk + bits)
    kw = dict(bits=bits, chunk=chunk)
    want = ref.bucketed_gossip_round_pipelined_ref(
        x["a"], x["codes"], x["scales"], x["w"], x["ref"], x["acc"], x["u"],
        **kw)
    want_w = ref.bucketed_gossip_round_pipelined_ref(
        x["a"], x["codes"], x["scales"], x["w"], x["ref"], x["w"], x["u"],
        **kw)
    ops.reset_launch_counts()
    sq = _k8_square(x, kw)
    _assert_same(sq, want)
    _assert_same(_k8_square(x, kw, acc_is_w=True), want_w)
    assert _k8_counts() == {_k8_instance(m, chunk): 2}
    codes0, scales0 = x["codes"].clone(), x["scales"].clone()
    for r in sorted({0, m - 1}):
        own = slice(r, r + 1)
        a_r = x["a"][own].contiguous()
        for acc_is_w in (False, True):
            w_r = x["w"][own].clone()
            acc_r = w_r if acc_is_w else x["acc"][own].clone()
            out_c = torch.empty((1, d), dtype=torch.int8, device=cuda)
            out_s = torch.empty((1, nc), device=cuda)
            ops.reset_launch_counts()
            got = ops.bucketed_gossip_round_pipelined_rows(
                a_r, x["codes"], x["scales"], w_r, x["ref"][own].clone(),
                acc_r, x["u"][own], out_c, out_s, **kw)
            assert _k8_counts() == {_k8_instance(1, chunk): 1}
            assert ops.launch_counts()[
                "bucketed_gossip_round_pipelined_rows"] == 1
            _assert_same(got, [t[own] for t in (want_w if acc_is_w
                                                 else want)])
            if not acc_is_w:
                _assert_same(got, [t[own] for t in sq])
    if m >= 2:          # a rank holding two rows
        own = slice(0, 2)
        ops.reset_launch_counts()
        got = ops.bucketed_gossip_round_pipelined_rows(
            x["a"][own].contiguous(), x["codes"], x["scales"], x["w"][own],
            x["ref"][own].clone(), x["acc"][own].clone(), x["u"][own],
            torch.empty((2, d), dtype=torch.int8, device=cuda),
            torch.empty((2, nc), device=cuda), **kw)
        assert _k8_counts() == {_k8_instance(2, chunk): 1}
        _assert_same(got, [t[own] for t in sq])
    _assert_same((x["codes"], x["scales"]), (codes0, scales0))


@pytest.mark.parametrize("form", ["square", "rows"])
def test_pipelined_round_misaligned_operand_takes_vec1(cuda, form):
    """An operand 4 bytes off 16-byte alignment: the C entry point falls
    back to one column a thread, and the result stays bitwise."""
    m, chunk, bits = 4, 256, 8
    d = chunk * 41
    x = _wire_inputs(cuda, m, d, chunk, bits, seed=11)
    kw = dict(bits=bits, chunk=chunk)
    want = ref.bucketed_gossip_round_pipelined_ref(
        x["a"], x["codes"], x["scales"], x["w"], x["ref"], x["acc"], x["u"],
        **kw)
    rows = m if form == "square" else 1
    buf = torch.empty(rows * d + 1, device=cuda)
    u_off = buf[1:].view(rows, d)               # 4 bytes past 16-aligned
    u_off.copy_(x["u"][:rows])
    assert u_off.data_ptr() % 16 == 4
    ops.reset_launch_counts()
    if form == "square":
        got = ops.bucketed_gossip_round_pipelined(
            x["a"], x["codes"].clone(), x["scales"].clone(), x["w"],
            x["ref"].clone(), x["acc"].clone(), u_off, **kw)
        _assert_same(got, want)
        assert _k8_counts() == {_k8_instance(m, chunk, vec4=False): 1}
    else:
        got = ops.bucketed_gossip_round_pipelined_rows(
            x["a"][:1].contiguous(), x["codes"], x["scales"], x["w"][:1],
            x["ref"][:1].clone(), x["acc"][:1].clone(), u_off,
            torch.empty((1, d), dtype=torch.int8, device=cuda),
            torch.empty((1, d // chunk), device=cuda), **kw)
        _assert_same(got, [t[:1] for t in want])
        assert _k8_counts() == {_k8_instance(1, chunk, vec4=False): 1}


@pytest.mark.parametrize("form", ["square", "rows"])
def test_pipelined_round_more_slabs_than_the_grid(cuda, form):
    """D of 8,453 chunks of 256 (more slabs than the persistent grid has
    blocks at up to eight blocks an SM; a ragged last slab): bitwise the
    plain version, in place with ``acc`` the iterate, as the periods call
    it."""
    m, chunk = 4, 256
    nc = 8 * 132 * 8 + 5
    d = chunk * nc
    x = _wire_inputs(cuda, m, d, chunk, 8, seed=12)
    kw = dict(bits=8, chunk=chunk)
    want = ref.bucketed_gossip_round_pipelined_ref(
        x["a"], x["codes"], x["scales"], x["w"], x["ref"], x["w"], x["u"],
        **kw)
    ops.reset_launch_counts()
    if form == "square":
        got = _k8_square(x, kw, acc_is_w=True)
        _assert_same(got, want)
        assert _k8_counts() == {"vec4.own4": 1}
    else:
        r = 2
        own = slice(r, r + 1)
        w_r = x["w"][own].clone()
        got = ops.bucketed_gossip_round_pipelined_rows(
            x["a"][own].contiguous(), x["codes"], x["scales"], w_r,
            x["ref"][own].clone(), w_r, x["u"][own],
            torch.empty((1, d), dtype=torch.int8, device=cuda),
            torch.empty((1, nc), device=cuda), **kw)
        _assert_same(got, [t[own] for t in want])
        assert _k8_counts() == {"vec4.own1": 1}


def test_row_forms_refuse_what_they_do_not_take(cuda):
    x = _wire_inputs(cuda, 4, 1024, 256, 8, seed=4)
    own = slice(1, 2)
    out_c = torch.empty((1, 1024), dtype=torch.int8, device=cuda)
    out_s = torch.empty((1, 4), device=cuda)
    args = (x["a"][own].contiguous(), x["codes"], x["scales"],
            x["ref"][own].clone(), x["acc"][own].clone(), x["u"][own])
    with pytest.raises(ValueError, match="row0"):
        ops.bucketed_gossip_round_rows(*args, out_c, out_s, row0=4)
    with pytest.raises(ValueError, match="must not overlap"):
        ops.bucketed_gossip_round_rows(*args, x["codes"][own], out_s,
                                       row0=1)
    with pytest.raises(ValueError, match="must be a contiguous"):
        ops.bucketed_gossip_round_rows(x["a"], *args[1:], out_c, out_s,
                                       row0=1)
    with pytest.raises(ValueError, match="rows"):
        ops.consensus_mix_rows(torch.ones((5, 4), device=cuda), x["w"])
