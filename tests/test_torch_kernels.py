"""Port parity for the kernels' plain versions and the device dispatch.

On the CPU: the port's plain ``consensus_mix_ref`` / ``rmsnorm_ref`` (and
the closed-form RMSNorm backward the CUDA kernel computes) /
``attention_ref`` against the JAX package's Pallas kernels in interpret
mode, its jnp oracles and ``jax.grad``; ``ops.*`` on CPU tensors runs the plain version and launches
nothing; kernel 3's bf16 arithmetic (P rounded to bf16 for the tensor
cores) emulated against ``attention_ref`` at the card's per-row limit.  The
Hopper kernels themselves are held against the plain versions on the card
by ``tests/test_torch_kernels_cuda.py``.

Tolerances: f32 contractions and reductions summed in another order than
XLA's — rtol/atol 2e-5 on O(1) data, as ``tests/test_kernels_misc.py``
uses for the Pallas kernels themselves.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.consensus import collapse_mixing as j_collapse  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.consensus_mix import consensus_mix_2d  # noqa: E402
from repro.kernels.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.ref import consensus_mix_ref as j_mix_ref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_2d  # noqa: E402
from repro.models.modules import rmsnorm_apply  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _mixing(m: int) -> np.ndarray:
    if m == 1:
        return np.ones((1, 1), np.float32)
    a = j_collapse(jtp.metropolis_weights(jtp.ring_graph(m)), 3)
    return a.astype(np.float32)


@pytest.mark.parametrize("m", [1, 4, 5])
@pytest.mark.parametrize("d", [1000, 4099])
def test_consensus_mix_plain_matches_pallas_and_oracle(m, d):
    rng = np.random.default_rng(m * 7 + d)
    a = _mixing(m)
    w = rng.standard_normal((m, d)).astype(np.float32)
    port = ref.consensus_mix_ref(torch.from_numpy(a), torch.from_numpy(w))
    pallas = consensus_mix_2d(jnp.asarray(a), jnp.asarray(w), block_d=512,
                              interpret=True)
    oracle = j_mix_ref(jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("rows,d", [(7, 64), (32, 120), (256, 960),
                                    (5, 128), (3, 1536), (2, 2048),
                                    (2, 3072)])
def test_rmsnorm_plain_matches_pallas_and_module(rows, d):
    rng = np.random.default_rng(rows + d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    port = ref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(s))
    pallas = rmsnorm_2d(jnp.asarray(x), jnp.asarray(s), block_rows=rows,
                        interpret=True)
    module = rmsnorm_apply({"scale": jnp.asarray(s)}, jnp.asarray(x))
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(module), **TOL)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Most bf16 steps between two bf16 arrays (as int16 bit patterns)."""
    def ordered(bits):
        bits = bits.astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("rows,d", [(6, 128), (4, 960), (2, 2048)])
def test_rmsnorm_plain_matches_pallas_and_module_bf16(rows, d):
    """bf16 in and out, f32 inside: the plain version within one bf16 step
    of the Pallas kernel and the module (both round once, from f32 values
    whose rsqrt and sum order differ in the last f32 bits)."""
    rng = np.random.default_rng(rows * d)
    x = jnp.asarray(rng.standard_normal((rows, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    s = jnp.asarray((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
                    ).astype(jnp.bfloat16)

    def bf16(a):
        return torch.from_numpy(np.asarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16)
    port = ref.rmsnorm_ref(bf16(x), bf16(s))
    assert port.dtype == torch.bfloat16
    port_bits = port.view(torch.int16).numpy()
    pallas = rmsnorm_2d(x, s, block_rows=rows, interpret=True)
    module = rmsnorm_apply({"scale": s}, x)
    for other in (pallas, module):
        assert other.dtype == jnp.bfloat16
        assert _bf16_ulps(port_bits, np.asarray(other).view(np.int16)) <= 1


@pytest.mark.parametrize("rows,d", [(5, 64), (48, 120)])
def test_rmsnorm_backward_matches_jax_grad(rows, d):
    """Autograd of the plain version AND the closed-form backward (the
    CUDA kernel's formula) against ``jax.grad`` of the module's norm.
    Tolerance 1e-4: gradients sum d products in another order."""
    rng = np.random.default_rng(rows * d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)

    def jloss(xx, ss):
        return jnp.sum(rmsnorm_apply({"scale": ss}, xx) * g)

    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    adx, ads = torch.autograd.grad(ref.rmsnorm_ref(tx, ts),
                                   (tx, ts), torch.from_numpy(g))
    cdx, cds = ref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(g))
    for dx, ds in ((adx, ads), (cdx, cds)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ds.numpy(), np.asarray(jds),
                                   rtol=1e-4, atol=1e-4)


def test_ops_on_cpu_use_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_mixing(4))
    w = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    out = torch.empty_like(w)
    assert ops.consensus_mix(a, w, out=out) is out
    assert torch.equal(out, ref.consensus_mix_ref(a, w))
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    s = torch.ones(40)
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    q = torch.from_numpy(rng.standard_normal((1, 5, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 7, 1, 8)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, k, k, window=3),
                       ref.attention_ref(q, k, k, window=3))
    u = torch.from_numpy(rng.uniform(0, 1, (4, 300)).astype(np.float32))
    assert torch.equal(ops.quantized_consensus_mix(a, w, u, chunk=60),
                       ref.quantized_consensus_mix_ref(a, w, u, chunk=60))
    xs = torch.from_numpy(rng.standard_normal((1, 9, 2, 4)).astype(np.float32))
    bs = torch.from_numpy(rng.standard_normal((1, 9, 1, 8)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0, 1, (1, 9, 2)).astype(np.float32))
    a_coef = -torch.ones(2)
    for got, want in zip(
            ops.ssd_scan(xs, bs, bs, dt, a_coef, chunk=4),
            ref.ssd_scan_chunked_ref(xs, bs, bs, dt, a_coef, chunk=4)):
        assert torch.equal(got, want)
    # kernel 1's row form (the multi-process wire) takes its plain version
    # on the CPU too
    assert torch.equal(ops.consensus_mix_rows(a[1:2], w),
                       ref.consensus_mix_ref(a[1:2], w))
    assert ops.launch_counts() == {"consensus_mix": 0, "flash_attention": 0,
                                   "rmsnorm_fwd": 0, "rmsnorm_bwd": 0,
                                   "ssd_scan": 0,
                                   "quantized_consensus_mix": 0,
                                   "quantized_gossip_encode": 0,
                                   "bucketed_gossip_round": 0,
                                   "bucketed_gossip_round_pipelined": 0,
                                   "quantized_gossip_round": 0,
                                   "consensus_mix_rows": 0,
                                   "consensus_mix_rows_bf16": 0,
                                   "bucketed_gossip_round_rows": 0,
                                   "bucketed_gossip_round_pipelined_rows": 0}
    assert ops.flash_attention_mode_counts() == {}


def test_flash_attention_mode_counts_key_and_reset():
    """Kernel 3 counts its launches by mode where it launches; the key names
    dtype, group, head_dim, causal, window and softcap, and a reset clears
    the tally with the counts."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.mode_key(torch.bfloat16, 2, 128, True, 4096, 50.0) == \
        "bfloat16/2/128/True/4096/50.0"
    assert fa.mode_key(torch.float32, 1, 64, False, None, None) == \
        "float32/1/64/False/None/None"
    fa.mode_launches["float32/1/64/False/None/None"] = 3
    assert ops.flash_attention_mode_counts() == {
        "float32/1/64/False/None/None": 3}
    ops.reset_launch_counts()
    assert ops.flash_attention_mode_counts() == {}


def _cut_rows_norm(x, s, g, tp):
    """The cut-row norm's plain passes over ``tp`` column pieces of x, the
    rows' statistics summed over the pieces as the ranks' all-reduce sums
    them -> (y, dx, dscale) with the pieces' columns put back together."""
    d = x.shape[1]
    xs, ss_, gs = x.chunk(tp, dim=1), s.chunk(tp), g.chunk(tp, dim=1)
    sq = sum(ops.rmsnorm_sumsq(xp, sp) for xp, sp in zip(xs, ss_))
    fwd = [ops.rmsnorm_given(xp, sp, 1e-6, sq, d) for xp, sp in zip(xs, ss_)]
    dot = sum(ops.rmsnorm_dot(xp, sp, r, gp)
              for xp, sp, gp, (_, r) in zip(xs, ss_, gs, fwd))
    bwd = [ops.rmsnorm_given_bwd(xp, sp, r, gp, dot, d)
           for xp, sp, gp, (_, r) in zip(xs, ss_, gs, fwd)]
    return (torch.cat([y for y, _ in fwd], dim=1),
            torch.cat([dx for dx, _ in bwd], dim=1),
            torch.cat([ds for _, ds in bwd]))


@pytest.mark.parametrize("rows,d,tp", [(5, 64, 2), (48, 120, 4)])
def test_rmsnorm_cut_rows_plain_matches_jax_grad(rows, d, tp):
    """Rows cut over ``tp`` ranks (Mamba's gated norm under tensor
    parallelism): the plain statistics and given-statistics passes, summed
    over the pieces, give the module's norm (1e-5) and ``jax.grad`` of it
    (1e-4: sums in another order) on the whole rows."""
    rng = np.random.default_rng(rows * d + tp)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)

    def jloss(xx, ss):
        return jnp.sum(rmsnorm_apply({"scale": ss}, xx) * g)

    jy = rmsnorm_apply({"scale": jnp.asarray(s)}, jnp.asarray(x))
    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    ops.reset_launch_counts()
    y, dx, ds = _cut_rows_norm(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(g), tp)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-4,
                               atol=1e-4)
    assert not any(ops.launch_counts().values())


def test_rmsnorm_kernels_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor raises (``ops``
    sends CPU tensors to the plain version before reaching them)."""
    x, s = torch.ones((4, 8)), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_fwd_cuda(x, s, 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd_cuda(x, s, torch.ones(4), x)
    assert rn.fwd_launches == 0 and rn.bwd_launches == 0


def test_rmsnorm_cut_row_kernels_refuse_cpu_tensors():
    """The statistics launches and the given-statistics passes never fall
    back either."""
    x, s, r = torch.ones((4, 8)), torch.ones(8), torch.ones(4)
    for call in (lambda: rn.rmsnorm_sumsq_cuda(x, s),
                 lambda: rn.rmsnorm_dot_cuda(x, s, r, x),
                 lambda: rn.rmsnorm_fwd_cuda(x, s, 1e-6, ss=r, d_norm=16),
                 lambda: rn.rmsnorm_bwd_cuda(x, s, r, x, dot=r, d_norm=16)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert rn.fwd_launches == 0 and rn.bwd_launches == 0


def test_build_lists_every_cuda_source():
    assert _build.sources() == ["consensus_mix", "flash_attention",
                                "quantized_mix", "quantized_wire",
                                "rmsnorm", "ssd_scan"]


def test_no_port_module_imports_triton():
    """Every kernel of the port is CUDA C++ bound with ctypes: no module
    imports ``triton``, at top level or inside a function."""
    root = pathlib.Path(ops.__file__).resolve().parents[1]
    found = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            found += [f"{path.name}:{node.lineno}" for n in names
                      if n.split(".")[0] == "triton"]
    assert len(list(root.rglob("*.py"))) > 20
    assert not found, found


@pytest.mark.parametrize("rounds,block", [(1, None), (4, None), (3, 7),
                                          (0, None)])
def test_consensus_mix_pytree_matches_per_leaf_rounds(rounds, block):
    """The flattened ping-pong path equals ``rounds`` per-leaf rounds of the
    reference's ``consensus_mix_ref`` oracle (f32 tolerance)."""
    rng = np.random.default_rng(rounds)
    a = _mixing(5)
    tree = {"w": rng.standard_normal((5, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((5, 6)).astype(np.float32),
            "n": (rng.standard_normal((5, 2, 2)).astype(np.float32),)}
    port = ops.consensus_mix_pytree(
        torch.from_numpy(a), jax.tree.map(torch.from_numpy, tree),
        rounds=rounds, block=block)
    want = jax.tree.map(jnp.asarray, tree)
    for _ in range(rounds):
        want = jax.tree.map(lambda leaf: j_mix_ref(
            jnp.asarray(a), leaf.reshape(5, -1)).reshape(leaf.shape), want)
    for got, exp in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), port)), jax.tree.leaves(want)):
        np.testing.assert_allclose(got, np.asarray(exp), **TOL)


def test_consensus_mix_pytree_refuses_non_f32():
    """Kernel 1 has an f32 and a bf16 instance: other leaf dtypes raise (a
    bf16 tree now mixes; ``test_torch_consensus.py`` holds it to the
    reference)."""
    for dtype in (torch.float16, torch.float64):
        tree = {"w": torch.zeros((2, 3), dtype=dtype)}
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.consensus_mix_pytree(torch.eye(2), tree)
    tree = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
    assert ops.consensus_mix_pytree(torch.eye(2), tree)["w"].dtype == \
        torch.bfloat16


def _qkv(seed, b, sq, sk, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, hd)).astype(np.float32))


# (b, sq, sk, h, kvh, hd) and options: a subset of the reference's sweep
# (tests/test_kernels_attention.py) at CPU-test sizes
ATTN_CASES = [
    ((1, 64, 64, 4, 4, 32), {}),                                 # MHA
    ((2, 64, 64, 8, 2, 16), {}),                                 # GQA 4:1
    ((1, 64, 64, 4, 1, 40), {}),                                 # MQA, hd 40
    ((2, 32, 96, 4, 2, 16), {}),                                 # sq < sk
    ((1, 50, 50, 3, 3, 32), {}),                                 # ragged
    ((1, 64, 66, 2, 2, 16), {}),                                 # ragged keys
    ((2, 1, 128, 4, 2, 16), {}),                                 # sq = 1
    ((1, 64, 64, 4, 2, 16), {"window": 16}),
    ((1, 64, 64, 2, 2, 16), {"softcap": 20.0}),
    ((1, 64, 64, 2, 2, 16), {"causal": False}),
    ((1, 64, 64, 4, 2, 16), {"window": 24, "softcap": 30.0}),
]


@pytest.mark.parametrize("shape,kw", ATTN_CASES,
                         ids=["x".join(map(str, s)) + "".join(
                             f"-{k}{v}" for k, v in kw.items())
                             for s, kw in ATTN_CASES])
def test_attention_ref_matches_pallas_and_oracle(shape, kw):
    """The port's plain flash attention against the reference's Pallas
    kernel (interpret mode, 32-row blocks so the k loop has several steps)
    and its jnp oracle; no row here is fully masked.  rtol/atol 2e-5, 5e-5
    with a softcap (the reference's own tolerances)."""
    q, k, v = _qkv(sum(shape), *shape)
    tol = 5e-5 if "softcap" in kw else 2e-5
    port = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    pallas = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=32, block_k=32,
                                   **kw)
    oracle = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(port.numpy(), np.asarray(oracle),
                               rtol=tol, atol=tol)


def test_attention_ref_fully_masked_rows_are_zero_as_in_the_kernel():
    """sq > sk under causality: the first sq - sk queries see no key.  The
    TPU kernel's l == 0 guard makes them 0, and so does the port; the
    reference's jnp oracle averages v there, so it is compared on the other
    rows only."""
    q, k, v = _qkv(5, 1, 48, 40, 2, 1, 16)
    port = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v)).numpy()
    pallas = np.asarray(j_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
        block_k=16))
    oracle = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v)))
    assert not port[:, :8].any()
    np.testing.assert_allclose(port, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port[:, 8:], oracle[:, 8:], rtol=2e-5,
                               atol=2e-5)


def test_attention_ref_bf16_keeps_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(6, 1, 32, 32, 2, 1, 16))
    out = ref.attention_ref(q, k, v)
    assert out.dtype == torch.bfloat16
    want = ref.attention_ref(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# kernel 3's bf16 instance: its rounding argument on the CPU
# ---------------------------------------------------------------------------

# the zoo's bf16 modes at a reduced length (3 key tiles of 128, a window of
# 160 that cuts them), their groups and head_dim as published: (b, s, h,
# kvh, hd), options
BF16_ZOO_MODES = {
    "gemma2_local": ((1, 384, 4, 2, 128), {"window": 160, "softcap": 50.0}),
    "gemma2_global": ((1, 384, 4, 2, 128), {"softcap": 50.0}),
    "command_r": ((1, 384, 16, 2, 128), {}),
    "mixtral": ((1, 384, 12, 2, 128), {"window": 160}),
}
# the card's per-row limit (tests/test_torch_kernels_cuda.py, chip_smoke.py)
BF16_ROW_LIMIT = 2.0 ** -7 + 1e-3


def _emulate_bf16_kernel(q, k, v, *, causal=True, window=None,
                         softcap=None, tile=128):
    """The bf16 instance's arithmetic, written out: f32 scores of the bf16
    operands, the scale (and the softcap) on the f32 scores, an online
    softmax over key tiles whose P is rounded to bf16 for the product and
    whose l sums the ROUNDED P, O in f32 divided by l once.  Returns O in
    f32 (b, sq, h, hd) before its one rounding to bf16."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kf = torch.repeat_interleave(k.float(), h // kvh, dim=2)
    vf = torch.repeat_interleave(v.float(), h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / hd ** 0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    m = torch.full((b, h, sq), float("-inf"))
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, hd))
    for k0 in range(0, sk, tile):
        st = s[..., k0:k0 + tile]
        mn = torch.maximum(m, st.amax(-1))
        mu = torch.where(mn == float("-inf"), torch.zeros(()), mn)
        al = torch.exp(m - mu)
        p = torch.exp(st - mu[..., None]).bfloat16().float()
        l = al * l + p.sum(-1)
        o = al[..., None] * o + torch.einsum("bhqk,bkhd->bhqd", p,
                                             vf[:, k0:k0 + tile])
        m = mn
    o = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None],
                    torch.zeros(()))
    return o.transpose(1, 2)


def _rows_rel(got, want) -> float:
    """The largest error of a row over that row's largest |value|."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", sorted(BF16_ZOO_MODES))
def test_bf16_flash_rounding_within_the_row_limit(mode, one_torch_thread):
    """The bf16 instance's rounding of P (up to 2^-8 of each weight, l from
    the rounded P) moves a row's f32 output by less than 2^-8 of the row's
    largest value, one bf16 rounding unit, so after each side's one rounding
    to bf16 the two lie within one bf16 step (2^-7 of the row's largest
    value) and the kernel's arithmetic meets BF16_ROW_LIMIT against
    ``attention_ref`` on every row -- the limit the card holds the kernel
    to.  ``attention_ref`` is held against the reference's Pallas kernel
    (interpret mode) on the same inputs.  With a softcap q is scaled by 8,
    as on the card, so the scores reach the cap's bend."""
    (b, s, h, kvh, hd), kw = BF16_ZOO_MODES[mode]
    q, k, v = _qkv(sum(map(ord, mode)), b, s, s, h, kvh, hd)
    if "softcap" in kw:
        q = q * 8.0
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    want32 = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    pallas = j_ops.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), block_q=128,
        block_k=128, **kw)
    tol = 5e-5 if "softcap" in kw else 2e-5
    np.testing.assert_allclose(want32.numpy(), np.asarray(pallas), rtol=tol,
                               atol=tol)
    got32 = _emulate_bf16_kernel(q, k, v, **kw)
    assert 0 < _rows_rel(got32, want32) < 2.0 ** -8   # P was rounded
    got = got32.bfloat16()
    assert _rows_rel(got, ref.attention_ref(q, k, v, **kw)) <= BF16_ROW_LIMIT
