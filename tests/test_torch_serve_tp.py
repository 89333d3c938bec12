"""Serving tensor parallel over "model" on the serve mesh ("data",
"model"): the rank-local prefill and decode of ``launch.serve`` on one
spawned world of 4 gloo ranks, held against the JAX package's
``prefill`` / ``decode_step`` (its reference route) and the port's one
process on the same weights and prompts.

Each rank takes its pieces of the whole weights (``serve_pieces``:
``local_shard`` under ``serve_param_specs`` without FSDP over "data") and
its rows of the batch over "data" (``batch_rows``), prefills a short
prompt on the kernel route (kernel 3's plain version here) and runs 4
decode steps teacher-forced on the reference's greedy tokens; each step's
logits are its vocab slice, gathered whole (``tp_logits``).  The cases:

* ``qwen3_14``: qwen3-smoke (4 q / 2 kv heads) on (1, 4): the 2 kv heads
  do not divide the axis, so each rank's ``w_k`` / ``w_v`` and cache hold
  the kv head its q head reads (``serve_pieces``), gathered by no pass;
* ``qwen3_22``: qwen3-smoke on (2, 2): the batch over "data", 2 q / 1 kv
  heads a rank;
* ``seamless_22``: seamless-smoke on (2, 2), its encoder and the cross
  cache on the rank's heads;
* ``internvl2_14``: internvl2-smoke replaced on both sides to 6 heads and
  2 kv heads, on (1, 4): the heads do not divide the axis, so the
  attention runs whole on every rank (``attn_tp=False``), the MLP and the
  vocab cut, the cache every head;
* ``gemma2_22``: gemma2-smoke on (2, 2) with a 40-token prompt past its
  window of 32: the local layer's ring (``_ring_pack``) on a rank's heads.

Held: the prefill's and each step's assembled logits, and the assembled
cache after the prefill and after the last step (``models.modules.
tp_kv_range`` places each rank's kv heads; heads held by several ranks
are bitwise equal), against the reference (logits 1e-4, cache 1e-5, as
``tests/test_torch_serve.py`` holds the one-process port) and the port's
one process (``ONE_TOL``); every TP site's calls and bytes to the byte;
the control, each rank's cache cut one kv head off (its kv heads shifted
by one), misses.  ``serve(mesh=)``'s tokens equal one process's ``serve``
on the same draws, greedy and at a temperature.
"""
import dataclasses
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
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.configs.base import MambaConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.tp import ModelParallel  # noqa: E402
from repro_torch.models import modules as tnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

B, S, STEPS = 4, 12, 4
F32 = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
#: the one-process port against the TP ranks: the row-parallel sums regroup
#: f32 contractions (measured <= 2.2e-6 on the logits, 2.5e-6 against the
#: reference)
ONE_TOL = dict(rtol=1e-5, atol=1e-5)
J_OPTS = jtf.ApplyOptions(remat=False)
T_OPTS = ttf.ApplyOptions(attn_impl="kernel")
# case -> (arch, serve mesh ("data", "model"), prompt length, config
# replacements on both sides)
CASES = {
    "qwen3_14": ("qwen3-1.7b", (1, 4), S, {}),
    "qwen3_22": ("qwen3-1.7b", (2, 2), S, {}),
    "seamless_22": ("seamless-m4t-large-v2", (2, 2), S, {}),
    "internvl2_14": ("internvl2-1b", (1, 4), S,
                     {"num_heads": 6, "num_kv_heads": 2}),
    "gemma2_22": ("gemma2-27b", (2, 2), 40, {}),
}
#: ``serve(mesh=)`` against one process's ``serve``, greedy: arch -> mesh
ON_MESH = {"qwen3-1.7b": (2, 2), "seamless-m4t-large-v2": (1, 4)}
#: ... and at a temperature, on a mesh whose "data" splits the batch
SAMPLED = ("qwen3-1.7b", (2, 2), 0.8)
SERVE_KW = dict(batch=B, prompt_len=8, gen=5, device="cpu")


def configs(case: str):
    arch, _, _, rep = CASES[case]
    return (dataclasses.replace(j_get_smoke(arch), **rep),
            dataclasses.replace(get_smoke(arch), **rep))


def extra(cfg) -> int:
    fe = cfg.frontend
    return fe.num_tokens if fe is not None and fe.kind == "vision_patches" \
        else 0


def max_len(case: str) -> int:
    return CASES[case][2] + extra(configs(case)[1]) + STEPS + 1


@functools.lru_cache(maxsize=None)
def np_params(case: str) -> dict:
    jparams = jtf.init_params(jax.random.key(11), configs(case)[0])
    return jax.tree.map(np.asarray, jparams)


@functools.lru_cache(maxsize=None)
def batch_for(case: str) -> dict:
    cfg, s = configs(case)[1], CASES[case][2]
    rng = np.random.default_rng(len(case))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s))}
    if cfg.frontend is not None:
        name = ("patch_embeds" if cfg.frontend.kind == "vision_patches"
                else "frames")
        n = cfg.frontend.num_tokens or s
        out[name] = (rng.standard_normal((B, n, cfg.d_model)) * 0.02
                     ).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(case: str):
    """The JAX package's prefill and STEPS greedy decode steps: the
    logits of each, the greedy tokens fed, and the caches after the
    prefill and after the last step (numpy)."""
    jcfg = configs(case)[0]
    jparams = jax.tree.map(jnp.asarray, np_params(case))
    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
             for k, v in batch_for(case).items()}
    logits, cache = jax.jit(lambda p, b: jtf.prefill(
        p, jcfg, b, max_len=max_len(case), cache_dtype=jnp.float32,
        opts=J_OPTS))(jparams, batch)
    step = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
    out, toks = [np.asarray(logits)], []
    first = jax.tree.map(np.asarray, cache)
    for _ in range(STEPS):
        nxt = np.array(jnp.argmax(logits[:, -1], -1))[:, None]
        toks.append(nxt)
        logits, cache = step(jparams, jnp.asarray(nxt, jnp.int32), cache)
        out.append(np.asarray(logits))
    return out, np.concatenate(toks, 1), first, jax.tree.map(np.asarray,
                                                              cache)


@functools.lru_cache(maxsize=None)
def one_process(case: str):
    """The port's one process on the whole weights and batch, fed the
    reference's tokens: logits of the prefill and each step, the caches
    (leaves of ``cache["stack"]``) after the prefill and the last step."""
    cfg = configs(case)[1]
    params = ttf.params_from_numpy(np_params(case))
    logits, cache = ttf.prefill(params, cfg, _t(batch_for(case)),
                                max_len=max_len(case),
                                cache_dtype=torch.float32, opts=T_OPTS)
    out = [logits]
    first = [x.clone() for x in tree_flatten(cache["stack"])[0]]
    toks = torch.from_numpy(reference(case)[1])
    for i in range(STEPS):
        logits, cache = ttf.decode_step(params, cfg, toks[:, i:i + 1], cache)
        out.append(logits)
    return out, first, tree_flatten(cache["stack"])[0]


# the script the ranks run: torch and repro_torch only
WORLD = textwrap.dedent('''
    import os
    import sys
    import time
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def main(rank, out, rdv, spec_path):
        torch.set_num_threads(1)
        spec = torch.load(spec_path, weights_only=False)
        dist.init_process_group("gloo", init_method="file://" + rdv,
                                world_size=4, rank=rank)
        try:
            res = {name: run_case(spec, spec_path, name, *case)
                   for name, case in spec["cases"].items()}
            res["on_mesh"] = {arch: on_mesh(spec, arch, shape)
                              for arch, shape in spec["on_mesh"].items()}
            arch, shape, temp = spec["sampled"]
            res["sampled"] = on_mesh(spec, arch, shape, temperature=temp)
            assert not [n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")]
            torch.save(res, out + f".{rank}")
        finally:
            dist.destroy_process_group()


    def fed_tokens(spec_path, name):
        """The reference's greedy tokens, written by the test process
        while the world starts."""
        path = spec_path + "." + name + ".tokens"
        deadline = time.time() + 200
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(path)
            time.sleep(0.05)
        return torch.load(path)


    def run_case(spec, spec_path, name, arch, shape, _s, rep):
        import dataclasses
        from repro_torch.configs import get_smoke
        from repro_torch.core import consensus as cns
        from repro_torch.launch import serve as sv
        from repro_torch.launch.mesh import RankMesh
        from repro_torch.models import modules as nn
        from repro_torch.models import transformer as tf
        from repro_torch.tree import tree_flatten, tree_unflatten
        cfg = dataclasses.replace(get_smoke(arch), **rep)
        mesh = RankMesh(("data", "model"), shape)
        params = tf.params_from_numpy(spec["params"][name])
        pieces, tp = sv.serve_pieces(params, cfg, mesh)
        lo, hi = sv.batch_rows(mesh, spec["b"])
        mine = {k: torch.from_numpy(v[lo:hi])
                for k, v in spec["batches"][name].items()}
        opts = tf.ApplyOptions(attn_impl="kernel", tp=tp)
        kw = dict(max_len=spec["max_len"][name], cache_dtype=torch.float32)
        cns.reset_collective_counts()
        logits, cache = tf.prefill(pieces, cfg, mine, opts=opts, **kw)
        got = [tp.gather_logits(logits)]
        first = [x.clone() for x in tree_flatten(cache["stack"])[0]]
        toks = fed_tokens(spec_path, name)[lo:hi]
        for i in range(spec["steps"]):
            logits, cache = tf.decode_step(pieces, cfg, toks[:, i:i + 1],
                                           cache, tp=tp)
            got.append(tp.gather_logits(logits))
        counts = cns.collective_counts()
        # the control: one process's cache of these rows, each attention
        # leaf cut to the rank's kv heads shifted by one
        _, whole = tf.prefill(params, cfg, mine,
                              opts=tf.ApplyOptions(attn_impl="kernel"), **kw)
        kv_lo, kv_hi = nn.tp_kv_range(cfg, nn.attention_tp(tp))
        shifted = (torch.arange(kv_lo, kv_hi) + 1) % cfg.num_kv_heads
        leaves, treedef = tree_flatten(whole)
        leaves = [x.index_select(x.dim() - 2, shifted).contiguous()
                  if x.dim() >= 4 else x for x in leaves]
        control = tree_unflatten(treedef, leaves)
        ctl = []
        for i in range(spec["steps"]):
            logits, control = tf.decode_step(pieces, cfg, toks[:, i:i + 1],
                                             control, tp=tp)
            ctl.append(tp.gather_logits(logits))
        return dict(coords=mesh.coords(), rows=(lo, hi),
                    attn_tp=tp.attn_tp, logits=got, control=ctl,
                    first=first,
                    last=[x.clone() for x in tree_flatten(cache["stack"])[0]],
                    collectives=counts)


    def on_mesh(spec, arch, shape, temperature=0.0):
        """The entry point on this rank: ``serve(mesh=)``."""
        from repro_torch.launch import serve as sv
        from repro_torch.launch.mesh import RankMesh
        res = sv.serve(arch, mesh=RankMesh(("data", "model"), shape),
                       temperature=temperature, **spec["serve_kw"])
        return {"generated": res["generated"], "rows": res["rows"]}


    if __name__ == "__main__":
        mp.spawn(main, args=(sys.argv[1], sys.argv[2], sys.argv[3]),
                 nprocs=4)
''')


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks, by rank.  The
    reference's greedy tokens go to the ranks through files as each case's
    reference is computed; the one-process references follow while the
    world runs."""
    d = tmp_path_factory.mktemp("serve_tp_world")
    script, out, spec_path = d / "world.py", d / "out.pt", d / "spec.pt"
    script.write_text(WORLD)
    spec = dict(b=B, steps=STEPS, cases=CASES, on_mesh=ON_MESH,
                sampled=SAMPLED, serve_kw=SERVE_KW,
                params={c: np_params(c) for c in CASES},
                batches={c: batch_for(c) for c in CASES},
                max_len={c: max_len(c) for c in CASES})
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
            path = f"{spec_path}.{case}.tokens"
            torch.save(torch.from_numpy(reference(case)[1]), path + ".tmp")
            os.replace(path + ".tmp", path)
        for case in CASES:
            one_process(case)
        for arch in ON_MESH:
            serve_one(arch)
        serve_one(SAMPLED[0], SAMPLED[2])
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(4)]


@functools.lru_cache(maxsize=None)
def serve_one(arch: str, temperature: float = 0.0):
    """One process's ``serve``'s tokens."""
    return tserve.serve(arch, temperature=temperature,
                        **SERVE_KW)["generated"]


def rows_logits(world, case: str, key: str) -> list:
    """Per step, the whole batch's logits from the ranks' rows (each rank
    of a model group holds the same gathered rows: asserted bitwise)."""
    out = []
    for i in range(len(world[0][case][key])):
        whole = [None] * B
        for w in world:
            lo, hi = w[case]["rows"]
            x = w[case][key][i]
            for r in range(lo, hi):
                if whole[r] is None:
                    whole[r] = x[r - lo]
                else:
                    assert torch.equal(whole[r], x[r - lo]), (case, i, r)
        out.append(torch.stack(whole))
    return out


def assembled_cache(world, case: str, key: str) -> list:
    """The whole cache's leaves (``cache["stack"]``) from every rank's:
    its rows over "data" and its kv heads (``tp_kv_range``); a slot held
    by several ranks is bitwise the same on each."""
    cfg = configs(case)[1]
    size = CASES[case][1][1]
    n = len(world[0][case][key])
    out = []
    for i in range(n):
        parts = []
        for w in world:
            lo, hi = w[case]["rows"]
            mp = ModelParallel(None, w[case]["coords"]["model"], size,
                               w[case]["attn_tp"])
            parts.append((lo, hi, tnn.tp_kv_range(cfg, tnn.attention_tp(mp)),
                          w[case][key][i]))
        x0 = parts[0][3]
        heads = x0.dim() >= 4
        shape = list(x0.shape)
        shape[1] = B
        if heads:
            shape[-2] = cfg.num_kv_heads
        whole = torch.full(shape, float("nan")) if x0.is_floating_point() \
            else torch.full(shape, -7, dtype=x0.dtype)
        for lo, hi, (kv_lo, kv_hi), x in parts:
            idx = (slice(None), slice(lo, hi)) + (
                (Ellipsis, slice(kv_lo, kv_hi), slice(None)) if heads
                else ())
            held = whole[idx]
            fresh = torch.isnan(held) if x.is_floating_point() else \
                held == -7
            assert torch.equal(held[~fresh], x[~fresh]), (case, key, i)
            whole[idx] = x
        out.append(whole)
    return out


def jax_leaves(jcache) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(jcache["stack"])[0]]


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_logits_match_the_reference(world, case):
    want = reference(case)[0]
    got = rows_logits(world, case, "logits")
    assert len(got) == STEPS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_logits_match_the_one_process_port(world, case):
    want = one_process(case)[0]
    for g, w in zip(rows_logits(world, case, "logits"), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **ONE_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("when", ["first", "last"])
def test_serve_tp_cache_matches_reference_and_one_process(world, case,
                                                          when):
    """The assembled cache after the prefill and after the last step:
    ``pos`` exact, k / v (and the cross K/V) within 1e-5 of the reference
    and of one process."""
    _, _, jfirst, jlast = reference(case)
    _, tfirst, tlast = one_process(case)
    jl = jax_leaves(jfirst if when == "first" else jlast)
    tl = tfirst if when == "first" else tlast
    got = assembled_cache(world, case, when)
    assert len(got) == len(jl) == len(tl)
    for g, (name, w), t in zip(got, jl, tl):
        assert tuple(g.shape) == w.shape, name
        if name.endswith("['pos']"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
            np.testing.assert_array_equal(g.numpy(), t.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(g.numpy(), t.numpy(), **CACHE_TOL,
                                       err_msg=name)


def test_each_rank_holds_the_kv_heads_its_q_heads_read(world):
    """qwen3-smoke on (1, 4): 2 kv heads do not divide 4 ranks, so a rank
    holds one, the one its q head reads (heads 0 0 1 1); on (2, 2) one kv
    head a rank, its own; under ``attn_tp=False`` every head."""
    held = {c: [w[c]["first"][0].shape[-2] for w in world] for c in CASES}
    assert held["qwen3_14"] == [1, 1, 1, 1]
    assert held["qwen3_22"] == [1, 1, 1, 1]
    assert held["internvl2_14"] == [2, 2, 2, 2]
    assert [w["internvl2_14"]["attn_tp"] for w in world] == [False] * 4
    cfg = configs("qwen3_14")[1]
    assert [tnn.tp_kv_range(cfg, ModelParallel(None, p, 4))
            for p in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]


@pytest.mark.parametrize("case", list(CASES))
def test_a_cache_cut_one_kv_head_off_misses(world, case):
    """The control: every rank's cache holds the kv heads one off its own;
    its decode logits miss the one-process run's by far more than the
    reference tolerance on every step."""
    want = one_process(case)[0][1:]
    for g, w in zip(rows_logits(world, case, "control"), want):
        miss = float((g - w).abs().max())
        assert miss > 100 * F32["atol"], (case, miss)


def predicted_sites(case: str, rows: int) -> dict:
    """Calls and bytes by TP site on one rank with ``rows`` of the batch:
    ``tp_forward`` a pass's embedding reduce and each block's row-parallel
    reduces (attention, cross-attention, MLP; the attention's only under
    ``attn_tp``) of (rows, positions, d) f32, the prefill's over its
    positions (patches included) and the encoder's over the frames, a
    decode step's over one; ``tp_logits`` one gather a pass of (rows, 1,
    V / size).  No ``tp_kv_gather``: under the head-dim fallback a rank
    holds the kv heads of ``w_k`` / ``w_v`` its q heads read."""
    cfg = configs(case)[1]
    size = CASES[case][1][1]
    attn = cfg.num_heads % size == 0
    d, s, f = cfg.d_model, CASES[case][2], 4
    pos = s + extra(cfg)
    le = cfg.encdec.num_encoder_layers if cfg.encdec is not None else 0
    per_layer = 1 + attn + (attn and cfg.encdec is not None)
    L = cfg.num_layers
    fwd_calls = (1 + le * (1 + attn) + L * per_layer) + STEPS * (
        1 + L * per_layer)
    fwd_bytes = rows * d * f * (s + le * (1 + attn) * s + L * per_layer * pos
                                + STEPS * (1 + L * per_layer))
    return {"tp_forward": (fwd_calls, fwd_bytes),
            "tp_logits": (1 + STEPS, (1 + STEPS) * rows
                          * cfg.padded_vocab_size // size * f)}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_collectives_by_site(world, case):
    for w in world:
        lo, hi = w[case]["rows"]
        c = w[case]["collectives"]
        got = {k: (v, c["site_bytes"][k]) for k, v in c["sites"].items()
               if k.startswith("tp_")}
        assert got == predicted_sites(case, hi - lo)


@pytest.mark.parametrize("arch", list(ON_MESH))
def test_serve_on_mesh_greedy_tokens_match_one_process(world, arch):
    """``serve(mesh=)`` draws what one process draws and samples from the
    gathered logits: every rank's rows of greedy tokens are one
    process's, on each rank's rows over "data" (all of them on (1, 4))."""
    want = serve_one(arch)
    rows = set()
    for w in world:
        got = w["on_mesh"][arch]
        lo, hi = got["rows"]
        rows.add((lo, hi))
        assert torch.equal(got["generated"], want[lo:hi])
    assert rows == ({(0, 2), (2, 4)} if ON_MESH[arch][0] == 2 else {(0, 4)})


def test_serve_on_mesh_samples_as_one_process(world):
    """At a temperature on (2, 2) each "data" rank samples its rows with
    the draws those rows take in one process (``sample_token``'s
    ``rows``): the tokens are one process's, and the two halves of the
    batch differ (rows [2, 4) do not reuse rows [0, 2)'s draws)."""
    arch, _, temp = SAMPLED
    want = serve_one(arch, temp)
    assert not torch.equal(want, serve_one(arch))
    for w in world:
        lo, hi = w["sampled"]["rows"]
        assert torch.equal(w["sampled"]["generated"], want[lo:hi])


# ---------------------------------------------------------------------------
# outside the world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,smoke,size,family", [
    ("mamba2-780m", True, 3, "Mamba"),
    ("jamba-1.5-large-398b", True, 16, "Mamba"),
    ("deepseek-v2-236b", True, 8, "MLA"),
    ("deepseek-v2-236b", False, 3, "MLA")])
def test_serving_tp_of_undivided_mamba_or_mla_heads_is_refused_by_name(
        arch, smoke, size, family):
    """A rank serves whole Mamba and MLA heads: a head count the "model"
    axis does not divide (mamba2-smoke's 8 on 3, jamba-smoke's 8 on 16,
    deepseek-smoke's 4 MLA heads on 8, DeepSeek-V2's 128 on 3) is refused
    by name, by ``init_cache`` and ``serve_pieces`` alike."""
    from repro_torch.launch.mesh import RankMesh
    cfg = get_smoke(arch) if smoke else get_arch(arch)
    why = ttf.serve_tp_refusal(cfg, size)
    assert why is not None and f"a rank's {family} heads" in why
    assert "do not divide" in why
    with pytest.raises(ValueError, match="serving tensor parallel"):
        ttf.init_cache(cfg, 1, 8, device="meta",
                       tp=ModelParallel(None, 0, size))
    params = ttf.init_params(torch.Generator(), cfg, device="meta")
    with pytest.raises(ValueError, match=f"a rank's {family} heads"):
        tserve.serve_pieces(params, cfg, RankMesh(("data", "model"),
                                                  (1, size), rank=0,
                                                  dry=True))


def test_serve_tp_families_and_the_attention_layout():
    """Every family is served TP at the plan's 16-wide axis; ``attn_tp``
    follows the heads (InternVL2's 14 and SmolLM's 15 do not divide it)."""
    for arch in ("qwen3-1.7b", "smollm-360m", "gemma2-27b", "command-r-35b",
                 "internvl2-1b", "seamless-m4t-large-v2"):
        cfg = get_arch(arch)
        assert ttf.serve_tp_refusal(cfg, 16) is None
        assert (cfg.num_heads % 16 == 0) == (
            arch not in ("internvl2-1b", "smollm-360m"))


@pytest.mark.parametrize("arch,shape,held", [
    ("qwen3-1.7b", (1, 4), True), ("qwen3-1.7b", (2, 2), False),
    ("command-r-35b", (1, 4), True), ("smollm-360m", (1, 4), False)])
def test_serve_pieces_hold_the_kv_heads_their_q_heads_read(arch, shape,
                                                           held):
    """``serve_pieces`` on every rank of a dry serve mesh: where the kv
    heads do not divide "model" (qwen3-smoke's and command-r-smoke's 2 at
    4), ``w_k`` / ``w_v`` are the whole leaves' kv heads ``tp_kv_range``
    gives the rank (no head-dim piece for a pass to gather); else
    ``local_shard`` of the whole leaves, as every other leaf (every head
    under ``attn_tp=False``: smollm-smoke's 3 heads at 4)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.tree import tree_leaves, tree_map_with_path
    cfg = get_smoke(arch)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    names = tree_leaves(tree_map_with_path(
        lambda path, _: shd._leaf_name(path), params))
    for rank in range(4):
        mesh = RankMesh(("data", "model"), shape, rank=rank, dry=True)
        pieces, tp = tserve.serve_pieces(params, cfg, mesh)
        specs = shd.serve_param_specs(params, mesh, fsdp=False,
                                      attn_tp=tp.attn_tp)
        kv = tnn.tp_kv_range(cfg, tnn.attention_tp(tp))
        assert (kv[1] - kv[0] < cfg.num_kv_heads
                and cfg.num_kv_heads % shape[1] != 0) == held
        for x, p, sp, name in zip(tree_leaves(params), tree_leaves(pieces),
                                  tree_leaves(specs), names):
            want = (x[..., slice(*kv), :]
                    if held and name in ("w_k", "w_v", "b_k", "b_v")
                    else shd.local_shard(x, sp, mesh))
            assert torch.equal(p, want), (rank, name)
            assert p.is_contiguous()


def _dry(arch: str, shape: str, **rep):
    from repro_torch.launch import dryrun, specs
    cfg = dataclasses.replace(get_smoke(arch), **rep)
    bundle = specs.build_program(arch.replace("-", "_").replace(".", "_"),
                                 shape, arch=cfg)
    got = dryrun.measure(bundle)
    return bundle, got, dryrun.device_numbers(bundle, got)["label"]


#: mamba2-smoke at head_dim 16: 16 SSD heads, so the plan's 16-wide axis
#: divides them
_MAMBA16 = {"mamba": MambaConfig(d_state=16, d_conv=4, expand=2,
                                 head_dim=16, chunk_size=8)}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch,rep,label", [
    ("qwen3-1.7b", {"num_heads": 16, "num_kv_heads": 8}, "measured_meta"),
    ("internvl2-1b", {}, "measured_meta"),
    ("seamless-m4t-large-v2", {"num_heads": 16, "num_kv_heads": 16},
     "measured_meta"),
    ("gemma2-27b", {"num_heads": 16, "num_kv_heads": 16}, "analytic_split"),
    ("mixtral-8x22b", {}, "analytic_split"),
    ("deepseek-v2-236b", {"num_heads": 16, "num_kv_heads": 16},
     "analytic_split"),
    ("mamba2-780m", _MAMBA16, "measured_meta")])
def test_dry_serve_programs_run_the_ranks_tp(shape, arch, rep, label):
    """The dry run's serve programs on the smoke configs: every family
    runs a rank's "model" pieces on a ``DryGroup`` (one ``tp_logits``
    gather a pass, the reductions counted; nothing divided,
    ``compute_shards`` 1), ``measured_meta`` unless the plan's FSDP over
    "data" (``serve_fsdp``: Gemma-2, Mixtral, DeepSeek-V2) is held as its
    arithmetic, named in ``meta["unsharded"]``.  Mixtral's 8 smoke heads
    run whole on 16 ranks (``attn_tp=False``), its 4 experts on their d_ff
    columns; DeepSeek's MLA gathers its q latent (``tp_latent_gather``);
    Mamba's in_proj blocks (``tp_ssm_gather``)."""
    bundle, got, lab = _dry(arch, shape, **rep)
    assert lab == label
    sites = got["collectives"]["sites"]
    assert bundle.meta["compute_shards"] == 1
    assert sites["tp_logits"] == 1 and sites["tp_forward"] > 0
    cfg = dataclasses.replace(get_smoke(arch), **rep)
    assert bundle.meta["attn_tp"] == (cfg.num_heads % 16 == 0)
    assert ("tp_latent_gather" in sites) == (arch == "deepseek-v2-236b")
    assert ("tp_ssm_gather" in sites) == (arch == "mamba2-780m")
    fsdp = [u for u in bundle.meta["unsharded"] if "FSDP" in u]
    assert bundle.meta["unsharded"] == fsdp
    assert bool(fsdp) == (label == "analytic_split")


def test_dry_train_program_runs_the_encdec_tp():
    """Seamless's smoke config widened to 16 heads: its train pair runs
    the rank's TP pieces on ``DryGroup``s, the memory's ``copy`` one
    ``tp_memory`` reduction a microbatch step, nothing divided."""
    bundle, got, lab = _dry("seamless-m4t-large-v2", "train_4k",
                            num_heads=16, num_kv_heads=16)
    local = got["stage_collectives"]["local_step"]["sites"]
    assert lab == "measured_meta" and bundle.meta["unsharded"] == []
    assert local["tp_memory"] == 1 and local["tp_vocab"] > 0
