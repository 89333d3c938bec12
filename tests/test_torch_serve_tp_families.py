"""Serving tensor parallel over "model" for the MoE, MLA and Mamba families
on the serve mesh ("data", "model"): the rank-local prefill and decode of
``launch.serve`` on one spawned world of 4 gloo ranks, held against the
JAX package's ``prefill`` / ``decode_step`` (drop-free MoE) and the port's
one process on the same weights and prompts.

Each rank takes its pieces of the whole weights (``serve_pieces``) and its
rows of the batch over "data" (``batch_rows``), prefills on the kernel
route (kernel 3's and kernel 9's plain versions here) and runs 4 decode
steps teacher-forced on the reference's greedy tokens; each step's logits
are its vocab slice, gathered whole (``tp_logits``).  The cases:

* ``mixtral_14``: mixtral-smoke on (1, 4) with a 40-token prompt past its
  window of 32: the ring on a rank's 2 q heads (its 2 kv heads do not
  divide the axis: the kv head its q heads read), one expert a rank;
* ``mixtral_dff_14``: mixtral-smoke with 6 experts on both sides, on
  (1, 4): 6 experts do not divide 4 ranks, so every expert runs on a
  rank's d_ff columns (``launch.sharding.MOE_DFF_FALLBACK``);
* ``deepseek_22``: deepseek-smoke on (2, 2): the dense prefix layer, 2 of
  4 MLA heads a rank with the whole latent cache and the absorbed decode,
  2 of 4 experts and the shared experts' d_ff half;
* ``mamba2_14``: mamba2-smoke on (1, 4): 2 of 8 SSD heads a rank, its
  conv window (its x channels, B and C whole) and SSM state;
* ``jamba_22``: jamba-smoke on (2, 2): a Mamba layer with the dense FFN,
  then an attention layer with the MoE, on one rank.

Held: the prefill's and each step's assembled logits against the reference
(1e-4) and the one process (``ONE_TOL``); the assembled cache after the
prefill and after the last step (1e-5), the copies several ranks hold (the
MLA latent, B and C in the conv window, a kv head two q-head blocks read)
bitwise equal; every TP site's calls and bytes to the byte; the controls
(a rank's experts offset by one expert; a rank's SSM state one head off)
miss.  ``serve(mesh=)``'s tokens equal one process's ``serve`` on the same
draws, greedy and at a temperature.
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
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.tp import ModelParallel  # noqa: E402
from repro_torch.models import modules as tnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_map_with_path)

B, S, STEPS = 4, 12, 4
F32 = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
#: the one-process port against the TP ranks: the row-parallel sums and
#: the gated norm's row sums regroup f32 contractions
ONE_TOL = dict(rtol=1e-5, atol=1e-5)
J_OPTS = jtf.ApplyOptions(remat=False, moe_no_drop=True)
T_OPTS = ttf.ApplyOptions(attn_impl="kernel", moe_no_drop=True)
# case -> (arch, serve mesh ("data", "model"), prompt length, config
# replacements on both sides: a dict value replaces a sub-config's fields)
CASES = {
    "mixtral_14": ("mixtral-8x22b", (1, 4), 40, {}),
    "mixtral_dff_14": ("mixtral-8x22b", (1, 4), S,
                       {"moe": {"num_experts": 6}}),
    "deepseek_22": ("deepseek-v2-236b", (2, 2), S, {}),
    "mamba2_14": ("mamba2-780m", (1, 4), S, {}),
    "jamba_22": ("jamba-1.5-large-398b", (2, 2), S, {}),
}
#: ``serve(mesh=)`` against one process's ``serve``, greedy: arch -> mesh
ON_MESH = {"mamba2-780m": (1, 4), "mixtral-8x22b": (1, 4),
           "deepseek-v2-236b": (2, 2)}
#: ... and at a temperature, on a mesh whose "data" splits the batch
SAMPLED = ("jamba-1.5-large-398b", (2, 2), 0.8)
SERVE_KW = dict(batch=B, prompt_len=8, gen=5, device="cpu")
#: a cache leaf's own dims (its batch dim first), by name
OWN_DIMS = {"k": 4, "v": 4, "pos": 2, "c_kv": 3, "k_rope": 3, "conv": 3,
            "ssm": 4}


def _replace(cfg, rep: dict):
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in rep.items()})


def configs(case: str):
    arch, _, _, rep = CASES[case]
    return _replace(j_get_smoke(arch), rep), _replace(get_smoke(arch), rep)


def max_len(case: str) -> int:
    return CASES[case][2] + STEPS + 1


@functools.lru_cache(maxsize=None)
def np_params(case: str) -> dict:
    jparams = jtf.init_params(jax.random.key(13), configs(case)[0])
    return jax.tree.map(np.asarray, jparams)


@functools.lru_cache(maxsize=None)
def batch_for(case: str) -> dict:
    cfg, s = configs(case)[1], CASES[case][2]
    rng = np.random.default_rng(len(case))
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s))}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _cache_part(cache) -> dict:
    """The layers' caches of a cache tree (without ``position``)."""
    return {"prefix": cache["prefix"], "stack": cache["stack"]}


@functools.lru_cache(maxsize=None)
def reference(case: str):
    """The JAX package's prefill and STEPS greedy decode steps: the
    logits of each, the greedy tokens fed, and the caches after the
    prefill and after the last step (numpy)."""
    jcfg = configs(case)[0]
    jparams = jax.tree.map(jnp.asarray, np_params(case))
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in batch_for(case).items()}
    logits, cache = jax.jit(lambda p, b: jtf.prefill(
        p, jcfg, b, max_len=max_len(case), cache_dtype=jnp.float32,
        opts=J_OPTS))(jparams, batch)
    step = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
    out, toks = [np.asarray(logits)], []
    first = jax.tree.map(np.asarray, _cache_part(cache))
    for _ in range(STEPS):
        nxt = np.array(jnp.argmax(logits[:, -1], -1))[:, None]
        toks.append(nxt)
        logits, cache = step(jparams, jnp.asarray(nxt, jnp.int32), cache)
        out.append(np.asarray(logits))
    return out, np.concatenate(toks, 1), first, jax.tree.map(
        np.asarray, _cache_part(cache))


@functools.lru_cache(maxsize=None)
def one_process(case: str):
    """The port's one process on the whole weights and batch, fed the
    reference's tokens: logits of the prefill and each step, the caches'
    leaves after the prefill and the last step."""
    cfg = configs(case)[1]
    params = ttf.params_from_numpy(np_params(case))
    logits, cache = ttf.prefill(params, cfg, _t(batch_for(case)),
                                max_len=max_len(case),
                                cache_dtype=torch.float32, opts=T_OPTS)
    out = [logits]
    first = [x.clone() for x in tree_flatten(_cache_part(cache))[0]]
    toks = torch.from_numpy(reference(case)[1])
    for i in range(STEPS):
        logits, cache = ttf.decode_step(params, cfg, toks[:, i:i + 1], cache)
        out.append(logits)
    return out, first, tree_flatten(_cache_part(cache))[0]


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


    def configured(arch, rep):
        import dataclasses
        from repro_torch.configs import get_smoke
        cfg = get_smoke(arch)
        return dataclasses.replace(cfg, **{
            k: dataclasses.replace(getattr(cfg, k), **v)
            if isinstance(v, dict) else v for k, v in rep.items()})


    def decoded(tf, pieces, cfg, tp, toks, cache, steps):
        got = []
        for i in range(steps):
            logits, cache = tf.decode_step(pieces, cfg, toks[:, i:i + 1],
                                           cache, tp=tp)
            got.append(tp.gather_logits(logits))
        return got, cache


    def run_case(spec, spec_path, name, arch, shape, _s, rep):
        from repro_torch.core import consensus as cns
        from repro_torch.launch import serve as sv
        from repro_torch.launch.mesh import RankMesh
        from repro_torch.launch.sharding import _leaf_name
        from repro_torch.models import transformer as tf
        from repro_torch.tree import (tree_flatten, tree_map,
                                      tree_map_with_path, tree_unflatten)
        cfg = configured(arch, rep)
        mesh = RankMesh(("data", "model"), shape)
        params = tf.params_from_numpy(spec["params"][name])
        pieces, tp = sv.serve_pieces(params, cfg, mesh)
        lo, hi = sv.batch_rows(mesh, spec["b"])
        mine = {k: torch.from_numpy(v[lo:hi])
                for k, v in spec["batches"][name].items()}
        opts = tf.ApplyOptions(attn_impl="kernel", moe_no_drop=True, tp=tp)
        kw = dict(max_len=spec["max_len"][name], cache_dtype=torch.float32)
        toks = fed_tokens(spec_path, name)[lo:hi]
        cns.reset_collective_counts()
        logits, cache = tf.prefill(pieces, cfg, mine, opts=opts, **kw)
        got = [tp.gather_logits(logits)]
        first = [x.clone() for x in tree_flatten(
            {"prefix": cache["prefix"], "stack": cache["stack"]})[0]]
        with torch.inference_mode():
            kept = tree_map(lambda x: x.clone() if isinstance(
                x, torch.Tensor) else x, cache)
        steps, cache = decoded(tf, pieces, cfg, tp, toks, cache,
                               spec["steps"])
        got += steps
        counts = cns.collective_counts()
        if cfg.moe is not None and cfg.mamba is None:
            # the control: the rank's expert tables cut from the whole
            # ones rolled by one expert (its experts, or every expert's
            # d_ff columns, one expert off)
            def rolled(path, x):
                return x.roll(1, dims=x.dim() - 3) if _leaf_name(path) in (
                    "w_gate", "w_up", "w_down") else x
            off, _ = sv.serve_pieces(tree_map_with_path(rolled, params), cfg,
                                     mesh)
            logits, ccache = tf.prefill(off, cfg, mine, opts=opts, **kw)
            ctl, _ = decoded(tf, off, cfg, tp, toks, ccache, spec["steps"])
            ctl = [tp.gather_logits(logits)] + ctl
        else:
            # the control: the prefill's cache with the rank's SSM state
            # taken one head off, from one process's state of these rows
            _, whole = tf.prefill(params, cfg, mine, opts=tf.ApplyOptions(
                attn_impl="kernel", moe_no_drop=True), **kw)
            nh = cfg.mamba.num_heads(cfg.d_model)
            hl = nh // tp.size
            shifted = (torch.arange(hl) + tp.pos * hl + 1) % nh
            names = tree_flatten(tree_map_with_path(
                lambda p, _: _leaf_name(p), kept))[0]
            leaves, treedef = tree_flatten(kept)
            wl = tree_flatten(whole)[0]
            leaves = [w.index_select(w.dim() - 3, shifted).contiguous()
                      if n_ == "ssm" else x
                      for x, w, n_ in zip(leaves, wl, names)]
            ctl, _ = decoded(tf, pieces, cfg, tp, toks,
                             tree_unflatten(treedef, leaves), spec["steps"])
        return dict(coords=mesh.coords(), rows=(lo, hi),
                    attn_tp=tp.attn_tp, logits=got, control=ctl,
                    first=first,
                    last=[x.clone() for x in tree_flatten(
                        {"prefix": cache["prefix"],
                         "stack": cache["stack"]})[0]],
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
    d = tmp_path_factory.mktemp("serve_tp_families_world")
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


def cache_names(case: str) -> list:
    """The leaf names of a cache's layers, in flatten order."""
    cfg = configs(case)[1]
    cache = ttf.init_cache(cfg, 1, 2, torch.float32, device="meta")
    return tree_leaves(tree_map_with_path(
        lambda p, _: shd._leaf_name(p), _cache_part(cache)))


def rank_slices(case: str, name: str, x, w: dict) -> list:
    """``(index into the whole leaf, piece)`` pairs placing a rank's
    cache leaf ``x`` (leaf ``name``): its rows over "data" at the leaf's
    batch dim, and over "model" a k / v leaf's kv heads
    (``tp_kv_range``), an SSM state's heads, a conv window's x channels
    of its heads beside B and C (whole); the MLA latent, ``pos`` whole."""
    cfg = configs(case)[1]
    size = CASES[case][1][1]
    lo, hi = w[case]["rows"]
    bdim = x.dim() - OWN_DIMS[name]
    lead = (slice(None),) * bdim + (slice(lo, hi),)
    p = w[case]["coords"]["model"]
    if name in ("k", "v"):
        mp = ModelParallel(None, p, size, w[case]["attn_tp"])
        kv_lo, kv_hi = tnn.tp_kv_range(cfg, tnn.attention_tp(mp))
        return [(lead + (Ellipsis, slice(kv_lo, kv_hi), slice(None)), x)]
    if name == "ssm":
        hl = x.shape[-3]
        return [(lead + (Ellipsis, slice(p * hl, (p + 1) * hl),
                         slice(None), slice(None)), x)]
    if name == "conv":
        m = cfg.mamba
        di = m.d_inner(cfg.d_model)
        dl = di // size
        return [(lead + (Ellipsis, slice(p * dl, (p + 1) * dl)),
                 x[..., :dl]), (lead + (Ellipsis, slice(di, None)),
                                x[..., dl:])]
    return [(lead, x)]


def assembled_cache(world, case: str, key: str) -> list:
    """The whole cache's leaves from every rank's (``rank_slices``); a
    slot held by several ranks is bitwise the same on each."""
    cfg = configs(case)[1]
    names = cache_names(case)
    whole_shapes = [tuple(x.shape) for x in tree_flatten(_cache_part(
        ttf.init_cache(cfg, B, max_len(case), torch.float32,
                       device="meta")))[0]]
    out = []
    for i, (name, shape) in enumerate(zip(names, whole_shapes)):
        x0 = world[0][case][key][i]
        whole = torch.full(shape, float("nan")) if x0.is_floating_point() \
            else torch.full(shape, -7, dtype=x0.dtype)
        for w in world:
            for idx, piece in rank_slices(case, name, w[case][key][i], w):
                held = whole[idx]
                fresh = torch.isnan(held) if piece.is_floating_point() \
                    else held == -7
                assert torch.equal(held[~fresh], piece[~fresh]), (
                    case, key, name)
                whole[idx] = piece
        assert not (torch.isnan(whole).any() if whole.is_floating_point()
                    else (whole == -7).any()), (case, key, name)
        out.append(whole)
    return out


def jax_leaves(jcache) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(jcache)[0]]


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_family_logits_match_the_reference(world, case):
    want = reference(case)[0]
    got = rows_logits(world, case, "logits")
    assert len(got) == STEPS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_family_logits_match_the_one_process_port(world, case):
    want = one_process(case)[0]
    for g, w in zip(rows_logits(world, case, "logits"), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **ONE_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("when", ["first", "last"])
def test_serve_tp_family_cache_matches_reference_and_one_process(world, case,
                                                                 when):
    """The assembled cache after the prefill and after the last step:
    ``pos`` exact; k / v, the MLA latent, the conv window and the SSM
    state within 1e-5 of the reference and of one process."""
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


def test_each_rank_holds_its_heads_and_the_whole_latent(world):
    """A rank's cache leaves: deepseek-smoke's MLA latent whole (32 + 8 of
    each position), mamba2-smoke's conv window its 2 heads' 64 x channels
    beside B and C (2 x 16) and its SSM state 2 of 8 heads, jamba-smoke's
    4 of 8 heads and its attention layer's one kv head of 2."""
    names = {c: cache_names(c) for c in CASES}

    def shape(case, name):
        return [tuple(w[case]["first"][names[case].index(name)].shape)
                for w in world]
    assert {s[-1] for s in shape("deepseek_22", "c_kv")} == {32}
    assert {s[-1] for s in shape("deepseek_22", "k_rope")} == {8}
    assert {s[-1] for s in shape("mamba2_14", "conv")} == {64 + 32}
    assert {s[-3] for s in shape("mamba2_14", "ssm")} == {2}
    assert {s[-3] for s in shape("jamba_22", "ssm")} == {4}
    assert {s[-2] for s in shape("jamba_22", "k")} == {1}


@pytest.mark.parametrize("case", list(CASES))
def test_a_rank_one_expert_or_one_head_off_misses(world, case):
    """The controls: a rank whose expert tables are the whole ones rolled
    by one expert (the MoE and MLA cases), or whose SSM state is its heads
    shifted by one (the Mamba cases): its logits miss the one-process
    run's by far more than the reference tolerance on every step the
    control changes (the prefill's and every step's under the experts'
    offset, every decode step's under the state's)."""
    want = one_process(case)[0]
    got = rows_logits(world, case, "control")
    if len(got) == len(want) - 1:
        want = want[1:]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        miss = float((g - w).abs().max())
        assert miss > 100 * F32["atol"], (case, miss)


def predicted_sites(case: str, rows: int) -> dict:
    """Calls and bytes by TP site on one rank with ``rows`` of the batch,
    a pass over P positions (the prompt's, then one a decode step), f32:
    ``tp_forward`` the embedding's reduce and, a layer, the mixer's
    (attention under ``attn_tp``, MLA, a mamba layer's ``out_proj``), the
    dense MLP's, an MoE layer's routed sum and its shared experts', each
    (rows, P, d); ``tp_latent_gather`` an MLA layer's (rows, P, q_rank /
    size) piece; ``tp_ssm_gather`` a mamba layer's in_proj block (rows, P,
    W / size) with its conv leaves' pieces, ``tp_ssm_norm`` its (rows x
    P,) sums of squares; ``tp_logits`` one gather a pass of (rows, 1, V /
    size).  The gates' ``copy`` and the per-head leaves' ``replicated``
    send nothing in a forward pass."""
    cfg = configs(case)[1]
    size = CASES[case][1][1]
    d, f = cfg.d_model, 4
    out: dict = {}

    def add(site, n_bytes):
        calls, total = out.get(site, (0, 0))
        out[site] = (calls + 1, total + n_bytes)

    for p_ in [CASES[case][2]] + [1] * STEPS:
        act = rows * p_ * d * f
        add("tp_forward", act)
        for i in range(cfg.num_layers):
            kind = cfg.pattern_for_layer(i)
            if kind == "mamba":
                m = cfg.mamba
                di, nh = m.d_inner(d), m.num_heads(d)
                width = 2 * di + 2 * m.d_state + nh
                ch = di + 2 * m.d_state
                add("tp_ssm_gather", (rows * p_ * width + m.d_conv * ch + ch)
                    // size * f)
                add("tp_ssm_norm", rows * p_ * f)
                add("tp_forward", act)
            elif cfg.mla is not None:
                add("tp_latent_gather",
                    rows * p_ * cfg.mla.q_lora_rank // size * f)
                add("tp_forward", act)
            elif cfg.num_heads % size == 0:
                add("tp_forward", act)
            if cfg.is_moe_layer(i):
                add("tp_forward", act)
                if cfg.moe.num_shared_experts:
                    add("tp_forward", act)
            elif cfg.d_ff > 0:
                add("tp_forward", act)
        add("tp_logits", rows * cfg.padded_vocab_size // size * f)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_family_collectives_by_site(world, case):
    for w in world:
        lo, hi = w[case]["rows"]
        c = w[case]["collectives"]
        got = {k: (v, c["site_bytes"][k]) for k, v in c["sites"].items()
               if k.startswith("tp_")}
        assert got == predicted_sites(case, hi - lo)


@pytest.mark.parametrize("arch", list(ON_MESH))
def test_serve_on_mesh_greedy_tokens_match_one_process(world, arch):
    """``serve(mesh=)`` draws what one process draws, the ranks of a model
    group in turn, and samples from the gathered logits: every rank's
    rows of greedy tokens are one process's."""
    want = serve_one(arch)
    rows = set()
    for w in world:
        got = w["on_mesh"][arch]
        lo, hi = got["rows"]
        rows.add((lo, hi))
        assert torch.equal(got["generated"], want[lo:hi])
    assert rows == ({(0, 2), (2, 4)} if ON_MESH[arch][0] == 2 else {(0, 4)})


def test_serve_on_mesh_samples_as_one_process(world):
    """jamba-smoke at a temperature on (2, 2): each "data" rank samples
    its rows with the draws those rows take in one process."""
    arch, _, temp = SAMPLED
    want = serve_one(arch, temp)
    assert not torch.equal(want, serve_one(arch))
    for w in world:
        lo, hi = w["sampled"]["rows"]
        assert torch.equal(w["sampled"]["generated"], want[lo:hi])
