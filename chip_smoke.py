#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (an H100, 80 GB: Command-R-35B's bf16 weights
alone take 60.6 GB, the cut Mixtral-8x22B's 50.9 GB) and the CUDA
toolkit's nvcc.  It
builds the port's kernels (six CUDA C++ sources) from this checkout, holds
each one against its plain PyTorch version on the card (kernel 2, RMSNorm
forward and backward, at every row shape the paths below run, in f32 and
bf16), and drives these paths, each with the launch counters reset just
before it and read just after:

* training: Algorithm 1 through ``repro_torch.launch.train.train`` on
  full-width, full-depth SmolLM-360M (361,821,120 parameters, random
  weights from a seed), then a full-size gossip period against the plain
  version and Lemma 1;
* dynamic federation: Algorithm 1 through
  ``repro_torch.launch.train.train_dynamic`` on full SmolLM-360M with
  Bernoulli(0.5) participation, per-epoch edge drops and server 2 dropping
  at epoch 1 and rejoining at epoch 2 (M = 4 -> 3 -> 4: kernel 1 five
  times an epoch, one epoch step built per M, the memory of two client
  replicas freed by the drop and taken back by the rejoin), then one
  Chebyshev epoch (kernel 1 ceil(sqrt(5)) = 3 times); then one dynamic
  period at full size and M = 3 (the masked mean and kernel 1 on an
  edge-dropped A_p against their plain versions, the server mean kept and
  the disagreement lowered in float64, kernel 1's time at M = 3 against
  its bound);
* serving: ``repro_torch.launch.serve.serve`` on full-width, full-depth
  Qwen3-1.7B (1,720,574,976 parameters, f32 weights from a seed, f32 KV
  cache): 4 prompts of 1024 tokens prefilled through the flash-attention
  kernel, 64 tokens decoded each; then the kernel-route prefill against the
  reference route and three decode steps against a full forward;
* the physical wire: ``train`` on full SmolLM-360M with int8 codes on the
  wire and error feedback (kernels 6 and 7 every round), then one epoch of
  it at staleness 1 (kernel 8 every round), each period's disagreement
  read in float64 before and after it; then one full-size wire period at
  staleness 0, at staleness 1 and in the per-leaf layout (kernel 5), each
  held against the plain versions on column slabs of the same inputs
  (chunks are independent, so a slab is exact);
* the simulated wire: kernel 4 against its plain version over M, bits and
  chunk; ``train`` on full SmolLM-360M with int8 compression on the default
  simulated wire (each period's round trip and first mix on kernel 4, the
  rest on kernel 1), then one epoch of int4 with error feedback and one
  each of top-k and random-k; then one full-size period, kernel 4 held
  against its plain version on whole-row slabs of every leaf, and the
  period's times (dither, pad copies, kernel 4, kernel 1);
* Mamba-2 serving: kernel 9 (the SSD scan) against its plain version over
  the reference's sweep, bf16, the model's strided layout and the decay
  extremes; then ``serve`` on full-width, full-depth Mamba2-780M
  (780,259,584 f32 parameters from a seed, f32 cache): 4 prompts of 1024
  tokens prefilled through kernel 9 (48 launches), 64 tokens decoded each
  (O(1) state, no kernel 9); the kernel-route prefill against the reference
  route (``ssd_chunked``) on the logits and every layer's cache, decode
  against a full forward, kernel 9's time at the prefill's shape against
  its bound, and the prefill and decode under the profiler;
* the dense zoo: kernel 1's bf16 instance at SmolLM-360M's full size and
  kernel 3 at each new mode's main shape (bf16 with Gemma-2's window 4096
  and softcap 50 at 6144 tokens, and its global layers; Command-R's group
  of 8 in bf16; InternVL2's group 7 at head_dim 64; Seamless's non-causal
  encoder and causal decoder) against their plain versions (on a slice of
  heads where the plain scores would not fit), timed against their bounds
  and ``F.scaled_dot_product_attention`` where it computes the same
  function; one static epoch of full SmolLM-360M with bf16 leaves through
  ``train`` (kernel 1's bf16 instance five times) and one period of each
  wire on a bf16 tree at smoke width, card against CPU; then four serving
  paths, each model freed before the next loads: Gemma2-27B (bf16, 2
  prompts of 6144 tokens, 32 generated) and Command-R-35B (bf16, 4 x 1024,
  64) through ``init_params(dtype=bf16)``, ``prefill``, ``decode_step`` and
  ``sample_token``, the loop ``serve()`` runs, and InternVL2-1B (256 patch
  embeddings ahead of the prompt) and Seamless-M4T-large-v2 (1024 frame
  embeddings through the encoder) in f32 through ``serve()``; each with
  its launches (kernel 3 by mode), peak memory, the kernel-route prefill
  against the reference route (f32: 1e-4 of the largest logit; bf16:
  twice the reference route's distance from itself with its key sums
  grouped otherwise, plus four bf16 steps) and three decode steps against
  a full forward;
* the MoE and MLA families, bf16 at full width and a cut depth: kernel 3
  at Mixtral's mode (group 6, window 4096, 6144 tokens) and kernel 9 on
  bf16 x/B/C at Jamba's shape (256 heads) against their plain versions
  beside controls that must fail; then Mixtral-8x22B (10 of 56 layers, 2 x
  6144, 32 generated), DeepSeek-V2 (its dense first layer + 5 MoE layers, 4
  x 1024, 64) and Jamba-1.5-Large (a 4-layer period: mamba, mamba + MoE,
  attention, mamba + MoE; 4 x 1024, 64) through ``init_params(dtype=bf16)``,
  ``prefill`` with drop-free MoE (as ``serve()`` sets it), ``decode_step``
  and ``sample_token``: launches (kernel 3 never for DeepSeek's MLA, kernel
  9 three times for Jamba), peaks, the tokens whose top-k expert set
  differs between the kernel route and the reference route (counted; the
  logits held on the rows without one, and on every row with the kernel
  route's routing pinned on the reference route), decode against a
  drop-free full forward with the same routing pinned, beside decode
  controls that the same limit must fail (a zeroed cache state; a step
  one position early, where every layer attends; in Jamba, where one
  layer in four attends, that control is held on the attention layer's
  decode output against the pinned forward's), a finite loss;
* Algorithm 1 training the other families through ``train``: full
  Mamba2-780M in f32 (its mixer on the reference route, so kernels 3 and
  9 never launch) and Mixtral-8x22B at full width in bf16 with its depth
  cut to one layer (kernel 1's bf16 instance), each with its launches,
  peak, the kernel-2 shapes it launched (all held by the sweep), finite
  losses (and aux losses), parameters moved and each period's float64
  disagreement falling;
* directed federation (push-sum) on full SmolLM-360M over a random
  orientation of K_4 with out-degree weights: two static epochs (kernel 1
  under P = A' every round), one full-size period (kernel 1 on P against
  its plain version and timed; the numerator's column sums and sum w = M
  in float64; the ratio nearer the servers' mean than row-stochastic
  gossip), one epoch on each wire (kernels 6 and 7; kernel 4 then 1) and
  three dynamic epochs with direction drops and server 2 out and back
  (the weight exactly 1 after each surgery).
* observability: the dynamic cell through ``train_dynamic`` under
  ``OBS_OFF`` and with the full bundle (console and JSONL sinks, span
  tracer, convergence monitor), histories held bit for bit, the compile
  causes, the span tree and both files checked, kernel 1's launches with
  the consensus-replay probe's (the step's T_S an epoch, the probe's T_S an
  epoch, one warm-up period per new M); the probe's estimate of each gossip
  period against CUDA events around the step's own consensus call; the
  physical wire's probe over one epoch (kernels 6 and 7, the state's wire
  key and error-feedback residual untouched); ``superepoch=4`` against 1 in
  turns; the static trainer's telemetry files over one epoch.
* the multi-process wire: the row forms of kernels 1, 7 and 8 (a rank's
  own rows of a gathered round) at the wire's main shape, each row bitwise
  row r of the square call and held to its plain version; the one-process
  epochs of the cells below in this process, each freed before the next;
  then one world of four gloo ranks on this card, one server a rank
  (spawned after the build, every collective staged through pinned host
  buffers), training full SmolLM-360M through the trainers with
  ``consensus_backend="shard_map"``: one epoch on the int8 physical wire
  with error feedback at staleness 0 and at 1, one uncompressed, one
  dynamic epoch (Bernoulli 0.5, edge drops 0.3) on the wire, one push-sum
  epoch on the wire over a random orientation of K_4; each rank's rows
  bitwise the
  one-process run's rows (the uncompressed one also within one f32
  rounding on value samples), every wire round one int8 and one f32
  all_gather of ``tree_bucketed_wire_bytes_per_server`` bytes, each rank's
  epoch, collective and staging seconds and peak; then the trainer under
  ``python -m torch.distributed.run --nproc-per-node 4`` at the smoke
  size, rank 0's JSONL history against the in-process run's.
* the launch layer (PR 27), in the same world: ``shard_map_inlier``, one
  dynamic epoch with ``inlier_shift`` on server 0 (the honest envelope
  reduced over the ranks), rows bitwise the one-process epoch's;
  ``shard_map_axes``, the four ranks as a (server 2, client 1, replica 2,
  model 1) mesh of ``launch.mesh`` holding full-width SmolLM-360M server
  rows cut by ``launch.sharding.fl_server_specs`` (FSDP over "replica"):
  one T_S = 5 period of the plain program (kernel 1r), of the int8
  physical wire with error feedback at staleness 0 (kernels 6, 7r) and 1
  (kernel 8r), each rank's pieces and residual bitwise row r of the
  one-process period on every piece under A ⊗ I_S (this process, square
  kernels), each rank's calls and bytes a round equal to the meta-device
  dry run's record, and the same federation's wire period with one whole
  row a rank on the two replica-0 ranks (``wire_whole``) as the
  yardstick; then ``dryrun``, one pair of each
  program (SmolLM-360M train_4k, Qwen3-1.7B prefill_32k, Mamba2-780M
  long_500k) on the meta device in a process of its own beside the CLI.

Kernels 3 and 9 at their prefill shapes also report each device kernel's
time from the profiler, the blocks of each launch, and the registers and
spills of every compiled instance.

Every phase prints one JSON line, with ``elapsed_s``, the seconds since the
script started (so a run shows where its time goes); any failure
raises and the script exits non-zero.  Before the last line it prints the
per-kernel JSON summary and the GPU's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

_START = time.perf_counter()

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) flop/s, at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
# bf16 operands: the dense tensor-core peak (the bound any bf16 attention
# could reach; kernel 3's bf16 instance computes on the tensor cores)
H100_BF16_TC_FLOP_PER_S = 989e12

# the main path of this slice: the trainer's defaults but M = 4 servers
# (a 2-ring's Metropolis A makes one round the exact mean) and T_C = 2
TRAIN = dict(smoke=False, servers=4, clients=2, t_client=2, t_server=5,
             epochs=2, seq_len=128, per_client_batch=2, graph="ring",
             device="cuda")
SMOLLM_PARAMS = 361_821_120

# the physical wire's path: the training path with int8 codes on the wire
WIRE_TRAIN = dict(TRAIN, compression="int8", wire="physical",
                  error_feedback=True)
WIRE_CHUNK = 256
# the wire kernels: ops entry point -> (C entry, the TPU kernel replaced)
WIRE_KERNELS = {
    "quantized_gossip_encode": "src/repro/kernels/consensus_mix.py:334",
    "bucketed_gossip_round": "src/repro/kernels/consensus_mix.py:440",
    "bucketed_gossip_round_pipelined":
        "src/repro/kernels/consensus_mix.py:577",
    "quantized_gossip_round": "src/repro/kernels/consensus_mix.py:219",
}
# what each wire kernel must move (each input read once, each output
# written once): bytes per element of its (M, D) operands, passes over the
# (M, D/chunk) f32 scales, and whether it reads the (M, M) f32 A.  The
# encode reads w, ref, u and writes codes and scales; the rounds read codes,
# scales, ref, u (and acc, w) and write their outputs, codes and scales.
WIRE_TRAFFIC = {"quantized_gossip_encode": (4 + 4 + 4 + 1, 1, False),
                "bucketed_gossip_round": ((1 + 4 + 4 + 4) + (4 + 4 + 1), 2,
                                          True),
                "bucketed_gossip_round_pipelined":
                    ((1 + 4 + 4 + 4 + 4) + (4 + 4 + 1), 2, True),
                "quantized_gossip_round": ((1 + 4 + 4) + (4 + 4 + 1), 2,
                                           True)}
WIRE_SLAB = 1 << 20         # columns of a slab held against the plain version
# the instances of kernel 8 that the training paths must take: the resident
# body with 16-byte loads (VEC = 4), four own rows in one process, one in a
# rank of the multi-process wire
KERNEL8_SQUARE = "vec4.own4"
KERNEL8_ROW = "vec4.own1"

# the dynamic-federation path: the training path with Bernoulli(0.5)
# participation, per-epoch edge drops (p = 0.3) and server 2 dropping at
# epoch 1 and rejoining at epoch 2 (M = 4 -> 3 -> 4)
DYN_TRAIN = dict(smoke=False, servers=4, clients=2, t_client=2, t_server=5,
                 epochs=3, seq_len=128, per_client_batch=2, gamma=0.05,
                 participation_kind="bernoulli", participation_rate=0.5,
                 edge_drop_prob=0.3, faults="drop:1:2,rejoin:2:2",
                 device="cuda")
# f32 bytes of one SmolLM-360M replica: a client's share of the state
SMOLLM_REPLICA_GB = SMOLLM_PARAMS * 4 / 1e9

# the simulated wire's path: the training path with int8 compression on the
# default wire (once a period), no error feedback
SIM_TRAIN = dict(TRAIN, compression="int8")
SIM_KERNEL = ("quantized_consensus_mix",
              "src/repro/kernels/consensus_mix.py:124")
SIM_SLAB = 1 << 20          # elements of a slab held against the plain version

# kernel 2 against its plain version and F.rms_norm: (rows, d, dtype, where
# the paths run it, launches there) -- the SmolLM-360M client step, Qwen3's
# prefill (4 x 1024 tokens: ln1 / ln2 / final, q_norm over 16 heads, k_norm
# over 8) and decode step (4 rows), Mamba2's prefill (ln1 and the final
# norm; the gated norm over d_inner) and decode step; 1000 rows, a count
# that fills no whole block; bf16 instances of the training and prefill
# shapes; the MoE families' prefill and decode shapes; the client steps of
# the Mamba2-780M and Mixtral-8x22B training cells
RMSNORM_SHAPES = [
    (256, 960, "float32", "smollm-360m client step ln1/ln2",
     "64 + 64 a step"),
    (254, 960, "float32", "smollm-360m client step final norm (the loss "
     "drops the last position)", "1 + 1 a step"),
    (1000, 960, "float32", "ragged rows", "-"),
    (4096, 2048, "float32", "qwen3 prefill ln1/ln2/final", "57 a prefill"),
    (65536, 128, "float32", "qwen3 prefill q_norm", "28 a prefill"),
    (32768, 128, "float32", "qwen3 prefill k_norm", "28 a prefill"),
    (4, 2048, "float32", "qwen3 decode ln1/ln2/final", "57 a step"),
    (64, 128, "float32", "qwen3 decode q_norm", "28 a step"),
    (32, 128, "float32", "qwen3 decode k_norm", "28 a step"),
    (4096, 1536, "float32", "mamba2 prefill ln1/final", "49 a prefill"),
    (4096, 3072, "float32", "mamba2 prefill gated norm", "48 a prefill"),
    (4, 1536, "float32", "mamba2 decode ln1/final", "49 a step"),
    (4, 3072, "float32", "mamba2 decode gated norm", "48 a step"),
    (256, 960, "bfloat16", "smollm-360m client step", "-"),
    (4096, 2048, "bfloat16", "qwen3 prefill ln1/ln2/final", "-"),
    (65536, 128, "bfloat16", "qwen3 prefill q_norm", "-"),
    (32768, 128, "bfloat16", "qwen3 prefill k_norm", "-"),
    (4096, 1536, "bfloat16", "mamba2 prefill ln1/final; deepseek q_norm",
     "6 a deepseek prefill"),
    (4096, 3072, "bfloat16", "mamba2 prefill gated norm", "-"),
    (12288, 6144, "bfloat16", "mixtral prefill ln1/ln2", "20 a prefill"),
    (4096, 5120, "bfloat16", "deepseek prefill ln1/ln2", "12 a prefill"),
    (4096, 512, "bfloat16", "deepseek prefill kv_norm", "6 a prefill"),
    (4096, 8192, "bfloat16", "jamba prefill ln1/ln2", "8 a prefill"),
    (4096, 16384, "bfloat16", "jamba prefill gated norm", "3 a prefill"),
    (2, 6144, "bfloat16", "mixtral decode ln1/ln2/final", "21 a step"),
    (4, 5120, "bfloat16", "deepseek decode ln1/ln2/final",
     "13 a step + the prefill's final norm"),
    (4, 1536, "bfloat16", "deepseek decode q_norm", "6 a step"),
    (4, 512, "bfloat16", "deepseek decode kv_norm", "6 a step"),
    (4, 8192, "bfloat16", "jamba decode ln1/ln2/final",
     "9 a step + the prefill's final norm"),
    (4, 16384, "bfloat16", "jamba decode gated norm", "3 a step"),
    (256, 1536, "float32", "mamba2 client step ln1", "48 + 48 a step"),
    (254, 1536, "float32", "mamba2 client step final norm", "1 + 1 a step"),
    (256, 3072, "float32", "mamba2 client step gated norm",
     "48 + 48 a step"),
    (256, 6144, "bfloat16", "mixtral (1 layer) client step ln1/ln2",
     "2 + 2 a step"),
    (254, 6144, "bfloat16", "mixtral (1 layer) client step final norm",
     "1 + 1 a step"),
]
RMSNORM_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"

# the serving path: full Qwen3-1.7B, 4 prompts of 1024 tokens, 64 generated
SERVE = dict(smoke=False, batch=4, prompt_len=1024, gen=64, device="cuda")
QWEN3_PARAMS = 1_720_574_976

# the Mamba-2 serving path: full Mamba2-780M at the Qwen3 serving cell's shape
MAMBA_PARAMS = 780_259_584
SSD_KERNEL = ("ssd_scan", "src/repro/kernels/ssd_scan.py:92")
# kernel 9 against its plain version: (b, s, nh, hd, ds, chunk) — the
# reference's tests/test_kernels_ssd.py sweep, its chunk-invariance shape at
# three chunks, a chunk that is no tile multiple, hd 128 with chunk cut to s
SSD_SWEEP = [(1, 128, 2, 32, 64, 64), (2, 256, 4, 64, 128, 128),
             (1, 200, 2, 32, 64, 64), (2, 64, 8, 64, 128, 64),
             (1, 192, 2, 32, 64, 32), (1, 192, 2, 32, 64, 64),
             (1, 192, 2, 32, 64, 128), (1, 192, 2, 32, 64, 48),
             (2, 96, 3, 128, 16, 256)]
# the reference's SSD tolerance (rtol = atol): f32 sums in another order and
# exp(cum_t - cum_k) of cumulative decays that cancel most of their digits
SSD_LIMIT = 2e-4

# the flash-attention sweep: (b, sq, sk, h, kvh, hd), options, dtype — the
# reference's tests/test_kernels_attention.py, plus hd 40 and the main shape
FLASH_SWEEP = [
    ((1, 128, 128, 4, 4, 64), {}, "float32"),            # MHA
    ((2, 128, 128, 8, 2, 64), {}, "float32"),            # GQA 4:1
    ((1, 256, 256, 4, 1, 128), {}, "float32"),           # MQA, hd 128
    ((2, 64, 192, 4, 2, 64), {}, "float32"),             # sq < sk
    ((1, 100, 100, 3, 3, 32), {}, "float32"),            # ragged, hd 32
    ((1, 128, 130, 4, 4, 64), {}, "float32"),            # ragged keys
    ((1, 128, 128, 4, 2, 64), {"window": 16}, "float32"),
    ((1, 128, 128, 4, 2, 64), {"window": 64}, "float32"),
    ((1, 128, 128, 4, 2, 64), {"window": 4096}, "float32"),
    ((1, 128, 128, 4, 4, 64), {"softcap": 20.0}, "float32"),
    ((1, 128, 128, 4, 4, 64), {"softcap": 50.0}, "float32"),
    ((1, 128, 128, 4, 4, 64), {"causal": False}, "float32"),
    ((1, 128, 128, 4, 2, 64), {"window": 48, "softcap": 30.0}, "float32"),
    ((1, 128, 128, 4, 2, 64), {}, "bfloat16"),
    ((2, 1, 512, 8, 2, 64), {}, "float32"),              # sq = 1
    ((1, 96, 96, 3, 1, 40), {}, "float32"),              # hd 40
    ((4, 1024, 1024, 16, 8, 128), {}, "float32"),        # serving prefill
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events around the run, after ``warmup`` untimed calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate(torch, fns: dict, reps: int) -> dict:
    """Time each function in turns (a, b, c, c, b, a) and keep the mean of
    its two runs, so a drift in the card's clock hits all alike."""
    order = list(fns) + list(reversed(list(fns)))
    runs: dict = {k: [] for k in fns}
    for name in order:
        runs[name].append(cuda_ms(torch, fns[name], reps))
    return {k: sum(v) / len(v) for k, v in runs.items()}


def host_us(torch, fn, reps: int) -> float:
    """Host time of one call of ``fn`` (the enqueue: no synchronisation
    inside the timed loop), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def device_us(torch, fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: every kernel it launches, summed,
    from the profiler, in microseconds."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages()) / reps


def device_kernels(torch, fn, reps: int = 10) -> dict:
    """Each device kernel that ``fn`` launches, from the profiler: its name
    (template arguments kept), its device microseconds a launch, averaged
    over the launches the profiler recorded, and those launches a call of
    ``fn`` (a session late in this long process may record fewer than were
    made)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen: dict = {}
    for e in prof.key_averages():    # a name may come in more than one group
        us = getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)
        if us:
            name = e.key.split("::")[-2] if "::" in e.key else e.key
            row = seen.setdefault(name.split("(")[0].strip() or e.key, [0, 0])
            row[0] += us
            row[1] += e.count
    return {k: {"us_a_launch": us / n, "launches_recorded_a_call": n / reps}
            for k, (us, n) in seen.items()}


def bf16_steps(torch, got, want) -> int:
    """Most bf16 steps between two bf16 tensors (0 when empty)."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    if not got.numel():
        return 0
    return int((ordered(got) - ordered(want)).abs().max())


def ptxas_entries(log: str) -> list:
    """Each entry function of an ``nvcc -Xptxas -v`` log: its (mangled)
    name, registers, spill-store bytes and stack frame bytes."""
    out, name, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
            stack = int(line.split("bytes stack frame")[0].split()[-1])
        elif "Used " in line and name:
            out.append({"kernel": name,
                        "registers": int(line.split("Used ")[1].split()[0]),
                        "spill_store_bytes": spill,
                        "stack_frame_bytes": stack})
            name = None
    return out


def pipelined_ptxas(log: str) -> list:
    """Kernel 8's instances in ``quantized_wire.cu``'s ptxas log, named as
    ``ops.wire_pipelined_instance_counts()`` names them, with VEC, the
    two-pass body's row bound MT (one template instance per MT in 1, 2, 4,
    ..., 64), registers, spill-store and stack frame bytes."""
    import re
    out = []
    for e in ptxas_entries(log):
        m = re.search(r"pipelined_kernelILi(\d+)ELi(\d+)E", e["kernel"])
        t = re.search(r"pipelined_twopass_kernelILi(\d+)E", e["kernel"])
        if m:
            rg, vec = (int(x) for x in m.groups())
            name, mt = f"vec{vec}.own{rg}", None
        elif t:
            name, vec, mt = "twopass", 1, int(t.group(1))
        else:
            continue
        out.append({"instance": name, "vec": vec, "mt": mt,
                    **{k: e[k] for k in ("registers", "spill_store_bytes",
                                         "stack_frame_bytes")}})
    return out


def bound_ms(n_bytes: float, n_flops: float,
             flop_per_s: float = H100_F32_FLOP_PER_S):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def instance_delta(before: dict, after: dict) -> dict:
    """Kernel 8's launches by instance between two readings."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def rel_err(torch, got, want) -> tuple:
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, err / max(scale, 1e-30)


def row_rel_err(torch, got, want) -> float:
    """The largest error of a row (one query of one head) over that row's
    largest |value|: a row that attends to few keys has large values, one
    that averages thousands has small ones, and a fault in the mask or the
    softcap may show only in the latter."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30))
                 .max())


# kernel 3 in bf16 against its plain version, per row: each side rounds its
# f32 output once to bf16.  Before that the two differ by the order of the
# f32 sums and by the kernel's P, rounded to bf16 for the tensor cores: up to
# 2^-8 of each weight, with l summing the rounded P so that the weights stay
# normalised, which moves an output by up to 2^-8 of a weighted spread of v
# around it -- below 2^-8 of the row's largest |value| (the CPU emulation in
# tests/test_torch_kernels.py measures up to 3.6e-3).  Two f32 values that
# close round at most one bf16 step apart, 2^-7 of the row's largest |value|;
# 1e-3 more for the f32 sums' order
FLASH_BF16_ROW_LIMIT = 2.0 ** -7 + 1e-3
# q's scale in the softcap modes' checks: the scores reach the cap's bend
FLASH_SOFTCAP_Q_SCALE = 8.0


def flash_limit(kw: dict, dtype: str) -> float:
    """The reference's tolerances: f32 sums in another order (2e-5; 5e-5
    through a softcap's tanh), bf16 rounding of the output (2e-2)."""
    if dtype == "bfloat16":
        return 2e-2
    return 5e-5 if "softcap" in kw else 2e-5


def causal_pairs(torch, sq: int, sk: int) -> int:
    """(query, key) pairs a causal mask lets through, queries end-aligned:
    the work any attention must do for these inputs."""
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    return int((torch.arange(sk)[None, :] <= qpos).sum())


@contextlib.contextmanager
def timed_norms():
    """Within the block, every RMSNorm call of the port is counted and its
    host time summed (perf_counter around the call, no synchronisation):
    ``ops.rmsnorm``, each forward (with the autograd Function around the
    kernel when a gradient will be asked for), and the backward wrapper,
    which autograd calls."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    stats = {"fwd_calls": 0, "fwd_host_ms": 0.0, "bwd_calls": 0,
             "bwd_host_ms": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                stats[key + "_calls"] += 1
                stats[key + "_host_ms"] += (time.perf_counter() - t0) * 1e3
        return call
    saved = ops.rmsnorm, rn.rmsnorm_bwd_cuda
    ops.rmsnorm = timed(saved[0], "fwd")
    rn.rmsnorm_bwd_cuda = timed(saved[1], "bwd")
    try:
        yield stats
    finally:
        ops.rmsnorm, rn.rmsnorm_bwd_cuda = saved


@dataclasses.dataclass
class EventSum:
    """One name's row of ``kineto_averages``, in ``key_averages()``'s
    fields (times in µs)."""
    key: str
    on_device: bool
    count: int = 0
    self_cpu_time_total: float = 0.0
    self_device_time_total: float = 0.0


# the events key_averages() leaves out (torch.autograd.profiler_util's
# _filter_name)
_UNLISTED = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def kineto_averages(prof) -> list:
    """``prof.key_averages()`` of a finished ``torch.profiler`` run, summed
    straight from its kineto events: per name, the calls, the self CPU time
    (an event's span less the spans of the events nested in it on its
    thread) and the device time, by ``key_averages()``'s rules: the same
    events left out, ``ProfilerStep*`` for the steps, no self time for an
    async span, an only child of its parent's name folded into it.
    ``key_averages()`` first builds a Python object tree of every event,
    which over a training epoch's events takes about a minute; this takes
    seconds.  ``tests/test_torch_profile_summary.py`` holds the two
    equal."""
    from torch._C._autograd import DeviceType
    rows, spans = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in _UNLISTED or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        if name.startswith("ProfilerStep#"):
            name = "ProfilerStep*"
        on_device = e.device_type() == DeviceType.CUDA
        row = rows.get((name, on_device))
        if row is None:
            row = rows[(name, on_device)] = EventSum(name, on_device)
        row.count += 1
        if on_device:
            row.self_device_time_total += e.duration_ns() / 1e3
        elif e.is_async() or e.start_thread_id() != e.end_thread_id():
            pass            # an async span has no self time, nor children
        else:
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), row))
    for evs in spans.values():          # self time: nesting on one thread
        evs.sort(key=lambda t: (t[0], t[1]))
        # [end_ns, own_ns, children_ns, row, children, last child's row]
        stack = []
        for start, neg_end, row in evs:
            # a span that ends past its would-be parent is not its child
            while stack and (stack[-1][0] <= start or -neg_end > stack[-1][0]):
                _close_span(stack.pop())
            own = -neg_end - start
            if stack:
                stack[-1][2] += own
                stack[-1][4] += 1
                stack[-1][5] = row
            stack.append([-neg_end, own, 0, row, 0, None])
        while stack:
            _close_span(stack.pop())
    return list(rows.values())


def _close_span(span) -> None:
    _, own, children, row, n_children, child_row = span
    row.self_cpu_time_total += (own - children) / 1e3
    if n_children == 1 and child_row is row:
        # key_averages() folds an only child of the same name (an op that
        # calls its own overload) into its parent: one call, the same time
        row.count -= 1


def profile_summary(prof, wall_s: float, top: int = 12,
                    norms: dict = None) -> dict:
    """Device busy time, the top device kernels and host ops, and the port's
    own kernels' device times, from a ``torch.profiler`` run (times in ms;
    the profiler adds host overhead, so its wall time is longer than an
    unprofiled epoch's, while device kernel times are not inflated).
    ``norms``, from ``timed_norms`` around the same run, adds the RMSNorm
    calls, their host time and their kernels' device time.  Adds
    ``summary_s``, the seconds this summary took."""
    t0 = time.perf_counter()

    def dev_us(e):
        return e.self_device_time_total
    events = kineto_averages(prof)
    kernels = [e for e in events if e.on_device]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    ours = [e for e in kernels if any(
        k in e.key for k in ("consensus_mix", "rmsnorm",
                             "flash_fwd", "encode_kernel", "bucketed_kernel",
                             "pipelined_kernel", "leaf_kernel",
                             "quant_mix_kernel", "ssd_scan_kernel"))]
    host = sorted((e for e in events if not e.on_device),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:top]

    def row(e):
        return {"name": e.key[:80], "calls": e.count,
                "total_ms": dev_us(e) / 1e3,
                "avg_us": dev_us(e) / max(e.count, 1)}
    extra = {}
    if norms is not None:
        calls = norms["fwd_calls"] + norms["bwd_calls"]
        host_ms = norms["fwd_host_ms"] + norms["bwd_host_ms"]
        extra["norms"] = dict(
            norms, calls=calls, host_ms=host_ms,
            host_us_per_call=host_ms * 1e3 / max(calls, 1),
            device_ms=sum(dev_us(e) for e in kernels
                          if "rmsnorm" in e.key) / 1e3)
    return {
        **extra, "summary_s": time.perf_counter() - t0,
        "wall_s": wall_s, "device_busy_ms": device_ms,
        "device_busy_share_of_profiled_wall": device_ms / (wall_s * 1e3),
        "top_device": [row(e) for e in sorted(kernels, key=dev_us,
                                              reverse=True)[:top]],
        "port_kernels": [row(e) for e in ours],
        "top_host": [{"name": e.key[:80], "calls": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in host]}


def profile_serving(torch, params, cfg, prompt, prefill_kw: dict,
                    phases: tuple, steps: int = 8) -> None:
    """Prefill ``prompt`` on the kernel route and decode ``steps`` greedy
    tokens under the profiler (the first phase's line), then the same
    decode steps timed alone, each synchronised (the second's)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as ttf
    kw = dict(prefill_kw, max_len=prompt.shape[1] + steps,
              opts=ttf.ApplyOptions(attn_impl="kernel"))

    def prefill():
        return ttf.prefill(params, cfg, {"tokens": prompt}, **kw)

    def step(logits, cache):
        return ttf.decode_step(params, cfg, logits[:, -1].argmax(-1)[:, None],
                               cache)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            timed_norms() as norms:
        t0 = time.perf_counter()
        logits, cache = prefill()
        for _ in range(steps):
            logits, cache = step(logits, cache)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    emit(phases[0], steps=steps,
         **profile_summary(prof, wall_s, norms=norms))
    logits, cache = prefill()
    torch.cuda.synchronize()
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = step(logits, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    emit(phases[1], step_s=step_s)


def disagreement_f64(torch, leaves) -> float:
    """The deviation norm ||W - 1 wbar'||_F of (M, ...) leaves, summed in
    float64 over column blocks (the epoch record's f32 form cancels to noise
    at full width)."""
    dev_sq = 0.0
    for leaf in leaves:
        flat = leaf.reshape(leaf.shape[0], -1)
        for lo in range(0, flat.shape[1], 1 << 24):
            c = flat[:, lo:lo + (1 << 24)].double()
            dev_sq += float(((c - c.mean(0)) ** 2).sum())
    return dev_sq ** 0.5


@contextlib.contextmanager
def period_disagreement(torch, tree_leaves, owner, attr: str,
                        before=lambda tree: tree, after=lambda out: out,
                        extra=None):
    """Within the block, every call of the consensus period ``owner.attr``
    (a method) records the float64 disagreement of the server models
    before it (``before`` of its first argument) and after it (``after`` of
    its result), ``extra(result)``'s fields, and the seconds the readings
    took (they fall inside the epoch's time)."""
    records = []
    inner = getattr(owner, attr)
    own = attr in vars(owner)

    def measured(self, tree, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dis0 = disagreement_f64(torch, tree_leaves(before(tree)))
        cost = time.perf_counter() - t0
        out = inner(self, tree, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dis1 = disagreement_f64(torch, tree_leaves(after(out)))
        rec = {"before": dis0, "after": dis1, "ratio": dis1 / dis0}
        if extra is not None:
            rec.update(extra(out))
        rec["measure_s"] = cost + time.perf_counter() - t0
        records.append(rec)
        return out

    setattr(owner, attr, measured)
    try:
        yield records
    finally:
        if own:
            setattr(owner, attr, inner)
        else:
            delattr(owner, attr)


def wire_period_disagreement(torch, cns, tree_leaves):
    """``period_disagreement`` of every physical-wire period."""
    return period_disagreement(torch, tree_leaves, cns.CompressedBackend,
                               "mix_compressed", after=lambda out: out[0])


# ---------------------------------------------------------------------------
# dynamic federation: the engine path and one period at M = 3
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def per_epoch_readings(torch, ops, engine_cls):
    """Within the block, every ``run_epoch`` of the engine records the
    kernel launches it made and the device's peak memory during it."""
    records = []
    inner = engine_cls.run_epoch

    def measured(self, *args, **kw):
        before = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = inner(self, *args, **kw)
        after = ops.launch_counts()
        records.append({"launches": {k: after[k] - before[k] for k in after
                                     if after[k] != before[k]},
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        return out

    engine_cls.run_epoch = measured
    try:
        yield records
    finally:
        engine_cls.run_epoch = inner


def dynamic_federation(torch, ttrain, ops) -> dict:
    """The dynamic path through ``train_dynamic``: launches, M, memory and
    the epoch step's builds per M, then one Chebyshev epoch."""
    import numpy as np
    from repro_torch.core.engine import DynamicFederationEngine
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with per_epoch_readings(torch, ops, DynamicFederationEngine) as epochs:
        run = ttrain.train_dynamic("smollm-360m", **DYN_TRAIN)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    hist, engine = run["history"], run["engine"]
    t_s, n_ep = DYN_TRAIN["t_server"], DYN_TRAIN["epochs"]
    norms_per_step = 2 * run["cfg"].num_layers + 1
    client_steps = sum(int(m) * DYN_TRAIN["clients"] * DYN_TRAIN["t_client"]
                       for m in hist["num_servers"])
    emit("train_dynamic", arch="smollm-360m", loss=hist["loss"],
         num_servers=hist["num_servers"],
         participation=hist["participation"],
         sigma_prod=hist["sigma_prod"], disagreement=hist["disagreement"],
         epoch_s=hist["epoch_s"], alloc_gb=hist["alloc_gb"],
         epoch_peak_gb=[e["peak_gb"] for e in epochs],
         epoch_launches=[e["launches"] for e in epochs],
         launches=launches, builds_per_m=engine.compile_counts(),
         replica_gb=SMOLLM_REPLICA_GB)
    assert hist["num_servers"] == [4.0, 3.0, 4.0], hist["num_servers"]
    assert all(e["launches"].get("consensus_mix") == t_s for e in epochs), \
        epochs
    assert launches["consensus_mix"] == t_s * n_ep, launches
    assert launches["rmsnorm_fwd"] == norms_per_step * client_steps
    assert launches["rmsnorm_bwd"] == norms_per_step * client_steps
    assert all(launches[k] == 0 for k in WIRE_KERNELS), launches
    assert launches[SIM_KERNEL[0]] == 0 and launches["ssd_scan"] == 0
    assert launches["flash_attention"] == 0, launches
    assert engine.compile_counts() == {4: 1, 3: 1}, engine.compile_counts()
    assert all(np.isfinite(hist["loss"])), hist["loss"]
    # the drop frees the dropped server's two client replicas, the rejoin
    # takes them back
    alloc = hist["alloc_gb"]
    two = 2 * SMOLLM_REPLICA_GB
    assert alloc[0] - alloc[1] > 0.9 * two, alloc
    assert abs(alloc[2] - alloc[0]) < 0.1 * two, alloc
    row = {"epoch_s": hist["epoch_s"], "alloc_gb": alloc,
           "epoch_peak_gb": [e["peak_gb"] for e in epochs]}
    del run, engine
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    cheb = dict(DYN_TRAIN, epochs=1, faults="", consensus_mode="chebyshev")
    with per_epoch_readings(torch, ops, DynamicFederationEngine) as epochs:
        run = ttrain.train_dynamic("smollm-360m", **cheb)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    hist = run["history"]
    rounds = int(np.ceil(np.sqrt(t_s)))
    emit("train_dynamic_chebyshev", loss=hist["loss"],
         participation=hist["participation"], sigma_prod=hist["sigma_prod"],
         disagreement=hist["disagreement"], epoch_s=hist["epoch_s"],
         epoch_peak_gb=[e["peak_gb"] for e in epochs],
         launches=launches, expected_consensus_mix=rounds)
    assert launches["consensus_mix"] == rounds, launches
    assert all(np.isfinite(hist["loss"])), hist["loss"]
    row["chebyshev_epoch_s"] = hist["epoch_s"]
    row["chebyshev_peak_gb"] = epochs[0]["peak_gb"]
    del run
    torch.cuda.empty_cache()
    return row


def dynamic_period_full_size(torch, cns, tp, ttf, dfl, ops, ref,
                             tree_leaves, tree_map) -> dict:
    """One dynamic period at full width and M = 3, N = 2: random client
    trees around seeded SmolLM weights, a Bernoulli mask with an idle
    client and at least one participant a server, and an edge-dropped A_p;
    the masked mean and the T_S kernel-1 rounds on A_p each against their
    plain versions, the server mean and disagreement in float64, and
    kernel 1's time at M = 3 against its byte bound."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.schedule import (ParticipationSchedule,
                                           TopologySchedule)
    dev = torch.device("cuda")
    m, n, t_s = 3, 2, DYN_TRAIN["t_server"]
    topo = tp.FLTopology(num_servers=m, clients_per_server=n, t_client=1,
                         t_server=t_s, graph_kind="ring")
    part = ParticipationSchedule(kind="bernoulli", rate=0.5, seed=0)
    tsched = TopologySchedule(kind="edge_drop", drop_prob=0.3, seed=1)
    epoch = next(e for e in range(100)
                 if (part.mask(e, m, n) == 0).any()
                 and not np.array_equal(tsched.mixing(topo, e),
                                        topo.mixing_matrix()))
    mask_np, a_np = part.mask(epoch, m, n), tsched.mixing(topo, epoch)
    g = torch.Generator(device=dev).manual_seed(3)
    base = ttf.init_params(g, get_arch("smollm-360m"), device=dev)
    clients = tree_map(lambda p: p[None, None] + 0.01 * torch.randn(
        (m, n) + tuple(p.shape), device=dev, generator=g), base)
    del base
    mask = torch.as_tensor(mask_np, dtype=torch.float32, device=dev)
    a_p = torch.as_tensor(a_np, dtype=torch.float32, device=dev)

    # the masked mean against a float64 plain mean over the participants
    server = dfl.masked_server_mean(clients, mask)
    mean_rel = 0.0
    for c, s_ in zip(tree_leaves(clients), tree_leaves(server)):
        mk = mask.double().reshape((m, n) + (1,) * (c.dim() - 2))
        want = (c.double() * mk).sum(1) / mk.sum(1)
        err, scale = float((s_.double() - want).abs().max()), float(
            want.abs().max())
        mean_rel = max(mean_rel, err / scale)
        del want
    del clients
    torch.cuda.empty_cache()
    assert mean_rel < 1e-6, mean_rel

    # the period on A_p: kernel 1 T_S times, against the plain rounds
    def f64_stats(tree):
        means = [leaf.reshape(m, -1).double().mean(0)
                 for leaf in tree_leaves(tree)]
        return means, disagreement_f64(torch, tree_leaves(tree))

    mean0, dis0 = f64_stats(server)
    ops.reset_launch_counts()
    mixed = cns.make_backend("gossip", topo.mixing_matrix(), t_s).mix(
        server, a_p)
    torch.cuda.synchronize()
    period_launches = ops.launch_counts()["consensus_mix"]
    plain = cns.gossip_scan(a_p, server, t_s)
    vs_plain = max(rel_err(torch, p, q)[1]
                   for p, q in zip(tree_leaves(mixed), tree_leaves(plain)))
    del plain
    mean1, dis1 = f64_stats(mixed)
    keep_err = max(float((p - q).abs().max()) for p, q in zip(mean0, mean1))
    keep_scale = max(float(p.abs().max()) for p in mean0)
    sigma = tp.sigma_a(a_np, t_s)
    del mixed, server, mean0, mean1
    torch.cuda.empty_cache()
    assert period_launches == t_s, period_launches
    assert vs_plain < 1e-5, vs_plain
    assert keep_err / keep_scale <= 1e-6, keep_err / keep_scale
    assert dis1 < dis0, (dis0, dis1)

    # kernel 1 at M = 3 (the MT = 4 instance, one zero-padded row) on A_p
    w = torch.randn((m, SMOLLM_PARAMS), device=dev, generator=g)
    out = torch.empty_like(w)
    err, rel = rel_err(torch, ops.consensus_mix(a_p, w, out=out),
                       ref.consensus_mix_ref(a_p, w))
    assert rel < 1e-5, rel
    times = alternate(torch, {
        "kernel": lambda: ops.consensus_mix(a_p, w, out=out),
        "plain": lambda: ref.consensus_mix_ref(a_p, w),
        "library": lambda: torch.matmul(a_p, w)}, reps=10)
    n_bytes = 2 * m * SMOLLM_PARAMS * 4 + m * m * 4
    bound, by = bound_ms(n_bytes, 2 * m * m * SMOLLM_PARAMS)
    del w, out
    torch.cuda.empty_cache()
    row = {"m": m, "n": n, "epoch": epoch, "mask": mask_np.tolist(),
           "a_p": a_np.tolist(), "masked_mean_max_rel_err": mean_rel,
           "period_launches": period_launches,
           "period_vs_plain_max_rel_err": vs_plain,
           "mean_kept_max_rel_err": keep_err / keep_scale,
           "disagreement_before": dis0, "disagreement_after": dis1,
           "ratio": dis1 / dis0, "sigma_a": sigma,
           "kernel_max_abs_err": err, "kernel_max_rel_err": rel,
           "kernel_ms": times["kernel"], "plain_ms": times["plain"],
           "library_ms": times["library"], "bound_ms": bound,
           "bound_by": by, "bound_share": bound / times["kernel"]}
    emit("dynamic_period_full_size", **row)
    return row


# ---------------------------------------------------------------------------
# the physical wire: comparisons and plain periods on column slabs
# ---------------------------------------------------------------------------


def wire_compare(torch, got, want) -> dict:
    """The wire's limits: scales identical; codes identical but for a
    counted few that differ by exactly one step (at most 1e-6 of the
    codes); f32 outputs exact wherever the codes agree."""
    codes = [(g, w) for g, w in zip(got, want) if g.dtype == torch.int8]
    agree = None
    off_by_one, n_codes = 0, 0
    for g, w in codes:
        diff = (g.int() - w.int()).abs()
        assert int(diff.max()) <= 1, int(diff.max())
        off_by_one += int((diff == 1).sum())
        n_codes += diff.numel()
        agree = diff == 0
    assert off_by_one <= 1e-6 * n_codes, (off_by_one, n_codes)
    max_err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.int8:
            continue
        if agree is not None and g.shape == agree.shape:
            err = float(((g - w).abs() * agree).max())
        else:
            err = float((g - w).abs().max())
            assert err == 0.0, ("scales differ", err)
        assert err == 0.0, err
        max_err = max(max_err, err)
    return {"codes_off_by_one": off_by_one, "codes": n_codes,
            "max_abs_err": max_err}


def slab_dither(torch, cp, key, m, lo, hi, *, leaf=0, rnd, block=0,
                real=None, device):
    """(m, hi - lo) wire dither of bucket (or block) columns [lo, hi): the
    cell (leaf, rnd, server, block) of every server; columns at or past
    ``real`` (a block's pad) get 0, as the period gives them."""
    out = torch.zeros((m, hi - lo), dtype=torch.float32, device=device)
    stop = hi if real is None else min(hi, real)
    for s in range(m):
        if stop > lo:
            cp.wire_dither(key, stop, leaf=leaf, rnd=rnd, server=s,
                           block=block, start=lo, stop=stop,
                           out=out[s, :stop - lo])
    return out


def plain_bucketed_slab(torch, ref, cp, a, x, key, lo, t_s, staleness,
                        bits, chunk):
    """The bucketed wire period of ``x`` = bucket columns [lo, lo + n) with
    the plain versions (acc after ``t_s`` rounds)."""
    m, n = x.shape
    kw = dict(bits=bits, chunk=chunk)

    def u(rnd):
        return slab_dither(torch, cp, key, m, lo, lo + n, rnd=rnd,
                           device=x.device)

    zeros = torch.zeros_like(x)
    r, acc = zeros, zeros
    if staleness == 0:
        c, s = ref.quantized_gossip_encode_ref(x, zeros, u(0), **kw)
        for t in range(t_s):
            acc, r, c, s = ref.bucketed_gossip_round_ref(
                a, c, s, r, acc, u(min(t + 1, t_s - 1)), **kw)
        return acc
    ring = [(torch.zeros((m, n), dtype=torch.int8, device=x.device),
             torch.ones((m, n // chunk), device=x.device))
            for _ in range(staleness)]
    w = x
    for t in range(t_s):
        acc, r, c, s = ref.bucketed_gossip_round_pipelined_ref(
            a, *ring[t % staleness], w, r, acc, u(t), **kw)
        ring[t % staleness] = (c, s)
        if t >= staleness:
            w = acc
    return w


def plain_leaf_slab(torch, ref, cp, a, x, key, leaf, block, lo, real, t_s,
                    bits, chunk):
    """The per-leaf wire period of ``x`` = columns [lo, lo + n) of block
    ``block`` of leaf ``leaf`` (its ``real`` first columns are data, the
    rest pad) with the plain versions (the iterate after ``t_s`` rounds)."""
    m, n = x.shape
    kw = dict(bits=bits, chunk=chunk)

    def u(rnd):
        return slab_dither(torch, cp, key, m, lo, lo + n, leaf=leaf, rnd=rnd,
                           block=block, real=real, device=x.device)

    r = torch.zeros_like(x)
    c, s = ref.quantized_gossip_encode_ref(x, r, u(0), **kw)
    mixed = x
    for t in range(t_s):
        mixed, r, c, s = ref.quantized_gossip_round_ref(
            a, c, s, r, u(min(t + 1, t_s - 1)), **kw)
    return mixed


# ---------------------------------------------------------------------------
# Mamba-2 serving: kernel 9 and the path that runs it
# ---------------------------------------------------------------------------


def ssd_inputs(torch, g, b, s, nh, hd, ds, *, a=None, dtype="float32"):
    """Kernel 9's operands in the model's layout: x, B and C are views into
    one (b, s, nh*hd + 2*ds) tensor, as the mixer splits its conv output;
    x ~ N(0, 1), B and C ~ N(0, 0.25), dt = softplus(N(0, 1)), A =
    -exp(linspace(-1, 1)) unless given."""
    dev = torch.device("cuda")
    xbc = torch.randn((b, s, nh * hd + 2 * ds), device=dev, generator=g)
    xbc[..., nh * hd:] *= 0.5
    xbc = xbc.to(getattr(torch, dtype))
    xs = xbc[..., :nh * hd].view(b, s, nh, hd)
    bs = xbc[..., nh * hd:nh * hd + ds].view(b, s, 1, ds)
    cs = xbc[..., nh * hd + ds:].view(b, s, 1, ds)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), device=dev, generator=g))
    if a is None:
        a = -torch.exp(torch.linspace(-1.0, 1.0, nh, device=dev))
    return xs, bs, cs, dt, a


def ssd_work(b, s, nh, hd, ds, chunk):
    """The flops and bytes the SSD scan needs on these shapes.  Flops per
    chunk of r steps, counting only the r(r+1)/2 causal (t, k) pairs: C.B'
    once per (batch, chunk), since B and C are one group shared by every
    head; per (batch, head) the scores times x, C.h and the state update.
    Bytes: each input read once (f32), y and the final state written once.
    Also returns the flops with C.B' per head, as the TPU kernel and kernel
    9 compute it."""
    q = min(chunk, s)
    shared, per_head = 0, 0
    for c0 in range(0, s, q):
        r = min(q, s - c0)
        pairs = r * (r + 1) // 2
        shared += b * pairs * 2 * ds
        per_head += b * nh * (pairs * 2 * hd + 2 * 2 * r * ds * hd)
    n_bytes = 4 * (2 * b * s * nh * hd + 2 * b * s * ds + b * s * nh + nh
                   + b * nh * ds * hd)
    return shared + per_head, n_bytes, shared * nh + per_head


def mamba_serving(torch, g, serve_shape: dict) -> dict:
    """The Mamba-2 phases; returns kernel 9's row of the ``kernels`` line."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve as tserve
    from repro_torch.models import mamba as tmm
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")

    def close(got, want):
        """Max abs and relative (to the largest |want|) error over (y,
        state), after holding both to the reference's SSD tolerance."""
        errs = [rel_err(torch, g_, w_) for g_, w_ in zip(got, want)]
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32 and g_.shape == w_.shape
            torch.testing.assert_close(g_, w_, rtol=SSD_LIMIT,
                                       atol=SSD_LIMIT)
        return max(e[0] for e in errs), max(e[1] for e in errs)

    # ---- a. kernel 9 vs its plain version ----
    cfg = get_arch("mamba2-780m")
    m = cfg.mamba
    nh, hd, ds = m.num_heads(cfg.d_model), m.head_dim, m.d_state
    b, s_len = serve_shape["batch"], serve_shape["prompt_len"]
    a48 = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
    cases = [(shape, {}) for shape in SSD_SWEEP] + [
        ((2, 160, 4, 64, 128, 64), {"dtype": "bfloat16"}),
        ((1, 512, nh, hd, ds, m.chunk_size), {"a": a48}),
        ((b, s_len, nh, hd, ds, m.chunk_size), {"a": a48})]   # main shape
    for (bb, s, h_, p_, n_, chunk), kw in cases:
        args = ssd_inputs(torch, g, bb, s, h_, p_, n_, **kw)
        err, rel = close(ops.ssd_scan(*args, chunk=chunk),
                         ref.ssd_scan_chunked_ref(*args, chunk=chunk))
        torch.cuda.synchronize()
        emit("ssd_kernel_check", shape=[bb, s, h_, p_, n_, chunk],
             dtype=kw.get("dtype", "float32"),
             a="-(1..nh)" if "a" in kw else "-exp(linspace(-1, 1))",
             x_contiguous=args[0].is_contiguous(), max_abs_err=err,
             max_rel_err=rel, limit=SSD_LIMIT)
    args = ssd_inputs(torch, g, 2, 96, 4, 32, 64)
    y, st = ops.ssd_scan(args[0], args[1], args[2],
                         torch.zeros_like(args[3]), args[4], chunk=32)
    emit("ssd_kernel_check", case="dt = 0", y_max=float(y.abs().max()),
         state_max=float(st.abs().max()))
    assert not y.any() and not st.any()
    y, _ = ops.ssd_scan(*args[:4], torch.full_like(args[4], -1e4), chunk=32)
    own = torch.einsum("bsn,bsn,bsh,bshp->bshp", args[2][:, :, 0],
                       args[1][:, :, 0], args[3], args[0])
    err, rel = rel_err(torch, y, own)
    emit("ssd_kernel_check", case="A = -1e4: y_t = its own step's term",
         max_abs_err=err, max_rel_err=rel, limit=SSD_LIMIT)
    torch.testing.assert_close(y, own, rtol=SSD_LIMIT, atol=SSD_LIMIT)

    # ---- b. serving: full Mamba2-780M through serve() ----
    # a short run at the same widths and batch first, so that the timed run
    # holds none of the first calls' set-up
    tserve.serve("mamba2-780m", **{**serve_shape, "prompt_len": 16,
                                   "gen": 2})
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    res = tserve.serve("mamba2-780m", **serve_shape)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    norms_per_pass = 2 * cfg.num_layers + 1     # ln1, the gated norm; final
    expected = {k: 0 for k in launches}
    expected.update(ssd_scan=cfg.num_layers,
                    rmsnorm_fwd=norms_per_pass * serve_shape["gen"])
    generated = res["generated"]
    gen = serve_shape["gen"]
    emit("serve_mamba", arch="mamba2-780m", batch=b, prompt_len=s_len,
         gen=gen, prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         tok_per_s=res["tok_per_s"],
         prefill_tok_per_s=b * s_len / res["prefill_s"],
         peak_mem_gb=(torch.cuda.max_memory_allocated() - baseline) / 1e9,
         launches=launches, expected_launches=expected,
         first_row=generated[0, :16].tolist())
    assert launches == expected, launches
    assert tuple(generated.shape) == (b, gen)
    assert 0 <= int(generated.min()) and \
        int(generated.max()) < cfg.vocab_size

    # ---- c. checked, on the weights and prompt serve() drew from seed 0:
    # the kernel route's prefill against the reference route (ssd_chunked)
    # on the logits; every layer's mixer output and SSM state on the two
    # routes from the same layer input (the reference route's); decode
    # against a full forward ----
    rng = torch.Generator(device=dev).manual_seed(0)
    params = ttf.init_params(rng, cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompt = torch.randint(0, cfg.vocab_size, (b, s_len), generator=rng,
                           device=dev)
    assert n_params == MAMBA_PARAMS, n_params
    assert torch.equal(prompt, res["prompt"])
    kernel_opts = ttf.ApplyOptions(attn_impl="kernel")
    prefill = dict(max_len=s_len + 4, cache_dtype=torch.float32)
    vocab = cfg.vocab_size       # the padded ids' logits are -1e30 on all
    ref_logits, ref_cache = ttf.prefill(params, cfg, {"tokens": prompt},
                                        **prefill)
    # the reference route at half the chunk: the same scan with its sums
    # grouped otherwise, so its distance from the reference route is what
    # 48 random layers make of rounding alone
    cfg128 = dataclasses.replace(cfg, mamba=dataclasses.replace(
        m, chunk_size=m.chunk_size // 2))
    alt_logits, alt_cache = ttf.prefill(params, cfg128, {"tokens": prompt},
                                        **prefill)
    ops.reset_launch_counts()
    logits, cache = ttf.prefill(params, cfg, {"tokens": prompt},
                                opts=kernel_opts, **prefill)
    torch.cuda.synchronize()
    prefill_launches = ops.launch_counts()
    pf_err, pf_rel = rel_err(torch, logits[..., :vocab],
                             ref_logits[..., :vocab])
    chunk_err = rel_err(torch, alt_logits[..., :vocab],
                        ref_logits[..., :vocab])[0]

    def drift(c):                 # per layer, relative to the largest |h|
        return [rel_err(torch, c["stack"][0]["mixer"]["ssm"][i],
                        ref_cache["stack"][0]["mixer"]["ssm"][i])[1]
                for i in range(cfg.num_layers)]
    kernel_drift, chunk_drift = drift(cache), drift(alt_cache)
    del ref_logits, ref_cache, alt_logits, alt_cache
    assert prefill_launches["ssd_scan"] == cfg.num_layers, prefill_launches
    assert prefill_launches["rmsnorm_fwd"] == norms_per_pass
    assert prefill_launches["flash_attention"] == 0
    # the kernel route is no further from the reference route than the
    # reference route is from itself at another chunk, with a factor of 2
    # for the spread of such rounding walks
    assert pf_err <= 2 * chunk_err, (pf_err, chunk_err)
    layer_out, layer_state = [], []
    with torch.inference_mode():
        x = ttf._embed(params, cfg, prompt)
        for _, layer in ttf._per_layer(params["stack"],
                                       ttf.stack_plan(cfg).n_periods):
            h = ops.rmsnorm(x, layer["ln1"]["scale"], cfg.norm_eps)
            mix, c_ref = tmm.mamba_prefill(layer["mixer"], h, cfg,
                                           impl="reference")
            mix_k, c_k = tmm.mamba_prefill(layer["mixer"], h, cfg,
                                           impl="kernel")
            layer_out.append(rel_err(torch, mix_k, mix)[1])
            layer_state.append(rel_err(torch, c_k["ssm"], c_ref["ssm"])[1])
            x = x + mix
        del x, h, mix, mix_k, c_ref, c_k
    assert max(layer_state) < SSD_LIMIT and max(layer_out) < SSD_LIMIT, \
        (layer_state, layer_out)
    nxt = logits[:, -1].argmax(-1)[:, None]
    assert torch.equal(nxt, generated[:, :1]), "prefill differs from serve()"
    # decode against a full forward on the same (kernel) route, as the
    # reference's test_decode_matches_forward runs prefill, decode and
    # forward with one set of options
    toks, dec_errs, decode_launches = prompt, [], []
    for _ in range(3):
        toks = torch.cat([toks, nxt], dim=1)
        ops.reset_launch_counts()
        logits, cache = ttf.decode_step(params, cfg, nxt, cache)
        decode_launches.append(ops.launch_counts())
        with torch.inference_mode():
            full, _ = ttf.forward(params, cfg, {"tokens": toks},
                                  opts=kernel_opts)
        want = full[:, -1]
        del full
        dec_errs.append(rel_err(torch, logits[:, 0], want)[0])
        torch.testing.assert_close(logits[:, 0], want, rtol=2e-3, atol=2e-3)
        nxt = logits[:, -1].argmax(-1)[:, None]
    assert all(d["ssd_scan"] == 0 and d["rmsnorm_fwd"] == norms_per_pass
               for d in decode_launches), decode_launches
    emit("serve_mamba_check", params=n_params,
         prefill_launches=prefill_launches,
         decode_step_launches=decode_launches[0],
         prefill_max_abs_err=pf_err, prefill_max_rel_err=pf_rel,
         reference_chunk128_max_abs_err=chunk_err,
         prefill_limit="2 x reference_chunk128_max_abs_err",
         layer_ssm_state_max_rel_err=layer_state,
         layer_mixer_out_max_rel_err=layer_out, layer_limit=SSD_LIMIT,
         full_run_ssm_state_rel_drift=kernel_drift,
         full_run_ssm_state_rel_drift_chunk128=chunk_drift,
         decode_vs_forward_max_abs_err=dec_errs, decode_limit=2e-3,
         forward_keys=toks.shape[1])
    del cache, logits, want

    # ---- d. kernel 9 at the prefill's shape: times and bound ----
    args = ssd_inputs(torch, g, b, s_len, nh, hd, ds, a=a48)
    chunk = m.chunk_size
    got = ops.ssd_scan(*args, chunk=chunk)
    ssd_err = rel_err(torch, got[0], ref.ssd_scan_chunked_ref(
        *args, chunk=chunk)[0])[0]
    del got
    times = alternate(torch, {
        "kernel": lambda: ops.ssd_scan(*args, chunk=chunk),
        "plain": lambda: ref.ssd_scan_chunked_ref(*args, chunk=chunk)},
        reps=10)
    flops, n_bytes, flops_cb_per_head = ssd_work(b, s_len, nh, hd, ds, chunk)
    ssd_bound, ssd_by = bound_ms(n_bytes, flops)
    ssd_dev = device_kernels(torch, lambda: ops.ssd_scan(*args, chunk=chunk))
    emit("ssd_main_shape", shape=[b, s_len, nh, hd, ds, chunk],
         kernel_ms=times["kernel"], plain_ms=times["plain"], library_ms=None,
         max_abs_err=ssd_err, flops=flops,
         flops_cb_per_head=flops_cb_per_head, bytes=n_bytes,
         bound_ms=ssd_bound, bound_by=ssd_by,
         bound_ms_cb_per_head=bound_ms(n_bytes, flops_cb_per_head)[0],
         kernel_TFLOPs=flops / times["kernel"] / 1e9,
         computed_TFLOPs=flops_cb_per_head / times["kernel"] / 1e9,
         bound_share=ssd_bound / times["kernel"],
         prefill_share=times["kernel"] * cfg.num_layers
         / (res["prefill_s"] * 1e3),
         dynamic_smem_bytes=ssd.smem_bytes(hd, ds, chunk),
         ptxas=[line.strip() for line in
                _build.build_logs.get("ssd_scan", "").splitlines()
                if "Used" in line or "spill" in line],
         device_us=ssd_dev,
         device_kernels_per_call=len(ssd_dev),
         blocks=ssd.blocks(b, s_len, nh, hd, ds, chunk),
         ptxas_instances=ptxas_entries(_build.build_logs.get("ssd_scan", "")))
    del args

    # ---- e. where the serving time goes ----
    profile_serving(torch, params, cfg, prompt, prefill,
                    ("serve_mamba_profile", "mamba_decode_steps"))
    del params
    torch.cuda.empty_cache()
    return {"name": SSD_KERNEL[0], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": SSD_KERNEL[1], "launches": launches["ssd_scan"],
            "max_abs_err": ssd_err, "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": ssd_bound,
            "bound_by": ssd_by, "library_ms": None}


# ---------------------------------------------------------------------------
# the dense zoo families: kernel 1's bf16 instance, kernel 3's new modes,
# bf16 leaves through Algorithm 1 and the wires, and four serving paths
# ---------------------------------------------------------------------------

# the serving paths: full width and depth, weights from seed 0
ZOO = {
    # bf16 weights (the published dtype; 54.4 / 60.6 GB), driven through
    # init_params(dtype=bf16), prefill, decode_step and sample_token, the
    # loop serve() runs; a prompt past Gemma-2's 4096 window
    "gemma2-27b": dict(dtype="bfloat16", batch=2, prompt_len=6144, gen=32),
    "command-r-35b": dict(dtype="bfloat16", batch=4, prompt_len=1024,
                          gen=64),
    # f32 through serve(): 256 patches ahead of the prompt (max_len covers
    # them), and 1024 frames through the encoder
    "internvl2-1b": dict(dtype="float32", batch=4, prompt_len=1024, gen=64,
                         max_len=256 + 1024 + 64),
    "seamless-m4t-large-v2": dict(dtype="float32", batch=4, prompt_len=1024,
                                  gen=64),
}
# kernel 3's modes on the zoo's prefills: (name, arch, b, s, h, kvh, hd,
# options, dtype, heads held against the plain version (None: all))
FLASH_ZOO = [
    ("gemma2_local", "gemma2-27b", 2, 6144, 32, 16, 128,
     {"window": 4096, "softcap": 50.0}, "bfloat16", 4),
    ("gemma2_global", "gemma2-27b", 2, 6144, 32, 16, 128,
     {"softcap": 50.0}, "bfloat16", 4),
    ("command_r", "command-r-35b", 4, 1024, 64, 8, 128, {}, "bfloat16", 16),
    ("internvl2", "internvl2-1b", 4, 1280, 14, 2, 64, {}, "float32", None),
    ("seamless_encoder", "seamless-m4t-large-v2", 4, 1024, 16, 16, 64,
     {"causal": False}, "float32", None),
    ("seamless_decoder", "seamless-m4t-large-v2", 4, 1024, 16, 16, 64, {},
     "float32", None),
    # Mixtral-8x22B: group 6 (two heads a block), window 4096, bf16, a
    # prompt past the window
    ("mixtral", "mixtral-8x22b", 2, 6144, 48, 8, 128, {"window": 4096},
     "bfloat16", 6),
]

# The MoE and MLA families, bf16 (their published dtype), full width at a
# cut depth (one H100 holds 80 GB), driven through init_params(dtype=bf16),
# prefill (drop-free MoE, as serve() sets it), decode_step and sample_token:
#   mixtral-8x22b: 10 of 56 layers (all MoE, all local), 2 x 6144 (past the
#     4096 window), 32 generated;
#   deepseek-v2-236b: the dense prefix layer + 5 MoE layers (6 of 60);
#   jamba-1.5-large-398b: 4 layers whose period keeps the published
#     pairings -- MoE only on mamba layers (every_2: layers 1 and 3), a
#     dense FFN on the attention layer and on a mamba layer, mamba ahead of
#     attention; the published 8-layer period (MoE on its four mamba
#     layers) weighs ~90.4 GB in bf16, more than the card.
MOE_ZOO = {
    "mixtral-8x22b": dict(num_layers=10, batch=2, prompt_len=6144, gen=32),
    "deepseek-v2-236b": dict(num_layers=6, batch=4, prompt_len=1024, gen=64),
    "jamba-1.5-large-398b": dict(
        num_layers=4, layer_pattern=("mamba", "mamba", "global", "mamba"),
        batch=4, prompt_len=1024, gen=64),
}
# kernel 3's modes on these prefills, by the FLASH_ZOO row they time (Jamba's
# is Command-R's mode, whose row keeps Command-R's launches)
MOE_MODES = {"mixtral-8x22b": {"bfloat16/6/128/True/4096/None": "mixtral"},
             "deepseek-v2-236b": {},
             "jamba-1.5-large-398b": {"bfloat16/8/128/True/None/None":
                                      "command_r"}}


def attn_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, queries end-aligned: the
    work any attention must do for these inputs."""
    qpos = np.arange(sq) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


@contextlib.contextmanager
def reference_route_regrouped(nn):
    """The reference route with its key sums grouped otherwise: every
    full-sequence attention through ``attend_chunked`` at chunk 256 (at or
    below 1024 keys it would take ``mha_attend``).  Its distance from the
    reference route is what the model's depth makes of rounding alone."""
    import functools
    orig_max, orig_chunked = nn.FULL_ATTEND_MAX_KEYS, nn.attend_chunked
    nn.FULL_ATTEND_MAX_KEYS = 0
    nn.attend_chunked = functools.partial(orig_chunked, chunk=256)
    try:
        yield
    finally:
        nn.FULL_ATTEND_MAX_KEYS, nn.attend_chunked = orig_max, orig_chunked


@contextlib.contextmanager
def flash_layouts():
    """Within the block, each kernel-3 call's q, k and v strides by mode --
    the layouts a model path hands the kernel.  The wrapper checks each
    call's layout against its rule (for bf16, TMA's) and raises, so a path
    that completes shows that all of its layouts pass."""
    from repro_torch.kernels import flash_attention as fa
    seen: dict = {}
    call = fa.flash_attention_cuda

    def recorded(q, k, v, **kw):
        key = fa.mode_key(q.dtype, q.shape[2] // k.shape[2], q.shape[3],
                          kw.get("causal", True), kw.get("window"),
                          kw.get("softcap"))
        seen.setdefault(key, set()).add(tuple(
            tuple(t.stride()) for t in (q, k, v)))
        return call(q, k, v, **kw)
    fa.flash_attention_cuda = recorded
    try:
        yield seen
    finally:
        fa.flash_attention_cuda = call


def layouts_json(seen: dict) -> dict:
    """``flash_layouts``' record as lists for the JSON line."""
    return {key: [[list(st) for st in layout] for layout in layouts]
            for key, layouts in seen.items()}


def bf16_mix_excess(torch, a, w, got) -> float:
    """How far kernel 1's bf16 output ``got`` lies beyond what rounding an
    f32 sum once to bf16 allows: |got - A w| (A w summed in f32 here) less
    half a bf16 step of |A w| and M f32 steps of sum |a| |w| (the sums run
    in another order, which near a cancellation may flip a rounding).  At
    most 0 means within; a bf16 step count is no measure near a
    cancellation, where A w is close to 0."""
    exact = torch.einsum("ij,jd->id", a.float(), w.float())
    lim = exact.abs().mul_(2.0 ** -8)
    lim.add_(torch.einsum("ij,jd->id", a.float().abs(), w.float().abs()),
             alpha=w.shape[0] * 2.0 ** -24)
    return float((got.float() - exact).abs_().sub_(lim).max())


def bf16_step(x: float) -> float:
    """One bf16 step (ulp) at |x|."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def zoo_kernel_checks(torch, g) -> dict:
    """Kernel 1's bf16 instance at SmolLM-360M's full size and kernel 3 at
    each new mode's main shape, against their plain versions (kernel 3's
    plain version on a slice of heads where its (b, h, s, s) scores would
    not fit beside the kernel's), timed beside their bounds and a library
    call.  Returns the rows of the ``kernels`` line (launches filled in
    later from the paths)."""
    from repro_torch.core import topology as tp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    rows = {}
    # ---- kernel 1, bf16: load bf16, sum in f32, store bf16 ----
    m, d = TRAIN["servers"], SMOLLM_PARAMS
    a = torch.tensor(tp.metropolis_weights(tp.ring_graph(m)),
                     dtype=torch.float32, device=dev)
    w = torch.randn((m, d), device=dev, generator=g).bfloat16()
    out = torch.empty_like(w)
    got = ops.consensus_mix(a, w, out=out)
    want = ref.consensus_mix_ref(a, w)
    err = float((got.float() - want.float()).abs().max())
    excess = bf16_mix_excess(torch, a, w, got)
    assert got.dtype == torch.bfloat16 and excess <= 0, excess
    del want
    a16 = a.bfloat16()
    times = alternate(torch, {
        "kernel": lambda: ops.consensus_mix(a, w, out=out),
        "plain": lambda: ref.consensus_mix_ref(a, w),
        "library": lambda: torch.matmul(a16, w)}, reps=10)
    n_bytes = 2 * m * d * 2 + m * m * 4
    bound, by = bound_ms(n_bytes, 2 * m * m * d)
    emit("consensus_mix_bf16_main_shape", m=m, d=d, max_abs_err=err,
         excess_over_one_rounding=excess,
         kernel_ms=times["kernel"], plain_ms=times["plain"],
         library_ms=times["library"],
         library="torch.matmul(A in bf16, W): A rounded to bf16, as the "
                 "reference's _mix_leaf does",
         bound_ms=bound, bound_by=by, bytes=n_bytes,
         kernel_GBps=n_bytes / times["kernel"] / 1e6,
         bound_share=bound / times["kernel"])
    rows["consensus_mix_bf16"] = {
        "name": "consensus_mix_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/consensus_mix.cu",
        "replaces": "src/repro/kernels/consensus_mix.py:71",
        "max_abs_err": err, "ms": times["kernel"],
        "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
        "library_ms": times["library"]}
    del w, out, got
    torch.cuda.empty_cache()

    # ---- kernel 3 at each new mode's main shape ----
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, arch, b, s, h, kvh, hd, kw, dtype, heads in FLASH_ZOO:
        dt = getattr(torch, dtype)
        grp = h // kvh
        hs = h if heads is None else heads      # q heads a plain call takes
        # with a softcap, q is scaled so that the scores (std ~8, largest
        # ~30 a row) reach where the cap bends them
        q_scale = FLASH_SOFTCAP_Q_SCALE if "softcap" in kw else 1.0
        q = (torch.randn((b, s, h, hd), device=dev, generator=g)
             * q_scale).to(dt)
        k = torch.randn((b, s, kvh, hd), device=dev, generator=g).to(dt)
        v = torch.randn((b, s, kvh, hd), device=dev, generator=g).to(dt)
        got = ops.flash_attention(q, k, v, **kw)
        encode_us = fa.encode_ns() / 1e3 if dtype == "bfloat16" else None
        # the plain version over every head, hs heads a call (its (b, h, s,
        # s) f32 scores at once would not fit beside the kernel's)
        slices = [(q[:, :, i:i + hs], k[:, :, i // grp:(i + hs) // grp],
                   v[:, :, i // grp:(i + hs) // grp])
                  for i in range(0, h, hs)]

        def plain_all(kw=kw, slices=slices):
            return [ref.attention_ref(*x, **kw) for x in slices]

        want = torch.cat(plain_all(), dim=2)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, got, want)
        row = row_rel_err(torch, got, want)
        if dtype == "bfloat16":
            limit, measure = FLASH_BF16_ROW_LIMIT, row
        else:
            limit, measure = flash_limit(kw, dtype), rel
        assert got.dtype == dt and measure <= limit, (name, measure, limit)
        # controls that must fail: the kernel without its window, its
        # softcap or its non-causal mask, held against the plain version
        # with them
        controls = {}
        for opt, off in (("window", None), ("softcap", None),
                         ("causal", True)):
            if opt in kw:
                wrong = ops.flash_attention(q, k, v, **{**kw, opt: off})
                controls[f"{opt}={off}"] = row_rel_err(torch, wrong, want)
                del wrong
                assert controls[f"{opt}={off}"] > 4 * limit, \
                    (name, opt, controls, limit)
        del want, got
        causal = kw.get("causal", True)
        window = kw.get("window")
        fns = {"kernel": lambda: ops.flash_attention(q, k, v, **kw),
               "plain": plain_all}
        if "softcap" not in kw:     # sdpa computes the same function
            mask = None
            if window is not None:
                i = torch.arange(s, device=dev)
                mask = (i[None, :] <= i[:, None]) & \
                    (i[None, :] > i[:, None] - window)
            fns["library"] = lambda: sdpa(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        times = alternate(torch, fns, reps=5 if s > 2048 else 10)
        pairs = attn_pairs(s, s, causal, window)
        flops = b * h * pairs * 4 * hd
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = (H100_BF16_TC_FLOP_PER_S if dtype == "bfloat16"
                else H100_F32_FLOP_PER_S)
        bound, by = bound_ms(n_bytes, flops, peak)
        emit("flash_attention_zoo_mode", mode=name, arch=arch,
             shape=[b, s, s, h, kvh, hd], group=grp, dtype=dtype,
             causal=causal, window=window, softcap=kw.get("softcap"),
             q_scale=q_scale, max_abs_err=err, max_rel_err=rel,
             max_row_rel_err=row, limit=limit,
             tma_encode_us=encode_us,
             dynamic_smem_bytes=fa.smem_bytes(hd, dt),
             limit_on="max_row_rel_err" if dtype == "bfloat16"
             else "max_rel_err",
             controls_row_rel_err=controls, kernel_ms=times["kernel"],
             plain_ms=times["plain"], plain_calls=len(slices),
             library_ms=times.get("library"), flops=flops, bytes=n_bytes,
             bound_ms=bound, bound_by=by, peak_flop_per_s=peak,
             kernel_TFLOPs=flops / times["kernel"] / 1e9,
             bound_share=bound / times["kernel"])
        rows[f"flash_attention_{name}"] = {
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:118",
            "max_abs_err": err, "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": times.get("library")}
        del q, k, v, slices
        torch.cuda.empty_cache()
    return rows


def bf16_training(torch, ttrain, ops) -> int:
    """One static epoch of Algorithm 1 on full SmolLM-360M with bf16 leaves
    through ``train`` (the gossip period on kernel 1's bf16 instance, five
    launches), then one period of each wire on a bf16 tree at smoke width,
    on the card and on the CPU.  Returns kernel 1's launches in the
    epoch."""
    from repro_torch.comm import compressors as cp
    from repro_torch.comm import prng
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core import consensus as cns
    from repro_torch.core import topology as tp
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    params = ttf.init_params(torch.Generator(device=dev).manual_seed(0),
                             get_arch("smollm-360m"), dtype=torch.bfloat16,
                             device=dev)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = ttrain.train("smollm-360m", **{**TRAIN, "epochs": 1},
                       params=params, log=False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    del params
    hist = run["history"]
    leaves = tree_leaves(run["state"].client_params)
    norms = (2 * run["cfg"].num_layers + 1) * TRAIN["t_client"] \
        * TRAIN["servers"] * TRAIN["clients"]
    expected = {k: 0 for k in launches}
    expected.update(consensus_mix=TRAIN["t_server"], rmsnorm_fwd=norms,
                    rmsnorm_bwd=norms)
    emit("train_bf16", arch="smollm-360m", dtype="bfloat16",
         leaf_dtypes=sorted({str(x.dtype) for x in leaves}),
         loss=hist["loss"], disagreement=hist["disagreement"],
         epoch_s=hist["epoch_s"], launches=launches,
         expected_launches=expected,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert launches == expected, launches
    assert all(x.dtype == torch.bfloat16 for x in leaves)
    assert all(np.isfinite(v) for v in hist["loss"]), hist
    del run, leaves
    torch.cuda.empty_cache()

    # the wires at smoke width: M = 4 servers of SmolLM's smoke tree in bf16
    cfg = get_smoke("smollm-360m")
    gen = torch.Generator().manual_seed(4)
    one = ttf.init_params(gen, cfg)
    tree = tree_map(lambda x: (x[None] + 0.05 * torch.randn(
        (4,) + tuple(x.shape), generator=gen)).bfloat16(), one)
    card = tree_map(lambda x: x.to(dev), tree)
    a = torch.tensor(tp.metropolis_weights(tp.ring_graph(4)),
                     dtype=torch.float32)
    q = cp.StochasticQuantizer(bits=8, chunk=WIRE_CHUNK)
    key = prng.key(21)
    t_s = TRAIN["t_server"]
    out = {}
    for name, fn, kw in (
            ("bucketed_s0", cns.gossip_scan_wire_bucketed, {}),
            ("bucketed_s1", cns.gossip_scan_wire_bucketed, {"staleness": 1}),
            ("per_leaf", cns.gossip_scan_wire, {})):
        ops.reset_launch_counts()
        got = fn(a.to(dev), card, t_s, q, key, **kw)
        torch.cuda.synchronize()
        got_l = ops.launch_counts()
        want = fn(a, tree, t_s, q, key, **kw)
        same = all(torch.equal(x.cpu(), y) and x.dtype == torch.bfloat16
                   for x, y in zip(tree_leaves(got), tree_leaves(want)))
        out[name] = {"identical_to_cpu": same,
                     "launches": {k: v for k, v in got_l.items() if v}}
        assert same, name
    # error feedback on the physical wire, and the simulated wire with EF
    for wire in ("physical", "simulated"):
        be = cns.make_backend("gossip", tp.metropolis_weights(
            tp.ring_graph(4)), t_s, compression="int8", error_feedback=True,
            wire=wire)
        res = tree_map(lambda x: (0.01 * x).contiguous(), tree)
        ops.reset_launch_counts()
        got, got_res = be.mix_compressed(
            card, residual=tree_map(lambda x: x.to(dev), res), key=key)
        torch.cuda.synchronize()
        got_l = ops.launch_counts()
        want, want_res = be.mix_compressed(tree, residual=res, key=key)
        # physical: bitwise; simulated: kernel 1's bf16 rounds sum in
        # another order than the CPU's, one bf16 step of the largest value
        # a round at most
        diff = max(float((x.cpu().float() - y.float()).abs().max())
                   for x, y in zip(tree_leaves(got), tree_leaves(want)))
        top = max(float(y.float().abs().max()) for y in tree_leaves(want))
        res_same = all(torch.equal(x.cpu(), y) for x, y in
                       zip(tree_leaves(got_res), tree_leaves(want_res)))
        limit = 0.0 if wire == "physical" else t_s * 2.0 ** -8 * top
        out[f"{wire}_ef"] = {"max_abs_diff_to_cpu": diff, "limit": limit,
                             "residual_identical_to_cpu": res_same,
                             "launches": {k: v for k, v in got_l.items()
                                          if v}}
        assert res_same, wire
        assert diff <= limit, (wire, diff, limit)
    emit("wire_bf16_smoke_width", arch="smollm-360m (smoke width)", m=4,
         t_server=t_s, params=sum(x[0].numel() for x in tree_leaves(tree)),
         **out)
    return launches["consensus_mix"]


def served_loop(torch, params, cfg, inputs, opts, pf_kw: dict,
                gen: int) -> dict:
    """The loop ``serve()`` runs, on given params: a short prefill and
    decode step first (so that the timed run holds none of the first calls'
    set-up), then, with the launch counters and the peak memory reset just
    before it, ``prefill`` and ``gen - 1`` decode steps with
    ``sample_token``.  Returns the seconds, the launches (kernel 3's by
    mode), the generated tokens and the cache."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as ttf
    logits, cache = ttf.prefill(params, cfg,
                                {"tokens": inputs["tokens"][:, :16]},
                                opts=opts, max_len=18,
                                cache_dtype=torch.float32)
    ttf.decode_step(params, cfg, tserve.sample_token(logits, None), cache)
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = ttf.prefill(params, cfg, inputs, opts=opts, **pf_kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks = [tserve.sample_token(logits, None)]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = ttf.decode_step(params, cfg, toks[-1], cache)
        toks.append(tserve.sample_token(logits, None))
    torch.cuda.synchronize()
    return {"prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "launches": ops.launch_counts(),
            "modes": ops.flash_attention_mode_counts(),
            "generated": torch.cat(toks, dim=1), "cache": cache}


def zoo_serving(torch, g, kernel_rows: dict) -> None:
    """The four serving paths, each with the launch counters reset just
    before it and the previous model freed; fills the launches of kernel
    3's zoo rows."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    kernel_opts = ttf.ApplyOptions(attn_impl="kernel")
    mode_of = {"gemma2-27b": {"bfloat16/2/128/True/4096/50.0":
                              "gemma2_local",
                              "bfloat16/2/128/True/None/50.0":
                              "gemma2_global"},
               "command-r-35b": {"bfloat16/8/128/True/None/None":
                                 "command_r"},
               "internvl2-1b": {"float32/7/64/True/None/None": "internvl2"},
               "seamless-m4t-large-v2": {
                   "float32/1/64/False/None/None": "seamless_encoder",
                   "float32/1/64/True/None/None": "seamless_decoder"}}
    for arch, shape in ZOO.items():
        cfg = get_arch(arch)
        b, s_len, gen = shape["batch"], shape["prompt_len"], shape["gen"]
        dtype = getattr(torch, shape["dtype"])
        fe = cfg.frontend
        n_fe = 0 if fe is None else (fe.num_tokens or s_len)
        fe_name = None if fe is None else (
            "patch_embeds" if fe.kind == "vision_patches" else "frames")
        seq = s_len + (n_fe if fe_name == "patch_embeds" else 0)
        max_len = shape.get("max_len", s_len + gen)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n_layers = cfg.num_layers
        enc = cfg.encdec.num_encoder_layers if cfg.encdec else 0
        post = 2 if cfg.final_logit_softcap is not None else 0
        cross = 1 if cfg.encdec else 0
        norms_pass = (2 + post + cross) * n_layers + 1
        expected = {k: 0 for k in ops.launch_counts()}
        expected.update(flash_attention=n_layers + enc,
                        rmsnorm_fwd=norms_pass * gen + (2 * enc + 1
                                                        if enc else 0))
        if shape["dtype"] == "float32":
            # serve(), as a user calls it; a short run first, so that the
            # timed one holds none of the first calls' set-up
            kw = dict(smoke=False, batch=b, prompt_len=s_len, gen=gen,
                      max_len=max_len, device="cuda")
            tserve.serve(arch, **{**kw, "prompt_len": 16, "gen": 2,
                                  "max_len": 16 + 2 + (
                                      n_fe if fe_name == "patch_embeds"
                                      else 0)})
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            res = tserve.serve(arch, **kw)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            modes = ops.flash_attention_mode_counts()
            peak_serve = torch.cuda.max_memory_allocated() - base
            prefill_s, decode_s = res["prefill_s"], res["decode_s"]
            generated, served = res["generated"], res["inputs"]
            del res
            rng = torch.Generator(device=dev).manual_seed(0)
            t0 = time.perf_counter()
            params = ttf.init_params(rng, cfg, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            peak_init = None
        else:
            # bf16 weights: the loop serve() runs, on bf16 params
            rng = torch.Generator(device=dev).manual_seed(0)
            t0 = time.perf_counter()
            params = ttf.init_params(rng, cfg, dtype=dtype, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            peak_init = torch.cuda.max_memory_allocated() - base
        weights_gb = sum(t.numel() * t.element_size()
                         for t in tree_leaves(params)) / 1e9
        n_params = sum(t.numel() for t in tree_leaves(params))
        prompt = torch.randint(0, cfg.vocab_size, (b, s_len), generator=rng,
                               device=dev)
        inputs = {"tokens": prompt}
        if fe_name is not None:
            inputs[fe_name] = torch.randn((b, n_fe, cfg.d_model),
                                          generator=rng, device=dev) * 0.02
        if shape["dtype"] == "float32":     # serve() drew these from seed 0
            assert all(torch.equal(inputs[k], served[k]) for k in inputs)
            del served
        pf_kw = dict(max_len=max_len, cache_dtype=torch.float32)
        if shape["dtype"] != "float32":
            run = served_loop(torch, params, cfg, inputs, kernel_opts, pf_kw,
                              gen)
            peak_serve = torch.cuda.max_memory_allocated() - base
            prefill_s, decode_s, launches, modes, generated = (
                run[k] for k in ("prefill_s", "decode_s", "launches",
                                 "modes", "generated"))
            del run
        torch.cuda.empty_cache()
        n_modes = {mode_of[arch].get(k, k): v for k, v in modes.items()}
        emit("serve_zoo", arch=arch, dtype=shape["dtype"], params=n_params,
             weights_gb=weights_gb, batch=b, prompt_len=s_len,
             frontend_positions=n_fe, prefill_positions=seq, gen=gen,
             max_len=max_len, init_s=init_s, prefill_s=prefill_s,
             decode_s=decode_s,
             tok_per_s=b * (gen - 1) / decode_s,
             ms_a_decode_step=decode_s / (gen - 1) * 1e3,
             prefill_tok_per_s=b * seq / prefill_s,
             peak_init_gb=None if peak_init is None else peak_init / 1e9,
             peak_serve_gb=peak_serve / 1e9, launches=launches,
             expected_launches=expected, attention_modes=n_modes,
             first_row=generated[0, :16].tolist())
        assert launches == expected, (arch, launches, expected)
        assert set(n_modes) == set(mode_of[arch].values()), n_modes
        assert sum(n_modes.values()) == launches["flash_attention"], \
            (n_modes, launches)
        for k, v in n_modes.items():
            kernel_rows[f"flash_attention_{k}"]["launches"] = v
        assert tuple(generated.shape) == (b, gen)
        assert 0 <= int(generated.min()) and \
            int(generated.max()) < cfg.vocab_size
        if arch == "gemma2-27b":
            assert peak_serve < 70e9 and peak_init < 70e9, \
                (peak_init, peak_serve)

        # ---- checked: the kernel route's prefill against the reference
        # route, and decode against a full forward ----
        vocab = cfg.vocab_size
        ref_logits, _ = ttf.prefill(params, cfg, inputs, **pf_kw)
        torch.cuda.empty_cache()
        with reference_route_regrouped(nn):
            alt_logits, _ = ttf.prefill(params, cfg, inputs, **pf_kw)
        torch.cuda.empty_cache()
        with flash_layouts() as layouts:
            logits, cache = ttf.prefill(params, cfg, inputs,
                                        opts=kernel_opts, **pf_kw)
        emit("kernel3_layouts", arch=arch, rule="strides % 8 (bf16, TMA) "
             "or % 4 (f32), unit head_dim stride, 16-byte start",
             layouts=layouts_json(layouts))
        cache_gb = sum(t.numel() * t.element_size()
                       for t in tree_leaves(cache["stack"])) / 1e9
        pf_err, pf_rel = rel_err(torch, logits[..., :vocab],
                                 ref_logits[..., :vocab])
        alt_err = rel_err(torch, alt_logits[..., :vocab],
                          ref_logits[..., :vocab])[0]
        top = float(ref_logits[..., :vocab].float().abs().max())
        del ref_logits, alt_logits
        if shape["dtype"] == "float32":
            pf_limit = 1e-4 * top
        else:
            # bf16: each route rounds its attention output to bf16 after an
            # f32 sum in its own order; the reference route regrouped shows
            # what the depth makes of such roundings
            pf_limit = 2 * alt_err + 4 * bf16_step(top)
        assert pf_err <= pf_limit, (arch, pf_err, pf_limit, alt_err)
        nxt = logits[:, -1].argmax(-1)[:, None]
        assert torch.equal(nxt, generated[:, :1]), \
            "prefill differs from the serving run"
        toks, dec_errs = prompt, []
        for _ in range(3):
            toks = torch.cat([toks, nxt], dim=1)
            logits, cache = ttf.decode_step(params, cfg, nxt, cache)
            with torch.inference_mode():
                hidden, _ = ttf.forward_hidden(params, cfg,
                                               {**inputs, "tokens": toks})
                want = ttf._head(params, cfg, hidden[:, -1:])[:, 0]
            del hidden
            got, want = logits[:, 0, :vocab].float(), want[:, :vocab].float()
            dec_errs.append(float((got - want).abs().max()))
            if shape["dtype"] == "float32":   # as tests/test_decode.py
                torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
            else:
                assert dec_errs[-1] <= pf_limit, (arch, dec_errs, pf_limit)
            nxt = logits[:, -1].argmax(-1)[:, None]
        emit("serve_zoo_check", arch=arch, dtype=shape["dtype"],
             cache_gb=cache_gb, prefill_max_abs_err=pf_err,
             prefill_max_rel_err=pf_rel,
             reference_regrouped_max_abs_err=alt_err, max_abs_logit=top,
             prefill_limit=pf_limit,
             prefill_limit_rule=("1e-4 of the largest logit"
                                 if shape["dtype"] == "float32" else
                                 "2 x reference_regrouped + 4 bf16 steps "
                                 "of the largest logit"),
             decode_vs_forward_max_abs_err=dec_errs,
             decode_limit=("rtol = atol = 2e-3" if shape["dtype"] == "float32"
                           else pf_limit),
             forward_positions=toks.shape[1] + (
                 n_fe if fe_name == "patch_embeds" else 0))
        del params, cache, logits, want, inputs, prompt
        torch.cuda.empty_cache()


@contextlib.contextmanager
def moe_routing(nn, record=None, pinned=None):
    """``nn.moe_route`` wrapped: each call's expert indices (g, tg, k)
    appended to ``record``; with ``pinned`` (index tensors, one a call in
    call order) the router's probabilities taken at those indices instead
    of its own top k, renormalised as ``moe_route`` does.  Pinning another
    run's routing leaves only the rounding of the rest of the model to
    compare."""
    orig = nn.moe_route
    calls = None if pinned is None else iter(pinned)

    def route(params, tokens, cfg):
        probs, gate_vals, gate_idx = orig(params, tokens, cfg)
        if calls is not None:
            gate_idx = next(calls)
            gate_vals = probs.gather(-1, gate_idx)
            gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        if record is not None:
            record.append(gate_idx.clone())
        return probs, gate_vals, gate_idx

    nn.moe_route = route
    try:
        yield
    finally:
        nn.moe_route = orig


@contextlib.contextmanager
def attention_outputs(nn, record):
    """Within the block, the output of every full-sequence self-attention
    (``nn.attention_apply`` without ``kv_override``; (b, s, d)) and of every
    decode step's attention (``nn.attention_decode_step``; (b, 1, d)) is
    appended to ``record``, in call order (nothing with ``record`` None)."""
    if record is None:
        yield
        return
    apply, step = nn.attention_apply, nn.attention_decode_step

    def recorded_apply(*args, **kw):
        out = apply(*args, **kw)
        if kw.get("kv_override") is None:
            record.append(out)
        return out

    def recorded_step(*args, **kw):
        out = step(*args, **kw)
        record.append(out[0])
        return out

    nn.attention_apply, nn.attention_decode_step = (recorded_apply,
                                                    recorded_step)
    try:
        yield
    finally:
        nn.attention_apply, nn.attention_decode_step = apply, step


@contextlib.contextmanager
def device_spans(torch, targets):
    """Within the block, each call of ``getattr(module, attr)`` for
    ``(module, attr, label)`` in ``targets`` is bracketed by CUDA events on
    the current stream (no synchronisation); yields a dict whose ``label``
    entries are, after the block, the summed device ms between each call's
    two events and the call count."""
    events = {label: [] for _, _, label in targets}
    saved = [(module, attr, getattr(module, attr))
             for module, attr, _ in targets]

    def spanned(fn, label):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*args, **kw)
            finally:
                end.record()
                events[label].append((start, end))
        return call
    for (module, attr, fn), (_, _, label) in zip(saved, targets):
        setattr(module, attr, spanned(fn, label))
    out = {}
    try:
        yield out
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
        torch.cuda.synchronize()
        for label, pairs in events.items():
            out[label] = {"ms": sum(a.elapsed_time(b) for a, b in pairs),
                          "calls": len(pairs)}


def routing_flips(a: list, b: list, batch: int) -> dict:
    """(token, layer) pairs whose top-k expert SET differs between two runs'
    recorded routings, and the batch rows that hold any."""
    flips = [(x.sort(-1).values != y.sort(-1).values).any(-1)
             .reshape(batch, -1) for x, y in zip(a, b)]
    per_row = sum(f.sum(-1) for f in flips)
    return {"pairs": int(per_row.sum()), "per_row": per_row.tolist(),
            "rows": [i for i, n in enumerate(per_row.tolist()) if n]}


def ssd_bf16_check(torch, g) -> dict:
    """Kernel 9 on bf16 x, B and C at Jamba-1.5-Large's prefill shape (b 4,
    s 1024, 256 heads of 64, d_state 128, chunk 256, A = -(1..256) as the
    model's init) against its plain version at the reference's SSD
    tolerance, beside a control that must fail (B and C swapped); timed
    against its plain version and its bound.  Returns row 9b of the
    ``kernels`` line (launches filled in from Jamba's serving path)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    cfg = get_arch("jamba-1.5-large-398b")
    m = cfg.mamba
    nh, hd, ds, chunk = m.num_heads(cfg.d_model), m.head_dim, m.d_state, \
        m.chunk_size
    b, s = MOE_ZOO["jamba-1.5-large-398b"]["batch"], \
        MOE_ZOO["jamba-1.5-large-398b"]["prompt_len"]
    a = -torch.arange(1, nh + 1, dtype=torch.float32,
                      device=torch.device("cuda"))
    xs, bs, cs, dt, a = ssd_inputs(torch, g, b, s, nh, hd, ds, a=a,
                                   dtype="bfloat16")
    got = ops.ssd_scan(xs, bs, cs, dt, a, chunk=chunk)
    want = ref.ssd_scan_chunked_ref(xs, bs, cs, dt, a, chunk=chunk)
    errs = [rel_err(torch, x, y) for x, y in zip(got, want)]
    # elementwise at the reference's rtol = atol, as the other SSD checks
    within = all(bool(((x - y).abs() <= SSD_LIMIT * (1 + y.abs())).all())
                 for x, y in zip(got, want))
    swapped = ops.ssd_scan(xs, cs, bs, dt, a, chunk=chunk)
    control = max(rel_err(torch, x, y)[1] for x, y in zip(swapped, want))
    del got, want, swapped
    times = alternate(torch, {
        "kernel": lambda: ops.ssd_scan(xs, bs, cs, dt, a, chunk=chunk),
        "plain": lambda: ref.ssd_scan_chunked_ref(xs, bs, cs, dt, a,
                                                  chunk=chunk)}, reps=5)
    flops, f32_bytes, _ = ssd_work(b, s, nh, hd, ds, chunk)
    # bf16 x, B and C: half of their f32 bytes
    n_bytes = f32_bytes - 2 * (b * s * nh * hd + 2 * b * s * ds)
    bound, by = bound_ms(n_bytes, flops)
    err = max(e[0] for e in errs)
    emit("ssd_bf16_main_shape", arch="jamba-1.5-large-398b",
         shape=[b, s, nh, hd, ds, chunk], dtype="bfloat16",
         a="-(1..nh)", max_abs_err=err,
         max_rel_err=max(e[1] for e in errs), limit=SSD_LIMIT,
         control_b_c_swapped_rel_err=control, kernel_ms=times["kernel"],
         plain_ms=times["plain"], flops=flops, bytes=n_bytes,
         bound_ms=bound, bound_by=by, bound_share=bound / times["kernel"],
         within_limit=within)
    assert within, errs
    assert control > 4 * SSD_LIMIT, control
    del xs, bs, cs, dt
    torch.cuda.empty_cache()
    return {"name": "ssd_scan_bf16_jamba", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": SSD_KERNEL[1], "max_abs_err": err,
            "ms": times["kernel"], "plain_ms": times["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def moe_serving(torch, g, kernel_rows: dict, ssd_row: dict) -> None:
    """The MoE and MLA serving paths (``MOE_ZOO``), each with the launch
    counters reset just before it and the previous model freed; fills the
    launches of kernel 3's Mixtral row and of kernel 9's bf16 row."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    # serve()'s options: the kernel route, drop-free MoE
    kernel_opts = ttf.ApplyOptions(attn_impl="kernel", moe_no_drop=True)
    ref_opts = ttf.ApplyOptions(moe_no_drop=True)
    for arch, shape in MOE_ZOO.items():
        cut = {k: v for k, v in shape.items()
               if k in ("num_layers", "layer_pattern")}
        cfg = dataclasses.replace(get_arch(arch), **cut)
        b, s_len, gen = shape["batch"], shape["prompt_len"], shape["gen"]
        plan = ttf.stack_plan(cfg)
        kinds = [ttf._layer_flags(cfg, i) for i in range(cfg.num_layers)]
        n_moe = sum(is_moe for _, is_moe in kinds)
        n_mamba = sum(kind == "mamba" for kind, _ in kinds)
        n_attn = 0 if cfg.mla else cfg.num_layers - n_mamba
        norms_pass = sum(2 + (2 if cfg.mla and kind != "mamba" else 0)
                         + (kind == "mamba") for kind, _ in kinds) + 1
        expected = {k: 0 for k in ops.launch_counts()}
        expected.update(flash_attention=n_attn, ssd_scan=n_mamba,
                        rmsnorm_fwd=norms_pass * gen)
        max_len = s_len + gen
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rng = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = ttf.init_params(rng, cfg, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        peak_init = torch.cuda.max_memory_allocated() - base
        weights_gb = sum(t.numel() * t.element_size()
                         for t in tree_leaves(params)) / 1e9
        n_params = sum(t.numel() for t in tree_leaves(params))
        prompt = torch.randint(0, cfg.vocab_size, (b, s_len), generator=rng,
                               device=dev)
        inputs = {"tokens": prompt}
        pf_kw = dict(max_len=max_len, cache_dtype=torch.float32)
        run = served_loop(torch, params, cfg, inputs, kernel_opts, pf_kw,
                          gen)
        peak_serve = torch.cuda.max_memory_allocated() - base
        prefill_s, decode_s, launches, modes, generated = (
            run[k] for k in ("prefill_s", "decode_s", "launches", "modes",
                             "generated"))
        cache_gb = sum(t.numel() * t.element_size()
                       for t in tree_leaves(run["cache"])) / 1e9
        del run
        torch.cuda.empty_cache()
        # where a prefill's device time goes: one more prefill with each
        # MoE FFN, kernel-3 call and kernel-9 call bracketed by events
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with device_spans(torch, [(nn, "moe_apply", "moe_ffn"),
                                  (ops, "flash_attention", "kernel3"),
                                  (ops, "ssd_scan", "kernel9")]) as spans:
            ttf.prefill(params, cfg, inputs, opts=kernel_opts, **pf_kw)
        spans["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        n_modes = {MOE_MODES[arch].get(k, k): v for k, v in modes.items()}
        emit("serve_moe", arch=arch, dtype="bfloat16", params=n_params,
             layers=cfg.num_layers,
             published_layers=get_arch(arch).num_layers,
             layer_pattern=list(cfg.layer_pattern),
             moe_layers=[i for i, (_, m) in enumerate(kinds) if m],
             stack_plan=dataclasses.asdict(plan), weights_gb=weights_gb,
             batch=b, prompt_len=s_len, gen=gen, max_len=max_len,
             init_s=init_s, prefill_s=prefill_s, decode_s=decode_s,
             tok_per_s=b * (gen - 1) / decode_s,
             ms_a_decode_step=decode_s / (gen - 1) * 1e3,
             prefill_tok_per_s=b * s_len / prefill_s,
             peak_init_gb=peak_init / 1e9, peak_serve_gb=peak_serve / 1e9,
             cache_gb=cache_gb, launches=launches,
             expected_launches=expected, attention_modes=n_modes,
             prefill_spans=spans,
             prefill_shares={k: v["ms"] / spans["prefill_ms"]
                             for k, v in spans.items() if k != "prefill_ms"},
             first_row=generated[0, :16].tolist())
        assert launches == expected, (arch, launches, expected)
        assert set(n_modes) == set(MOE_MODES[arch].values()), n_modes
        assert sum(n_modes.values()) == launches["flash_attention"]
        if arch == "mixtral-8x22b":
            kernel_rows["flash_attention_mixtral"]["launches"] = \
                n_modes["mixtral"]
        if n_mamba:
            ssd_row["launches"] = launches["ssd_scan"]
        assert tuple(generated.shape) == (b, gen)
        assert 0 <= int(generated.min()) and \
            int(generated.max()) < cfg.vocab_size
        assert peak_serve < 75e9, (arch, peak_serve)

        # ---- checked: the kernel route's prefill against the reference
        # route (the tokens whose expert set differs counted; the logits
        # held on the rows without such a token, and on every row with the
        # kernel route's routing pinned on the reference route), decode
        # against a drop-free full forward with the serving run's routing
        # pinned, and the loss finite ----
        vocab = cfg.vocab_size
        k_route, r_route = [], []
        with moe_routing(nn, record=k_route), flash_layouts() as layouts:
            logits, cache = ttf.prefill(params, cfg, inputs,
                                        opts=kernel_opts, **pf_kw)
        emit("kernel3_layouts", arch=arch, rule="strides % 8 (bf16, TMA) "
             "or % 4 (f32), unit head_dim stride, 16-byte start",
             layouts=layouts_json(layouts))
        with moe_routing(nn, record=r_route):
            ref_logits, _ = ttf.prefill(params, cfg, inputs, opts=ref_opts,
                                        **pf_kw)
        torch.cuda.empty_cache()
        with moe_routing(nn, pinned=k_route):
            pin_logits, _ = ttf.prefill(params, cfg, inputs, opts=ref_opts,
                                        **pf_kw)
        torch.cuda.empty_cache()
        # the reference route regrouped: attention's key sums in chunks of
        # 256 and a mamba layer's SSD over chunks of half the length, so
        # that its distance shows what rounding alone does in both mixers
        alt_cfg = cfg if not n_mamba else dataclasses.replace(
            cfg, mamba=dataclasses.replace(
                cfg.mamba, chunk_size=cfg.mamba.chunk_size // 2))
        with reference_route_regrouped(nn), moe_routing(nn, pinned=k_route):
            alt_logits, _ = ttf.prefill(params, alt_cfg, inputs,
                                        opts=ref_opts, **pf_kw)
        torch.cuda.empty_cache()
        assert len(k_route) == len(r_route) == n_moe
        flips = routing_flips(k_route, r_route, b)
        got = logits[:, -1, :vocab].float()
        pin = pin_logits[:, -1, :vocab].float()
        top = float(pin.abs().max())
        alt_err = float((alt_logits[:, -1, :vocab].float() - pin).abs()
                        .max())
        pf_limit = 2 * alt_err + 4 * bf16_step(top)
        pf_err = float((got - pin).abs().max())
        same_rows = [i for i in range(b) if i not in flips["rows"]]
        unpinned = ref_logits[:, -1, :vocab].float()
        row_errs = (got - unpinned).abs().amax(-1).tolist()
        finite = bool(torch.isfinite(got).all())
        del ref_logits, pin_logits, alt_logits, pin, unpinned
        nxt = logits[:, -1].argmax(-1)[:, None]
        assert torch.equal(nxt, generated[:, :1]), \
            "prefill differs from the serving run"
        prompt_route = [r.reshape(b, s_len, -1) for r in k_route]

        # in a hybrid (Jamba: one attention layer in four) the logits do
        # not resolve a decode step written one position early, so the
        # attention layers' decode outputs are held too, each against the
        # pinned forward's at the same position
        mixer_check = bool(n_mamba and n_attn)

        def routed_step(tok):
            """A decode step of ``tok`` -> (its logits, its routing, its
            attention layers' outputs (b, 1, d))."""
            route, mix = [], []
            with moe_routing(nn, record=route), \
                    attention_outputs(nn, mix if mixer_check else None):
                step_logits, _ = ttf.decode_step(params, cfg, tok, cache)
            return step_logits, [r.reshape(b, 1, -1) for r in route], mix

        def pinned_forward(toks, step_routes, regrouped=False):
            """The drop-free full forward over ``toks``, the routing of the
            prompt and of each step (``step_routes``) pinned on it (on
            ``reference_route_regrouped`` and ``alt_cfg`` with
            ``regrouped``) -> (the last position's logits, the attention
            layers' outputs there)."""
            pinned = [torch.cat([p] + [d[j] for d in step_routes], dim=1)
                      .reshape(1, -1, p.shape[-1])
                      for j, p in enumerate(prompt_route)]
            mix = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode())
                stack.enter_context(moe_routing(nn, pinned=pinned))
                stack.enter_context(attention_outputs(
                    nn, mix if mixer_check else None))
                if regrouped:
                    stack.enter_context(reference_route_regrouped(nn))
                hidden, _ = ttf.forward_hidden(
                    params, alt_cfg if regrouped else cfg, {"tokens": toks},
                    opts=ref_opts)
                want = ttf._head(params, cfg, hidden[:, -1:])[:, 0]
            return want, [x[:, -1].float() for x in mix]

        def against_forward(step, toks, step_routes):
            """A step's (logits, attention outputs) against the pinned
            forward's -> (logits' max abs difference, the attention
            outputs')."""
            step_logits, step_mix = step
            want, want_mix = pinned_forward(toks, step_routes)
            mix_err = max((float((m[:, 0].float() - w).abs().max())
                           for m, w in zip(step_mix, want_mix)),
                          default=None)
            return float((step_logits[:, 0, :vocab].float()
                          - want[:, :vocab].float()).abs().max()), mix_err

        toks, dec_errs, dec_mix_errs, dec_route = prompt, [], [], []
        for i in range(3):
            toks = torch.cat([toks, nxt], dim=1)
            logits, route, mix = routed_step(nxt)
            dec_route.append(route)
            err, mix_err = against_forward((logits, mix), toks, dec_route)
            dec_errs.append(err)
            dec_mix_errs.append(mix_err)
            if i == 0 and mixer_check:
                # the attention outputs' yardstick: the regrouped reference
                # route's distance from the pinned forward at this step
                _, ref_mix = pinned_forward(toks, dec_route)
                _, alt_mix = pinned_forward(toks, dec_route, regrouped=True)
                mix_alt_err = max(float((x - y).abs().max())
                                  for x, y in zip(alt_mix, ref_mix))
                mix_top = max(float(x.abs().max()) for x in ref_mix)
                mix_limit = 2 * mix_alt_err + 4 * bf16_step(mix_top)
                del ref_mix, alt_mix
            nxt = logits[:, -1].argmax(-1)[:, None]
        # controls that the decode limits must fail, each the next step held
        # against the same forward: written one position early (the cache's
        # position back by one), then again on a cache whose mixer state
        # (K/V, latents, conv window and SSM state; not the slot positions)
        # is zeroed
        toks = torch.cat([toks, nxt], dim=1)
        controls, mix_controls = {}, {}
        cache["position"] = cache["position"] - 1
        logits, route, mix = routed_step(nxt)
        controls["position_off_by_one"], \
            mix_controls["position_off_by_one"] = against_forward(
                (logits, mix), toks, dec_route + [route])
        with torch.inference_mode():    # the cache's tensors are such
            for blk in cache["prefix"] + cache["stack"]:
                for key, t in blk["mixer"].items():
                    if key != "pos":
                        t.zero_()
        logits, route, mix = routed_step(nxt)
        controls["mixer_state_zeroed"], \
            mix_controls["mixer_state_zeroed"] = against_forward(
                (logits, mix), toks, dec_route + [route])
        mixer_row = ({} if not mixer_check else dict(
            attention_decode_max_abs_err=dec_mix_errs,
            attention_reference_regrouped_max_abs_err=mix_alt_err,
            max_abs_attention_output=mix_top,
            attention_decode_limit=mix_limit,
            attention_controls_max_abs_err=mix_controls))
        with torch.inference_mode():
            loss, parts = ttf.make_loss_fn(cfg, ref_opts)(params, inputs,
                                                          None)
        emit("serve_moe_check", arch=arch, dtype="bfloat16",
             moe_calls_a_pass=n_moe, routed_tokens_a_call=b * s_len,
             routing_flips=flips["pairs"], routing_flip_rows=flips["rows"],
             routing_flips_per_row=flips["per_row"],
             prefill_vs_pinned_max_abs_err=pf_err,
             reference_regrouped_pinned_max_abs_err=alt_err,
             max_abs_logit=top, prefill_limit=pf_limit,
             prefill_limit_rule="2 x reference_regrouped + 4 bf16 steps of "
                                "the largest logit",
             regrouped_ssd_chunk=alt_cfg.mamba.chunk_size if n_mamba
             else None,
             unpinned_row_max_abs_err=row_errs,
             unpinned_rows_checked=same_rows,
             decode_vs_pinned_forward_max_abs_err=dec_errs,
             decode_limit=pf_limit,
             decode_controls_max_abs_err=controls, **mixer_row,
             loss=float(loss), nll=float(parts["nll"]),
             aux=float(parts["aux"]))
        # held after the line is out, so that a failing run shows its numbers
        assert finite and bool(torch.isfinite(loss)) \
            and float(parts["aux"]) > 0, (arch, float(loss))
        assert pf_err <= pf_limit, (arch, pf_err, pf_limit, alt_err)
        assert all(row_errs[i] <= pf_limit for i in same_rows), \
            (arch, row_errs, same_rows, pf_limit)
        assert max(dec_errs) <= pf_limit, (arch, dec_errs, pf_limit)
        # the zeroed state must fail everywhere; the position one back must
        # fail on the logits where every layer attends; in Jamba, where one
        # layer in four attends and the step's other rounding leaves the
        # logits' limit wider than that fault, it must fail on the attention
        # layer's output instead (PERF.md, Findings)
        must_fail = {k: v for k, v in controls.items()
                     if k == "mixer_state_zeroed" or not n_mamba}
        assert all(e > pf_limit for e in must_fail.values()), \
            (arch, controls, pf_limit)
        if mixer_check:
            assert max(dec_mix_errs) <= mix_limit, \
                (arch, dec_mix_errs, mix_limit)
            assert all(e > mix_limit for e in mix_controls.values()), \
                (arch, mix_controls, mix_limit)
        del params, cache, logits, inputs, prompt, k_route, r_route, mix
        del prompt_route, dec_route, routed_step, against_forward
        del pinned_forward
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# Algorithm 1 training the Mamba-2 and MoE families; directed federation
# ---------------------------------------------------------------------------

# full Mamba2-780M (f32) at the SmolLM cell's shape: M = 4 ring, N = 2,
# T_C = 2, T_S = 5, seq 128, batch 2 a client, SGD 0.05, 2 epochs
MAMBA_TRAIN = dict(TRAIN, gamma=0.05)
# Mixtral-8x22B at full width in bf16, depth cut to 1 of its 56 layers
# (88.1 M attention, 2,415.9 M expert and 2 x 201.3 M embedding parameters,
# 5.81 GB a model); M = 2 ring, N = 2, the rest TRAIN's shape
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "mixtral-8x22b", 1
MOE_TRAIN = dict(TRAIN, servers=2, gamma=0.05)
# directed federation on full SmolLM-360M: TRAIN's shape with push-sum over
# a directed graph's row-stochastic out-degree weights.  A directed RING's
# out-degree weights are doubly stochastic (every out-degree is 1), which
# would leave push-sum's weights at 1 and nothing to correct, so the graph
# is the reference's directed test graph, a random strongly connected
# orientation of K_4 (unequal out-degrees, a skewed Perron vector)
PS_TRAIN = dict(TRAIN, mixing="push_sum", graph="random_orientation",
                gamma=0.05)
# ... and under dynamic federation: per-epoch direction drops (p = 0.3,
# ``TopologySchedule(kind="asymmetric")`` on the ring), Bernoulli(0.5)
# participation, server 2 out at epoch 1 and back at epoch 2
PS_DYN_TRAIN = dict(DYN_TRAIN, edge_drop_prob=0.0, asymmetric_drop_prob=0.3,
                    mixing="push_sum")
EPS32 = 2.0 ** -23


@contextlib.contextmanager
def launched_norms(torch):
    """Within the block, the (rows, d, dtype) of every kernel-2 launch,
    forward and backward, into a set."""
    from repro_torch.kernels import rmsnorm as rn
    seen = set()
    fwd, bwd = rn.rmsnorm_fwd_cuda, rn.rmsnorm_bwd_cuda

    def note(x):
        seen.add((x.shape[0], x.shape[1], str(x.dtype).split(".")[-1]))

    def fwd_noted(x, *args, **kw):
        note(x)
        return fwd(x, *args, **kw)

    def bwd_noted(x, *args, **kw):
        note(x)
        return bwd(x, *args, **kw)

    rn.rmsnorm_fwd_cuda, rn.rmsnorm_bwd_cuda = fwd_noted, bwd_noted
    try:
        yield seen
    finally:
        rn.rmsnorm_fwd_cuda, rn.rmsnorm_bwd_cuda = fwd, bwd


@contextlib.contextmanager
def cut_depth(ttrain, arch: str, layers: int):
    """Within the block, ``train`` resolves ``arch`` with its depth cut to
    ``layers`` (the published widths kept)."""
    saved = ttrain.get_arch, ttrain.get_smoke

    def cut(resolve):
        def get(arch_id):
            cfg = resolve(arch_id)
            return (dataclasses.replace(cfg, num_layers=layers)
                    if arch_id == arch else cfg)
        return get

    ttrain.get_arch, ttrain.get_smoke = (cut(f) for f in saved)
    try:
        yield
    finally:
        ttrain.get_arch, ttrain.get_smoke = saved


def leaf_heads(leaves, n: int = 4096) -> list:
    """Copies of the first ``n`` elements of each leaf."""
    return [x.reshape(-1)[:n].clone() for x in leaves]


def trained_cell(torch, ttrain, ops, arch: str, shape: dict, params,
                 norms_per_step: int, sweep: set, *, ctx=None) -> dict:
    """``train(arch, **shape, params=...)`` with the launch counters reset
    just before it: each period's float64 disagreement before and after
    it, the kernel-2 shapes launched (all held by the sweep), launches
    against the prediction (kernel 1 T_S an epoch, kernel 2 forward and
    backward ``norms_per_step`` a client step, nothing else), the peak,
    finite losses and parameters moved.  ``params`` is a one-item list the
    call empties, so the trainer holds the only reference.  Returns the
    run's numbers."""
    from repro_torch.core import consensus as cns
    from repro_torch.tree import tree_leaves
    heads = leaf_heads(tree_leaves(params[0]))
    n_params = sum(t.numel() for t in tree_leaves(params[0]))
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with launched_norms(torch) as norms, \
            period_disagreement(torch, tree_leaves, cns.GossipBackend,
                                "mix") as periods, \
            (ctx or contextlib.nullcontext()):
        run = ttrain.train(arch, **shape, params=params.pop(), log=False)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = run["history"]
    steps = (shape["t_client"] * shape["servers"] * shape["clients"]
             * shape["epochs"])
    expected = {k: 0 for k in launches}
    expected.update(consensus_mix=shape["t_server"] * shape["epochs"],
                    rmsnorm_fwd=norms_per_step * steps,
                    rmsnorm_bwd=norms_per_step * steps)
    after = leaf_heads([x[0, 0] for x in
                        tree_leaves(run["state"].client_params)])
    moved = sum(not torch.equal(a, b) for a, b in zip(after, heads))
    tokens = (shape["t_client"] * shape["servers"] * shape["clients"]
              * shape["per_client_batch"] * shape["seq_len"])
    row = dict(arch=arch, params=n_params, layers=run["cfg"].num_layers,
               servers=shape["servers"],
               clients=shape["clients"],
               leaf_dtypes=sorted({str(x.dtype) for x in tree_leaves(
                   run["state"].client_params)}),
               loss=hist["loss"], epoch_s=hist["epoch_s"],
               tokens_per_s=[tokens / t for t in hist["epoch_s"]],
               sigma_prod=hist["sigma_prod"], periods=periods,
               peak_mem_gb=peak, launches=launches,
               expected_launches=expected,
               norm_shapes=sorted(norms), leaves_moved=moved,
               leaves=len(heads))
    assert launches == expected, (arch, launches, expected)
    assert norms <= sweep, (arch, sorted(norms - sweep))
    assert all(np.isfinite(v) for v in hist["loss"]), hist["loss"]
    assert moved > len(heads) // 2, (moved, len(heads))
    assert len(periods) == shape["epochs"], periods
    assert all(p["after"] < p["before"] for p in periods), periods
    return row


def family_training(torch, ttrain, ops, sweep: set) -> None:
    """Algorithm 1 through ``train`` on full Mamba2-780M (f32; the mixer on
    the reference route, ``ssd_chunked`` under autograd, so no kernel 9;
    no attention, so no kernel 3) and on Mixtral-8x22B at full width, bf16,
    one layer (the capacity MoE path, the f32 router, the Switch aux loss;
    kernel 1's bf16 instance), each with the counters reset before it."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as ttf
    resolve = get_smoke if TRAIN["smoke"] else get_arch
    dev = torch.device(TRAIN["device"])
    cfg = resolve("mamba2-780m")
    params = [ttf.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)]
    # kernel 2 a client step: ln1 and the mixer's gated norm a layer, and
    # the final norm (no FFN, so ln2 is never read): 97 at full depth
    row = trained_cell(torch, ttrain, ops, "mamba2-780m", MAMBA_TRAIN,
                       params, 2 * cfg.num_layers + 1, sweep)
    emit("train_mamba", **row, model_gb=row["params"] * 4 / 1e9)
    if not TRAIN["smoke"]:
        assert row["params"] == MAMBA_PARAMS, row["params"]
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(resolve(MOE_TRAIN_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = [ttf.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, dtype=torch.bfloat16, device=dev)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    aux = []
    orig = nn.moe_apply

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        aux.append(out[1].detach())
        return out

    nn.moe_apply = recorded
    try:
        # kernel 2 a client step: ln1 and ln2 a layer, the final norm
        row = trained_cell(torch, ttrain, ops, MOE_TRAIN_ARCH, MOE_TRAIN,
                           params, 2 * MOE_TRAIN_LAYERS + 1, sweep,
                           ctx=cut_depth(ttrain, MOE_TRAIN_ARCH,
                                         MOE_TRAIN_LAYERS))
    finally:
        nn.moe_apply = orig
    aux_vals = torch.stack(aux).float().cpu()
    steps = (MOE_TRAIN["t_client"] * MOE_TRAIN["servers"]
             * MOE_TRAIN["clients"] * MOE_TRAIN["epochs"])
    published = resolve(MOE_TRAIN_ARCH).num_layers
    emit("train_moe", **row, dtype="bfloat16", init_s=init_s,
         model_gb=row["params"] * 2 / 1e9,
         reduced={"depth": f"{MOE_TRAIN_LAYERS}/{published}",
                  "servers": MOE_TRAIN["servers"],
                  "clients": MOE_TRAIN["clients"]},
         moe_calls=len(aux), aux_loss=[float(aux_vals.min()),
                                       float(aux_vals.max())])
    assert row["leaf_dtypes"] == ["torch.bfloat16"], row["leaf_dtypes"]
    assert len(aux) == steps * MOE_TRAIN_LAYERS, (len(aux), steps)
    assert bool(torch.isfinite(aux_vals).all()) and float(aux_vals.min()) > 0
    torch.cuda.empty_cache()


def mass_f64(torch, leaves, ref_leaves, rounds: int) -> float:
    """The largest column's |sum_i num_i - sum_i x_i| over its rounding
    allowance, float64: ``rounds`` rounds of an f32 column-stochastic mix
    (with P itself rounded to f32) keep each column sum within
    ``rounds (M + 1) eps32 sum_i |x_i|``.  At most 1 means kept."""
    worst = 0.0
    for x, y in zip(ref_leaves, leaves):
        m = x.shape[0]
        xf, yf = x.reshape(m, -1), y.reshape(m, -1)
        for lo in range(0, xf.shape[1], 1 << 24):
            a = xf[:, lo:lo + (1 << 24)].double()
            b = yf[:, lo:lo + (1 << 24)].double()
            lim = a.abs().sum(0).mul_(rounds * (m + 1) * EPS32)
            ratio = (b.sum(0) - a.sum(0)).abs_() / lim.clamp_(min=1e-300)
            worst = max(worst, float(ratio.max()))
    return worst


def distance_from_mean_f64(torch, leaves, ref_leaves) -> float:
    """||W - 1 xbar'||_F in float64, ``xbar`` the unweighted mean of the
    servers' ``ref_leaves``."""
    sq = 0.0
    for x, y in zip(ref_leaves, leaves):
        m = x.shape[0]
        xf, yf = x.reshape(m, -1), y.reshape(m, -1)
        for lo in range(0, xf.shape[1], 1 << 24):
            mean = xf[:, lo:lo + (1 << 24)].double().mean(0)
            sq += float(((yf[:, lo:lo + (1 << 24)].double() - mean) ** 2)
                        .sum())
    return sq ** 0.5


@contextlib.contextmanager
def surgery_weights(engine_cls):
    """Within the block, the push-sum weight the engine's fault surgery
    leaves, per epoch that had faults."""
    records = []
    inner = engine_cls.apply_faults

    def recorded(self, state, epoch):
        out = inner(self, state, epoch)
        if self.faults.at(epoch):
            records.append((epoch, out.psum_weight.detach().cpu()))
        return out

    engine_cls.apply_faults = recorded
    try:
        yield records
    finally:
        engine_cls.apply_faults = inner


def directed_federation(torch, ttrain, ops, sweep: set) -> dict:
    """Push-sum on full SmolLM-360M, each cell with the counters reset
    before it: two static epochs (kernel 1 T_S times an epoch under
    P = A'), one full-size period (kernel 1 on P against its plain version
    and timed; the numerator's column sums and sum w = M in float64; the
    ratio nearer the servers' unweighted mean than row-stochastic gossip on
    the same A), one epoch on each wire (physical: kernel 6 once, kernel 7
    T_S times; simulated: kernel 4 once a leaf, then kernel 1 T_S - 1
    times), and three dynamic epochs with direction drops and a server out
    and back (the weight exactly 1 after each surgery).  Returns kernel 1's
    row under P."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core import consensus as cns
    from repro_torch.core import topology as tp
    from repro_torch.core.engine import DynamicFederationEngine
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device(PS_TRAIN["device"])
    shape = PS_TRAIN
    m, t_s, n_ep = shape["servers"], shape["t_server"], shape["epochs"]
    steps = shape["t_client"] * m * shape["clients"]
    # kernel 2 a client step: ln1, ln2 a layer, the final norm (65)
    norms = 2 * (get_smoke if shape["smoke"] else get_arch)(
        "smollm-360m").num_layers + 1

    def weights(out):
        return {"weight_sum": float(out.weight.double().sum()),
                "weight_min": float(out.weight.min())}

    # ---- two static epochs ----
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with launched_norms(torch) as seen, period_disagreement(
            torch, tree_leaves, cns.GossipBackend, "mix_push_sum",
            before=lambda st: st.values, after=lambda out: out.ratio(),
            extra=weights) as periods:
        run = ttrain.train("smollm-360m", **shape, log=False)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    hist = run["history"]
    expected = {k: 0 for k in launches}
    expected.update(consensus_mix=t_s * n_ep, rmsnorm_fwd=norms * steps * n_ep,
                    rmsnorm_bwd=norms * steps * n_ep)
    a_np = run["topology"].mixing_matrix()
    tokens = steps * shape["per_client_batch"] * shape["seq_len"]
    emit("train_push_sum", arch="smollm-360m", graph=shape["graph"],
         a=a_np.tolist(), perron=tp.perron_weights(a_np).tolist(),
         loss=hist["loss"], psum_min_weight=hist["psum_min_weight"],
         sigma_prod=hist["sigma_prod"], disagreement=hist["disagreement"],
         epoch_s=hist["epoch_s"],
         tokens_per_s=[tokens / t for t in hist["epoch_s"]],
         periods=periods, launches=launches, expected_launches=expected,
         norm_shapes=sorted(seen),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert launches == expected, launches
    assert seen <= sweep, sorted(seen - sweep)
    assert all(np.isfinite(v) for v in hist["loss"]), hist["loss"]
    assert all(0.0 < v <= 1.0 + 1e-6 for v in hist["psum_min_weight"])
    assert all(abs(p["weight_sum"] - m) < 1e-4 * m for p in periods)
    assert all(p["after"] < p["before"] for p in periods), periods
    ps_launches = launches["consensus_mix"]

    # ---- one period at full size ----
    gen = torch.Generator(device=dev).manual_seed(3)
    server = tree_map(lambda x: x[:, 0].clone(), run["state"].client_params)
    del run
    torch.cuda.empty_cache()
    server = tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, device=dev, generator=gen), server)
    leaves = tree_leaves(server)
    p = torch.tensor(np.ascontiguousarray(a_np.T), dtype=torch.float32,
                     device=dev)
    w = torch.cat([x.reshape(m, -1) for x in leaves], dim=1)
    out = torch.empty_like(w)
    err, rel = rel_err(torch, ops.consensus_mix(p, w, out=out),
                       ref.consensus_mix_ref(p, w))
    times = alternate(torch, {
        "kernel": lambda: ops.consensus_mix(p, w, out=out),
        "plain": lambda: ref.consensus_mix_ref(p, w),
        "library": lambda: torch.matmul(p, w)}, reps=10)
    d = w.shape[1]
    bound, by = bound_ms(2 * m * d * 4 + m * m * 4, 2 * m * m * d)
    del w, out
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    ps = cns.make_backend("gossip", a_np, t_s).mix_push_sum(
        cns.init_push_sum(server))
    torch.cuda.synchronize()
    period_launches = ops.launch_counts()["consensus_mix"]

    def plain_rounds(x):
        want = x.reshape(m, -1)
        for _ in range(t_s):
            want = ref.consensus_mix_ref(p, want)
        return want

    # a comprehension, so that no loop variable keeps a leaf (a view of
    # the period's whole buffer) alive after it
    vs_plain = max(rel_err(torch, got.reshape(m, -1), plain_rounds(x))[1]
                   for x, got in zip(leaves, tree_leaves(ps.values)))
    mass = mass_f64(torch, tree_leaves(ps.values), leaves, t_s)
    w_sum = float(ps.weight.double().sum())
    ratio = ps.ratio()
    d_ps = distance_from_mean_f64(torch, tree_leaves(ratio), leaves)
    del ratio, ps
    torch.cuda.empty_cache()
    rs = cns.make_backend("gossip", a_np, t_s).mix(server)
    d_rs = distance_from_mean_f64(torch, tree_leaves(rs), leaves)
    del rs
    d_0 = distance_from_mean_f64(torch, leaves, leaves)
    emit("push_sum_period_full_size", m=m, t_server=t_s, d=d,
         kernel_max_abs_err=err, kernel_max_rel_err=rel, kernel_limit=1e-5,
         kernel_ms=times["kernel"], plain_ms=times["plain"],
         library_ms=times["library"], bound_ms=bound, bound_by=by,
         bound_share=bound / times["kernel"], period_launches=period_launches,
         period_vs_plain_max_rel_err=vs_plain,
         mass_error_over_allowance=mass, weight_sum=w_sum,
         weight_sum_error=abs(w_sum - m),
         distance_from_mean={"before": d_0, "push_sum_ratio": d_ps,
                             "row_stochastic": d_rs},
         sigma_push_sum=tp.sigma_push_sum(a_np, t_s),
         sigma_a=tp.sigma_a(a_np, t_s))
    assert rel < 1e-5, rel
    assert period_launches == t_s, period_launches
    assert vs_plain < 1e-5, vs_plain
    assert mass <= 1.0, mass
    assert abs(w_sum - m) <= t_s * (m + 1) * EPS32 * m, w_sum
    assert d_ps < d_rs, (d_ps, d_rs)
    del server, leaves
    torch.cuda.empty_cache()
    row = {"name": "consensus_mix_push_sum", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/consensus_mix.cu",
           "replaces": "src/repro/kernels/consensus_mix.py:71",
           "launches": ps_launches, "max_abs_err": err, "ms": times["kernel"],
           "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
           "library_ms": times["library"]}

    # ---- one epoch on each wire ----
    wires = {
        "physical": (dict(shape, epochs=1, compression="int8",
                          wire="physical", error_feedback=True),
                     {"quantized_gossip_encode": 1,
                      "bucketed_gossip_round": t_s}),
        "simulated": (dict(shape, epochs=1, compression="int8"),
                      {"quantized_consensus_mix": 11,
                       "consensus_mix": t_s - 1})}
    for wire, (wshape, kernels) in wires.items():
        ops.reset_launch_counts()
        with period_disagreement(
                torch, tree_leaves, cns.CompressedBackend,
                "mix_push_sum_compressed", before=lambda st: st.values,
                after=lambda out: out[0].ratio(),
                extra=lambda out: weights(out[0])) as wperiods:
            run = ttrain.train("smollm-360m", **wshape, log=False)
            torch.cuda.synchronize()
        launches = ops.launch_counts()
        hist = run["history"]
        expected = {k: 0 for k in launches}
        expected.update(rmsnorm_fwd=norms * steps, rmsnorm_bwd=norms * steps,
                        **kernels)
        emit("train_push_sum_wire", wire=wire, compression="int8",
             error_feedback=wshape.get("error_feedback", False),
             loss=hist["loss"], psum_min_weight=hist["psum_min_weight"],
             epoch_s=hist["epoch_s"], wire_mb=hist["wire_mb"],
             wire_ratio=hist["wire_ratio"], periods=wperiods,
             launches=launches, expected_launches=expected)
        assert launches == expected, (wire, launches)
        assert all(np.isfinite(v) for v in hist["loss"]), hist["loss"]
        assert len(wperiods) == 1 and wperiods[0]["after"] < \
            wperiods[0]["before"], wperiods
        assert abs(wperiods[0]["weight_sum"] - m) < 1e-4 * m, wperiods
        del run
        torch.cuda.empty_cache()

    # ---- three dynamic epochs: direction drops, server 2 out and back ----
    ops.reset_launch_counts()
    with surgery_weights(DynamicFederationEngine) as surgeries, \
            per_epoch_readings(torch, ops, DynamicFederationEngine) as eps:
        run = ttrain.train_dynamic("smollm-360m", **PS_DYN_TRAIN, log=False)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    hist, engine = run["history"], run["engine"]
    client_steps = sum(int(k) * PS_DYN_TRAIN["clients"]
                       * PS_DYN_TRAIN["t_client"]
                       for k in hist["num_servers"])
    emit("train_dynamic_push_sum", arch="smollm-360m",
         loss=hist["loss"], num_servers=hist["num_servers"],
         participation=hist["participation"],
         psum_min_weight=hist["psum_min_weight"],
         sigma_prod=hist["sigma_prod"], disagreement=hist["disagreement"],
         epoch_s=hist["epoch_s"], alloc_gb=hist.get("alloc_gb"),
         epoch_peak_gb=[e["peak_gb"] for e in eps],
         weights_after_surgery={e: w.tolist() for e, w in surgeries},
         launches=launches, builds_per_m=engine.compile_counts())
    assert hist["num_servers"] == [4.0, 3.0, 4.0], hist["num_servers"]
    assert [e for e, _ in surgeries] == [1, 2], surgeries
    assert all(torch.equal(w, torch.ones_like(w)) for _, w in surgeries)
    assert [len(w) for _, w in surgeries] == [3, 4], surgeries
    assert launches["consensus_mix"] == t_s * 3, launches
    assert launches["rmsnorm_fwd"] == norms * client_steps, launches
    assert launches["rmsnorm_bwd"] == norms * client_steps, launches
    assert all(v == 0 for k, v in launches.items()
               if not k.startswith(("consensus_mix", "rmsnorm"))), launches
    assert all(np.isfinite(v) for v in hist["loss"]), hist["loss"]
    assert all(0.0 < v <= 1.0 + 1e-6 for v in hist["psum_min_weight"])
    assert engine.compile_counts() == {4: 1, 3: 1}, engine.compile_counts()
    del run, engine
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# robust gossip under the Byzantine injection, and checkpointing
# ---------------------------------------------------------------------------

# the robust path: the dynamic path's shape on K_4 (Metropolis weights 1/4)
# with full participation, one epoch a run; one attacker of four is the
# CLI's sign_flip:0.25
ROBUST_TRAIN = dict(smoke=False, servers=4, clients=2, t_client=2,
                    t_server=5, epochs=1, seq_len=128, per_client_batch=2,
                    gamma=0.05, graph="complete", device="cuda")
# (consensus mode, attack, epochs): the runs of the train_robust cell
ROBUST_RUNS = [("gossip", "", 1), ("trimmed_mean:0", "", 1),
               ("gossip", "sign_flip:0.25", 1),
               ("trimmed_mean:1", "sign_flip:0.25", 2),
               ("median", "scaled_noise:0.25:10", 1),
               ("clipped", "sign_flip:0.25", 2)]
# the pull of one full-size period: a screen must keep the honest servers
# within this share of their mean's norm (plain gossip reads ~0.5)
SCREEN_PULL_LIMIT = 0.05
# SmolLM-360M's depth cut for the checkpoint cell (the widths kept)
CKPT_LAYERS = 2


@contextlib.contextmanager
def screen_readings(torch, cns, methods, t_server: int):
    """Within the block, every call of the given ``(backend class, method)``
    pairs (a period: ``mix``, or ``mix_stats`` with its per-source counts)
    records its device milliseconds (CUDA events around the period) and
    the counts, and the rank screens' counts of each period's
    FIRST round, the one that sees the attack: on a complete graph every
    receiver holds the same value after it, and later rounds break those
    ties by source index (the lowest and the highest lose)."""
    records = []
    saved = {(cls, attr): getattr(cls, attr) for cls, attr in methods}
    # an inherited method is restored by deleting the wrapper, so that no
    # copy of it shadows the base class's afterwards
    own = {(cls, attr) for cls, attr in methods if attr in vars(cls)}
    block_round = cns._rank_keep_block
    first = {"rej": None, "calls": 0}

    def round_noted(sup, x, rule, rejected):
        before = rejected.clone() if first["calls"] % t_server == 0 else None
        out = block_round(sup, x, rule, rejected)
        if before is not None:
            delta = rejected - before
            first["rej"] = delta if first["rej"] is None \
                else first["rej"] + delta
        first["calls"] += 1
        return out

    def wrap(inner):
        def measured(self, tree, *args, **kw):
            first["rej"], first["calls"] = None, 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(self, tree, *args, **kw)
            end.record()
            torch.cuda.synchronize()
            stats = isinstance(out, tuple) and len(out) == 2 \
                and isinstance(out[1], torch.Tensor)
            records.append({
                "ms": start.elapsed_time(end),
                "rejected": out[1].cpu().tolist() if stats else None,
                "first_round_rejected": (None if first["rej"] is None
                                         else first["rej"].cpu().tolist())})
            return out
        return measured

    for (cls, attr), inner in saved.items():
        setattr(cls, attr, wrap(inner))
    cns._rank_keep_block = round_noted
    try:
        yield records
    finally:
        for (cls, attr), inner in saved.items():
            if (cls, attr) in own:
                setattr(cls, attr, inner)
            else:
                delattr(cls, attr)
        cns._rank_keep_block = block_round


@contextlib.contextmanager
def synced_seconds(torch, targets: dict):
    """Within the block, the wall seconds and calls of each ``name: (owner,
    attribute)`` target, the device synchronised before and after each call
    (so nested targets each read their own share)."""
    stats = {name: {"s": 0.0, "calls": 0} for name in targets}
    saved = {name: getattr(owner, attr)
             for name, (owner, attr) in targets.items()}

    def wrap(name, inner):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                torch.cuda.synchronize()
                stats[name]["s"] += time.perf_counter() - t0
                stats[name]["calls"] += 1
        return call

    for name, (owner, attr) in targets.items():
        setattr(owner, attr, wrap(name, saved[name]))
    try:
        yield stats
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, saved[name])


def robust_federation(torch, ttrain, ops, sweep: set) -> dict:
    """``train_dynamic`` on full SmolLM-360M over K_4 for each run of
    ROBUST_RUNS, the counters reset before each: launches (kernel 1 T_S an
    epoch for gossip, trimmed_mean:0 and clipped, none for the rank
    screens; kernel 2 65 x 16 a direction an epoch; nothing else), epoch
    seconds and peaks, the attacking share, the per-source screen counts
    (the attacker's at least twice each honest server's under the rank
    screens) and the screen's device time a period; trimmed_mean:0's
    server models bitwise plain gossip's.  Then trimmed_mean:1 over the
    int8 simulated wire (kernel 4 once a leaf on A = I, kernel 1 never).
    Returns the clipped run's kernel-1 launches."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core import consensus as cns
    from repro_torch.core.engine import DynamicFederationEngine
    from repro_torch.core.schedule import ByzantineSchedule
    from repro_torch.tree import tree_leaves
    shape = ROBUST_TRAIN
    m, t_s = shape["servers"], shape["t_server"]
    steps = shape["t_client"] * m * shape["clients"]
    norms = 2 * (get_smoke if shape["smoke"] else get_arch)(
        "smollm-360m").num_layers + 1
    # the period each run's epoch step calls: plain gossip's mix, the
    # robust backends' mix_stats (their screen readout)
    screens = ((cns.GossipBackend, "mix"), (cns.TrimmedMeanBackend,
                                            "mix_stats"),
               (cns.MedianBackend, "mix_stats"),
               (cns.ClippedGossipBackend, "mix_stats"))
    plain_servers, rows, clipped_launches = None, {}, 0
    for mode, spec, epochs in ROBUST_RUNS:
        ops.reset_launch_counts()
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        with launched_norms(torch) as seen, \
                per_epoch_readings(torch, ops,
                                   DynamicFederationEngine) as eps, \
                screen_readings(torch, cns, screens, t_s) as periods:
            run = ttrain.train_dynamic("smollm-360m", **dict(
                shape, epochs=epochs), consensus_mode=mode, byzantine=spec,
                log=False)
            torch.cuda.synchronize()
        launches = ops.launch_counts()
        hist = run["history"]
        mixes = 0 if mode in ("trimmed_mean:1", "median") else t_s
        expected = {k: 0 for k in launches}
        expected.update(consensus_mix=mixes * epochs,
                        rmsnorm_fwd=norms * steps * epochs,
                        rmsnorm_bwd=norms * steps * epochs)
        attacker = None
        if spec:
            codes = ByzantineSchedule.parse(spec, seed=0).codes(
                0, tuple(range(m)), m)
            attacker = int(np.nonzero(codes)[0][0])
        screened = [p for p in periods if p["rejected"]
                    and any(p["rejected"])]
        row = {"mode": mode, "attack": spec, "epochs": epochs,
               "attacker": attacker, "loss": hist["loss"],
               "disagreement": hist["disagreement"],
               "epoch_s": hist["epoch_s"], "held_before_gb": held_gb,
               "epoch_peak_gb": [e["peak_gb"] for e in eps],
               "launches": launches, "expected_launches": expected,
               "byzantine": hist.get("byzantine"),
               "screen_rejected": hist.get("screen_rejected"),
               "per_source_rejected": [p["rejected"] for p in periods],
               "first_round_rejected": [p["first_round_rejected"]
                                        for p in periods],
               "screen_ms": [p["ms"] for p in periods],
               "screen_ms_a_round": [p["ms"] / t_s for p in periods]}
        emit("train_robust", **row)
        assert launches == expected, (mode, spec, launches)
        assert seen <= sweep, sorted(seen - sweep)
        assert all(np.isfinite(v) for v in hist["loss"]), hist["loss"]
        assert len(periods) == epochs, periods
        if spec:
            assert hist["byzantine"] == [1.0 / m] * epochs, hist["byzantine"]
        if mode in ("trimmed_mean:1", "median"):
            assert len(screened) == epochs, periods
            for p in periods:
                rej = p["first_round_rejected"]
                honest = [r for j, r in enumerate(rej) if j != attacker]
                assert rej[attacker] >= 2 * max(honest), (mode, rej)
        server = [x[:, 0] for x in tree_leaves(run["state"].client_params)]
        if mode == "gossip" and not spec:
            plain_servers = [x.clone() for x in server]
        elif mode == "trimmed_mean:0":
            assert all(torch.equal(a, b)
                       for a, b in zip(server, plain_servers)), mode
            plain_servers = None
        if mode == "clipped":
            clipped_launches = launches["consensus_mix"]
        rows[f"{mode}+{spec or 'none'}"] = {
            "epoch_s": hist["epoch_s"],
            "screen_ms_a_round": row["screen_ms_a_round"]}
        del run, server
        torch.cuda.empty_cache()

    # trimmed_mean:1 over the int8 simulated wire: kernel 4 decodes each
    # leaf on A = I, then the screen runs the whole period
    from repro_torch.comm import prng
    from repro_torch.comm.accounting import BytesTracker
    from repro_torch.comm.compressors import (make_compressor,
                                              tree_message_elems,
                                              tree_wire_bytes_per_server)
    from repro_torch.core import dfl
    ops.reset_launch_counts()
    parts = {"period": (cns.CompressedBackend, "mix_compressed"),
             "kernel4": (ops, "quantized_consensus_mix"),
             "dither": (prng, "uniform"),
             "screen": (cns.TrimmedMeanBackend, "mix_stats"),
             "injection": (dfl, "apply_byzantine")}
    with per_epoch_readings(torch, ops, DynamicFederationEngine) as eps, \
            synced_seconds(torch, parts) as split:
        run = ttrain.train_dynamic(
            "smollm-360m", **shape, consensus_mode="trimmed_mean:1",
            byzantine="sign_flip:0.25", compression="int8", log=False)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    hist = run["history"]
    leaves = tree_leaves(run["state"].client_params)
    expected = {k: 0 for k in launches}
    expected.update(quantized_consensus_mix=len(leaves),
                    rmsnorm_fwd=norms * steps, rmsnorm_bwd=norms * steps)
    # the wire ledger counts the links of A, whatever the inner mode
    abstract = [torch.empty((m,) + tuple(x.shape[2:]), device="meta")
                for x in leaves]
    codec = make_compressor("int8")
    want_mb = BytesTracker(codec).update(
        run["engine"].topo.mixing_matrix(), t_s,
        row_bytes=tree_wire_bytes_per_server(codec, abstract),
        elems_per_row=tree_message_elems(abstract)) / 1e6
    emit("train_robust_sim", mode="trimmed_mean:1", attack="sign_flip:0.25",
         compression="int8", loss=hist["loss"], epoch_s=hist["epoch_s"],
         epoch_peak_gb=[e["peak_gb"] for e in eps],
         byzantine=hist["byzantine"], wire_mb=hist["wire_mb"],
         wire_ratio=hist["wire_ratio"], expected_wire_mb=want_mb,
         seconds=split,
         launches=launches, expected_launches=expected)
    assert launches == expected, launches
    assert hist["wire_mb"] == [want_mb], (hist["wire_mb"], want_mb)
    assert all(np.isfinite(v) for v in hist["loss"]), hist["loss"]
    rows["sim"] = {"epoch_s": hist["epoch_s"]}
    del run, leaves
    torch.cuda.empty_cache()
    return {"clipped_launches": clipped_launches, "runs": rows}


def pull_f64(torch, leaves, mean_leaves) -> float:
    """max_i ||x_i - hbar|| / ||hbar|| over the rows of ``leaves``, float64,
    ``hbar`` given by ``mean_leaves`` (one row a leaf)."""
    m = leaves[0].shape[0]
    sq, ref_sq = [0.0] * m, 0.0
    for x, h in zip(leaves, mean_leaves):
        xf, hf = x.reshape(m, -1), h.reshape(-1)
        for lo in range(0, xf.shape[1], 1 << 24):
            hb = hf[lo:lo + (1 << 24)].double()
            ref_sq += float((hb * hb).sum())
            for i in range(m):
                d = xf[i, lo:lo + (1 << 24)].double() - hb
                sq[i] += float((d * d).sum())
    return max(s ** 0.5 for s in sq) / ref_sq ** 0.5


def robust_period_full_size(torch) -> dict:
    """One period of each robust backend on a (4, 361,821,120) server tree:
    seeded honest rows around the SmolLM init (spread 1e-3 of each leaf's
    rms), row 0 attacked through ``apply_byzantine``.  The attacks timed
    (honest rows unchanged bitwise; the inlier shift inside the honest
    envelope); kernel 1 under clipped gossip's ``C`` against its plain
    version and timed (row 1c), ``C``'s rows summing to 1 and the
    attacker's weights under tau/dist; each period's pull of the honest
    servers from their pre-attack mean, float64: plain gossip as the
    control (~0.5 on K_4), each screen at least 10x below it."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core import consensus as cns
    from repro_torch.core import dfl
    from repro_torch.core import topology as tp
    from repro_torch.core.schedule import ByzantineAttack
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
    shape = ROBUST_TRAIN
    dev = torch.device(shape["device"])
    m, t_s = shape["servers"], shape["t_server"]
    a_np = tp.metropolis_weights(tp.complete_graph(m))
    a = torch.tensor(a_np, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    base = ttf.init_params(g, (get_smoke if shape["smoke"] else get_arch)(
        "smollm-360m"), device=dev)
    base_leaves, treedef = tree_flatten(base)
    honest_leaves = []
    for p in base_leaves:
        rms = float(p.float().pow(2).mean().sqrt()) or 1.0
        honest_leaves.append(p[None] + 1e-3 * rms * torch.randn(
            (m,) + tuple(p.shape), device=dev, generator=g))
    del base, base_leaves
    honest = tree_unflatten(treedef, honest_leaves)
    hbar = [x[1:].mean(dim=0) for x in honest_leaves]
    spread = pull_f64(torch, [x[1:] for x in honest_leaves], hbar)
    codes = np.array([1, 0, 0, 0], np.int32)
    key = np.array([0, 22], np.uint32)

    # ---- the attacks, each timed ----
    attack_s, attacked = {}, None
    for kind, scale in (("sign_flip", 1.0), ("scaled_noise", 10.0),
                        ("inlier_shift", 0.8)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dfl.apply_byzantine(honest, codes, key,
                                  (ByzantineAttack(kind, 0.25, scale),))
        torch.cuda.synchronize()
        attack_s[kind] = time.perf_counter() - t0
        for x, y in zip(tree_leaves(honest), tree_leaves(out)):
            assert torch.equal(x[1:], y[1:]), kind
            assert not torch.equal(x[0], y[0]), kind
            if kind == "inlier_shift":
                lo, hi = x[1:].amin(dim=0), x[1:].amax(dim=0)
                assert bool(((y[0] >= lo) & (y[0] <= hi)).all()), kind
        if kind == "sign_flip":
            attacked = out
        del out
    torch.cuda.empty_cache()

    # ---- kernel 1 under clipped gossip's C ----
    c, clipped = cns.clip_weights_stats(a, attacked)
    d2 = cns._gram_d2(a, tree_leaves(attacked))
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    off = ~torch.eye(m, dtype=torch.bool, device=dev)
    tau = torch.stack([dist[i][off[i]].sort().values[(m - 2) // 2]
                       for i in range(m)])
    row_sums = c.sum(dim=1)
    attacker_w = c[1:, 0]
    attacker_lim = a[1:, 0] * tau[1:] / dist[1:, 0]
    assert float((row_sums - 1.0).abs().max()) <= 1e-6, row_sums
    assert bool((attacker_w <= attacker_lim * (1 + 1e-5)).all()), (
        attacker_w, attacker_lim)
    w = torch.cat([x.reshape(m, -1) for x in tree_leaves(attacked)], dim=1)
    out = torch.empty_like(w)
    ops.reset_launch_counts()
    err, rel = rel_err(torch, ops.consensus_mix(c, w, out=out),
                       ref.consensus_mix_ref(c, w))
    assert ops.launch_counts()["consensus_mix"] == 1
    times = alternate(torch, {
        "kernel": lambda: ops.consensus_mix(c, w, out=out),
        "plain": lambda: ref.consensus_mix_ref(c, w),
        "library": lambda: torch.matmul(c, w)}, reps=10)
    d = w.shape[1]
    bound, by = bound_ms(2 * m * d * 4 + m * m * 4, 2 * m * m * d)
    del w, out
    torch.cuda.empty_cache()
    assert rel < 1e-5, rel

    # ---- one period of each backend: the pull, float64 ----
    pulls, period_ms, launches = {}, {}, {}
    for mode in ("gossip", "trimmed_mean:1", "median", "clipped"):
        be = cns.make_backend(mode, a_np, t_s)
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mixed, rejected = be.mix_stats(attacked)
        end.record()
        torch.cuda.synchronize()
        period_ms[mode] = start.elapsed_time(end)
        launches[mode] = ops.launch_counts()["consensus_mix"]
        pulls[mode] = pull_f64(torch, [x[1:] for x in tree_leaves(mixed)],
                               hbar)
        del mixed, rejected
        torch.cuda.empty_cache()
    rank_bound, _ = bound_ms(2 * m * d * 4, 0)
    row = {"m": m, "t_server": t_s, "d": d, "honest_spread": spread,
           "attack_s": attack_s, "c": c.tolist(),
           "c_row_sums": row_sums.tolist(),
           "attacker_weights": attacker_w.tolist(),
           "attacker_weight_limits": attacker_lim.tolist(),
           "clipped_links": clipped.tolist(),
           "kernel_max_abs_err": err, "kernel_max_rel_err": rel,
           "kernel_limit": 1e-5, "kernel_ms": times["kernel"],
           "plain_ms": times["plain"], "library_ms": times["library"],
           "bound_ms": bound, "bound_by": by,
           "bound_share": bound / times["kernel"],
           "period_ms": period_ms, "period_launches": launches,
           "rank_screen_ms_a_round": {
               k: period_ms[k] / t_s for k in ("trimmed_mean:1", "median")},
           "rank_screen_bound_ms_a_round": rank_bound,
           "pull": pulls, "pull_limit": SCREEN_PULL_LIMIT}
    emit("robust_period_full_size", **row)
    assert pulls["gossip"] > SCREEN_PULL_LIMIT, pulls
    for mode in ("trimmed_mean:1", "median", "clipped"):
        assert pulls[mode] < SCREEN_PULL_LIMIT, (mode, pulls)
        assert pulls[mode] * 10 <= pulls["gossip"], (mode, pulls)
    assert launches == {"gossip": t_s, "trimmed_mean:1": 0, "median": 0,
                        "clipped": t_s}, launches
    del honest, attacked, honest_leaves, hbar
    torch.cuda.empty_cache()
    return {"name": "consensus_mix_clipped", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/consensus_mix.cu",
            "replaces": "src/repro/kernels/consensus_mix.py:71",
            "max_abs_err": err, "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": times["library"]}


def ckpt_roundtrip(torch, ttrain) -> None:
    """SmolLM-360M at full width, depth cut to CKPT_LAYERS: one epoch of
    ``train_dynamic`` at M = 4, N = 2 saved through ``ckpt_dir``;
    ``restore_dropped(server 2)`` onto M = 3 and one more epoch on a fresh
    engine, against the run whose engine drops server 2 at epoch 1 itself
    (``tests/test_checkpoint_surgery.py``'s tolerance); save and restore
    seconds and the file's GB."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.core import make_engine
    from repro_torch.core.dfl import DFLState
    from repro_torch.optim.optimizers import SGDState
    from repro_torch.tree import tree_leaves, tree_map
    shape = dict(DYN_TRAIN, participation_rate=1.0, edge_drop_prob=0.0,
                 graph="complete", faults="")
    arch = "smollm-360m"
    resolve = get_smoke if shape["smoke"] else get_arch
    with cut_depth(ttrain, arch, CKPT_LAYERS):
        surgery = ttrain.train_dynamic(arch, **dict(
            shape, epochs=2, faults="drop:1:2"), log=False)
        directory = tempfile.mkdtemp(prefix="ckpt_roundtrip_")
        save_s = []
        inner = Checkpointer.save

        def timed_save(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(self, *args, **kw)
            save_s.append(time.perf_counter() - t0)
            return out

        Checkpointer.save = timed_save
        try:
            first = ttrain.train_dynamic(arch, **dict(shape, epochs=1),
                                         ckpt_dir=directory, log=False)
        finally:
            Checkpointer.save = inner
        ck = Checkpointer(directory)
        path = ck._path(0)
        file_gb = os.path.getsize(path) / 1e9
        state = first["state"]
        topo = first["engine"].topo
        keep = torch.tensor([0, 1, 3], device=torch.device(shape["device"]))
        template = tree_map(lambda x: x.index_select(0, keep),
                            state.client_params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, new_topo = ck.restore_dropped(template, 2, topo)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        # the pipeline of the ORIGINAL four servers: data follows identity
        _, cfg, _, loss_fn, optimizer, pipe, params = ttrain._setup_lm(
            arch, shape["smoke"], 4, shape["clients"], shape["t_client"],
            shape["t_server"], "complete", shape["gamma"], shape["seq_len"],
            shape["per_client_batch"], 0, shape["device"], "symmetric", None)
        del params
        survivors = [0, 1, 3]
        eng = make_engine(new_topo, loss_fn, optimizer)

        def batch_fn(epoch, alive):
            return pipe.epoch_batches(
                epoch, server_ids=tuple(survivors[i] for i in alive))

        cont = DFLState(restored, SGDState(state.opt_state.count),
                        state.epoch, state.rng, None, state.wire_key)
        cont, _ = eng.run_epoch(cont, 1, batch_fn)
        torch.cuda.synchronize()
    worst = 0.0
    for a, b in zip(tree_leaves(cont.client_params),
                    tree_leaves(surgery["state"].client_params)):
        lim = 1e-7 + 1e-6 * b.abs()
        worst = max(worst, float(((a - b).abs() / lim).max()))
    n_params = sum(x[0, 0].numel() for x in tree_leaves(state.client_params))
    emit("ckpt_roundtrip", arch=arch, params=n_params,
         reduced={"depth": f"{CKPT_LAYERS}/{resolve(arch).num_layers}"},
         servers=[4, 3], save_s=save_s, restore_s=restore_s,
         file_gb=file_gb, survivors=survivors,
         surgery_num_servers=surgery["history"]["num_servers"],
         max_err_over_tolerance=worst, tolerance={"rtol": 1e-6,
                                                  "atol": 1e-7})
    assert surgery["history"]["num_servers"] == [4.0, 3.0]
    assert surgery["engine"].alive == survivors, surgery["engine"].alive
    assert worst <= 1.0, worst
    shutil.rmtree(directory)
    assert not os.path.exists(directory)
    del surgery, first, state, restored, cont, template
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# observability: the engine's spans, the replay probe, the trainers' files
# ---------------------------------------------------------------------------

# the physical wire through the dynamic engine (full participation, the
# static ring), where the probe runs kernels 6 and 7
OBS_WIRE = dict(DYN_TRAIN, participation_rate=1.0, edge_drop_prob=0.0,
                faults="", epochs=1, compression="int8", wire="physical",
                error_feedback=True)
# the superepoch against K = 1: the dynamic cell without faults, 4 epochs
OBS_SUPER = dict(DYN_TRAIN, faults="", epochs=4)
# history columns compared bit for bit (epoch_s and alloc_gb are readings)
OBS_READINGS = ("epoch_s", "alloc_gb")


@contextlib.contextmanager
def obs_off(ttrain):
    """Within the block the trainers run under ``OBS_OFF``: no sink, no
    tracer, no monitor."""
    from repro_torch.obs import OBS_OFF
    inner = ttrain._make_observability
    ttrain._make_observability = lambda **kw: OBS_OFF
    try:
        yield
    finally:
        ttrain._make_observability = inner


def state_fingerprint(torch, state, tree_leaves) -> list:
    """The wire key's bytes and, per error-feedback residual leaf, the sum
    of its int32 bit patterns (int64) and of its magnitudes (float64)."""
    fp = [None if state.wire_key is None else state.wire_key.tobytes()]
    for leaf in ([] if state.ef_residual is None
                 else tree_leaves(state.ef_residual)):
        fp.append((int(leaf.view(torch.int32).sum(dtype=torch.int64)),
                   float(leaf.abs().sum(dtype=torch.float64))))
    return fp


def params_fingerprint(torch, params, tree_leaves) -> list:
    return [int(x.view(torch.int32).sum(dtype=torch.int64))
            for x in tree_leaves(params)]


@contextlib.contextmanager
def probe_readings(torch, engine_cls, tree_leaves, check_state=False):
    """Within the block, every consensus-replay probe run records the
    federation size, its own clock reading, its wall seconds and (with
    ``check_state``) whether the state's wire key and error-feedback
    residual are the same after it as before."""
    records = []
    inner = engine_cls._time_probe

    def measured(self, probe, state, a_np, lam2):
        before = (state_fingerprint(torch, state, tree_leaves)
                  if check_state else None)
        t0 = time.perf_counter()
        ns = inner(self, probe, state, a_np, lam2)
        rec = {"m": self.topo.num_servers, "probe_ms": ns / 1e6,
               "wall_s": time.perf_counter() - t0}
        if check_state:
            rec["state_untouched"] = before == state_fingerprint(
                torch, state, tree_leaves)
        records.append(rec)
        return ns

    engine_cls._time_probe = measured
    try:
        yield records
    finally:
        engine_cls._time_probe = inner


@contextlib.contextmanager
def step_consensus_events(torch, cns, engine_cls):
    """Within the block, CUDA events around every gossip period an epoch
    step runs (``GossipBackend.mix``, not the replay probe's calls): the
    in-step truth the replay estimate is held to."""
    pairs = []
    in_probe = [False]
    owner = cns.GossipBackend
    own = "mix" in vars(owner)
    mix = owner.mix
    time_probe = engine_cls._time_probe

    def timed_mix(self, *args, **kw):
        if in_probe[0]:
            return mix(self, *args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = mix(self, *args, **kw)
        end.record()
        pairs.append((start, end))
        return out

    def flagged(self, *args, **kw):
        in_probe[0] = True
        try:
            return time_probe(self, *args, **kw)
        finally:
            in_probe[0] = False

    owner.mix = timed_mix
    engine_cls._time_probe = flagged
    try:
        yield pairs
    finally:
        if own:
            owner.mix = mix
        else:
            del owner.mix
        engine_cls._time_probe = time_probe


def span_rows(tracer) -> list:
    """Each ``epoch`` span's milliseconds and its children's, by name."""
    rows = []
    for ep in (s for s in tracer.spans if s.name == "epoch"):
        row = {"epoch": ep.args["epoch"], "epoch_ms": ep.duration_ns / 1e6}
        for s in tracer.spans:
            if s.parent is ep:
                row[s.name + "_ms"] = s.duration_ns / 1e6
        rows.append(row)
    return rows


def check_obs_files(obs_mod, jpath: str, cpath: str, epochs: int) -> set:
    """Both files validate; the stream holds one epoch event an epoch.
    Returns the trace's event names."""
    events = obs_mod.validate_jsonl(obs_mod.load_jsonl(jpath))
    assert sum(e["kind"] == "epoch" for e in events) == epochs, events
    with open(cpath, encoding="utf-8") as f:
        trace = obs_mod.validate_chrome_trace(json.load(f))
    return {e["name"] for e in trace}


def same_records(a: dict, b: dict) -> bool:
    keys = [k for k in a if k not in OBS_READINGS]
    return set(keys) == {k for k in b if k not in OBS_READINGS} and all(
        a[k] == b[k] for k in keys)


def observability(torch, ttrain, ops, cns, smi: str) -> None:
    """The obs phases: the dynamic cell untraced (``OBS_OFF``) and with the
    full bundle, then with CUDA events around the step's own consensus
    call; the physical wire's probe; the superepoch against K = 1; the
    static trainer's files.  Every traced history is held bit for bit to
    the untraced one."""
    import shutil
    import tempfile
    from repro_torch import obs as tobs
    from repro_torch.core.engine import DynamicFederationEngine as Eng
    from repro_torch.tree import tree_leaves
    directory = tempfile.mkdtemp(prefix="obs_")
    t_s = DYN_TRAIN["t_server"]

    def path(name):
        return str(pathlib.Path(directory) / name)

    def run_dynamic(shape, traced: bool, name: str = "dyn"):
        torch.cuda.reset_peak_memory_stats()
        if traced:
            run = ttrain.train_dynamic(
                "smollm-360m", **shape, telemetry_jsonl=path(name + ".jsonl"),
                chrome_trace=path(name + ".json"))
        else:
            with obs_off(ttrain):
                run = ttrain.train_dynamic("smollm-360m", **shape)
        torch.cuda.synchronize()
        return run, torch.cuda.max_memory_allocated() / 1e9

    # ---- obs_dynamic: OBS_OFF, then hub + JSONL + tracer + monitor ----
    n_ep = DYN_TRAIN["epochs"]
    ops.reset_launch_counts()
    plain, plain_peak = run_dynamic(DYN_TRAIN, False)
    plain_launches = ops.launch_counts()
    plain_hist = plain["history"]
    del plain
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    with probe_readings(torch, Eng, tree_leaves) as probes:
        run, traced_peak = run_dynamic(DYN_TRAIN, True)
    launches = ops.launch_counts()
    hist, tracer = run["history"], run["obs"].tracer
    causes = [ev["args"]["cause"] for ev in tracer.instants
              if ev["name"] == "compile"]
    builds = run["engine"].compile_counts()
    names = check_obs_files(tobs, path("dyn.jsonl"), path("dyn.json"), n_ep)
    # the step's T_S an epoch, the probe's timed T_S an epoch, and one
    # untimed warm-up period per new M (4, then 3)
    n_m = len(set(hist["num_servers"]))
    want_k1 = t_s * (n_ep + n_ep + n_m)
    nests = all(s.parent.encloses(s) for s in tracer.spans
                if s.parent is not None)
    rows = span_rows(tracer)
    del run
    torch.cuda.empty_cache()
    emit("obs_dynamic", nvidia_smi=smi, num_servers=hist["num_servers"],
         epoch_s_untraced=plain_hist["epoch_s"], epoch_s_traced=hist["epoch_s"],
         traced_minus_untraced_s=[a - b for a, b in zip(
             hist["epoch_s"], plain_hist["epoch_s"])],
         periods=rows, probe_runs=probes, compile_causes=causes,
         builds_per_m=builds, span_names=sorted(names),
         consensus_mix_launches={"untraced": plain_launches["consensus_mix"],
                                 "traced": launches["consensus_mix"],
                                 "expected_traced": want_k1},
         peak_gb_untraced=plain_peak, peak_gb_traced=traced_peak,
         server_tree_gb=DYN_TRAIN["servers"] * SMOLLM_REPLICA_GB)
    assert same_records(hist, plain_hist), (hist, plain_hist)
    assert causes == ["first_trace", "federation_size_change"], causes
    assert builds == {4: 1, 3: 1}, builds
    assert nests, "a span lies outside its parent"
    assert {"epoch", "fault-surgery", "local-period", "gossip-period",
            "host-aggregation", "compile"} <= names, names
    assert plain_launches["consensus_mix"] == t_s * n_ep, plain_launches
    assert launches["consensus_mix"] == want_k1, launches
    assert launches["rmsnorm_fwd"] == plain_launches["rmsnorm_fwd"]

    # the replay estimate against the in-step truth: CUDA events around the
    # step's own consensus call, in one more traced run of two epochs
    with step_consensus_events(torch, cns, Eng) as pairs:
        run, _ = run_dynamic(dict(DYN_TRAIN, epochs=2), True, "dyn_events")
    torch.cuda.synchronize()
    in_step = [s.elapsed_time(e) for s, e in pairs]
    rows2 = span_rows(run["obs"].tracer)
    del run
    torch.cuda.empty_cache()
    replay = [r["gossip-period_ms"] for r in rows2]
    emit("obs_replay_vs_in_step", nvidia_smi=smi, replay_ms=replay,
         in_step_cuda_event_ms=in_step,
         ratio=[a / b for a, b in zip(replay, in_step)])
    assert len(in_step) == len(replay) == 2, (in_step, replay)

    # ---- obs_wire: the physical int8 wire with error feedback ----
    ops.reset_launch_counts()
    plain, plain_peak = run_dynamic(OBS_WIRE, False)
    plain_launches = ops.launch_counts()
    plain_hist = plain["history"]
    plain_fp = (params_fingerprint(torch, plain["state"].client_params,
                                   tree_leaves),
                state_fingerprint(torch, plain["state"], tree_leaves))
    del plain
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    with probe_readings(torch, Eng, tree_leaves, check_state=True) as probes:
        run, traced_peak = run_dynamic(OBS_WIRE, True, "wire")
    launches = ops.launch_counts()
    hist = run["history"]
    fp = (params_fingerprint(torch, run["state"].client_params, tree_leaves),
          state_fingerprint(torch, run["state"], tree_leaves))
    rows = span_rows(run["obs"].tracer)
    check_obs_files(tobs, path("wire.jsonl"), path("wire.json"),
                    OBS_WIRE["epochs"])
    del run
    torch.cuda.empty_cache()
    n_ep = OBS_WIRE["epochs"]
    periods = n_ep + n_ep + 1           # step, timed probe, one warm-up
    wire_kernels = ("quantized_gossip_encode", "bucketed_gossip_round")
    emit("obs_wire", nvidia_smi=smi, epoch_s_untraced=plain_hist["epoch_s"],
         epoch_s_traced=hist["epoch_s"],
         probe_cost_s_per_epoch=[a - b for a, b in zip(
             hist["epoch_s"], plain_hist["epoch_s"])],
         probe_runs=probes, periods=rows,
         launches={k: {"untraced": plain_launches[k], "traced": launches[k]}
                   for k in wire_kernels + ("consensus_mix",)},
         expected_traced={"quantized_gossip_encode": periods,
                          "bucketed_gossip_round": periods * t_s},
         peak_gb_untraced=plain_peak, peak_gb_traced=traced_peak,
         final_state_equal=fp == plain_fp)
    assert same_records(hist, plain_hist), (hist, plain_hist)
    assert fp == plain_fp
    assert all(p["state_untouched"] for p in probes), probes
    assert len(probes) == periods - n_ep, probes
    assert launches["quantized_gossip_encode"] == periods, launches
    assert launches["bucketed_gossip_round"] == periods * t_s, launches
    assert plain_launches["quantized_gossip_encode"] == n_ep
    assert plain_launches["bucketed_gossip_round"] == n_ep * t_s

    # ---- obs_superepoch: K = 4 against K = 1 in turns (K = 1, K = 4
    # traced, K = 4, K = 1) ----
    runs = []
    for k, traced in ((1, False), (4, True), (4, False), (1, False)):
        ops.reset_launch_counts()
        run, peak = run_dynamic(dict(OBS_SUPER, superepoch=k), traced,
                                "super")
        runs.append({"k": k, "traced": traced, "hist": run["history"],
                     "spans": None if not traced else [
                         (s.name, s.parent, s) for s in
                         run["obs"].tracer.spans],
                     "epochs_per_s": OBS_SUPER["epochs"]
                     / sum(run["history"]["epoch_s"]),
                     "consensus_mix": ops.launch_counts()["consensus_mix"],
                     "peak_gb": peak})
        del run
        torch.cuda.empty_cache()
    spans = next(r["spans"] for r in runs if r["traced"])
    supers = [s for name, _, s in spans if name == "superepoch"]
    epochs = [s for name, parent, s in spans
              if name == "epoch" and parent is supers[0]]
    rounds = [[s for name, parent, s in spans if name == "gossip-round"
               and parent.parent is ep] for ep in epochs]
    emit("obs_superepoch", nvidia_smi=smi,
         runs=[{k: v for k, v in r.items() if k not in ("hist", "spans")}
               for r in runs],
         epochs_per_s_k1=[r["epochs_per_s"] for r in runs if r["k"] == 1],
         epochs_per_s_k4=[r["epochs_per_s"] for r in runs if r["k"] == 4],
         epoch_s={f"{r['k']}{'_traced' if r['traced'] else ''}_{i}":
                  r["hist"]["epoch_s"] for i, r in enumerate(runs)},
         superepoch_spans=len(supers), epoch_spans=len(epochs),
         gossip_rounds=[len(r) for r in rounds])
    assert all(same_records(r["hist"], runs[0]["hist"]) for r in runs)
    assert len(supers) == 1 and len(epochs) == OBS_SUPER["epochs"]
    assert all(e.args["method"] == "uniform-split" for e in epochs)
    assert [len(r) for r in rounds] == [t_s] * OBS_SUPER["epochs"], rounds
    del runs, spans, supers, epochs, rounds

    # ---- obs_static: the static trainer's files, one epoch ----
    static = dict(TRAIN, epochs=1)
    ops.reset_launch_counts()
    with obs_off(ttrain):
        plain = ttrain.train("smollm-360m", **static)
    plain_hist = plain["history"]
    del plain
    torch.cuda.empty_cache()
    run = ttrain.train("smollm-360m", **static,
                       telemetry_jsonl=path("static.jsonl"),
                       chrome_trace=path("static.json"))
    hist = run["history"]
    names = check_obs_files(tobs, path("static.jsonl"), path("static.json"),
                            static["epochs"])
    del run
    torch.cuda.empty_cache()
    emit("obs_static", nvidia_smi=smi, epoch_s_untraced=plain_hist["epoch_s"],
         epoch_s_traced=hist["epoch_s"], span_names=sorted(names),
         launches=ops.launch_counts())
    assert same_records(hist, plain_hist), (hist, plain_hist)
    assert names == {"epoch"}, names
    shutil.rmtree(directory)


def rmsnorm_sweep(torch, g) -> dict:
    """Kernel 2 at each of RMSNORM_SHAPES: forward and backward through
    ``ops.rmsnorm`` under autograd against the plain versions (f32: 1e-5
    forward, 1e-4 backward, of the largest value; bf16: the forward within
    one bf16 step, the backward within 2^-8 of the largest value, since
    dx cancels), then kernel, plain version and ``F.rms_norm`` timed in
    turns (forward; backward through autograd), the kernel call's host and
    device time, and the bound.  Returns each shape's numbers by (rows, d,
    dtype)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn
    rms_norm = torch.nn.functional.rms_norm
    dev = torch.device("cuda")
    # the host cost of reading the current stream: the public call, and the
    # binding the kernel wrappers call (the same stream, no Stream object)
    stream_us = {
        "current_stream": host_us(torch, lambda: torch.cuda.current_stream(
            dev).cuda_stream, 10000),
        "raw": host_us(torch, lambda: torch._C._cuda_getCurrentRawStream(
            dev.index or 0), 10000)}
    stats = {}
    for rows, d, dtype, where, path_launches in RMSNORM_SHAPES:
        dt = getattr(torch, dtype)
        x = torch.randn((rows, d), device=dev, generator=g).to(dt)
        s = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        gy = torch.randn((rows, d), device=dev, generator=g).to(dt)
        xg, sg = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
        before = ops.launch_counts()
        y = ops.rmsnorm(xg, sg)
        dx, ds = torch.autograd.grad(y, (xg, sg), gy)
        after = ops.launch_counts()
        assert after["rmsnorm_fwd"] == before["rmsnorm_fwd"] + 1
        assert after["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
        y_ref = ref.rmsnorm_ref(x, s)
        dx_ref, ds_ref = ref.rmsnorm_bwd_ref(x, s, gy)
        torch.cuda.synchronize()
        errs = {k: rel_err(torch, a, b) for k, (a, b) in {
            "y": (y.detach(), y_ref), "dx": (dx, dx_ref),
            "dscale": (ds, ds_ref)}.items()}
        if dtype == "float32":
            limits = {"y": 1e-5, "dx": 1e-4, "dscale": 1e-4}
            y_steps = None
            ok = all(errs[k][1] < lim for k, lim in limits.items())
        else:
            limits = {"y": "1 bf16 step", "dx": 2 ** -8, "dscale": 2 ** -8}
            y_steps = bf16_steps(torch, y.detach(), y_ref)
            ok = y_steps <= 1 and all(errs[k][1] <= 2 ** -8
                                      for k in ("dx", "dscale"))
        assert y.dtype == dx.dtype == dt and ds.dtype == dt
        _, rstd = rn.rmsnorm_fwd_cuda(x, s, 1e-6)
        y_plain = ref.rmsnorm_ref(xg, sg)
        y_lib = rms_norm(xg, (d,), sg, 1e-6)
        reps = 200 if rows * d <= 1 << 20 else 50
        # the forward as training calls it (rstd kept for the backward) and
        # as serving does (no rstd); the library call without autograd, and
        # both sides under autograd (a graph node that saves what the
        # backward needs) as the training forward runs them
        fwd = alternate(torch, {
            "kernel": lambda: rn.rmsnorm_fwd_cuda(x, s, 1e-6),
            "kernel_no_rstd": lambda: rn.rmsnorm_fwd_cuda(
                x, s, 1e-6, need_rstd=False),
            "kernel_autograd": lambda: rn.RMSNormFn.apply(xg, sg, 1e-6),
            "plain": lambda: ref.rmsnorm_ref(x, s),
            "library": lambda: rms_norm(x, (d,), s, 1e-6),
            "library_autograd": lambda: rms_norm(xg, (d,), sg, 1e-6)}, reps)
        bwd = alternate(torch, {
            "kernel": lambda: rn.rmsnorm_bwd_cuda(x, s, rstd, gy),
            "plain": lambda: torch.autograd.grad(y_plain, (xg, sg), gy,
                                                 retain_graph=True),
            "library": lambda: torch.autograd.grad(y_lib, (xg, sg), gy,
                                                   retain_graph=True)}, reps)
        es = x.element_size()
        fb, fby = bound_ms(2 * rows * d * es + d * es + rows * 4,
                           4 * rows * d)
        bb, bby = bound_ms(3 * rows * d * es + 2 * d * es + rows * 4,
                           10 * rows * d)
        st = dict(
            fwd=fwd, bwd=bwd, fwd_err=errs["y"][0],
            bwd_err=max(errs["dx"][0], errs["dscale"][0]), fwd_bound=fb,
            fwd_by=fby, bwd_bound=bb, bwd_by=bby,
            fwd_host_us=host_us(torch, fwd_kernel := (
                lambda: rn.rmsnorm_fwd_cuda(x, s, 1e-6)), 200),
            bwd_host_us=host_us(torch, bwd_kernel := (
                lambda: rn.rmsnorm_bwd_cuda(x, s, rstd, gy)), 200),
            fwd_device_us=device_us(torch, fwd_kernel),
            bwd_device_us=device_us(torch, bwd_kernel))
        stats[(rows, d, dtype)] = st
        emit("rmsnorm_check", rows=rows, d=d, dtype=dtype, path=where,
             path_launches=path_launches,
             max_abs_err={k: e[0] for k, e in errs.items()},
             max_rel_err={k: e[1] for k, e in errs.items()},
             y_bf16_steps=y_steps, limits=limits, ok=ok,
             fwd_ms=fwd, bwd_ms=bwd, fwd_bound_ms=fb, fwd_bound_by=fby,
             bwd_bound_ms=bb, bwd_bound_by=bby,
             fwd_bound_share=fb / fwd["kernel"],
             bwd_bound_share=bb / bwd["kernel"],
             fwd_vs_library=fwd["kernel"] / fwd["library"],
             fwd_no_rstd_vs_library=fwd["kernel_no_rstd"] / fwd["library"],
             fwd_autograd_vs_library=(fwd["kernel_autograd"]
                                      / fwd["library_autograd"]),
             bwd_vs_library=bwd["kernel"] / bwd["library"],
             fwd_host_us=st["fwd_host_us"], bwd_host_us=st["bwd_host_us"],
             fwd_device_us=st["fwd_device_us"],
             bwd_device_us=st["bwd_device_us"],
             current_stream_us=stream_us)
        assert ok, (rows, d, dtype, errs, y_steps)
    rmsnorm_host_path(torch, stream_us)
    return stats


def rmsnorm_host_path(torch, stream_us: dict) -> None:
    """Where a kernel-2 forward call's host time goes, at 256 x 960 f32:
    each step of the wrapper alone, the whole wrapper, the serving call
    through ``ops.rmsnorm``, and ``F.rms_norm`` (microseconds a call,
    enqueue only)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    x = torch.randn((256, 960), device=dev)
    s = torch.ones(960, device=dev)
    y, rstd = rn.rmsnorm_fwd_cuda(x, s, 1e-6)
    ptrs = (x.data_ptr(), s.data_ptr(), y.data_ptr(), rstd.data_ptr())
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    x3 = x.view(2, 128, 960)
    steps = {
        "checks": lambda: rn._check(x, s),
        "alloc_y": lambda: torch.empty_like(
            x, memory_format=torch.contiguous_format),
        "alloc_rstd": lambda: x.new_empty((256,), dtype=torch.float32),
        "ctypes_launch": lambda: rn._fwd(ptrs[0], 960, ptrs[1], ptrs[2],
                                         ptrs[3], 256, 960, 1e-6, 0, 1,
                                         stream),
        "wrapper": lambda: rn.rmsnorm_fwd_cuda(x, s, 1e-6),
        "wrapper_no_rstd": lambda: rn.rmsnorm_fwd_cuda(x, s, 1e-6,
                                                       need_rstd=False),
        "library": lambda: torch.nn.functional.rms_norm(x, (960,), s, 1e-6)}
    out = {k: host_us(torch, fn, 2000) for k, fn in steps.items()}
    with torch.no_grad():
        out["ops_rmsnorm_serving"] = host_us(
            torch, lambda: ops.rmsnorm(x3, s), 2000)
    emit("rmsnorm_host_path", rows=256, d=960, host_us=out,
         stream_us=stream_us)


# ---------------------------------------------------------------------------
# the multi-process wire: shard_map over torch.distributed, one rank
# a server, all four ranks on the one card through gloo
# ---------------------------------------------------------------------------

SHARD_M = 4
# the row forms: ops entry point -> (CUDA source, the TPU kernel replaced)
ROW_KERNELS = {
    "consensus_mix_rows": ("src/repro_torch/kernels/csrc/consensus_mix.cu",
                           "src/repro/kernels/consensus_mix.py:71"),
    "bucketed_gossip_round_rows": (
        "src/repro_torch/kernels/csrc/quantized_wire.cu",
        "src/repro/kernels/consensus_mix.py:440"),
    "bucketed_gossip_round_pipelined_rows": (
        "src/repro_torch/kernels/csrc/quantized_wire.cu",
        "src/repro/kernels/consensus_mix.py:577"),
}
# the row forms' main shape: the SmolLM-360M wire bucket (M = 4)
ROW_D = 364_904_448
# the world's phases: (name, trainer, trainer keywords); every one full
# width and full depth, one epoch, through the trainers with
# consensus_backend="shard_map"
SHARD_PHASES = [
    ("wire", "train", dict(WIRE_TRAIN, epochs=1)),
    ("wire_stale", "train", dict(WIRE_TRAIN, epochs=1, staleness=1)),
    ("plain", "train", dict(TRAIN, epochs=1)),
    ("dynamic", "train_dynamic", dict(
        DYN_TRAIN, faults="", epochs=1, compression="int8",
        wire="physical", error_feedback=True)),
    ("push_sum", "train", dict(PS_TRAIN, epochs=1, compression="int8",
                               wire="physical", error_feedback=True)),
    # inlier_shift across ranks: seed 1 marks server 0 (one attacker of
    # four), plain gossip over the dynamic graph
    ("inlier", "train_dynamic", dict(
        DYN_TRAIN, faults="", epochs=1, byzantine="inlier_shift:0.25:0.9",
        seed=1)),
]
#: each rank's share of the card: four ranks of ~14 GB at their peak and
#: this process's context fit in 80 GB only if no rank keeps another's
#: share in its allocator's cache
SHARD_MEMORY_FRACTION = 0.23
SHARD_SAMPLE = 4096         # elements a leaf of the plain phase's samples
SHARD_PLAIN_TOL = 1e-6      # of the leaf's largest |w|: one f32 rounding
SHARD_TIMEOUT_S = 900


def rows_fingerprint(torch, leaves, sample: bool = False) -> list:
    """Per (row, client) of a client tree, per leaf: the int64 sum of the
    int32 bit patterns and a position-weighted one (two exact sums that
    any differing bit moves), and with ``sample`` a strided sample of the
    values."""
    out = []
    for i in range(leaves[0].shape[0]):
        for j in range(leaves[0].shape[1]):
            row = []
            for leaf in leaves:
                bits = leaf[i, j].reshape(-1).view(torch.int32).to(
                    torch.int64)
                pos = torch.arange(bits.numel(), device=bits.device) \
                    .remainder_(1021).add_(1)
                fp = [int(bits.sum()), int((bits * pos).sum())]
                if sample:
                    flat = leaf[i, j].reshape(-1)
                    step = max(1, flat.numel() // SHARD_SAMPLE)
                    fp.append(flat[::step][:SHARD_SAMPLE].float().cpu()
                              .tolist())
                row.append(fp)
                del bits, pos
            out.append(row)
    return out


def _run_fingerprints(torch, run, tree_leaves, sample=False) -> dict:
    st = run["state"]
    leaves = tree_leaves(st.client_params)
    return {"clients": rows_fingerprint(torch, leaves, sample),
            # float64 sum of the server models' squares (client 0 of each
            # row, after the broadcast): the disagreement formula's scale
            "sumsq": sum(float(x[:, 0].double().square().sum())
                         for x in leaves),
            "ef": (None if st.ef_residual is None else rows_fingerprint(
                torch, [x[:, None] for x in tree_leaves(st.ef_residual)])),
            "history": {k: v for k, v in run["history"].items()
                        if k not in ("epoch_s", "alloc_gb")}}


# the sharded server row: a (server, client, replica, model) mesh of the
# launch layer, _BIG_SP's structure (M = 2, N = 1, R = 8, TP = 16) at four
# ranks; full-width SmolLM-360M server rows cut by fl_server_specs (FSDP
# over "replica", tp_axis None as SmolLM's plan has it); one T_S period of
# each run; "wire_whole" is the timing yardstick: the same M = 2
# federation and period with one whole row a rank (the mesh (2, 1, 1, 1)),
# run on the bare server group of the ranks at replica 0 while the others
# wait
AXES_SHAPE = (2, 1, 2, 1)
AXES_WHOLE = (2, 1, 1, 1)
AXES_A = [[0.75, 0.25], [0.25, 0.75]]
AXES_T = 5
AXES_KEY = 7
AXES_CODEC = "int8"
AXES_DEVICE = "cuda"
# run -> (mesh shape, staleness; None: the plain program)
AXES_RUNS = {"plain": (AXES_SHAPE, None), "wire": (AXES_SHAPE, 0),
             "wire_stale": (AXES_SHAPE, 1), "wire_whole": (AXES_WHOLE, 0)}
# the dry run's pairs, one of each program (prefill is qwen3's)
DRYRUN_PAIRS = [("smollm-360m", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                ("mamba2-780m", "long_500k")]


def axes_matrix(m: int) -> np.ndarray:
    """The period's mixing matrix, AXES_A (M = 2)."""
    assert m == 2, m
    return np.asarray(AXES_A, np.float32)


def axes_server_row(torch, ttf, cfg, i: int) -> list:
    """Server i's row of full SmolLM-360M (its leaves in tree order): the
    seed-0 init plus 0.01 N(0, 1) drawn leaf by leaf from a generator
    seeded 1 + i (on the card, the same values in every process)."""
    dev = torch.device(AXES_DEVICE)
    from repro_torch.tree import tree_leaves
    base = tree_leaves(ttf.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, torch.float32,
        device=dev))
    g = torch.Generator(device=dev).manual_seed(1 + i)
    for leaf in base:
        leaf.add_(torch.randn(leaf.shape, device=dev, generator=g),
                  alpha=0.01)
    return base


def axes_layout(torch, ttf, cfg, shape, rank=None):
    """``(mesh, server_abs, specs)`` of a run: the FL rank mesh of
    ``shape``, the (M, *w) server tree on meta, its fl_server_specs."""
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as shd
    from repro_torch.tree import tree_map
    mesh = lm.fl_rank_mesh(lm.FLMeshSpec(*shape), rank=rank)
    meta = ttf.init_params(torch.Generator(), cfg, torch.float32,
                           device="meta")
    server_abs = tree_map(lambda x: torch.empty(
        (shape[0],) + tuple(x.shape), device="meta"), meta)
    return mesh, server_abs, shd.fl_server_specs(server_abs, mesh,
                                                 tp_axis=None)


def axes_pieces(torch, ttf, cfg, shape, rank: int, row=None) -> list:
    """Rank ``rank``'s pieces (leaves ``(1, *local)``) of its server's row
    on the mesh of ``shape``."""
    from repro_torch.launch import sharding as shd
    from repro_torch.tree import tree_leaves
    mesh, server_abs, specs = axes_layout(torch, ttf, cfg, shape, rank)
    i = mesh.coords(rank)["server"]
    row = axes_server_row(torch, ttf, cfg, i) if row is None else row
    out = []
    for leaf, full, spec in zip(row, tree_leaves(server_abs),
                                tree_leaves(specs)):
        cut = shd.shard_slices(tuple(full.shape), spec, mesh, rank)
        out.append(leaf[cut[1:]][None].contiguous())
    return out


def axes_backend(torch, cns, m: int, t_s: int, staleness, mesh=None,
                 specs=None, kron: int = 0):
    """The run's backend: on ``mesh`` the shard_map backend over ``specs``
    (``mesh`` a bare group and ``specs`` None: whole rows), or (``kron`` =
    S) the one-process backend on the (M * S)-row problem under A ⊗ I_S;
    the int8 physical wire with error feedback unless ``staleness`` is
    None."""
    from repro_torch.comm import compressors as cp
    a = axes_matrix(m)
    if kron:
        inner = cns.GossipBackend(np.kron(a, np.eye(kron, dtype=np.float32)),
                                  t_s, staleness=staleness or 0)
    else:
        from repro_torch.launch import sharding as shd
        from repro_torch.tree import tree_leaves
        counted = (None if specs is None else
                   [shd.first_copy(x, mesh) for x in tree_leaves(specs)])
        inner = cns.ShardMapBackend(mesh, a, t_s, specs, counted=counted,
                                    staleness=staleness or 0)
    if staleness is None:
        return inner
    return cns.CompressedBackend(inner, cp.make_compressor(AXES_CODEC),
                                 error_feedback=True, wire="physical",
                                 wire_block=16_777_216)


def axes_period(torch, cns, backend, staleness, tree):
    """One period: ``(mixed, residual)`` (residual None on the plain
    program)."""
    from repro_torch.comm import prng
    from repro_torch.tree import tree_map
    if staleness is None:
        return backend.mix(tree), None
    return backend.mix_compressed(
        tree, residual=tree_map(torch.zeros_like, tree),
        key=prng.key(AXES_KEY))


def axes_rank(torch, cns, ops, ttf, cfg, rank: int) -> dict:
    """The world's ``shard_map_axes`` runs on this rank: per run, its
    pieces' and residual's fingerprints, launches, collectives, the
    period's seconds, the disagreement over the world and the peak.  A
    rank at replica 1 sits ``wire_whole`` out (no entry)."""
    import torch.distributed as dist
    out = {}
    # the mesh's server subgroups are made once, on every rank
    mesh, _, specs = axes_layout(torch, ttf, cfg, AXES_SHAPE)
    pieces = axes_pieces(torch, ttf, cfg, AXES_SHAPE, rank)
    for name, (shape, stale) in AXES_RUNS.items():
        start = None            # the group that starts the period: all
        if shape == AXES_WHOLE:
            dist.barrier()
            if mesh.coords()["replica"]:
                continue
            # the same federation one whole row a rank: the server group
            # of the replica-0 ranks, taken as a bare group
            start = mesh.group("server")
            pieces = [x[None] for x in axes_server_row(
                torch, ttf, cfg, mesh.coords()["server"])]
            backend = axes_backend(torch, cns, shape[0], AXES_T, stale,
                                   start)
        else:
            backend = axes_backend(torch, cns, shape[0], AXES_T, stale,
                                   mesh, specs)
        tree = list(pieces)
        inner = getattr(backend, "inner", backend)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        cns.reset_collective_counts()
        torch.cuda.synchronize()
        dist.barrier(group=start)
        t0 = time.perf_counter()
        mixed, res = axes_period(torch, cns, backend, stale, tree)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = cns.collective_counts()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        k8 = ops.wire_pipelined_instance_counts()
        dis = float(inner.disagreement(mixed))
        out[name] = {
            "rows": rows_fingerprint(torch, [x[:, None] for x in mixed]),
            "ef": (None if res is None else rows_fingerprint(
                torch, [x[:, None] for x in res])),
            "period_s": seconds, "launches": launches,
            "kernel8_instances": k8,
            "collectives": counts, "disagreement": dis,
            "server_group": dist.get_process_group_ranks(inner.group),
            "piece_elems": sum(x.numel() for x in pieces),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del mixed, res, tree, backend, inner
    del pieces
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def axes_emulation(torch, cns, ttf, cfg) -> dict:
    """The one-process periods on the (M * S)-row problem of every piece
    under A ⊗ I_S (rank r's pieces as row r), each row's fingerprints,
    and the seconds of each period (square kernels 1, 6, 7, 8)."""
    want = {}
    m, s = AXES_SHAPE[0], AXES_SHAPE[2]
    rows = [[] for _ in range(m * s)]
    for i in range(m):
        row = axes_server_row(torch, ttf, cfg, i)
        for k in range(s):
            rows[i * s + k] = axes_pieces(torch, ttf, cfg, AXES_SHAPE,
                                          i * s + k, row)
        del row
    emul = [torch.cat(parts) for parts in zip(*rows)]
    del rows
    torch.cuda.empty_cache()
    for name, (shape, stale) in AXES_RUNS.items():
        if shape != AXES_SHAPE:
            continue
        backend = axes_backend(torch, cns, m, AXES_T, stale, kron=s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mixed, res = axes_period(torch, cns, backend, stale, list(emul))
        torch.cuda.synchronize()
        want[name] = {
            "rows": rows_fingerprint(torch, [x[:, None] for x in mixed]),
            "ef": (None if res is None else rows_fingerprint(
                torch, [x[:, None] for x in res])),
            "period_s": time.perf_counter() - t0}
        del mixed, res, backend
        torch.cuda.empty_cache()
    want["elems"] = sum(x[0].numel() for x in emul)
    del emul
    torch.cuda.empty_cache()
    return want


def shard_rank_main(rank: int, rdv: str, phases, q) -> None:
    """One rank of the world: server ``rank`` on ``cuda:0``.  Runs every
    phase through the trainers and puts its readings on ``q``; a failure
    is put there too and raised."""
    import datetime
    import os
    import traceback

    # fewer cached fragments in each rank's allocator (set before CUDA)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core import consensus as cns
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.tree import tree_leaves
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        torch.cuda.set_per_process_memory_fraction(SHARD_MEMORY_FRACTION, 0)
        ttrain.set_full_f32()
        dist.init_process_group("gloo", init_method="file://" + rdv,
                                world_size=SHARD_M, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        for name, trainer, kw in phases:
            if trainer == "axes":
                from repro_torch.configs import get_arch
                from repro_torch.models import transformer as ttf
                t0 = time.perf_counter()
                out[name] = axes_rank(torch, cns, ops, ttf,
                                      get_arch("smollm-360m"), rank)
                out[name]["wall_s"] = time.perf_counter() - t0
                continue
            ops.reset_launch_counts()
            cns.reset_collective_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            t0 = time.perf_counter()
            fn = ttrain.train if trainer == "train" else ttrain.train_dynamic
            run = fn("smollm-360m", **kw, consensus_backend="shard_map",
                     log=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            leaves = tree_leaves(run["state"].client_params)
            out[name] = {
                **_run_fingerprints(torch, run, tree_leaves,
                                    sample=name == "plain"),
                "rows": list(leaves[0].shape[:2]),
                "leaf_shapes": [list(x.shape[2:]) for x in leaves],
                "epoch_s": run["history"]["epoch_s"], "wall_s": wall,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k: v for k, v in ops.launch_counts().items()
                             if v},
                "kernel8_instances": ops.wire_pipelined_instance_counts(),
                "collectives": cns.collective_counts()}
            del run, leaves
        q.put(out)
    except BaseException:
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def shard_world(torch, phases) -> list:
    """Spawn the world of SHARD_M gloo ranks (the parent has initialized
    CUDA, so ``spawn``), wait for every rank's readings, and stop every
    process whatever happens; a rank's failure raises here."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    base = pathlib.Path(__file__).resolve().parent / "build"
    base.mkdir(exist_ok=True)
    rdv = pathlib.Path(tempfile.mkdtemp(dir=base)) / "rdv"
    procs = [ctx.Process(target=shard_rank_main,
                         args=(r, str(rdv), phases, q))
             for r in range(SHARD_M)]
    import queue
    got = []
    deadline = time.perf_counter() + SHARD_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(got) < SHARD_M:
            try:
                item = q.get(timeout=5)
            except queue.Empty:
                # a rank that died without reporting (a native abort) ends
                # the world at once, as does the deadline
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise RuntimeError(f"the world stopped: exit codes "
                                       f"{[p.exitcode for p in procs]}")
                continue
            if "error" in item:
                raise RuntimeError(f"rank {item['rank']} failed:\n"
                                   f"{item['error']}")
            got.append(item)
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * SHARD_M:
        raise RuntimeError(f"ranks exited with {codes}")
    return sorted(got, key=lambda r: r["rank"])


def shard_kernel_rows(torch, ops, ref, tp, g) -> dict:
    """``shard_map_rows``: the row forms of kernels 1, 7 and 8 at the main
    shape, each row r bitwise row r of the square call, held to its plain
    version (kernel 1 over all columns within 1e-5; kernels 7 and 8
    bitwise on a slab of whole chunks), timed against the plain version,
    its byte bound and, for kernel 1, ``torch.matmul`` of the same row."""
    dev = torch.device("cuda")
    m, d, chunk = SHARD_M, ROW_D, WIRE_CHUNK
    nc = d // chunk
    a = torch.tensor(tp.metropolis_weights(tp.ring_graph(m)),
                     dtype=torch.float32, device=dev)
    rows = {}
    # kernel 1: W (M, D) f32, A's row r
    w = torch.randn((m, d), device=dev, generator=g)
    square = ops.consensus_mix(a, w)
    out = torch.empty((1, d), device=dev)
    bitwise = []
    for r in range(m):
        a_r = a[r:r + 1].contiguous()
        bitwise.append(bool(torch.equal(ops.consensus_mix_rows(
            a_r, w, out=out), square[r:r + 1])))
    del square
    err, rel = rel_err(torch, out, ref.consensus_mix_ref(a_r, w))
    t = alternate(torch, {
        "kernel": lambda: ops.consensus_mix_rows(a_r, w, out=out),
        "plain": lambda: ref.consensus_mix_ref(a_r, w),
        "library": lambda: torch.matmul(a_r, w)}, reps=10)
    bnd, by = bound_ms(m * d * 4 + d * 4 + m * 4, 2 * m * d)
    rows["consensus_mix_rows"] = dict(
        bitwise_rows=bitwise, max_abs_err=err, max_rel_err=rel,
        ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
        bound_ms=bnd, bound_by=by)
    emit("shard_map_rows", kernel="consensus_mix_rows", m=m, d=d,
         **rows["consensus_mix_rows"])
    assert all(bitwise) and rel < 1e-5, rows["consensus_mix_rows"]
    del w, out
    torch.cuda.empty_cache()
    # kernels 7 and 8: the gathered (M, D) codes and scales, the own rows
    codes = torch.randint(-127, 128, (m, d), device=dev, generator=g,
                          dtype=torch.int8)
    scales = torch.rand((m, nc), device=dev, generator=g) * 0.02 + 1e-3
    own = {k: torch.randn((m, d), device=dev, generator=g) * s
           for k, s in (("w", 1.0), ("ref", 0.5), ("acc", 0.5))}
    own["u"] = torch.rand((m, d), device=dev, generator=g)
    lo, hi = 1 << 24, (1 << 24) + WIRE_SLAB      # a slab of whole chunks
    for name in ("bucketed_gossip_round_rows",
                 "bucketed_gossip_round_pipelined_rows"):
        stale = "pipelined" in name
        st = [codes.clone(), scales.clone(), own["ref"].clone(),
              own["acc"].clone()]
        if stale:
            sq = ops.bucketed_gossip_round_pipelined(
                a, st[0], st[1], own["w"], st[2], st[3], own["u"])
        else:
            sq = ops.bucketed_gossip_round(a, *st, own["u"])
        sq = [x[1:2].clone() for x in sq]
        del st
        r = 1
        a_r = a[r:r + 1].contiguous()
        c_out = torch.empty((1, d), dtype=torch.int8, device=dev)
        s_out = torch.empty((1, nc), device=dev)

        def call(ref_r, acc_r):
            if stale:
                return ops.bucketed_gossip_round_pipelined_rows(
                    a_r, codes, scales, own["w"][r:r + 1], ref_r, acc_r,
                    own["u"][r:r + 1], c_out, s_out)
            return ops.bucketed_gossip_round_rows(
                a_r, codes, scales, ref_r, acc_r, own["u"][r:r + 1], c_out,
                s_out, row0=r)

        got = call(own["ref"][r:r + 1].clone(), own["acc"][r:r + 1].clone())
        bit_square = all(bool(torch.equal(x, y)) for x, y in zip(got, sq))
        # the plain version on a slab of whole chunks (chunks are
        # independent), the gathered slab of every row
        cs = slice(lo // chunk, hi // chunk)
        slab = dict(codes=codes[:, lo:hi], scales=scales[:, cs],
                    ref=own["ref"][r:r + 1, lo:hi],
                    acc=own["acc"][r:r + 1, lo:hi],
                    u=own["u"][r:r + 1, lo:hi], w=own["w"][r:r + 1, lo:hi])
        if stale:
            want = ref.bucketed_gossip_round_pipelined_ref(
                a_r, slab["codes"], slab["scales"], slab["w"], slab["ref"],
                slab["acc"], slab["u"])
        else:
            want = ref.bucketed_gossip_round_rows_ref(
                a_r, slab["codes"], slab["scales"], slab["ref"],
                slab["acc"], slab["u"], row0=r)
        got_slab = [got[0][:, lo:hi], got[1][:, lo:hi], got[2][:, lo:hi],
                    got[3][:, cs]]
        bit_plain = all(bool(torch.equal(x, y))
                        for x, y in zip(got_slab, want))
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got_slab, want))
        ref_r, acc_r = own["ref"][r:r + 1].clone(), own["acc"][r:r + 1].clone()
        if stale:
            def plain_slab():
                return ref.bucketed_gossip_round_pipelined_ref(
                    a_r, slab["codes"], slab["scales"], slab["w"],
                    slab["ref"], slab["acc"], slab["u"])
        else:
            def plain_slab():
                return ref.bucketed_gossip_round_rows_ref(
                    a_r, slab["codes"], slab["scales"], slab["ref"],
                    slab["acc"], slab["u"], row0=r)
        before = ops.wire_pipelined_instance_counts()
        ms = cuda_ms(torch, lambda: call(ref_r, acc_r), reps=10)
        instances = instance_delta(before,
                                   ops.wire_pipelined_instance_counts())
        plain_ms = cuda_ms(torch, plain_slab, reps=3, warmup=1)
        # each input read once, each output written once: the gathered
        # codes and scales of every row, the own ref, acc, u (and w), the
        # own ref, acc, codes and scales written, A's row
        own_in = 4 * (3 + (1 if stale else 0))
        n_bytes = (m * d + m * nc * 4 + d * own_in + d * (4 + 4 + 1)
                   + nc * 4 + m * 4)
        bnd, by = bound_ms(n_bytes, 2 * m * d)
        rows[name] = dict(bitwise_square_row=bit_square,
                          bitwise_plain_slab=bit_plain, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms,
                          plain_cols=hi - lo, bound_ms=bnd, bound_by=by,
                          library_ms=None)
        emit("shard_map_rows", kernel=name, m=m, d=d, row=r,
             kernel8_instances=instances, **rows[name])
        assert bit_square and bit_plain, rows[name]
        assert set(instances) == ({KERNEL8_ROW} if stale else set()), \
            instances
        del got, sq, ref_r, acc_r, c_out, s_out
    del codes, scales, own
    torch.cuda.empty_cache()
    return rows


def _rank_per_round(ranks, name: str, t_server: int, epochs: int) -> list:
    """Each rank's all_gather calls and bytes a gossip round of a phase."""
    out = []
    for r in ranks:
        c = r[name]["collectives"]
        rounds = t_server * epochs
        out.append({
            "rank": r["rank"],
            "calls_per_round": {k: v / rounds for k, v in c["calls"].items()
                                if k.startswith("all_gather")},
            "bytes_per_round": {k: v / rounds for k, v in c["bytes"].items()
                                if k.startswith("all_gather")},
            "collective_s": c["seconds"], "staging_s": c["staging_s"],
            "op_seconds": c["op_seconds"],
            "epoch_s": r[name]["epoch_s"], "wall_s": r[name]["wall_s"],
            "peak_gb": r[name]["peak_gb"], "launches": r[name]["launches"]})
    return out


def _samples_close(got_rows, want_rows) -> float:
    """The largest difference between two runs' value samples, over every
    (row, client, leaf), relative to that leaf's largest sampled |w|."""
    worst = 0.0
    for g_row, w_row in zip(got_rows, want_rows):
        for g_leaf, w_leaf in zip(g_row, w_row):
            g_, w_ = np.asarray(g_leaf[2]), np.asarray(w_leaf[2])
            scale = max(float(np.abs(w_).max()), 1e-30)
            worst = max(worst, float(np.abs(g_ - w_).max()) / scale)
    return worst


def shard_map_phases(torch, ttrain, ops, ref, tp, smi: str, g) -> dict:
    """The multi-process wire on the card: the row forms
    (``shard_map_rows``), then one-process reference epochs in this process,
    then one world of four gloo ranks running ``shard_map_wire`` (staleness
    0 and 1), ``shard_map_plain``, ``shard_map_dynamic`` (and push-sum),
    ``shard_map_inlier`` and ``shard_map_axes``, each rank's rows held to
    the one-process run's; then ``shard_map_cli`` through
    ``torch.distributed.run`` with the dry run's process beside it (the
    last timed phase is over) and the ``dryrun`` lines.  Returns the row
    forms' kernel rows with their launches."""
    from repro_torch.comm import compressors as cp
    from repro_torch.comm.accounting import \
        tree_bucketed_wire_bytes_per_server
    from repro_torch.tree import tree_leaves
    rows = shard_kernel_rows(torch, ops, ref, tp, g)

    # ---- the one-process reference epochs, each freed before the next ----
    want = {}
    for name, trainer, kw in SHARD_PHASES:
        fn = ttrain.train if trainer == "train" else ttrain.train_dynamic
        t0 = time.perf_counter()
        run = fn("smollm-360m", **kw, log=False)
        torch.cuda.synchronize()
        want[name] = _run_fingerprints(torch, run, tree_leaves,
                                       sample=name == "plain")
        want[name]["epoch_s"] = run["history"]["epoch_s"]
        want[name]["wall_s"] = time.perf_counter() - t0
        n_params = sum(t[0, 0].numel()
                       for t in tree_leaves(run["state"].client_params))
        del run
        torch.cuda.empty_cache()
    assert n_params == SMOLLM_PARAMS, n_params
    emit("shard_map_reference", epoch_s={k: v["epoch_s"]
                                         for k, v in want.items()},
         wall_s={k: v["wall_s"] for k, v in want.items()})

    # ---- the sharded row's one-process emulation (A ⊗ I_S on every
    # piece) and the dry run's collective record of each run ----
    from repro_torch.configs import get_arch
    from repro_torch.core import consensus as cns
    from repro_torch.models import transformer as ttf
    cfg = get_arch("smollm-360m")
    want_axes = axes_emulation(torch, cns, ttf, cfg)
    dry_axes = axes_dry_records(torch, ttf, cfg)

    # ---- the world: four ranks, one server each, on the one card (this
    # process keeps only its context and what main() still holds) ----
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    emit("shard_map_parent", alloc_gb=torch.cuda.memory_allocated() / 1e9,
         reserved_gb=torch.cuda.memory_reserved() / 1e9)
    t0 = time.perf_counter()
    ranks = shard_world(torch, SHARD_PHASES + [("axes", "axes", {})])
    world_s = time.perf_counter() - t0
    server_abs = [torch.empty((SHARD_M,) + tuple(s), device="meta")
                  for s in ranks[0]["wire"]["leaf_shapes"]]
    codec = cp.make_compressor(WIRE_TRAIN["compression"])
    for name, trainer, kw in SHARD_PHASES:
        # the assembled rows: rank r's (1, N) clients are rows r of the
        # one-process run, leaf by leaf
        got_clients = [c for r in ranks for c in r[name]["clients"]]
        n = kw["clients"]
        assert all(r[name]["rows"] == [1, n] for r in ranks), name
        epochs = kw["epochs"]
        per_round = _rank_per_round(ranks, name, kw["t_server"], epochs)
        sumsq = sum(r[name]["sumsq"] for r in ranks)
        match = [history_match(r[name]["history"], want[name]["history"],
                               want[name]["sumsq"]) for r in ranks]
        same_hist = all(m_[0] for m_ in match)
        dis_ratio = max(m_[1] for m_ in match)
        fields = dict(world_s=world_s, ranks=per_round,
                      one_process_epoch_s=want[name]["epoch_s"],
                      disagreement=ranks[0][name]["history"].get(
                          "disagreement"),
                      one_process_disagreement=want[name]["history"].get(
                          "disagreement"),
                      drift=ranks[0][name]["history"].get("drift"),
                      one_process_drift=want[name]["history"].get("drift"),
                      diagnostics_over_limit=dis_ratio, sumsq=sumsq,
                      one_process_sumsq=want[name]["sumsq"],
                      wire_mb=ranks[0][name]["history"].get("wire_mb"),
                      one_process_wire_mb=want[name]["history"].get(
                          "wire_mb"), nvidia_smi=smi)
        if name == "plain":
            bitwise = [[fp[:2] for fp in row] for row in got_clients] == [
                [fp[:2] for fp in row] for row in want[name]["clients"]]
            worst = _samples_close(got_clients, want[name]["clients"])
            emit("shard_map_plain", bitwise=bitwise,
                 sample_rel_err=worst, tolerance=SHARD_PLAIN_TOL,
                 same_history=same_hist, **fields)
            assert worst <= SHARD_PLAIN_TOL, worst
        else:
            bitwise = got_clients == want[name]["clients"]
            ef_same = ([e for r in ranks for e in (r[name]["ef"] or [])]
                       == (want[name]["ef"] or []))
            phase = {"wire": "shard_map_wire",
                     "wire_stale": "shard_map_wire",
                     "dynamic": "shard_map_dynamic",
                     "push_sum": "shard_map_dynamic",
                     "inlier": "shard_map_inlier"}[name]
            k8 = [r[name]["kernel8_instances"] for r in ranks]
            attack = {}
            if name == "inlier":
                # the attack ran: the honest envelope's two max-reductions
                # a leaf an epoch on every rank, an attacker that epoch
                attack = dict(
                    inlier_shift_reductions=[
                        r[name]["collectives"]["sites"].get(
                            "inlier_shift", 0) for r in ranks],
                    expected_reductions=2 * len(ranks[0][name][
                        "leaf_shapes"]) * epochs,
                    byzantine=ranks[0][name]["history"]["byzantine"],
                    one_process_byzantine=want[name]["history"][
                        "byzantine"])
            emit(phase, run=name, staleness=kw.get("staleness", 0),
                 bitwise=bitwise, ef_bitwise=ef_same,
                 same_history=same_hist, kernel8_instances=k8, **attack,
                 **fields)
            assert bitwise and ef_same, name
            if attack:
                assert attack["inlier_shift_reductions"] == [
                    attack["expected_reductions"]] * SHARD_M, attack
                assert min(attack["one_process_byzantine"]) > 0, attack
            # every rank's round on the resident row body, VEC = 4
            want_k8 = ({KERNEL8_ROW: kw["t_server"] * kw["epochs"]}
                       if kw.get("staleness") else {})
            assert all(x == want_k8 for x in k8), k8
        assert same_hist and dis_ratio <= 1.0, (name, match)
        if kw.get("wire") == "physical":
            row_bytes = tree_bucketed_wire_bytes_per_server(
                codec, server_abs, 16_777_216)
            for rank_row in per_round:
                assert rank_row["calls_per_round"] == {
                    "all_gather:int8": 1.0, "all_gather:float32": 1.0}, \
                    rank_row
                assert sum(rank_row["bytes_per_round"].values()) \
                    == row_bytes, rank_row
    axes_launches = axes_check(torch, ranks, want_axes, dry_axes, smi)
    launches = {k: sum(r[name]["launches"].get(k, 0) for r in ranks
                       for name in ("wire", "wire_stale", "plain"))
                + axes_launches.get(k, 0) for k in ROW_KERNELS}
    assert all(launches.values()), launches
    for k, row in rows.items():
        row["launches"] = launches[k]

    # ---- the CLI as users start it, at the smoke size; the dry run of one
    # pair of each program beside it, in a process of its own (no CUDA;
    # started after the last timed phase, so it shares the host's cores
    # with no measurement) ----
    dry = start_dryrun()
    shard_cli(torch, ttrain)
    finish_dryrun(dry, dry_axes)
    return rows


def axes_dry_records(torch, ttf, cfg) -> dict:
    """The dry run's collective record of each ``shard_map_axes`` run (meta
    pieces, ``DryGroup``s) on rank 0: what each rank of the world must
    send (every rank's pieces have rank 0's shapes)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import FLMeshSpec
    out = {}
    for name, (shape, stale) in AXES_RUNS.items():
        _, server_abs, _ = axes_layout(torch, ttf, cfg, shape, rank=0)
        kw = ({} if stale is None else dict(
            compression=AXES_CODEC, error_feedback=True, wire="physical",
            staleness=stale))
        out[name] = dryrun.consensus_record(
            server_abs, FLMeshSpec(*shape), axes_matrix(shape[0]), AXES_T,
            rank=0, tp_axis=None, **kw)
    return out


def axes_check(torch, ranks, want: dict, dry: dict, smi: str) -> dict:
    """``shard_map_axes``, one line a run: each rank's pieces (and EF
    residual) bitwise row r of the one-process A ⊗ I_S emulation, the
    launches, each rank's calls and bytes a round by op:dtype equal to the
    dry run's record, the period's seconds (and the emulation's), the
    server subgroups, the disagreement over the world, the peak per rank;
    ``wire_whole`` on ranks 0 and 2 only, beside the sharded wire's
    period.  Returns the row kernels' launches summed over the runs and
    ranks."""
    total: dict = {}
    whole_bytes = sum(ranks[0]["axes"]["wire_whole"]["collectives"][
        "bytes"].values()) / AXES_T
    for name, (shape, stale) in AXES_RUNS.items():
        # rank -> its readings (a rank at replica 1 sits wire_whole out)
        got = {r: x["axes"][name] for r, x in enumerate(ranks)
               if name in x["axes"]}
        per_rank = []
        for r, x in got.items():
            c = x["collectives"]
            per_rank.append({
                "rank": r, "period_s": x["period_s"],
                "calls_per_round": {k: v / AXES_T
                                    for k, v in c["calls"].items()},
                "bytes_per_round": {k: v / AXES_T
                                    for k, v in c["bytes"].items()},
                "collective_s": c["seconds"], "staging_s": c["staging_s"],
                "server_group": x["server_group"],
                "piece_elems": x["piece_elems"], "launches": x["launches"],
                "kernel8_instances": x["kernel8_instances"],
                "peak_gb": x["peak_gb"]})
            for k, v in x["launches"].items():
                total[k] = total.get(k, 0) + v
        same_dry = all(x["collectives"]["calls"] == dry[name]["calls"]
                       and x["collectives"]["bytes"] == dry[name]["bytes"]
                       for x in got.values())
        dis = [x["disagreement"] for x in got.values()]
        fields = dict(run=name, mesh=dict(zip(
            ("server", "client", "replica", "model"), shape)),
            staleness=stale, t_server=AXES_T, ranks=per_rank,
            disagreement=dis, same_as_dry_run=same_dry, nvidia_smi=smi)
        if stale is not None:
            fields["bytes_per_round_vs_whole_row"] = sum(
                per_rank[0]["bytes_per_round"].values()) / whole_bytes
        if shape == AXES_WHOLE:
            fields["sharded_wire_period_s"] = [
                r["axes"]["wire"]["period_s"] for r in ranks]
        if name in want:
            rows_same = all(x["rows"][0] == want[name]["rows"][r]
                            for r, x in got.items())
            ef_same = all(x["ef"] is None and want[name]["ef"] is None
                          or x["ef"][0] == want[name]["ef"][r]
                          for r, x in got.items())
            fields.update(bitwise=rows_same, ef_bitwise=ef_same,
                          one_process_period_s=want[name]["period_s"])
        emit("shard_map_axes", **fields)
        assert same_dry, (name, [x["collectives"] for x in got.values()],
                          dry[name])
        assert all(np.isfinite(dis)), dis
        if name in want:
            assert fields["bitwise"] and fields["ef_bitwise"], name
        if shape == AXES_SHAPE:
            # the server subgroups: the two ranks of each replica
            assert [x["server_group"] for x in got.values()] == [
                [r % 2, 2 + r % 2] for r in range(SHARD_M)], got
        else:
            # the yardstick: the replica-0 ranks, one group, whole rows
            assert sorted(got) == [0, 2] and all(
                x["server_group"] == [0, 2] for x in got.values()), got
        launches = got[0]["launches"]
        if stale is None:
            assert launches.get("consensus_mix_rows", 0) > 0, launches
        elif stale == 0:
            assert launches.get("bucketed_gossip_round_rows") == AXES_T
            assert launches.get("quantized_gossip_encode", 0) >= 1
        else:
            assert launches.get(
                "bucketed_gossip_round_pipelined_rows") == AXES_T
            assert all(x["kernel8_instances"] == {KERNEL8_ROW: AXES_T}
                       for x in got.values()), got
        if stale is not None:
            assert all(p["calls_per_round"] == {"all_gather:int8": 1.0,
                                                "all_gather:float32": 1.0}
                       for p in per_rank), per_rank
    return total


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_dryrun():
    """The dry run of DRYRUN_PAIRS in a process of its own, on the CPU (it
    runs on meta tensors: no card, no storage); ``finish_dryrun`` reads
    it, and the process is killed at exit if it still runs."""
    root = pathlib.Path(__file__).resolve().parent
    code = ("import json, sys, time\n"
            "from repro_torch.launch import dryrun\n"
            "for a, s in json.loads(sys.argv[1]):\n"
            "    t0 = time.perf_counter()\n"
            "    r = dryrun.run_one(a, s, save=False, verbose=False)\n"
            "    r['pair_s'] = time.perf_counter() - t0\n"
            "    print(json.dumps(r, default=str), flush=True)\n")
    env = {**__import__("os").environ, "PYTHONPATH": str(root / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    # its output goes to files: a full pipe would stall it while this
    # process runs the paths
    (root / "build").mkdir(exist_ok=True)
    out = root / "build" / f"dryrun_{int(time.time())}"
    with open(f"{out}.out", "w") as fo, open(f"{out}.err", "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(DRYRUN_PAIRS)],
            cwd=root, env=env, stdout=fo, stderr=fe)
    proc.out_path = out
    atexit.register(_stop, proc)
    return proc


def finish_dryrun(proc, dry_axes: dict) -> None:
    """``dryrun``: one line a pair (the device's peak and FLOPs against the
    card's 80 GB, the collective bytes, the dominant roofline term, each
    number's label), and the consensus bytes of the (2, 1, 2, 1) mesh at
    SmolLM-360M's tree (the dry record ``shard_map_axes`` was held to)."""
    t0 = time.perf_counter()
    proc.wait(timeout=600)
    out = pathlib.Path(f"{proc.out_path}.out").read_text()
    if proc.returncode != 0:
        err = pathlib.Path(f"{proc.out_path}.err").read_text()
        raise RuntimeError(f"the dry run exited {proc.returncode}:\n"
                           f"{err[-4000:]}")
    recs = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert [(r["meta"]["arch"], r["meta"]["shape"]) for r in recs] == \
        DRYRUN_PAIRS, recs
    for r in recs:
        emit("dryrun", arch=r["meta"]["arch"], shape=r["meta"]["shape"],
             mesh=r["mesh_axes"], chips=r["chips"],
             peak_per_device=r["memory"]["peak_per_device"],
             argument_bytes=r["memory"]["argument_bytes"],
             flops_per_device=r["cost"]["flops_per_device"],
             collective_bytes=r["collectives"]["total_bytes"],
             dominant=r["roofline"]["dominant"],
             unsharded=r["meta"]["unsharded"], pair_s=r["pair_s"],
             wait_s=time.perf_counter() - t0)
        assert r["memory"]["peak_per_device"]["label"] in (
            "measured_meta", "analytic_split"), r
    emit("dryrun", arch="smollm-360m", shape="consensus_period",
         mesh=dict(zip(("server", "client", "replica", "model"), AXES_SHAPE)),
         calls=dry_axes["wire"]["calls"], bytes=dry_axes["wire"]["bytes"],
         label="measured_meta")


#: history keys that depend on the wire's byte layout: the shard_map
#: program's bucket pads to its 16,777,216-element blocks, the one-process
#: wire's to 4,194,304, so at full size the ledgers differ by the padding
SHARD_LAYOUT_KEYS = ("wire_mb", "wire_ratio")
#: the Lemma-1 and Lemma-3 diagnostics: the disagreement is sqrt(sum_i
#: |w_i|^2 - M |mean|^2) and the drift sqrt(|c|^2 - 2 c.s + |s|^2) in
#: float32, differences of near-equal sums that the ranks reduce in
#: another order than one process (all-reduced sums; the card's reduction
#: kernels split a (1, N, ...) leaf otherwise than an (M, N, ...) one).
#: Held to the larger of 1e-3 of the value and its float32 floor
#: sqrt(2^-20 sum_i |w_i|^2) (a float32 sum of 3.6e8 squares carries
#: ~1e-6 of its size); every other key is held exactly
SHARD_FLOOR_KEYS = ("disagreement", "drift")
SHARD_METRIC_RTOL = 1e-3
SHARD_SUMSQ_FLOOR = 2.0 ** -20


def history_match(got: dict, want: dict, sumsq: float) -> tuple:
    """``(every other key equal, the diagnostics' largest difference over
    their limit)`` of two runs' histories, the layout keys left out; the
    limit is the larger of SHARD_METRIC_RTOL of the value and the float32
    floor of the servers' squared norm ``sumsq``."""
    keys = set(want) - set(SHARD_LAYOUT_KEYS) - set(SHARD_FLOOR_KEYS)
    same = set(got) == set(want) and all(got[k] == want[k] for k in keys)
    floor = (SHARD_SUMSQ_FLOOR * sumsq) ** 0.5
    ratio = max((abs(g - w) / max(SHARD_METRIC_RTOL * abs(w), floor, 1e-30)
                 for k in SHARD_FLOOR_KEYS
                 for g, w in zip(got.get(k, []), want.get(k, []))),
                default=0.0)
    return same, ratio


def shard_cli(torch, ttrain) -> None:
    """``shard_map_cli``: ``torch.distributed.run`` with four ranks on the
    int8 physical wire at the smoke size; rank 0's JSONL history against
    the in-process one-process run's."""
    import socket
    root = pathlib.Path(__file__).resolve().parent
    jl = root / "build" / f"shard_cli_{int(time.time())}.jsonl"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = ["--servers", "4", "--clients", "2", "--t-client", "2",
            "--t-server", "5", "--epochs", "1", "--compression", "int8",
            "--wire", "physical"]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-addr", "localhost", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--consensus-backend",
         "shard_map", "--telemetry-jsonl", str(jl)] + args,
        cwd=root, env={**__import__("os").environ,
                       "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"torch.distributed.run exited {r.returncode}:\n"
                           f"{r.stderr[-4000:]}")
    recs = [json.loads(line)["value"] for line in jl.read_text().splitlines()
            if json.loads(line).get("kind") == "epoch"]
    from repro_torch.tree import tree_leaves
    one_run = ttrain.train("smollm-360m", servers=4, clients=2, t_client=2,
                           t_server=5, epochs=1, compression="int8",
                           wire="physical", log=False)
    one = one_run["history"]
    cli_sumsq = sum(float(x[:, 0].double().square().sum())
                    for x in tree_leaves(one_run["state"].client_params))
    del one_run
    got = {k: [rec[k] for rec in recs] for k in one
           if k not in ("epoch_s", "alloc_gb")}
    want = {k: v for k, v in one.items() if k not in ("epoch_s", "alloc_gb")}
    # at the smoke size both bucket layouts are one block: the ledger too
    same, dis_ratio = history_match(got, want, cli_sumsq)
    same = same and all(got[k] == want[k] for k in SHARD_LAYOUT_KEYS)
    keys = sorted(want)
    emit("shard_map_cli", exit_code=r.returncode, seconds=cli_s,
         records=len(recs), same_history=same, keys=keys,
         diagnostics_over_limit=dis_ratio,
         loss=[rec["loss"] for rec in recs], one_process_loss=one["loss"])
    jl.unlink()
    assert same and dis_ratio <= 1.0 and len(recs) == 1, (recs, one)



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a GPU and has nothing to run here", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core import consensus as cns
    from repro_torch.core import dfl as tdfl
    from repro_torch.core import topology as tp
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves, tree_map
    import numpy as np

    dev = torch.device("cuda")
    ttrain.set_full_f32()
    smi = nvidia_smi()

    # ---- 1. device ----
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ---- 2. build (set-up) ----
    t0 = time.perf_counter()
    _build.compile_all(_build.sources())
    nvcc_s = time.perf_counter() - t0
    regs = sorted({line.split("Used ")[1].split(",")[0]
                   for log in _build.build_logs.values()
                   for line in log.splitlines() if "Used " in line})
    # kernel 2's instances by family and block bound (1024: the widest rows)
    rn_ptxas: dict = {}
    for e in ptxas_entries(_build.build_logs.get("rmsnorm", "")):
        family = next(f for f in ("fwd", "bwd", "column_sum", "")
                      if f"rmsnorm_{f}" in e["kernel"])
        key = family + ("_1024" if "Li1024E" in e["kernel"] else "")
        row = rn_ptxas.setdefault(key, {"instances": 0, "max_registers": 0,
                                        "max_spill_store_bytes": 0})
        row["instances"] += 1
        row["max_registers"] = max(row["max_registers"], e["registers"])
        row["max_spill_store_bytes"] = max(row["max_spill_store_bytes"],
                                           e["spill_store_bytes"])
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    x = torch.randn((8, 960), device=dev, generator=g)
    y, rstd = rn.rmsnorm_fwd_cuda(x, torch.ones(960, device=dev), 1e-6)
    rn.rmsnorm_bwd_cuda(x, torch.ones(960, device=dev), rstd,
                        torch.ones_like(y))
    torch.cuda.synchronize()
    # kernel 8's instances (only when this run compiled quantized_wire.cu)
    k8_ptxas = pipelined_ptxas(_build.build_logs.get("quantized_wire", ""))
    emit("build", nvcc_s=nvcc_s, sources=_build.sources(),
         ptxas_registers=regs, rmsnorm_ptxas=rn_ptxas,
         pipelined_ptxas=k8_ptxas,
         rmsnorm_first_call_s=time.perf_counter() - t0)
    assert len(_build.sources()) == 6, _build.sources()
    assert not ("quantized_wire" in _build.build_logs and len(k8_ptxas) != 11)
    assert all(e["spill_store_bytes"] == 0 for e in k8_ptxas), k8_ptxas

    # ---- 3. kernel 1 vs its plain version ----
    for m in (1, 4, 5, 16):
        a_np = (tp.metropolis_weights(tp.ring_graph(m)) if m > 1
                else [[1.0]])
        a = torch.tensor(cns.collapse_mixing(a_np, 3), dtype=torch.float32,
                         device=dev)
        for d in (4096, 1_000_003):
            w = torch.randn((m, d), device=dev, generator=g)
            err, rel = rel_err(torch, ops.consensus_mix(a, w),
                               ref.consensus_mix_ref(a, w))
            torch.cuda.synchronize()
            emit("consensus_mix_check", m=m, d=d, max_abs_err=err,
                 max_rel_err=rel)
            assert rel < 1e-5, (m, d, rel)
    m, d = TRAIN["servers"], SMOLLM_PARAMS
    a = torch.tensor(tp.metropolis_weights(tp.ring_graph(m)),
                     dtype=torch.float32, device=dev)
    w = torch.randn((m, d), device=dev, generator=g)
    out = torch.empty_like(w)
    cm_err, cm_rel = rel_err(torch, ops.consensus_mix(a, w, out=out),
                             ref.consensus_mix_ref(a, w))
    assert cm_rel < 1e-5, cm_rel
    cm_times = alternate(torch, {
        "kernel": lambda: ops.consensus_mix(a, w, out=out),
        "plain": lambda: ref.consensus_mix_ref(a, w),
        "library": lambda: torch.matmul(a, w)}, reps=10)
    cm_bytes = 2 * m * d * 4 + m * m * 4
    cm_bound, cm_by = bound_ms(cm_bytes, 2 * m * m * d)
    emit("consensus_mix_main_shape", m=m, d=d, max_abs_err=cm_err,
         max_rel_err=cm_rel, kernel_ms=cm_times["kernel"],
         plain_ms=cm_times["plain"], library_ms=cm_times["library"],
         bound_ms=cm_bound, bound_by=cm_by,
         kernel_GBps=cm_bytes / cm_times["kernel"] / 1e6,
         bound_GBps=H100_BYTES_PER_S / 1e9)
    del w, out
    torch.cuda.empty_cache()

    # ---- 4. kernel 2 (forward and backward) vs its plain version and
    # F.rms_norm at every row shape of the paths ----
    rn_stats = rmsnorm_sweep(torch, g)

    # ---- 5. training: the main path ----
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = ttrain.train("smollm-360m", **TRAIN)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    hist = run["history"]
    n_params = sum(t[0, 0].numel() for t in
                   tree_leaves(run["state"].client_params))
    tokens_per_epoch = (TRAIN["t_client"] * TRAIN["servers"]
                        * TRAIN["clients"] * TRAIN["per_client_batch"]
                        * TRAIN["seq_len"])
    client_steps = (TRAIN["t_client"] * TRAIN["servers"] * TRAIN["clients"]
                    * TRAIN["epochs"])
    norms_per_step = 2 * run["cfg"].num_layers + 1
    emit("train", arch="smollm-360m", params=n_params,
         loss=hist["loss"], disagreement=hist["disagreement"],
         drift=hist["drift"], sigma_prod=hist["sigma_prod"],
         epoch_s=hist["epoch_s"],
         tokens_per_s=[tokens_per_epoch / t for t in hist["epoch_s"]],
         launches=launches,
         expected_launches={
             "consensus_mix": TRAIN["t_server"] * TRAIN["epochs"],
             "flash_attention": 0,
             "rmsnorm_fwd": norms_per_step * client_steps,
             "rmsnorm_bwd": norms_per_step * client_steps},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert n_params == SMOLLM_PARAMS, n_params
    assert launches["flash_attention"] == 0, launches   # not on this path
    assert all(launches[k] == 0 for k in WIRE_KERNELS), launches
    assert launches[SIM_KERNEL[0]] == 0, launches
    assert launches["ssd_scan"] == 0, launches
    assert launches["consensus_mix"] == TRAIN["t_server"] * TRAIN["epochs"]
    assert launches["rmsnorm_fwd"] == norms_per_step * client_steps
    assert launches["rmsnorm_bwd"] == norms_per_step * client_steps
    assert all(torch.isfinite(torch.tensor(v)) for v in hist["loss"]), hist

    # ---- 6. gossip at full size: kernel vs plain, mean, Lemma 1 ----
    gen = torch.Generator(device=dev).manual_seed(1)
    server = tree_map(lambda x: x[:, 0].clone(), run["state"].client_params)
    del run
    torch.cuda.empty_cache()
    server = tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, device=dev, generator=gen), server)
    a_np = tp.metropolis_weights(tp.ring_graph(m))
    t_s = TRAIN["t_server"]
    mixed = cns.make_backend("gossip", a_np, t_s).mix(server)
    plain = cns.gossip_scan(torch.tensor(a_np, dtype=torch.float32,
                                         device=dev), server, t_s)

    def stats(tree):
        """Per-leaf server means and the f64 deviation norm ||W - 1 wbar'||."""
        means = [leaf.reshape(leaf.shape[0], -1).double().mean(0)
                 for leaf in tree_leaves(tree)]
        return means, disagreement_f64(torch, tree_leaves(tree))

    mean0, dis0 = stats(server)
    mean1, dis1 = stats(mixed)
    mean_err = max(float((p - q).abs().max()) for p, q in zip(mean0, mean1))
    mean_scale = max(float(p.abs().max()) for p in mean0)
    vs_plain = max(rel_err(torch, p, q)[1]
                   for p, q in zip(tree_leaves(mixed), tree_leaves(plain)))
    sigma = tp.sigma_a(a_np, t_s)
    emit("gossip_full_size", m=m, t_server=t_s, d=SMOLLM_PARAMS,
         mean_max_rel_err=mean_err / mean_scale,
         disagreement_before=dis0, disagreement_after=dis1,
         ratio=dis1 / dis0, sigma_a=sigma, vs_plain_max_rel_err=vs_plain)
    assert mean_err / mean_scale < 1e-5, mean_err / mean_scale
    assert dis1 <= sigma * dis0 * (1 + 1e-4), (dis1, sigma * dis0)
    assert vs_plain < 1e-5, vs_plain
    del server, mixed, plain, mean0, mean1
    torch.cuda.empty_cache()

    # ---- 7. where the time goes: one more epoch under the profiler ----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            timed_norms() as norms:
        t0 = time.perf_counter()
        ttrain.train("smollm-360m", **{**TRAIN, "epochs": 1}, log=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        t_stop = time.perf_counter()
    emit("profile", profiler_stop_s=time.perf_counter() - t_stop,
         **profile_summary(prof, wall_s, norms=norms))

    # ---- 7b. dynamic federation: participation, edge drops, a server
    # dropping and rejoining, then a Chebyshev epoch ----
    dynamic_federation(torch, ttrain, ops)
    # ---- 7c. one dynamic period at full size, M = 3 ----
    dynamic_period_full_size(torch, cns, tp, ttf, tdfl, ops, ref,
                             tree_leaves, tree_map)

    # ---- 8. kernel 3 vs its plain version over the reference's sweep ----
    for shape, kw, dtype in FLASH_SWEEP:
        b, sq, sk, h, kvh, hd = shape
        q = torch.randn((b, sq, h, hd), device=dev, generator=g)
        k = torch.randn((b, sk, kvh, hd), device=dev, generator=g)
        v = torch.randn((b, sk, kvh, hd), device=dev, generator=g)
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, got, want)
        limit = flash_limit(kw, dtype)
        emit("flash_attention_check", shape=shape, dtype=dtype, **kw,
             out_dtype=str(got.dtype), max_abs_err=err, max_rel_err=rel,
             limit=limit)
        assert got.dtype == q.dtype and rel < limit, (shape, kw, dtype, rel)

    # ---- 9. kernel 3 at the serving path's shape: times and bound ----
    qcfg = get_arch("qwen3-1.7b")
    b, s_len = SERVE["batch"], SERVE["prompt_len"]
    h, kvh, hd = qcfg.num_heads, qcfg.num_kv_heads, qcfg.resolved_head_dim()
    q = torch.randn((b, s_len, h, hd), device=dev, generator=g)
    k = torch.randn((b, s_len, kvh, hd), device=dev, generator=g)
    v = torch.randn((b, s_len, kvh, hd), device=dev, generator=g)
    fa_err, fa_rel = rel_err(torch, ops.flash_attention(q, k, v),
                             ref.attention_ref(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = rel_err(torch, sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), is_causal=True,
                                  enable_gqa=True).transpose(1, 2),
                      ref.attention_ref(q, k, v))[1]
    assert fa_rel < 2e-5, fa_rel
    fa_times = alternate(torch, {
        "kernel": lambda: ops.flash_attention(q, k, v),
        "plain": lambda: ref.attention_ref(q, k, v),
        "library": lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), is_causal=True,
                                enable_gqa=True)}, reps=20)
    fa_flops = b * h * causal_pairs(torch, s_len, s_len) * 4 * hd
    fa_bytes = (2 * q.numel() + k.numel() + v.numel()) * 4
    fa_bound, fa_by = bound_ms(fa_bytes, fa_flops)
    fa_dev = device_kernels(torch, lambda: ops.flash_attention(q, k, v))
    emit("flash_attention_main_shape", shape=[b, s_len, s_len, h, kvh, hd],
         causal=True, max_abs_err=fa_err, max_rel_err=fa_rel,
         library_max_rel_err=lib_err, kernel_ms=fa_times["kernel"],
         plain_ms=fa_times["plain"], library_ms=fa_times["library"],
         flops=fa_flops, bytes=fa_bytes, bound_ms=fa_bound, bound_by=fa_by,
         kernel_TFLOPs=fa_flops / fa_times["kernel"] / 1e9,
         bound_share=fa_bound / fa_times["kernel"],
         dynamic_smem_bytes=fa.smem_bytes(hd),
         ptxas=[line.strip() for line in
                _build.build_logs.get("flash_attention", "").splitlines()
                if "Used" in line or "spill" in line],
         device_us=fa_dev,
         device_kernels_per_call=len(fa_dev),
         blocks=fa.blocks(b, s_len, h, kvh),
         ptxas_instances=ptxas_entries(
             _build.build_logs.get("flash_attention", "")))
    del q, k, v
    torch.cuda.empty_cache()

    # ---- 10. serving: the second path ----
    # a short run at the same widths and batch first, so that the timed run
    # holds none of the first calls' set-up (cuBLAS handles, the allocator)
    tserve.serve("qwen3-1.7b", **{**SERVE, "prompt_len": 16, "gen": 2})
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    res = tserve.serve("qwen3-1.7b", **SERVE)
    torch.cuda.synchronize()
    serve_launches = ops.launch_counts()
    norms_per_pass = 4 * qcfg.num_layers + 1
    serve_expected = {"consensus_mix": 0,
                      "flash_attention": qcfg.num_layers,
                      "rmsnorm_fwd": norms_per_pass * SERVE["gen"],
                      "rmsnorm_bwd": 0, SIM_KERNEL[0]: 0, "ssd_scan": 0,
                      **{k: 0 for k in WIRE_KERNELS},
                      **{k: 0 for k in ROW_KERNELS}}
    generated = res["generated"]
    emit("serve", arch="qwen3-1.7b", batch=b, prompt_len=s_len,
         gen=SERVE["gen"], prefill_s=res["prefill_s"],
         decode_s=res["decode_s"], tok_per_s=res["tok_per_s"],
         prefill_tok_per_s=b * s_len / res["prefill_s"],
         peak_mem_gb=(torch.cuda.max_memory_allocated() - baseline) / 1e9,
         launches=serve_launches, expected_launches=serve_expected,
         first_row=generated[0, :16].tolist())
    assert serve_launches == serve_expected, serve_launches
    assert tuple(generated.shape) == (b, SERVE["gen"])
    assert 0 <= int(generated.min()) and \
        int(generated.max()) < qcfg.vocab_size

    # ---- 11. serving, checked: kernel vs reference route, decode vs
    # forward, on the weights and prompt serve() drew from seed 0 ----
    rng = torch.Generator(device=dev).manual_seed(0)
    params = ttf.init_params(rng, qcfg, device=dev)
    n_qwen = sum(t.numel() for t in tree_leaves(params))
    prompt = torch.randint(0, qcfg.vocab_size, (b, s_len), generator=rng,
                           device=dev)
    assert n_qwen == QWEN3_PARAMS, n_qwen
    assert torch.equal(prompt, res["prompt"])
    prefill = dict(max_len=s_len + 4, cache_dtype=torch.float32)
    ref_logits, _ = ttf.prefill(params, qcfg, {"tokens": prompt}, **prefill)
    logits, cache = ttf.prefill(params, qcfg, {"tokens": prompt},
                                opts=ttf.ApplyOptions(attn_impl="kernel"),
                                **prefill)
    pf_err, pf_rel = rel_err(torch, logits, ref_logits)
    del ref_logits
    assert pf_rel < 1e-4, pf_rel
    nxt = logits[:, -1].argmax(-1)[:, None]
    assert torch.equal(nxt, generated[:, :1]), "prefill differs from serve()"
    toks, dec_errs = prompt, []
    for _ in range(3):
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = ttf.decode_step(params, qcfg, nxt, cache)
        with torch.inference_mode():
            full, _ = ttf.forward(params, qcfg, {"tokens": toks})
        want = full[:, -1]
        del full
        dec_errs.append(rel_err(torch, logits[:, 0], want)[0])
        torch.testing.assert_close(logits[:, 0], want, rtol=2e-3, atol=2e-3)
        nxt = logits[:, -1].argmax(-1)[:, None]
    emit("serve_check", params=n_qwen, prefill_max_abs_err=pf_err,
         prefill_max_rel_err=pf_rel, prefill_limit=1e-4,
         decode_vs_forward_max_abs_err=dec_errs, decode_limit=2e-3,
         forward_keys=toks.shape[1])
    del cache, logits, want

    # ---- 12. where the serving time goes: prefill and 8 decode steps
    # under the profiler, then the same decode steps timed alone ----
    profile_serving(torch, params, qcfg, prompt, prefill,
                    ("serve_profile", "decode_steps"))
    del params
    torch.cuda.empty_cache()

    # ---- 13. the wire kernels vs their plain versions ----
    from repro_torch.comm import compressors as cp
    from repro_torch.comm import prng
    wire_errs = {name: 0.0 for name in WIRE_KERNELS}
    off_by_one = 0
    for m in (1, 4, 5, 16):
        a = torch.tensor(tp.metropolis_weights(tp.ring_graph(m)) if m > 1
                         else [[1.0]], dtype=torch.float32, device=dev)
        for bits in (8, 4):
            qmax = 2 ** (bits - 1) - 1
            for chunk in (16, 256, 960):
                d = chunk * 517         # the last slab of a block is ragged
                w, r, acc = (torch.randn((m, d), device=dev, generator=g)
                             * sc for sc in (1.0, 0.5, 0.5))
                u = torch.rand((m, d), device=dev, generator=g)
                codes = torch.randint(-qmax, qmax + 1, (m, d), device=dev,
                                      generator=g, dtype=torch.int8)
                scales = torch.rand((m, d // chunk), device=dev,
                                    generator=g) * 0.02 + 1e-3
                kw = dict(bits=bits, chunk=chunk)

                def st(*ts):    # the kernels update their state in place
                    return [t.clone() for t in ts]

                pairs = {
                    "quantized_gossip_encode": (
                        ops.quantized_gossip_encode(w, r, u,
                                                    *st(codes, scales), **kw),
                        ref.quantized_gossip_encode_ref(w, r, u, **kw)),
                    "bucketed_gossip_round": (
                        ops.bucketed_gossip_round(
                            a, *st(codes, scales, r, acc), u, **kw),
                        ref.bucketed_gossip_round_ref(a, codes, scales, r,
                                                      acc, u, **kw)),
                    "bucketed_gossip_round_pipelined": (
                        ops.bucketed_gossip_round_pipelined(
                            a, *st(codes, scales), w, *st(r, acc), u, **kw),
                        ref.bucketed_gossip_round_pipelined_ref(
                            a, codes, scales, w, r, acc, u, **kw)),
                    "quantized_gossip_round": (
                        ops.quantized_gossip_round(
                            a, *st(codes, scales, r), torch.empty_like(r), u,
                            **kw),
                        ref.quantized_gossip_round_ref(a, codes, scales, r,
                                                       u, **kw)),
                }
                torch.cuda.synchronize()
                res = {k: wire_compare(torch, *v) for k, v in pairs.items()}
                for k, v in res.items():
                    wire_errs[k] = max(wire_errs[k], v["max_abs_err"])
                    off_by_one += v["codes_off_by_one"]
                emit("wire_kernel_check", m=m, bits=bits, chunk=chunk, d=d,
                     **{k: v["codes_off_by_one"] for k, v in res.items()},
                     max_abs_err=max(v["max_abs_err"] for v in res.values()))
    # the dither: the card's int64 hash against the CPU's, bitwise
    for n in (1000, (1 << 24) + 17):
        kw = dict(leaf=0, rnd=3, server=2, block=0)
        assert torch.equal(cp.wire_dither(prng.key(5), n, device=dev,
                                          **kw).cpu(),
                           cp.wire_dither(prng.key(5), n, **kw))
    emit("wire_dither_check", ok=True, codes_off_by_one=off_by_one)
    del w, r, acc, u, codes, scales, pairs
    torch.cuda.empty_cache()

    # ---- 14. the wire path: training with int8 codes on the wire and
    # error feedback ----
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with wire_period_disagreement(torch, cns, tree_leaves) as periods:
        run = ttrain.train("smollm-360m", **WIRE_TRAIN)
        torch.cuda.synchronize()
    wire_launches = ops.launch_counts()
    hist = run["history"]
    n_params = sum(t[0, 0].numel() for t in
                   tree_leaves(run["state"].client_params))
    wire_expected = {
        "consensus_mix": 0, "flash_attention": 0,
        "rmsnorm_fwd": norms_per_step * client_steps,
        "rmsnorm_bwd": norms_per_step * client_steps,
        "quantized_gossip_encode": WIRE_TRAIN["epochs"],
        "bucketed_gossip_round": WIRE_TRAIN["t_server"] * WIRE_TRAIN["epochs"],
        "bucketed_gossip_round_pipelined": 0, "quantized_gossip_round": 0,
        SIM_KERNEL[0]: 0, "ssd_scan": 0, **{k: 0 for k in ROW_KERNELS}}
    emit("train_wire", arch="smollm-360m", params=n_params,
         compression=WIRE_TRAIN["compression"], wire=WIRE_TRAIN["wire"],
         error_feedback=WIRE_TRAIN["error_feedback"], loss=hist["loss"],
         disagreement=hist["disagreement"], drift=hist["drift"],
         epoch_s=hist["epoch_s"],
         tokens_per_s=[tokens_per_epoch / t for t in hist["epoch_s"]],
         wire_mb=hist["wire_mb"], wire_ratio=hist["wire_ratio"],
         launches=wire_launches, expected_launches=wire_expected,
         periods=periods, sigma_a=tp.sigma_a(
             tp.metropolis_weights(tp.ring_graph(WIRE_TRAIN["servers"])),
             WIRE_TRAIN["t_server"]),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert n_params == SMOLLM_PARAMS, n_params
    assert wire_launches == wire_expected, wire_launches
    assert all(torch.isfinite(torch.tensor(v)) for v in hist["loss"]), hist
    # every wire period contracts the servers' disagreement (float64)
    assert len(periods) == WIRE_TRAIN["epochs"], periods
    assert all(p["after"] < p["before"] for p in periods), periods
    del run
    torch.cuda.empty_cache()

    # ---- 14b. the wire path at staleness 1: one epoch, every gossip round
    # on kernel 8 ----
    stale_train = dict(WIRE_TRAIN, epochs=1, staleness=1)
    ops.reset_launch_counts()
    with wire_period_disagreement(torch, cns, tree_leaves) as stale_periods:
        run = ttrain.train("smollm-360m", **stale_train)
        torch.cuda.synchronize()
    stale_launches = ops.launch_counts()
    stale_instances = ops.wire_pipelined_instance_counts()
    stale_expected = {
        "consensus_mix": 0, "flash_attention": 0,
        "rmsnorm_fwd": norms_per_step * client_steps // TRAIN["epochs"],
        "rmsnorm_bwd": norms_per_step * client_steps // TRAIN["epochs"],
        "quantized_gossip_encode": 0, "bucketed_gossip_round": 0,
        "bucketed_gossip_round_pipelined": stale_train["t_server"],
        "quantized_gossip_round": 0, SIM_KERNEL[0]: 0, "ssd_scan": 0,
        **{k: 0 for k in ROW_KERNELS}}
    hist = run["history"]
    emit("train_wire_stale", arch="smollm-360m", staleness=1,
         loss=hist["loss"], epoch_s=hist["epoch_s"],
         tokens_per_s=[tokens_per_epoch / t for t in hist["epoch_s"]],
         sigma_prod=hist["sigma_prod"], periods=stale_periods,
         sigma_a=tp.sigma_a(
             tp.metropolis_weights(tp.ring_graph(stale_train["servers"])),
             stale_train["t_server"] // 2),
         launches=stale_launches, expected_launches=stale_expected,
         kernel8_instances=stale_instances)
    assert stale_launches == stale_expected, stale_launches
    # every round on the resident body, 16-byte loads (VEC = 4)
    assert stale_instances == {KERNEL8_SQUARE: stale_train["t_server"]}, \
        stale_instances
    assert all(torch.isfinite(torch.tensor(v)) for v in hist["loss"]), hist
    assert len(stale_periods) == 1, stale_periods
    assert stale_periods[0]["after"] < stale_periods[0]["before"], \
        stale_periods

    # ---- 15. one wire period at full size: staleness 0 and 1, and the
    # per-leaf layout; each against the plain versions on column slabs ----
    m, t_s = WIRE_TRAIN["servers"], WIRE_TRAIN["t_server"]
    server = tree_map(lambda x: x[:, 0].clone(), run["state"].client_params)
    del run
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)
    server = tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, device=dev, generator=gen), server)
    a = torch.tensor(tp.metropolis_weights(tp.ring_graph(m)),
                     dtype=torch.float32, device=dev)
    q = cp.StochasticQuantizer(bits=8, chunk=WIRE_CHUNK)
    key = prng.key(11)
    leaves = tree_leaves(server)
    d_tot, d_pad = cns._bucket_layout(leaves, cns.DEFAULT_GOSSIP_BLOCK,
                                         WIRE_CHUNK)
    flat_in = cns._bucket_flat(leaves, d_pad)
    mean0, dis0 = stats(server)
    period_launches = {}
    slabs = [0, (d_pad // 2) // WIRE_CHUNK * WIRE_CHUNK, d_pad - WIRE_SLAB]
    for staleness in (0, 1):
        ops.reset_launch_counts()
        out = cns.gossip_scan_wire_bucketed(a, server, t_s, q, key,
                                            staleness=staleness)
        torch.cuda.synchronize()
        got_launches = ops.launch_counts()
        got_instances = ops.wire_pipelined_instance_counts()
        period_launches[staleness] = got_launches
        flat_out = cns._bucket_flat(tree_leaves(out), d_pad)
        errs = []
        for lo in slabs:
            want = plain_bucketed_slab(
                torch, ref, cp, a, flat_in[:, lo:lo + WIRE_SLAB].clone(),
                key, lo, t_s, staleness, 8, WIRE_CHUNK)
            assert torch.equal(flat_out[:, lo:lo + WIRE_SLAB], want), lo
            errs.append(float((flat_out[:, lo:lo + WIRE_SLAB]
                               - want).abs().max()))
        mean1, dis1 = stats(out)
        mean_err = max(float((p_ - q_).abs().max())
                       for p_, q_ in zip(mean0, mean1))
        emit("wire_period_full_size", layout="bucketed",
             staleness=staleness, m=m, t_server=t_s, d=d_tot, d_pad=d_pad,
             launches=got_launches, kernel8_instances=got_instances,
             slabs=slabs, slab_cols=WIRE_SLAB,
             slab_max_abs_err=max(errs), mean_max_abs_drift=mean_err,
             disagreement_before=dis0, disagreement_after=dis1,
             ratio=dis1 / dis0, sigma_a=tp.sigma_a(
                 np.asarray(a.cpu()), t_s // (staleness + 1)))
        want_launches = ({"quantized_gossip_encode": 1,
                          "bucketed_gossip_round": t_s} if staleness == 0
                         else {"bucketed_gossip_round_pipelined": t_s})
        assert all(got_launches[k] == want_launches.get(k, 0)
                   for k in WIRE_KERNELS), got_launches
        assert got_instances == ({KERNEL8_SQUARE: t_s} if staleness
                                 else {}), got_instances
        assert dis1 < dis0, (dis1, dis0)
        del out, flat_out
        torch.cuda.empty_cache()
    del flat_in
    # the per-leaf layout: one encode and T_S per-leaf rounds per leaf
    ops.reset_launch_counts()
    out = cns.gossip_scan_wire(a, server, t_s, q, key)
    torch.cuda.synchronize()
    leaf_launches = ops.launch_counts()
    period_launches["per_leaf"] = leaf_launches
    block = cns.DEFAULT_GOSSIP_BLOCK
    errs = []
    for li, (x_in, x_out) in enumerate(zip(leaves, tree_leaves(out))):
        d_leaf = x_in[0].numel()
        if li > 1 and d_leaf < block:
            continue                    # the embedding and one small leaf
        rows_in, blk, nb, blk_pad = cns._leaf_blocks(
            x_in.reshape(m, -1), block, WIRE_CHUNK)
        rows_out = cns._leaf_blocks(x_out.reshape(m, -1), block,
                                    WIRE_CHUNK)[0]
        for b in sorted({0, nb - 1}):
            real = min(blk, d_leaf - b * blk)
            n = min(WIRE_SLAB, blk_pad)
            lo = max(0, (real - n // 2) // WIRE_CHUNK * WIRE_CHUNK)
            lo = min(lo, blk_pad - n)
            cols = slice(b * blk_pad + lo, b * blk_pad + lo + n)
            want = plain_leaf_slab(torch, ref, cp, a,
                                   rows_in[:, cols].clone(), key, li, b, lo,
                                   real, t_s, 8, WIRE_CHUNK)
            assert torch.equal(rows_out[:, cols], want), (li, b)
            errs.append(float((rows_out[:, cols] - want).abs().max()))
        del rows_in, rows_out
    mean1, dis1 = stats(out)
    n_leaves = len(leaves)
    emit("wire_period_full_size", layout="per_leaf", m=m, t_server=t_s,
         d=d_tot, leaves=n_leaves, launches=leaf_launches,
         slab_max_abs_err=max(errs),
         mean_max_abs_drift=max(float((p_ - q_).abs().max())
                                for p_, q_ in zip(mean0, mean1)),
         disagreement_before=dis0, disagreement_after=dis1,
         ratio=dis1 / dis0)
    assert leaf_launches["quantized_gossip_encode"] == n_leaves
    assert leaf_launches["quantized_gossip_round"] == n_leaves * t_s
    assert dis1 < dis0, (dis1, dis0)
    leaf_pad = sum(cns._leaf_blocks(torch.empty((1, x[0].numel()),
                                                device="meta"),
                                    block, WIRE_CHUNK)[0].shape[1]
                   for x in leaves)
    del out, mean0, mean1
    torch.cuda.empty_cache()

    # where a wire period's time goes besides its kernels: one round's
    # dither (all servers), the bucket copy, the EF residual (CUDA events)
    flat = cns._bucket_flat(leaves, d_pad)
    u = torch.empty_like(flat)
    res = [torch.zeros_like(x).reshape(m, -1) for x in leaves]
    codes = torch.zeros((m, d_pad), dtype=torch.int8, device=dev)
    scales = torch.ones((m, d_pad // WIRE_CHUNK), device=dev)

    def residual():
        off = 0
        for r_ in res:
            cns._ef_residual_into(r_, flat, codes, scales, off, WIRE_CHUNK)
            off += r_.shape[1]

    emit("wire_breakdown", m=m, d_pad=d_pad,
         dither_ms=cuda_ms(torch, lambda: cns._bucket_dither_rows(
             key, m, d_pad, rnd=1, out=u), reps=2, warmup=1),
         bucket_flat_ms=cuda_ms(torch, lambda: cns._bucket_flat(
             leaves, d_pad), reps=2, warmup=1),
         ef_residual_ms=cuda_ms(torch, residual, reps=1, warmup=1),
         per_epoch={"dither": t_s, "bucket_flat": 1, "ef_residual": 1,
                    "quantized_gossip_encode": 1,
                    "bucketed_gossip_round": t_s})
    del flat, u, res, codes, scales, server, leaves
    torch.cuda.empty_cache()

    # where a wire epoch's time goes: one more epoch under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ttrain.train("smollm-360m", **{**WIRE_TRAIN, "epochs": 1}, log=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        t_stop = time.perf_counter()
    emit("profile_wire", profiler_stop_s=time.perf_counter() - t_stop,
         **profile_summary(prof, wall_s))
    del prof
    torch.cuda.empty_cache()

    # ---- 16. the wire kernels at the main path's shape: times, bounds, and
    # a slab of each call held against the plain version ----
    wire_times = {}
    n_max = m * max(d_pad, leaf_pad)    # one set of buffers for all four
    big = {"w": torch.randn(n_max, device=dev, generator=g),
           "r": torch.randn(n_max, device=dev, generator=g) * 0.5,
           "acc": torch.randn(n_max, device=dev, generator=g) * 0.5,
           "u": torch.rand(n_max, device=dev, generator=g),
           "codes": torch.randint(-127, 128, (n_max,), device=dev,
                                  generator=g, dtype=torch.int8),
           "scales": torch.rand(n_max // WIRE_CHUNK, device=dev,
                                generator=g) * 0.02 + 1e-3}
    lo = (d_pad // 3) // WIRE_CHUNK * WIRE_CHUNK
    cols = slice(lo, lo + WIRE_SLAB)
    kw = dict(bits=8, chunk=WIRE_CHUNK)

    def leaf_view(t, d):                # a contiguous (m, d) prefix
        return t[:m * d].view(m, d)

    calls = {
        "quantized_gossip_encode": (
            d_pad, lambda b: ops.quantized_gossip_encode(
                b["w"], b["r"], b["u"], b["codes"], b["scales"], **kw),
            lambda b: ref.quantized_gossip_encode_ref(
                b["w"], b["r"], b["u"], **kw)),
        "bucketed_gossip_round": (d_pad, lambda b: ops.bucketed_gossip_round(
            a, b["codes"], b["scales"], b["r"], b["acc"], b["u"], **kw),
            lambda b: ref.bucketed_gossip_round_ref(
                a, b["codes"], b["scales"], b["r"], b["acc"], b["u"], **kw)),
        "bucketed_gossip_round_pipelined": (
            d_pad, lambda b: ops.bucketed_gossip_round_pipelined(
                a, b["codes"], b["scales"], b["w"], b["r"], b["acc"], b["u"],
                **kw),
            lambda b: ref.bucketed_gossip_round_pipelined_ref(
                a, b["codes"], b["scales"], b["w"], b["r"], b["acc"], b["u"],
                **kw)),
        "quantized_gossip_round": (
            leaf_pad, lambda b: ops.quantized_gossip_round(
                a, b["codes"], b["scales"], b["r"], b["acc"], b["u"], **kw),
            lambda b: ref.quantized_gossip_round_ref(
                a, b["codes"], b["scales"], b["r"], b["u"], **kw)),
    }
    for name, (d_k, kernel, plain) in calls.items():
        buf = {k: leaf_view(v, d_k // WIRE_CHUNK if k == "scales" else d_k)
               for k, v in big.items()}
        slab = {k: (v[:, lo // WIRE_CHUNK:(lo + WIRE_SLAB) // WIRE_CHUNK]
                    if k == "scales" else v[:, cols]).clone()
                for k, v in buf.items()}
        want = plain(slab)
        got = kernel(buf)
        torch.cuda.synchronize()
        got_slab = tuple(
            x[:, lo // WIRE_CHUNK:(lo + WIRE_SLAB) // WIRE_CHUNK]
            if x.shape[1] == d_k // WIRE_CHUNK else x[:, cols] for x in got)
        cmp = wire_compare(torch, got_slab, want)
        before = ops.wire_pipelined_instance_counts()
        ms = alternate(torch, {"kernel": lambda: kernel(buf)}, reps=10)
        instances = instance_delta(before,
                                   ops.wire_pipelined_instance_counts())
        plain_ms = cuda_ms(torch, lambda: plain(slab), reps=3)
        per_elem, scale_passes, reads_a = WIRE_TRAFFIC[name]
        n_bytes = (m * d_k * per_elem
                   + scale_passes * m * (d_k // WIRE_CHUNK) * 4
                   + (m * m * 4 if reads_a else 0))
        # f32 operations: the encode's subtract and dither multiply-add, and
        # the rounds' mixing multiply-adds
        n_ops = 4 * m * d_k + (2 * m * m * d_k if reads_a else 0)
        bound, by = bound_ms(n_bytes, n_ops)
        wire_times[name] = dict(
            ms=ms["kernel"], plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            max_abs_err=max(wire_errs[name], cmp["max_abs_err"]))
        emit("wire_main_shape", kernel=name, m=m, d=d_k, chunk=WIRE_CHUNK,
             kernel_ms=ms["kernel"], bound_ms=bound, bound_by=by,
             bytes=n_bytes, kernel_GBps=n_bytes / ms["kernel"] / 1e6,
             bound_share=bound / ms["kernel"], plain_ms=plain_ms,
             plain_shape=[m, WIRE_SLAB], library_ms=None,
             slab_cols=[lo, lo + WIRE_SLAB], kernel8_instances=instances,
             **cmp)
        if name == "bucketed_gossip_round_pipelined":
            assert set(instances) == {KERNEL8_SQUARE}, instances
        del buf, slab, want, got, got_slab
    ptxas = [line.strip() for line in _build.build_logs.get(
        "quantized_wire", "").splitlines()
        if "Used" in line or "spill" in line]
    emit("wire_ptxas", ptxas=ptxas)
    del big
    torch.cuda.empty_cache()

    # ---- 17. the simulated wire: kernel 4 vs its plain version, on a
    # mixing matrix and on A = I (the round trip itself) ----
    from repro_torch.comm import accounting as acc
    sim_err = 0.0
    for m in (1, 4, 5, 16):
        a_m = torch.tensor(tp.metropolis_weights(tp.ring_graph(m)) if m > 1
                           else [[1.0]], dtype=torch.float32, device=dev)
        for bits in (8, 4):
            for chunk in (16, 64, 256, 960):
                d = chunk * 517         # the last slab of a block is ragged
                w = torch.randn((m, d), device=dev, generator=g)
                u = torch.rand((m, d), device=dev, generator=g)
                same, err = [], 0.0
                for a_ in (a_m, torch.eye(m, device=dev)):
                    got = ops.quantized_consensus_mix(a_, w, u, bits=bits,
                                                      chunk=chunk)
                    want = ref.quantized_consensus_mix_ref(
                        a_, w, u, bits=bits, chunk=chunk)
                    torch.cuda.synchronize()
                    same.append(torch.equal(got, want))
                    err = max(err, float((got - want).abs().max()))
                sim_err = max(sim_err, err)
                emit("sim_kernel_check", m=m, bits=bits, chunk=chunk, d=d,
                     identical=same, max_abs_err=err)
                assert all(same), (m, bits, chunk)
    del w, u, got, want
    torch.cuda.empty_cache()

    # ---- 18. the simulated wire's path: training with int8 compression on
    # the default wire, no error feedback ----
    m, t_s = SIM_TRAIN["servers"], SIM_TRAIN["t_server"]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with wire_period_disagreement(torch, cns, tree_leaves) as sim_periods:
        run = ttrain.train("smollm-360m", **SIM_TRAIN)
        torch.cuda.synchronize()
    sim_launches = ops.launch_counts()
    hist = run["history"]
    server_shapes = [(m,) + tuple(x.shape[2:])
                     for x in tree_leaves(run["state"].client_params)]
    n_leaves = len(server_shapes)
    per_epoch_norms = norms_per_step * client_steps // TRAIN["epochs"]

    def sim_expected(epochs, kernel4, mixes):
        return {"consensus_mix": mixes * epochs, "flash_attention": 0,
                "rmsnorm_fwd": per_epoch_norms * epochs,
                "rmsnorm_bwd": per_epoch_norms * epochs,
                SIM_KERNEL[0]: kernel4 * epochs, "ssd_scan": 0,
                **{k: 0 for k in WIRE_KERNELS},
                **{k: 0 for k in ROW_KERNELS}}

    # the ledger by host arithmetic: 8 live links of the 4-ring, T_S
    # messages each, of the closed-form payload of every leaf
    q8 = cp.StochasticQuantizer(bits=8, chunk=WIRE_CHUNK)
    row = sum(acc.analytic_leaf_bytes(q8, sh) for sh in server_shapes)
    links = 2 * m
    want_mb = float(links * t_s * row) / 1e6
    want_ratio = SMOLLM_PARAMS * 4 / row
    expected = sim_expected(SIM_TRAIN["epochs"], n_leaves, t_s - 1)
    emit("train_sim", arch="smollm-360m", compression="int8",
         wire="simulated", error_feedback=False, loss=hist["loss"],
         disagreement=hist["disagreement"], epoch_s=hist["epoch_s"],
         tokens_per_s=[tokens_per_epoch / t for t in hist["epoch_s"]],
         wire_mb=hist["wire_mb"], wire_ratio=hist["wire_ratio"],
         host_wire_mb=want_mb, host_wire_ratio=want_ratio,
         bytes_per_server_round=row, kernel4_launches_per_period=n_leaves,
         launches=sim_launches, expected_launches=expected,
         periods=sim_periods, sigma_a=tp.sigma_a(
             tp.metropolis_weights(tp.ring_graph(m)), t_s),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert row == SMOLLM_PARAMS + 4 * 2_029_828, row
    assert hist["wire_mb"] == [want_mb] * SIM_TRAIN["epochs"], hist
    assert hist["wire_ratio"] == [want_ratio] * SIM_TRAIN["epochs"], hist
    assert sim_launches == expected, sim_launches
    assert all(torch.isfinite(torch.tensor(v)) for v in hist["loss"]), hist
    assert len(sim_periods) == SIM_TRAIN["epochs"], sim_periods
    assert all(p["after"] < p["before"] for p in sim_periods), sim_periods

    # ---- 19. one simulated period at full size on the trained tree: the
    # period's launches and contraction, then kernel 4 (on A and on I)
    # against its plain version on whole-row slabs of every leaf ----
    server = tree_map(lambda x: x[:, 0].clone(), run["state"].client_params)
    del run
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(3)
    server = tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, device=dev, generator=gen), server)
    a_np = tp.metropolis_weights(tp.ring_graph(m))
    a = torch.tensor(a_np, dtype=torch.float32, device=dev)
    key = prng.key(13)
    leaves = tree_leaves(server)
    mean0, dis0 = stats(server)
    ops.reset_launch_counts()
    out = cns.make_backend("gossip", a_np, t_s,
                           compression="int8").mix_compressed(
                               server, key=key)[0]
    torch.cuda.synchronize()
    period_sim = ops.launch_counts()
    mean1, dis1 = stats(out)
    del out
    torch.cuda.empty_cache()
    slab_checks = 0
    for li, leaf in enumerate(leaves):
        k_i = prng.fold_in(key, li)
        n = leaf.shape[-1]
        rows = leaf[0].numel() // n
        kc = n if n <= WIRE_CHUNK else WIRE_CHUNK
        n_pad = -(-n // kc) * kc
        nr = max(1, SIM_SLAB // n)
        for a_ in (a, None):
            got = q8.mix(leaf, k_i, a_).reshape(m, rows, n)
            for r0 in sorted({0, max(0, rows - nr)}):
                r1 = min(rows, r0 + nr)
                x = torch.zeros((m, r1 - r0, n_pad), device=dev)
                x[..., :n] = leaf.reshape(m, rows, n)[:, r0:r1]
                u = torch.zeros_like(x)
                for srv in range(m):
                    prng.uniform(k_i, (r1 - r0, n), out=u[srv, :, :n],
                                 start=srv * rows * n + r0 * n)
                want = ref.quantized_consensus_mix_ref(
                    torch.eye(m, device=dev) if a_ is None else a_,
                    x.view(m, -1), u.view(m, -1), bits=8, chunk=kc)
                assert torch.equal(got[:, r0:r1], want.view(
                    m, r1 - r0, n_pad)[..., :n]), (li, r0, a_ is None)
                slab_checks += 1
            del got
    emit("sim_period_full_size", m=m, t_server=t_s, d=SMOLLM_PARAMS,
         leaves=n_leaves, launches=period_sim, slab_checks=slab_checks,
         slab_rows_elems=SIM_SLAB, identical=True,
         mean_max_abs_drift=max(float((p_ - q_).abs().max())
                                for p_, q_ in zip(mean0, mean1)),
         disagreement_before=dis0, disagreement_after=dis1,
         ratio=dis1 / dis0, sigma_a=tp.sigma_a(a_np, t_s))
    assert period_sim[SIM_KERNEL[0]] == n_leaves, period_sim
    assert period_sim["consensus_mix"] == t_s - 1, period_sim
    assert dis1 < dis0, (dis1, dis0)
    del mean0, mean1

    # ---- 20. where a simulated period's time goes, and kernel 4 at the
    # main path's shape (every leaf's launch, padded as the period pads it)
    # against its bound ----
    def padded(leaf):
        n = leaf.shape[-1]
        n_pad = -(-n // WIRE_CHUNK) * WIRE_CHUNK if n > WIRE_CHUNK else n
        x = leaf.reshape(-1, n)
        if n_pad != n:
            x = torch.nn.functional.pad(x, (0, n_pad - n))
        return x.view(m, -1), min(n, WIRE_CHUNK)

    def dither_all():
        for li, leaf in enumerate(leaves):
            prng.uniform(prng.fold_in(key, li), tuple(leaf.shape),
                         out=dith[li])

    dith = [torch.empty_like(x) for x in leaves]
    dither_ms = cuda_ms(torch, dither_all, reps=1, warmup=1)
    pad_ms = cuda_ms(torch, lambda: [padded(x) for x in leaves], reps=2,
                     warmup=1)
    del dith
    bufs = []
    for leaf in leaves:
        w_p, kc = padded(leaf)
        bufs.append((w_p, torch.rand(w_p.shape, device=dev, generator=g),
                     torch.empty_like(w_p), kc))
    d_pad = sum(b[0].shape[1] for b in bufs)

    def kernel4_period():
        for w_p, u_p, o_p, kc in bufs:
            ops.quantized_consensus_mix(a, w_p, u_p, bits=8, chunk=kc,
                                        out=o_p)

    k4 = alternate(torch, {"kernel": kernel4_period}, reps=5)
    rest_ms = cuda_ms(torch, lambda: ops.consensus_mix_pytree(
        a, server, rounds=t_s - 1), reps=1, warmup=1)
    slab_w = bufs[2][0][:, :SIM_SLAB].clone()
    slab_u = bufs[2][1][:, :SIM_SLAB].clone()
    sim_plain_ms = cuda_ms(torch, lambda: ref.quantized_consensus_mix_ref(
        a, slab_w, slab_u, bits=8, chunk=WIRE_CHUNK), reps=3)
    k4_bytes = 12 * m * d_pad + n_leaves * m * m * 4
    k4_ops = 2 * m * m * d_pad + 4 * m * d_pad
    k4_bound, k4_by = bound_ms(k4_bytes, k4_ops)
    emit("sim_breakdown", m=m, d=SMOLLM_PARAMS, d_pad=d_pad,
         dither_ms=dither_ms, pad_copies_ms=pad_ms,
         kernel4_ms=k4["kernel"], kernel1_rounds_ms=rest_ms,
         per_period={"dither": 1, "pad_copies": 1,
                     SIM_KERNEL[0]: n_leaves, "consensus_mix": t_s - 1})
    emit("sim_main_shape", kernel=SIM_KERNEL[0], m=m, d_pad=d_pad,
         launches=n_leaves, chunk=WIRE_CHUNK, kernel_ms=k4["kernel"],
         bound_ms=k4_bound, bound_by=k4_by, bytes=k4_bytes,
         kernel_GBps=k4_bytes / k4["kernel"] / 1e6,
         bound_share=k4_bound / k4["kernel"], plain_ms=sim_plain_ms,
         plain_shape=[m, SIM_SLAB], library_ms=None,
         ptxas=[line.strip() for line in _build.build_logs.get(
             "quantized_mix", "").splitlines()
             if "Used" in line or "spill" in line])
    del bufs, slab_w, slab_u, server, leaves
    torch.cuda.empty_cache()

    # ---- 21. the simulated wire with error feedback (int4), then top-k and
    # random-k with error feedback: one epoch each ----
    ops.reset_launch_counts()
    with wire_period_disagreement(torch, cns, tree_leaves) as ef_periods:
        run = ttrain.train("smollm-360m", **{**SIM_TRAIN, "epochs": 1,
                                             "compression": "int4",
                                             "error_feedback": True})
        torch.cuda.synchronize()
    ef_launches = ops.launch_counts()
    hist = run["history"]
    expected = sim_expected(1, n_leaves, t_s)
    emit("train_sim_ef", compression="int4", error_feedback=True,
         loss=hist["loss"], epoch_s=hist["epoch_s"],
         tokens_per_s=[tokens_per_epoch / t for t in hist["epoch_s"]],
         wire_mb=hist["wire_mb"], wire_ratio=hist["wire_ratio"],
         periods=ef_periods, launches=ef_launches,
         expected_launches=expected)
    assert ef_launches == expected, ef_launches
    assert all(torch.isfinite(torch.tensor(v)) for v in hist["loss"]), hist
    assert ef_periods[0]["after"] < ef_periods[0]["before"], ef_periods
    del run
    torch.cuda.empty_cache()
    for spec in ("top_k:0.05", "random_k:0.05"):
        ops.reset_launch_counts()
        run = ttrain.train("smollm-360m", **{**SIM_TRAIN, "epochs": 1,
                                             "compression": spec,
                                             "error_feedback": True})
        torch.cuda.synchronize()
        sparse_launches = ops.launch_counts()
        hist = run["history"]
        expected = sim_expected(1, 0, t_s)
        emit("train_sim_sparse", compression=spec, error_feedback=True,
             loss=hist["loss"], epoch_s=hist["epoch_s"],
             wire_mb=hist["wire_mb"], wire_ratio=hist["wire_ratio"],
             launches=sparse_launches, expected_launches=expected)
        assert sparse_launches == expected, sparse_launches
        assert all(torch.isfinite(torch.tensor(v)) for v in hist["loss"])
        del run
        torch.cuda.empty_cache()

    # ---- 22. Mamba-2 serving: kernel 9, then full Mamba2-780M ----
    ssd_row = mamba_serving(torch, g, SERVE)

    # ---- 22b. the dense zoo families: kernel 1's bf16 instance and kernel
    # 3's new modes against their plain versions, bf16 leaves through
    # Algorithm 1 and the wires, then four serving paths ----
    zoo_rows = zoo_kernel_checks(torch, g)
    zoo_rows["consensus_mix_bf16"]["launches"] = bf16_training(
        torch, ttrain, ops)
    zoo_serving(torch, g, zoo_rows)

    # ---- 22c. the MoE and MLA families: kernel 9 on bf16 at Jamba's
    # shape, then Mixtral-8x22B, DeepSeek-V2 and Jamba-1.5-Large serving at
    # full width and a cut depth ----
    ssd_bf16_row = ssd_bf16_check(torch, g)
    moe_serving(torch, g, zoo_rows, ssd_bf16_row)
    zoo_rows["ssd_scan_bf16_jamba"] = ssd_bf16_row
    assert all("launches" in r and r["launches"] > 0
               for r in zoo_rows.values()), zoo_rows

    # ---- 22d. Algorithm 1 training full Mamba2-780M and a one-layer
    # Mixtral-8x22B; directed federation (push-sum) on full SmolLM-360M:
    # static, one full-size period, both wires, dynamic ----
    family_training(torch, ttrain, ops, set(rn_stats))
    zoo_rows["consensus_mix_push_sum"] = directed_federation(
        torch, ttrain, ops, set(rn_stats))

    # ---- 22e. robust gossip under the Byzantine injection on full
    # SmolLM-360M (trimmed mean, median, clipped; kernel 1 under clipped
    # gossip's C), one full-size robust period, then checkpointing with
    # drop surgery ----
    robust = robust_federation(torch, ttrain, ops, set(rn_stats))
    clipped_row = robust_period_full_size(torch)
    clipped_row["launches"] = robust["clipped_launches"]
    zoo_rows["consensus_mix_clipped"] = clipped_row
    ckpt_roundtrip(torch, ttrain)

    # ---- 22f. observability: the dynamic cell traced against OBS_OFF, the
    # replay estimate against CUDA events in the step, the physical wire's
    # probe, the superepoch against K = 1, the static trainer's files ----
    observability(torch, ttrain, ops, cns, smi)

    # ---- 22g. the multi-process wire: the row forms of kernels 1, 7 and 8,
    # then a world of four gloo ranks on this card (one server each)
    # training full SmolLM-360M on the physical wire at staleness 0 and 1,
    # uncompressed, dynamic and push-sum, each held to the one-process run;
    # then the trainer under torch.distributed.run ----
    row_rows = shard_map_phases(torch, ttrain, ops, ref, tp, smi, g)

    # ---- 23. per-kernel summary, card, result ----
    r256 = rn_stats[(256, 960, "float32")]
    kernels = [
        {"name": "consensus_mix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/consensus_mix.cu",
         "replaces": "src/repro/kernels/consensus_mix.py:71",
         "launches": launches["consensus_mix"], "max_abs_err": cm_err,
         "ms": cm_times["kernel"], "plain_ms": cm_times["plain"],
         "bound_ms": cm_bound, "bound_by": cm_by,
         "library_ms": cm_times["library"]},
        {"name": "rmsnorm_fwd", "route": "cuda", "source": RMSNORM_SOURCE,
         "replaces": "src/repro/kernels/rmsnorm.py:28",
         "launches": launches["rmsnorm_fwd"], "max_abs_err": r256["fwd_err"],
         "ms": r256["fwd"]["kernel"], "plain_ms": r256["fwd"]["plain"],
         "bound_ms": r256["fwd_bound"], "bound_by": r256["fwd_by"],
         "library_ms": r256["fwd"]["library"]},
        {"name": "rmsnorm_bwd", "route": "cuda", "source": RMSNORM_SOURCE,
         "replaces": "src/repro/kernels/rmsnorm.py:28",
         "launches": launches["rmsnorm_bwd"], "max_abs_err": r256["bwd_err"],
         "ms": r256["bwd"]["kernel"], "plain_ms": r256["bwd"]["plain"],
         "bound_ms": r256["bwd_bound"], "bound_by": r256["bwd_by"],
         "library_ms": r256["bwd"]["library"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:118",
         "launches": serve_launches["flash_attention"], "max_abs_err": fa_err,
         "ms": fa_times["kernel"], "plain_ms": fa_times["plain"],
         "bound_ms": fa_bound, "bound_by": fa_by,
         "library_ms": fa_times["library"]},
    ]
    # launches: kernels 6 and 7 from the wire training path, kernel 8 from
    # its staleness-1 epoch, kernel 5 from the per-leaf period
    wire_path_launches = {
        "quantized_gossip_encode": wire_launches,
        "bucketed_gossip_round": wire_launches,
        "bucketed_gossip_round_pipelined": stale_launches,
        "quantized_gossip_round": period_launches["per_leaf"]}
    for name, replaces in WIRE_KERNELS.items():
        t = wire_times[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/quantized_wire.cu",
             "replaces": replaces,
             "launches": wire_path_launches[name][name],
             "max_abs_err": t["max_abs_err"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": None})
    kernels.append(
        {"name": SIM_KERNEL[0], "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantized_mix.cu",
         "replaces": SIM_KERNEL[1],
         "launches": sim_launches[SIM_KERNEL[0]], "max_abs_err": sim_err,
         "ms": k4["kernel"], "plain_ms": sim_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None})
    kernels.append(ssd_row)
    kernels.extend(zoo_rows.values())
    for name, (source, replaces) in ROW_KERNELS.items():
        r = row_rows[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": r["launches"],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
