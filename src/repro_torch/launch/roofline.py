"""Roofline terms of a dry-run record on H100 constants (port of
``repro.launch.roofline``).

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = bytes / HBM_bw                 (per device)
    collective term = collective_bytes / link_bw     (per device)

The analytic terms (``analytic_terms``) use the reference's formulas.  The
collective bytes come from the port's own collective record
(``consensus.collective_counts()``: calls and bytes sent per
``"op:dtype"``) in place of the reference's HLO parser, with all-reduce
weighted x2 as there (a ring all-reduce moves 2(n-1)/n ~ 2 bytes per
reduced byte).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 SXM5 80 GB, per GPU, from the datasheet (not measured here)
H100_PEAK_BF16 = 989e12     # FLOP/s, bf16 dense tensor core
H100_PEAK_F32 = 67e12       # FLOP/s, f32 (TF32 off)
H100_HBM_BW = 3.35e12       # bytes/s, HBM3
H100_HBM_BYTES = 80e9       # bytes of HBM
# the inter-server link a GPU owns: one NDR InfiniBand port, 400 Gb/s, one
# direction
H100_LINK_BW = 50e9         # bytes/s

PEAK_FLOPS = H100_PEAK_BF16
HBM_BW = H100_HBM_BW
LINK_BW = H100_LINK_BW

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the port's collective helpers -> the reference's HLO kinds
_OP_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "ring_exchange": "collective-permute"}


def peak_flops(dtype: Optional[str]) -> float:
    """The peak rate of the plan's dtype ("bfloat16" or "float32")."""
    return H100_PEAK_BF16 if dtype == "bfloat16" else H100_PEAK_F32


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_bytes(counts: Dict) -> CollectiveStats:
    """Per-device collective traffic from a ``collective_counts()`` record
    (``{"calls": {"op:dtype": n}, "bytes": {"op:dtype": b}, ...}``), by the
    reference's kinds; all-reduce bytes x2."""
    bytes_by_kind = {k: 0 for k in _COLL_KINDS}
    count_by_kind = {k: 0 for k in _COLL_KINDS}
    for key, n in counts.get("calls", {}).items():
        op = key.split(":", 1)[0]
        kind = _OP_KIND.get(op)
        if kind is None:
            raise ValueError(f"unknown collective {key!r}")
        b = int(counts.get("bytes", {}).get(key, 0))
        bytes_by_kind[kind] += 2 * b if kind == "all-reduce" else b
        count_by_kind[kind] += int(n)
    return CollectiveStats(bytes_by_kind, count_by_kind)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # analytic terms (the roofline): see ``analytic_terms`` for formulas
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float               # 6ND (train) / 2ND (serve), N = active
    analytic_bytes_per_device: float
    collective_bytes_per_device: float
    # the device program's own FLOPs (``FlopCounterMode`` on meta) and its
    # arguments' bytes, per device
    program_flops_per_device: float
    program_bytes_per_device: float
    useful_ratio: float              # model_flops / (program_flops x chips)
    bytes_per_device_peak: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def row(self) -> Dict:
        return dataclasses.asdict(self) | {"dominant": self.dominant}


def _cache_bytes(cfg, batch: int, seq: int) -> float:
    """Decode-cache bytes (bf16) for one full forward state."""
    total = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.pattern_for_layer(i)
        if kind == "mamba":
            m = cfg.mamba
            d_in = m.d_inner(cfg.d_model)
            total += batch * (m.num_heads(cfg.d_model) * m.d_state *
                              m.head_dim * 4 +           # ssm state f32
                              (m.d_conv - 1) * (d_in + 2 * m.d_state) * 2)
        elif cfg.mla is not None:
            m = cfg.mla
            total += batch * seq * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
        else:
            n = seq
            if kind == "local" and cfg.sliding_window:
                n = min(seq, cfg.sliding_window)
            total += 2 * batch * n * cfg.num_kv_heads * \
                cfg.resolved_head_dim() * 2
    return total


def analytic_terms(meta: Dict, chips: int) -> Dict[str, float]:
    """Napkin-math compute/memory terms (per device, seconds), the
    reference's formulas on H100 constants; the peak follows
    ``meta["dtype"]``.

    compute: MODEL_FLOPS / chips / peak, MODEL_FLOPS = 6*N_active*tokens for
    training (fwd+bwd) and 2*N_active*tokens for inference.

    memory (per device):
      train   T_C * (3*n_micro + 2) * P_dev   (per local step: read params +
              read/write grad per microbatch, + update read/write)
              + 2 * T_S * P_dev               (gossip read+write per round)
              + A                             (activation traffic, ~12 bytes
                                               per token-dim per layer,
                                               fwd+bwd with remat)
      prefill P_dev + A + cache write
      decode  P_dev + cache read              (the classic decode bound)
    """
    from repro_torch.configs import get_arch            # local import: cycle
    cfg = get_arch(meta["arch"])
    active = meta.get("active_params", meta.get("params", 0))
    shape = meta["shape"]
    dtype_b = 2 if meta.get("dtype") == "bfloat16" else 4

    if shape == "train_4k":
        m, n, r, tp = meta["M"], meta["N"], meta["R"], meta["TP"]
        tokens = meta["t_client"] * m * n * meta["per_client_batch"] * 4096
        flops = 6.0 * active * tokens
        p_dev = meta["params"] * dtype_b / (max(r, 1) * tp)
        n_micro = meta.get("grad_microbatches", 1)
        tokens_dev = tokens / (m * n * max(r, 1) * tp)
        act = tokens_dev * cfg.d_model * cfg.num_layers * 12 * dtype_b
        mem = (meta["t_client"] * (3 * n_micro + 2) * p_dev
               + 2 * meta["t_server"] * p_dev + act)
    elif shape == "prefill_32k":
        tokens = meta["batch"] * meta["seq"]
        flops = 2.0 * active * tokens
        shards = chips if meta.get("serve_fsdp") else 16
        p_dev = meta["params"] * 2 / shards
        tokens_dev = tokens / chips
        act = tokens_dev * cfg.d_model * cfg.num_layers * 6 * 2
        cache = _cache_bytes(cfg, meta["batch"], meta["seq"]) / chips
        mem = p_dev + act + cache
    else:                                   # decode (one token)
        tokens = meta["batch"]
        flops = 2.0 * active * tokens
        shards = chips if meta.get("serve_fsdp") else 16
        p_dev = meta["params"] * 2 / shards
        cache = _cache_bytes(cfg, meta["batch"], meta["cache_len"]) / chips
        mem = p_dev + cache
    return {"model_flops": flops,
            "compute_s": flops / chips / peak_flops(meta.get("dtype")),
            "mem_bytes_dev": mem,
            "memory_s": mem / HBM_BW}


def roofline(meta: Dict, chips: int, cost: Dict, coll: CollectiveStats,
             peak_bytes: Optional[float] = None) -> RooflineReport:
    """``cost``: the device program's ``{"flops", "bytes accessed"}``."""
    prog_flops = float(cost.get("flops", 0.0))
    prog_bytes = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(coll.total_bytes)
    terms = analytic_terms(meta, chips)
    return RooflineReport(
        arch=meta["arch"], shape=meta["shape"],
        mesh="multi_pod" if meta.get("multi_pod") else "single_pod",
        chips=chips,
        compute_s=terms["compute_s"],
        memory_s=terms["memory_s"],
        collective_s=coll_dev / LINK_BW,
        model_flops=terms["model_flops"],
        analytic_bytes_per_device=terms["mem_bytes_dev"],
        collective_bytes_per_device=coll_dev,
        program_flops_per_device=prog_flops,
        program_bytes_per_device=prog_bytes,
        useful_ratio=(terms["model_flops"] / (prog_flops * chips)
                      if prog_flops else 0.0),
        bytes_per_device_peak=peak_bytes)
