"""Per-architecture deployment plans (port of ``repro.launch.plans``).

The paper's protocol requires each client to hold a full model copy; on a
16 GB-HBM v5e that forces a per-arch trade between the number of FL clients
(M*N) and the intra-client shard degree (R*TP):

    bytes/device ~= param_bytes / (R * TP)   (+ grads of the same size
                    + remat'd activations)

Small archs use the paper-like M=4, N=4 (16 clients); the 100B+ archs scale
clients down and FSDP up (M=2, N=1, R=8..16).  dtype is bf16 for the big
archs (mixed-precision deployment; the paper's SGD is stateless so there is
no optimizer-moment memory either way) and f32 for the small ones (matches
the theory-faithful configuration).

``plan_for(arch)`` is the single lookup the launcher uses.

The numbers (M, N, R, TP, T_S, microbatches, compression, wire) are the
reference's, sized for a 16 GB v5e, unchanged; on an 80 GB H100 they fit
with room to spare.  ``dtype()`` / ``serve_dtype()`` return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.launch.mesh import FLMeshSpec


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    arch_id: str
    # FL refinement of the replica axes (train_4k / the DFL epoch step)
    single_pod: FLMeshSpec
    multi_pod: FLMeshSpec
    param_dtype: str = "float32"      # "float32" | "bfloat16"
    # per-client microbatch is derived: global_batch / (M*N)
    t_client_dry: int = 2             # local steps of the dry-run program
    t_server: int = 25                # the paper's T_S
    # Archs whose head count does not divide the 16-wide "model" axis
    # (smollm: 15 heads, internvl: 14) use the model axis as intra-client
    # data parallelism instead of TP: weights replicate, the per-client
    # batch shards 16-way.
    batch_over_model: bool = False
    # Gradient-accumulation microbatches per local step (DFLConfig pass-
    # through).
    grad_microbatches: int = 1
    # Serving: 2-D (data x model) weight sharding for the big models; the
    # small ones replicate over "data".
    serve_fsdp: bool = False
    # Megatron-SP on/off for the train / serve programs (None = auto).  The
    # reference chose these on its own hardware; the port records them and
    # runs a client's layers whole (see ``launch.specs``).
    seq_parallel: Optional[bool] = None
    serve_seq_parallel: Optional[bool] = None
    # Consensus execution path for the train shape (an explicit
    # build_train_program(consensus_mode=...) overrides):
    # "gossip_shardmap" = the rank-local program over the mesh's server
    # axis (consensus.ShardMapBackend), "gossip_blocked" = blocked
    # streaming, "gossip" = per-leaf.
    consensus_backend: str = "gossip_shardmap"
    # Inter-server message compression for the train shape
    # (DFLConfig.compression).  Gossip cost is pure inter-server bandwidth,
    # one full replica per live edge per round, so the 140-400B archs
    # default to int8 with error feedback; the small and mid archs keep the
    # exact paper protocol.
    compression: str = "none"
    error_feedback: bool = False
    # Where the compression happens (DFLConfig.wire).  The 140-400B archs
    # run wire="physical": the int8 codes and per-chunk scales are the
    # literal all-gather operands.  "simulated" wherever the wire is exact
    # anyway (compression="none").
    wire: str = "simulated"

    def serve_dtype(self):
        return torch.bfloat16        # deployment dtype for all archs

    def fl_spec(self, multi_pod: bool) -> FLMeshSpec:
        return self.multi_pod if multi_pod else self.single_pod

    def dtype(self):
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)


_SMALL_SP = FLMeshSpec(num_servers=4, clients_per_server=4, fsdp=1, tp=16)
_SMALL_MP = FLMeshSpec(num_servers=4, clients_per_server=8, fsdp=1, tp=16)
_MID_SP = FLMeshSpec(num_servers=2, clients_per_server=2, fsdp=4, tp=16)
_MID_MP = FLMeshSpec(num_servers=2, clients_per_server=4, fsdp=4, tp=16)
_BIG_SP = FLMeshSpec(num_servers=2, clients_per_server=1, fsdp=8, tp=16)
_BIG_MP = FLMeshSpec(num_servers=2, clients_per_server=1, fsdp=16, tp=16)

PLANS: Dict[str, DeploymentPlan] = {
    # ~0.4-2B: plenty of room -> paper-like 16 clients, f32
    "smollm_360m": DeploymentPlan("smollm_360m", _SMALL_SP, _SMALL_MP,
                                  batch_over_model=True),
    "qwen3_1_7b": DeploymentPlan("qwen3_1_7b", _SMALL_SP, _SMALL_MP),
    "mamba2_780m": DeploymentPlan("mamba2_780m", _SMALL_SP, _SMALL_MP),
    "internvl2_1b": DeploymentPlan("internvl2_1b", _SMALL_SP, _SMALL_MP,
                                   batch_over_model=True),
    "seamless_m4t_large_v2": DeploymentPlan("seamless_m4t_large_v2",
                                            _SMALL_SP, _SMALL_MP),
    # ~27-35B: bf16 + R=2 (1.7-1.9 GB params/device)
    "gemma2_27b": DeploymentPlan("gemma2_27b", _MID_SP, _MID_MP,
                                 param_dtype="bfloat16",
                                 grad_microbatches=8, serve_fsdp=True),
    "command_r_35b": DeploymentPlan("command_r_35b", _MID_SP, _MID_MP,
                                    param_dtype="bfloat16",
                                    grad_microbatches=16, serve_fsdp=True,
                                    seq_parallel=False),
    # 140-400B: bf16 + R=8/16, 2 servers x 1 client (the scalability edge
    # case: DFL still applies — consensus over M=2 is one gossip edge)
    "mixtral_8x22b": DeploymentPlan("mixtral_8x22b", _BIG_SP, _BIG_MP,
                                    param_dtype="bfloat16",
                                    grad_microbatches=16, serve_fsdp=True,
                                    serve_seq_parallel=False,
                                    compression="int8", error_feedback=True,
                                    wire="physical"),
    "deepseek_v2_236b": DeploymentPlan("deepseek_v2_236b", _BIG_SP, _BIG_MP,
                                       param_dtype="bfloat16",
                                       grad_microbatches=16, serve_fsdp=True,
                                       compression="int8",
                                       error_feedback=True,
                                       wire="physical"),
    "jamba_1_5_large_398b": DeploymentPlan("jamba_1_5_large_398b", _BIG_SP,
                                           _BIG_MP, param_dtype="bfloat16",
                                           grad_microbatches=16, serve_fsdp=True,
                                           seq_parallel=False,
                                           serve_seq_parallel=False,
                                           compression="int8",
                                           error_feedback=True,
                                           wire="physical"),
}


def plan_for(arch_id: str) -> DeploymentPlan:
    return PLANS[arch_id.replace("-", "_").replace(".", "_")]
