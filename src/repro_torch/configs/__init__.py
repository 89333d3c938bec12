"""Architecture configs of the port: ``get_arch`` / ``get_smoke`` by id.

Only the archs whose model the port runs are registered: the dense GQA path
(``qwen3_1_7b``, ``smollm_360m``) and the Mamba-2 path (``mamba2_780m``).
Archs with MoE, MLA, an encoder-decoder or a frontend are not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import mamba2_780m, qwen3_1_7b, smollm_360m
from repro_torch.configs.base import ArchConfig

_ARCHS = {"mamba2_780m": mamba2_780m, "qwen3_1_7b": qwen3_1_7b,
          "smollm_360m": smollm_360m}


def _module(arch_id: str):
    key = arch_id.replace("-", "_").replace(".", "_")
    if key not in _ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (the port has "
            f"{sorted(_ARCHS)}); MoE, MLA, encoder-decoder and frontend "
            f"archs are later slices of ROADMAP.md Queue 1")
    return _ARCHS[key]


def get_arch(arch_id: str) -> ArchConfig:
    """The published-size config (``CONFIG``) of ``arch_id`` (dashes ok)."""
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    """The reduced CPU-test member of ``arch_id``'s family."""
    return _module(arch_id).smoke_config()


__all__ = ["ArchConfig", "get_arch", "get_smoke"]
