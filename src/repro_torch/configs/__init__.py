"""Architecture configs of the port: ``get_arch`` / ``get_smoke`` by id.

Every arch of the reference is registered: the dense GQA path
(``qwen3_1_7b``, ``smollm_360m``, ``gemma2_27b``, ``command_r_35b``), the
Mamba-2 path (``mamba2_780m``), the vision-patch frontend
(``internvl2_1b``), the encoder-decoder (``seamless_m4t_large_v2``), the
MoE (``mixtral_8x22b``), MLA with a dense prefix layer and shared experts
(``deepseek_v2_236b``) and the Mamba/attention/MoE hybrid
(``jamba_1_5_large_398b``).
"""
from __future__ import annotations

from repro_torch.configs import (command_r_35b, deepseek_v2_236b, gemma2_27b,
                                 internvl2_1b, jamba_1_5_large_398b,
                                 mamba2_780m, mixtral_8x22b, qwen3_1_7b,
                                 seamless_m4t_large_v2, smollm_360m)
from repro_torch.configs.base import ArchConfig

_ARCHS = {"command_r_35b": command_r_35b,
          "deepseek_v2_236b": deepseek_v2_236b, "gemma2_27b": gemma2_27b,
          "internvl2_1b": internvl2_1b,
          "jamba_1_5_large_398b": jamba_1_5_large_398b,
          "mamba2_780m": mamba2_780m, "mixtral_8x22b": mixtral_8x22b,
          "qwen3_1_7b": qwen3_1_7b,
          "seamless_m4t_large_v2": seamless_m4t_large_v2,
          "smollm_360m": smollm_360m}

#: every registered arch id, in the reference's ``ARCH_IDS`` spelling
ARCH_IDS = tuple(sorted(_ARCHS))


def _module(arch_id: str):
    key = arch_id.replace("-", "_").replace(".", "_")
    if key not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (the port has "
                       f"{sorted(_ARCHS)})")
    return _ARCHS[key]


def get_arch(arch_id: str) -> ArchConfig:
    """The published-size config (``CONFIG``) of ``arch_id`` (dashes ok)."""
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    """The reduced CPU-test member of ``arch_id``'s family."""
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "ArchConfig", "get_arch", "get_smoke"]
