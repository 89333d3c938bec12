"""Architecture configs of the port: ``get_arch`` / ``get_smoke`` by id.

Only the archs whose model the port runs are registered: the dense GQA path
(``qwen3_1_7b``, ``smollm_360m``, ``gemma2_27b``, ``command_r_35b``), the
Mamba-2 path (``mamba2_780m``), the vision-patch frontend
(``internvl2_1b``) and the encoder-decoder (``seamless_m4t_large_v2``).
The MoE and MLA archs (``mixtral_8x22b``, ``deepseek_v2_236b``, the
``jamba_1_5_large_398b`` hybrid) are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import (command_r_35b, gemma2_27b, internvl2_1b,
                                 mamba2_780m, qwen3_1_7b,
                                 seamless_m4t_large_v2, smollm_360m)
from repro_torch.configs.base import ArchConfig

_ARCHS = {"command_r_35b": command_r_35b, "gemma2_27b": gemma2_27b,
          "internvl2_1b": internvl2_1b, "mamba2_780m": mamba2_780m,
          "qwen3_1_7b": qwen3_1_7b,
          "seamless_m4t_large_v2": seamless_m4t_large_v2,
          "smollm_360m": smollm_360m}
_LATER = {"mixtral_8x22b": "MoE", "deepseek_v2_236b": "MLA",
          "jamba_1_5_large_398b": "MoE (the Jamba hybrid's)"}


def _module(arch_id: str):
    key = arch_id.replace("-", "_").replace(".", "_")
    if key not in _ARCHS:
        block = _LATER.get(key)
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (the port has "
            f"{sorted(_ARCHS)})"
            + (f": its {block} blocks" if block else "")
            + "; MoE, MLA and the Jamba hybrid are later slices of "
            "ROADMAP.md Queue 1")
    return _ARCHS[key]


def get_arch(arch_id: str) -> ArchConfig:
    """The published-size config (``CONFIG``) of ``arch_id`` (dashes ok)."""
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    """The reduced CPU-test member of ``arch_id``'s family."""
    return _module(arch_id).smoke_config()


__all__ = ["ArchConfig", "get_arch", "get_smoke"]
