"""PyTorch/CUDA port of the DFL reproduction (Algorithm 1 on an NVIDIA H100).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.core.dfl`` <-> ``repro.core.dfl``) and keeps the same
pytree key paths, so parameters carry across as numpy arrays
(``repro_torch.models.transformer.params_from_numpy``).  It imports neither
``jax`` nor anything of ``repro``.

Kernels live in ``repro_torch.kernels``: each wrapper launches its Hopper
kernel for a CUDA tensor and uses its plain PyTorch version for a CPU
tensor — never a silent fallback on the card.
"""
