"""The port's kernels, in three layers as in ``repro.kernels``:

* the Hopper kernels: ``csrc/consensus_mix.cu`` and the physical wire's
  ``csrc/quantized_wire.cu`` (CUDA C++, built by ``_build`` with nvcc and
  bound with ctypes, wrapped in ``consensus_mix.py``),
  ``csrc/flash_attention.cu`` (wrapped in ``flash_attention.py``),
  ``csrc/ssd_scan.cu`` (wrapped in ``ssd_scan.py``) and the Triton RMSNorm
  in ``rmsnorm.py``;
* ``ops``, which launches them for CUDA tensors and runs the plain
  versions for CPU tensors;
* ``ref``, the plain PyTorch versions.

The public entry points are in ``repro_torch.kernels.ops``; this package
re-exports nothing, so ``repro_torch.kernels.rmsnorm`` and
``repro_torch.kernels.consensus_mix`` name the kernel modules.
"""
