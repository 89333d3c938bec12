"""The port's kernels, in three layers as in ``repro.kernels``:

* the Hopper kernels, CUDA C++ built by ``_build`` with nvcc and bound
  with ctypes: ``csrc/consensus_mix.cu``, the simulated wire's
  ``csrc/quantized_mix.cu`` and the physical wire's
  ``csrc/quantized_wire.cu`` (wrapped in ``consensus_mix.py``),
  ``csrc/rmsnorm.cu`` (wrapped in ``rmsnorm.py``),
  ``csrc/flash_attention.cu`` (wrapped in ``flash_attention.py``) and
  ``csrc/ssd_scan.cu`` (wrapped in ``ssd_scan.py``);
* ``ops``, which launches them for CUDA tensors and runs the plain
  versions for CPU tensors;
* ``ref``, the plain PyTorch versions.

The public entry points are in ``repro_torch.kernels.ops``; this package
re-exports nothing, so ``repro_torch.kernels.rmsnorm`` and
``repro_torch.kernels.consensus_mix`` name the kernel modules.
"""
