"""rnnt_tpu_torch: the PyTorch / CUDA port of rnnt_tpu for NVIDIA Hopper.

Same layout as ``rnnt_tpu`` (ops, models, data, decode, train, config, cli,
compat), held against it by tests that feed both packages the same inputs
and weights.  Hand-written CUDA kernels live in ``csrc/`` and are built
with nvcc at first use (``ops/kernels.py``).  Entry points run on CUDA
unless the caller asks for the CPU; they never fall back quietly.

This package imports torch and never jax, and nothing of ``rnnt_tpu``.
"""

from rnnt_tpu_torch.utils import resolve_device

__all__ = ["resolve_device"]
