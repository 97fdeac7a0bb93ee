"""K3: the alpha lattice recursion as a hand-written CUDA kernel.

Replaces ``rnnt_tpu/ops/lattice_pallas.py:120`` ``_alpha_kernel`` (launcher
``_alpha_pallas:170``, call ``:178``).  The module keeps the reference's
name so the two packages line up file by file; the kernel is CUDA C++ in
``csrc/alpha_fwd.cu``, built for sm_90a by ``ops/kernels.py``.

Bound on an H100: latency.  At the eval shape (B 4, T' 504, U+1 65) the
kernel reads and writes ~1.6 MB — 0.5 us at 3.35 TB/s — but runs 504
dependent rows, each a log-semiring scan over U.  The design (one warp per
sample, shuffle scans, the next row prefetched into registers) keeps each
row's latency to a few hundred cycles; see the source for details.

``alpha_plain`` beside it is the same function in plain PyTorch (the CPU
path and the card-side yardstick).  ``alpha_forward`` takes the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises.  ``K3.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from rnnt_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor, ptr
from rnnt_tpu_torch.ops.transducer import final_nll, transducer_alpha

_P = ctypes.c_void_p
_I = ctypes.c_int
K3 = CudaKernel(
    "alpha_fwd", "rnnt_alpha_fwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel")
U_MAX = 1024


def alpha_plain(lp_blank, lp_label, t_lens, u_lens):
    """(nll (B,), alpha (B, T, U)) in plain PyTorch, float32."""
    alphas = transducer_alpha(lp_blank, lp_label)
    return final_nll(alphas, lp_blank, t_lens, u_lens), alphas


def alpha_forward(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                  t_lens: torch.Tensor, u_lens: torch.Tensor):
    """(nll (B,), alpha (B, T, U)).  lp_blank/lp_label (B, T, U) float32
    with lp_label NEG at u >= u_len; t_lens/u_lens (B,) int32 with
    1 <= t_len <= T and 0 <= u_len < U."""
    if lp_blank.device.type == "cpu":
        return alpha_plain(lp_blank, lp_label, t_lens, u_lens)
    if lp_blank.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or the CPU, got {lp_blank.device}")
    B, T, U = lp_blank.shape
    dev = lp_blank.device
    check_cuda_tensor("lp_blank", lp_blank, torch.float32, (B, T, U), dev)
    check_cuda_tensor("lp_label", lp_label, torch.float32, (B, T, U), dev)
    check_cuda_tensor("t_lens", t_lens, torch.int32, (B,), dev)
    check_cuda_tensor("u_lens", u_lens, torch.int32, (B,), dev)
    if U > U_MAX:
        raise ValueError(f"K3 takes U <= {U_MAX}, got {U}")
    alphas = torch.empty_like(lp_blank)
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    K3.launch(ptr(lp_blank), ptr(lp_label), ptr(t_lens), ptr(u_lens),
              ptr(alphas), ptr(nll), B, T, U)
    return nll, alphas


def transducer_alpha_loss_fast(lp_blank, lp_label, t_lens, u_lens):
    """Per-sample negative log-likelihood (B,) — same contract as
    ``transducer_alpha_loss``."""
    return alpha_forward(lp_blank, lp_label, t_lens, u_lens)[0]
