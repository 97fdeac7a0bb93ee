"""K5: the arbitrary-start window gather as a hand-written CUDA kernel, and
the banded two-tap interpolation the device augmentation builds on it.

K5 replaces ``rnnt_tpu/ops/window_gather.py:38`` ``_window_kernel``
(launcher ``_gather_windows_impl:60``, call ``:73``); the kernel is CUDA
C++ in ``csrc/window_gather.cu``, built for sm_90a by ``ops/kernels.py``.
Every consumer (chorus taps, resample blocks, trim blocks, phase-vocoder
frames in ``data/augment_device.py``) reads short contiguous windows at
arbitrary per-window starts.

Bound on an H100: bytes — the output written once plus x and the starts
read once (~18 MB written per device-augmented step at the flagship
shapes, a few microseconds at 3.35 TB/s).

``gather_windows_plain`` is the same function in plain PyTorch (zero pad,
index, ``torch.gather``): the CPU path and the card-side yardstick.
``gather_windows`` takes it only for CPU tensors; for CUDA tensors it
launches K5 or raises.  ``K5.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rnnt_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
K5 = CudaKernel(
    "window_gather", "rnnt_window_gather", [_P, _P, _P, _I, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/window_gather.py:38 _window_kernel")


def _check_width(width: int) -> None:
    if width % 128 != 0 or width <= 0:
        raise ValueError(f"width must be a multiple of 128, got {width}")


def gather_windows_plain(x: torch.Tensor, starts: torch.Tensor,
                         width: int) -> torch.Tensor:
    """``gather_windows`` in plain PyTorch: x zero-padded by ``width``, the
    clipped starts plus ``arange(width)`` as a (B, N * width) index, one
    ``torch.gather``."""
    _check_width(width)
    B, L = x.shape
    xp = F.pad(x.float(), (0, width))
    k = torch.arange(width, device=x.device)
    idx = starts.long().clamp(0, L - 1)[:, :, None] + k
    return torch.gather(xp, 1, idx.reshape(B, -1)).reshape(B, -1, width)


def gather_windows(x: torch.Tensor, starts: torch.Tensor,
                   width: int) -> torch.Tensor:
    """out[b, n, k] = x[b, starts[b, n] + k] for k in [0, width), (B, N,
    width) float32.

    x (B, L) float32; starts (B, N) int32, clipped to [0, L-1] where L is
    the row's length as passed (callers that pre-pad clip inside their
    padding); width a multiple of 128 (else ValueError).  Reads past L
    return 0; N is free."""
    _check_width(width)
    if x.device.type == "cpu":
        return gather_windows_plain(x, starts, width)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or the CPU, got {x.device}")
    B, L = x.shape
    if L < 1:
        raise ValueError("K5 takes rows of length >= 1")
    N = starts.shape[1]
    check_cuda_tensor("x", x, torch.float32, (B, L), x.device)
    check_cuda_tensor("starts", starts, torch.int32, (B, N), x.device)
    out = torch.empty((B, N, width), dtype=torch.float32, device=x.device)
    K5.launch(x, starts, out, B, L, N, width)
    return out


def band_lerp(win: torch.Tensor, rel: torch.Tensor, s_lo: int,
              s_hi: int) -> torch.Tensor:
    """Banded fractional interpolation of window rows.

    win (B, N, W); rel (B, N, C) window positions of C output lanes.
    Returns y (B, N, C) with

      y[l] = sum over p in [l + s_lo, l + s_hi + 1], 0 <= p < W, of
             max(0, 1 - |rel[l] - p|) * win[p]:

    the linear interpolation between floor(rel) and floor(rel) + 1, where a
    tap that falls outside the band (or the window) contributes 0.  The
    reference forms this sum as an einsum against a constant (W, C, S)
    one-hot band, materialising a (B, N, C, S) intermediate (chunked under
    ``lax.map`` past ``max_chunk_bytes``); only the two taps p = floor(rel)
    and floor(rel) + 1 can have a nonzero weight, so here it is two
    ``torch.gather``s with band masks, no intermediate, and no chunking
    option."""
    W = win.shape[-1]
    lane = torch.arange(rel.shape[-1], device=rel.device, dtype=torch.float32)
    p0 = torch.floor(rel)
    y = None
    for p in (p0, p0 + 1.0):
        w = torch.clamp(1.0 - torch.abs(rel - p), min=0.0)
        off = p - lane
        inside = (off >= s_lo) & (off <= s_hi + 1) & (p >= 0) & (p <= W - 1)
        tap = torch.gather(win, 2, p.clamp(0, W - 1).long())
        term = torch.where(inside, w * tap, 0.0)
        y = term if y is None else y + term
    return y
