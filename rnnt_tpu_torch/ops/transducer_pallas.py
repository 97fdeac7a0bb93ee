"""K1: the fused joint forward as a hand-written CUDA kernel, and the exact
transducer NLL built on it.

Replaces ``rnnt_tpu/ops/transducer_pallas.py:65`` ``_fwd_kernel``
(launcher ``_fwd_pallas:99``, call ``:114``).  The module keeps the
reference's name so the two packages line up file by file; the kernel is
CUDA C++ in ``csrc/joint_fwd.cu``.

For each lattice cell the kernel forms ``tanh(enc_t + pred_u)`` and the
V-wide logits on chip only and writes three (B, T, U+1) float32 arrays:
the logsumexp over V, the blank logit and the label logit.  It reads int32
label ids and the blank index in place of the TPU kernel's one-hot
operands (those exist for vocabulary sharding; the function is the same).

Bound on an H100: operations — 2*B*T*U1*H*V flops, 0.28 ms at the eval
shape (4, 504, 65, 1024, 1024) at 989 TFLOP/s bf16, against ~1.6 MB of
output.  The kernel tiles the flattened lattice 64 cells per block, stages
the tanh rows in shared memory once and multiplies them on the tensor
cores (WMMA) against W slabs streamed through a cp.async ring, while
walking V with an online logsumexp; ragged T and U need no padding.

``fused_joint_outputs_plain`` is the same function in plain PyTorch (the
CPU path and the card-side yardstick).  ``fused_joint_outputs`` takes it
only for CPU tensors; for CUDA tensors it launches the kernel (bf16 enc,
pred and W) or raises.  ``K1.launches`` counts launches.  The backward
kernel (K2) belongs to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from rnnt_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor, ptr
from rnnt_tpu_torch.ops.transducer import NEG, lattice_nll, reduce_losses

_P = ctypes.c_void_p
_I = ctypes.c_int
K1 = CudaKernel(
    "joint_fwd", "rnnt_joint_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/transducer_pallas.py:65 _fwd_kernel")


def fused_joint_outputs_plain(enc, pred, w, b, labels, blank: int):
    """(lse, blank_logit, label_logit), each (B, T, U1) float32, in plain
    PyTorch.  enc (B, T, H), pred (B, U1, H) and w (H, V) share one dtype;
    b (V,) float32; labels (B, U1) int ids of the label leaving each column."""
    h = torch.tanh(enc[:, :, None, :] + pred[:, None, :, :])
    logits = torch.matmul(h.float(), w.float()) + b.float()
    B, T, U1, _ = logits.shape
    idx = labels.long()[:, None, :, None].expand(B, T, U1, 1)
    return (torch.logsumexp(logits, dim=-1), logits[..., blank],
            torch.gather(logits, 3, idx)[..., 0])


def fused_joint_outputs(enc, pred, w, b, labels, blank: int):
    """Same contract as ``fused_joint_outputs_plain``; on CUDA, enc, pred
    and w must be bf16 and every input contiguous."""
    if enc.device.type == "cpu":
        return fused_joint_outputs_plain(enc, pred, w, b, labels, blank)
    if enc.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or the CPU, got {enc.device}")
    B, T, H = enc.shape
    U1 = pred.shape[1]
    V = w.shape[1]
    dev = enc.device
    check_cuda_tensor("enc", enc, torch.bfloat16, (B, T, H), dev)
    check_cuda_tensor("pred", pred, torch.bfloat16, (B, U1, H), dev)
    check_cuda_tensor("w", w, torch.bfloat16, (H, V), dev)
    check_cuda_tensor("b", b, torch.float32, (V,), dev)
    check_cuda_tensor("labels", labels, torch.int32, (B, U1), dev)
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} outside [0, {V})")
    outs = [torch.empty((B, T, U1), dtype=torch.float32, device=dev)
            for _ in range(3)]
    K1.launch(ptr(enc), ptr(pred), ptr(w), ptr(b), ptr(labels),
              *(ptr(o) for o in outs), B, T, U1, H, V, blank)
    return tuple(outs)


def transducer_loss_pallas(joint, audio, text, targets, t_lens, u_lens,
                           blank: int, *, reduction: str = "mean"):
    """Exact transducer NLL through K1 + the alpha recursion (K3 on CUDA).

    Same contract as ``ops.transducer.transducer_loss``; blank must be the
    last class.  The label of the final lattice column is a dummy 0, and
    label log-probs at u >= u_len are NEG."""
    from rnnt_tpu_torch.models.joint import project_sides

    audio, text = project_sides(joint, audio, text)
    B, T, _ = audio.shape
    U1 = text.shape[1]
    labels = torch.cat([targets, targets.new_zeros((B, 1))], dim=1)
    lse, blank_logit, label_logit = fused_joint_outputs(
        audio.contiguous(), text.to(audio.dtype).contiguous(),
        joint.out.w.to(audio.dtype).contiguous(),
        joint.out.b.float().contiguous(), labels.to(torch.int32).contiguous(),
        blank)
    lp_blank = blank_logit - lse
    u_mask = torch.arange(U1, device=audio.device)[None, :] < u_lens[:, None]
    lp_label = torch.where(u_mask[:, None, :], label_logit - lse,
                           torch.full_like(lse, NEG))
    return reduce_losses(lattice_nll(lp_blank, lp_label, t_lens, u_lens),
                         reduction)
