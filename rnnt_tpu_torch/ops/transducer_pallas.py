"""K1 and K2: the fused joint forward and backward as hand-written CUDA
kernels, and the exact transducer NLL built on them.

Replaces ``rnnt_tpu/ops/transducer_pallas.py:65`` ``_fwd_kernel``
(launcher ``_fwd_pallas:99``, call ``:114``).  The module keeps the
reference's name so the two packages line up file by file; the kernel is
CUDA C++ in ``csrc/joint_fwd.cu``.

For each lattice cell the kernel forms ``act(enc_t + pred_u)`` (``act`` is
tanh, or ReLU for a joint whose ``activation`` is ``relu``; a launch
argument, ``ACT_CODES``) and the
V-wide logits on chip only and writes three (B, T, U+1) float32 arrays:
the logsumexp over V, the blank logit and the label logit.  It reads int32
label ids and the blank index in place of the TPU kernel's one-hot
operands.  Where those one-hots are V-sharded, K1 and K2 take ``v0``, the
first global id of W's columns: an id outside [v0, v0 + V) counts in no
column, its logit is 0 and it adds nothing to K2's dl
(``parallel/partition.py`` merges the slices).  ``v0 = 0`` with the whole
V is the unsliced function.

Bound on an H100: operations — 2*B*T*U1*H*V flops, 0.28 ms at the eval
shape (4, 504, 65, 1024, 1024) at 989 TFLOP/s bf16, against ~1.6 MB of
output.  The kernel writes h = tanh(enc + pred) once to a bf16 workspace
(the device function K2 rounds h with), then multiplies it by W on the
TMA-fed wgmma mainloop K2's products share (``csrc/sm90_gemm.cuh``): a
block per 128 rows of the flattened lattice walks every V tile, keeping an
online logsumexp in the accumulator's registers; ragged T and U need no
padding.

``fused_joint_outputs_plain`` is the same function in plain PyTorch (the
CPU path and the card-side yardstick).  ``fused_joint_forward`` takes it
only for CPU tensors; for CUDA tensors it launches the kernel (bf16 enc,
pred and W) or raises.  ``K1.launches`` counts launches.

K2 replaces ``rnnt_tpu/ops/transducer_pallas.py:155`` ``_bwd_kernel``
(launcher ``_bwd_pallas:280``, call ``:333``): from the saved lse and the
three cotangents it recomputes the logits, forms d(loss)/d(logits)
(optionally clamped) and returns denc, dpred, dW and db in float32.  Bound
on an H100: operations, three products of 2*B*T*U1*H*V flops (0.83 ms at
the eval shape).  The kernel (``csrc/joint_bwd.cu``) writes h once to a
bf16 workspace, then runs the three products on one TMA-fed wgmma GEMM
mainloop (``csrc/sm90_gemm.cuh``) around a bf16 dl workspace; see the
source.
``fused_joint_bwd_plain`` is its plain version and ``fused_joint_backward``
its wrapper (``K2.launches``).  ``fused_joint_outputs`` is the autograd
Function over the pair, as ``fused_joint_outputs`` with its custom VJP is in
the reference (``:400-426``).
"""

from __future__ import annotations

import ctypes

import torch

from rnnt_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor
from rnnt_tpu_torch.ops.transducer import NEG, lattice_nll, reduce_losses

_P = ctypes.c_void_p
_I = ctypes.c_int
K1 = CudaKernel(
    "joint_fwd", "rnnt_joint_fwd", [_P] * 9 + [_I] * 9 + [_P],
    replaces="rnnt_tpu/ops/transducer_pallas.py:65 _fwd_kernel")
K2 = CudaKernel(
    "joint_bwd", "rnnt_joint_bwd",
    [_P] * 15 + [_I] * 8 + [ctypes.c_float, _I, _P],
    replaces="rnnt_tpu/ops/transducer_pallas.py:155 _bwd_kernel")


# The joint activations K1 and K2 take, by their launch argument's value.
ACT_CODES = {"tanh": 0, "relu": 1}


def _act_code(act: str) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"K1 and K2 take the joint activations {sorted(ACT_CODES)}, "
                         f"got {act!r}")
    return ACT_CODES[act]


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    return torch.tanh(x) if _act_code(act) == 0 else torch.relu(x)


def _slice_ids(labels, blank: int, v0: int, V: int):
    """(local label ids clamped into [0, V), which of them the slice
    [v0, v0 + V) owns, the blank's local column or None)."""
    local = labels.long() - v0
    own = (local >= 0) & (local < V)
    return local.clamp(0, V - 1), own, (blank - v0 if 0 <= blank - v0 < V else None)


def fused_joint_outputs_plain(enc, pred, w, b, labels, blank: int, v0: int = 0, *,
                              act: str = "tanh"):
    """(lse, blank_logit, label_logit), each (B, T, U1) float32, in plain
    PyTorch, over h = act(enc + pred) (``act`` tanh or relu).  enc (B, T, H), pred (B, U1, H) and w (H, V) share one dtype;
    b (V,) float32; labels (B, U1) int ids of the label leaving each column.
    w and b hold the columns of ids [v0, v0 + V): lse is over them, and a
    blank or label id outside them gives a 0 logit."""
    h = _activate(enc[:, :, None, :] + pred[:, None, :, :], act)
    logits = torch.matmul(h.float(), w.float()) + b.float()
    B, T, U1, V = logits.shape
    local, own, blank_col = _slice_ids(labels, blank, v0, V)
    idx = local[:, None, :, None].expand(B, T, U1, 1)
    label_logit = torch.gather(logits, 3, idx)[..., 0]
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return (torch.logsumexp(logits, dim=-1),
            logits[..., blank_col] if blank_col is not None else zero.expand(B, T, U1),
            torch.where(own[:, None, :], label_logit, zero))


def check_blank(blank: int, V: int) -> None:
    """A blank id must be a column of the whole vocabulary of V ids (K1 and
    K2 take one outside a slice)."""
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside the vocabulary [0, {V})")


def _check_joint(enc, pred, w, b, labels, blank: int, v0: int):
    B, T, H = enc.shape
    U1 = pred.shape[1]
    V = w.shape[1]
    dev = enc.device
    check_cuda_tensor("enc", enc, torch.bfloat16, (B, T, H), dev)
    check_cuda_tensor("pred", pred, torch.bfloat16, (B, U1, H), dev)
    check_cuda_tensor("w", w, torch.bfloat16, (H, V), dev)
    check_cuda_tensor("b", b, torch.float32, (V,), dev)
    check_cuda_tensor("labels", labels, torch.int32, (B, U1), dev)
    if blank < 0 or v0 < 0:
        raise ValueError(f"blank {blank} and v0 {v0} must be >= 0")
    return B, T, U1, H, V


# Lattice rows (B*T*U1) K1 and K2 take: their row indices, TMA coordinates
# and grids are 32-bit, with room to spare (the entry points refuse more).
MAX_ROWS = (1 << 31) // 8


def fused_joint_forward(enc, pred, w, b, labels, blank: int, v0: int = 0, *,
                        act: str = "tanh"):
    """Same contract as ``fused_joint_outputs_plain``; on CUDA, enc, pred
    and w must be bf16 and every input contiguous."""
    if enc.device.type == "cpu":
        return fused_joint_outputs_plain(enc, pred, w, b, labels, blank, v0, act=act)
    if enc.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or the CPU, got {enc.device}")
    return _joint_forward_kernel(enc, pred, w, b, labels, blank, v0, act)


# Rows of the lattice per step of the plain backward: bounds its (rows, V)
# float32 temporaries to ~64 MB each.
_PLAIN_BWD_CELLS = 1 << 24


def fused_joint_bwd_plain(enc, pred, w, b, labels, blank: int, lse, g_blank,
                          g_label, g_lse, grad_clamp: float = -1.0, v0: int = 0, *,
                          act: str = "tanh"):
    """(denc (B,T,H), dpred (B,U1,H), dW (H,V), db (V,)), all float32: the
    K2 formula in plain PyTorch, a few frames at a time.  Per cell,
    dl = g_lse * softmax + g_blank * 1[blank] + g_label * 1[label] (clamped
    to +-grad_clamp when it is > 0) from the logits recomputed against the
    saved lse; dh = dl . W^T and dW = h^T . dl take dl in W's dtype, db sums
    it in float32; dpre = dh act'(h) (1 - h^2 for tanh, [h > 0] for relu)
    sums over u into denc and over t into dpred.  On a vocabulary slice (w and b the columns of ids [v0, v0 + V),
    lse the merged one) the indicator of an id outside the slice is 0."""
    B, T, H = enc.shape
    U1 = pred.shape[1]
    V = w.shape[1]
    wf = w.float()
    bf = b.float()
    denc = torch.empty((B, T, H), dtype=torch.float32, device=enc.device)
    dpred = torch.zeros((B, U1, H), dtype=torch.float32, device=enc.device)
    dw = torch.zeros((H, V), dtype=torch.float32, device=enc.device)
    db = torch.zeros((V,), dtype=torch.float32, device=enc.device)
    lab, own, blank_col = _slice_ids(labels, blank, v0, V)
    step = max(1, _PLAIN_BWD_CELLS // max(1, B * U1 * V))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        h = _activate(enc[:, t0:t1, None, :] + pred[:, None, :, :], act)
        hf = h.float()
        dl = torch.exp(torch.matmul(hf, wf) + bf - lse[:, t0:t1, :, None])
        dl = dl * g_lse[:, t0:t1, :, None]
        if blank_col is not None:
            dl[..., blank_col] += g_blank[:, t0:t1]
        idx = lab[:, None, :, None].expand(B, t1 - t0, U1, 1)
        g_own = torch.where(own[:, None, :], g_label[:, t0:t1], g_label.new_zeros(()))
        dl.scatter_add_(3, idx, g_own[..., None])
        if grad_clamp > 0:
            dl = dl.clamp(-grad_clamp, grad_clamp)
        db += dl.sum(dim=(0, 1, 2))
        dlw = dl.to(w.dtype).float()
        dpre = torch.matmul(dlw, wf.T) * ((1.0 - hf * hf) if act == "tanh"
                                           else (hf > 0).float())
        denc[:, t0:t1] = dpre.sum(dim=2)
        dpred += dpre.sum(dim=1)
        dw += torch.matmul(hf.reshape(-1, H).T, dlw.reshape(-1, V))
    return denc, dpred, dw, db


def fused_joint_backward(enc, pred, w, b, labels, blank: int, lse, g_blank,
                         g_label, g_lse, grad_clamp: float = -1.0, v0: int = 0, *,
                         act: str = "tanh"):
    """Same contract as ``fused_joint_bwd_plain``; on CUDA every input as
    ``fused_joint_forward`` takes it, plus lse and the cotangents (B, T, U1)
    float32 contiguous."""
    if enc.device.type == "cpu":
        return fused_joint_bwd_plain(enc, pred, w, b, labels, blank, lse,
                                     g_blank, g_label, g_lse, grad_clamp, v0, act=act)
    if enc.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or the CPU, got {enc.device}")
    return _joint_backward_kernel(enc, pred, w, b, labels, blank, lse, g_blank,
                                  g_label, g_lse, grad_clamp, v0, act)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy when its data does not start on 16 bytes (a TMA
    base must)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _padded_operands(enc, pred, w):
    """(enc, pred, w, Hp, Vp) for K1's and K2's tensor maps, which need rows
    of a multiple of 16 bytes: where H or V is not a multiple of 8, enc,
    pred and W are copied into zero-padded buffers of width Hp and Vp (no
    config has such widths); each is copied again only where its data does
    not start on 16 bytes."""
    H, V = w.shape
    Hp, Vp = -(-H // 8) * 8, -(-V // 8) * 8
    if Hp != H:
        enc = torch.nn.functional.pad(enc, (0, Hp - H))
        pred = torch.nn.functional.pad(pred, (0, Hp - H))
    if Hp != H or Vp != V:
        w = torch.nn.functional.pad(w, (0, Vp - V, 0, Hp - H))
    return _aligned(enc), _aligned(pred), _aligned(w), Hp, Vp


def _check_rows(name: str, B: int, T: int, U1: int) -> None:
    if B * T * U1 >= MAX_ROWS:
        raise ValueError(f"{name}: B*T*U1 = {B * T * U1} lattice rows, the kernel takes "
                         f"fewer than {MAX_ROWS} (32-bit row indices)")


def _joint_forward_kernel(enc, pred, w, b, labels, blank, v0=0, act="tanh"):
    """K1's launch on enc, pred and W padded as ``_padded_operands`` pads
    them, with h (N, Hp), N = B*T*U1, a bf16 workspace; the bias is read
    only below V."""
    B, T, U1, H, V = _check_joint(enc, pred, w, b, labels, blank, v0)
    code = _act_code(act)
    _check_rows("K1", B, T, U1)
    dev = enc.device
    enc, pred, w, Hp, Vp = _padded_operands(enc, pred, w)
    h_ws = torch.empty((B * T * U1, Hp), dtype=torch.bfloat16, device=dev)
    outs = [torch.empty((B, T, U1), dtype=torch.float32, device=dev) for _ in range(3)]
    K1.launch(enc, pred, w, _aligned(b), labels, h_ws, *outs, B, T, U1, Hp, V, Vp, blank,
              v0, code)
    return tuple(outs)


def _joint_backward_kernel(enc, pred, w, b, labels, blank, lse, g_blank, g_label,
                           g_lse, grad_clamp, v0=0, act="tanh"):
    """K2's launch on enc, pred and W padded as ``_padded_operands`` pads
    them; the outputs are cropped back.  h (N, Hp) and dl (N, Vp),
    N = B*T*U1, are bf16 workspaces."""
    B, T, U1, H, V = _check_joint(enc, pred, w, b, labels, blank, v0)
    code = _act_code(act)
    _check_rows("K2", B, T, U1)
    dev = enc.device
    for name, x in (("lse", lse), ("g_blank", g_blank), ("g_label", g_label),
                    ("g_lse", g_lse)):
        check_cuda_tensor(name, x, torch.float32, (B, T, U1), dev)
    enc, pred, w, Hp, Vp = _padded_operands(enc, pred, w)
    h_ws = torch.empty((B * T * U1, Hp), dtype=torch.bfloat16, device=dev)
    dl_ws = torch.empty((B * T * U1, Vp), dtype=torch.bfloat16, device=dev)
    denc = torch.zeros((B, T, Hp), dtype=torch.float32, device=dev)
    dpred = torch.zeros((B, U1, Hp), dtype=torch.float32, device=dev)
    dw = torch.zeros((Hp, Vp), dtype=torch.float32, device=dev)
    db = torch.zeros((V,), dtype=torch.float32, device=dev)
    K2.launch(enc, pred, w, b, labels, lse, g_blank, g_label, g_lse, h_ws, dl_ws,
              denc, dpred, dw, db, B, T, U1, Hp, V, Vp, blank, v0, float(grad_clamp), code)
    if Hp != H or Vp != V:
        denc, dpred, dw = (x.contiguous() for x in (denc[..., :H], dpred[..., :H],
                                                     dw[:H, :V]))
    return denc, dpred, dw, db


class FusedJointOutputs(torch.autograd.Function):
    """K1 forward saving lse; K2 backward.  Gradients flow to enc, pred, w
    and b, cast to their dtypes (dW arrives bf16 under bf16 precision, as
    ``_fjo_bwd`` returns it)."""

    @staticmethod
    def forward(ctx, enc, pred, w, b, labels, blank, grad_clamp, act="tanh"):
        check_blank(blank, w.shape[1])
        lse, blank_logit, label_logit = fused_joint_forward(
            enc, pred, w, b, labels, blank, act=act)
        ctx.blank, ctx.grad_clamp, ctx.act = blank, grad_clamp, act
        ctx.save_for_backward(enc, pred, w, b, labels, lse)
        return lse, blank_logit, label_logit

    @staticmethod
    def backward(ctx, g_lse, g_blank, g_label):
        enc, pred, w, b, labels, lse = ctx.saved_tensors
        gs = [torch.zeros_like(lse) if g is None else g.float().contiguous()
              for g in (g_blank, g_label, g_lse)]
        denc, dpred, dw, db = fused_joint_backward(
            enc, pred, w, b, labels, ctx.blank, lse, *gs, ctx.grad_clamp, act=ctx.act)
        return (denc.to(enc.dtype), dpred.to(pred.dtype), dw.to(w.dtype),
                db.to(b.dtype), None, None, None, None)


def fused_joint_outputs(enc, pred, w, b, labels, blank: int,
                        grad_clamp: float = -1.0, mesh=None, act: str = "tanh"):
    """(lse, blank_logit, label_logit), each (B, T, U1) float32 over the
    lattice of enc (B, T, H) and pred (B, U1, H), differentiable in enc,
    pred, w and b.  grad_clamp > 0 bounds d(loss)/d(logits) in backward.
    With a ``mesh``, w and b are this model rank's slice of V and the
    outputs are merged over the slices (``parallel/partition.py``, tanh
    only)."""
    if mesh is not None:
        from rnnt_tpu_torch.parallel.partition import fused_joint_outputs_tp

        return fused_joint_outputs_tp(enc, pred, w, b, labels, blank, grad_clamp, mesh)
    return FusedJointOutputs.apply(enc, pred, w, b, labels, blank, grad_clamp, act)


def transducer_loss_pallas(joint, audio, text, targets, t_lens, u_lens,
                           blank: int, *, reduction: str = "mean",
                           grad_clamp: float = -1.0):
    """Exact transducer NLL through K1 + the alpha recursion (K3 on CUDA),
    differentiable through K2 and K4.

    Same contract as ``ops.transducer.transducer_loss``; blank must be the
    last class.  The label of the final lattice column is a dummy 0, and
    label log-probs at u >= u_len are NEG.  A V-sharded joint (its
    ``tp_mesh`` set) runs K1 and K2 on its slice; the lattice is whole on
    every model rank."""
    from rnnt_tpu_torch.models.joint import project_sides

    audio, text = project_sides(joint, audio, text)
    B, T, _ = audio.shape
    U1 = text.shape[1]
    labels = torch.cat([targets, targets.new_zeros((B, 1))], dim=1)
    lse, blank_logit, label_logit = fused_joint_outputs(
        audio.contiguous(), text.to(audio.dtype).contiguous(),
        joint.out.w.to(audio.dtype).contiguous(),
        joint.out.b.float().contiguous(), labels.to(torch.int32).contiguous(),
        blank, grad_clamp, mesh=joint.tp_mesh, act=joint.spec.activation)
    lp_blank = blank_logit - lse
    u_mask = torch.arange(U1, device=audio.device)[None, :] < u_lens[:, None]
    lp_label = torch.where(u_mask[:, None, :], label_logit - lse,
                           torch.full_like(lse, NEG))
    return reduce_losses(lattice_nll(lp_blank, lp_label, t_lens, u_lens),
                         reduction)
