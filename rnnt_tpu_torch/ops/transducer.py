"""RNN-T (transducer) loss: the plain PyTorch reference, differentiable.

Port of ``rnnt_tpu/ops/transducer.py``: blank is the last class, ``NEG = -1e30`` is a finite log-zero (never -inf: inf - inf is NaN),
and the log-sum-exp here is guarded so two log-zeros stay exactly NEG.

* ``lattice_log_probs`` — (B, T, U+1, V) logits to per-cell blank and label
  log-probs; label log-probs at u >= u_len are NEG, the final column's
  label is a dummy 0.
* ``transducer_alpha`` / ``transducer_alpha_loss`` — the alpha recursion:
  a loop over T rows, each an inclusive (LSE, +) scan over U done as a
  Hillis-Steele scan of affine maps.  This is also the plain version of
  the K3 kernel (ops/lattice_pallas.py).
* ``joint_lattice_log_probs`` / ``transducer_loss`` — the chunked path:
  the joint is evaluated T-chunk by T-chunk, each chunk under
  ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` remat), so
  only (B, T, U+1) log-probs persist, then ``lattice_nll`` runs the DP.
* ``transducer_loss_from_logits`` — the oracle over full logits.
* ``clamp_grads`` — identity forward, the cotangent clamped backward.
* ``lattice_nll`` — the differentiable lattice NLL (ops/lattice_pallas.py):
  K3 forward and K4 backward for CUDA tensors, the plain alpha and beta for
  CPU tensors; with a mesh whose ``model`` axis is larger than 1, the
  T-sharded chain over the model group (ops/lattice_tshard.py, K6 and K7).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

NEG = -1e30


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Guarded log(exp(a) + exp(b)): both log-zero -> exactly NEG."""
    m = torch.maximum(a, b)
    dead = m <= NEG / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe) + 1e-30)
    return torch.where(dead, torch.full_like(out, NEG), out)


def lattice_log_probs(logits: torch.Tensor, targets: torch.Tensor,
                      u_lens: torch.Tensor, blank: int):
    """(B, T, U+1, V) logits -> (lp_blank, lp_label), both (B, T, U+1) f32."""
    logits = logits.float()
    lp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    B, T, U1, _ = lp.shape
    tgt = torch.cat([targets, targets.new_zeros((B, 1))], dim=1).long()
    lp_label = torch.gather(lp, 3, tgt[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    u_mask = torch.arange(U1, device=lp.device)[None, :] < u_lens[:, None]
    lp_label = torch.where(u_mask[:, None, :], lp_label,
                           torch.full_like(lp_label, NEG))
    return lp[..., blank], lp_label


def row_scan(c: torch.Tensor, e_shift: torch.Tensor) -> torch.Tensor:
    """Row recurrence a[u] = LSE(c[u], a[u-1] + e_shift[u]) over (B, U).

    Each column is the affine map x -> LSE(x + A, b) with (A, b) =
    (e_shift[u], c[u]); composing left then right gives
    (A1 + A2, LSE(b1 + A2, b2)).  Hillis-Steele: log2(U) rounds, the
    identity (0, NEG) filling the first k columns of round k."""
    A, bv = e_shift, c
    B, U = c.shape
    k = 1
    while k < U:
        A_s = torch.cat([A.new_zeros((B, k)), A[:, :-k]], dim=1)
        b_s = torch.cat([bv.new_full((B, k), NEG), bv[:, :-k]], dim=1)
        bv = _lse(b_s + A, bv)
        A = A + A_s
        k *= 2
    return bv


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """(B, U) -> (B, U): drop the last column, prepend a NEG column."""
    return torch.cat([x.new_full((x.shape[0], 1), NEG), x[:, :-1]], dim=1)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def transducer_alpha(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                     t0: int = 0, carry: torch.Tensor | None = None) -> torch.Tensor:
    """alpha (B, T, U+1): alpha[t, u] = LSE(alpha[t-1, u] + lp_blank[t-1, u],
    alpha[t, u-1] + lp_label[t, u-1]), alpha[0, 0] = 0; float32, or float64
    for float64 inputs.  On one T-shard of a longer lattice
    (ops/lattice_tshard.py) whose rows start at global row ``t0 > 0``, the
    first row takes ``carry`` (alpha + lp_blank of global row t0 - 1) in
    place of the seed."""
    lp_blank = _at_least_f32(lp_blank)
    lp_label = _at_least_f32(lp_label)
    B, T, U1 = lp_blank.shape
    c = torch.full((B, U1), NEG, dtype=lp_blank.dtype, device=lp_blank.device)
    c[:, 0] = 0.0
    if t0 > 0:
        c = carry.to(lp_blank.dtype)
    rows = []
    for t in range(T):
        if t > 0:
            c = rows[-1] + lp_blank[:, t - 1]
        rows.append(row_scan(c, _shift_right(lp_label[:, t])))
    return torch.stack(rows, dim=1)


def final_nll(alphas, lp_blank, t_lens, u_lens) -> torch.Tensor:
    """-(alpha + lp_blank) at (t_len - 1, u_len), shape (B,)."""
    b_idx = torch.arange(alphas.shape[0], device=alphas.device)
    t_last = t_lens.long() - 1
    u = u_lens.long()
    return -(alphas[b_idx, t_last, u] + _at_least_f32(lp_blank)[b_idx, t_last, u])


def transducer_alpha_loss(lp_blank, lp_label, t_lens, u_lens) -> torch.Tensor:
    """Per-sample negative log-likelihood (B,) by the plain alpha recursion."""
    return final_nll(transducer_alpha(lp_blank, lp_label), lp_blank,
                     t_lens, u_lens)


def lattice_nll(lp_blank, lp_label, t_lens, u_lens, mesh=None) -> torch.Tensor:
    """Per-sample NLL, differentiable in the log-probs: K3 forward and K4
    backward for CUDA tensors, the plain alpha and beta for CPU tensors.
    A ``mesh`` (parallel/mesh.py) with ``model > 1`` selects the T-sharded
    chain instead (the reference's ``:153-159``): every rank passes the
    whole lattice and back-propagates its own block of rows."""
    from rnnt_tpu_torch.ops.lattice_pallas import LatticeNLL

    if mesh is not None and mesh.model > 1:
        from rnnt_tpu_torch.ops.lattice_tshard import transducer_alpha_loss_tsharded

        return transducer_alpha_loss_tsharded(lp_blank, lp_label, t_lens, u_lens, mesh)

    return LatticeNLL.apply(
        lp_blank.float().contiguous(), lp_label.float().contiguous(),
        t_lens.to(torch.int32).contiguous(), u_lens.to(torch.int32).contiguous())


class _ClampGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, clamp):
        ctx.clamp = clamp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.clamp, ctx.clamp), None


def clamp_grads(x: torch.Tensor, clamp: float) -> torch.Tensor:
    """Identity forward; backward clamps the cotangent to [-clamp, clamp]
    (torchaudio's rnnt_loss ``clamp``)."""
    return _ClampGrads.apply(x, clamp)


def transducer_loss_from_logits(logits, targets, t_lens, u_lens, blank: int,
                                reduction: str = "mean",
                                grad_clamp: float = -1.0) -> torch.Tensor:
    """Loss from full (B, T, U+1, V) logits — the correctness oracle."""
    if grad_clamp > 0:
        logits = clamp_grads(logits, grad_clamp)
    lp_blank, lp_label = lattice_log_probs(logits, targets, u_lens, blank)
    return reduce_losses(lattice_nll(lp_blank, lp_label, t_lens, u_lens),
                         reduction)


def _joint_chunk_log_probs(w, b, enc_chunk, text, tgt, u_mask, blank: int,
                           grad_clamp: float):
    """Joint + log-softmax + blank/label gather for a chunk of frames:
    (B, Tc, U+1) f32 blank and label log-probs."""
    h = torch.tanh(enc_chunk[:, :, None, :] + text[:, None, :, :])
    logits = torch.matmul(h.float(), w.to(h.dtype).float()) + b.float()
    if grad_clamp > 0:
        logits = clamp_grads(logits, grad_clamp)
    denom = torch.logsumexp(logits, dim=-1)
    B, Tc, U1, _ = logits.shape
    label = torch.gather(logits, 3,
                         tgt[:, None, :, None].expand(B, Tc, U1, 1))[..., 0]
    return (logits[..., blank] - denom,
            torch.where(u_mask[:, None, :], label - denom,
                        torch.full_like(denom, NEG)))


def joint_lattice_log_probs(joint, audio: torch.Tensor, text: torch.Tensor,
                            targets: torch.Tensor, u_lens: torch.Tensor,
                            blank: int, chunk_size: int = 32,
                            grad_clamp: float = -1.0, t_rows: slice | None = None):
    """(lp_blank, lp_label), both (B, T, U+1) f32, from the joint evaluated
    ``chunk_size`` frames at a time.  audio (B, T, H) and text (B, U+1, H)
    are the encoder and predictor outputs; targets (B, U) label ids;
    ``t_rows`` keeps only those frames of the projected audio (a T-sharded
    rank's block).  When autograd records, each chunk runs under
    ``torch.utils.checkpoint`` so its (B, chunk, U+1, V) logits are
    recomputed in backward, not kept."""
    from rnnt_tpu_torch.models.joint import project_sides

    audio, text = project_sides(joint, audio, text)
    if t_rows is not None:
        audio = audio[:, t_rows]
    B, T, _ = audio.shape
    U1 = text.shape[1]
    tgt = torch.cat([targets, targets.new_zeros((B, 1))], dim=1).long()
    u_mask = torch.arange(U1, device=audio.device)[None, :] < u_lens[:, None]
    remat = torch.is_grad_enabled()
    lpb, lpl = [], []
    for t0 in range(0, T, chunk_size):
        args = (joint.out.w, joint.out.b, audio[:, t0:t0 + chunk_size], text,
                tgt, u_mask, blank, grad_clamp)
        if remat:
            b_c, l_c = torch.utils.checkpoint.checkpoint(
                _joint_chunk_log_probs, *args, use_reentrant=False)
        else:
            b_c, l_c = _joint_chunk_log_probs(*args)
        lpb.append(b_c)
        lpl.append(l_c)
    return torch.cat(lpb, dim=1), torch.cat(lpl, dim=1)


def reduce_losses(losses: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def transducer_loss(joint, audio, text, targets, t_lens, u_lens, blank: int,
                    *, chunk_size: int = 32, reduction: str = "mean",
                    grad_clamp: float = -1.0, mesh=None):
    """Chunked joint + transducer NLL.  With a ``mesh`` whose ``model``
    axis is larger than 1, this rank runs the joint on its block of T rows
    only (the reference's ``:208-215`` slicing) and the lattice on the
    T-sharded chain: per-rank O(T / model) log-prob and lattice memory."""
    if mesh is None or mesh.model == 1:
        lp_blank, lp_label = joint_lattice_log_probs(
            joint, audio, text, targets, u_lens, blank, chunk_size, grad_clamp)
        return reduce_losses(lattice_nll(lp_blank, lp_label, t_lens, u_lens),
                             reduction)
    from rnnt_tpu_torch.ops.lattice_tshard import pad_block, t_block, tsharded_block_nll

    start, stop, rows = t_block(audio.shape[1], mesh)
    if stop == start:
        raise ValueError(f"T = {audio.shape[1]} frames leave model rank "
                         f"{mesh.model_rank} of {mesh.model} no rows")
    lp_blank, lp_label = pad_block(*joint_lattice_log_probs(
        joint, audio, text, targets, u_lens, blank, chunk_size, grad_clamp,
        t_rows=slice(start, stop)), rows)
    return reduce_losses(tsharded_block_nll(lp_blank, lp_label, t_lens, u_lens, mesh),
                         reduction)
