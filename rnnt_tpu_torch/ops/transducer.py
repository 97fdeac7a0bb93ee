"""RNN-T (transducer) loss, forward only: the plain PyTorch reference.

Port of ``rnnt_tpu/ops/transducer.py`` for evaluation: blank is the last
class, ``NEG = -1e30`` is a finite log-zero (never -inf: inf - inf is NaN),
and the log-sum-exp here is guarded so two log-zeros stay exactly NEG.

* ``lattice_log_probs`` — (B, T, U+1, V) logits to per-cell blank and label
  log-probs; label log-probs at u >= u_len are NEG, the final column's
  label is a dummy 0.
* ``transducer_alpha`` / ``transducer_alpha_loss`` — the alpha recursion:
  a loop over T rows, each an inclusive (LSE, +) scan over U done as a
  Hillis-Steele scan of affine maps.  This is also the plain version of
  the K3 kernel (ops/lattice_pallas.py).
* ``joint_lattice_log_probs`` / ``transducer_loss`` — the chunked path:
  the joint is evaluated T-chunk by T-chunk so only (B, T, U+1) log-probs
  persist, then ``lattice_nll`` runs the DP.
* ``lattice_nll`` — K3 for CUDA tensors, the plain alpha for CPU tensors.
"""

from __future__ import annotations

import torch

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


def transducer_alpha(lp_blank: torch.Tensor, lp_label: torch.Tensor) -> torch.Tensor:
    """alpha (B, T, U+1): alpha[t, u] = LSE(alpha[t-1, u] + lp_blank[t-1, u],
    alpha[t, u-1] + lp_label[t, u-1]), alpha[0, 0] = 0."""
    lp_blank = lp_blank.float()
    lp_label = lp_label.float()
    B, T, U1 = lp_blank.shape
    c = torch.full((B, U1), NEG, dtype=torch.float32, device=lp_blank.device)
    c[:, 0] = 0.0
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
    return -(alphas[b_idx, t_last, u] + lp_blank.float()[b_idx, t_last, u])


def transducer_alpha_loss(lp_blank, lp_label, t_lens, u_lens) -> torch.Tensor:
    """Per-sample negative log-likelihood (B,) by the plain alpha recursion."""
    return final_nll(transducer_alpha(lp_blank, lp_label), lp_blank,
                     t_lens, u_lens)


def lattice_nll(lp_blank, lp_label, t_lens, u_lens) -> torch.Tensor:
    """Per-sample NLL: the K3 kernel for CUDA tensors, the plain alpha for
    CPU tensors."""
    from rnnt_tpu_torch.ops.lattice_pallas import transducer_alpha_loss_fast

    return transducer_alpha_loss_fast(
        lp_blank.contiguous(), lp_label.contiguous(),
        t_lens.to(torch.int32).contiguous(), u_lens.to(torch.int32).contiguous())


def joint_lattice_log_probs(joint, audio: torch.Tensor, text: torch.Tensor,
                            targets: torch.Tensor, u_lens: torch.Tensor,
                            blank: int, chunk_size: int = 32):
    """(lp_blank, lp_label), both (B, T, U+1) f32, from the joint evaluated
    ``chunk_size`` frames at a time.  audio (B, T, H) and text (B, U+1, H)
    are the encoder and predictor outputs; targets (B, U) label ids."""
    from rnnt_tpu_torch.models.joint import project_sides

    audio, text = project_sides(joint, audio, text)
    B, T, _ = audio.shape
    U1 = text.shape[1]
    tgt = torch.cat([targets, targets.new_zeros((B, 1))], dim=1).long()
    u_mask = torch.arange(U1, device=audio.device)[None, :] < u_lens[:, None]
    lpb, lpl = [], []
    for t0 in range(0, T, chunk_size):
        h = torch.tanh(audio[:, t0:t0 + chunk_size, None, :] + text[:, None, :, :])
        logits = (torch.matmul(h.float(), joint.out.w.to(h.dtype).float())
                  + joint.out.b.float())
        denom = torch.logsumexp(logits, dim=-1)
        Tc = logits.shape[1]
        lpb.append(logits[..., blank] - denom)
        label = torch.gather(logits, 3,
                             tgt[:, None, :, None].expand(B, Tc, U1, 1))[..., 0]
        lpl.append(torch.where(u_mask[:, None, :], label - denom,
                               torch.full_like(denom, NEG)))
    return torch.cat(lpb, dim=1), torch.cat(lpl, dim=1)


def reduce_losses(losses: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def transducer_loss(joint, audio, text, targets, t_lens, u_lens, blank: int,
                    *, chunk_size: int = 32, reduction: str = "mean"):
    """Chunked joint + transducer NLL (forward only)."""
    lp_blank, lp_label = joint_lattice_log_probs(
        joint, audio, text, targets, u_lens, blank, chunk_size)
    return reduce_losses(lattice_nll(lp_blank, lp_label, t_lens, u_lens),
                         reduction)
