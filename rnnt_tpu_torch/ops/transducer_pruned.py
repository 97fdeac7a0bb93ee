"""Pruned RNN-T loss: a factored "simple" joint prunes the T x U lattice to
a band of U, and the full joint runs only inside the band.

Port of ``rnnt_tpu/ops/transducer_pruned.py`` (the pruned transducer of
Kuang et al., Interspeech 2022, as the k2/icefall recipe trains it):

1. ``simple_joint_log_probs`` — the factored joint ``am(t) + lm(u)``; its
   per-cell normalizer is one (B, T, V) x (B, V, U+1) product of
   exponentials (a plain product, left to ``torch.einsum`` as the JAX
   package leaves it to XLA).
2. ``nll_with_occupancy`` — the simple loss and the label-arc occupancy
   from ONE lattice forward-backward (K3 + K4 on CUDA), reused as its own
   gradient; ``prune_bounds`` turns the tile-pooled occupancy into monotone
   band starts.
3. The banded full joint through the fused kernels (K1 forward, K2
   backward): with one band start per 16-frame tile, each (sample, tile)
   is an independent (16, band) lattice patch, so the band is one
   ``fused_joint_outputs`` call on (B * n_tiles, 16, band); the band is
   rounded up to a multiple of 8 as on the reference's fused path.  On the
   CPU the same path runs the kernels' plain versions; there is no second
   banded path.
4. ``banded_to_full`` (an exact selection, ``gather`` + ``where``) and the
   full-lattice DP (K3 + K4) give the banded NLL, capped at 1e6.

``pruned_warmup_loss`` is the warmup objective: the exact fused loss plus
``simple_scale`` x the simple NLL.

A V-sharded joint (``tp_mesh`` set, ``parallel/mesh.shard_params``) takes
the simple joint of ``parallel/partition.py`` and the fused kernels on its
slice (``fused_joint_outputs(mesh=)``), in the banded loss and in both
parts of the warmup loss (whose exact part then runs the fused path on the
CPU too: the chunked joint has no sharded version).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnnt_tpu_torch.ops.transducer import NEG, lattice_nll, reduce_losses

BOUNDS_TILE = 16  # frames per band start; the fused kernel's lattice patch


def simple_joint_log_probs(simple, audio, text, targets, u_lens, blank: int):
    """Full-lattice (lp_blank, lp_label), (B, T, U+1) float32, of the
    factored joint.  ``simple`` holds the ``am`` and ``lm`` Linear heads;
    audio (B, T, Da) and text (B, U+1, Dt) are the raw encoder and
    predictor outputs; targets (B, U)."""
    am = audio.float() @ simple["am"].w.float() + simple["am"].b.float()
    lm = text.float() @ simple["lm"].w.float() + simple["lm"].b.float()
    am_max = am.amax(dim=-1)
    lm_max = lm.amax(dim=-1)
    pa = torch.exp(am - am_max[..., None])
    pl = torch.exp(lm - lm_max[..., None])
    z = torch.einsum("btv,buv->btu", pa, pl)
    z = torch.log(z + 1e-30) + am_max[:, :, None] + lm_max[:, None, :]
    B, U1 = targets.shape[0], text.shape[1]
    tgt = torch.cat([targets, targets.new_zeros((B, 1))], dim=1).long()
    am_lbl = torch.gather(am, 2, tgt[:, None, :].expand(B, am.shape[1], U1))
    lm_lbl = torch.gather(lm, 2, tgt[:, :, None])[..., 0]
    return simple_log_probs(z, am_lbl, lm_lbl, am[..., blank], lm[..., blank], u_lens)


def simple_log_probs(z, am_lbl, lm_lbl, am_blank, lm_blank, u_lens):
    """(lp_blank, lp_label) of the factored joint from its normalizer z
    (B, T, U+1), the label logits am_lbl (B, T, U+1) and lm_lbl (B, U+1)
    and the blank logits am_blank (B, T) and lm_blank (B, U+1); labels at
    u >= u_len are NEG."""
    U1 = z.shape[2]
    lp_blank = am_blank[:, :, None] + lm_blank[:, None, :] - z
    lp_label = am_lbl + lm_lbl[:, None, :] - z
    u_mask = torch.arange(U1, device=z.device)[None, :] < u_lens[:, None]
    lp_label = torch.where(u_mask[:, None, :], lp_label,
                           torch.full_like(lp_label, NEG))
    return lp_blank, lp_label


class _NLLWithOccupancy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_blank, lp_label, t_lens, u_lens):
        from rnnt_tpu_torch.ops.lattice_pallas import nll_and_grads

        nll, d_blank, d_label = nll_and_grads(lp_blank, lp_label, t_lens, u_lens)
        ctx.save_for_backward(d_blank, d_label)
        gamma = -d_label
        ctx.mark_non_differentiable(gamma)
        return nll, gamma

    @staticmethod
    def backward(ctx, g_losses, _g_gamma):
        d_blank, d_label = ctx.saved_tensors
        g3 = g_losses.float()[:, None, None]
        return g3 * d_blank, g3 * d_label, None, None


def nll_with_occupancy(lp_blank, lp_label, t_lens, u_lens):
    """(losses (B,), gamma (B, T, U+1)) with gamma = -d(losses)/d(lp_label),
    the label-arc occupancy, from one alpha + beta pass (K3 + K4 on CUDA)
    whose per-sample gradient is also this op's backward.  gamma carries no
    gradient."""
    return _NLLWithOccupancy.apply(
        lp_blank.float().contiguous(), lp_label.float().contiguous(),
        t_lens.to(torch.int32).contiguous(), u_lens.to(torch.int32).contiguous())


def prune_bounds(gamma, t_lens, u_lens, band: int) -> torch.Tensor:
    """Band starts s (B, T) int32 from label occupancy gamma (B, T, U+1):
    0 <= s <= U1 - band, non-decreasing with jumps of at most band - 1,
    pinned at t >= t_len - 1 to clip(u_len - band + 1, 0, U1 - band) so the
    final cell stays in band, and 0 at t = 0 for feasible samples — the
    reference's forward min-plus and reverse max-plus passes."""
    with torch.no_grad():
        B, T, U1 = gamma.shape
        S = min(band, U1)
        cs = F.pad(torch.cumsum(gamma, dim=-1), (1, 0))
        win = cs[..., S:] - cs[..., :-S]
        raw = torch.argmax(win, dim=-1).to(torch.int64)
        final = torch.clamp(u_lens.long() - (S - 1), 0, U1 - S)
        raw = torch.minimum(raw, final[:, None])
        t_ids = torch.arange(T, device=gamma.device)[None, :]
        pinned = t_ids >= (t_lens.long() - 1)[:, None]
        raw = torch.where(pinned, final[:, None], raw)
        raw[:, 0] = 0
        mono = torch.cummax(raw, dim=1).values
        ramp = t_ids * (S - 1)
        s = ramp - torch.cummax(-(mono - ramp), dim=1).values  # + cummin
        s = torch.where(pinned, final[:, None], s)
        rev = torch.flip(torch.cummax(torch.flip(s - ramp, [1]), dim=1).values, [1])
        return (ramp + rev).to(torch.int32)


def banded_to_full(lp_band, bounds, U1: int) -> torch.Tensor:
    """Banded (B, T, S) log-probs to the full (B, T, U1) lattice, NEG
    outside the band: out[b, t, u] = lp_band[b, t, u - bounds[b, t]].  An
    exact selection (gather + where), never a float product."""
    B, T, S = lp_band.shape
    rel = (torch.arange(U1, device=lp_band.device)[None, None, :]
           - bounds.long()[:, :, None])
    inband = (rel >= 0) & (rel < S)
    vals = torch.gather(lp_band.float(), 2, rel.clamp(0, S - 1))
    return torch.where(inband, vals, torch.full_like(vals, NEG))


def _simple(joint, audio, text, targets, u_lens, blank: int):
    """The simple joint's (lp_blank, lp_label), V-sharded on a sharded
    joint."""
    if joint.tp_mesh is not None:
        from rnnt_tpu_torch.parallel.partition import simple_joint_log_probs_tp

        return simple_joint_log_probs_tp(joint.simple, audio, text, targets, u_lens,
                                         blank, joint.tp_mesh)
    return simple_joint_log_probs(joint.simple, audio, text, targets, u_lens, blank)


def _banded_fused_log_probs(joint, audio_p, text_p, s_tile, targets_pad,
                            blank: int, band: int, tile: int,
                            grad_clamp: float):
    """(lp_blank, lp_label), (B, T_pad, band) float32, the label NOT yet
    u_len-masked: the banded joint as one fused-kernel call on
    (B * n_t, tile, band) patches.  audio_p (B, T_pad, H) and text_p
    (B, U+1, H) are side-projected; s_tile (B, n_t) band starts."""
    from rnnt_tpu_torch.ops.transducer_pallas import fused_joint_outputs

    B, T_pad, H = audio_p.shape
    n_t = T_pad // tile
    dt = audio_p.dtype
    idx = s_tile.long()[:, :, None] + torch.arange(band, device=audio_p.device)
    b_idx = torch.arange(B, device=audio_p.device)[:, None, None]
    text_band = text_p.to(dt)[b_idx, idx]                 # (B, n_t, band, H)
    labels = targets_pad[b_idx, idx]                      # (B, n_t, band)
    lse, blank_logit, label_logit = fused_joint_outputs(
        audio_p.reshape(B * n_t, tile, H).contiguous(),
        text_band.reshape(B * n_t, band, H).contiguous(),
        joint.out.w.to(dt).contiguous(), joint.out.b.float().contiguous(),
        labels.reshape(B * n_t, band).to(torch.int32).contiguous(), blank,
        grad_clamp, mesh=joint.tp_mesh)
    return ((blank_logit - lse).reshape(B, T_pad, band),
            (label_logit - lse).reshape(B, T_pad, band))


def pruned_warmup_loss(joint, audio, text, targets, t_lens, u_lens,
                       blank: int, *, simple_scale: float = 0.5,
                       chunk_size: int = 32, reduction: str = "mean",
                       grad_clamp: float = -1.0):
    """Warmup objective: the exact full-lattice loss (the fused kernels on
    CUDA, the chunked path on the CPU) plus ``simple_scale`` x the
    simple-joint NLL, so the bands are informed by trained simple heads
    when the banded loss takes over."""
    from rnnt_tpu_torch.models.rnnt import resolve_loss_impl
    from rnnt_tpu_torch.ops.transducer import transducer_loss
    from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas

    lpb_s, lpl_s = _simple(joint, audio, text, targets, u_lens, blank)
    losses_simple = lattice_nll(lpb_s, lpl_s, t_lens, u_lens)
    args = (joint, audio, text, targets, t_lens, u_lens, blank)
    if joint.tp_mesh is not None or resolve_loss_impl("auto", audio.device) == "pallas":
        exact = transducer_loss_pallas(*args, grad_clamp=grad_clamp,
                                       reduction="none")
    else:
        exact = transducer_loss(*args, chunk_size=chunk_size,
                                grad_clamp=grad_clamp, reduction="none")
    return reduce_losses(exact + simple_scale * losses_simple, reduction)


def pruned_transducer_loss(joint, audio, text, targets, t_lens, u_lens,
                           blank: int, *, band: int = 16,
                           simple_scale: float = 0.5,
                           pruned_scale: float = 1.0,
                           reduction: str = "mean", grad_clamp: float = -1.0):
    """simple_scale x simple NLL + pruned_scale x banded NLL.

    audio (B, T, Da) and text (B, U+1, Dt) are the RAW encoder and
    predictor outputs (side projections are applied here); ``joint`` must
    carry the ``simple`` heads.  Bounds are tile-granular (one band start
    per ``BOUNDS_TILE`` frames) and ``band`` is rounded up to a multiple of
    8.  The banded joint has no chunked path."""
    from rnnt_tpu_torch.models.joint import project_sides

    B, T, _ = audio.shape
    U1 = text.shape[1]
    band = min(-(-band // 8) * 8, U1)
    tile = BOUNDS_TILE

    lpb_s, lpl_s = _simple(joint, audio, text, targets, u_lens, blank)
    losses_simple, gamma = nll_with_occupancy(lpb_s, lpl_s, t_lens, u_lens)

    n_t = -(-T // tile)
    T_pad = n_t * tile
    gamma_tile = F.pad(gamma.detach(), (0, 0, 0, T_pad - T)).reshape(
        B, n_t, tile, U1).sum(dim=2)
    t_lens_tile = -(-t_lens.long() // tile)
    s_tile = prune_bounds(gamma_tile, t_lens_tile, u_lens, band)  # (B, n_t)
    bounds = torch.repeat_interleave(s_tile, tile, dim=1)[:, :T]  # (B, T)

    audio_p, text_p = project_sides(joint, audio, text)
    targets_pad = torch.cat([targets, targets.new_zeros((B, 1))], dim=1)
    lp_blank, lp_label = _banded_fused_log_probs(
        joint, F.pad(audio_p, (0, 0, 0, T_pad - T)), text_p, s_tile,
        targets_pad, blank, band, tile, grad_clamp)
    lp_blank = lp_blank[:, :T]
    idx_f = bounds.long()[:, :, None] + torch.arange(band, device=audio.device)
    lp_label = torch.where(idx_f < u_lens.long()[:, None, None],
                           lp_label[:, :T], torch.full_like(lp_blank, NEG))

    losses_pruned = lattice_nll(banded_to_full(lp_blank, bounds, U1),
                                banded_to_full(lp_label, bounds, U1),
                                t_lens, u_lens)
    # A target the band cannot reach has an unreachable final cell, NLL
    # ~ -NEG: cap it; its pruned gradient is ~0 and the simple loss trains it.
    losses_pruned = torch.clamp(losses_pruned, max=1e6)
    return reduce_losses(simple_scale * losses_simple
                         + pruned_scale * losses_pruned, reduction)
