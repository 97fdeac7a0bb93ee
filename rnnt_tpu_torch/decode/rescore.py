"""N-best marginal rescoring: pick each utterance's hypothesis by the
transducer's exact sum-over-alignments NLL instead of the beam's path score.

Port of ``rnnt_tpu/decode/rescore.py``.  The B x C candidates of
``beam_decode_nbest`` (C = beam width + the greedy chain) become B·C
lattices: blank-prepended, 0-padded targets through the predictor, the
encoder output repeated C times, and ``ops/transducer.transducer_loss`` with
``reduction="none"`` — the chunked joint, then the lattice NLL, which is K3
(csrc/alpha_fwd.cu) for CUDA tensors and its plain version for CPU tensors.
The lattice has ``max_tokens + 1`` label columns whatever the candidates'
counts; lanes with count 0 or at the buffer's end are ordinary lattices.
"""

from __future__ import annotations

import torch

from rnnt_tpu_torch.models.predictor import predictor_apply
from rnnt_tpu_torch.models.rnnt import prepend_blank
from rnnt_tpu_torch.ops.transducer import transducer_loss


def rescore_lattice_inputs(predictor, audio, t_lens, tokens, counts, blank: int):
    """(audio (B*C, T, H), text (B*C, L+1, D), targets (B*C, L) 0-padded
    past the counts, t_lens (B*C,), u_lens (B*C,)): the rescoring lattices."""
    B, C, L = tokens.shape
    flat_counts = counts.reshape(B * C).long()
    pos = torch.arange(L, device=tokens.device)
    tgt = torch.where(pos[None, :] < flat_counts[:, None],
                      tokens.reshape(B * C, L).long(), 0)
    text = predictor_apply(predictor, prepend_blank(tgt, blank))
    audio_c = audio.repeat_interleave(C, dim=0).to(text.dtype)
    return audio_c, text, tgt, t_lens.repeat_interleave(C), flat_counts


def marginal_rescore(predictor, joint, audio: torch.Tensor, t_lens: torch.Tensor,
                     tokens: torch.Tensor, counts: torch.Tensor, predictor_spec,
                     joint_spec, *, chunk_size: int = 16):
    """audio (B, T, H) encoder output; tokens (B, C, L) blank-padded
    candidates with counts (B, C).  Returns (best_tokens (B, L), best_counts
    (B,), nlls (B, C)): per utterance the candidate of least exact NLL, the
    first of equal ones (``jnp.argmin``'s rule); a non-finite NLL counts as
    inf."""
    B, C, _ = tokens.shape
    blank = joint_spec.blank_idx
    audio_c, text, tgt, tl_c, u_lens = rescore_lattice_inputs(
        predictor, audio, t_lens, tokens, counts, blank)
    nll = transducer_loss(joint, audio_c, text, tgt, tl_c, u_lens, blank,
                          chunk_size=chunk_size, reduction="none").reshape(B, C)
    nll = torch.where(torch.isfinite(nll), nll, torch.inf)
    best = nll.argmin(dim=1)
    rows = torch.arange(B, device=best.device)
    return tokens[rows, best], counts[rows, best], nll
