"""The sequence-parallel (T-sharded) transducer lattice over the mesh's
``model`` group.

Port of ``rnnt_tpu/ops/lattice_tshard.py``.  Each model rank holds one
contiguous block of the lattice's T rows and runs the chain stages on it:

* forward: K6 (``alpha_chain_forward``) once the previous rank's (B, U)
  carry row has arrived, then the carry goes on to the next rank; the
  shards' log-likelihood parts are summed over the group, so every rank
  returns the whole per-sample NLL;
* backward: K7 (``beta_chain_backward``) in reverse rank order with the
  beta carry, giving the gradient of this rank's block only.

The recursion over T is sequential, so the chain scales memory, not
latency: per-rank O(T / n) lattice state.  T is padded so that every rank
holds an equal block of ``ceil(T / n)`` rows; padded ``lp_label`` rows are
NEG and padded ``lp_blank`` rows 0 (the reference's ``:183-188``).  The
carry rows cross ranks by ``parallel/mesh.py``'s ``send_row`` /
``recv_row``.  On CPU tensors the stages run their plain versions in
float64, as ``LatticeNLL`` does.
"""

from __future__ import annotations

import torch

from rnnt_tpu_torch.ops.lattice_pallas import (
    _dp_input,
    alpha_chain_forward,
    beta_chain_backward,
)
from rnnt_tpu_torch.ops.transducer import NEG
from rnnt_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, recv_row, send_row


def t_block(T: int, mesh: Mesh) -> tuple[int, int, int]:
    """(start, stop, rows): this rank's rows [start, stop) of a T-row
    lattice and the padded block height ``rows = ceil(T / model)``."""
    rows = -(-T // mesh.model)
    start = min(mesh.model_rank * rows, T)
    return start, min(start + rows, T), rows


def pad_block(lp_blank, lp_label, rows: int):
    """Pad a block of lattice rows to ``rows``: lp_blank with 0, lp_label
    with NEG (rows no path can take)."""
    pad = rows - lp_blank.shape[1]
    if pad == 0:
        return lp_blank, lp_label
    B, _, U = lp_blank.shape
    return (torch.cat([lp_blank, lp_blank.new_zeros((B, pad, U))], dim=1),
            torch.cat([lp_label, lp_label.new_full((B, pad, U), NEG)], dim=1))


class TShardedNLL(torch.autograd.Function):
    """Per-sample NLL (B,) float32 of the lattice whose block of rows this
    rank holds; differentiable in the block."""

    @staticmethod
    def forward(ctx, lp_blank, lp_label, t_lens, u_lens, mesh: Mesh):
        lpb, lpl = _dp_input(lp_blank), _dp_input(lp_label)
        B, rows, U = lpb.shape
        r, n = mesh.model_rank, mesh.model
        t0 = r * rows
        carry = lpb.new_full((B, U), NEG)
        if r > 0:
            carry = recv_row(carry, mesh.model_peer(r - 1), mesh)
        alphas, ll, carry = alpha_chain_forward(lpb, lpl, t_lens, u_lens, t0, carry)
        if r < n - 1:
            send_row(carry, mesh.model_peer(r + 1), mesh)
        if n > 1:
            ll = all_reduce_sum(ll, mesh.model_group)
        ctx.mesh, ctx.t0 = mesh, t0
        ctx.save_for_backward(lpb, lpl, alphas, t_lens, u_lens, ll)
        return (-ll).float()

    @staticmethod
    def backward(ctx, g):
        lpb, lpl, alphas, t_lens, u_lens, ll = ctx.saved_tensors
        mesh = ctx.mesh
        r, n = mesh.model_rank, mesh.model
        carry = lpb.new_full((lpb.shape[0], lpb.shape[2]), NEG)
        if r < n - 1:
            carry = recv_row(carry, mesh.model_peer(r + 1), mesh)
        glpb, glpl, carry = beta_chain_backward(
            lpb, lpl, alphas, t_lens, u_lens, ll, g.to(ll.dtype).contiguous(),
            ctx.t0, carry)
        if r > 0:
            send_row(carry, mesh.model_peer(r - 1), mesh)
        return glpb.float(), glpl.float(), None, None, None


def tsharded_block_nll(lp_blank, lp_label, t_lens, u_lens, mesh: Mesh):
    """Per-sample NLL (B,) from this rank's block of lattice rows: rows
    ``t_block(T, mesh)`` padded to the block height by ``pad_block``.
    Every rank of the model group calls it with its own block."""
    return TShardedNLL.apply(
        lp_blank.float().contiguous(), lp_label.float().contiguous(),
        t_lens.to(torch.int32).contiguous(), u_lens.to(torch.int32).contiguous(),
        mesh)


def transducer_alpha_loss_tsharded(lp_blank, lp_label, t_lens, u_lens,
                                   mesh: Mesh):
    """Per-sample NLL (B,) with the T axis sharded over the mesh's model
    group: the reference's contract (``lattice_tshard.py:168-191``), the
    whole (B, T, U) lattice in and every rank's NLL the whole lattice's.
    Each rank takes its block of rows, so its gradient is nonzero on that
    block only; the model group's gradients sum to the lattice's."""
    start, stop, rows = t_block(lp_blank.shape[1], mesh)
    lpb, lpl = pad_block(lp_blank[:, start:stop], lp_label[:, start:stop], rows)
    return tsharded_block_nll(lpb, lpl, t_lens, u_lens, mesh)
