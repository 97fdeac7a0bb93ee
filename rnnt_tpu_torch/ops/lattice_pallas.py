"""K3 and K4: the alpha and beta lattice recursions as hand-written CUDA
kernels, and the lattice NLL as a ``torch.autograd.Function`` over them;
K6 and K7: the same recursions on one T-shard of the lattice, the stages of
the sequence-parallel chain (ops/lattice_tshard.py).

K3 replaces ``rnnt_tpu/ops/lattice_pallas.py:120`` ``_alpha_kernel``
(launcher ``_alpha_pallas:170``, call ``:178``); K4 replaces ``:353``
``_beta_kernel`` (launcher ``_beta_pallas:397``, call ``:408``).  The module
keeps the reference's name so the two packages line up file by file; the
kernels are CUDA C++ in ``csrc/alpha_fwd.cu`` and ``csrc/beta_bwd.cu``,
built for sm_90a by ``ops/kernels.py``.  K6 replaces ``:204``
``_alpha_chain_kernel`` (``_alpha_chain_pallas:247``, call ``:256``) and K7
``:272`` ``_beta_chain_kernel`` (``_beta_chain_pallas:321``, call ``:335``);
they are ``csrc/alpha_chain.cu`` and ``csrc/beta_chain.cu``.

Bound on an H100: latency.  At the eval shape (B 4, T' 504, U+1 65) K3
moves ~1.6 MB and K4 ~2.6 MB — about 0.5 and 0.8 us at 3.35 TB/s — but the
recursion's critical path is T + U - 1 = 568 dependent log-sum-exps.  All
four are one anti-diagonal wavefront (``csrc/lattice_wave.cuh``): a block
a sample, a thread a column, one LSE and one barrier a diagonal, the
inputs staged through a shared-memory ring by 8-column strips and the
outputs written back the same way.  The alpha sweep is K3 and K6, the beta
sweep K4 and K7, each a kernel template whose ``Chain`` flag adds the
shard's ends (carry in, carry out, local rows at t0); the four ``.cu``
files are their C entry points.

``alpha_plain``, ``beta_plain``, ``alpha_chain_plain`` and
``beta_chain_plain`` are the same functions in plain PyTorch (the CPU path
and the card-side yardsticks; K4's is K7's on the whole lattice, and K3's
and K6's share ``transducer_alpha``).  ``alpha_forward``, ``beta_backward``, ``alpha_chain_forward`` and
``beta_chain_backward`` take the plain versions only for CPU tensors; for
CUDA tensors they launch the kernels or raise.  ``K3.launches`` ..
``K7.launches`` count launches.  ``transducer_alpha_loss_fast`` is K3
forward (saving alpha and the losses) with K4 as its backward, as
``_fast_fwd`` / ``_fast_bwd`` are in the reference; no B, T or U padding.
"""

from __future__ import annotations

import ctypes

import torch

from rnnt_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor
from rnnt_tpu_torch.ops.transducer import (
    NEG, _at_least_f32, _lse, final_nll, transducer_alpha)

_P = ctypes.c_void_p
_I = ctypes.c_int
K3 = CudaKernel(
    "alpha_fwd", "rnnt_alpha_fwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel")
K4 = CudaKernel(
    "beta_bwd", "rnnt_beta_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/lattice_pallas.py:353 _beta_kernel")
K6 = CudaKernel(
    "alpha_chain", "rnnt_alpha_chain",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/lattice_pallas.py:204 _alpha_chain_kernel")
K7 = CudaKernel(
    "beta_chain", "rnnt_beta_chain",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    replaces="rnnt_tpu/ops/lattice_pallas.py:272 _beta_chain_kernel")
U_MAX = 1024


def alpha_chain_plain(lp_blank, lp_label, t_lens, u_lens, t0: int, carry_in):
    """(alphas (B, T, U), ll_part (B,), carry_out (B, U)) of one T-shard in
    plain PyTorch, float32 (float64 for float64 inputs).

    The shard's rows sit at global rows t0 .. t0 + T - 1; the first takes
    carry_in (the previous shard's carry_out) unless it is global row 0
    (``transducer_alpha``).  ll_part is alpha + lp_blank at (t_len - 1,
    u_len) for the samples whose row t_len - 1 the shard holds, 0 for the
    others; carry_out is alpha + lp_blank of the last row."""
    alphas = transducer_alpha(lp_blank, lp_label, t0, carry_in)
    lp_blank = _at_least_f32(lp_blank)
    B, T, _ = alphas.shape
    row = t_lens.long() - 1 - t0  # the local row of t_len - 1
    held = (row >= 0) & (row < T)
    b = torch.arange(B, device=alphas.device)
    at = row.clamp(0, T - 1), u_lens.long()
    ll = torch.where(held, alphas[b, at[0], at[1]] + lp_blank[b, at[0], at[1]], 0.0)
    return alphas, ll, alphas[:, -1] + lp_blank[:, -1]


def alpha_plain(lp_blank, lp_label, t_lens, u_lens):
    """(nll (B,), alpha (B, T, U)) in plain PyTorch, float32 (float64 for
    float64 inputs)."""
    alphas = transducer_alpha(lp_blank, lp_label)
    return final_nll(alphas, lp_blank, t_lens, u_lens), alphas


def _check_lattice(name, lp_blank, lp_label, t_lens, u_lens):
    B, T, U = lp_blank.shape
    dev = lp_blank.device
    check_cuda_tensor("lp_blank", lp_blank, torch.float32, (B, T, U), dev)
    check_cuda_tensor("lp_label", lp_label, torch.float32, (B, T, U), dev)
    check_cuda_tensor("t_lens", t_lens, torch.int32, (B,), dev)
    check_cuda_tensor("u_lens", u_lens, torch.int32, (B,), dev)
    if U > U_MAX:
        raise ValueError(f"{name} takes U <= {U_MAX}, got {U}")


def alpha_forward(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                  t_lens: torch.Tensor, u_lens: torch.Tensor):
    """(nll (B,), alpha (B, T, U)).  lp_blank/lp_label (B, T, U) float32
    with lp_label NEG at u >= u_len; t_lens/u_lens (B,) int32 with
    1 <= t_len <= T and 0 <= u_len < U."""
    if lp_blank.device.type == "cpu":
        return alpha_plain(lp_blank, lp_label, t_lens, u_lens)
    if lp_blank.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or the CPU, got {lp_blank.device}")
    _check_lattice("K3", lp_blank, lp_label, t_lens, u_lens)
    B, T, U = lp_blank.shape
    alphas = torch.empty_like(lp_blank)
    nll = torch.empty((B,), dtype=torch.float32, device=lp_blank.device)
    K3.launch(lp_blank, lp_label, t_lens, u_lens, alphas, nll, B, T, U)
    return nll, alphas


def _check_t0(name, t0) -> int:
    if not (isinstance(t0, int) and t0 >= 0):
        raise ValueError(f"{name} takes a global row offset t0 >= 0, got {t0!r}")
    return t0


def alpha_chain_forward(lp_blank, lp_label, t_lens, u_lens, t0: int, carry_in):
    """(alphas (B, T, U), ll_part (B,), carry_out (B, U)) of one T-shard at
    global row offset ``t0`` (see ``alpha_chain_plain``).  Inputs as
    ``alpha_forward`` takes them (t_len >= 1, possibly past this shard) plus
    carry_in (B, U) float32."""
    t0 = _check_t0("K6", t0)
    if lp_blank.device.type == "cpu":
        return alpha_chain_plain(lp_blank, lp_label, t_lens, u_lens, t0, carry_in)
    if lp_blank.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or the CPU, got {lp_blank.device}")
    _check_lattice("K6", lp_blank, lp_label, t_lens, u_lens)
    B, T, U = lp_blank.shape
    dev = lp_blank.device
    check_cuda_tensor("carry_in", carry_in, torch.float32, (B, U), dev)
    alphas = torch.empty_like(lp_blank)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    carry_out = torch.empty_like(carry_in)
    K6.launch(lp_blank, lp_label, t_lens, u_lens, carry_in, alphas, ll,
              carry_out, B, T, U, t0)
    return alphas, ll, carry_out


def suffix_row_scan(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Row recurrence beta[u] = LSE(d[u], e[u] + beta[u+1]) over (B, U) with
    beta[U] = log-zero: Hillis-Steele over the affine maps composed right
    to left, combine(f, g) = (A_f + A_g, LSE(b_f, A_f + b_g)), the identity
    (0, NEG) filling the last k columns of round k."""
    A, bv = e, d
    B, U = d.shape
    k = 1
    while k < U:
        A_s = torch.cat([A[:, k:], A.new_zeros((B, k))], dim=1)
        b_s = torch.cat([bv[:, k:], bv.new_full((B, k), NEG)], dim=1)
        bv = _lse(bv, A + b_s)
        A = A + A_s
        k *= 2
    return bv


def beta_chain_plain(lp_blank, lp_label, alphas, t_lens, u_lens, ll, g,
                     t0: int, carry_in):
    """(glp_blank, glp_label (B, T, U), carry_out (B, U)) of one T-shard in
    plain PyTorch: the beta recursion in reverse over the shard's rows
    (global rows t0 .. t0 + T - 1; a suffix scan over U per row) from
    beta_next = the seed (0 at u_len) at global t == t_len - 1, else the
    carry (carry_in, the next shard's carry_out, below the last row),
    emitting -g * exp(alpha + lp + beta - ll) per edge with ll the
    log-likelihood, masked inside the exponent for t >= t_len.  carry_out
    is beta at the shard's first row, NEG for the samples with t_len <= t0.
    Computes in the dtype of ``alphas`` (float32, or float64)."""
    dt = alphas.dtype
    lp_blank, lp_label = lp_blank.to(dt), lp_label.to(dt)
    B, T, U = lp_blank.shape
    dev = lp_blank.device
    t_lens = t_lens.long()
    llc = ll.to(dt)[:, None]
    gg = g.to(dt)[:, None]
    seed = torch.where(torch.arange(U, device=dev)[None, :] == u_lens.long()[:, None],
                       0.0, NEG).to(dt)
    glpb = torch.empty_like(lp_blank)
    glpl = torch.empty_like(lp_blank)
    carry = carry_in.to(dt)
    neg_col = torch.full((B, 1), NEG, dtype=dt, device=dev)
    for r in reversed(range(T)):
        t = t0 + r
        beta_next = torch.where((t == t_lens - 1)[:, None], seed, carry)
        beta = suffix_row_scan(lp_blank[:, r] + beta_next, lp_label[:, r])
        beta_up = torch.cat([beta[:, 1:], neg_col], dim=1)
        valid = (t < t_lens)[:, None]
        glpb[:, r] = -gg * torch.exp(torch.where(
            valid, alphas[:, r] + lp_blank[:, r] + beta_next - llc, NEG))
        glpl[:, r] = -gg * torch.exp(torch.where(
            valid, alphas[:, r] + lp_label[:, r] + beta_up - llc, NEG))
        carry = beta
    return glpb, glpl, torch.where((t0 < t_lens)[:, None], carry, NEG)


def beta_plain(lp_blank, lp_label, alphas, t_lens, u_lens, nll, g):
    """(glp_blank, glp_label), both (B, T, U), in plain PyTorch: the chain's
    stage on the whole lattice with ll = -nll."""
    B, _, U = lp_blank.shape
    carry = alphas.new_full((B, U), NEG)  # unread: row t_len - 1 takes the seed
    return beta_chain_plain(lp_blank, lp_label, alphas, t_lens, u_lens, -nll, g,
                            0, carry)[:2]


def beta_backward(lp_blank, lp_label, alphas, t_lens, u_lens, nll, g):
    """(glp_blank, glp_label): the gradient of sum(g * nll) with respect to
    the lattice log-probs.  Inputs as ``alpha_forward`` plus its alpha and
    nll and the cotangent g (B,) float32."""
    if lp_blank.device.type == "cpu":
        return beta_plain(lp_blank, lp_label, alphas, t_lens, u_lens, nll, g)
    if lp_blank.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or the CPU, got {lp_blank.device}")
    _check_lattice("K4", lp_blank, lp_label, t_lens, u_lens)
    B, T, U = lp_blank.shape
    dev = lp_blank.device
    check_cuda_tensor("alphas", alphas, torch.float32, (B, T, U), dev)
    check_cuda_tensor("nll", nll, torch.float32, (B,), dev)
    check_cuda_tensor("g", g, torch.float32, (B,), dev)
    glpb = torch.empty_like(lp_blank)
    glpl = torch.empty_like(lp_blank)
    K4.launch(lp_blank, lp_label, alphas, t_lens, u_lens, nll, g, glpb, glpl,
              B, T, U)
    return glpb, glpl


def beta_chain_backward(lp_blank, lp_label, alphas, t_lens, u_lens, ll, g,
                        t0: int, carry_in):
    """(glp_blank, glp_label (B, T, U), carry_out (B, U)) of one T-shard at
    global row offset ``t0`` (see ``beta_chain_plain``).  Inputs as
    ``alpha_chain_forward`` takes them plus the shard's alphas, the
    log-likelihood ll (B,) and the cotangent g (B,) float32."""
    t0 = _check_t0("K7", t0)
    if lp_blank.device.type == "cpu":
        return beta_chain_plain(lp_blank, lp_label, alphas, t_lens, u_lens, ll,
                                g, t0, carry_in)
    if lp_blank.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or the CPU, got {lp_blank.device}")
    _check_lattice("K7", lp_blank, lp_label, t_lens, u_lens)
    B, T, U = lp_blank.shape
    dev = lp_blank.device
    check_cuda_tensor("alphas", alphas, torch.float32, (B, T, U), dev)
    check_cuda_tensor("ll", ll, torch.float32, (B,), dev)
    check_cuda_tensor("g", g, torch.float32, (B,), dev)
    check_cuda_tensor("carry_in", carry_in, torch.float32, (B, U), dev)
    glpb = torch.empty_like(lp_blank)
    glpl = torch.empty_like(lp_blank)
    carry_out = torch.empty_like(carry_in)
    K7.launch(lp_blank, lp_label, alphas, t_lens, u_lens, ll, g, carry_in,
              glpb, glpl, carry_out, B, T, U, t0)
    return glpb, glpl, carry_out


def _dp_input(x: torch.Tensor) -> torch.Tensor:
    """The lattice DP's operand: float64 for CPU tensors (the alpha and beta
    sums reach O(10^2-10^3), where float32 keeps ~1e-5 of absolute
    precision, and the gradient is exp of their difference), unchanged for
    CUDA tensors (K3 and K4 take float32)."""
    return x.double() if x.device.type == "cpu" else x


class LatticeNLL(torch.autograd.Function):
    """Per-sample NLL (B,) float32: ``alpha_forward`` saving alpha and the
    losses, backward ``beta_backward`` — K3 and K4 for CUDA tensors, their
    plain versions in float64 for CPU tensors."""

    @staticmethod
    def forward(ctx, lp_blank, lp_label, t_lens, u_lens):
        nll, alphas = alpha_forward(_dp_input(lp_blank), _dp_input(lp_label),
                                    t_lens, u_lens)
        ctx.save_for_backward(lp_blank, lp_label, alphas, t_lens, u_lens, nll)
        return nll.float()

    @staticmethod
    def backward(ctx, g):
        lp_blank, lp_label, alphas, t_lens, u_lens, nll = ctx.saved_tensors
        glpb, glpl = beta_backward(lp_blank, lp_label, alphas, t_lens, u_lens,
                                   nll, g.float().contiguous())
        return glpb.float(), glpl.float(), None, None


def nll_and_grads(lp_blank, lp_label, t_lens, u_lens):
    """(nll, d nll / d lp_blank, d nll / d lp_label), float32, from one
    alpha + beta pass with a unit cotangent, on the devices and in the
    precision ``LatticeNLL`` uses."""
    nll, alphas = alpha_forward(_dp_input(lp_blank), _dp_input(lp_label),
                                t_lens, u_lens)
    d_blank, d_label = beta_backward(lp_blank, lp_label, alphas, t_lens, u_lens,
                                     nll, torch.ones_like(nll))
    return nll.float(), d_blank.float(), d_label.float()


def transducer_alpha_loss_fast(lp_blank, lp_label, t_lens, u_lens):
    """Per-sample negative log-likelihood (B,) — same contract as
    ``transducer_alpha_loss``, differentiable in lp_blank and lp_label."""
    return LatticeNLL.apply(lp_blank, lp_label, t_lens, u_lens)
