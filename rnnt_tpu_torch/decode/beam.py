"""Batched frame-synchronous beam search over the transducer.

Port of ``rnnt_tpu/decode/beam.py`` with the same defaults: a Python loop
over batched tensor ops in place of the nested ``lax.while_loop``.  All
hypothesis state — token buffers (B, K, L), counts, scores and the
predictor's feature and state (B*K, ...) — lives in fixed-shape tensors;
every expansion round scores a (B, K + K*V) candidate pool (K stays, then
K*V emissions), takes the top K and gathers beam state by parent index.

* Blank-run skip (``frames_per_step`` W): each iteration scores W frames
  against the current predictor features in one ``joint_window`` call and
  finds, per utterance, the first frame at which an emission would enter
  the top K; the blank-only prefix before it is consumed in bulk (a cumsum
  of the blank log-probs), and only that frame runs the expansion rounds.
  The test assumes the tie rule below: an emission enters iff it strictly
  beats the worst stay under the search's ranking.
* Tie rule: ``lax.top_k`` puts the lower index first among equal values,
  and stays precede emissions in the pool.  ``torch.topk`` promises no
  order on ties, so ``top_k`` takes the first K of a stable descending
  sort.  Dead lanes start at ``NEG`` = -1e30, where ``NEG + lp == NEG`` in
  float32, so exact ties happen at every frame: the rule decides which
  parent a dead lane copies, and so the N-best list rescoring sees.
* Scores are float32: the joint's logits are cast before ``log_softmax``.
* ``search_norm`` ranks the pool by score / (tokens + 1) but carries raw
  path scores; the skip test ranks the same way.
* ``merge_paths`` log-sum-exps lanes with equal label histories at every
  frame boundary (``merge_duplicate_scores``).
* ``beam_decode`` picks the best lane (length-normalized with
  ``length_norm``); ``greedy_guard`` also runs the K = 1 raw-ranked search
  and keeps it for an utterance where it scores higher.
* ``beam_decode_nbest`` returns every final lane (+ the K = 1 chain) for
  ``decode/rescore.py``.

Each expansion round ends in one host sync (does any lane still expand?),
and each window iteration in one more (is any utterance still running?);
the ``BeamResult`` of ``beam_search_final`` counts them, the rounds and the
iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rnnt_tpu_torch.decode.greedy import (
    make_predictor_stepper, tree_map, tree_where)
from rnnt_tpu_torch.models.joint import joint_single, joint_window

NEG = -1e30


class BeamState(NamedTuple):
    tokens: torch.Tensor     # (B, K, L) long, blank past n
    n: torch.Tensor          # (B, K) long
    score: torch.Tensor      # (B, K) float32
    pred_feat: torch.Tensor  # (B*K, D)
    pred_state: object       # the predictor state, leaves (B*K, ...)


class BeamResult(NamedTuple):
    state: BeamState
    rounds: int              # expansion rounds run (the blank-forced ones included)
    iterations: int          # window iterations
    syncs: int               # host syncs of the loop's exit tests


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in index order (``lax.top_k``'s tie rule)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def merge_duplicate_scores(tokens: torch.Tensor, n: torch.Tensor,
                           score: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp scores of lanes with identical label histories.

    tokens (B, K, L) blank-padded, n (B, K), score (B, K).  The lowest lane
    of each duplicate group carries the merged score; the others drop to
    NEG.  Dead lanes (score <= NEG / 2) keep their score."""
    K = score.shape[1]
    eq = (tokens[:, :, None, :] == tokens[:, None, :, :]).all(dim=-1)
    eq &= n[:, :, None] == n[:, None, :]
    live = score > NEG / 2
    eq &= live[:, :, None] & live[:, None, :]
    first = eq.to(torch.int32).argmax(dim=-1)
    is_canon = (first == torch.arange(K, device=score.device)[None, :]) & live
    contrib = torch.where(eq, score[:, None, :], torch.full_like(eq, NEG, dtype=score.dtype))
    merged = torch.logsumexp(contrib, dim=-1)
    return torch.where(is_canon, merged,
                       torch.where(live, torch.full_like(score, NEG), score))


def beam_decode(predictor, joint, audio: torch.Tensor, t_lens: torch.Tensor,
                predictor_spec, joint_spec, *, beam_width: int = 8,
                max_tokens: int = 200, expansions_per_frame: int = 10,
                length_norm: bool = True, merge_paths: bool = True,
                frames_per_step: int = 8, search_norm: bool = True,
                greedy_guard: bool = True):
    """audio (B, T, H) encoder output, t_lens (B,) -> (tokens (B, max_tokens)
    int32, counts (B,) int32, scores (B,) float32) of the best hypothesis
    per utterance."""
    kw = dict(max_tokens=max_tokens, expansions_per_frame=expansions_per_frame,
              frames_per_step=frames_per_step)
    final = beam_search_final(predictor, joint, audio, t_lens, predictor_spec,
                              joint_spec, beam_width=beam_width,
                              merge_paths=merge_paths, search_norm=search_norm,
                              **kw).state
    ranked = final.score / final.n.clamp(min=1).float() if length_norm else final.score
    best = ranked.argmax(dim=1)
    rows = torch.arange(best.shape[0], device=best.device)
    tokens, counts, scores = final.tokens[rows, best], final.n[rows, best], final.score[rows, best]

    if greedy_guard and beam_width > 1:
        g_tokens, g_counts, g_scores = beam_decode(
            predictor, joint, audio, t_lens, predictor_spec, joint_spec,
            beam_width=1, length_norm=False, merge_paths=False,
            search_norm=False, greedy_guard=False, **kw)
        use_g = g_scores > scores
        tokens = torch.where(use_g[:, None], g_tokens.long(), tokens)
        counts = torch.where(use_g, g_counts.long(), counts)
        scores = torch.where(use_g, g_scores, scores)
    return tokens.to(torch.int32), counts.to(torch.int32), scores


def beam_search_final(predictor, joint, audio: torch.Tensor, t_lens: torch.Tensor,
                      predictor_spec, joint_spec, *, beam_width: int = 8,
                      max_tokens: int = 200, expansions_per_frame: int = 10,
                      merge_paths: bool = True, frames_per_step: int = 8,
                      search_norm: bool = True) -> BeamResult:
    """The frame-synchronous search (``_beam_search_final``); returns every
    final lane and the loop's counts."""
    B, T, _ = audio.shape
    K = beam_width
    W = max(1, min(frames_per_step, T))
    V = joint_spec.num_classes
    blank = joint_spec.blank_idx
    dev = audio.device
    L = max_tokens

    feat0, state0, pred_step = make_predictor_stepper(
        predictor, predictor_spec, blank, B * K, dev)
    score0 = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    score0[:, 0] = 0.0
    state = BeamState(
        tokens=torch.full((B, K, L), blank, dtype=torch.long, device=dev),
        n=torch.zeros((B, K), dtype=torch.long, device=dev),
        score=score0, pred_feat=feat0, pred_state=state0)
    t_lens = t_lens.long()
    rows = torch.arange(B, device=dev)
    lanes = torch.arange(K, device=dev)
    offs = torch.arange(W, device=dev)
    counts = dict(rounds=0, iterations=0, syncs=0)

    def gather_beams(x, parent):
        """x (B*K, ...) -> the parents' rows, (B*K, ...)."""
        xk = x.reshape((B, K) + x.shape[1:])
        return xk[rows[:, None], parent].reshape(x.shape)

    def expansion_round(st: BeamState, expanding, allow_emit: bool, frame):
        counts["rounds"] += 1
        lp = torch.log_softmax(joint_single(joint, frame, st.pred_feat).float(),
                               dim=-1).reshape(B, K, V)
        stay = torch.where(expanding, st.score + lp[..., blank], st.score)
        if allow_emit:
            emit = torch.where(expanding[..., None], st.score[..., None] + lp, NEG)
            emit[..., blank] = NEG
            # No emissions past the token buffer.
            emit = torch.where((st.n < L)[..., None], emit, NEG)
            pool = torch.cat([stay, emit.reshape(B, K * V)], dim=1)
        else:
            pool = stay
        if search_norm:
            # Rank by per-token score, carry raw path scores.
            u1 = (st.n + 1).float()
            u_pool = u1 if not allow_emit else torch.cat(
                [u1, (u1 + 1.0)[..., None].expand(B, K, V).reshape(B, K * V)], dim=1)
            _, top_idx = top_k(pool / u_pool, K)
            top_score = pool.gather(1, top_idx)
        else:
            top_score, top_idx = top_k(pool, K)
        is_emit = top_idx >= K
        parent = torch.where(is_emit, torch.div(top_idx - K, V, rounding_mode="floor"),
                             top_idx)
        token = torch.where(is_emit, (top_idx - K) % V, blank)

        tokens = st.tokens[rows[:, None], parent]
        n = st.n.gather(1, parent)
        slot = n.clamp(0, L - 1)
        cur = tokens.gather(2, slot[..., None])[..., 0]
        tokens[rows[:, None], lanes[None, :], slot] = torch.where(is_emit, token, cur)
        n = torch.where(is_emit, n + 1, n)

        pred_feat = gather_beams(st.pred_feat, parent)
        pred_state = tree_map(lambda x: gather_beams(x, parent), st.pred_state)
        if allow_emit:
            # Only the lanes that took an emission take the stepped state.
            stepped_feat, stepped_state = pred_step(pred_state, token.reshape(B * K))
            emit_flat = is_emit.reshape(B * K)
            pred_feat = torch.where(emit_flat[:, None], stepped_feat, pred_feat)
            pred_state = tree_where(emit_flat, stepped_state, pred_state)
        return BeamState(tokens, n, top_score, pred_feat, pred_state), is_emit

    def process_frame(st: BeamState, frame) -> BeamState:
        """Expansion rounds until no lane expands (at most
        ``expansions_per_frame``), the blank-forced round, then the merge."""
        expanding = torch.ones((B, K), dtype=torch.bool, device=dev)
        for _ in range(expansions_per_frame):
            counts["syncs"] += 1
            if not bool(expanding.any()):
                break
            st, expanding = expansion_round(st, expanding, True, frame)
        st, _ = expansion_round(st, expanding, False, frame)
        if merge_paths:
            st = st._replace(score=merge_duplicate_scores(st.tokens, st.n, st.score))
        return st

    t = torch.zeros((B,), dtype=torch.long, device=dev)
    while True:
        act = t < t_lens
        counts["syncs"] += 1
        if not bool(act.any()):
            break
        counts["iterations"] += 1
        pos = t[:, None] + offs[None, :]                                   # (B, W)
        in_range = pos < t_lens[:, None]
        frames = audio[rows[:, None], pos.clamp(0, T - 1)]                 # (B, W, H)
        lp = torch.log_softmax(
            joint_window(joint, frames.repeat_interleave(K, dim=0), state.pred_feat)
            .float(), dim=-1).reshape(B, K, W, V)

        # Scores if every hypothesis stays blank through the window;
        # out-of-range frames add nothing and cannot emit.
        blank_lp = torch.where(in_range[:, None, :], lp[..., blank], 0.0)
        cum = blank_lp.cumsum(dim=-1)                                      # (B, K, W)
        cum_before = cum - blank_lp
        stay_w = state.score[:, :, None] + cum
        emit_lp = lp.clone()
        emit_lp[..., blank] = NEG
        emit_lp = torch.where(in_range[:, None, :, None], emit_lp, NEG)
        emit_lp = torch.where((state.n < L)[:, :, None, None], emit_lp, NEG)
        emit_cand = state.score[:, :, None, None] + cum_before[..., None] + emit_lp
        # The K stays win ties, so an emission enters the top K iff it
        # strictly beats the worst stay under the rounds' ranking.
        if search_norm:
            u1w = (state.n + 1).float()[:, :, None]                        # (B, K, 1)
            emit_best = (emit_cand / (u1w + 1.0)[..., None]).amax(dim=(1, 3))
            emits_at = emit_best > (stay_w / u1w).amin(dim=1)              # (B, W)
        else:
            emit_best = emit_cand.amax(dim=(1, 3))
            emits_at = emit_best > stay_w.amin(dim=1)
        has_emit = emits_at.any(dim=1)
        w_star = emits_at.to(torch.int32).argmax(dim=1).long()            # (B,)

        # Consume the blank-only prefix (the whole window when nothing emits).
        gain = torch.where(
            has_emit[:, None],
            cum_before.gather(2, w_star[:, None, None].expand(B, K, 1))[..., 0],
            cum[..., -1])
        skipped = state._replace(score=state.score + gain)
        frame_star = frames[rows, w_star]                                  # (B, H)
        expanded = process_frame(skipped, frame_star.repeat_interleave(K, dim=0))

        emitm = act & has_emit

        def pick(exp, skp, old):
            per_lane = exp.shape[0] != B
            m_e = emitm.repeat_interleave(K) if per_lane else emitm
            m_a = act.repeat_interleave(K) if per_lane else act
            shape = (exp.shape[0],) + (1,) * (exp.dim() - 1)
            return torch.where(m_a.reshape(shape),
                               torch.where(m_e.reshape(shape), exp, skp), old)

        state = BeamState(*(tree_map(pick, e, s, o)
                            for e, s, o in zip(expanded, skipped, state)))
        t = torch.where(act, torch.where(has_emit, t + w_star + 1, t + W), t)
    return BeamResult(state, counts["rounds"], counts["iterations"], counts["syncs"])


def beam_decode_nbest(predictor, joint, audio: torch.Tensor, t_lens: torch.Tensor,
                      predictor_spec, joint_spec, *, beam_width: int = 8,
                      max_tokens: int = 200, include_greedy: bool = True, **kwargs):
    """Every final lane as an N-best list: (tokens (B, C, L) int32, counts
    (B, C) int32, scores (B, C)) with C = beam_width (+1 with
    ``include_greedy``: the K = 1 raw-ranked chain) — the candidates of
    ``decode/rescore.py marginal_rescore``."""
    final = beam_search_final(predictor, joint, audio, t_lens, predictor_spec,
                              joint_spec, beam_width=beam_width,
                              max_tokens=max_tokens, **kwargs).state
    tokens, counts, scores = final.tokens.to(torch.int32), final.n.to(torch.int32), final.score
    if include_greedy and beam_width > 1:
        g_tokens, g_counts, g_scores = beam_decode(
            predictor, joint, audio, t_lens, predictor_spec, joint_spec,
            beam_width=1, max_tokens=max_tokens, length_norm=False,
            merge_paths=False, search_norm=False, greedy_guard=False)
        tokens = torch.cat([tokens, g_tokens[:, None]], dim=1)
        counts = torch.cat([counts, g_counts[:, None]], dim=1)
        scores = torch.cat([scores, g_scores[:, None]], dim=1)
    return tokens, counts, scores
