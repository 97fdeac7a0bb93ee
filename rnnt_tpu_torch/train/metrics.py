"""Evaluation metrics: word error rate (WER).

The port's own copy of ``rnnt_tpu/train/metrics.py``: corpus WER as a
word-level Levenshtein distance over total reference words.
"""

from __future__ import annotations


def _edit_distance(ref: list[str], hyp: list[str]) -> int:
    """Word-level Levenshtein distance, O(len(ref)·len(hyp))."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1,          # deletion
                         cur[j - 1] + 1,       # insertion
                         prev[j - 1] + (r != h))  # substitution
        prev = cur
    return prev[-1]


def wer(references: list[str], hypotheses: list[str]) -> float:
    """Corpus WER: total edit distance / total reference words
    (jiwer-compatible definition)."""
    if len(references) != len(hypotheses):
        raise ValueError("references and hypotheses must align")
    total_errors = 0
    total_words = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        total_errors += _edit_distance(r, h)
        total_words += len(r)
    if total_words == 0:
        return 0.0 if total_errors == 0 else float("inf")
    return total_errors / total_words
