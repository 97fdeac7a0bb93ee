"""The one traffic generator: it reads a mix's parameters (a JSON file in
``benchmark/traffic``) and makes the inputs from the run's seed.

Every seed gets the same set of sizes in another order: utterance lengths
lie on an even grid over the mix's ``seconds`` range and the seed permutes
them, so two seeds do the same work.  Audio is band-limited noise plus
three tones of random pitch and level (the port's synthetic corpus
recipe), drawn on the card in bulk and sent as the int16 wire format;
transcripts are ``tokens_per_second`` times the length, rounded, of ids
drawn uniformly from the text vocabulary.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
WIRE_SCALE = 16384.0


def seconds_grid(mix: dict, n: int, seed: int) -> np.ndarray:
    lo, hi = mix["seconds"]
    grid = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return grid[np.random.RandomState(seed % 2 ** 32).permutation(n)]


def token_count(seconds: float, mix: dict, cap: int) -> int:
    return int(min(max(round(seconds * mix["tokens_per_second"]), 1), cap))


@torch.no_grad()
def wire_audio(lens, width: int, g: torch.Generator, device, block: int = 256):
    """(n, width) int16 rows on ``device``; row i holds ``lens[i]`` samples
    of audio, zeros after."""
    lens_t = torch.as_tensor(np.asarray(lens), device=device)
    out = torch.zeros((len(lens), width), dtype=torch.int16, device=device)
    t = torch.arange(width, device=device, dtype=torch.float32) / SAMPLE_RATE
    for s in range(0, len(lens), block):
        n = min(block, len(lens) - s)
        x = torch.randn((n, width), generator=g, device=device).mul_(0.05)
        f = torch.rand((n, 3), generator=g, device=device) * 3900 + 100
        a = torch.rand((n, 3), generator=g, device=device) * 0.08 + 0.02
        for k in range(3):
            x += a[:, k, None] * torch.sin(2 * math.pi * f[:, k, None] * t[None])
        keep = torch.arange(width, device=device)[None] < lens_t[s: s + n, None]
        x = torch.where(keep, x, torch.zeros_like(x))
        out[s: s + n] = torch.clamp(torch.round(x * WIRE_SCALE), -32768, 32767).to(torch.int16)
    return out


def transcripts(counts, width: int, vocab: int, g: torch.Generator, device):
    """(n, width) int32 ids, row i's first ``counts[i]`` drawn in [0, vocab)."""
    ids = torch.randint(0, vocab, (len(counts), width), generator=g, device=device,
                        dtype=torch.int32)
    keep = torch.arange(width, device=device)[None] < torch.as_tensor(
        np.asarray(counts), device=device)[:, None]
    return torch.where(keep, ids, torch.zeros_like(ids))


def samples_for_frames(frames: int, fz: dict) -> int:
    """The fewest samples that give ``frames`` frames: a centred featurizer
    pads ``n_fft // 2`` on both sides and gives ``samples // hop + 1``."""
    if fz["center"]:
        return (frames - 1) * fz["hop_length"]
    return fz["n_fft"] + (frames - 1) * fz["hop_length"]


def utterances(mix: dict, n: int, seed: int):
    """Host (lens in samples, token counts) of n utterances of the mix."""
    secs = seconds_grid(mix, n, seed)
    lens = np.round(secs * SAMPLE_RATE).astype(np.int64)
    cap = max(mix["token_buckets"])
    counts = np.array([token_count(s, mix, cap) for s in secs], np.int64)
    return lens, counts
