"""Spectrogram featurizers over raw waveforms, and the streaming featurizer.

Port of ``rnnt_tpu/ops/stft.py``: a 201-bin power STFT
(n_fft = win = 400, hop 160, periodic Hann, center=False, onesided) as ONE
strided convolution with a (2*bins, 1, n_fft) windowed-DFT basis, an
optional mel filterbank, and the ``piecewise``, ``old_piecewise`` and
``log`` compressions with scalar or per-channel normalization.  Output is
(B, frames, bins) float32.  ``FeatureStreamer`` featurizes audio fed in
pieces of any length: it keeps ``n_fft - hop`` samples of overlap, so the
streamed frames are the full utterance's frames.

On a CUDA card the float32 conv goes through cuDNN, which runs TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; a card-side comparison with
the JAX package sets it False.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

_INT16_GAIN = float(np.iinfo(np.int16).max) ** 2


@dataclass(frozen=True)
class FeaturizerSpec:
    """Static featurizer description; ``log_mode`` is ``"piecewise"``,
    ``"old_piecewise"`` or ``"log"``."""

    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 160
    num_mels: int = 0          # 0 => linear power spectrogram (n_fft//2+1 bins)
    sample_rate: int = 16000   # only used for the mel filterbank
    log_mode: str = "piecewise"
    x_cutoff: float = 10e-3
    slope: float = 50.0
    mean: tuple | float = 15.0
    invstddev: tuple | float = 0.25
    center: bool = False

    @property
    def num_bins(self) -> int:
        return self.num_mels if self.num_mels else self.n_fft // 2 + 1

    @property
    def overlap(self) -> int:
        """Samples of history a streaming chunk must keep: frame - hop."""
        return self.n_fft - self.hop_length

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            return num_samples // self.hop_length + 1
        if num_samples < self.n_fft:
            return 0
        return (num_samples - self.n_fft) // self.hop_length + 1

    def samples_for_frames(self, frames: int) -> int:
        """Smallest sample count yielding exactly ``frames`` frames."""
        if self.center:
            return max((frames - 1) * self.hop_length, 0)
        return self.n_fft + (frames - 1) * self.hop_length


def _hann(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def _dft_basis(spec: FeaturizerSpec) -> np.ndarray:
    """Windowed real-DFT basis (n_fft, 2*bins): all cosines, then all sines;
    a shorter window sits centred in the n_fft frame (torch.stft's rule)."""
    bins = spec.n_fft // 2 + 1
    k = np.arange(spec.n_fft)[:, None]
    f = np.arange(bins)[None, :]
    angle = 2.0 * np.pi * f * k / spec.n_fft
    window = np.zeros(spec.n_fft, np.float32)
    left = (spec.n_fft - spec.win_length) // 2
    window[left:left + spec.win_length] = _hann(spec.win_length)
    window = window[:, None]
    real = (np.cos(angle) * window).astype(np.float32)
    imag = (-np.sin(angle) * window).astype(np.float32)
    return np.concatenate([real, imag], axis=1)


def _mel_filterbank(spec: FeaturizerSpec) -> np.ndarray:
    """HTK-scale triangular mel filterbank (torchaudio defaults), shape
    (n_fft//2+1, num_mels)."""
    n_freqs = spec.n_fft // 2 + 1
    f_max = spec.sample_rate / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, spec.sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(f_max), spec.num_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def piecewise_linear_log(x: torch.Tensor, x_cutoff: float = 10e-3,
                         slope: float = 50.0) -> torch.Tensor:
    """Log above the cutoff, the continuing line below it."""
    intercept = math.log(x_cutoff) - slope * x_cutoff
    safe = torch.clamp(x, min=x_cutoff)
    return torch.where(x > x_cutoff, torch.log(safe), slope * x + intercept)


def old_piecewise_linear_log(x: torch.Tensor) -> torch.Tensor:
    """Scale by int16_max**2, then log above e, divide by e below."""
    x = x * _INT16_GAIN
    safe = torch.clamp(x, min=math.e)
    return torch.where(x > math.e, torch.log(safe), x / math.e)


def make_featurizer(spec: FeaturizerSpec):
    """``featurize(waveform (B, L) or (L,)) -> (B, frames, bins)`` float32,
    on the waveform's device."""
    if spec.log_mode not in ("piecewise", "old_piecewise", "log"):
        raise ValueError(f"unknown log_mode: {spec.log_mode}")
    basis_np = _dft_basis(spec).T[:, None, :].copy()  # (2*bins, 1, n_fft)
    mel_np = _mel_filterbank(spec) if spec.num_mels else None
    bins = spec.n_fft // 2 + 1
    consts: dict = {}

    def on(device):
        if device not in consts:
            consts[device] = (
                torch.from_numpy(basis_np).to(device),
                None if mel_np is None else torch.from_numpy(mel_np).to(device),
                torch.tensor(spec.mean, dtype=torch.float32, device=device),
                torch.tensor(spec.invstddev, dtype=torch.float32, device=device))
        return consts[device]

    def featurize(waveform: torch.Tensor) -> torch.Tensor:
        squeeze = waveform.dim() == 1
        x = waveform.float()[None] if squeeze else waveform.float()
        basis, mel_fb, mean, invstd = on(x.device)
        x = x[:, None, :]  # (B, 1, L)
        if spec.center:
            pad = spec.n_fft // 2
            x = F.pad(x, (pad, pad), mode="reflect")
        stft = F.conv1d(x, basis, stride=spec.hop_length).transpose(1, 2)
        power = stft[:, :, :bins] ** 2 + stft[:, :, bins:] ** 2
        if mel_fb is not None:
            power = torch.matmul(power, mel_fb)
        if spec.log_mode == "piecewise":
            feats = piecewise_linear_log(power, spec.x_cutoff, spec.slope)
        elif spec.log_mode == "old_piecewise":
            feats = old_piecewise_linear_log(power + 1e-6)
        else:
            feats = torch.log(power + 1e-6)
        feats = (feats - mean) * invstd
        return feats[0] if squeeze else feats

    return featurize


class FeatureStreamer:
    """Streaming featurizer: a host buffer of samples, from which each
    ``process`` featurizes the whole frames it holds plus the ``overlap``
    samples the next frame shares with them, so the concatenated frames
    equal the full utterance's.  The featurizer runs on ``device``."""

    def __init__(self, spec: FeaturizerSpec, device="cpu"):
        if spec.center:
            raise ValueError(
                "centered featurizers are not streamable; use a "
                "center=False (TFJS-variant) spec for streaming")
        self.spec = spec
        self.device = torch.device(device)
        self.featurize = make_featurizer(spec)
        self.reset()

    def reset(self):
        self._buffer = np.zeros((0,), dtype=np.float32)

    def process(self, samples: np.ndarray) -> torch.Tensor | None:
        """Feed samples; returns the new frames (frames, bins) on the
        streamer's device, or None while no whole frame is buffered."""
        self._buffer = np.concatenate([self._buffer, np.asarray(samples, np.float32)])
        n = self.spec.num_frames(len(self._buffer))
        if n == 0:
            return None
        consumed = n * self.spec.hop_length
        chunk = self._buffer[: consumed + self.spec.overlap]
        self._buffer = self._buffer[consumed:]
        with torch.inference_mode():
            return self.featurize(torch.from_numpy(chunk).to(self.device))
