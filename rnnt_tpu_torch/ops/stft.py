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

``log_mode="nemo"`` is NeMo's ``AudioToMelSpectrogramPreprocessor`` as
parakeet-rnnt-0.6b uses it (no dither): pre-emphasis ``y[n] = x[n] -
0.97 x[n-1]`` with samples at or past the row's length zeroed, a
symmetric Hann window of ``win_length`` centred in ``n_fft``, a centred
STFT with zero padding, the power, a Slaney-scale, Slaney-normalised mel
filterbank over 0 Hz to half the sample rate (librosa's ``htk=False,
norm="slaney"``), ``log(x + 2**-24)``, and per feature the mean over the
row's valid frames (``samples // hop + 1``) subtracted and (unbiased std
+ 1e-5) divided out; frames past the valid ones are 0.  Its featurizer
takes each row's sample count; the others ignore it.
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
    """Static featurizer description; ``log_mode`` is ``"nemo"``, ``"piecewise"``,
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


NEMO_PREEMPH = 0.97
NEMO_LOG_GUARD = 2.0 ** -24
NEMO_STD_EPS = 1e-5


def slaney_mel_filterbank(n_fft: int, num_mels: int, sample_rate: int) -> np.ndarray:
    """(n_fft // 2 + 1, num_mels) float32: triangles evenly spaced on the
    Slaney mel scale (linear below 1 kHz, logarithmic above) from 0 Hz to
    half the sample rate, each scaled to unit area (2 / its width in Hz)."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), num_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return weights.T.astype(np.float32)


def _nemo_featurizer(spec: FeaturizerSpec):
    fb_np = slaney_mel_filterbank(spec.n_fft, spec.num_mels, spec.sample_rate)
    consts: dict = {}

    def on(device):
        if device not in consts:
            consts[device] = (torch.from_numpy(fb_np).to(device),
                              torch.hann_window(spec.win_length, periodic=False,
                                                device=device))
        return consts[device]

    def featurize(waveform: torch.Tensor, lengths: torch.Tensor | None = None):
        squeeze = waveform.dim() == 1
        x = waveform.float()[None] if squeeze else waveform.float()
        B, L = x.shape
        fb, window = on(x.device)
        if lengths is None:
            lengths = torch.full((B,), L, dtype=torch.long, device=x.device)
        lengths = lengths.to(x.device).long()
        keep = torch.arange(L, device=x.device)[None, :] < lengths[:, None]
        x = torch.cat([x[:, :1], x[:, 1:] - NEMO_PREEMPH * x[:, :-1]], dim=1)
        x = torch.where(keep, x, torch.zeros((), device=x.device))
        stft = torch.stft(x, spec.n_fft, hop_length=spec.hop_length,
                          win_length=spec.win_length, window=window, center=True,
                          pad_mode="constant", return_complex=True)
        power = (stft.real ** 2 + stft.imag ** 2).transpose(1, 2)   # (B, frames, bins)
        feats = torch.log(torch.matmul(power, fb) + NEMO_LOG_GUARD)
        valid = (torch.arange(feats.shape[1], device=x.device)[None, :]
                 < (lengths // spec.hop_length + 1)[:, None])[:, :, None]
        n = valid.sum(dim=1, keepdim=True).float()
        mean = torch.where(valid, feats, 0.0).sum(dim=1, keepdim=True) / n
        var = torch.where(valid, (feats - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / (n - 1)
        feats = torch.where(valid, (feats - mean) / (torch.sqrt(var) + NEMO_STD_EPS), 0.0)
        return feats[0] if squeeze else feats

    return featurize


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
    """``featurize(waveform (B, L) or (L,), lengths=None) -> (B, frames,
    bins)`` float32, on the waveform's device; ``lengths`` (B,) samples are
    read by the ``nemo`` featurizer alone (all samples valid when None)."""
    if spec.log_mode == "nemo":
        return _nemo_featurizer(spec)
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

    def featurize(waveform: torch.Tensor, lengths=None) -> torch.Tensor:
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
