"""Host-side audio augmentation (numpy/scipy DSP) and SpecAugment.

The port's own copy of ``rnnt_tpu/data/augment.py``: the same numpy/scipy
code, so from the same ``RandomState`` both packages produce bit-equal
audio.  Augmentation families of the original recipe (reference
rnnt/augment.py): probabilistic composition (:39-57), peak-level
normalization (:62-74), white noise with log-sampled level (:77-95), shaped
(band-enveloped) noise (:98-150), tempo change (:153-161), pitch shift via
rate change (:164-173), and leading-edge trim (:176-188), with ffmpeg's
chorus and compressor filters as direct DSP.  These run in host workers and
never touch the device.

``spec_augment`` (time and frequency masking of the features, inside the
train step) is in torch: ``spec_augment_draws`` draws the mask starts and
widths from an explicit ``torch.Generator``, ``spec_augment_apply`` masks,
so a test can feed the reference's draws to the port.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
# scipy is imported here, once, and not inside the functions: the functions
# run in a pool of worker threads, and threads that import scipy at the same
# time can see its package half initialised (ImportError: partially
# initialized module 'scipy._lib._testutils').
from scipy import fft as sfft  # float32-preserving (np.fft upcasts)
from scipy.signal import lfilter, resample_poly


class Augmentation:
    def __init__(self, p: float):
        self.p = p

    def apply(self, audio: np.ndarray, sample_rate: int,
              rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError


class PeakLevel(Augmentation):
    """Normalize to a random peak level (reference rnnt/augment.py:62-74)."""

    def __init__(self, p: float, min_peak_level: float = 0.5,
                 max_peak_level: float = 1.0):
        super().__init__(p)
        self.lo, self.hi = min_peak_level, max_peak_level

    def apply(self, audio, sample_rate, rng):
        peak = np.abs(audio).max()
        if peak == 0:
            return audio
        level = rng.uniform(self.lo, self.hi)
        return audio / peak * level


class WhiteNoise(Augmentation):
    """Uniform noise, log-sampled level (reference rnnt/augment.py:77-95)."""

    def __init__(self, p: float, min_noise_level: float = 0.01,
                 max_noise_level: float = 0.1):
        super().__init__(p)
        self.lo, self.hi = min_noise_level, max_noise_level

    def apply(self, audio, sample_rate, rng):
        level = 10 ** rng.uniform(np.log10(self.lo), np.log10(self.hi))
        noise = rng.uniform(-level, level, size=audio.shape)
        return audio + noise.astype(audio.dtype)


class ShapedNoise(Augmentation):
    """White noise with a random per-band spectral envelope
    (reference rnnt/augment.py:98-150)."""

    def __init__(self, p: float, min_noise_level: float = 0.01,
                 max_noise_level: float = 0.1, num_buckets: int = 256):
        super().__init__(p)
        self.lo, self.hi = min_noise_level, max_noise_level
        self.num_buckets = num_buckets

    def apply(self, audio, sample_rate, rng):
        # The FFT runs at next_fast_len (an arbitrary post-resample length
        # can have large prime factors) and the per-band envelope is built
        # vectorized.  The noise is random, so padding changes no semantics.
        level = 10 ** rng.uniform(np.log10(self.lo), np.log10(self.hi))
        n = len(audio)
        noise = rng.rand(n).astype(np.float32)
        ratios = rng.rand(self.num_buckets)
        ratios /= ratios.sum()
        nfft = sfft.next_fast_len(n, real=True)
        spec = sfft.rfft(noise, nfft)
        band = len(spec) // self.num_buckets
        nb = self.num_buckets * band
        # env over bucket i: linspace(ratios[i], ratios[i+1], band) ** 0.5
        r0 = np.repeat(ratios, band)
        r1 = np.repeat(np.append(ratios[1:], 0.0), band)
        frac = np.tile(np.linspace(0.0, 1.0, band), self.num_buckets)
        env = np.sqrt(r0 + (r1 - r0) * frac)
        shaped = np.zeros_like(spec)
        shaped[:nb] = spec[:nb] * env
        shaped[0] = 0
        out = sfft.irfft(shaped, nfft)[:n]
        peak = np.abs(out).max()
        if peak > 0:
            out = out / peak * level
        out = np.pad(out, (0, max(0, len(audio) - len(out))))[: len(audio)]
        return audio + out.astype(audio.dtype)


def _resample(audio: np.ndarray, ratio: float) -> np.ndarray:
    """Polyphase resample via scipy; ratio > 1 shortens (speeds up).

    The ratio is quantized to a small rational (max denominator 32, worst
    relative error ~1e-3 — inaudible for augmentation) so resample_poly's
    polyphase filter stays short; a 1000/997-style coprime pair would
    design a 20k-tap filter."""
    frac = Fraction(ratio).limit_denominator(32)
    up, down = frac.denominator, max(frac.numerator, 1)
    return resample_poly(audio, up, down).astype(audio.dtype)


class Tempo(Augmentation):
    """Tempo change (reference atempo, rnnt/augment.py:153-161).  Implemented
    as resampling — pitch shifts with tempo, matching the reference's
    asetrate-based PitchShift more than a phase-vocoder atempo; acceptable
    as a speed-perturbation augmentation (the classic 0.9/1.0/1.1 trick)."""

    def __init__(self, p: float, min_tempo_rate: float = 0.8,
                 max_tempo_rate: float = 1.2):
        super().__init__(p)
        self.lo, self.hi = min_tempo_rate, max_tempo_rate

    def apply(self, audio, sample_rate, rng):
        rate = rng.uniform(self.lo, self.hi)
        return _resample(audio, rate)


class PitchShift(Augmentation):
    """Pitch shift via rate change (reference asetrate trick,
    rnnt/augment.py:164-173)."""

    def __init__(self, p: float, min_semitones: int = -4,
                 max_semitones: int = 4):
        super().__init__(p)
        self.lo, self.hi = min_semitones, max_semitones

    def apply(self, audio, sample_rate, rng):
        semis = rng.randint(self.lo, self.hi + 1)
        return _resample(audio, 2.0 ** (semis / 12.0))


def _time_stretch(audio: np.ndarray, rate: float, frame: int = 512) -> np.ndarray:
    """Pitch-preserving time stretch (phase vocoder).  rate > 1 speeds up
    (shorter output), like ffmpeg's ``atempo`` (reference
    rnnt/augment.py:153-161).

    Vectorized: analysis frames gathered in one strided view, batch rfft,
    phase propagation as a cumsum over instantaneous frequencies, batch
    irfft, and — because the synthesis hop is exactly frame/2 — overlap-add
    as two shifted reshaped adds.
    """
    hs = frame // 2
    n = len(audio)
    if n < 2 * frame or abs(rate - 1.0) < 1e-3:
        return audio
    out_len = int(n / rate)
    m_frames = max((out_len - frame) // hs + 1, 2)
    window = np.hanning(frame).astype(np.float32)

    # Analysis frame positions (float hop hs*rate, clamped to the signal).
    pos = np.minimum((np.arange(m_frames) * hs * rate).astype(np.int64),
                     n - frame)
    frames = np.lib.stride_tricks.sliding_window_view(audio, frame)[pos]
    spec = sfft.rfft(frames * window, axis=1)            # (M, frame/2+1)

    mag = np.abs(spec)
    phase = np.angle(spec)
    omega = (2.0 * np.pi * np.arange(frame // 2 + 1) / frame
             ).astype(np.float32)                            # rad/sample
    ha = np.diff(pos)[:, None].astype(np.float32)            # actual hops
    dphi = phase[1:] - phase[:-1] - omega[None, :] * ha
    dphi -= 2.0 * np.pi * np.round(dphi / (2.0 * np.pi))     # princarg
    inst_freq = omega[None, :] + dphi / np.maximum(ha, 1.0)
    psi = np.concatenate(
        [phase[:1], phase[:1] + np.cumsum(inst_freq * hs, axis=0,
                                          dtype=np.float32)], axis=0)

    out_frames = sfft.irfft(mag * (np.cos(psi) + 1j * np.sin(psi)), frame,
                            axis=1).astype(np.float32) * window

    # Overlap-add at hop hs == frame/2: two shifted reshaped adds.
    acc = np.zeros((m_frames + 1, hs), np.float32)
    acc[:m_frames] += out_frames[:, :hs]
    acc[1:] += out_frames[:, hs:]
    out = acc.ravel()
    # Window^2 OLA normalization (same reshape trick, one frame's worth).
    w2 = window * window
    wsum = np.zeros((m_frames + 1, hs), np.float32)
    wsum[:m_frames] += w2[:hs]
    wsum[1:] += w2[hs:]
    out /= np.maximum(wsum.ravel(), 1e-3)
    return out[:out_len].astype(audio.dtype)


class ATempo(Augmentation):
    """True pitch-preserving tempo change (reference atempo,
    rnnt/augment.py:153-161): duration scales by 1/rate, pitch constant —
    unlike ``Tempo``/``PitchShift`` which resample (pitch follows rate)."""

    def __init__(self, p: float, min_tempo_rate: float = 0.8,
                 max_tempo_rate: float = 1.2):
        super().__init__(p)
        self.lo, self.hi = min_tempo_rate, max_tempo_rate

    def apply(self, audio, sample_rate, rng):
        rate = rng.uniform(self.lo, self.hi)
        return _time_stretch(audio, rate)


class Chorus(Augmentation):
    """Chorus: dry signal plus decayed, sinusoidally-modulated delay taps
    (the ffmpeg/sox ``chorus`` filter the reference composes via
    ChooseAFilter, rnnt/augment.py:190-196 +
    config/basic_sp_convjs_fullcausal.yaml:139-148).

    ``y[n] = in_gain*x[n] + out_gain * sum_j decay_j * x[n - D_j(n)]`` with
    ``D_j(n) = delay_j + depth_j * sin(2*pi*speed_j*n/sr)`` (delays/depths in
    ms, speeds in Hz), fractional delays linearly interpolated.
    """

    def __init__(self, p: float, in_gain: float = 0.5, out_gain: float = 0.8,
                 delays_ms=(30.0,), decays=(0.4,), speeds=(0.1,),
                 depths_ms=(2.0,)):
        super().__init__(p)
        self.in_gain, self.out_gain = in_gain, out_gain
        self.taps = list(zip(delays_ms, decays, speeds, depths_ms))

    def apply(self, audio, sample_rate, rng):
        n = np.arange(len(audio), dtype=np.float32)
        wet = np.zeros(len(audio), np.float32)
        for delay_ms, decay, speed, depth_ms in self.taps:
            d = (delay_ms + depth_ms * np.sin(
                (2 * np.pi * speed / sample_rate) * n))
            src = n - d * (sample_rate / 1000.0)
            wet += decay * np.interp(src, n, audio, left=0.0,
                                     right=0.0).astype(np.float32)
        return (self.in_gain * audio + self.out_gain * wet).astype(audio.dtype)


class Compressor(Augmentation):
    """Dynamic-range compressor (the ffmpeg ``acompressor`` variants the
    reference composes via ChooseAFilter,
    config/basic_sp_convjs_fullcausal.yaml:152-158).

    Block-based (1 ms) RMS detector with attack/release smoothing, hard-knee
    gain above threshold, per-sample gains linearly interpolated between
    block centers.
    """

    def __init__(self, p: float, threshold_db: float = -20.0,
                 ratio: float = 4.0, attack_ms: float = 5.0,
                 release_ms: float = 250.0, makeup: float = 1.0):
        super().__init__(p)
        self.threshold_db = threshold_db
        self.ratio = ratio
        self.attack_ms = attack_ms
        self.release_ms = release_ms
        self.makeup = makeup

    def apply(self, audio, sample_rate, rng):
        block = max(sample_rate // 1000, 1)  # 1 ms
        nb = (len(audio) + block - 1) // block
        x = np.pad(audio.astype(np.float32), (0, nb * block - len(audio)))
        rms = np.sqrt(np.mean(x.reshape(nb, block) ** 2, axis=1) + 1e-12)

        # Attack/release envelope as the max of two single-pole followers
        # (vectorized: a data-dependent dual-coefficient IIR would need a
        # Python loop).  Rising edges track the fast attack pole, falling
        # edges the slow release pole — the classic two-follower topology.
        block_ms = 1000.0 * block / sample_rate
        atk = float(np.exp(-block_ms / max(self.attack_ms, 1e-3)))
        rel = float(np.exp(-block_ms / max(self.release_ms, 1e-3)))
        zi = np.array([rms[0]])
        fast, _ = lfilter([1.0 - atk], [1.0, -atk], rms, zi=zi * atk)
        slow, _ = lfilter([1.0 - rel], [1.0, -rel], rms, zi=zi * rel)
        env = np.maximum(fast, slow).astype(np.float32)

        level_db = 20.0 * np.log10(env)
        over = np.maximum(level_db - self.threshold_db, 0.0)
        gain_db = over * (1.0 / self.ratio - 1.0)
        gains = (10.0 ** (gain_db / 20.0)) * self.makeup
        centers = (np.arange(nb) + 0.5) * block
        g = np.interp(np.arange(len(audio)), centers, gains)
        return (audio * g).astype(audio.dtype)


def augmentation_from_filter_string(filter_str: str, p: float = 1.0):
    """Build an Augmentation from an ffmpeg filter string, so the
    reference's YAML recipes work verbatim
    (config/basic_sp_convjs_fullcausal.yaml:127-158).

    Supported: ``chorus=in:out:delays:decays:speeds:depths`` ('|'-separated
    multi-tap values) and
    ``acompressor=threshold=-20dB:ratio=4:attack=5:release=250``.
    """
    name, _, args = filter_str.partition("=")
    name = name.strip()
    if name == "chorus":
        parts = args.split(":")
        if len(parts) != 6:
            raise ValueError(f"chorus needs 6 params: {filter_str!r}")
        in_gain, out_gain = float(parts[0]), float(parts[1])
        multi = [tuple(float(v) for v in s.split("|")) for s in parts[2:]]
        return Chorus(p, in_gain, out_gain, delays_ms=multi[0],
                      decays=multi[1], speeds=multi[2], depths_ms=multi[3])
    if name == "acompressor":
        kw = {}
        for item in args.split(":"):
            k, _, v = item.partition("=")
            v = v.strip().removesuffix("dB")
            kw[k.strip()] = float(v)
        return Compressor(
            p,
            threshold_db=kw.get("threshold", -20.0),
            ratio=kw.get("ratio", 4.0),
            attack_ms=kw.get("attack", 5.0),
            release_ms=kw.get("release", 250.0),
            makeup=kw.get("makeup", 1.0))
    raise ValueError(f"unsupported filter: {filter_str!r}")


class ChooseAFilter(Augmentation):
    """Pick one ffmpeg-style filter string at random per application
    (reference rnnt/augment.py:190-196)."""

    def __init__(self, p: float, filters: list[str]):
        super().__init__(p)
        self.choices = [augmentation_from_filter_string(f) for f in filters]

    def apply(self, audio, sample_rate, rng):
        aug = self.choices[rng.randint(len(self.choices))]
        return aug.apply(audio, sample_rate, rng)


class Trim(Augmentation):
    """Trim a random slice off the start (reference rnnt/augment.py:176-188)."""

    def __init__(self, p: float, max_trim: float = 0.02):
        super().__init__(p)
        self.max_trim = max_trim

    def apply(self, audio, sample_rate, rng):
        trim = rng.uniform(0, self.max_trim)
        n = int(trim * sample_rate)
        return audio[n:] if n < len(audio) else audio


class Augmentor:
    """Probabilistic composition (reference TimeDomainAugmentor,
    rnnt/augment.py:27-59)."""

    def __init__(self, augmentations: list[Augmentation], seed: int = 0):
        self.augmentations = augmentations
        self.rng = np.random.RandomState(seed)

    def __call__(self, audio: np.ndarray, sample_rate: int,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
        rng = rng if rng is not None else self.rng
        for aug in self.augmentations:
            if rng.rand() < aug.p:
                audio = aug.apply(audio, sample_rate, rng)
        return audio


# The reference fullcausal recipe's filter variants, verbatim
# (config/basic_sp_convjs_fullcausal.yaml:139-158).
REFERENCE_CHORUS_FILTERS = [
    "chorus=0.5:0.8:30:0.4:0.1:2",
    "chorus=0.4:0.6:25:0.3:0.1:8",
    "chorus=0.6:0.8:35:0.3:0.05:5",
    "chorus=0.7:0.9:28:0.4:0.05:4",
    "chorus=0.5:0.7:40:0.4:0.08:3",
    "chorus=0.4:0.6:20:0.5:0.07:6",
    "chorus=0.5:0.7:32:0.3:0.09:7",
    "chorus=0.6:0.8:30:0.4:0.06:3",
    "chorus=0.5:0.7:27:0.5:0.05:4",
    "chorus=0.4:0.6:34:0.3:0.04:5",
]
REFERENCE_COMPRESSOR_FILTERS = [
    "acompressor=threshold=-20dB:ratio=4:attack=5:release=250",
    "acompressor=threshold=-30dB:ratio=2:attack=10:release=1000",
    "acompressor=threshold=-10dB:ratio=8:attack=2:release=50",
    "acompressor=threshold=-15dB:ratio=3:attack=50:release=100",
    "acompressor=threshold=-25dB:ratio=10:attack=1:release=500",
]

# kind name (YAML) -> class, for config-driven stacks.
AUGMENTATIONS = {
    "atempo": ATempo,
    "tempo": Tempo,
    "pitch_shift": PitchShift,
    "trim": Trim,
    "peak_level": PeakLevel,
    "white_noise": WhiteNoise,
    "shaped_noise": ShapedNoise,
    "chorus": Chorus,
    "compressor": Compressor,
    "choose_filter": ChooseAFilter,
}


def build_augmentor(aug_configs: list[dict], seed: int = 0) -> Augmentor:
    """Build a composition from YAML dicts, e.g.
    ``[{kind: atempo, p: 0.5, min_tempo_rate: 0.75, max_tempo_rate: 1.25},
    {kind: choose_filter, p: 0.5, filters: ["chorus=0.5:0.8:30:0.4:0.1:2"]}]``
    — the reference drives the same composition through Hydra ``_target_``
    lists (config/basic_sp_convjs_fullcausal.yaml:120-158)."""
    augs = []
    for c in aug_configs:
        c = dict(c)
        kind = c.pop("kind")
        cls = AUGMENTATIONS.get(kind)
        if cls is None:
            raise ValueError(f"unknown augmentation kind {kind!r}; "
                             f"known: {sorted(AUGMENTATIONS)}")
        augs.append(cls(**c))
    return Augmentor(augs, seed=seed)


def default_augmentor(seed: int = 0) -> Augmentor:
    """The reference's fullcausal training recipe
    (config/basic_sp_convjs_fullcausal.yaml:120-158): pitch-preserving
    atempo, pitch shift, trim, one-of-10 chorus, one-of-5 compressor,
    shaped noise, peak level."""
    return Augmentor([
        ATempo(0.5, 0.75, 1.25),
        PitchShift(0.5, -3, 3),
        Trim(0.5, 0.02),
        ChooseAFilter(0.5, REFERENCE_CHORUS_FILTERS),
        ChooseAFilter(0.5, REFERENCE_COMPRESSOR_FILTERS),
        ShapedNoise(0.5, 0.001, 0.015, num_buckets=8),
        PeakLevel(0.5, 0.25, 0.99),
    ], seed=seed)




def spec_augment_draws(generator: torch.Generator | None, B: int, T: int,
                       F: int, *, num_time_masks: int = 2,
                       time_mask_width: int = 30, num_freq_masks: int = 2,
                       freq_mask_width: int = 27, device=None) -> dict:
    """The mask starts and widths of ``spec_augment``, (B, n_masks) int64
    each, drawn in this order: time starts in [0, max(T - width, 1)), time
    widths in [0, width], then the same for frequency — the reference's
    distributions (``jax.random.randint`` with the same bounds)."""

    def axis(n, width, length):
        starts = torch.randint(0, max(length - width, 1), (B, n),
                               generator=generator, device=device)
        widths = torch.randint(0, width + 1, (B, n), generator=generator,
                               device=device)
        return starts, widths

    t_starts, t_widths = axis(num_time_masks, time_mask_width, T)
    f_starts, f_widths = axis(num_freq_masks, freq_mask_width, F)
    return {"time_starts": t_starts, "time_widths": t_widths,
            "freq_starts": f_starts, "freq_widths": f_widths}


def spec_augment_apply(features: torch.Tensor, draws: dict) -> torch.Tensor:
    """Zero the drawn time frames and frequency bins of (B, T, F) features:
    a position is masked when start <= i < start + width for any mask."""
    B, T, F = features.shape

    def keep(starts, widths, length):
        i = torch.arange(length, device=features.device)[None, None, :]
        s = starts.to(features.device)[..., None]
        hit = (i >= s) & (i < s + widths.to(features.device)[..., None])
        return ~hit.any(dim=1)  # (B, length)

    t_keep = keep(draws["time_starts"], draws["time_widths"], T)
    features = features * t_keep[:, :, None].to(features.dtype)
    f_keep = keep(draws["freq_starts"], draws["freq_widths"], F)
    return features * f_keep[:, None, :].to(features.dtype)


def spec_augment(generator: torch.Generator | None, features: torch.Tensor,
                 *, num_time_masks: int = 2, time_mask_width: int = 30,
                 num_freq_masks: int = 2, freq_mask_width: int = 27):
    """SpecAugment (time and frequency masking) on (B, T, F) features, the
    draws from ``generator`` on the features' device."""
    B, T, F = features.shape
    draws = spec_augment_draws(
        generator, B, T, F, num_time_masks=num_time_masks,
        time_mask_width=time_mask_width, num_freq_masks=num_freq_masks,
        freq_mask_width=freq_mask_width, device=features.device)
    return spec_augment_apply(features, draws)
