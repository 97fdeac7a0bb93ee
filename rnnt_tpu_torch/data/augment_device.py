"""Device-side audio augmentation: the reference recipe as batched torch ops
inside the train step.

Port of ``rnnt_tpu/data/augment_device.py``.  Every op works on a padded
(B, L) float32 batch with its ``lens`` and leaves samples beyond the lens
zero:

* ``chorus`` — a single-tap modulated delay; each 128-sample output block
  reads one contiguous 256-sample window (K5) and ``band_lerp``
  interpolates the fractional taps;
* ``compressor`` — 1 ms block RMS, attack / release single-pole followers
  (``_single_pole_iir``: a log-depth doubling scan), hard-knee gain;
* ``shape_noise`` — band-enveloped white noise (rfft / irfft);
* ``peak_level`` — peak normalisation over the lens;
* ``resample_lerp``, ``trim``, ``time_stretch`` — the length-changing ops
  of ``augment_device: full``: the buffer keeps its shape and the lens
  change (resample blocks, trim blocks and phase-vocoder frames through
  K5).

``device_augment`` (chorus, compressor, shaped noise, peak) and
``device_augment_full`` (time stretch, pitch resample and trim first) take
a ``torch.Generator`` where the reference takes a key.  Each is a draw step
(``*_draws``: every random number of the recipe, in a fixed order, from
the generator on the audio's device) and an apply step (``*_apply``) that
takes the draws, so a test can feed the reference's draws to the port.
As in the reference, every op runs on the whole batch and its gate then
picks per sample; K5 launches 4 times per ``device_augment_full`` call
(chorus, resample, trim, time stretch).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rnnt_tpu_torch.data.augment import (
    REFERENCE_CHORUS_FILTERS,
    REFERENCE_COMPRESSOR_FILTERS,
    ATempo,
    Augmentor,
    PitchShift,
    Trim,
    augmentation_from_filter_string,
)
from rnnt_tpu_torch.ops.window_gather import band_lerp, gather_windows

_F32 = torch.float32
_I32 = torch.int32


def _param(p, device, shape=(-1,)) -> torch.Tensor:
    """A scalar or (B,) parameter as a float32 tensor on ``device``.  A
    Python number becomes a fill on the device, not a copy from the host
    (a pageable copy would wait for the card and stall the step)."""
    if isinstance(p, torch.Tensor):
        return p.to(device=device, dtype=_F32).reshape(shape)
    return torch.full((1,), float(p), dtype=_F32, device=device).reshape(shape)


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[None, :]


# ------------------------------ primitive ops ------------------------------

def chorus(audio, sample_rate: int, in_gain, out_gain, delay_ms, decay,
           speed, depth_ms):
    """Batched single-tap chorus.  audio (B, L); each param () or (B,).

    y[n] = in_gain*x[n] + out_gain*decay*x[n - D(n)],
    D(n) = (delay_ms + depth_ms*sin(2*pi*speed*n/sr)) * sr/1000, fractional
    delays linearly interpolated, taps outside [0, L-1] read 0 (the host
    Chorus's np.interp).  The LFO drifts by < 1 sample per 128-sample
    block, so each output block reads one 256-sample window (K5) anchored
    at its first tap, and the per-lane offsets stay in a 4-wide band
    (``band_lerp``)."""
    B, L = audio.shape
    dev = audio.device
    Lp = -(-L // 128) * 128
    PAD = 1024   # > max delay + depth (48 ms * 16 = 768 samples)
    a_p = F.pad(audio.to(_F32), (PAD, Lp - L))
    n = torch.arange(Lp, dtype=_F32, device=dev)[None, :]

    def as2(p):
        return _param(p, dev, (-1, 1))

    d = as2(delay_ms) + as2(depth_ms) * torch.sin(
        (2.0 * math.pi / sample_rate) * as2(speed) * n)
    src = (n - d * (sample_rate / 1000.0)).expand(B, Lp)
    nb = Lp // 128
    w0 = torch.floor(src[:, ::128]).to(_I32) - 1               # (B, nb)
    win = gather_windows(a_p, w0 + PAD, 256)
    rel = src - torch.repeat_interleave(w0, 128, dim=1).to(_F32)
    tap = band_lerp(win, rel.reshape(B, nb, 128), 0, 3).reshape(B, Lp)
    tap = tap[:, :L]
    src = src[:, :L]
    tap = torch.where((src >= 0) & (src <= L - 1), tap, 0.0)
    wet = as2(decay) * tap
    return as2(in_gain) * audio + as2(out_gain) * wet


def _single_pole_iir(x, a, y0):
    """y[t] = a*y[t-1] + (1-a)*x[t] with y[-1] = y0.

    x (B, T), a () or (B,), y0 (B,).  Each step is the affine map
    y -> a*y + c; the maps compose associatively, so the filter is an
    inclusive scan of (m, c) pairs by doubling: round k combines each
    position with the one 2^k before it (the identity (1, 0) before the
    start), ceil(log2 T) rounds — 14 at T = 10^4.  No cumulative product is
    divided out, so nothing overflows or underflows beyond the true
    coefficients a^k."""
    B, T = x.shape
    m = _param(a, x.device, (-1, 1)).expand(B, T)
    c = (1.0 - m) * x
    k = 1
    while k < T:
        m_prev = F.pad(m[:, :-k], (k, 0), value=1.0)
        c_prev = F.pad(c[:, :-k], (k, 0), value=0.0)
        c = c_prev * m + c      # earlier map, then this one
        m = m_prev * m
        k *= 2
    return m * y0[:, None] + c


def compressor(audio, sample_rate: int, threshold_db, ratio, attack_ms,
               release_ms, makeup=1.0):
    """Batched dynamic-range compressor — data/augment.py Compressor.apply:
    1 ms block RMS, max of attack/release single-pole followers, hard-knee
    gain above threshold, per-sample gains lerped between block centers."""
    B, L = audio.shape
    dev = audio.device
    block = max(sample_rate // 1000, 1)
    nb = -(-L // block)
    x = F.pad(audio.to(_F32), (0, nb * block - L))
    rms = torch.sqrt(torch.mean(x.reshape(B, nb, block) ** 2, dim=2) + 1e-12)

    block_ms = 1000.0 * block / sample_rate
    atk = torch.exp(-block_ms / torch.clamp(_param(attack_ms, dev), min=1e-3))
    rel = torch.exp(-block_ms / torch.clamp(_param(release_ms, dev), min=1e-3))
    fast = _single_pole_iir(rms, atk, rms[:, 0])
    slow = _single_pole_iir(rms, rel, rms[:, 0])
    env = torch.maximum(fast, slow)

    level_db = 20.0 * torch.log10(env)
    over = torch.clamp(level_db - _param(threshold_db, dev)[:, None], min=0.0)
    gain_db = over * (1.0 / _param(ratio, dev)[:, None] - 1.0)
    gains = torch.pow(10.0, gain_db / 20.0) * _param(makeup, dev, ())

    # np.interp(arange(L), centers, gains) with centers (i + 0.5) * block:
    # sample block*k + r lerps blocks k-1/k for r < block/2, k/k+1 after.
    nlo = (block + 1) // 2
    hb = 0.5 * block
    g_prev = torch.cat([gains[:, :1], gains[:, :-1]], dim=1)
    g_next = torch.cat([gains[:, 1:], gains[:, -1:]], dim=1)
    r = torch.arange(block, dtype=_F32, device=dev)
    fr_lo = ((r[:nlo] + hb) / block)[None, None, :]
    fr_hi = ((r[nlo:] - hb) / block)[None, None, :]
    lo = g_prev[:, :, None] * (1.0 - fr_lo) + gains[:, :, None] * fr_lo
    hi = gains[:, :, None] * (1.0 - fr_hi) + g_next[:, :, None] * fr_hi
    g = torch.cat([lo, hi], dim=2).reshape(B, nb * block)[:, :L]
    return audio * g


def shape_noise(noise, ratios, level):
    """Shape white noise by a per-band spectral envelope and normalize its
    peak to ``level`` — the deterministic core of data/augment.py
    ShapedNoise.apply, batched.  noise (B, Lf) white in [0, 1); ratios
    (B, num_buckets) summing to 1; level (B,).  Returns (B, Lf)."""
    B, Lf = noise.shape
    dev = noise.device
    num_buckets = ratios.shape[1]
    spec = torch.fft.rfft(noise, dim=1)                      # (B, Lf//2+1)
    n_spec = spec.shape[1]
    band = n_spec // num_buckets
    nbb = num_buckets * band
    r0 = torch.repeat_interleave(ratios, band, dim=1)        # (B, nbb)
    r1 = torch.repeat_interleave(torch.cat(
        [ratios[:, 1:], ratios.new_zeros((B, 1))], dim=1), band, dim=1)
    frac = torch.linspace(0.0, 1.0, band, device=dev).repeat(num_buckets)[None, :]
    env = torch.sqrt(r0 + (r1 - r0) * frac)
    env_full = torch.zeros((B, n_spec), dtype=_F32, device=dev)
    env_full[:, :nbb] = env
    env_full[:, 0] = 0.0
    out = torch.fft.irfft(spec * env_full, n=Lf, dim=1)
    peak = torch.amax(torch.abs(out), dim=1, keepdim=True)
    return torch.where(peak > 0, out / peak, 0.0) * _param(level, dev, (-1, 1))


def peak_level(audio, lens, level):
    """Normalize each sample's (in-length) peak to ``level`` (B,) —
    data/augment.py PeakLevel.apply."""
    B, L = audio.shape
    mask = _positions(L, audio.device) < lens[:, None]
    peak = torch.amax(torch.abs(torch.where(mask, audio, 0.0)), dim=1,
                      keepdim=True)
    scale = torch.where(peak > 0, _param(level, audio.device, (-1, 1)) / peak,
                        1.0)
    return audio * scale


# --------------------- length-changing ops (full mode) ---------------------
#
# The host recipe's atempo / pitch / trim change the signal length.  Here
# each keeps the padded (B, L) buffer and returns new ``lens``; the
# featurizer's length arithmetic, peak normalisation and the loss masks run
# off the lens.  Slowdowns that would overflow the buffer are clamped to
# capacity (rate >= len/L) by the callers.


def resample_lerp(audio, lens, ratio):
    """Batched rate-change resample: out[i] = x(i*ratio), pitch follows rate
    (the asetrate trick, reference rnnt/augment.py:164-173).  audio (B, L),
    lens (B,) int, ratio (B,) > 0; returns (out, new_lens) with new_len =
    floor(len/ratio) clamped to L.  Linear interpolation where the host's
    ``_resample`` is polyphase.

    64-lane output blocks are anchored at their middle lane: the per-lane
    offsets stay inside the band [6, 27] for ratio in [0.71, 1.275], and the
    ratio is clipped to that range, so out-of-band reads cannot happen."""
    B, L = audio.shape
    dev = audio.device
    Lp = -(-L // 128) * 128
    a_p = F.pad(audio.to(_F32), (128, Lp - L))
    r = torch.clamp(_param(ratio, dev), 0.71, 1.275).reshape(-1, 1)
    src = (torch.arange(Lp, dtype=_F32, device=dev)[None, :] * r).expand(B, Lp)
    nb = Lp // 64
    w0 = torch.floor(src[:, 32::64]).to(_I32) - 48
    win = gather_windows(a_p, w0 + 128, 128)
    rel = src - torch.repeat_interleave(w0, 64, dim=1).to(_F32)
    out = band_lerp(win, rel.reshape(B, nb, 64), 6, 27).reshape(B, Lp)
    out = out[:, :L]
    new_lens = torch.clamp(lens.to(_F32) / r[:, 0], max=float(L)).to(_I32)
    out = torch.where(_positions(L, dev) < new_lens[:, None], out, 0.0)
    return out, new_lens


def trim(audio, lens, n_trim):
    """Drop ``n_trim`` samples off the start (reference
    rnnt/augment.py:176-188: no-op when n_trim >= len).  audio (B, L),
    n_trim (B,) int; returns (out, new_lens).  The per-row shift is read
    as contiguous 128-sample windows (K5)."""
    B, L = audio.shape
    dev = audio.device
    shift = torch.where(n_trim < lens, n_trim, 0).to(_I32)
    nb = -(-L // 128)
    starts = shift[:, None] + 128 * torch.arange(nb, dtype=_I32, device=dev)[None, :]
    out = gather_windows(audio.to(_F32).contiguous(), starts,
                         128).reshape(B, nb * 128)[:, :L]
    new_lens = (lens - shift).to(_I32)
    out = torch.where(_positions(L, dev) < new_lens[:, None], out, 0.0)
    return out, new_lens


def time_stretch(audio, lens, rate, frame: int = 512):
    """Batched pitch-preserving time stretch — the phase vocoder of
    data/augment.py _time_stretch, sample for sample (same analysis
    positions, princarg phase propagation, hop-frame/2 overlap-add).
    audio (B, L), lens (B,) int, rate (B,); returns (out, new_lens) with
    new_len = floor(len/rate).  Samples with len < 2*frame or
    |rate-1| < 1e-3 pass through unchanged (the host guard).  The analysis
    frames are K5 windows at arbitrary starts."""
    B, L = audio.shape
    dev = audio.device
    hs = frame // 2
    M = max((L - frame) // hs + 1, 2)
    k = torch.arange(frame, dtype=_F32, device=dev)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / (frame - 1))  # np.hanning
    n = lens.to(_F32)
    r = _param(rate, dev)
    out_len = torch.floor(n / r).to(_I32)
    m = torch.clamp((out_len - frame) // hs + 1, min=2)               # (B,)

    i = torch.arange(M, dtype=_F32, device=dev)[None, :]
    pos = torch.minimum(torch.floor(i * (hs * r[:, None])), n[:, None] - frame)
    pos = torch.clamp(pos, min=0.0).to(_I32)                         # (B, M)

    frames = gather_windows(audio.to(_F32).contiguous(), pos, frame)
    spec = torch.fft.rfft(frames * window, dim=-1)                   # (B, M, F/2+1)
    mag = torch.abs(spec)
    phase = torch.angle(spec)
    omega = (2.0 * math.pi / frame) * torch.arange(frame // 2 + 1, dtype=_F32,
                                                   device=dev)
    ha = torch.diff(pos, dim=1).to(_F32)[:, :, None]                 # (B, M-1, 1)
    dphi = phase[:, 1:] - phase[:, :-1] - omega[None, None, :] * ha
    dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))  # princarg
    inst = omega[None, None, :] + dphi / torch.clamp(ha, min=1.0)
    psi = torch.cat(
        [phase[:, :1], phase[:, :1] + torch.cumsum(inst * hs, dim=1)], dim=1)
    out_frames = torch.fft.irfft(mag * torch.exp(1j * psi), frame,
                                 dim=-1) * window

    # Overlap-add at hop hs == frame/2: two shifted padded adds; frames at
    # i >= m (beyond this sample's output) are masked out of both the
    # signal accumulator and the window^2 normalizer.
    fmask = (_positions(M, dev) < m[:, None])[:, :, None]
    of = torch.where(fmask, out_frames, 0.0)
    acc = F.pad(of[:, :, :hs], (0, 0, 0, 1)) + F.pad(of[:, :, hs:], (0, 0, 1, 0))
    acc = acc.reshape(B, (M + 1) * hs)
    w2 = torch.where(fmask, (window * window)[None, None, :], 0.0)
    wacc = F.pad(w2[:, :, :hs], (0, 0, 0, 1)) + F.pad(w2[:, :, hs:], (0, 0, 1, 0))
    wacc = wacc.reshape(B, (M + 1) * hs)
    out = acc / torch.clamp(wacc, min=1e-3)
    if (M + 1) * hs >= L:
        out = out[:, :L]
    else:
        out = F.pad(out, (0, L - (M + 1) * hs))

    # The host's OLA buffer holds (m+1)*hs samples, so its output is
    # min(out_len, (m+1)*hs).
    new_lens = torch.clamp(torch.minimum(out_len, (m + 1) * hs), max=L)
    skip = (lens < 2 * frame) | (torch.abs(r - 1.0) < 1e-3)
    out = torch.where(skip[:, None], audio, out)
    new_lens = torch.where(skip, lens.to(_I32), new_lens)
    out = torch.where(_positions(L, dev) < new_lens[:, None], out, 0.0)
    return out, new_lens


# --------------------------- recipe-driven sampler ---------------------------

_TABLES: dict = {}   # (name, device) -> {param: tensor}, copied once


def _table(name: str, columns, device) -> dict:
    key = (name, torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = {k: torch.tensor(v, dtype=_F32, device=device)
                        for k, v in columns().items()}
    return _TABLES[key]


def _chorus_table(device) -> dict:
    """The reference chorus variants' parameters, one (10,) tensor each
    (every variant is single-tap), on ``device``."""
    def columns():
        augs = [augmentation_from_filter_string(f) for f in REFERENCE_CHORUS_FILTERS]
        return {"in_gain": [a.in_gain for a in augs],
                "out_gain": [a.out_gain for a in augs],
                "delay_ms": [a.taps[0][0] for a in augs],
                "decay": [a.taps[0][1] for a in augs],
                "speed": [a.taps[0][2] for a in augs],
                "depth_ms": [a.taps[0][3] for a in augs]}
    return _table("chorus", columns, device)


def _compressor_table(device) -> dict:
    """The reference compressor variants' parameters, one (5,) tensor each,
    on ``device``."""
    def columns():
        augs = [augmentation_from_filter_string(f)
                for f in REFERENCE_COMPRESSOR_FILTERS]
        return {"threshold_db": [a.threshold_db for a in augs],
                "ratio": [a.ratio for a in augs],
                "attack_ms": [a.attack_ms for a in augs],
                "release_ms": [a.release_ms for a in augs]}
    return _table("compressor", columns, device)


def _blend(applied, audio, on):
    return torch.where(on[:, None], applied, audio)


def _uniform(generator, shape, device, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=generator, device=device)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def noise_length(L: int) -> int:
    """The shaped noise's FFT-friendly length: the next power of two >= L
    (the noise is random, so padding changes no semantics)."""
    return 1 << max(int(math.ceil(math.log2(max(L, 2)))), 1)


def device_augment_draws(generator, B: int, L: int, *, device=None,
                         p: float = 0.5, noise_lo: float = 0.001,
                         noise_hi: float = 0.015, noise_buckets: int = 8,
                         peak_lo: float = 0.25, peak_hi: float = 0.99) -> dict:
    """Every random number of ``device_augment``, in the reference's order
    (chorus variant and gate, compressor variant and gate, noise, band
    ratios, noise level and gate, peak level and gate) and with its
    distributions (``augment_device.py:375-404``)."""
    def gate():
        return _uniform(generator, (B,), device) < p

    d = {"chorus_idx": torch.randint(0, len(REFERENCE_CHORUS_FILTERS), (B,),
                                     generator=generator, device=device)}
    d["chorus_on"] = gate()
    d["compressor_idx"] = torch.randint(
        0, len(REFERENCE_COMPRESSOR_FILTERS), (B,), generator=generator,
        device=device)
    d["compressor_on"] = gate()
    d["noise"] = _uniform(generator, (B, noise_length(L)), device)
    ratios = _uniform(generator, (B, noise_buckets), device)
    d["noise_ratios"] = ratios / torch.sum(ratios, dim=1, keepdim=True)
    d["noise_level"] = torch.pow(10.0, _uniform(
        generator, (B,), device, math.log10(noise_lo), math.log10(noise_hi)))
    d["noise_on"] = gate()
    d["peak_level"] = _uniform(generator, (B,), device, peak_lo, peak_hi)
    d["peak_on"] = gate()
    return d


def device_augment_apply(draws: dict, audio, audio_lens,
                         sample_rate: int = 16000):
    """The device half of the reference recipe (data/augment.py
    default_augmentor minus atempo / pitch / trim, same order) with the
    given draws: one-of-10 chorus, one-of-5 compressor, shaped noise, peak
    level, each blended in where its gate is on.  Samples stay zero beyond
    audio_lens."""
    B, L = audio.shape
    dev = audio.device
    audio = audio.to(_F32)
    orig_mask = _positions(L, dev) < audio_lens[:, None]

    ci = draws["chorus_idx"]
    ch = chorus(audio, sample_rate,
                **{k: v[ci] for k, v in _chorus_table(dev).items()})
    audio = _blend(ch, audio, draws["chorus_on"])

    ki = draws["compressor_idx"]
    cp = compressor(audio, sample_rate,
                    **{k: v[ki] for k, v in _compressor_table(dev).items()})
    audio = _blend(cp, audio, draws["compressor_on"])

    shaped = shape_noise(draws["noise"], draws["noise_ratios"],
                         draws["noise_level"])[:, :L]
    audio = _blend(audio + shaped, audio, draws["noise_on"])

    audio = _blend(peak_level(audio, audio_lens, draws["peak_level"]), audio,
                   draws["peak_on"])
    return torch.where(orig_mask, audio, 0.0)


def device_augment(generator, audio, audio_lens, sample_rate: int = 16000, *,
                   p: float = 0.5, noise_lo: float = 0.001,
                   noise_hi: float = 0.015, noise_buckets: int = 8,
                   peak_lo: float = 0.25, peak_hi: float = 0.99):
    """``device_augment_apply`` of ``device_augment_draws`` from
    ``generator`` (on the audio's device)."""
    B, L = audio.shape
    draws = device_augment_draws(
        generator, B, L, device=audio.device, p=p, noise_lo=noise_lo,
        noise_hi=noise_hi, noise_buckets=noise_buckets, peak_lo=peak_lo,
        peak_hi=peak_hi)
    return device_augment_apply(draws, audio, audio_lens, sample_rate)


def device_augment_full_draws(generator, B: int, L: int, *, device=None,
                              p: float = 0.5, **kwargs) -> dict:
    """Every random number of ``device_augment_full``: tempo rate and gate,
    semitones and gate, trim seconds and gate (``augment_device.py:
    425-448``), then ``device_augment_draws``."""
    def gate():
        return _uniform(generator, (B,), device) < p

    d = {"tempo_rate": _uniform(generator, (B,), device, 0.75, 1.25)}
    d["tempo_on"] = gate()
    d["pitch_semitones"] = torch.randint(-3, 4, (B,), generator=generator,
                                         device=device)
    d["pitch_on"] = gate()
    d["trim_seconds"] = _uniform(generator, (B,), device, 0.0, 0.02)
    d["trim_on"] = gate()
    d.update(device_augment_draws(generator, B, L, device=device, p=p, **kwargs))
    return d


def device_augment_full_apply(draws: dict, audio, audio_lens,
                              sample_rate: int = 16000):
    """The whole reference recipe on the device with the given draws, in
    the host recipe's order: atempo, pitch shift, trim, then
    ``device_augment_apply``.  Returns (audio, new_lens).  Slowdown rates
    are clamped to the buffer (rate >= len/L)."""
    B, L = audio.shape
    audio = audio.to(_F32)
    lens = audio_lens.to(_I32)

    rate = torch.maximum(draws["tempo_rate"], lens.to(_F32) / L)
    st, sl = time_stretch(audio, lens, rate)
    on = draws["tempo_on"]
    audio = _blend(st, audio, on)
    lens = torch.where(on, sl, lens)

    ratio = torch.pow(2.0, draws["pitch_semitones"].to(_F32) / 12.0)
    ratio = torch.maximum(ratio, lens.to(_F32) / L)
    rs, rl = resample_lerp(audio, lens, ratio)
    on = draws["pitch_on"]
    audio = _blend(rs, audio, on)
    lens = torch.where(on, rl, lens)

    n_trim = (draws["trim_seconds"] * sample_rate).to(_I32)
    tr, tl = trim(audio, lens, n_trim)
    on = draws["trim_on"]
    audio = _blend(tr, audio, on)
    lens = torch.where(on, tl, lens)

    return device_augment_apply(draws, audio, lens, sample_rate), lens


def device_augment_full(generator, audio, audio_lens, sample_rate: int = 16000,
                        *, p: float = 0.5, **kwargs):
    """``device_augment_full_apply`` of ``device_augment_full_draws`` from
    ``generator`` (on the audio's device).  Returns (audio, new_lens)."""
    B, L = audio.shape
    draws = device_augment_full_draws(generator, B, L, device=audio.device,
                                      p=p, **kwargs)
    return device_augment_full_apply(draws, audio, audio_lens, sample_rate)


# Host-side augmentation kinds that device_augment replaces (the train loop
# strips them from the host worker recipe when data.augment_device is on).
DEVICE_SIDE_KINDS = frozenset(
    {"chorus", "compressor", "choose_filter", "shaped_noise", "white_noise",
     "peak_level"})

# Additionally replaced in "full" mode (data.augment_device: full).
DEVICE_SIDE_KINDS_FULL = DEVICE_SIDE_KINDS | frozenset(
    {"atempo", "tempo", "pitch_shift", "trim"})

# The parameters the device recipe runs (fixed in device_augment /
# device_augment_full).  When the train loop strips a host-side op whose
# config differs from these, warn_stripped_param_mismatch says so.
DEVICE_RECIPE_PARAMS = {
    "atempo": {"p": 0.5, "min_tempo_rate": 0.75, "max_tempo_rate": 1.25},
    "tempo": {"p": 0.5, "min_tempo_rate": 0.75, "max_tempo_rate": 1.25},
    "pitch_shift": {"p": 0.5, "min_semitones": -3, "max_semitones": 3},
    "trim": {"p": 0.5, "max_trim": 0.02},
    "choose_filter": {"p": 0.5},
    "chorus": {"p": 0.5},
    "compressor": {"p": 0.5},
    "shaped_noise": {"p": 0.5, "min_noise_level": 0.001,
                     "max_noise_level": 0.015, "num_buckets": 8},
    "white_noise": None,       # not in the device recipe at all
    "peak_level": {"p": 0.5, "min_peak_level": 0.25,
                   "max_peak_level": 0.99},
}


def warn_stripped_param_mismatch(stripped_cfgs) -> list[str]:
    """Compare host augmentation configs stripped by the train loop against
    the parameters the device recipe runs; return (and print) a warning
    line per mismatch so custom per-op settings are never silently
    discarded."""
    warnings = []
    for c in stripped_cfgs:
        kind = c.get("kind")
        expect = DEVICE_RECIPE_PARAMS.get(kind)
        if expect is None:
            warnings.append(
                f"augment_device: host op {kind!r} has no device "
                f"equivalent with these semantics — it will NOT run")
            continue
        diffs = {k: (v, expect[k]) for k, v in c.items()
                 if k != "kind" and k in expect and v != expect[k]}
        extra = [k for k in c if k not in expect and k != "kind"
                 and k != "filters"]
        if diffs or extra:
            parts = [f"{k}={got!r} (device runs {want!r})"
                     for k, (got, want) in diffs.items()]
            parts += [f"{k}={c[k]!r} (ignored)" for k in extra]
            warnings.append(
                f"augment_device: stripped host op {kind!r} config differs "
                f"from the device recipe: " + ", ".join(parts))
    for w in warnings:
        print(f"WARNING: {w}")
    return warnings


def host_only_default_augmentor(seed: int = 0):
    """The length-changing remainder of the default recipe for host
    workers when device augmentation is on: atempo, pitch, trim."""
    return Augmentor([
        ATempo(0.5, 0.75, 1.25),
        PitchShift(0.5, -3, 3),
        Trim(0.5, 0.02),
    ], seed=seed)
