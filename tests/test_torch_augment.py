"""The port's augmentation against rnnt_tpu on the CPU, inputs from numpy
seeds.

* ``gather_windows_plain`` (K5's plain version, which the CPU wrapper runs)
  against JAX's Pallas ``gather_windows`` in interpret mode: exact.
* ``band_lerp`` against JAX's: atol 1e-6 (the same two products summed;
  the reference's einsum may fuse them differently).
* each device op against its JAX counterpart on shared inputs and
  parameters, JAX jitted.  trim and peak level: exact.  chorus: XLA's and
  torch's float32 ``sin`` differ by an ulp at a few LFO positions, which
  moves a tap by ~1e-6 samples: atol 1e-4 (measured 4.6e-5).  resample:
  XLA fuses the source position i * ratio into the tap weights; at
  positions of ~10^4 samples a float32 ulp is ~1e-3 samples: atol 5e-4
  (measured 1.1e-4 on a DC-offset signal).  The compressor's block RMS mean
  and its IIR scan sum in another order (a doubling scan against
  ``lax.associative_scan``): atol 5e-6 on gains of O(1) (measured 1.8e-6).
  shape_noise's FFTs are another library's: atol 1e-7 on a 1e-2 peak.
  time_stretch, against eager JAX and the host: the phase ``psi`` is a
  float32 cumsum of O(10^3-10^5) rad whose ulp moves the high bins, so
  JAX's own bounds against the host (tests/test_augment_device.py:203):
  atol 4e-3 in the body, 5e-2 in the last hop.
* ``device_augment_full`` with JAX's draws (replayed from its key as
  ``augment_device.py:371-404,421-450`` split it) fed to the port's apply
  step, one gate at a time and all at once, against JAX's output from the
  same key and gates: the new lens exact; with the time stretch on, its
  bounds; else atol 1e-3 (resample's 5e-4 and chorus's 1e-4 as the peak
  normalisation rescales them: measured 4.0e-4 and 1.7e-4).
* the host recipe (``Augmentor`` and its parts, ``default_augmentor``,
  ``build_augmentor``) bit-equal to JAX's from the same ``RandomState``,
  alone and through ``BatchIterator`` serially, in threads and in
  processes; ``warn_stripped_param_mismatch``'s lines; SpecAugment with
  injected draws, exact.
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.data import augment as jaug  # noqa: E402
from rnnt_tpu.data import augment_device as jdev  # noqa: E402
from rnnt_tpu.data import dataset as jdata  # noqa: E402
from rnnt_tpu.data.tokenizer import UnigramTokenizer as JTokenizer  # noqa: E402
from rnnt_tpu.ops import window_gather as jwg  # noqa: E402
from rnnt_tpu_torch.data import augment as taug  # noqa: E402
from rnnt_tpu_torch.data import augment_device as tdev  # noqa: E402
from rnnt_tpu_torch.data import dataset as tdata  # noqa: E402
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer as TTokenizer  # noqa: E402
from rnnt_tpu_torch.ops import window_gather as twg  # noqa: E402
from rnnt_tpu_torch.ops.stft import FeaturizerSpec  # noqa: E402

SR = 16000
CHORUS_ATOL = 1e-4
RESAMPLE_ATOL = 5e-4
COMPRESSOR_ATOL = 5e-6
RECIPE_ATOL = 1e-3   # resample's and chorus's, after the peak normalisation
STRETCH_BODY, STRETCH_TAIL = 4e-3, 5e-2


# The reference's functions jitted once each: eager JAX dispatches op by
# op and runs the interpret-mode Pallas gather step by step, ~100x slower.
# Jitted, XLA's CPU code contracts multiply-adds and rounds some quotients
# differently from the same ops run one by one (which the port matched bit
# for bit in chorus, trim, resample and peak level): the tolerances below
# cover that.  time_stretch is held to eager JAX (see its test).
J_GATHER = jax.jit(jwg.gather_windows, static_argnums=(2,))
J_BAND_LERP = jax.jit(jwg.band_lerp, static_argnums=(2, 3))
J_CHORUS = jax.jit(jdev.chorus, static_argnums=(1,))
J_COMPRESSOR = jax.jit(jdev.compressor, static_argnums=(1,))
J_IIR = jax.jit(jdev._single_pole_iir)
J_SHAPE_NOISE = jax.jit(jdev.shape_noise)
J_PEAK = jax.jit(jdev.peak_level)
J_RESAMPLE = jax.jit(jdev.resample_lerp)
J_TRIM = jax.jit(jdev.trim)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ------------------------------ K5, band_lerp ------------------------------

@pytest.mark.parametrize("B,L,N,width,lo,hi", [
    (3, 1000, 17, 256, 0, 1000),        # N % 8 != 0, windows past L
    (2, 300, 8, 128, -40, 340),         # negative starts, starts >= L
    (1, 2049, 5, 512, 1500, 2049),      # every window runs past L
    (4, 640, 33, 128, 0, 512),
])
def test_gather_windows_plain_equals_jax(B, L, N, width, lo, hi):
    rng = np.random.RandomState(B * 100 + N)
    x = rng.randn(B, L).astype(np.float32)
    starts = rng.randint(lo, hi, (B, N)).astype(np.int32)
    want = np.asarray(J_GATHER(_j(x), _j(starts), width))
    got = twg.gather_windows_plain(_t(x), _t(starts), width)
    assert got.shape == (B, N, width) and got.dtype == torch.float32
    _eq(got, want)
    _eq(twg.gather_windows(_t(x), _t(starts), width), want)  # the CPU wrapper


def test_gather_windows_clip_and_zero_pad():
    x = torch.arange(300, dtype=torch.float32)[None, :]
    out = twg.gather_windows(x, torch.tensor([[-5, 250, 299, 400]], dtype=torch.int32), 128)
    _eq(out[0, 0], np.arange(128))                       # clipped to 0
    _eq(out[0, 1, :50], np.arange(250, 300))
    assert (out[0, 1, 50:] == 0).all()                   # zero past L
    assert out[0, 2, 0] == 299 and (out[0, 2, 1:] == 0).all()
    _eq(out[0, 3], out[0, 2])                            # clipped to L - 1


@pytest.mark.parametrize("width", [100, 0, 130])
def test_gather_windows_width_validation(width):
    with pytest.raises(ValueError, match="multiple of 128"):
        twg.gather_windows(torch.zeros(1, 256), torch.zeros((1, 4), dtype=torch.int32),
                           width)
    with pytest.raises(ValueError, match="multiple of 128"):
        twg.gather_windows_plain(torch.zeros(1, 256),
                                 torch.zeros((1, 4), dtype=torch.int32), width)


@pytest.mark.parametrize("s_lo,s_hi,spread", [(-3, 5, 0.0), (0, 3, 0.0), (6, 27, 0.0),
                                              (0, 3, 4.0), (-3, 5, 6.0)],
                         ids=["in-band", "chorus-band", "resample-band",
                              "out-of-band", "both"])
def test_band_lerp_matches_jax(s_lo, s_hi, spread):
    """``spread`` > 0 pushes some lanes' taps outside the band (and some
    past the window), where both must read 0."""
    rng = np.random.RandomState(s_hi * 10 + int(spread))
    B, N, W, C = 2, 9, 256, 128
    win = rng.randn(B, N, W).astype(np.float32)
    lane = np.arange(C)[None, None, :]
    rel = lane + rng.uniform(s_lo - spread, s_hi + spread, (B, N, C))
    rel = np.clip(rel, -1.5, W + 0.5).astype(np.float32)
    want = np.asarray(J_BAND_LERP(_j(win), _j(rel), s_lo, s_hi))
    got = twg.band_lerp(_t(win), _t(rel), s_lo, s_hi)
    _close(got, want, 1e-6)


def test_band_lerp_out_of_band_reads_zero():
    rel = torch.arange(128, dtype=torch.float32)[None, None, :] + 50.0
    assert (twg.band_lerp(torch.ones(1, 1, 256), rel, 0, 3) == 0).all()


# ------------------------------ device ops ------------------------------

@pytest.fixture(scope="module")
def audio():
    return (np.random.RandomState(0).randn(3, 8000) * 0.3).astype(np.float32)


@pytest.mark.parametrize("filt", jaug.REFERENCE_CHORUS_FILTERS[::2])
def test_chorus_matches_jax(audio, filt):
    a = jaug.augmentation_from_filter_string(filt)
    args = (a.in_gain, a.out_gain, *a.taps[0])
    _close(tdev.chorus(_t(audio), SR, *args), J_CHORUS(_j(audio), SR, *args),
           CHORUS_ATOL)


def test_chorus_per_sample_params(audio):
    table = tdev._chorus_table("cpu")
    idx = np.asarray([0, 4, 9])
    jt = {k: _j(v.numpy()[idx]) for k, v in table.items()}
    got = tdev.chorus(_t(audio), SR, **{k: v[idx] for k, v in table.items()})
    _close(got, J_CHORUS(_j(audio), SR, **jt), CHORUS_ATOL)


@pytest.mark.parametrize("filt", jaug.REFERENCE_COMPRESSOR_FILTERS)
def test_compressor_matches_jax(audio, filt):
    a = jaug.augmentation_from_filter_string(filt)
    args = (a.threshold_db, a.ratio, a.attack_ms, a.release_ms)
    _close(tdev.compressor(_t(audio), SR, *args), J_COMPRESSOR(_j(audio), SR, *args),
           COMPRESSOR_ATOL)


def test_compressor_long_and_odd_block():
    """nb = 10,240 blocks (the IIR scan at flagship depth), and an odd
    11-sample block (sr 11025)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 163840) * 0.3).astype(np.float32)
    for sr, filt in ((SR, 1), (11025, 0)):
        a = jaug.augmentation_from_filter_string(jaug.REFERENCE_COMPRESSOR_FILTERS[filt])
        args = (a.threshold_db, a.ratio, a.attack_ms, a.release_ms)
        got = tdev.compressor(_t(x), sr, *args)
        _close(got, J_COMPRESSOR(_j(x), sr, *args), COMPRESSOR_ATOL)
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("T,a", [(12000, (0.9, 0.999)), (20000, (0.5, 0.99999)),
                                 (7, (0.3, 0.8))])
def test_single_pole_iir_matches_jax_and_scipy(T, a):
    """The doubling scan against JAX's associative scan (atol 2e-6 on
    values in [0, 1]) and against scipy's lfilter in float64 (rtol 1e-4,
    the reference's own bound: float32 sums of 10^4 terms), at nb >=
    10,000 where a cumprod would underflow."""
    from scipy.signal import lfilter

    rng = np.random.RandomState(T)
    x = rng.rand(2, T).astype(np.float32)
    a = np.asarray(a, np.float32)
    got = tdev._single_pole_iir(_t(x), _t(a), _t(x[:, 0])).numpy()
    _close(got, J_IIR(_j(x), _j(a), _j(x[:, 0])), 2e-6)
    for b in range(2):
        want, _ = lfilter([1.0 - a[b]], [1.0, -a[b]], x[b].astype(np.float64),
                          zi=[x[b, 0] * a[b]])
        np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-6)


def test_shape_noise_matches_jax():
    rng = np.random.RandomState(2)
    noise = rng.rand(2, 8192).astype(np.float32)
    ratios = rng.rand(2, 8).astype(np.float32)
    ratios /= ratios.sum(axis=1, keepdims=True)
    level = np.asarray([0.01, 0.002], np.float32)
    got = tdev.shape_noise(_t(noise), _t(ratios), _t(level))
    _close(got, J_SHAPE_NOISE(_j(noise), _j(ratios), _j(level)), 1e-7)
    _close(got.abs().amax(dim=1), level, 1e-8)


def test_peak_level_matches_jax(audio):
    padded = np.concatenate([audio, np.full((3, 100), 9.9, np.float32)], axis=1)
    lens = np.asarray([8000, 5000, 300], np.int32)
    level = np.asarray([0.5, 0.3, 0.9], np.float32)
    _eq(tdev.peak_level(_t(padded), _t(lens), _t(level)),
        J_PEAK(_j(padded), _j(lens), _j(level)))


def test_resample_lerp_matches_jax():
    """The ±3 semitone recipe extremes, the 1.27 band edge, 0.72, and a
    ratio past the clip (1.6)."""
    rng = np.random.RandomState(21)
    L = 6000
    ratios = np.asarray([2 ** (3 / 12), 2 ** (-3 / 12), 1.27, 0.72, 1.6], np.float32)
    lens = np.asarray([5800, 5000, 6000, 4000, 6000], np.int32)
    buf = np.zeros((5, L), np.float32)
    for b, n in enumerate(lens):
        buf[b, :n] = 1.0 + 0.1 * rng.randn(n)
    got, got_lens = tdev.resample_lerp(_t(buf), _t(lens), _t(ratios))
    want, want_lens = J_RESAMPLE(_j(buf), _j(lens), _j(ratios))
    _close(got, want, RESAMPLE_ATOL)
    _eq(got_lens, want_lens)


def test_trim_matches_jax():
    rng = np.random.RandomState(14)
    buf = np.zeros((3, 4000), np.float32)
    lens = np.asarray([3500, 3500, 1000], np.int32)
    for b, n in enumerate(lens):
        buf[b, :n] = rng.randn(n)
    n_trim = np.asarray([123, 5000, 0], np.int32)   # the second exceeds len
    got, got_lens = tdev.trim(_t(buf), _t(lens), _t(n_trim))
    want, want_lens = J_TRIM(_j(buf), _j(lens), _j(n_trim))
    _eq(got, want)
    _eq(got_lens, want_lens)


def _stretch_close(got, want, lens, tail: int):
    """Body within STRETCH_BODY, the last ``tail`` samples before each
    sample's len within STRETCH_TAIL, zero past the len in both."""
    got, want = np.asarray(got), np.asarray(want)
    for b, m in enumerate(np.asarray(lens)):
        _close(got[b, :max(m - tail, 0)], want[b, :max(m - tail, 0)], STRETCH_BODY)
        _close(got[b, max(m - tail, 0):], want[b, max(m - tail, 0):], STRETCH_TAIL)


def test_time_stretch_matches_jax():
    """Speed-up, slow-down and a padded row; a short row and rate 1 pass
    through (the host guard).  Against eager JAX, and against the host's
    ``_time_stretch`` on the first two rows (the unpadded cases) as JAX's
    own test holds JAX.  Jitted JAX is no yardstick here: its compiled
    phase sums put it 2.4e-2 from the host in the body at rate 0.8."""
    rng = np.random.RandomState(10)
    L = 16384
    lens = np.asarray([8192, 10000, 7000, 900, 9000], np.int32)
    rates = np.asarray([1.25, 0.8, 1.15, 0.8, 1.0], np.float32)
    buf = np.zeros((5, L), np.float32)
    for b, n in enumerate(lens):
        buf[b, :n] = rng.randn(n) * 0.3
    got, got_lens = tdev.time_stretch(_t(buf), _t(lens), _t(rates))
    want, want_lens = jdev.time_stretch(_j(buf), _j(lens), _j(rates))
    _eq(got_lens, want_lens)
    _stretch_close(got, want, want_lens, 256)
    _eq(got[3:], buf[3:])
    for b in range(2):
        host = jaug._time_stretch(buf[b, :lens[b]], float(rates[b]))
        assert len(host) == int(got_lens[b])
        _stretch_close(got[b:b + 1, :len(host)], host[None], [len(host)], 256)


# ------------------------ the recipe, JAX's draws ------------------------

GATES = ("tempo_on", "pitch_on", "trim_on", "chorus_on", "compressor_on",
         "noise_on", "peak_on")


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_partial_draws(key, B, L, p=0.5, noise_lo=0.001, noise_hi=0.015,
                      noise_buckets=8, peak_lo=0.25, peak_hi=0.99):
    """``device_augment``'s random numbers from ``key``, split as
    ``rnnt_tpu/data/augment_device.py:371-404`` splits it."""
    r = jax.random
    keys = r.split(key, 9)
    lf = 1 << max(int(math.ceil(math.log2(max(L, 2)))), 1)
    ratios = r.uniform(keys[5], (B, noise_buckets))
    lv_key, gate_key = r.split(keys[8])
    d = {"chorus_idx": r.randint(keys[0], (B,), 0, len(jaug.REFERENCE_CHORUS_FILTERS)),
         "chorus_on": r.uniform(keys[1], (B,)) < p,
         "compressor_idx": r.randint(keys[2], (B,), 0,
                                     len(jaug.REFERENCE_COMPRESSOR_FILTERS)),
         "compressor_on": r.uniform(keys[3], (B,)) < p,
         "noise": r.uniform(keys[4], (B, lf)),
         "noise_ratios": ratios / jnp.sum(ratios, axis=1, keepdims=True),
         "noise_level": 10.0 ** r.uniform(keys[6], (B,), minval=np.log10(noise_lo),
                                          maxval=np.log10(noise_hi)),
         "noise_on": r.uniform(keys[7], (B,)) < p,
         "peak_level": r.uniform(lv_key, (B,), minval=peak_lo, maxval=peak_hi),
         "peak_on": r.uniform(gate_key, (B,)) < p}
    return d


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_full_draws(key, B, L, p=0.5):
    """``device_augment_full``'s random numbers from ``key``, split as
    ``augment_device.py:421-450`` splits it."""
    r = jax.random
    keys = r.split(key, 7)
    d = {"tempo_rate": r.uniform(keys[0], (B,), minval=0.75, maxval=1.25),
         "tempo_on": r.uniform(keys[1], (B,)) < p,
         "pitch_semitones": r.randint(keys[2], (B,), -3, 4),
         "pitch_on": r.uniform(keys[3], (B,)) < p,
         "trim_seconds": r.uniform(keys[4], (B,), maxval=0.02),
         "trim_on": r.uniform(keys[5], (B,)) < p}
    d.update(jax_partial_draws(keys[6], B, L, p))
    return d


def to_port(draws, device="cpu"):
    """JAX's draws as the port's draw dict (tensors on ``device``)."""
    return {k: _t(v).to(device) for k, v in draws.items()}


@functools.lru_cache(maxsize=None)
def jax_recipe(full: bool, p: float = 0.5):
    """JAX's ``device_augment_full`` (or ``device_augment``), jitted, with
    its gates taken from a (7, B) argument in GATES order (or, for None,
    drawn from the key as the recipe draws them): ``_gate`` is swapped in
    the reference module while it traces, and put back."""

    def fn(key, audio, lens, gates):
        rows = iter(range(len(GATES)) if full else range(3, len(GATES)))
        drawn = jdev._gate
        if gates is not None:
            jdev._gate = lambda k, p_, B: gates[next(rows)]
        try:
            if full:
                return jdev.device_augment_full(key, audio, lens, SR, p=p)
            return jdev.device_augment(key, audio, lens, SR, p=p)
        finally:
            jdev._gate = drawn

    return jax.jit(fn)


@pytest.fixture(scope="module")
def batch():
    """Lens up to 0.6 L, so that the recipe's clamps (rate and ratio >=
    len/L) never bind: there jitted XLA's quotient len / (len/L) can fall
    one below L (measured: 15999 for 15000 / 0.9375), which exact
    arithmetic, eager JAX and the port give as L."""
    rng = np.random.RandomState(15)
    L = 16000
    lens = np.asarray([9600, 8000, 6000, 9000], np.int32)
    audio = np.zeros((4, L), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rng.randn(n) * 0.2
    return audio, lens


@pytest.mark.parametrize("on", [(g,) for g in GATES] + [GATES],
                         ids=list(GATES) + ["all"])
def test_device_augment_full_matches_jax_draws(batch, on):
    audio, lens = batch
    B, L = audio.shape
    key = jax.random.PRNGKey(len(on) * 7 + GATES.index(on[0]))
    gates = {g: np.full((B,), g in on) for g in GATES}
    draws = jax_full_draws(key, B, L)
    draws.update(gates)
    want, want_lens = jax_recipe(True)(key, _j(audio), _j(lens),
                                       _j(np.stack([gates[g] for g in GATES])))
    got, got_lens = tdev.device_augment_full_apply(to_port(draws), _t(audio), _t(lens), SR)
    _eq(got_lens, want_lens)
    assert torch.isfinite(got).all()
    for b, m in enumerate(np.asarray(want_lens)):
        assert (got[b, m:] == 0).all()
    if "tempo_on" in on:
        # The stretched signal then runs through resample (ratio >= 0.71)
        # and trim, which move its last hop by up to 256 / 0.71 samples.
        _stretch_close(got, want, want_lens, 361)
    else:
        _close(got, want, RECIPE_ATOL)


def test_device_augment_matches_jax_draws(batch):
    """``augment_device: true``'s half of the recipe, the draws' gates as
    JAX drew them."""
    audio, lens = batch
    B, L = audio.shape
    key = jax.random.PRNGKey(3)
    want = jax_recipe(False, 0.7)(key, _j(audio), _j(lens), None)
    got = tdev.device_augment_apply(to_port(jax_partial_draws(key, B, L, p=0.7)),
                                    _t(audio), _t(lens), SR)
    _close(got, want, RECIPE_ATOL)


def test_port_draws_and_entry_points(batch):
    """The port's own draws: shapes, ranges, determinism per generator;
    ``device_augment_full`` is apply(draws); p = 0 is the identity."""
    audio, lens = batch
    B, L = audio.shape
    d = tdev.device_augment_full_draws(torch.Generator().manual_seed(0), B, L)
    assert set(d) == set(jax_full_draws(jax.random.PRNGKey(0), B, L))
    assert d["noise"].shape == (B, 16384) and d["noise_ratios"].shape == (B, 8)
    assert ((d["tempo_rate"] >= 0.75) & (d["tempo_rate"] < 1.25)).all()
    assert ((d["pitch_semitones"] >= -3) & (d["pitch_semitones"] <= 3)).all()
    assert ((d["noise_level"] >= 0.001 - 1e-9) & (d["noise_level"] <= 0.015 + 1e-9)).all()
    torch.testing.assert_close(d["noise_ratios"].sum(1), torch.ones(B))
    out, new = tdev.device_augment_full(torch.Generator().manual_seed(0), _t(audio),
                                        _t(lens), SR)
    want, want_lens = tdev.device_augment_full_apply(d, _t(audio), _t(lens), SR)
    _eq(out, want)
    _eq(new, want_lens)
    assert ((new > 0) & (new <= L)).all()
    same, same_lens = tdev.device_augment_full(torch.Generator().manual_seed(1),
                                               _t(audio), _t(lens), SR, p=0.0)
    _eq(same, audio)
    _eq(same_lens, lens)


# ------------------------------ host recipe ------------------------------

def _make(pkg, name):
    if name == "choose_filter":
        return pkg.ChooseAFilter(1.0, pkg.REFERENCE_CHORUS_FILTERS
                                 + pkg.REFERENCE_COMPRESSOR_FILTERS)
    return pkg.AUGMENTATIONS[name](1.0)


@pytest.mark.parametrize("name", sorted(jaug.AUGMENTATIONS))
def test_host_augmentation_bit_equal(name):
    x = (np.random.RandomState(1).randn(9000) * 0.3).astype(np.float32)
    for seed in range(3):
        want = _make(jaug, name).apply(x, SR, np.random.RandomState(seed))
        got = _make(taug, name).apply(x, SR, np.random.RandomState(seed))
        assert got.dtype == want.dtype
        _eq(got, want)


def test_default_and_built_augmentors_bit_equal():
    x = (np.random.RandomState(2).randn(12000) * 0.3).astype(np.float32)
    cfgs = [{"kind": "atempo", "p": 0.5, "min_tempo_rate": 0.75, "max_tempo_rate": 1.25},
            {"kind": "white_noise", "p": 0.7},
            {"kind": "choose_filter", "p": 0.6, "filters": jaug.REFERENCE_CHORUS_FILTERS},
            {"kind": "tempo", "p": 0.5}]
    pairs = [(jaug.default_augmentor(), taug.default_augmentor()),
             (jaug.build_augmentor(cfgs), taug.build_augmentor(cfgs)),
             (jdev.host_only_default_augmentor(), tdev.host_only_default_augmentor())]
    for ja, ta in pairs:
        for seed in range(6):
            _eq(ta(x, SR, rng=np.random.RandomState(seed)),
                ja(x, SR, rng=np.random.RandomState(seed)))
        _eq(ta(x, SR), ja(x, SR))      # the augmentor's own RandomState(0)
    with pytest.raises(ValueError, match="unknown augmentation kind"):
        taug.build_augmentor([{"kind": "reverb"}])


def test_warn_stripped_param_mismatch_same_lines(capsys):
    cfgs = [{"kind": "atempo", "p": 0.5, "min_tempo_rate": 0.75, "max_tempo_rate": 1.25},
            {"kind": "trim", "p": 0.9, "bogus": 1},
            {"kind": "white_noise", "p": 0.5},
            {"kind": "shaped_noise", "p": 0.5, "num_buckets": 16},
            {"kind": "choose_filter", "p": 0.5, "filters": ["chorus=0.5:0.8:30:0.4:0.1:2"]}]
    want = jdev.warn_stripped_param_mismatch(cfgs)
    want_out = capsys.readouterr().out
    got = tdev.warn_stripped_param_mismatch(cfgs)
    assert got == want and len(got) == 3
    assert capsys.readouterr().out == want_out
    assert tdev.DEVICE_SIDE_KINDS == jdev.DEVICE_SIDE_KINDS
    assert tdev.DEVICE_SIDE_KINDS_FULL == jdev.DEVICE_SIDE_KINDS_FULL
    assert tdev.DEVICE_RECIPE_PARAMS == jdev.DEVICE_RECIPE_PARAMS


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    import json

    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(tdata.synthetic_piece_table(255)))
    return path


@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "thread"), (2, "process")])
def test_batch_iterator_with_host_augmentor_equals_jax(vocab, workers, mode):
    """The default host recipe through BatchIterator (per-row RandomState,
    2 shards of the epoch): serial, thread and process runs give JAX's
    serial batches exactly."""
    ds = tdata.synthetic_dataset(20, 0.8, seed=4)
    buckets = tdata.Buckets.from_frames([64, 96], [12], FeaturizerSpec())
    common = dict(batch_size=3, seed=5, shard_id=1, num_shards=2, wire_dtype="int16")
    want = list(jdata.BatchIterator(ds, JTokenizer.from_vocab_json(vocab), buckets,
                                    augmentor=jaug.default_augmentor(), **common))
    got = list(tdata.BatchIterator(ds, TTokenizer.from_vocab_json(vocab), buckets,
                                   augmentor=taug.default_augmentor(), num_workers=workers,
                                   worker_mode=mode, **common))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _eq(g[k], w[k])


def test_augment_imports_scipy_before_worker_threads():
    """Importing the module loads the scipy parts the recipe calls, so
    BatchIterator's worker threads never import scipy concurrently (threads
    that do can see scipy half initialised and raise ImportError).  Checked
    in a fresh interpreter, where nothing else has imported scipy yet."""
    import subprocess
    import sys

    code = ("import sys\n"
            "assert 'scipy' not in sys.modules\n"
            "import rnnt_tpu_torch.data.augment\n"
            "missing = [m for m in ('scipy.fft', 'scipy.signal') if m not in sys.modules]\n"
            "assert not missing, missing\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ------------------------------ SpecAugment ------------------------------

def jax_spec_draws(key, B, T, F, nt=2, wt=30, nf=2, wf=27):
    """``spec_augment``'s draws from ``key``, as ``augment.py:456-463``
    splits it."""
    keys = jax.random.split(key, 4)

    def axis(k, n, width, length):
        return (jax.random.randint(k, (B, n), 0, max(length - width, 1)),
                jax.random.randint(jax.random.fold_in(k, 1), (B, n), 0, width + 1))

    ts, tw = axis(keys[0], nt, wt, T)
    fs, fw = axis(keys[1], nf, wf, F)
    return {"time_starts": ts, "time_widths": tw, "freq_starts": fs, "freq_widths": fw}


@pytest.mark.parametrize("T,F", [(120, 201), (20, 16)])
def test_spec_augment_injected_draws_exact(T, F):
    feats = np.random.RandomState(T).randn(3, T, F).astype(np.float32)
    key = jax.random.PRNGKey(T)
    want = jaug.spec_augment(key, _j(feats))
    got = taug.spec_augment_apply(_t(feats), to_port(jax_spec_draws(key, 3, T, F)))
    _eq(got, want)
    assert (got == 0).any()


def test_spec_augment_port_draws():
    g = torch.Generator().manual_seed(0)
    d = taug.spec_augment_draws(g, 4, 100, 80)
    assert ((d["time_starts"] >= 0) & (d["time_starts"] < 70)).all()
    assert ((d["time_widths"] >= 0) & (d["time_widths"] <= 30)).all()
    assert ((d["freq_starts"] >= 0) & (d["freq_starts"] < 53)).all()
    assert ((d["freq_widths"] >= 0) & (d["freq_widths"] <= 27)).all()
    feats = torch.randn(4, 100, 80)
    out = taug.spec_augment(torch.Generator().manual_seed(0), feats)
    _eq(out, taug.spec_augment_apply(feats, d))
