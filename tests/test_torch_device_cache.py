"""The port's on-card corpus cache (data/device_cache.py) against rnnt_tpu's
``DeviceSampleCache`` on the CPU, and the train loop's augmentor and
staging choices.

Both caches are built from the same synthetic corpus with tokenizers read
from one in-test piece table (``vocab_json``).  Exact throughout: the
groups' arrays, the epoch order (the same ``RandomState`` draws), the
gathered batches, and the budget fallback.  Staging: ``device`` with a host
augmentor raises, as does ``device`` over the budget; ``stream`` never
caches; ``auto`` caches only without a host augmentor.  The host
augmentor each data setting selects gives the audio of the one the
reference's ``train`` builds for it (``rnnt_tpu/train/loop.py:173-203``),
bit for bit.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from rnnt_tpu.data import augment as jaug  # noqa: E402
from rnnt_tpu.data import augment_device as jdev  # noqa: E402
from rnnt_tpu.data.device_cache import DeviceSampleCache as JCache  # noqa: E402
from rnnt_tpu.data.device_cache import make_cached_train_step as jcached  # noqa: E402
from rnnt_tpu.data.tokenizer import UnigramTokenizer as JTokenizer  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data import dataset as tdata  # noqa: E402
from rnnt_tpu_torch.data.device_cache import (  # noqa: E402
    DeviceSampleCache, gather_rows, make_cached_train_step)
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer as TTokenizer  # noqa: E402
from rnnt_tpu_torch.ops.stft import FeaturizerSpec  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402

KEYS = ("audio", "audio_lens", "targets", "target_lens")


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(tdata.synthetic_piece_table(255)))
    return path


@pytest.fixture(scope="module")
def corpus():
    return tdata.synthetic_dataset(40, 0.9, seed=3)


def _buckets():
    return tdata.Buckets.from_frames([64, 96], [12], FeaturizerSpec())


def _build(vocab, corpus, wire="int16", budget=None, workers=0):
    j = JCache.build(corpus, JTokenizer.from_vocab_json(vocab), _buckets(),
                     wire_dtype=wire, budget_bytes=budget, collate_batch=8)
    t = DeviceSampleCache.build(corpus, TTokenizer.from_vocab_json(vocab), _buckets(),
                                wire_dtype=wire, budget_bytes=budget, collate_batch=8,
                                num_workers=workers, device="cpu")
    return j, t


@pytest.mark.parametrize("wire,workers", [("int16", 0), ("mulaw", 2), ("float32", 0)])
def test_cache_groups_equal_jax(vocab, corpus, wire, workers):
    j, t = _build(vocab, corpus, wire, workers=workers)
    assert len(t.groups) == len(j.groups) == 2
    for tg, jg in zip(t.groups, j.groups):
        for k in KEYS:
            assert tg[k].device.type == "cpu"
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
    assert t.n_samples == j.n_samples
    assert t.nbytes() == j.nbytes()
    for bs in (1, 3, 4):
        assert t.steps_per_epoch(bs) == j.steps_per_epoch(bs)


@pytest.mark.parametrize("bs,seed", [(4, 0), (3, 7), (2, 1)])
def test_epoch_batches_equal_jax(vocab, corpus, bs, seed):
    j, t = _build(vocab, corpus)
    got = [(gi, idx.tolist()) for gi, idx in t.epoch_batches(bs, seed)]
    want = [(gi, idx.tolist()) for gi, idx in j.epoch_batches(bs, seed)]
    assert got == want and len(got) == t.steps_per_epoch(bs)
    seen = [(gi, i) for gi, idx in got for i in idx]
    assert len(seen) == len(set(seen))
    for gi, idx in t.epoch_batches(bs, seed):
        assert idx.dtype == np.int32
        assert t.batch_audio_seconds(gi, idx) == j.batch_audio_seconds(gi, idx)


def test_gathered_batches_equal_jax(vocab, corpus):
    j, t = _build(vocab, corpus)
    jgather = j.gather_jit()
    step = make_cached_train_step(lambda state, batch, gen: (state, batch))
    jstep = jax.jit(jcached(lambda state, batch, rng: (state, batch)))
    for gi, idx in t.epoch_batches(4, seed=2):
        got = gather_rows(t.groups[gi], idx)
        _, via_step = step(0, t.groups[gi], idx, None)
        want = jgather(j.groups[gi], idx)
        _, want_step = jstep(0, j.groups[gi], idx, None)
        for k in KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(via_step[k].numpy(), np.asarray(want_step[k]))


@pytest.mark.parametrize("budget", [1024, 100_000])
def test_over_budget_returns_none(vocab, corpus, budget):
    j, t = _build(vocab, corpus, budget=budget)
    assert t is None and j is None


def _cfg(vocab, *overrides):
    return tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")), [
        "tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
        "data.synthetic_size=16", "data.synthetic_seconds=0.9",
        "training.frame_buckets=[96]", "training.token_buckets=[12]",
        "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
        *overrides])


@pytest.mark.parametrize("overrides,match", [
    (("data.staging=device", "data.augment=true", "data.augment_device=false"),
     "host-side"),
    (("data.staging=device", "data.augment=true", "data.augment_device=true"),
     "host-side"),
    (("data.staging=device", "data.device_cache_budget_mb=0"), "exceeds"),
    (("data.staging=bogus",), "auto|stream|device"),
])
def test_train_staging_refusals(vocab, tmp_path, overrides, match):
    with pytest.raises(ValueError, match=match):
        tloop.train(_cfg(vocab, *overrides), output_base=tmp_path, max_steps=1,
                    device="cpu")
    assert not any(tmp_path.iterdir())  # refused before writing a run


@pytest.mark.parametrize("overrides,cached", [
    (("data.staging=auto", "data.augment=false"), True),
    (("data.staging=auto", "data.augment=true", "data.augment_device=full"), True),
    (("data.staging=auto", "data.augment=true", "data.augment_device=true"), False),
    (("data.staging=auto", "data.augment=true", "data.augment_device=false"), False),
    (("data.staging=stream", "data.augment=false"), False),
    (("data.staging=device", "data.augment=true", "data.augment_device=full"), True),
    (("data.staging=auto", "data.device_cache_budget_mb=0"), False),
])
def test_staging_choice(vocab, capsys, overrides, cached):
    """``build_cache`` caches exactly when the reference would (an
    over-budget ``auto`` says so and streams)."""
    cfg = _cfg(vocab, *overrides)
    fspec = tconfig.build_featurizer_spec(cfg)
    tc = cfg.training
    cache = tloop.build_cache(
        cfg, tloop._load_datasets(cfg)[0], tloop._load_tokenizer(cfg),
        tdata.Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec), fspec,
        tloop.select_augmentor(cfg), torch.device("cpu"))
    out = capsys.readouterr().out
    assert (cache is not None) == cached
    assert ("device sample cache: 16 samples" in out) == cached
    if "data.device_cache_budget_mb=0" in overrides:
        assert "exceeds device_cache_budget_mb" in out


def test_augment_device_overrides_from_full():
    """``data.augment_device`` takes true, false or full over the
    flagship's ``full``.  A divergence from the reference, pinned: its
    override coerces to the current value's type, so over ``full`` it
    refuses false and true."""
    from rnnt_tpu.config import config as jconfig

    for raw, want in (("false", False), ("true", True), ("FULL", "full")):
        cfg = tconfig.apply_overrides(tconfig.load_config(
            tconfig.resolve_config("base_convjs")), [f"data.augment_device={raw}"])
        assert cfg.data.augment_device == want
    with pytest.raises(ValueError, match="true, false or full"):
        tconfig.apply_overrides(tconfig.load_config(
            tconfig.resolve_config("base_convjs")), ["data.augment_device=2"])
    with pytest.raises(ValueError, match="cannot coerce"):
        jconfig.apply_overrides(jconfig.load_config(
            tconfig.CONFIG_DIR / "base_convjs.yaml"), ["data.augment_device=false"])


_STACK = [{"kind": "atempo", "p": 0.5, "min_tempo_rate": 0.75, "max_tempo_rate": 1.25},
          {"kind": "white_noise", "p": 0.8},
          {"kind": "pitch_shift", "p": 0.6},
          {"kind": "peak_level", "p": 0.7}]


@pytest.mark.parametrize("augment,device,stack,want", [
    (False, "full", False, None),
    (True, "full", False, None),
    (True, True, False, lambda: jdev.host_only_default_augmentor()),
    (True, False, False, lambda: jaug.default_augmentor()),
    (True, False, True, lambda: jaug.build_augmentor(_STACK)),
    (True, True, True, lambda: jaug.build_augmentor([_STACK[0], _STACK[2]])),
    (True, "full", True, None),
], ids=["off", "full", "device", "host", "stack", "stack-device", "stack-full"])
def test_select_augmentor_matches_reference(vocab, capsys, augment, device, stack, want):
    cfg = _cfg(vocab, f"data.augment={str(augment).lower()}",
               f"data.augment_device={str(device).lower()}")
    if stack:
        cfg.data.augmentations = [dict(c) for c in _STACK]
    got = tloop.select_augmentor(cfg)
    if want is None:
        assert got is None
    else:
        x = (np.random.RandomState(0).randn(9000) * 0.3).astype(np.float32)
        for seed in range(4):
            np.testing.assert_array_equal(
                got(x, 16000, rng=np.random.RandomState(seed)),
                want()(x, 16000, rng=np.random.RandomState(seed)))
    if stack and device:
        # The stripped ops whose settings differ from the device recipe's.
        assert "white_noise" in capsys.readouterr().out
    marker = object()
    assert tloop.select_augmentor(cfg, lambda c: marker) is (marker if augment else None)
