"""Synthetic corpus and static-shape batching.

The port's own copy of the host data layer of ``rnnt_tpu/data/dataset.py``:
the wire formats (int16 at ``WIRE_SCALE``, 8-bit mu-law at half scale),
the deterministic synthetic corpus, (samples, tokens) buckets and the
``BatchIterator`` that augments (host recipe, per-row RNG), tokenizes,
bucket-pads and collates numpy batches exactly as the JAX package does,
serially or over a thread or process pool; and the Hugging Face corpus
loaders (``librispeech_dataset``, ``commonvoice_dataset``) with
``concatenate_rows``, which import ``datasets`` when called, as the JAX
package's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer
from rnnt_tpu_torch.ops.stft import FeaturizerSpec

# int16 wire-format scale: 2x headroom over full-scale PCM.
WIRE_SCALE = 16384.0

# mu-law (mu=255) 8-bit wire, uint8 with bias 128, encoded at half scale
# (decode multiplies by 2) for the same 2x headroom as int16.
_MU = 255.0
MULAW_PRESCALE = 0.5


def mulaw_encode(audio: np.ndarray) -> np.ndarray:
    x = np.clip(audio * MULAW_PRESCALE, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return (np.rint(y * 127.0) + 128.0).astype(np.uint8)


_WORDS = (
    "the of and to in a is that it was for on are as with his they at be "
    "this have from or one had by word but not what all were we when your "
    "can said there use an each which she how their if will up other about "
    "out many then them these so some her would make like him into time has "
    "look two more write go see number no way could people my than first "
    "water been call who oil its now find long down day did get come made "
    "may part over new sound take only little work know place year live me "
    "back give most very after thing our just name good sentence man think "
    "say great where help through much before line right too mean old any "
    "same tell boy follow came want show also around form three small set "
    "put end does another well large must big even such because turn here "
    "why ask went men read need land different home us move try kind hand "
    "picture again change off play spell air away animal house point page "
    "letter mother answer found study still learn should world high every "
    "near add food between own below country plant last school father keep "
    "tree never start city earth eye light thought head under story saw "
    "left dont few while along might close something seem next hard open "
    "example begin life always those both paper together got group often run"
).split()


def synthetic_dataset(size: int, seconds: float, sample_rate: int = 16000,
                      seed: int = 0, max_words: int = 12) -> list[dict]:
    """Deterministic synthetic corpus: band-limited noise + random text.
    Mirrors the HF row shape: {"audio": {"array", "sampling_rate"}, "text"}.
    ``max_words`` scales target length (default keeps the historical 3-11
    word range; larger values give flagship-scale U for A/B studies)."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(size):
        n = int(seconds * sample_rate * rng.uniform(0.6, 1.0))
        audio = rng.randn(n).astype(np.float32) * 0.05
        # A few random tones so the spectrogram has structure.
        t = np.arange(n) / sample_rate
        for _ in range(3):
            f = rng.uniform(100, 4000)
            audio += (rng.uniform(0.02, 0.1)
                      * np.sin(2 * np.pi * f * t).astype(np.float32))
        n_words = rng.randint(max(3, max_words // 4), max_words)
        text = " ".join(rng.choice(_WORDS) for _ in range(n_words))
        rows.append({"audio": {"array": audio, "sampling_rate": sample_rate},
                     "text": text})
    return rows


def synthetic_piece_table(n_pieces: int = 1023) -> dict[int, str]:
    """An id -> piece table (the ``vocab_json`` format) in which every
    synthetic-corpus word is one piece, so its segmentation is unique;
    filler pieces that no text contains pad it to ``n_pieces``.  Stands in
    for a SentencePiece model where none is available."""
    pieces = ["<unk>"] + list(dict.fromkeys("\u2581" + w for w in _WORDS))
    if len(pieces) > n_pieces:
        raise ValueError(f"{len(pieces)} word pieces exceed {n_pieces}")
    pieces += [f"<fill{i}>" for i in range(n_pieces - len(pieces))]
    return dict(enumerate(pieces))


def librispeech_dataset(splits: Sequence[str], cache_dir: str = ""):
    """Hugging Face ``librispeech_asr`` splits, concatenated."""
    import datasets as hf_datasets

    parts = [hf_datasets.load_dataset("librispeech_asr", cache_dir=cache_dir or None,
                                      split=split) for split in splits]
    if len(parts) == 1:
        return parts[0]
    return hf_datasets.concatenate_datasets(parts)


def commonvoice_dataset(split: str, cache_dir: str = ""):
    """CommonVoice 16.1 (en) cast to 16 kHz audio, ``sentence`` copied to
    ``text``."""
    import datasets as hf_datasets

    ds = hf_datasets.load_dataset(
        "mozilla-foundation/common_voice_16_1", "en", split=split,
        cache_dir=cache_dir or None)
    ds = ds.cast_column("audio", hf_datasets.Audio(sampling_rate=16_000))

    def fixup(row):
        row["text"] = row["sentence"]
        return row

    return ds.map(fixup)


class _ConcatRows:
    """Row datasets (Hugging Face datasets or row lists) behind one
    ``__len__`` / ``__getitem__``, whatever their other columns, so mixed
    corpora compose."""

    def __init__(self, parts):
        self.parts = list(parts)
        self._offsets = []
        total = 0
        for p in self.parts:
            total += len(p)
            self._offsets.append(total)

    def __len__(self):
        return self._offsets[-1] if self._offsets else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        lo = 0
        for part, off in zip(self.parts, self._offsets):
            if idx < off:
                return part[idx - lo]
            lo = off
        raise IndexError(idx)


def concatenate_rows(parts):
    """One dataset of ``parts``; a single part passes through as it is."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    return _ConcatRows(parts)


@dataclass
class Buckets:
    """Static-shape padding targets: samples (audio) and tokens (text)."""
    sample_buckets: tuple[int, ...]
    token_buckets: tuple[int, ...]

    @classmethod
    def from_frames(cls, frame_buckets: Sequence[int],
                    token_buckets: Sequence[int],
                    spec: FeaturizerSpec) -> "Buckets":
        samples = tuple(spec.samples_for_frames(f)
                        for f in sorted(frame_buckets))
        return cls(samples, tuple(sorted(token_buckets)))

    def pick(self, n_samples: int, n_tokens: int) -> tuple[int, int] | None:
        """Smallest bucket fitting the utterance, or None (drop too-long)."""
        s = next((b for b in self.sample_buckets if b >= n_samples), None)
        t = next((b for b in self.token_buckets if b >= n_tokens), None)
        if s is None or t is None:
            return None
        return s, t


# Fork-inheritance stash for process workers: set in the parent just before
# the pool forks, read by ``_process_row_forked`` in the children, so nothing
# (tokenizer, dataset) is pickled.
_FORK_STASH: "BatchIterator | None" = None


def _process_row_forked(idx: int):
    return _FORK_STASH._process(idx)


def _ordered_windowed_map(submit, fn, items, window: int):
    """Parallel ``map`` that keeps at most ``window`` tasks in flight and
    yields results in input order, so a pool that races ahead of the card
    holds O(window) augmented utterances, not an epoch."""
    from collections import deque

    futs: deque = deque()
    try:
        for x in items:
            futs.append(submit(fn, x))
            if len(futs) >= window:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
    finally:
        for f in futs:
            f.cancel()


class BatchIterator:
    """Tokenize, augment, bucket-pad and batch a dataset.

    Yields numpy batches {"audio": (B, S), "audio_lens": (B,) i32,
    "targets": (B, U) i32, "target_lens": (B,) i32} where (S, U) come from
    the bucket grid and audio is in ``wire_dtype`` (float32, int16 or
    mulaw).  Utterances are grouped per bucket so every batch has one
    shape; utterances longer than every bucket are dropped.

    ``augmentor`` (data/augment.py) runs per row with its own
    ``RandomState((seed * 1_000_003 + idx) % (2**31 - 1))``.
    ``num_workers`` maps the per-row augment + tokenize over a pool of
    threads (``worker_mode="thread"``; numpy and scipy release the GIL) or
    of forked processes (``"process"``).  The per-row RNG makes serial,
    thread and process runs give identical batches.  ``shard_id`` /
    ``num_shards`` take a disjoint stride of the shuffled epoch order;
    ``rows_loaded`` counts the rows an iteration has loaded (and
    augmented) so far."""

    def __init__(self, dataset, tokenizer: UnigramTokenizer, buckets: Buckets,
                 batch_size: int, *, augmentor=None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 max_batches: int | None = None, num_workers: int = 0,
                 worker_mode: str = "thread", shard_id: int = 0,
                 num_shards: int = 1, wire_dtype: str = "float32"):
        if wire_dtype not in ("float32", "int16", "mulaw"):
            raise ValueError(f"wire_dtype must be float32|int16|mulaw, "
                             f"got {wire_dtype!r}")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, "
                             f"got {worker_mode!r}")
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.buckets = buckets
        self.batch_size = batch_size
        self.augmentor = augmentor
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.max_batches = max_batches
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.wire_dtype = wire_dtype
        self.rows_loaded = 0

    def _process(self, idx: int):
        """Load, augment and tokenize one utterance (thread-safe: a fresh
        RNG per row)."""
        row = self.dataset[int(idx)]
        audio = np.asarray(row["audio"]["array"], dtype=np.float32)
        sr = row["audio"].get("sampling_rate", 16000)
        if self.augmentor is not None:
            rng = np.random.RandomState((self.seed * 1_000_003 + idx)
                                        % (2 ** 31 - 1))
            audio = self.augmentor(audio, sr, rng=rng)
        return audio, self.tokenizer.encode(row["text"].lower())

    def _rows(self, order):
        """(rows iterator, pool or None) over ``order``."""
        window = max(4 * self.num_workers, 16)
        if self.num_workers > 0 and self.worker_mode == "process":
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            global _FORK_STASH
            _FORK_STASH = self
            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("fork"))
            return _ordered_windowed_map(pool.submit, _process_row_forked,
                                         order, window), pool
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            return _ordered_windowed_map(pool.submit, self._process, order,
                                         window), pool
        return map(self._process, order), None

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
        rows, pool = self._rows(order)
        pending: dict[tuple[int, int], list] = {}
        emitted = 0
        self.rows_loaded = 0
        try:
            for audio, tokens in rows:
                self.rows_loaded += 1
                if len(tokens) == 0:
                    continue
                b = self.buckets.pick(len(audio), len(tokens))
                if b is None:
                    continue
                pending.setdefault(b, []).append((audio, tokens))
                if len(pending[b]) == self.batch_size:
                    yield self._collate(pending.pop(b), b)
                    emitted += 1
                    if self.max_batches and emitted >= self.max_batches:
                        return
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        if not self.drop_last:
            for b, items in pending.items():
                if items:
                    yield self._collate(items, b)
                    emitted += 1
                    if self.max_batches and emitted >= self.max_batches:
                        return

    def _collate(self, items, bucket) -> dict:
        S, U = bucket
        B = len(items)
        audio = np.zeros((B, S), np.float32)
        audio_lens = np.zeros((B,), np.int32)
        targets = np.zeros((B, U), np.int32)
        target_lens = np.zeros((B,), np.int32)
        for i, (a, toks) in enumerate(items):
            audio[i, : len(a)] = a
            audio_lens[i] = len(a)
            targets[i, : len(toks)] = toks
            target_lens[i] = len(toks)
        if self.wire_dtype == "int16":
            # 16-bit PCM at scale 16384 (2x headroom); decoded on the
            # device by train/step.py decode_wire_audio.
            audio = np.clip(np.rint(audio * WIRE_SCALE),
                            -32768, 32767).astype(np.int16)
        elif self.wire_dtype == "mulaw":
            audio = mulaw_encode(audio)
        return {"audio": audio, "audio_lens": audio_lens,
                "targets": targets, "target_lens": target_lens}
