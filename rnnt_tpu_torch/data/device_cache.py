"""The on-card corpus cache.

Port of ``rnnt_tpu/data/device_cache.py``.  When the wire-format corpus
fits ``data.device_cache_budget_mb`` of card memory, it is collated once,
grouped by padded (samples, tokens) bucket, and kept on the card; each
training batch is then a row gather driven by a (B,) index vector, so a
step copies ~B indices to the card instead of the batch.  The cache holds
UNAUGMENTED wire audio: with device augmentation in the step every epoch
still sees fresh augmentation; epoch shuffling is a host-side permutation
of indices, in the reference's ``RandomState`` order.

The row gather is ``index_select`` (the reference's is ``jnp.take``, not a
kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from rnnt_tpu_torch.data.dataset import BatchIterator
from rnnt_tpu_torch.train.profiling import span

_KEYS = ("audio", "audio_lens", "targets", "target_lens")


class DeviceSampleCache:
    """Bucket-grouped tensors of collated samples on one device.

    ``groups`` is a list of ``{key: tensor}`` dicts, one per padded (S, U)
    bucket shape, each with a leading sample axis.  Host copies of
    ``audio_lens`` are kept for throughput accounting without reading the
    card."""

    def __init__(self, groups, host_audio_lens, sample_rate: int = 16000):
        self.groups = groups
        self._host_audio_lens = host_audio_lens
        self.sample_rate = sample_rate

    @classmethod
    def build(cls, dataset, tokenizer, buckets, *, wire_dtype: str = "int16",
              collate_batch: int = 64, budget_bytes: int | None = None,
              shard_id: int = 0, num_shards: int = 1,
              sample_rate: int = 16000, num_workers: int = 0,
              device="cuda"):
        """Tokenize and collate the corpus once (no host augmentation) and
        put it on ``device``.  Returns None when the corpus exceeds
        ``budget_bytes`` (checked while collating, so host memory stays
        bounded too) or is empty; callers then stream."""
        it = BatchIterator(dataset, tokenizer, buckets,
                           batch_size=collate_batch, augmentor=None,
                           shuffle=False, drop_last=False,
                           num_workers=num_workers,
                           shard_id=shard_id, num_shards=num_shards,
                           wire_dtype=wire_dtype)
        host: dict[tuple[int, int], list] = {}
        total = 0
        for b in it:
            key = (b["audio"].shape[1], b["targets"].shape[1])
            host.setdefault(key, []).append(b)
            total += sum(b[k].nbytes for k in _KEYS)
            if budget_bytes is not None and total > budget_bytes:
                return None
        if not host:
            return None
        groups, host_lens = [], []
        for key in sorted(host):
            cat = {k: np.concatenate([bb[k] for bb in host[key]], axis=0)
                   for k in _KEYS}
            host_lens.append(cat["audio_lens"].copy())
            groups.append({k: torch.from_numpy(v).to(device)
                           for k, v in cat.items()})
        return cls(groups, host_lens, sample_rate)

    @property
    def n_samples(self) -> int:
        return sum(len(lens) for lens in self._host_audio_lens)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for g in self.groups for v in g.values())

    def steps_per_epoch(self, batch_size: int) -> int:
        return sum(len(lens) // batch_size for lens in self._host_audio_lens)

    def epoch_batches(self, batch_size: int, seed: int):
        """Yield (group_index, (B,) int32 row indices) covering each cached
        sample at most once, full batches only, batch order shuffled across
        groups — the reference's order for the same seed."""
        rng = np.random.RandomState(seed)
        chunks = []
        for gi, lens in enumerate(self._host_audio_lens):
            perm = rng.permutation(len(lens))
            for j in range(len(lens) // batch_size):
                chunks.append((gi, perm[j * batch_size:(j + 1) * batch_size]))
        rng.shuffle(chunks)
        for gi, idx in chunks:
            yield gi, np.ascontiguousarray(idx, dtype=np.int32)

    def batch_audio_seconds(self, gi: int, idx: np.ndarray) -> float:
        return float(self._host_audio_lens[gi][idx].sum()) / self.sample_rate


def gather_rows(group: dict, idx) -> dict:
    """The batch of rows ``idx`` ((B,) ints) of a cache group, on the
    group's device.  To a card the indices go from pinned memory without
    waiting for it."""
    dev = group["audio"].device
    rows = torch.from_numpy(np.asarray(idx, dtype=np.int64))
    if dev.type == "cuda":
        rows = rows.pin_memory().to(dev, non_blocking=True)
    return {k: v.index_select(0, rows) for k, v in group.items()}


def make_cached_train_step(step_fn):
    """Wrap ``step(state, batch, generator)`` as ``step(state, group, idx,
    generator)``: the batch is gathered from the cached group first, in a
    ``gather`` span of the step (``train/profiling.py``)."""

    def cached_step(state, group, idx, generator):
        with span("gather", step=getattr(state, "step", None)):
            batch = gather_rows(group, idx)
        return step_fn(state, batch, generator)

    return cached_step
