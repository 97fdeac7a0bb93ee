"""Streaming inference: audio chunks in, tokens out, at constant memory.

Port of ``rnnt_tpu/decode/streaming.py``.  A chunk of samples (with the
featurizer's ``n_fft - hop`` overlap) is featurized, run through the
streaming encoder with one carry state per causal conv
(``Encoder.streaming``), and decoded greedily from the cross-chunk decode
carry (``greedy_decode_incremental``).  Every stream's state — conv
carries, predictor feature and predictor state (the conv predictor's token
window, or the LSTM's per-layer (h, c)) — stays on the model's device
between chunks; only the sample buffers and the emitted token ids live on
the host.

* ``StreamingSession`` steps one stream, or ``batch`` streams in lockstep.
* ``StreamingSessionPool`` multiplexes up to ``slots`` streams that feed at
  their own pace onto one set of stacked state tensors: ``pump`` gathers
  the lanes with a whole chunk buffered, steps them as one sub-batch
  (padded to a power of two; padding lanes read and write the sink lane
  ``slots``, which is never surfaced) and scatters them back, leaf by leaf
  of the carry (``_scatter_lanes``, as ``rnnt_tpu/decode/streaming.py:135``
  does); a newly opened lane is reset to the fresh carry, which for the
  LSTM is one blank step from the zero state, not zeros.  Only
  ``pump`` touches the device: ``open``, ``feed``, ``flush`` and ``close``
  are host work, so a server's request threads can call them while its
  pump thread owns the card.

The JAX package compiles each step into one program; here a step is one
Python call under ``torch.inference_mode`` (entered by the call itself, so
a serving thread needs no grad-mode setup).  The greedy loop syncs with
the host once an iteration.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from rnnt_tpu_torch.decode.greedy import (
    decode_init_carry, greedy_decode_incremental, tree_map)
from rnnt_tpu_torch.models.encoder import encoder_streaming_init_state
from rnnt_tpu_torch.models.rnnt import RNNT
from rnnt_tpu_torch.ops.stft import FeaturizerSpec, make_featurizer


def _scatter_lanes(tree, sub, idx: torch.Tensor) -> None:
    """``tree[idx] = sub`` leaf by leaf, in place; a leaf of ``sub`` with
    one lane is broadcast over ``idx``."""
    def put(x, s):
        x[idx] = s
    tree_map(put, tree, sub)


def _step(model: RNNT, featurize, chunk: torch.Tensor, conv_states, carry,
          max_tokens: int, max_symbols_per_step: int):
    """Featurize -> streaming encoder -> incremental greedy decode for a
    (B, samples) chunk.  Returns (tokens, counts, n_enc, conv_states,
    carry); with no encoder frame the carry is returned unchanged and
    tokens / counts are zeros."""
    spec = model.spec
    enc, conv_states = model.encoder.streaming(featurize(chunk), conv_states)
    n, n_enc = chunk.shape[0], enc.shape[1]
    if n_enc == 0:
        return (torch.zeros((n, max_tokens), dtype=torch.int32, device=chunk.device),
                torch.zeros((n,), dtype=torch.int32, device=chunk.device),
                0, conv_states, carry)
    t_lens = torch.full((n,), n_enc, dtype=torch.long, device=chunk.device)
    tokens, counts, carry = greedy_decode_incremental(
        model.predictor, model.joint, enc, t_lens, spec.predictor, spec.joint,
        max_tokens=max_tokens, max_symbols_per_step=max_symbols_per_step,
        carry=carry)
    return tokens, counts, n_enc, conv_states, carry


class StreamingSession:
    """One (optionally batched) audio stream on ``model``'s device.

    ``feed(samples)`` takes host float32 samples of any length ((B, n) for
    batch > 1) and returns the newly emitted token ids, a list per stream;
    ``tokens(b)`` returns everything stream b emitted so far.
    """

    def __init__(self, model: RNNT, fspec: FeaturizerSpec, *, batch: int = 1,
                 max_tokens_per_chunk: int = 64,
                 max_symbols_per_step: int = 10):
        self.model = model
        self.spec = model.spec
        self.fspec = fspec
        self.batch = batch
        self.max_tokens_per_chunk = max_tokens_per_chunk
        self.max_symbols_per_step = max_symbols_per_step
        self.device = next(model.parameters()).device
        self._featurize = make_featurizer(fspec)
        self.reset()

    def reset(self):
        self._buffer = np.zeros((self.batch, 0), np.float32)
        with torch.inference_mode():
            self.conv_states = encoder_streaming_init_state(
                self.batch, self.spec.encoder, device=self.device)
            self.decode_carry = decode_init_carry(
                self.model.predictor, self.spec.predictor, self.spec.joint,
                self.batch, self.device)
        self._tokens: list[list[int]] = [[] for _ in range(self.batch)]
        self.encoder_frames_emitted = 0

    def feed(self, samples: np.ndarray) -> list[list[int]]:
        samples = np.asarray(samples, np.float32)
        if samples.ndim == 1:
            samples = samples[None, :]
        if samples.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {samples.shape[0]}")
        self._buffer = np.concatenate([self._buffer, samples], axis=1)

        n_frames = self.fspec.num_frames(self._buffer.shape[1])
        if n_frames == 0:
            return [[] for _ in range(self.batch)]
        consumed = n_frames * self.fspec.hop_length
        chunk = self._buffer[:, : consumed + self.fspec.overlap]
        self._buffer = self._buffer[:, consumed:]

        with torch.inference_mode():
            tokens, counts, n_enc, self.conv_states, self.decode_carry = _step(
                self.model, self._featurize,
                torch.from_numpy(chunk).to(self.device), self.conv_states,
                self.decode_carry, self.max_tokens_per_chunk,
                self.max_symbols_per_step)
            if n_enc == 0:
                return [[] for _ in range(self.batch)]
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
        self.encoder_frames_emitted += n_enc
        out = []
        for b in range(self.batch):
            new = [int(t) for t in tokens[b, : counts[b]]]
            self._tokens[b].extend(new)
            out.append(new)
        return out

    def tokens(self, b: int = 0) -> list[int]:
        return self._tokens[b]


class StreamingSessionPool:
    """Continuous batching: up to ``slots`` independent streams on one set
    of stacked device state tensors (``slots + 1`` lanes; the last is the
    sink that padding lanes read and write).

    ``feed`` only buffers host samples; ``pump`` steps every slot that has
    a whole chunk (``chunk_seconds`` of hops plus the overlap) buffered, in
    sub-batches padded to a power of two, until none has.  A chunk of a
    fixed ``frames_per_chunk`` keeps every carry at a fixed length, which
    the stacked state needs: with the stride-2 prologue that count must be
    even (0.2 s chunks give 20).
    """

    def __init__(self, model: RNNT, fspec: FeaturizerSpec, *, slots: int = 8,
                 chunk_seconds: float = 0.2, max_tokens_per_chunk: int = 64,
                 max_symbols_per_step: int = 10):
        self.model = model
        self.spec = spec = model.spec
        self.fspec = fspec
        self.slots = slots
        self.max_tokens_per_chunk = max_tokens_per_chunk
        self.max_symbols_per_step = max_symbols_per_step
        self.device = dev = next(model.parameters()).device

        hop = fspec.hop_length
        self.frames_per_chunk = max(int(round(chunk_seconds
                                              * fspec.sample_rate)) // hop, 1)
        self.chunk_samples = self.frames_per_chunk * hop
        self._need = self.chunk_samples + fspec.overlap
        self._featurize = make_featurizer(fspec)

        with torch.inference_mode():
            self.conv_states = encoder_streaming_init_state(
                slots + 1, spec.encoder, device=dev)
            self.decode_carry = decode_init_carry(
                model.predictor, spec.predictor, spec.joint, slots + 1, dev)
            self._fresh_carry = decode_init_carry(
                model.predictor, spec.predictor, spec.joint, 1, dev)

        self._free = list(range(slots))
        self._stale: set[int] = set()  # opened lanes still holding old state
        self._buffers: dict[int, np.ndarray] = {}
        self._tokens: dict[int, list[int]] = {}
        # Serving observability: the last 1000 device steps' latencies and
        # lane counts, and a token counter.
        self._pump_ms: deque[float] = deque(maxlen=1000)
        self._pump_lanes: deque[int] = deque(maxlen=1000)
        self._total_tokens = 0

    def open(self) -> int:
        """Claim a free slot; its stream state starts fresh.  Host work
        only: the next pump resets the lane before stepping it."""
        if not self._free:
            raise RuntimeError(f"all {self.slots} slots in use")
        slot = self._free.pop(0)
        self._stale.add(slot)
        self._buffers[slot] = np.zeros((0,), np.float32)
        self._tokens[slot] = []
        return slot

    def _reset_opened_lanes(self) -> None:
        """Fresh state for the lanes opened since the last pump, written by
        unique indices (the scatter of a pump may repeat the sink's)."""
        if not self._stale:
            return
        idx = torch.tensor(sorted(self._stale), device=self.device)
        for s in self.conv_states:
            s[idx] = 0
        _scatter_lanes(self.decode_carry, self._fresh_carry, idx)
        self._stale.clear()

    def close(self, slot: int) -> None:
        self._buffers.pop(slot, None)
        self._tokens.pop(slot, None)
        if slot not in self._free:
            self._free.append(slot)

    def feed(self, slot: int, samples: np.ndarray) -> None:
        """Buffer host samples for one stream (no device work)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffers[slot] = np.concatenate([self._buffers[slot], samples])

    def flush(self, slot: int) -> None:
        """Zero-pad a stream's tail so its remaining audio decodes on the
        next pump (end of stream)."""
        buf = self._buffers[slot]
        if buf.shape[0] == 0:
            return
        pad = max(self._need - buf.shape[0], 0)
        self._buffers[slot] = np.concatenate([buf, np.zeros((pad,), np.float32)])

    def slot_ready(self, slot: int) -> bool:
        """True when the slot has at least one whole chunk buffered."""
        buf = self._buffers.get(slot)
        return buf is not None and buf.shape[0] >= self._need

    def has_ready(self) -> bool:
        return any(b.shape[0] >= self._need for b in self._buffers.values())

    def _pump_step(self, chunk: torch.Tensor, idx: torch.Tensor):
        """Gather lanes ``idx``, step them, scatter them back.  Padding
        lanes repeat the sink's index; the sink is never read, so which of
        its duplicate writes lands does not matter."""
        conv_sub = tuple(s[idx] for s in self.conv_states)
        carry_sub = tree_map(lambda x: x[idx], self.decode_carry)
        tokens, counts, n_enc, conv_sub, carry_sub = _step(
            self.model, self._featurize, chunk, conv_sub, carry_sub,
            self.max_tokens_per_chunk, self.max_symbols_per_step)
        for s, sub in zip(self.conv_states, conv_sub):
            s[idx] = sub
        if n_enc:
            _scatter_lanes(self.decode_carry, carry_sub, idx)
        return tokens, counts

    def pump(self) -> dict[int, list[int]]:
        """Step every stream with a whole chunk buffered; returns the newly
        emitted token ids per stepped slot."""
        out: dict[int, list[int]] = {}
        while True:
            ready = [s for s, b in self._buffers.items() if b.shape[0] >= self._need]
            if not ready:
                return out
            t0 = time.perf_counter()
            ready = ready[: self.slots]
            n = 1
            while n < len(ready):
                n *= 2
            idx_np = np.full((n,), self.slots, np.int64)
            idx_np[: len(ready)] = ready
            chunk = np.zeros((n, self._need), np.float32)
            for i, s in enumerate(ready):
                chunk[i] = self._buffers[s][: self._need]
                self._buffers[s] = self._buffers[s][self.chunk_samples:]

            with torch.inference_mode():
                self._reset_opened_lanes()
                tokens, counts = self._pump_step(
                    torch.from_numpy(chunk).to(self.device),
                    torch.from_numpy(idx_np).to(self.device))
                tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
            for i, s in enumerate(ready):
                new = [int(t) for t in tokens[i, : counts[i]]]
                self._tokens[s].extend(new)
                self._total_tokens += len(new)
                out.setdefault(s, []).extend(new)
            self._pump_ms.append((time.perf_counter() - t0) * 1e3)
            self._pump_lanes.append(len(ready))

    def tokens(self, slot: int) -> list[int]:
        return self._tokens[slot]

    def stats(self) -> dict:
        """Serving metrics: device-step latency percentiles, batching
        occupancy and the token counter."""
        lat = sorted(self._pump_ms)
        pct = (lambda p: lat[min(int(p * len(lat)), len(lat) - 1)]) \
            if lat else (lambda p: 0.0)
        return {
            "active_slots": self.slots - len(self._free),
            "slots": self.slots,
            "device_steps": len(lat),
            "step_ms_p50": round(pct(0.50), 2),
            "step_ms_p99": round(pct(0.99), 2),
            "mean_batched_lanes": round(
                float(np.mean(self._pump_lanes)) if self._pump_lanes else 0.0, 2),
            "max_batched_lanes": int(max(self._pump_lanes, default=0)),
            "tokens_emitted": self._total_tokens,
        }
