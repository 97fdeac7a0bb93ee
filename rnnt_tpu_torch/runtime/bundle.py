"""Export-bundle runtime: transcribe with only the files ``cli/export``
wrote (``manifest.json``, ``tokenizer.json``, ``encoder_streaming_states.json``
and the ``torch.export`` graphs ``<name>.pt2``).

Port of ``rnnt_tpu/runtime/bundle.py``.  ``cli/run_bundle`` transcribes
WAV files with it and ``cli/serve --bundle`` serves streaming sessions
from it.  It imports nothing of the port's ``models``, ``train``,
``decode`` or ``ops``: a graph or manifest field that is missing or wrong
breaks these paths, not only a test.

Decoding is the live greedy decoder's: time-synchronous, at most
``max_symbols_per_step`` emissions a frame, blank advances time, at most
``max_tokens`` in all.  The predictor graph takes a fixed token window
(manifest ``predictor_tokens``); the conv predictor's finite receptive
field (``predictor_window``) makes a sliding window exact, which loading
checks.  Every joint call's argmax is read on the host, as in the JAX
runtime: one device sync a (t, u).

``BundleStream.flush`` decodes a short utterance: the JAX runtime returns
early whenever the buffered tail is no longer than the featurizer's
overlap, even before any chunk was encoded, so an utterance that short is
transcribed as empty there (``rnnt_tpu/runtime/bundle.py:164``).  Here the
early return applies only once a chunk has been encoded, when such a tail
is overlap the last chunk already covered.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from rnnt_tpu_torch.utils import resolve_device

REQUIRED = ("manifest.json", "tokenizer.json", "encoder_streaming_states.json")


class BundleRuntime:
    """A bundle directory's graphs on ``device`` (CUDA unless ``"cpu"``; no
    fallback); makes streams and offline transcriptions."""

    def __init__(self, bundle_dir: str | Path, device="cuda"):
        bundle_dir = Path(bundle_dir)
        for name in REQUIRED:
            if not (bundle_dir / name).exists():
                raise FileNotFoundError(f"{bundle_dir} is not an export bundle "
                                        f"(missing {name})")
        self.device = resolve_device(device)
        self.manifest = json.loads((bundle_dir / "manifest.json").read_text())
        self.pieces = {int(k): v for k, v in json.loads(
            (bundle_dir / "tokenizer.json").read_text()).items()}
        self.graphs = {
            name: move_to_device_pass(torch.export.load(bundle_dir / f"{name}.pt2"),
                                      self.device).module()
            for name in self.manifest["graphs"]}
        states = json.loads((bundle_dir / "encoder_streaming_states.json").read_text())
        self.state_shapes = states["shapes"]
        self.pred_tokens = int(self.manifest.get("predictor_tokens", 16))
        window = int(self.manifest.get("predictor_window", 0))
        if window > self.pred_tokens:
            raise ValueError(
                f"bundle predictor window {window} exceeds the exported token ports "
                f"({self.pred_tokens}); re-export with --pred-tokens >= {window}")

    def detokenize(self, tokens) -> str:
        text = "".join(self.pieces.get(int(t), "") for t in tokens)
        return text.replace("▁", " ").strip()

    def open_stream(self, max_symbols_per_step: int = 10,
                    max_tokens: int = 512) -> "BundleStream":
        return BundleStream(self, max_symbols_per_step, max_tokens)

    def transcribe(self, wav: np.ndarray, *, pad_tail: bool = True,
                   max_symbols_per_step: int = 10, max_tokens: int = 512):
        """Offline: one stream fed the whole wave; ``pad_tail`` zero-pads
        the last partial chunk so the tail is decoded.  Returns (tokens,
        text)."""
        stream = self.open_stream(max_symbols_per_step, max_tokens)
        stream.feed(wav)
        if pad_tail:
            stream.flush()
        return list(stream.tokens), stream.text()


class BundleStream:
    """One streaming session over a bundle: buffers samples, featurizes and
    encodes each whole chunk (carrying the numbered encoder states on the
    device) and runs the incremental greedy loop over its frames."""

    def __init__(self, runtime: BundleRuntime, max_symbols_per_step: int,
                 max_tokens: int = 512):
        self.rt = runtime
        m = runtime.manifest
        self.chunk_samples = int(m["chunk_samples"])
        self.overlap = int(m["overlap"])
        self.new_per_chunk = self.chunk_samples - self.overlap
        self.blank = int(m["blank_idx"])
        self.max_symbols = max_symbols_per_step
        self.max_tokens = max_tokens
        self.states = [torch.zeros(s, device=runtime.device) for s in runtime.state_shapes]
        self.buffer = np.zeros((0,), np.float32)
        self.tokens: list[int] = []
        self.chunks = 0     # chunks encoded so far
        self._feat = None   # predictor feature of the current history

    def _pred_feat(self) -> torch.Tensor:
        p = self.rt.pred_tokens
        hist = ([self.blank] + self.tokens)[-p:]
        window = torch.tensor([(hist + [self.blank] * p)[:p]], dtype=torch.long,
                              device=self.rt.device)
        return self.rt.graphs["predictor"](window)[:, len(hist) - 1]

    def _decode_frames(self, enc: torch.Tensor) -> None:
        """Greedy over (1, T, H) encoder frames, continuing the history."""
        if self._feat is None:
            self._feat = self._pred_feat()
        for t in range(enc.shape[1]):
            frame = enc[:, t]
            for _ in range(self.max_symbols):
                if len(self.tokens) >= self.max_tokens:
                    return
                k = int(torch.argmax(self.rt.graphs["joint"](frame, self._feat)[0]))
                if k == self.blank:
                    break
                self.tokens.append(k)
                self._feat = self._pred_feat()

    def feed(self, samples: np.ndarray) -> list[int]:
        """Buffer samples; featurize, encode and decode every whole chunk.
        Returns the tokens this call emitted."""
        mark = len(self.tokens)
        self.buffer = np.concatenate([self.buffer, np.asarray(samples, np.float32)])
        graphs = self.rt.graphs
        with torch.inference_mode():
            while len(self.buffer) >= self.chunk_samples:
                chunk = torch.from_numpy(self.buffer[:self.chunk_samples].copy())
                self.buffer = self.buffer[self.new_per_chunk:]
                feats = graphs["featurize"](chunk[None].to(self.rt.device))
                out = graphs["encoder_streaming"](feats, *self.states)
                self.states = list(out[1:])
                self.chunks += 1
                self._decode_frames(out[0])
        return self.tokens[mark:]

    def flush(self) -> list[int]:
        """Zero-pad the buffered tail to a whole chunk and decode it; an
        empty buffer, or once a chunk was encoded a tail within the
        overlap, has nothing new to decode."""
        n = len(self.buffer)
        if n == 0 or (self.chunks and n <= self.overlap):
            return []
        return self.feed(np.zeros((self.chunk_samples - n,), np.float32))

    def text(self) -> str:
        return self.rt.detokenize(self.tokens)
