"""Streaming ASR server:
``python -m rnnt_tpu_torch.cli.serve <checkpoint_dir> [--port 8000] [--slots 8]``.

Port of ``rnnt_tpu/cli/serve.py``.  Every session shares one
``StreamingSessionPool``, so concurrent callers are decoded together in
padded sub-batches on the card.  Clients stream 16 kHz mono PCM over plain
HTTP:

    POST /session                         -> {"session": id}  (503 when full)
    POST /feed/<id>   (body: int16 PCM)   -> {"new_tokens": [...], "text": str}
    GET  /text/<id>                       -> {"text": str}
    GET  /stats                           -> device-step latency p50/p99,
                                             batching occupancy, token count
    DELETE /session/<id>                  -> {"text": str}   (flushes tail)

``/feed`` takes the audio's rate from an ``X-Sample-Rate`` header or a
``?rate=`` query; other rates than 16 kHz are resampled on the host with a
polyphase anti-aliasing filter.

A background pump thread does all device work: feeds only buffer samples
and wake it, so the chunks of concurrent callers land in one sub-batch.
The checkpoint is a directory of ``config.yaml`` and ``params.npz``
(compat/jax_params.py).  Runs on CUDA unless ``--device cpu``; without CUDA
it raises.  ``--set key.path=value`` overrides the checkpoint's config.
Serving from an export bundle (``--bundle``) is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import threading
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_server(argv=None) -> ThreadingHTTPServer:
    """Parse ``argv``, load the model and return the bound (not yet
    serving) HTTP server; its ``runtime`` attribute owns the pump thread,
    which ``runtime.stop()`` ends."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="checkpoint directory")
    ap.add_argument("--bundle", action="store_true",
                    help="serve from an export bundle (not ported yet)")
    ap.add_argument("--config", default=None,
                    help="config yaml (default: next to checkpoint)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=8,
                    help="max concurrent sessions batched on the device")
    ap.add_argument("--chunk-seconds", type=float, default=0.2)
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    if args.bundle:
        raise NotImplementedError(
            "serving from an export bundle needs the bundle runtime, which is "
            "not ported to rnnt_tpu_torch yet (ROADMAP.md queue 1, item 6: "
            "export and the bundle runtime)")

    from rnnt_tpu_torch.compat.jax_params import find_config, load_checkpoint
    from rnnt_tpu_torch.config.config import (
        apply_overrides, build_featurizer_spec, build_model_spec, load_config)
    from rnnt_tpu_torch.decode.streaming import StreamingSessionPool
    from rnnt_tpu_torch.train.loop import _load_tokenizer
    from rnnt_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config or find_config(args.checkpoint)),
                          args.overrides)
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    model = load_checkpoint(args.checkpoint, spec, dev)
    pool = StreamingSessionPool(model, fspec, slots=args.slots,
                                chunk_seconds=args.chunk_seconds)
    runtime = ServerRuntime(pool, tokenizer)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(runtime))
    server.runtime = runtime
    server.description = (
        f"model {cfg.model_name} on {dev}, {fspec.num_bins}-bin featurizer, "
        f"{args.slots} batched slots, background pump")
    return server


def main(argv=None) -> None:
    server = make_server(argv)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} ({server.description})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.runtime.stop()
        server.server_close()


class ServerRuntime:
    """Sessions plus the background pump thread that does all device work.

    Feed handlers only buffer samples and wait on a condition until the
    pump has consumed every whole chunk of their slot; the pump steps all
    slots buffered at that moment as one sub-batch.  A pump that raises
    stops the pump thread, and every later request that needs it raises
    ``RuntimeError`` with the pump's error (the handler answers 500)."""

    def __init__(self, pool, tokenizer):
        self.pool = pool
        self.tokenizer = tokenizer
        self.sessions: dict[str, int] = {}  # public id -> pool slot
        self.cond = threading.Condition()
        self._stop = False
        self._error: str | None = None
        self._thread = threading.Thread(target=self._pump_loop, daemon=True)
        self._thread.start()

    # ----- pump thread -----

    def _pump_loop(self):
        while True:
            with self.cond:
                self.cond.wait_for(lambda: self._stop or self.pool.has_ready())
                if self._stop:
                    return
                try:
                    self.pool.pump()  # enters inference mode in this thread
                except Exception:
                    self._error = traceback.format_exc()
                    return
                finally:
                    self.cond.notify_all()

    def _wait_consumed(self, slot: int, timeout: float) -> None:
        self.cond.wait_for(lambda: self._error is not None
                           or not self.pool.slot_ready(slot), timeout=timeout)
        if self._error is not None:
            raise RuntimeError(f"the pump thread failed:\n{self._error}")

    def stop(self):
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        self._thread.join(timeout=5)

    # ----- request-side operations (each takes the condition lock) -----

    def open(self) -> str:
        with self.cond:
            slot = self.pool.open()  # raises RuntimeError when full
            sid = uuid.uuid4().hex[:12]
            self.sessions[sid] = slot
            return sid

    def feed(self, sid: str, audio, timeout: float = 30.0):
        """Buffer, wake the pump, wait until this slot's whole chunks are
        consumed; returns (new_tokens, text), or None for an unknown
        session."""
        with self.cond:
            slot = self.sessions.get(sid)
            if slot is None:
                return None
            mark = len(self.pool.tokens(slot))
            self.pool.feed(slot, audio)
            self.cond.notify_all()
            self._wait_consumed(slot, timeout)
            toks = self.pool.tokens(slot)
            return toks[mark:], self.tokenizer.decode(toks)

    def text(self, sid: str):
        with self.cond:
            slot = self.sessions.get(sid)
            if slot is None:
                return None
            return self.tokenizer.decode(self.pool.tokens(slot))

    def delete(self, sid: str):
        """Flush the tail, wait for its decode, close the slot."""
        with self.cond:
            slot = self.sessions.pop(sid, None)
            if slot is None:
                return ""
            self.pool.flush(slot)
            self.cond.notify_all()
            self._wait_consumed(slot, 30.0)
            out = self.tokenizer.decode(self.pool.tokens(slot))
            self.pool.close(slot)
            return out

    def stats(self):
        with self.cond:
            return self.pool.stats()


def resample_to_16k(audio: np.ndarray, rate: int) -> np.ndarray:
    """Mic-rate ingest: a polyphase resample with an anti-aliasing filter."""
    if rate == 16000:
        return audio
    from rnnt_tpu_torch.data.augment import _resample

    return _resample(audio, rate / 16000.0)


def make_handler(runtime: ServerRuntime):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path == "/session":
                try:
                    sid = runtime.open()
                except RuntimeError:
                    self._json(503, {"error": "all slots in use"})
                    return
                self._json(200, {"session": sid})
                return
            if self.path.startswith("/feed/"):
                sid = self.path.split("/feed/", 1)[1].split("?")[0]
                n = int(self.headers.get("Content-Length", 0))
                pcm = np.frombuffer(self.rfile.read(n), dtype=np.int16)
                audio = pcm.astype(np.float32) / 32768.0
                rate = int(self.headers.get("X-Sample-Rate", "16000"))
                if "?rate=" in self.path:
                    rate = int(self.path.split("?rate=", 1)[1])
                if rate != 16000:
                    audio = resample_to_16k(audio, rate)
                try:
                    res = runtime.feed(sid, audio)
                except RuntimeError as e:
                    self._json(500, {"error": str(e)})
                    return
                if res is None:
                    self._json(404, {"error": "unknown session"})
                    return
                new, text = res
                self._json(200, {"new_tokens": new, "text": text})
                return
            self._json(404, {"error": "unknown endpoint"})

        def do_GET(self):
            if self.path == "/stats":
                self._json(200, runtime.stats())
                return
            if self.path.startswith("/text/"):
                sid = self.path.split("/text/", 1)[1]
                text = runtime.text(sid)
                if text is None:
                    self._json(404, {"error": "unknown session"})
                    return
                self._json(200, {"text": text})
                return
            self._json(404, {"error": "unknown endpoint"})

        def do_DELETE(self):
            if self.path.startswith("/session/"):
                sid = self.path.split("/session/", 1)[1]
                try:
                    self._json(200, {"text": runtime.delete(sid)})
                except RuntimeError as e:
                    self._json(500, {"error": str(e)})
                return
            self._json(404, {"error": "unknown endpoint"})

        def log_message(self, fmt, *a):  # quiet
            pass

    return Handler


if __name__ == "__main__":
    main()
