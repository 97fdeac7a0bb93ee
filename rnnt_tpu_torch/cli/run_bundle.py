"""Transcribe WAV files with only an export bundle:
``python -m rnnt_tpu_torch.cli.run_bundle <bundle_dir> file.wav [...]``.

Port of ``rnnt_tpu/cli/run_bundle.py``: the bundle's counterpart of
``cli/infer``, driving the ``torch.export`` graphs and manifest through
``runtime/bundle.py``; it imports nothing of the port's ``models``,
``train``, ``decode`` or ``ops``.  A WAV must be 16-bit mono at 16 kHz
(``ValueError`` otherwise).  ``--streaming-chunks SECONDS`` feeds each
file in pieces and prints every piece's new tokens as a ``+...``
increment, the tail's from ``flush`` included (the JAX CLI never prints
the flush's, ``rnnt_tpu/cli/run_bundle.py:58``).  Decoding a file stops
at ``--max-tokens`` (default 512, the JAX CLI's fixed cap).  After each
file's text and tokens it prints the audio-seconds decoded per second of
the file's decode (the bundle's load not counted).  Runs on CUDA unless
``--device cpu``; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import time
import wave

import numpy as np

from rnnt_tpu_torch.runtime.bundle import BundleRuntime


def read_wav(path: str) -> np.ndarray:
    """A 16-bit mono 16 kHz WAV file as float32 samples in [-1, 1)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit samples, got "
                             f"{8 * w.getsampwidth()}-bit")
        if w.getnchannels() != 1:
            raise ValueError(f"{path}: expected mono audio, got {w.getnchannels()} channels")
        if w.getframerate() != 16000:
            raise ValueError(f"{path}: expected 16000 Hz input, got {w.getframerate()}")
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    return pcm.astype(np.float32) / 32768.0


def main(argv=None) -> list[tuple[str, list[int], str]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bundle", help="directory written by cli/export")
    ap.add_argument("wavs", nargs="+", help="16 kHz mono 16-bit WAV files")
    ap.add_argument("--streaming-chunks", type=float, default=0.0, metavar="SECONDS",
                    help="feed each file in SECONDS-long pieces and print the "
                         "increments (0 = offline, in one piece)")
    ap.add_argument("--max-tokens", type=int, default=512,
                    help="stop decoding a file after this many tokens (default 512, "
                         "the JAX CLI's fixed cap)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)

    rt = BundleRuntime(args.bundle, args.device)
    results = []
    for path in args.wavs:
        wav = read_wav(path)
        t0 = time.perf_counter()
        if args.streaming_chunks > 0:
            stream = rt.open_stream(max_tokens=args.max_tokens)
            step = int(args.streaming_chunks * rt.manifest["sample_rate"])

            def show(new):
                if new:
                    print(f"  +{rt.detokenize(new)}")

            for pos in range(0, len(wav), step):
                show(stream.feed(wav[pos:pos + step]))
            show(stream.flush())
            tokens, text = list(stream.tokens), stream.text()
        else:
            tokens, text = rt.transcribe(wav, max_tokens=args.max_tokens)
        dt = time.perf_counter() - t0
        audio_s = len(wav) / rt.manifest["sample_rate"]
        print(f"{path}: {text}")
        print(f"  tokens: {tokens}")
        print(f"  {audio_s / dt:.2f} audio-s/s ({audio_s:.2f} s of audio in {dt:.3f} s)")
        results.append((path, tokens, text))
    return results


if __name__ == "__main__":
    main()
