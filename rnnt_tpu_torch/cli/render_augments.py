"""Augmentation listening page:
``python -m rnnt_tpu_torch.cli.render_augments [--wav in.wav] [--out dir]``.

Port of ``rnnt_tpu/cli/render_augments.py``: each of fourteen host
augmentations (``data/augment.py``) at p = 1 on a source clip (a 16-bit
WAV read by ``cli/infer.read_wav``, or a 3 s amplitude-modulated 220 Hz
tone), written as 16-bit WAV files beside ``original.wav``, with an
``index.html`` that plays them.  Host only, as the JAX package's: no
device is used.
"""

from __future__ import annotations

import argparse
import html
import wave
from pathlib import Path

import numpy as np

from rnnt_tpu_torch.cli.infer import read_wav
from rnnt_tpu_torch.data.augment import (
    REFERENCE_CHORUS_FILTERS,
    REFERENCE_COMPRESSOR_FILTERS,
    ATempo,
    Augmentor,
    ChooseAFilter,
    PeakLevel,
    PitchShift,
    ShapedNoise,
    Tempo,
    Trim,
    WhiteNoise,
    augmentation_from_filter_string,
)

AUGS = [
    ("atempo_fast", ATempo(1.0, 1.2, 1.25)),
    ("atempo_slow", ATempo(1.0, 0.75, 0.8)),
    ("tempo_fast_resample", Tempo(1.0, 1.2, 1.25)),
    ("tempo_slow_resample", Tempo(1.0, 0.75, 0.8)),
    ("pitch_up", PitchShift(1.0, 3, 3)),
    ("pitch_down", PitchShift(1.0, -3, -3)),
    ("trim", Trim(1.0, 0.02)),
    ("peak_level", PeakLevel(1.0, 0.5, 0.6)),
    ("white_noise", WhiteNoise(1.0, 0.05, 0.05)),
    ("shaped_noise", ShapedNoise(1.0, 0.05, 0.05)),
    ("chorus_any", ChooseAFilter(1.0, REFERENCE_CHORUS_FILTERS)),
    ("compressor_any", ChooseAFilter(1.0, REFERENCE_COMPRESSOR_FILTERS)),
    ("chorus_0", augmentation_from_filter_string(REFERENCE_CHORUS_FILTERS[0])),
    ("compressor_aggressive",
     augmentation_from_filter_string(REFERENCE_COMPRESSOR_FILTERS[2])),
]


def write_wav(path: Path, audio: np.ndarray, sr: int = 16000) -> None:
    """Mono 16-bit PCM, samples clipped to [-1, 1] and scaled by 32767."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
        w.writeframes(pcm.tobytes())


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--wav", default=None, help="source clip (default: tone)")
    ap.add_argument("--out", default="augment_renders")
    args = ap.parse_args(argv)

    sr = 16000
    if args.wav:
        audio, sr = read_wav(args.wav)
    else:
        t = np.arange(sr * 3) / sr
        audio = (0.4 * np.sin(2 * np.pi * 220 * t)
                 * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))).astype(np.float32)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    write_wav(out / "original.wav", audio, sr)
    rows = ['<tr><td>original</td><td><audio controls src="original.wav">'
            "</audio></td></tr>"]
    for name, aug in AUGS:
        rendered = Augmentor([aug], seed=0)(audio.copy(), sr)
        write_wav(out / f"{name}.wav", rendered, sr)
        rows.append(f'<tr><td>{html.escape(name)}</td>'
                    f'<td><audio controls src="{name}.wav"></audio></td>'
                    f"<td>{len(rendered) / sr:.2f}s</td></tr>")
        print(f"  {name}: {len(rendered) / sr:.2f}s")
    (out / "index.html").write_text(
        "<html><body><h1>rnnt_tpu_torch augmentation renders</h1>"
        "<table border=1>" + "".join(rows) + "</table></body></html>")
    print(f"rendered {len(AUGS)} augmentations to {out}/index.html")
    return out


if __name__ == "__main__":
    main()
