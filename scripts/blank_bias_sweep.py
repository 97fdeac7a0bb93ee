#!/usr/bin/env python3
"""Greedy token counts of chip_smoke.py's untrained full-width models over a
ladder of blank biases: where each model goes from emitting at the
per-frame cap to emitting nothing, which is where chip_smoke's decode
checks (``DECODE_BIAS``), its streamed-against-offline cases
(``STREAM_CASES``) and its LSTM stream case (``LSTM_STREAM_BIAS``) must sit
to compare non-empty, unclipped token lists.

    python3 scripts/blank_bias_sweep.py [--device cuda]

* ``base_convjs`` at ``bench.py`` ``bench_beam``'s batch (16 x 10 s, the
  eval forward at the config's precision), the first 4 utterances: greedy
  and width-4 beam counts, buffer 200;
* ``base_convjs_fullcausal`` and ``base_sp_lstm`` with chip_smoke's stream
  overrides, random batch-norm statistics in [0.5, 1.5], the stream
  check's 10 s wave: offline greedy counts over the whole utterance.

Random weights from seed 0, as chip_smoke draws them; fp32 matmuls and
convolutions without TF32.  Prints one line a model and bias.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BIASES = (0.0, 0.25, 0.5, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0)


def main() -> None:
    import chip_smoke as cs
    from rnnt_tpu_torch.decode.beam import beam_decode
    from rnnt_tpu_torch.decode.greedy import greedy_decode
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.ops.stft import make_featurizer
    from rnnt_tpu_torch.train.step import make_eval_forward
    from rnnt_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        tmp = Path(tmp)
        cfg, spec, fspec = cs.serve_cfg(tmp, "base_convjs")
        model = rnnt_init(spec, seed=0, device=dev)
        audio, t_lens = make_eval_forward(spec, fspec, cfg.training.precision)(
            model, cs.bench_beam_audio(fspec, dev, 16, 10.0))
        audio, t_lens = audio[:4], t_lens[:4]
        args = (model.predictor, model.joint, audio, t_lens, spec.predictor, spec.joint)
        for bias in BIASES:
            with cs.blank_bias(model, bias):
                _, n = greedy_decode(*args, max_tokens=200)
                _, n4, _ = beam_decode(*args, beam_width=4, max_tokens=200)
            print(f"base_convjs bench_beam x4, blank bias {bias:g}: greedy {n.tolist()}, "
                  f"width 4 {n4.tolist()}", flush=True)
        del model

        for config, overrides in (("base_convjs_fullcausal", ()),
                                  (cs.LSTM_CONFIG, cs.LSTM_STREAM_OVERRIDES)):
            _, spec, fspec = cs.serve_cfg(tmp, config, overrides)
            model = rnnt_init(spec, seed=0, device=dev)
            g = torch.Generator().manual_seed(5)  # stream_offline_check's statistics
            for buf in model.buffers():
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            n = int(10.0 * fspec.sample_rate)
            wave = (np.random.RandomState(0).randn(n).astype(np.float32) * 0.2
                    + np.sin(2 * np.pi * 500 * np.arange(n) / fspec.sample_rate)
                    .astype(np.float32) * 0.3)
            enc = model.encoder(make_featurizer(fspec)(torch.from_numpy(wave).to(dev))[None])
            frames = torch.tensor([enc.shape[1]], device=dev)
            for bias in BIASES:
                with cs.blank_bias(model, bias):
                    _, c = greedy_decode(model.predictor, model.joint, enc, frames,
                                         spec.predictor, spec.joint, max_tokens=3200)
                print(f"{config} stream wave ({enc.shape[1]} frames), blank bias {bias:g}: "
                      f"greedy {int(c[0])}", flush=True)
            del model


if __name__ == "__main__":
    main()
