"""Export CLI: ``python -m rnnt_tpu_torch.cli.export <checkpoint_dir> [--out dir]``.

Port of ``rnnt_tpu/cli/export.py``.  It writes a self-contained serving
bundle: five graphs, each traced with ``torch.export.export`` at a fixed
example shape and saved with ``torch.export.save`` as ``<name>.pt2``, all
float32, in eval mode:

* ``encoder``: features (1, 64, bins) -> encoder frames;
* ``encoder_streaming``: a chunk of ``--frames`` feature frames and the
  carries of every causal conv as numbered ports, in the order and shapes
  of ``encoder_streaming_init_state`` -> (frames, carries...);
* ``predictor``: a token window of ``max(--pred-tokens, receptive field)``
  ids (int64) -> predictor features;
* ``joint``: ``joint_single`` on (1, H) and (1, P) -> (1, V) logits;
* ``featurize``: a waveform chunk of ``frames * hop + overlap`` samples ->
  (1, frames, bins) (the streaming featurizer's contract).

Beside them ``tokenizer.json`` (id -> piece), ``encoder_streaming_states.json``
(the carries' count and shapes) and ``manifest.json`` carry the JAX
package's fields and values.  Tracing runs on ``--device`` (CUDA unless
``--device cpu``; without CUDA it raises); each graph is moved to the CPU
(``torch.export.passes.move_to_device_pass``) before it is saved, so a
bundle written on a card loads on any machine (``runtime/bundle.py``
moves it to its own device).  The port's hand-written kernels are ctypes
launches that ``torch.export`` cannot trace, and none lies on these five
graphs: they hold the plain modules.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from rnnt_tpu_torch.compat.jax_params import find_config, load_checkpoint
from rnnt_tpu_torch.config.config import (
    apply_overrides, build_featurizer_spec, build_model_spec, load_config)
from rnnt_tpu_torch.models.encoder import encoder_streaming_init_state
from rnnt_tpu_torch.models.joint import joint_single
from rnnt_tpu_torch.models.predictor import predictor_apply
from rnnt_tpu_torch.models.rnnt import refuse_unsupported
from rnnt_tpu_torch.ops.stft import make_featurizer
from rnnt_tpu_torch.train.loop import _load_tokenizer
from rnnt_tpu_torch.utils import resolve_device

GRAPHS = ("featurize", "encoder", "encoder_streaming", "predictor", "joint")


class _Graph(nn.Module):
    """``fn(*inputs)`` (a plain function) as a module that owns ``parts``,
    the modules whose parameters and buffers ``fn`` reads."""

    def __init__(self, fn, **parts):
        super().__init__()
        self.fn = fn
        self.parts = nn.ModuleDict(parts)

    def forward(self, *inputs):
        return self.fn(*inputs)


def graphs(model, fspec, frames: int, pred_tokens: int, device) -> dict:
    """{name: (module, example inputs)} of the five graphs on ``device``."""
    spec = model.spec
    enc = model.encoder
    states = encoder_streaming_init_state(1, spec.encoder, device=device)
    featurize = make_featurizer(fspec)
    chunk = torch.zeros((1, frames * fspec.hop_length + fspec.overlap), device=device)
    featurize(chunk)  # build its constants on the device before tracing

    def streaming(x, *carries):
        y, new = enc.streaming(x, carries)
        return (y, *new)

    bins = fspec.num_bins
    return {
        "featurize": (_Graph(featurize), (chunk,)),
        "encoder": (_Graph(lambda x: enc(x), encoder=enc),
                    (torch.zeros((1, 64, bins), device=device),)),
        "encoder_streaming": (_Graph(streaming, encoder=enc),
                              (torch.zeros((1, frames, bins), device=device), *states)),
        "predictor": (_Graph(lambda t: predictor_apply(model.predictor, t),
                             predictor=model.predictor),
                      (torch.zeros((1, pred_tokens), dtype=torch.long, device=device),)),
        "joint": (_Graph(lambda a, t: joint_single(model.joint, a, t), joint=model.joint),
                  (torch.zeros((1, spec.encoder.output_features), device=device),
                   torch.zeros((1, spec.predictor.output_dim), device=device))),
    }


def export_graph(module: nn.Module, inputs: tuple, path: Path) -> int:
    """Trace, move to the CPU, save; returns the file's size in bytes."""
    with torch.no_grad():
        program = torch.export.export(module, inputs)
    torch.export.save(move_to_device_pass(program, "cpu"), path)
    return path.stat().st_size


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="checkpoint directory")
    ap.add_argument("--config", default=None,
                    help="config yaml (default: next to checkpoint)")
    ap.add_argument("--out", default=None, help="output dir (default: <checkpoint>/export)")
    ap.add_argument("--frames", type=int, default=8,
                    help="streaming chunk length in feature frames")
    ap.add_argument("--pred-tokens", type=int, default=16,
                    help="predictor graph token-window length (raised to the conv "
                         "predictor's receptive field, which exact sliding-window "
                         "decode needs)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="where to trace: cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = apply_overrides(load_config(args.config or find_config(args.checkpoint)),
                          args.overrides)
    spec = build_model_spec(cfg)
    refuse_unsupported(spec, "cli.export (bundles)")
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    model = load_checkpoint(args.checkpoint, spec, dev)
    out_dir = Path(args.out or Path(args.checkpoint) / "export")
    out_dir.mkdir(parents=True, exist_ok=True)

    window = getattr(spec.predictor, "receptive_field", 0)
    pred_tokens = max(args.pred_tokens, window)
    built = graphs(model, fspec, args.frames, pred_tokens, dev)
    for name in GRAPHS:
        module, inputs = built[name]
        size = export_graph(module, inputs, out_dir / f"{name}.pt2")
        print(f"  {name}.pt2 ({size:,} bytes)")

    shapes = [list(s.shape) for s in built["encoder_streaming"][1][1:]]
    (out_dir / "encoder_streaming_states.json").write_text(
        json.dumps({"num_states": len(shapes), "shapes": shapes}))
    (out_dir / "tokenizer.json").write_text(
        json.dumps({str(k): v for k, v in tokenizer.piece_table().items()}))
    print(f"  tokenizer.json ({tokenizer.vocab_size()} pieces)")
    (out_dir / "manifest.json").write_text(json.dumps({
        "sample_rate": fspec.sample_rate,
        "chunk_samples": args.frames * fspec.hop_length + fspec.overlap,
        "chunk_frames": args.frames,
        "hop_length": fspec.hop_length,
        "win_length": fspec.win_length,
        "overlap": fspec.overlap,
        "num_bins": fspec.num_bins,
        "blank_idx": spec.blank_idx,
        "num_classes": spec.joint.num_classes,
        "predictor_window": window,
        "predictor_tokens": pred_tokens,
        "graphs": list(GRAPHS),
    }, indent=2))
    print(f"export complete: {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
