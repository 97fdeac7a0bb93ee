"""Train CLI: ``python -m rnnt_tpu_torch.cli.train --config <name or yaml>``.

Port of ``rnnt_tpu/cli/train.py``: ``--resume`` a checkpoint directory,
``--max-steps`` for short runs, ``--output-base`` for the run directories,
``--set key.path=value`` config overrides, and ``--device`` (CUDA unless
``--device cpu``; without CUDA it raises).  Prints the final WER.  TF32 is
off for float32 matmuls and cuDNN convolutions (both flags set, and said
once at start), so fp32 training means fp32.
"""

from __future__ import annotations

import argparse

import torch

from rnnt_tpu_torch.config.config import apply_overrides, load_config, resolve_config
from rnnt_tpu_torch.train.loop import train
from rnnt_tpu_torch.utils import resolve_device


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="base_convjs",
                    help="config name (in rnnt_tpu/config/configs) or path")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--output-base", default="experiments")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY.PATH=VALUE",
                    help="dotted config override, e.g. "
                         "--set training.loss_impl=pruned")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {dev}; TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
          f"torch.backends.cudnn.allow_tf32 = False)")
    cfg = apply_overrides(load_config(resolve_config(args.config)), args.overrides)
    final_wer = train(cfg, output_base=args.output_base, resume=args.resume,
                      max_steps=args.max_steps, device=dev)
    print(f"final wer: {final_wer}")
    return final_wer


if __name__ == "__main__":
    main()
