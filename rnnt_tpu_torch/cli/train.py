"""Train CLI: ``python -m rnnt_tpu_torch.cli.train --config <name or yaml>``.

Port of ``rnnt_tpu/cli/train.py``: ``--resume`` a checkpoint directory,
``--max-steps`` for short runs, ``--output-base`` for the run directories,
``--set key.path=value`` config overrides, ``--profile`` (a torch.profiler
trace of steps 3-6 into ``<run_dir>/trace``), and ``--device`` (CUDA
unless ``--device cpu``; without CUDA it raises).  Prints the final WER.
TF32 is off for float32 matmuls and cuDNN convolutions (both flags set),
so fp32 training means fp32; the start-up line says so, and whether the
host tokenizer encodes in C++ (``rnnt_tpu_torch/native``, built by g++)
or in Python.

Under ``python -m torch.distributed.run --nproc-per-node N -m
rnnt_tpu_torch.cli.train ...`` every rank reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``),
takes its card and joins the process group before training on the
config's ``mesh``:

* ``--device cuda`` means ``cuda:{LOCAL_RANK}``; a rank without that card
  raises;
* ``--dist-backend`` is ``nccl`` on CUDA and ``gloo`` on the CPU by
  default;
* ranks share one card only when asked: ``--device cuda:0 --dist-backend
  gloo`` (NCCL takes one card per rank).
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from rnnt_tpu_torch.config.config import apply_overrides, load_config, resolve_config
from rnnt_tpu_torch.native import load_error, load_native
from rnnt_tpu_torch.train.loop import train
from rnnt_tpu_torch.utils import resolve_device


def rank_device(device: str, local_rank: int, world: int) -> torch.device:
    """This rank's device: ``cuda`` is ``cuda:{local_rank}`` on a
    multi-rank run and must exist; an explicit ``cuda:N`` or ``cpu`` is
    taken as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world > 1:
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {local_rank} wants card {dev} but this machine has "
            f"{torch.cuda.device_count()}; start one rank per card, or share "
            "one card explicitly with --device cuda:0 --dist-backend gloo")
    return dev


def init_distributed(dev: torch.device, backend: str | None, rank: int,
                     world: int) -> str:
    """Join the process group torchrun describes; returns the backend."""
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("--dist-backend nccl needs CUDA devices")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend == "nccl" and local_world > torch.cuda.device_count():
        raise ValueError(f"{local_world} ranks over NCCL need a card each; "
                         "share one card with --dist-backend gloo")
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return backend


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="base_convjs",
                    help="config name (in rnnt_tpu_torch/config/configs) or path")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--output-base", default="experiments")
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of steps 3-6 into "
                         "<run_dir>/trace (gzipped Chrome trace, one file a rank)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY.PATH=VALUE",
                    help="dotted config override, e.g. "
                         "--set training.loss_impl=pruned")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; cuda:LOCAL_RANK under torchrun), "
                         "cuda:N or cpu; no fallback")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend under torchrun: nccl on CUDA "
                         "and gloo on the CPU by default")
    args = ap.parse_args(argv)
    rank, world = int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
    dev = rank_device(args.device, int(os.environ.get("LOCAL_RANK", "0")), world)
    if dev.index is not None:  # this rank's card becomes its current device
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = apply_overrides(load_config(resolve_config(args.config)), args.overrides)
    backend = init_distributed(dev, args.dist_backend, rank, world) if world > 1 else None
    try:
        if rank == 0:
            tokenizer = ("native C++" if load_native() is not None
                         else f"Python (no native library: {load_error()})")
            print(f"device {dev}" + (f" (rank 0 of {world}, {backend})" if backend else "")
                  + "; TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
                  f"torch.backends.cudnn.allow_tf32 = False); host tokenizer {tokenizer}")
        final_wer = train(cfg, output_base=args.output_base, resume=args.resume,
                          max_steps=args.max_steps, device=dev, profile=args.profile)
    finally:
        if backend is not None:
            dist.destroy_process_group()
    if rank == 0:
        print(f"final wer: {final_wer}")
    return final_wer


if __name__ == "__main__":
    main()
