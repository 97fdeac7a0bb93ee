"""Import a reference PyTorch checkpoint into the port:
``python -m rnnt_tpu_torch.cli.import_torch checkpoint_step_N.pt out/ --config base_convjs``.

Port of ``rnnt_tpu/cli/import_torch.py``.  A reference ``checkpoint_step_N.pt``
(``{"model_state_dict": ..., "completed_steps": N}`` or a bare state dict)
becomes ``out/checkpoint_step_<step>`` in the port's training format
(``train/checkpoint.py``: ``config.yaml``, ``params.npz``, ``opt_state.npz``),
which ``cli.eval``, ``cli.infer``, ``cli.serve``, ``cli.export`` and
``cli.train --resume`` read as it is::

    python -m rnnt_tpu_torch.cli.import_torch ckpt.pt out/ --config base_convjs
    python -m rnnt_tpu_torch.cli.eval out/checkpoint_step_<N>

The step is the checkpoint's ``completed_steps`` (0 when absent) unless
``--step`` is given; a resumed run counts on from it.  The optimizer state
is a fresh AdamW state (count 0), as in the JAX package.  Under
``loss_impl: pruned`` the pruned loss's simple heads, which the reference
has not, are drawn fresh by the port's own ``Joint`` init from
``torch.Generator().manual_seed(0)``; the JAX package draws them from
``PRNGKey(0)``, which the port cannot repeat bit for bit.  They feed only
the loss, never decoding.  The file is read with
``torch.load(weights_only=True)``.  Runs on CUDA unless ``--device cpu``;
without CUDA it raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from rnnt_tpu_torch.compat.jax_params import flatten_tree, from_flat, module_tree
from rnnt_tpu_torch.compat.torch_import import import_reference_state_dict
from rnnt_tpu_torch.config.config import (
    Config, apply_overrides, build_model_spec, load_config, resolve_config)
from rnnt_tpu_torch.models.joint import Joint
from rnnt_tpu_torch.train import checkpoint as ckpt
from rnnt_tpu_torch.train.optim import make_optimizer
from rnnt_tpu_torch.train.step import TrainState
from rnnt_tpu_torch.utils import resolve_device


def fresh_simple_heads(spec, seed: int = 0) -> dict:
    """The pruned loss's simple heads of a freshly initialised joint, as
    flat ``joint/simple/...`` leaves."""
    joint = Joint(spec.joint, torch.Generator().manual_seed(seed), simple=True)
    return {f"joint/simple/{k}": v
            for k, v in flatten_tree(module_tree(joint.simple)).items()}


def import_to_checkpoint(pt_path: str | Path, out_dir: str | Path, cfg: Config,
                         step: int | None = None, device="cuda") -> Path:
    """The CLI's work, callable from tests: returns the checkpoint directory."""
    dev = resolve_device(device)
    spec = build_model_spec(cfg)
    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    if step is None:
        step = int(sd.get("completed_steps", 0))
    params, state = import_reference_state_dict(sd, spec)
    if spec.loss_impl == "pruned" and not any(k.startswith("joint/simple/") for k in params):
        params.update(fresh_simple_heads(spec))
        print("note: initialized fresh pruned-loss simple heads (absent from the "
              "reference checkpoint)")
    model = from_flat(params, state, spec).to(dev)
    tc = cfg.training
    optimizer, _ = make_optimizer(tc, total_steps=max(tc.total_steps or 10000, 1))
    opt_state = optimizer.init(dict(model.named_parameters()))
    return ckpt.save(out_dir, TrainState(model, opt_state, step), cfg)


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pt", help="reference checkpoint_step_N.pt")
    ap.add_argument("out", help="output checkpoint base directory")
    ap.add_argument("--config", default="base_convjs",
                    help="config name (in rnnt_tpu_torch/config/configs) or yaml "
                         "path describing the model")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--step", type=int, default=None,
                    help="the imported checkpoint's step (default: the .pt's "
                         "completed_steps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    cfg = apply_overrides(load_config(resolve_config(args.config)), args.overrides)
    out = import_to_checkpoint(args.pt, args.out, cfg, step=args.step, device=args.device)
    print(f"imported {args.pt} -> {out}")
    print(f"eval with: python -m rnnt_tpu_torch.cli.eval {out}")
    return out


if __name__ == "__main__":
    main()
