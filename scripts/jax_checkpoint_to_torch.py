#!/usr/bin/env python3
"""Convert a checkpoint the JAX package trained (orbax) into the port's
checkpoint format.

    python scripts/jax_checkpoint_to_torch.py \\
        experiments/base_convjs/run-1/checkpoint_step_5000 converted/
    python -m rnnt_tpu_torch.cli.eval converted/checkpoint_step_5000
    python -m rnnt_tpu_torch.cli.train --config converted/config.yaml \\
        --resume converted/checkpoint_step_5000

The checkpoint is restored with ``rnnt_tpu.train.checkpoint.restore_checkpoint``
(host arrays, no template) and written as ``<out>/checkpoint_step_<step>``:
``config.yaml`` and ``params.npz`` (the parameters and batch-norm
statistics, ``compat/jax_params.write_checkpoint``) and ``opt_state.npz``
(the step and the AdamW count, ``mu`` and ``nu`` of the ``optax.chain
(clip_by_global_norm, adamw)`` state, plus ``MultiSteps``' position and
accumulated gradients when the run accumulated; ``opt_state_from_jax``),
with ``config.yaml`` also beside it, as ``cli.train`` lays a run out.  The
config is the one beside the JAX checkpoint unless ``--config`` names one.

It needs JAX and orbax, so it lives outside both packages: the port never
imports it.  JAX runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def adam_state(tree):
    """(count, mu, nu, mini_step, acc) of a restored optax state: the
    adam leaf is the dict with ``count``, ``mu`` and ``nu``; a
    ``MultiSteps`` state around it adds ``mini_step`` and ``acc_grads``."""
    mini_step, acc = 0, None
    if isinstance(tree, dict) and "inner_opt_state" in tree:
        mini_step, acc = int(np.asarray(tree["mini_step"])), tree["acc_grads"]
        tree = tree["inner_opt_state"]
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict) and {"count", "mu", "nu"} <= set(node):
            return node["count"], node["mu"], node["nu"], mini_step, acc
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    raise ValueError("no adam state (count, mu, nu) in the checkpoint's opt_state")


def convert(jax_checkpoint: str | Path, out: str | Path,
            config: str | Path | None = None) -> Path:
    """Write the port's checkpoint of ``jax_checkpoint`` under ``out``;
    returns its directory."""
    import jax

    from rnnt_tpu.train import checkpoint as jckpt
    from rnnt_tpu_torch.compat.jax_params import (
        load_checkpoint, opt_state_from_jax, write_checkpoint)
    from rnnt_tpu_torch.config.config import build_model_spec, load_config, save_config
    from rnnt_tpu_torch.train import checkpoint as tckpt

    cfg = load_config(config or jckpt.find_config(jax_checkpoint))
    restored = jckpt.restore_checkpoint(jax_checkpoint)
    host = jax.tree.map(np.asarray, restored)
    step = int(host["step"])
    path = tckpt.checkpoint_dir(out, step)
    write_checkpoint(path, cfg, host["params"], host["model_state"])
    model = load_checkpoint(path, build_model_spec(cfg), "cpu")
    count, mu, nu, mini_step, acc = adam_state(host["opt_state"])
    opt_state = opt_state_from_jax(count, mu, nu, model, mini_step=mini_step, acc=acc)
    tckpt.write_opt_state(path, opt_state, step)
    save_config(cfg, Path(out) / "config.yaml")
    return path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="the JAX package's checkpoint_step_N directory")
    ap.add_argument("out", help="output base directory")
    ap.add_argument("--config", default=None,
                    help="config yaml (default: beside the checkpoint)")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    path = convert(args.checkpoint, args.out, args.config)
    print(f"converted {args.checkpoint} -> {path}")
    return path


if __name__ == "__main__":
    main()
