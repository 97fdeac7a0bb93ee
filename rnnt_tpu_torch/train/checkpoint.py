"""Training checkpoints in the port's own format.

Port of ``rnnt_tpu/train/checkpoint.py``'s layout (``experiments/<model>/
run-N/checkpoint_step_N``, ``config.yaml`` beside the checkpoints) with its
own files in place of orbax: a checkpoint directory holds

* ``config.yaml`` and ``params.npz`` (compat/jax_params.py), so
  ``python -m rnnt_tpu_torch.cli.eval <dir>`` reads it as it is;
* ``opt_state.npz``: the step, the optimizer's count and its ``mu`` / ``nu``
  (and accumulation) leaves under ``/``-joined JAX paths.

Saves are synchronous.  ``restore`` resumes the model (weights and
batch-norm statistics), the optimizer state and the step.  Both take the
whole model: on a multi-rank run the loop saves on rank 0 only, after
gathering every tensor-parallel shard of the parameters and the moments
over the model group (``parallel/mesh.whole_model``), and every rank
restores the whole model before cutting it to its shards.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rnnt_tpu_torch.compat.jax_params import (
    PARAMS_FILE,
    find_config,
    flatten_tree,
    load_flat,
    opt_state_from_jax,
    opt_state_to_jax,
    save_checkpoint as save_params,
)
from rnnt_tpu_torch.config.config import Config, save_config

OPT_FILE = "opt_state.npz"

__all__ = ["checkpoint_dir", "find_config", "latest_checkpoint",
           "next_run_dir", "restore", "save", "write_opt_state"]


def checkpoint_dir(output_dir: str | Path, step: int) -> Path:
    return Path(output_dir) / f"checkpoint_step_{step}"


def next_run_dir(base: str | Path, model_name: str) -> Path:
    """``<base>/<model_name>/run-N``, N one past the highest existing."""
    root = Path(base) / model_name
    root.mkdir(parents=True, exist_ok=True)
    nums = [int(d.name.split("-")[-1]) for d in root.iterdir()
            if d.is_dir() and d.name.startswith("run-")
            and d.name.split("-")[-1].isdigit()]
    out = root / f"run-{max(nums) + 1 if nums else 1}"
    out.mkdir(parents=True, exist_ok=True)
    return out


def latest_checkpoint(output_dir: str | Path) -> Path | None:
    ckpts = sorted(Path(output_dir).glob("checkpoint_step_*"),
                   key=lambda p: int(p.name.rsplit("_", 1)[1]))
    return ckpts[-1] if ckpts else None


def save(output_dir: str | Path, state, cfg: Config) -> Path:
    """Write ``checkpoint_step_<step>`` for a TrainState, and config.yaml
    beside it in the run directory."""
    path = checkpoint_dir(output_dir, state.step)
    save_params(path, cfg, state.model)
    write_opt_state(path, state.opt_state, state.step)
    save_config(cfg, Path(output_dir) / "config.yaml")
    return path


def write_opt_state(path: str | Path, opt_state, step: int) -> None:
    """``opt_state.npz`` of a checkpoint directory: the step and the
    optimizer state's leaves under their JAX paths."""
    opt = flatten_tree(opt_state_to_jax(opt_state))
    opt["step"] = np.int64(step)
    np.savez(Path(path) / OPT_FILE, **opt)


def restore(path: str | Path, model) -> tuple:
    """Load a checkpoint into ``model`` (in place, on its device); return
    (OptState, step)."""
    path = Path(path)
    with np.load(path / PARAMS_FILE) as z:
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
        state = {k[len("state/"):]: z[k] for k in z.files
                 if k.startswith("state/")}
    device = next(model.parameters()).device
    load_flat(model, params, state)
    model.to(device)
    with np.load(path / OPT_FILE) as z:
        tree = {k: z[k] for k in z.files}

    def sub(prefix):
        return {k[len(prefix) + 1:]: v for k, v in tree.items()
                if k.startswith(prefix + "/")}

    acc = sub("acc")
    opt_state = opt_state_from_jax(
        tree["count"], sub("mu"), sub("nu"), model,
        mini_step=int(tree.get("mini_step", 0)), acc=acc or None)
    return opt_state, int(tree["step"])
