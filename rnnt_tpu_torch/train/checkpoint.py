"""Training checkpoints in the port's own format.

Port of ``rnnt_tpu/train/checkpoint.py``'s layout (``experiments/<model>/
run-N/checkpoint_step_N``, ``config.yaml`` beside the checkpoints) with its
own files in place of orbax: a checkpoint directory holds

* ``config.yaml`` and ``params.npz`` (compat/jax_params.py), so
  ``python -m rnnt_tpu_torch.cli.eval <dir>`` reads it as it is;
* ``opt_state.npz``: the step, the optimizer's count and its ``mu`` / ``nu``
  (and accumulation) leaves under ``/``-joined JAX paths.

Saves can be asynchronous, as the JAX package's are
(``rnnt_tpu/train/checkpoint.py``): ``save(..., wait=False)`` copies the
step's tensors to host memory before it returns, so the train step may
update them at once, and writes the files on a background thread; at
most one save is in flight (a second waits for the first), and
``wait_for_checkpoints()`` waits for it and raises what it raised.  A save
writes into ``.writing_step_<step>``, a name ``latest_checkpoint``'s
``checkpoint_step_*`` never matches, and renames it when complete.
``restore`` waits for pending saves first, then resumes the model
(weights and batch-norm statistics), the optimizer state and the step.
Both take the whole model: on a multi-rank run the loop saves on rank 0
only, after gathering every tensor-parallel shard of the parameters and
the moments over the model group (``parallel/mesh.whole_model``; the
gather stays synchronous, only rank 0's disk writes go to the thread),
and every rank restores the whole model before cutting it to its shards.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from rnnt_tpu_torch.compat.jax_params import (
    PARAMS_FILE,
    find_config,
    flatten_tree,
    load_flat,
    opt_state_from_jax,
    opt_state_to_jax,
    to_jax,
    write_checkpoint,
)
from rnnt_tpu_torch.config.config import Config, save_config

OPT_FILE = "opt_state.npz"

__all__ = ["checkpoint_dir", "find_config", "latest_checkpoint",
           "next_run_dir", "restore", "save", "wait_for_checkpoints",
           "write_opt_state"]

_WRITER: ThreadPoolExecutor | None = None
_PENDING: Future | None = None


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
    ckpts = sorted((p for p in Path(output_dir).glob("checkpoint_step_*")
                    if p.name.rsplit("_", 1)[1].isdigit()),
                   key=lambda p: int(p.name.rsplit("_", 1)[1]))
    return ckpts[-1] if ckpts else None


def wait_for_checkpoints() -> None:
    """Block until the save in flight (if any) is on disk; re-raise its
    error."""
    global _PENDING
    pending, _PENDING = _PENDING, None
    if pending is not None:
        pending.result()


def _host_copy(tree, copy: bool) -> dict:
    """The leaves of a numpy pytree, flattened, copied when they may share
    memory with the model's tensors (those of a CPU model do)."""
    return {k: np.array(v) if copy else v for k, v in flatten_tree(tree).items()}


def save(output_dir: str | Path, state, cfg: Config, *, wait: bool = True) -> Path:
    """Write ``checkpoint_step_<step>`` for a TrainState, and config.yaml
    beside it in the run directory.  With ``wait=False`` the files are
    written on a background thread once the tensors are in host memory
    (``wait_for_checkpoints``)."""
    global _WRITER, _PENDING
    wait_for_checkpoints()
    copy = next(state.model.parameters()).device.type == "cpu"
    params, model_state = to_jax(state.model)
    arrays = dict(params=_host_copy(params, copy), state=_host_copy(model_state, copy),
                  opt=_host_copy(opt_state_to_jax(state.opt_state), copy))
    path = checkpoint_dir(output_dir, state.step)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_config(cfg, path.parent / "config.yaml")
    if wait:
        _write(path, cfg, state.step, arrays)
        return path
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
    _PENDING = _WRITER.submit(_write, path, cfg, state.step, arrays)
    return path


def _write(path: Path, cfg: Config, step: int, arrays: dict) -> None:
    """The checkpoint's files under a temporary name, then the rename."""
    tmp = path.with_name(f".writing_step_{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    write_checkpoint(tmp, cfg, arrays["params"], arrays["state"])
    np.savez(tmp / OPT_FILE, **arrays["opt"], step=np.int64(step))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def write_opt_state(path: str | Path, opt_state, step: int) -> None:
    """``opt_state.npz`` of a checkpoint directory: the step and the
    optimizer state's leaves under their JAX paths."""
    np.savez(Path(path) / OPT_FILE, **flatten_tree(opt_state_to_jax(opt_state)),
             step=np.int64(step))


def restore(path: str | Path, model) -> tuple:
    """Load a checkpoint into ``model`` (in place, on its device); return
    (OptState, step).  Waits for a save in flight first."""
    wait_for_checkpoints()
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
