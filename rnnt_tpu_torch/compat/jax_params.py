"""Weights across the two packages, and the port's checkpoint directory.

The port's modules name their parameters after the JAX params pytree and
keep its layouts (conv weights (K, Cin, Cout), linear weights (in, out)),
so a pytree path ``encoder/blocks/0/convs/1/w`` is the state-dict key
``encoder.blocks.0.convs.1.w``.  The only renaming is batch-norm state:
JAX keeps the prologue's and epilogue's running stats at
``encoder/prologue/mean`` where the module has ``encoder.prologue.norm.mean``.

* ``from_jax(params, state, spec)`` — JAX ``rnnt_init`` pytrees (nested
  dicts and lists of numpy arrays) to an ``RNNT`` with identical weights.
* ``to_jax(model)`` — the inverse: (params, state) pytrees of numpy arrays
  with the JAX structure, empty dicts included.
* ``save_checkpoint`` / ``load_checkpoint`` — a directory with
  ``config.yaml`` and ``params.npz``; the npz holds the pytree leaves
  under ``params/...`` and ``state/...`` ``/``-joined paths in JAX layout,
  so either package's arrays can be written into it.
* ``opt_state_from_jax`` / ``opt_state_to_jax`` — the state of
  ``optax.chain(clip_by_global_norm, adamw)`` (its count and the ``mu`` and
  ``nu`` pytrees, numpy leaves in the params' structure) to the port's
  ``OptState`` and back, so a run started in JAX continues in the port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.config.config import Config, save_config
from rnnt_tpu_torch.models.rnnt import RNNT, RNNTSpec

PARAMS_FILE = "params.npz"
CONFIG_FILE = "config.yaml"


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists -> {"a/0/b": leaf}.  Empty containers vanish."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: dict):
    """{"a/0/b": leaf} -> nested dicts, with lists where every key of a
    level is an index (the inverse of ``flatten_tree`` up to empty
    containers)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def opt_state_from_jax(count, mu, nu, model: nn.Module, *, mini_step: int = 0,
                       acc=None):
    """The port's ``OptState`` for ``model`` from optax's adam count and
    ``mu`` / ``nu`` pytrees (``acc``: MultiSteps' accumulated gradients)."""
    from rnnt_tpu_torch.train.optim import OptState

    names = dict(model.named_parameters())

    def tensors(tree):
        flat = flatten_tree(tree)
        if set(k.replace("/", ".") for k in flat) != set(names):
            raise KeyError("optimizer pytree does not match the model's "
                           "parameters")
        return {k.replace("/", "."): torch.tensor(np.asarray(v, np.float32),
                                                  device=names[k.replace("/", ".")].device)
                for k, v in flat.items()}

    return OptState(int(np.asarray(count)), tensors(mu), tensors(nu),
                    int(mini_step), tensors(acc) if acc is not None else {})


def opt_state_to_jax(opt_state) -> dict:
    """{"count", "mu", "nu"} (and "mini_step", "acc" when accumulating)
    with numpy pytrees in the JAX params' structure."""
    def tree(d):
        return unflatten_tree({k.replace(".", "/"): v.detach().cpu().numpy()
                               for k, v in d.items()})

    out = {"count": np.int32(opt_state.count), "mu": tree(opt_state.mu),
           "nu": tree(opt_state.nu)}
    if opt_state.acc:
        out["mini_step"] = np.int32(opt_state.mini_step)
        out["acc"] = tree(opt_state.acc)
    return out


def _state_key(path: str) -> str:
    """JAX state path -> module buffer key (norm stats of the prologue and
    epilogue sit one level deeper in the module)."""
    parts = path.split("/")
    out = []
    for i, p in enumerate(parts):
        out.append(p)
        if (p in ("prologue", "epilogue") and i + 1 < len(parts)
                and parts[i + 1] in ("mean", "var")):
            out.append("norm")
    return ".".join(out)


def load_flat(module: nn.Module, params: dict[str, np.ndarray],
              state: dict[str, np.ndarray] | None = None) -> nn.Module:
    """Copy flattened JAX leaves into ``module`` in place (strict: every
    parameter and buffer must be given, and nothing else)."""
    sd = {k.replace("/", "."): torch.tensor(np.asarray(v))
          for k, v in params.items()}
    sd.update({_state_key(k): torch.tensor(np.asarray(v))
               for k, v in (state or {}).items()})
    module.load_state_dict(sd, strict=True)
    return module


def load_jax_params(module: nn.Module, params, state=None) -> nn.Module:
    """Copy a JAX params pytree (and norm state) into ``module`` in place."""
    return load_flat(module, flatten_tree(params),
                     flatten_tree(state) if state is not None else None)


def _has_simple(flat_params) -> bool:
    return any(k.startswith("joint/simple/") for k in flat_params)


def from_flat(params: dict, state: dict, spec: RNNTSpec) -> RNNT:
    model = RNNT(spec, torch.Generator().manual_seed(0),
                 simple=_has_simple(params))
    return load_flat(model, params, state).eval()


def from_jax(params, state, spec: RNNTSpec) -> RNNT:
    """An ``RNNT`` (CPU, float32, eval mode) holding the given JAX weights."""
    return from_flat(flatten_tree(params), flatten_tree(state), spec)


def module_tree(module: nn.Module):
    """Parameters of ``module`` as a JAX-structured pytree of numpy arrays."""
    if isinstance(module, nn.ModuleList):
        return [module_tree(m) for m in module]
    out = {n: p.detach().float().cpu().numpy()
           for n, p in module.named_parameters(recurse=False)}
    for n, m in module.named_children():
        out[n] = module_tree(m)
    return out


def _norm_state(norm) -> dict:
    if norm.norm_type != "batch":
        return {}
    return {"mean": norm.mean.detach().float().cpu().numpy(),
            "var": norm.var.detach().float().cpu().numpy()}


def encoder_state(encoder) -> dict:
    """The JAX encoder state pytree (batch-norm running stats); a
    FastConformer's (which the JAX package does not have) by its module
    path, one conv module's norm a layer."""
    if hasattr(encoder, "layers"):
        return {"layers": [{"conv": {"norm": _norm_state(layer.conv.norm)}}
                           for layer in encoder.layers]}
    return {
        "prologue": _norm_state(encoder.prologue["norm"]),
        "blocks": [{"norms": [_norm_state(n) for n in blk.norms],
                    "residual_norm": _norm_state(blk.residual_norm)}
                   for blk in encoder.blocks],
        "epilogue": _norm_state(encoder.epilogue["norm"]),
    }


def to_jax(model: RNNT):
    """(params, state) pytrees of numpy arrays, JAX structure and layout."""
    return module_tree(model), {"encoder": encoder_state(model.encoder)}


def write_checkpoint(path: str | Path, cfg: Config, params, state) -> Path:
    """Write ``config.yaml`` and ``params.npz`` from JAX-layout pytrees."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_config(cfg, path / CONFIG_FILE)
    arrays = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    arrays.update({f"state/{k}": v for k, v in flatten_tree(state).items()})
    np.savez(path / PARAMS_FILE, **arrays)
    return path


def save_checkpoint(path: str | Path, cfg: Config, model: RNNT) -> Path:
    return write_checkpoint(path, cfg, *to_jax(model))


def find_config(checkpoint: str | Path) -> Path:
    """config.yaml in the checkpoint directory or its parent."""
    p = Path(checkpoint)
    for cand in (p / CONFIG_FILE, p.parent / CONFIG_FILE):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"no {CONFIG_FILE} next to {checkpoint}")


def load_checkpoint(path: str | Path, spec: RNNTSpec, device) -> RNNT:
    """The model stored in a checkpoint directory, on ``device``, eval mode."""
    with np.load(Path(path) / PARAMS_FILE) as z:
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
        state = {k[len("state/"):]: z[k] for k in z.files
                 if k.startswith("state/")}
    return from_flat(params, state, spec).to(device)
