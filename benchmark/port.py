"""The program under test, as the benchmark sets it up: its configuration
with the cell's changes, and its model with weights made from the seed on
the card.

Weights are drawn in three calls on the model's device from one
``torch.Generator`` seeded by the run's seed: one uniform draw shared by
every convolution and linear layer (each slice scaled by its layer's
Kaiming bound 1/sqrt(fan_in), the port's own distribution), one normal
draw for the embedding, and one uniform draw for batch-norm running
statistics (mean and variance in [0.5, 1.5]); norms' scales are 1 and
their biases 0; the joint's blank output bias is given.  A parameter or
buffer that none of these rules names is refused: the model is made on
the meta device and moved with ``to_empty``, so it would hold whatever
memory it was given.  The same tensors, copied, are what the plain
reference is given.
"""

from __future__ import annotations

import json

import torch

def load_config(conf: dict, extra: list[str] = ()):
    """The port's config for a benchmark configuration: its YAML with the
    configuration's overrides and the cell's ``extra`` ones.  Raises when
    the result's model differs from the configuration's ``model`` block,
    which is what the reference computes."""
    from rnnt_tpu_torch.config.config import (
        apply_overrides, config_to_dict, load_config as port_load, resolve_config)

    cfg = apply_overrides(port_load(resolve_config(conf["port_yaml"])),
                          list(conf.get("overrides", [])) + list(extra))
    got = json.loads(json.dumps(config_to_dict(cfg)))
    for k, want in conf["model"].items():
        have = got[k]
        if k == "training":
            have = {kk: have[kk] for kk in want}
        if have != want:
            raise ValueError(f"{conf['name']}: the port's {k} is {have}, the "
                             f"benchmark's configuration says {want}")
    return cfg


def fan_in(name: str, p: torch.Tensor) -> int | None:
    if name.endswith(".w"):
        return p.shape[0] * p.shape[1] if p.dim() == 3 else p.shape[0]
    return None


@torch.no_grad()
def build_model(cfg, seed: int, device, blank_bias: float = 0.0):
    """(the port's RNNT on ``device`` in eval mode, a dict of float32 copies
    of its parameters and buffers by name for the reference)."""
    from rnnt_tpu_torch.config.config import build_model_spec
    from rnnt_tpu_torch.models.rnnt import RNNT

    spec = build_model_spec(cfg)
    with torch.device("meta"):
        model = RNNT(spec, torch.Generator())
    model = model.to_empty(device=device).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    named = dict(model.named_parameters())
    bufs = dict(model.named_buffers())
    bounds = {}
    for name, p in named.items():
        if (name.endswith(".w") or name.endswith(".b")) and name[:-2] + ".w" in named:
            w = named[name[:-2] + ".w"]
            bounds[name] = fan_in(name[:-2] + ".w", w) ** -0.5
    undrawn = [n for n in named if n not in bounds and n != "predictor.embedding"
               and not n.endswith((".scale", ".bias"))]
    undrawn += [n for n in bufs if not n.endswith((".mean", ".var"))]
    if undrawn:
        raise ValueError(f"the benchmark draws no value for {', '.join(undrawn)}: "
                         "benchmark/port.py build_model needs a rule for each")
    total = sum(named[n].numel() for n in bounds)
    flat = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    off = 0
    for name, bound in bounds.items():
        p = named[name]
        p.copy_(flat[off: off + p.numel()].view_as(p)).mul_(bound)
        off += p.numel()
    emb = named["predictor.embedding"]
    emb.copy_(torch.randn(emb.shape, generator=g, device=device))
    for name, p in named.items():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith(".bias") and name not in bounds:
            p.fill_(0.0)
    if bufs:
        n = sum(b.numel() for b in bufs.values())
        draw = torch.rand(n, generator=g, device=device).add_(0.5)
        off = 0
        for b in bufs.values():
            b.copy_(draw[off: off + b.numel()].view_as(b))
            off += b.numel()
    named["joint.out.b"][spec.blank_idx] = blank_bias
    weights = {k: v.detach().float().clone() for k, v in
               list(named.items()) + list(bufs.items())}
    return model, weights
