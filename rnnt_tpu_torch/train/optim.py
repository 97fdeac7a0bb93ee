"""Optimizer and LR schedule: the port's own AdamW, equal step for step to
``optax.chain(clip_by_global_norm, adamw)`` of ``rnnt_tpu/train/optim.py``.

* The clip is optax's: ``g * max_norm / g_norm`` when ``g_norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and is not the same).
* Adam: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, bias
  correction by optax's count (of real updates), ``eps`` outside the sqrt.
* Weight decay is decoupled, added to the update and scaled with it by the
  learning rate of the schedule at the count before the update.
* ``accumulate_steps > 1`` is ``optax.MultiSteps``: a running mean of the
  micro-gradients; the inner update (and its count) advance only every k
  calls, and parameters do not move in between.

The state (``OptState``) holds float32 ``mu`` and ``nu`` by parameter name
(``model.named_parameters()``); ``compat/jax_params.py`` carries it to and
from the optax layout.  On a tensor-parallel mesh the parameters are this
rank's shards, so are the moments, and the clip takes its global norm from
the caller (``norm``), which counts each shard once over the model group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, min_lr_ratio: float = 0.05):
    """Linear 0 -> lr over warmup_steps (the step counter starting at 1: the
    +1 offset of the reference's torch scheduler), then cosine to
    base_lr * min_lr_ratio.  Float32 arithmetic, as the JAX schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step + 1)
        warm = s / f32(max(1, warmup_steps))
        progress = (s - f32(warmup_steps)) / f32(max(1, total_steps - warmup_steps))
        progress = np.clip(progress, f32(0.0), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * progress))
        decayed = f32(1.0 - min_lr_ratio) * cos + f32(min_lr_ratio)
        factor = warm if s <= warmup_steps else decayed
        return float(f32(base_lr) * f32(factor))

    return schedule


@dataclass
class OptState:
    count: int                                    # real updates so far
    mu: dict = field(default_factory=dict)        # name -> float32 tensor
    nu: dict = field(default_factory=dict)
    mini_step: int = 0                            # MultiSteps position
    acc: dict = field(default_factory=dict)       # running mean of grads


class AdamWClip:
    """``clip_by_global_norm(max_norm)`` then ``adamw(schedule, b1, b2,
    eps, weight_decay)``, optionally under ``MultiSteps(k)``."""

    def __init__(self, schedule, *, b1: float, b2: float, eps: float,
                 weight_decay: float, max_norm: float,
                 accumulate_steps: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.k = accumulate_steps

    def init(self, params: dict) -> OptState:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for n, p in params.items()}
        return OptState(0, zeros(), zeros(), 0, zeros() if self.k > 1 else {})

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: OptState,
               norm=None) -> OptState:
        """Apply one call's gradients to ``params`` in place; return the new
        state (the tensors of ``state`` are updated in place too).
        ``norm(grads)`` is the clip's global norm (by default the norm of
        the given gradients)."""
        if self.k <= 1:
            return self._apply(params, grads, state, norm)
        n = state.mini_step
        for name, g in grads.items():
            a = state.acc[name]
            a.add_((g.float() - a) / (n + 1))
        if n < self.k - 1:
            return OptState(state.count, state.mu, state.nu, n + 1, state.acc)
        new = self._apply(params, state.acc, state, norm)
        for a in state.acc.values():
            a.zero_()
        return OptState(new.count, new.mu, new.nu, 0, state.acc)

    def _apply(self, params: dict, grads: dict, state: OptState, norm=None) -> OptState:
        g_norm = (norm(grads) if norm is not None
                  else torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values())))
        clip = g_norm >= self.max_norm
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        lr = self.schedule(state.count)
        for name, p in params.items():
            g = grads[name].float()
            g = torch.where(clip, g / g_norm * self.max_norm, g)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd = upd + self.weight_decay * p.float()
            p.add_((-lr * upd).to(p.dtype))
        return OptState(count, state.mu, state.nu, state.mini_step, state.acc)


def make_optimizer(tc, total_steps: int):
    """(optimizer, schedule) from a TrainingConfig, as the JAX
    ``make_optimizer``."""
    oc = tc.optimizer
    sched = warmup_cosine_schedule(oc.lr, tc.lr_schedule.warmup_steps,
                                   total_steps, tc.lr_schedule.min_lr_ratio)
    opt = AdamWClip(sched, b1=oc.betas[0], b2=oc.betas[1], eps=oc.eps,
                    weight_decay=oc.weight_decay, max_norm=tc.clip_grad_norm,
                    accumulate_steps=tc.accumulate_steps)
    return opt, sched
