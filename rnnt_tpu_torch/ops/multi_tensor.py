"""The train step's gradient norms and AdamW update as two multi-tensor
CUDA passes over every parameter leaf.

Neither replaces a TPU kernel: the JAX package leaves optax's
``global_norm`` and ``clip_by_global_norm`` + ``adamw`` to XLA, which fuses
them.  In eager PyTorch the same arithmetic written per leaf issues ~17
kernels a leaf for the update and one or two a leaf for each norm pass
(~20,000 launches a step at parakeet_rnnt_0.6b's 911 leaves), and the card
waits on the host that launches them.

* ``sq_norms`` (``csrc/sq_norms.cu``): the sum of squares of every leaf,
  summed into its group's slot of a small float32 vector.  Per-block
  partials, then a fixed-order reduction of each group's partials: no float
  atomics, so two runs give the same bits.
* ``adamw_update`` (``csrc/adamw_update.cu``): optax's clip (the global
  norm read from device memory, ``g / g_norm * max_norm`` when ``g_norm >=
  max_norm``), the moments, the bias-corrected update, the decoupled weight
  decay and ``p -= lr * upd``, in float32 in ``train/optim.py``'s order; one
  thread reads g, p, mu and nu of an element once and writes p, mu and nu
  once.

Bound on an H100: bytes.  The update reads 16 B and writes 12 B a
parameter, the norm pass reads 4 B: 32 B a parameter, 5.86 ms for
613,410,305 parameters at 3.35 TB/s.

**How the leaves reach the kernels.**  ``plan_launches`` (pure Python, the
CPU tests pin it) cuts the leaves, in order, into launches of at most
``cap`` leaves, and each leaf into blocks of ``chunk`` elements; a launch's
blocks are numbered leaf after leaf, and ``blk`` holds each leaf's first
block (prefix sums), so a block finds its leaf by a binary search over
``blk`` and its chunk as the difference.  Leaves of 0 elements get no block.
For the norm pass each block's partial has a slot in one buffer sorted by
group (``out``, ``group_start``), so a group's partials are one range.  The
C entry point copies one launch's table (pointers, element counts, ``blk``,
``out``) into a struct passed by value as the kernel's parameters (CUDA
12.1+ allows 32,764 bytes of them on sm_90): nothing is copied to the card
ahead of the launch, so the host may run steps ahead.  The pointers are
read from the tensors at every call; the plan is memoised by the leaves'
sizes and groups.

``sq_norms_plain`` and ``adamw_update_plain`` are the same functions as
per-leaf PyTorch loops: the CPU path (bit for bit what ``train/optim.py``
and ``parallel/mesh.py`` computed before the kernels) and the card's
yardstick.  The wrappers take them only for CPU tensors; for CUDA tensors
they launch or raise.  ``SQ_NORMS.launches`` and ``ADAMW_UPDATE.launches``
count C calls: one a launch of leaves, the norm pass's last one also
running the group reduction.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from rnnt_tpu_torch.ops.kernels import CudaKernel, build_all

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

SQ_NORMS = CudaKernel(
    "sq_norms", "rnnt_sq_norms", [_P, _P, _P, _P, _I, _L, _P, _P, _I, _P, _P],
    replaces="none: optax global_norm, fused by XLA")
ADAMW_UPDATE = CudaKernel(
    "adamw_update", "rnnt_adamw_update",
    [_P] * 6 + [_I, _L, _P] + [_F] * 10 + [_P],
    replaces="none: optax clip_by_global_norm + adamw, fused by XLA")

# Leaves a launch and elements a block; the caps are the sizes of the
# by-value tables in csrc/sq_norms.cu and csrc/adamw_update.cu.
NORM_CAP, NORM_CHUNK = 1024, 16384
UPDATE_CAP, UPDATE_CHUNK = 640, 8192
MAX_GROUPS = 64  # csrc/sq_norms.cu MAX_GROUPS


@dataclass(frozen=True)
class Launch:
    leaves: np.ndarray      # indices into the leaf list, each with >= 1 block
    n: np.ndarray           # their element counts, int64
    blk: np.ndarray         # (len(leaves) + 1,) int32: first block of each; blk[-1] = blocks
    out: np.ndarray | None  # norm pass: slot of each leaf's first partial, int32


@dataclass(frozen=True)
class Plan:
    chunk: int
    launches: tuple[Launch, ...]
    blocks: int                          # over every launch
    group_start: np.ndarray | None       # norm pass: (groups + 1,) int32 slot ranges


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=16)
def plan_launches(sizes: tuple[int, ...], cap: int, chunk: int,
                  groups: tuple[int, ...] | None = None, n_groups: int = 0) -> Plan:
    """Launches of at most ``cap`` leaves covering every element of leaves
    of ``sizes`` elements once, in blocks of ``chunk``.  With ``groups``
    (one id in [0, n_groups) a leaf) each block also gets a partial slot,
    the slots of a group forming ``group_start[g]:group_start[g + 1]``."""
    n = np.asarray(sizes, dtype=np.int64)
    nblk = -(-n // chunk)
    if nblk.max(initial=0) >= 2 ** 31 or nblk.sum() >= 2 ** 31:
        raise ValueError("more than 2^31 blocks")
    live = np.flatnonzero(nblk)
    out_all = group_start = None
    if groups is not None:
        g = np.asarray(groups, dtype=np.int64)
        if len(g) != len(n) or (len(g) and (g.min() < 0 or g.max() >= n_groups)):
            raise ValueError(f"groups must give each leaf an id in [0, {n_groups})")
        per_group = np.bincount(g, weights=nblk, minlength=n_groups).astype(np.int64)
        group_start = np.concatenate([[0], np.cumsum(per_group)]).astype(np.int32)
        # Within a group, slots follow the leaves' order.
        out_all = np.empty(len(n), dtype=np.int64)
        cursor = group_start[:-1].astype(np.int64).copy()
        for i in range(len(n)):
            out_all[i] = cursor[g[i]]
            cursor[g[i]] += nblk[i]
    launches = []
    for s in range(0, len(live), cap):
        idx = live[s:s + cap]
        blk = np.concatenate([[0], np.cumsum(nblk[idx])]).astype(np.int32)
        launches.append(Launch(
            _frozen(idx), _frozen(n[idx].copy()), _frozen(blk),
            None if out_all is None else _frozen(out_all[idx].astype(np.int32))))
    return Plan(chunk, tuple(launches), int(nblk.sum()),
                None if group_start is None else _frozen(group_start))


def _ensure_built() -> None:
    """Both sources in one parallel nvcc round at the first launch."""
    if SQ_NORMS._fn is None or ADAMW_UPDATE._fn is None:
        build_all([SQ_NORMS, ADAMW_UPDATE])


def _pointers(name: str, tensors: list, sizes, device, *, fix: bool = False) -> np.ndarray:
    """The data pointers of float32 tensors on ``device`` of ``sizes``
    elements, contiguous (made so in ``tensors`` when ``fix``: read-only
    inputs), as uint64; raises on any other.  One pass a property: ~0.1 ms
    each over 911 leaves."""
    ok = [t.device == device and t.dtype is torch.float32 and t.numel() == n
          for t, n in zip(tensors, sizes)]
    if not all(ok):
        i = ok.index(False)
        t = tensors[i]
        raise ValueError(f"{name}[{i}]: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected float32 of {sizes[i]} elements on {device}")
    if fix:
        tensors[:] = [t.contiguous() for t in tensors]
    elif not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous (updated in place)")
    return np.array([t.data_ptr() for t in tensors], dtype=np.uint64)


def _host(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def sq_norms_plain(tensors, groups, n_groups: int) -> torch.Tensor:
    """``sq_norms`` as a per-leaf loop: each group's float32 sums of
    squares added in the leaves' order."""
    sums: list = [None] * n_groups
    for t, g in zip(tensors, groups):
        sq = torch.sum(t.float() ** 2)
        sums[g] = sq if sums[g] is None else sums[g] + sq
    dev = tensors[0].device if len(tensors) else None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([zero if s is None else s for s in sums])


def sq_norms(tensors, groups, n_groups: int) -> torch.Tensor:
    """(n_groups,) float32 on the tensors' device: the sum of the squares of
    the tensors of each group (``groups`` gives each tensor's id in [0,
    n_groups)); 0 for a group of no elements.  CPU tensors take
    ``sq_norms_plain``; CUDA tensors (float32) the kernel."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type == "cpu":
        return sq_norms_plain(tensors, groups, n_groups)
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"sq_norms runs on CUDA or the CPU, got {dev}")
    if not 0 < n_groups <= MAX_GROUPS:
        raise ValueError(f"sq_norms takes 1 to {MAX_GROUPS} groups, got {n_groups}")
    sizes = tuple(t.numel() for t in tensors)
    plan = plan_launches(sizes, NORM_CAP, NORM_CHUNK, tuple(groups), n_groups)
    if plan.blocks == 0:
        return torch.zeros(n_groups, dtype=torch.float32, device=dev)
    ptrs = _pointers("tensors", tensors, sizes, dev, fix=True)
    partials = torch.empty(plan.blocks, dtype=torch.float32, device=dev)
    sums = torch.empty(n_groups, dtype=torch.float32, device=dev)
    _ensure_built()
    last = len(plan.launches) - 1
    for i, la in enumerate(plan.launches):
        g = np.ascontiguousarray(ptrs[la.leaves])
        SQ_NORMS.launch(_host(g), _host(la.n), _host(la.blk), _host(la.out),
                        len(la.leaves), plan.chunk, partials,
                        _host(plan.group_start) if i == last else None,
                        n_groups if i == last else 0, sums)
    return sums


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, float32 (optax's
    ``global_norm``), through ``sq_norms``."""
    tensors = list(tensors)
    return torch.sqrt(sq_norms(tensors, [0] * len(tensors), 1)[0])


@dataclass(frozen=True)
class AdamWHyper:
    """One update's scalars: the schedule's ``lr`` and the bias corrections
    ``bc1``, ``bc2`` at its count, with the optimizer's constants."""
    lr: float
    bc1: float
    bc2: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    max_norm: float


def adamw_update_plain(params, grads, mu, nu, g_norm: torch.Tensor, h: AdamWHyper) -> None:
    """``adamw_update`` as a per-leaf loop (``train/optim.py``'s
    arithmetic, op for op)."""
    clip = g_norm >= h.max_norm
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g.float()
        g = torch.where(clip, g / g_norm * h.max_norm, g)
        m.mul_(h.b1).add_(g, alpha=1 - h.b1)
        v.mul_(h.b2).add_(g * g, alpha=1 - h.b2)
        upd = (m / h.bc1) / (torch.sqrt(v / h.bc2) + h.eps)
        upd = upd + h.weight_decay * p.float()
        p.add_((-h.lr * upd).to(p.dtype))


def adamw_update(params, grads, mu, nu, g_norm: torch.Tensor, h: AdamWHyper) -> None:
    """In place on every leaf: optax's clip of ``grads`` by the global norm
    ``g_norm`` (a 0-d float32 tensor on the leaves' device, read there), the
    moments ``mu`` and ``nu``, and AdamW's step with decoupled decay on
    ``params``.  CPU tensors take ``adamw_update_plain``; CUDA tensors
    (float32, the parameters and moments contiguous) the kernel."""
    params, grads, mu, nu = list(params), list(grads), list(mu), list(nu)
    if not params or params[0].device.type == "cpu":
        return adamw_update_plain(params, grads, mu, nu, g_norm, h)
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"adamw_update runs on CUDA or the CPU, got {dev}")
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("params, grads, mu and nu must be leaf for leaf")
    if g_norm.device != dev or g_norm.dtype != torch.float32 or g_norm.numel() != 1:
        raise ValueError(f"g_norm: {g_norm.dtype} {tuple(g_norm.shape)} on "
                         f"{g_norm.device}, expected one float32 on {dev}")
    sizes = tuple(p.numel() for p in params)
    plan = plan_launches(sizes, UPDATE_CAP, UPDATE_CHUNK)
    tables = [_pointers("params", params, sizes, dev),
              _pointers("grads", grads, sizes, dev, fix=True),
              _pointers("mu", mu, sizes, dev), _pointers("nu", nu, sizes, dev)]
    # float32 as PyTorch rounds a Python scalar against a float32 tensor.
    scalars = [float(np.float32(x)) for x in (h.max_norm, h.b1, 1 - h.b1, h.b2, 1 - h.b2,
                                              h.bc1, h.bc2, h.eps, h.weight_decay, -h.lr)]
    _ensure_built()
    for la in plan.launches:
        p, g, m, v = (np.ascontiguousarray(t[la.leaves]) for t in tables)
        ADAMW_UPDATE.launch(_host(p), _host(g), _host(m), _host(v), _host(la.n),
                            _host(la.blk), len(la.leaves), plan.chunk, g_norm, *scalars)
