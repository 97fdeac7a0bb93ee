"""The ("data", "model") process mesh: the port's distribution layer.

Port of ``rnnt_tpu/parallel/mesh.py``.  Where JAX lays one jitted program
over a device mesh and lets XLA insert the collectives, the port runs one
process per rank (``python -m torch.distributed.run``) and names its
collectives itself:

* rank r sits at (r // model, r % model); its ``data`` group is the ranks of
  its mesh column (the data-parallel replicas that hold the same shard),
  its ``model`` group the ranks of its mesh row (the same batch rows);
* tensor parallelism follows JAX's rules (``_TP_RULES``, ``_spec_for`` at
  ``mesh.py:47-90``, here ``TP_RULES`` and ``sharded_dim``): on a ``model``
  axis larger than 1, ``joint.out`` and the pruned loss's simple heads hold
  their rank's slice of V, ``encoder.out`` and ``predictor.linear`` their
  slice of H; a leaf shards only when its rank matches the rule's and the
  sharded dimension divides by the model axis, and is replicated
  otherwise.  ``shard_params`` cuts a whole model, built alike on every
  rank (``rnnt_init`` or ``compat.from_jax``), down to the rank's shards;
  ``gather_params`` and ``whole_model`` are its inverse.  The optimizer's
  moments are allocated from the shards, so they are sharded too.
  ``replica_digests`` tells whether the replicated parameters stayed
  bit-equal on every rank;
* the collectives of the sharded layers are autograd Functions over the
  model group: ``copy_to_model`` (identity forward, all-reduce backward:
  the input of a column-parallel layer), ``gather_last`` (all-gather along
  the last dim forward, the rank's slice backward: the model ranks'
  gradients there are already equal, so it must not sum) and
  ``reduce_from_model`` (all-reduce forward, identity backward: a partial
  sum whose consumers are replicated); ``all_reduce_both`` (all-reduce
  both ways) carries batch-norm statistics over the data group.  They use
  only ``all_reduce``, ``all_gather`` and ``broadcast``, which gloo and
  NCCL both take on CUDA tensors (``parallel/gloo_probe.py``; gloo has no
  ``reduce_scatter``);
* with ``lattice_shard_t`` the model axis carries T blocks of the lattice
  instead, and every parameter stays replicated on it, where JAX shards by
  the same rules under either: a deliberate divergence in memory layout
  only, the arithmetic is the same.

The groups are the rows and columns ``init_device_mesh(device, (data,
model), mesh_dim_names=("data", "model"))`` would build, made with
``torch.distributed.new_group`` so that they take the default group's
backend: NCCL between cards, gloo on the CPU and for ranks that share one
card.  The point-to-point exchange names its transport by backend
(``send_row`` / ``recv_row``); collectives pass device tensors to either.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from rnnt_tpu_torch.ops.multi_tensor import sq_norms


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a data x model mesh, and its groups (None on a
    one-process run)."""
    data: int
    model: int
    rank: int = 0
    backend: str | None = None
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def model_peer(self, m: int) -> int:
        """The global rank of model index ``m`` in this rank's mesh row."""
        return self.data_rank * self.model + m

    def rows(self, local_batch: int) -> slice:
        """This rank's rows of a global batch of ``data * local_batch``."""
        return slice(self.data_rank * local_batch,
                     (self.data_rank + 1) * local_batch)


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh over the initialised default process group (one rank when
    there is none).  ``data=-1`` takes ``world // model``; raises unless
    ``data * model`` is the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1:
        raise ValueError(f"mesh model axis must be >= 1, got {model}")
    if data == -1:
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(f"mesh data={data} x model={model} needs "
                         f"{data * model} ranks, the process group has {world}")
    if world == 1:
        return Mesh(data, model)
    # Every rank makes every group, in the same order.
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    return Mesh(data, model, rank, dist.get_backend(),
                data_groups[rank % model], model_groups[rank // model])


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (the world when None), in place; returns
    ``t``.  Both backends take device tensors (gloo copies CUDA tensors
    through the host itself)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gloo_staged(t: torch.Tensor, mesh: Mesh) -> bool:
    """gloo's send and recv read and write the tensor's memory from the
    host, so a CUDA tensor crosses them through pinned host memory."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def send_row(t: torch.Tensor, dst: int, mesh: Mesh) -> None:
    """Send a (B, U) boundary row to global rank ``dst``: device to device
    over NCCL; through pinned host memory over gloo."""
    if _gloo_staged(t, mesh):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.send(host, dst)
    else:
        dist.send(t.contiguous(), dst)


def recv_row(like: torch.Tensor, src: int, mesh: Mesh) -> torch.Tensor:
    """Receive a row shaped, typed and placed like ``like`` from global rank
    ``src`` (the transport of ``send_row``)."""
    if _gloo_staged(like, mesh):
        host = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        dist.recv(host, src)
        return host.to(like.device)
    out = torch.empty_like(like)
    dist.recv(out, src)
    return out


# ----------------------------- tensor parallelism -----------------------------

# rnnt_tpu/parallel/mesh.py:47-61: (path parts, spec), the spec one entry per
# dim, "model" on the dim that shards.
TP_RULES: tuple = (
    (("joint", "out", "w"), (None, "model")),       # (H, V): vocabulary
    (("joint", "out", "b"), ("model",)),
    (("joint", "simple", "am", "w"), (None, "model")),
    (("joint", "simple", "am", "b"), ("model",)),
    (("joint", "simple", "lm", "w"), (None, "model")),
    (("joint", "simple", "lm", "b"), ("model",)),
    (("encoder", "out", "w"), (None, "model")),     # (C_epi, H): H
    (("encoder", "out", "b"), ("model",)),
    (("predictor", "linear", "w"), (None, "model")),  # (D, H): H
    (("predictor", "linear", "b"), ("model",)),
)
# The submodules whose forward runs sharded, by the parameter that says so.
TP_MODULES = (("encoder", "encoder.out.w"), ("predictor", "predictor.linear.w"),
              ("joint", "joint.out.w"))


def sharded_dim(path_parts, shape, model: int) -> int | None:
    """The dim a leaf at ``path_parts`` (its name split on ".") shards on
    over ``model`` ranks, or None for replicated: ``_spec_for`` of
    ``rnnt_tpu/parallel/mesh.py:74-90``, rule for rule (a rule whose rank
    differs from the leaf's, or whose dim does not divide, passes to the
    next)."""
    if model > 1:
        for keys, spec in TP_RULES:
            if not all(k in path_parts for k in keys) or len(shape) != len(spec):
                continue
            dims = [i for i, d in enumerate(spec) if d is not None]
            if dims and all(shape[i] % model == 0 for i in dims):
                return dims[0]
    return None


def take_shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of ``t`` along ``dim`` (a contiguous copy)."""
    part = t.chunk(mesh.model, dim)[mesh.model_rank]
    return part.clone(memory_format=torch.contiguous_format)


def all_gather_dim(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model ranks' slices of a tensor, concatenated along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def shard_params(model, mesh: Mesh) -> dict[str, int]:
    """Cut ``model`` (whole, the same on every rank) down to this rank's
    shards in place, by the TP rules; mark the submodules that run sharded
    (``tp_mesh``) and keep the layout on the model (``tp_layout``).
    Returns the layout, {} on a model axis of 1 (nothing changes)."""
    if mesh.model > 1 and hasattr(model, "spec"):  # a whole model, not a part's holder
        from rnnt_tpu_torch.models.rnnt import refuse_unsupported

        refuse_unsupported(model.spec, "a tensor-parallel mesh")
    params = dict(model.named_parameters())
    dims = {n: sharded_dim(n.split("."), tuple(p.shape), mesh.model) for n, p in params.items()}
    layout = {n: d for n, d in dims.items() if d is not None}
    with torch.no_grad():
        for name, dim in layout.items():
            params[name].data = take_shard(params[name].data, dim, mesh)
    for sub, key in TP_MODULES:
        if key in layout:
            getattr(model, sub).tp_mesh = mesh
    model.tp_layout = layout
    return layout


def _gathered(tensors: dict, layout: dict, mesh: Mesh) -> dict:
    return {n: all_gather_dim(t, layout[n], mesh) if n in layout else t
            for n, t in tensors.items()}


def gather_params(model, mesh: Mesh) -> dict[str, torch.Tensor]:
    """Every parameter of a sharded ``model`` whole, by name, on every
    model rank (a collective over the model group)."""
    with torch.no_grad():
        return _gathered({n: p.data for n, p in model.named_parameters()},
                         getattr(model, "tp_layout", {}), mesh)


def shard_opt_state(opt_state, layout: dict, mesh: Mesh):
    """An optimizer state of the whole model cut to this rank's shards."""
    def cut(d):
        return {n: take_shard(t, layout[n], mesh) if n in layout else t for n, t in d.items()}

    return dataclasses.replace(opt_state, mu=cut(opt_state.mu), nu=cut(opt_state.nu),
                               acc=cut(opt_state.acc))


@contextlib.contextmanager
def whole_model(model, mesh: Mesh, opt_state=None):
    """Inside, ``model`` holds every parameter whole and runs unsharded
    (its forward makes no collective); yields the optimizer state gathered
    likewise (None when none is given).  The shards are back on exit.  A
    collective over the model group on entry; nothing happens for a model
    that is not sharded."""
    layout = getattr(model, "tp_layout", {})
    if not layout:
        yield opt_state
        return
    params = dict(model.named_parameters())
    shards = {n: params[n].data for n in layout}
    marks = {sub: getattr(model, sub).tp_mesh for sub, _ in TP_MODULES}
    whole_opt = None
    with torch.no_grad():
        for n, t in gather_params(model, mesh).items():
            params[n].data = t
        if opt_state is not None:
            whole_opt = dataclasses.replace(
                opt_state, mu=_gathered(opt_state.mu, layout, mesh),
                nu=_gathered(opt_state.nu, layout, mesh),
                acc=_gathered(opt_state.acc, layout, mesh))
    for sub in marks:
        getattr(model, sub).tp_mesh = None
    try:
        yield whole_opt
    finally:
        for n, t in shards.items():
            params[n].data = t
        for sub, m in marks.items():
            getattr(model, sub).tp_mesh = m


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def replica_digests(model, mesh: Mesh) -> list[int]:
    """Every rank's digest of the bits of its replicated parameters (those
    not in ``model.tp_layout``), by global rank: bit-equal replicas give
    equal digests.  A collective over the world."""
    layout = getattr(model, "tp_layout", {})
    digest, dev = 0, None
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in layout:
                continue
            dev = p.device
            bits = p.reshape(-1).view(_BITS[p.element_size()]).long()
            pos = torch.arange(1, bits.numel() + 1, device=dev)
            digest = (digest * 1000003 + int((bits * pos).sum())) % (1 << 61)
    if mesh.world == 1:
        return [digest]
    mine = torch.tensor([digest], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(parts, mine)
    return [int(x) for x in parts]


def norm_groups(names, layout: dict) -> tuple[list[str], list[int]]:
    """(the top-level submodules, sorted; each name's group): its
    submodule's index, plus the number of submodules when it is sharded
    (in ``layout``)."""
    subs = sorted({n.split(".")[0] for n in names})
    slot = {s: i for i, s in enumerate(subs)}
    return subs, [slot[n.split(".")[0]] + (len(subs) if n in layout else 0) for n in names]


def squared_norms(grads: dict, layout: dict, mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """{top-level submodule: the sum of squares of its gradients}, float32,
    counting each sharded gradient once: a rank's squares of its shards are
    summed over the model group (one all-reduce), the replicated ones are
    taken as they are.  One ``sq_norms`` pass over every leaf, grouped by
    ``norm_groups``."""
    if not grads:
        return {}
    subs, groups = norm_groups(grads, layout)
    S = len(subs)
    sq = sq_norms(list(grads.values()), groups, 2 * S)
    rep, sh = sq[:S], sq[S:]
    if any(n in layout for n in grads) and mesh is not None and mesh.model > 1:
        sh = all_reduce_sum(sh.contiguous(), mesh.model_group)
    return dict(zip(subs, rep + sh))


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _GatherLast(torch.autograd.Function):
    """The model ranks' slices concatenated along the last dim forward; this
    rank's slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_dim(x, x.dim() - 1, mesh)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return g.chunk(m.model, -1)[m.model_rank].contiguous(), None


class _ReduceFromModel(torch.autograd.Function):
    """Summed over the model group forward; identity backward (every model
    rank consumes the sum alike)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBoth(torch.autograd.Function):
    """Summed over ``group`` forward and backward: a partial sum whose
    consumers on every rank are parts of one loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherLast.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def all_reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceBoth.apply(x, group)


def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max over the model group (no gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return out


def column_parallel(linear, x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``linear(x)`` whole: with a mesh, ``linear`` holds this rank's
    output columns, x is replicated, and the model ranks' columns are
    gathered."""
    if mesh is None:
        return linear(x)
    return gather_last(linear(copy_to_model(x, mesh)), mesh)
