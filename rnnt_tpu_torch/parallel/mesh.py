"""The ("data", "model") process mesh: the port's distribution layer.

Port of ``rnnt_tpu/parallel/mesh.py:19-32``.  Where JAX lays one jitted
program over a device mesh and lets XLA insert the collectives, the port
runs one process per rank (``python -m torch.distributed.run``) and names
its collectives itself:

* rank r sits at (r // model, r % model); its ``data`` group is the ranks of
  its mesh column (the data-parallel replicas that hold the same T block),
  its ``model`` group the ranks of its mesh row (the same batch rows);
* every rank launches the kernels on its own rows, so
  ``rnnt_tpu/parallel/partition.py`` has no counterpart;
* every parameter and optimizer moment is replicated on every rank,
  ``model`` axis included, where JAX V-shards ``joint.out`` and a few wide
  weights (``mesh.py:47-61``).  The arithmetic is the same; only the memory
  layout differs.  The tensor-parallel joint is later work (ROADMAP §1).

The groups are the rows and columns ``init_device_mesh(device, (data,
model), mesh_dim_names=("data", "model"))`` would build, made with
``torch.distributed.new_group`` so that they take the default group's
backend: NCCL between cards, gloo on the CPU and for ranks that share one
card.  The point-to-point exchange names its transport by backend
(``send_row`` / ``recv_row``); collectives pass device tensors to either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


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
