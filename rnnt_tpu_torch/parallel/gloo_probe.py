"""Which gloo operations take CUDA tensors: run on a machine with a card,

    python -m torch.distributed.run --nproc-per-node 2 -m rnnt_tpu_torch.parallel.gloo_probe

Two ranks on ``cuda:0`` join a gloo process group and try, in order,
all_reduce, broadcast, all_gather, then send / recv on CUDA tensors; rank
0 (rank 1 for send / recv, whose receiving end it is) prints one line per
operation (``ok``, or the error) as it goes, so a rank that dies inside an
operation still leaves the lines before it.
``parallel/mesh.py`` stages through pinned host memory what this finds
gloo cannot take.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def main() -> None:
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    world = dist.get_world_size()
    want = float(sum(range(1, world + 1)))

    def report(name, fn, reporter=0):
        try:
            ok = fn()
            msg = "ok" if ok else "wrong values"
        except Exception as e:  # the finding is the error itself
            msg = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        if rank == reporter:
            print(f"gloo {name} on CUDA tensors: {msg}", flush=True)
        dist.barrier()

    def all_reduce():
        t = torch.full((4, 65), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == want).all())

    def broadcast():
        t = torch.full((4, 65), float(rank + 1), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 1.0).all())

    def all_gather():
        parts = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def send_recv():
        t = torch.full((4, 65), 7.0, device=dev)
        if rank == 0:
            dist.send(t, 1)
            return True
        out = torch.zeros_like(t)
        if rank == 1:
            dist.recv(out, 0)
            return bool((out == 7.0).all())
        return True

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather)):
        report(name, fn)
    report("send/recv", send_recv, reporter=1)  # rank 1 receives
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
