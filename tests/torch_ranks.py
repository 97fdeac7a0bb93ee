"""Run a function on n ranks of a gloo process group in spawned CPU
processes, for the port's multi-rank tests (tests/test_torch_tshard.py,
tests/test_torch_distributed.py, tests/test_torch_tp.py,
tests/test_torch_tp_chunked.py).

The rank functions live here, not in the test files, so a spawned process
imports torch and the port only, never JAX.  Every run has its own
timeout: a hung collective fails its test instead of the whole suite.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RUN_TIMEOUT = 120  # seconds for one multi-rank run


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _entry(rank, world, port, out_dir, fn, args):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RUN_TIMEOUT))
    try:
        result = fn(*args)
        Path(out_dir, f"{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, *args, timeout: int = RUN_TIMEOUT) -> list:
    """[fn(*args) on rank r for r in range(world)]: every rank joins a gloo
    group first.  Raises when a rank fails or the run outlasts
    ``timeout`` (every rank is then terminated)."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_entry, args=(r, world, port, out, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        for p in procs:
            p.join(max((deadline - datetime.datetime.now()).total_seconds(), 0.1))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after {timeout} s")
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks failed (rank, exit code): {failed}")
        return [pickle.loads(Path(out, f"{r}.pkl").read_bytes()) for r in range(world)]


# ------------------------------ rank functions ------------------------------

def tsharded_loss_rank(data: int, model: int, lpb, lpl, t_lens, u_lens):
    """This rank's (mesh place, NLL, d sum(NLL) / d lattice) of the T-sharded
    loss over a data x model mesh, through ``lattice_nll(mesh=)``: the data
    rank takes its rows of the batch, the model rank its block of T;
    float64 CPU lattice."""
    from rnnt_tpu_torch.ops.transducer import lattice_nll
    from rnnt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data, model)
    rows = mesh.rows(lpb.shape[0] // data)
    a, b = (torch.tensor(x[rows], requires_grad=True) for x in (lpb, lpl))
    nll = lattice_nll(a, b, torch.from_numpy(t_lens[rows]),
                      torch.from_numpy(u_lens[rows]), mesh=mesh)
    ga, gb = torch.autograd.grad(nll.sum(), (a, b))
    return dict(place=(mesh.data_rank, mesh.model_rank), rows=(rows.start, rows.stop),
                nll=nll.detach().numpy(), grads=(ga.numpy(), gb.numpy()))


def _tiny_setup(overrides: list):
    from rnnt_tpu_torch.config import config as tconfig

    cfg = tconfig.apply_overrides(
        tconfig.load_config(tconfig.resolve_config("tiny_conv")), overrides)
    return cfg, tconfig.build_model_spec(cfg), tconfig.build_featurizer_spec(cfg)


def train_step_rank(data: int, model: int, overrides: list, batch: dict,
                    device_augment, spec_augment: bool):
    """One train step of tiny_conv (seed-0 weights) on this rank's rows of
    ``batch`` (numpy, the global batch) over a data x model mesh; returns
    the mesh place, the step's metrics and the updated parameters."""
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.parallel.mesh import make_mesh
    from rnnt_tpu_torch.train import loop, optim, step

    mesh = make_mesh(data, model)
    cfg, spec, fspec = _tiny_setup(overrides)
    opt, _ = optim.make_optimizer(cfg.training, 10)
    fn = step.make_train_step(spec, fspec, opt, cfg.training.precision,
                              spec_augment=spec_augment,
                              device_augment=device_augment, mesh=mesh)
    m = rnnt_init(spec, seed=0)
    state = step.TrainState(m, opt.init(dict(m.named_parameters())), 0)
    rows = mesh.rows(batch["audio"].shape[0] // data)
    local = step.batch_to_device({k: v[rows] for k, v in batch.items()}, "cpu")
    state, metrics = fn(state, local, loop.step_generator(torch.device("cpu"), 0, 0))
    groups = [sorted(dist.get_process_group_ranks(g))
              for g in (mesh.data_group, mesh.model_group)]
    return dict(place=(mesh.data_rank, mesh.model_rank), groups=groups,
                metrics={k: float(v) for k, v in metrics.items()},
                params={k: v.detach().numpy().copy()
                        for k, v in state.model.named_parameters()})


def loss_fn_rank(data: int, model: int, cfg, state_dict: dict, batch: dict):
    """The eval loss (training=False) of a model given by its state dict,
    with ``cfg``'s spec (``lattice_shard_t`` on), on this rank's rows over a
    data x model mesh."""
    from rnnt_tpu_torch.config import config as tconfig
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.parallel.mesh import make_mesh
    from rnnt_tpu_torch.train import step

    mesh = make_mesh(data, model)
    spec = tconfig.build_model_spec(cfg)
    m = rnnt_init(spec)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    fn = step.make_loss_fn(spec, tconfig.build_featurizer_spec(cfg), "fp32", mesh=mesh)
    rows = mesh.rows(batch["audio"].shape[0] // data)
    with torch.no_grad():
        loss = fn(m, step.batch_to_device({k: v[rows] for k, v in batch.items()}, "cpu"))
    return dict(place=(mesh.data_rank, mesh.model_rank), loss=float(loss))


def chunked_joint_rank(data: int, model: int, arrays: dict, blank: int, chunk_size: int,
                       clamps: tuple):
    """The chunked joint with ``joint.out`` cut to this rank's slice of V
    (``shard_params`` on a holder of a projection-free ``Joint`` built from
    ``arrays``' whole w (H, V) and b (V,)): for each grad_clamp in
    ``clamps``, the lattice log-probs, the mean loss of ``transducer_loss``
    and its gradients in audio, text and the slice's w and b."""
    from torch import nn

    from rnnt_tpu_torch.models.joint import Joint, JointSpec
    from rnnt_tpu_torch.ops.transducer import joint_lattice_log_probs, transducer_loss
    from rnnt_tpu_torch.parallel.mesh import make_mesh, shard_params

    mesh = make_mesh(data, model)
    H, V = arrays["w"].shape
    holder = nn.Module()
    holder.joint = Joint(JointSpec(0, 0, H, V), torch.Generator().manual_seed(0))
    with torch.no_grad():
        holder.joint.out.w.copy_(torch.from_numpy(arrays["w"]))
        holder.joint.out.b.copy_(torch.from_numpy(arrays["b"]))
    layout = shard_params(holder, mesh)
    joint = holder.joint
    t = {k: torch.from_numpy(arrays[k]) for k in ("targets", "t_lens", "u_lens")}
    out = {}
    for clamp in clamps:
        audio, text = (torch.tensor(arrays[k], requires_grad=True) for k in ("audio", "text"))
        with torch.no_grad():
            lpb, lpl = joint_lattice_log_probs(joint, audio, text, t["targets"], t["u_lens"],
                                               blank, chunk_size, clamp)
        loss = transducer_loss(joint, audio, text, t["targets"], t["t_lens"], t["u_lens"],
                               blank, chunk_size=chunk_size, grad_clamp=clamp)
        grads = torch.autograd.grad(loss, (audio, text, joint.out.w, joint.out.b))
        out[clamp] = dict(lp_blank=lpb.numpy(), lp_label=lpl.numpy(), loss=float(loss),
                          grads=[g.numpy() for g in grads])
    return dict(model_rank=mesh.model_rank, layout=layout, runs=out)


def sharded_loss_route_rank(data: int, model: int, overrides: list, impls: tuple,
                            batch: dict):
    """For each loss_impl in ``impls``: the train loss of tiny_conv
    (seed-0 weights, the simple heads for the pruned objectives) cut to
    this rank's shards, and of the same model whole, on the CPU; which
    joints each ran (calls of the chunked V-sharded joint and of K1 and
    K2's plain versions) and the hand-written kernels' launch counts."""
    import dataclasses

    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.ops import kernels, transducer_pallas
    from rnnt_tpu_torch.parallel import partition
    from rnnt_tpu_torch.parallel.mesh import make_mesh, shard_params
    from rnnt_tpu_torch.train import step

    calls = {}

    def spy(module, name):
        inner = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return inner(*args, **kwargs)

        setattr(module, name, counted)

    spy(partition, "chunked_joint_log_probs_tp")
    spy(transducer_pallas, "fused_joint_outputs_plain")
    spy(transducer_pallas, "fused_joint_bwd_plain")
    mesh = make_mesh(data, model)
    out = {}
    for impl in impls:
        cfg, spec, fspec = _tiny_setup(overrides + [
            f"training.loss_impl={'pruned' if impl.startswith('pruned') else impl}"])
        local = step.batch_to_device(batch, "cpu")
        fn = step.make_loss_fn(dataclasses.replace(spec, loss_impl=impl), fspec,
                               cfg.training.precision)
        losses = []
        for sharded in (True, False):
            m = rnnt_init(spec, seed=0)
            if sharded:
                shard_params(m, mesh)
            calls.clear()
            loss = fn(m, local, training=True)
            loss.backward()
            losses.append(float(loss))
            if sharded:
                out[impl] = dict(calls=dict(calls), launches=kernels.launch_counts(),
                                 tp_mesh=m.joint.tp_mesh is not None)
        out[impl].update(loss_sharded=losses[0], loss_whole=losses[1])
    return out


def flat_params(params: dict) -> np.ndarray:
    return np.concatenate([v.ravel() for _, v in sorted(params.items())])


class RecordingOptimizer:
    """An optimizer that keeps a copy of the gradients it is given (the
    train step's synchronized gradients), then updates as ``inner``."""

    def __init__(self, inner):
        self.inner, self.grads = inner, {}

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state, norm=None):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.update(params, grads, state, norm=norm)


def mesh_train_rank(data: int, model: int, cfg, runs: dict, batches: list):
    """Train steps on this rank's rows over a data x model mesh: for each
    ``runs[name] = (loss_impl, flat params, flat state)`` a model is built
    whole from the flat numpy weights (``compat.from_flat``), cut to this
    rank's shards on a model axis (``shard_params``) and takes one step per
    batch (numpy global batches, no generator).  Returns, by run, each
    step's metrics, the last step's synchronized gradients, the parameters
    gathered whole, the batch-norm buffers, the layout, the shapes this
    rank holds of its sharded parameters and their two moments, and every
    rank's digest of its replicated parameters."""
    import dataclasses

    from rnnt_tpu_torch.compat.jax_params import from_flat
    from rnnt_tpu_torch.config import config as tconfig
    from rnnt_tpu_torch.parallel.mesh import (
        gather_params, make_mesh, replica_digests, shard_params)
    from rnnt_tpu_torch.train import optim, step

    mesh = make_mesh(data, model)
    fspec = tconfig.build_featurizer_spec(cfg)
    out = {}
    for name, (impl, flat, state_flat) in runs.items():
        spec = dataclasses.replace(tconfig.build_model_spec(cfg), loss_impl=impl)
        m = from_flat(flat, state_flat, spec)
        layout = shard_params(m, mesh)
        opt = RecordingOptimizer(optim.make_optimizer(cfg.training, 100)[0])
        fn = step.make_train_step(spec, fspec, opt, "fp32", mesh=mesh)
        state = step.TrainState(m, opt.init(dict(m.named_parameters())), 0)
        metrics = []
        for batch in batches:
            rows = mesh.rows(batch["audio"].shape[0] // data)
            state, mt = fn(state, step.batch_to_device({k: v[rows] for k, v in batch.items()},
                                                        "cpu"), None)
            metrics.append({k: float(v) for k, v in mt.items()})
        params = dict(m.named_parameters())
        out[name] = dict(
            metrics=metrics, layout=layout,
            grads={k: g.numpy() for k, g in opt.grads.items()},
            params={k: v.numpy() for k, v in gather_params(m, mesh).items()},
            buffers={k: v.numpy().copy() for k, v in m.named_buffers()},
            digests=replica_digests(m, mesh),
            held={n: [tuple(params[n].shape), tuple(state.opt_state.mu[n].shape),
                      tuple(state.opt_state.nu[n].shape)] for n in layout})
    return dict(place=(mesh.data_rank, mesh.model_rank), runs=out)


class RecordingAugmentor:
    """The host recipe, recording each row it is given by its first
    samples' bytes (a row's key before augmentation)."""

    def __init__(self, inner):
        self.inner, self.keys = inner, []

    def __call__(self, audio, sample_rate, rng=None):
        self.keys.append(audio[:16].tobytes())
        return self.inner(audio, sample_rate, rng=rng)


def streamed_train_rank(overrides: list, output_base: str):
    """``train.loop.train`` of tiny_conv on the streamed path (the host
    recipe through a RecordingAugmentor) over this rank's data shard;
    returns the rows it augmented and the final WER."""
    from rnnt_tpu_torch.data.augment import default_augmentor
    from rnnt_tpu_torch.train import loop

    cfg, _, _ = _tiny_setup(overrides)
    rec = RecordingAugmentor(default_augmentor())
    wer = loop.train(cfg, output_base=output_base, device="cpu",
                     make_augmentor=lambda c: rec)
    return dict(rank=dist.get_rank(), keys=rec.keys, wer=wer)
