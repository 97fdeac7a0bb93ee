"""The port's multi-rank layer on the CPU, over gloo.

* ``make_mesh``: rank r at (r // model, r % model), its data and model
  groups, and the refusals;
* a 4-rank train step (dropout on) against the 1-rank step: the T-sharded
  loss on (data 2, model 2) and data parallelism on (data 4, model 1) with
  device augmentation and SpecAugment — every draw made at the global
  batch's shape — loss and gradient norms within 1e-5, updated parameters
  within 1e-4;
* ``cli.train`` through ``torch.distributed.run`` on 2 ranks: one
  metrics.jsonl, the 1-rank run's losses, and a resume from its checkpoint
  equal to the 1-rank resume;
* the guards: a rank without a card, ``lattice_shard_t`` without a model
  axis or with the pruned loss, a batch that does not split over the data
  axis, the chunked loss on a tensor-parallel mesh;
* ``CudaKernel.launch`` runs on its tensors' device and that device's
  stream.

Every multi-rank case runs in spawned processes with its own timeout
(tests/torch_ranks.py, or ``timeout=`` on the torchrun subprocess).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.cli import train as cli_train
from rnnt_tpu_torch.config import config as tconfig
from rnnt_tpu_torch.data.dataset import synthetic_piece_table
from rnnt_tpu_torch.ops import kernels
from rnnt_tpu_torch.parallel.mesh import make_mesh
from rnnt_tpu_torch.train import loop, step
from torch_ranks import RUN_TIMEOUT, flat_params, free_port, run_ranks, train_step_rank

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(synthetic_piece_table(255)))
    return path


def _overrides(vocab, *extra):
    """tiny_conv at test size, float32, dropout at the config's 0.1."""
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
            "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
            "training.precision=fp32", "training.global_batch_size=4",
            "training.frame_buckets=[96]", "training.token_buckets=[12]",
            "training.eval_max_elements=4", "data.dataset=synthetic",
            "data.synthetic_size=16", "data.synthetic_seconds=0.9",
            "data.synthetic_max_words=6", "training.log_steps=1",
            "training.lr_schedule.warmup_steps=2", *extra]


# --------------------------------- mesh ---------------------------------

def test_make_mesh_one_process_and_refusals():
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.world, mesh.rank) == (1, 1, 1, 0)
    assert mesh.rows(4) == slice(0, 4)
    for data, model in ((2, 1), (1, 2), (-1, 0)):
        with pytest.raises(ValueError, match="mesh"):
            make_mesh(data, model)


# ------------------------------ train step ------------------------------

def _first_batch(cfg):
    fspec = tconfig.build_featurizer_spec(cfg)
    return next(iter(loop.BatchIterator(
        loop._load_datasets(cfg)[0], loop._load_tokenizer(cfg),
        loop.Buckets.from_frames([96], [12], fspec), batch_size=4, shuffle=True,
        seed=0, wire_dtype="int16")))


@pytest.mark.parametrize("data,model,extra,device_augment,spec_augment", [
    (2, 2, ["training.loss_impl=chunked", "training.lattice_shard_t=true"], False, False),
    (4, 1, ["training.loss_impl=chunked"], "full", True),
], ids=["tshard-2x2", "data-parallel-4"])
def test_four_rank_train_step_matches_one_rank(vocab, data, model, extra,
                                               device_augment, spec_augment):
    ov = _overrides(vocab, *extra)
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config(
        "tiny_conv")), ov)
    batch = _first_batch(cfg)
    results = run_ranks(4, train_step_rank, data, model, ov, batch, device_augment,
                        spec_augment)
    for r, res in enumerate(results):
        d, m = r // model, r % model
        assert res["place"] == (d, m)
        assert res["groups"] == [[x * model + m for x in range(data)],
                                 [d * model + x for x in range(model)]]
    # 1 rank: the same step on the whole batch, in this process.
    spec = tconfig.build_model_spec(cfg)
    assert spec.lattice_shard_t == ("training.lattice_shard_t=true" in extra)
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.train import optim

    opt, _ = optim.make_optimizer(cfg.training, 10)
    fn = step.make_train_step(spec, tconfig.build_featurizer_spec(cfg), opt, "fp32",
                              spec_augment=spec_augment, device_augment=device_augment)
    mdl = rnnt_init(spec, seed=0)
    state, metrics = fn(step.TrainState(mdl, opt.init(dict(mdl.named_parameters())), 0),
                        step.batch_to_device(batch, "cpu"),
                        loop.step_generator(torch.device("cpu"), 0, 0))
    want = {k: float(v) for k, v in metrics.items()}
    assert want["grad_norm"] > 0
    want_params = flat_params({k: v.detach().numpy()
                               for k, v in state.model.named_parameters()})
    for res in results:
        assert set(res["metrics"]) == set(want)
        for k in want:
            np.testing.assert_allclose(res["metrics"][k], want[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(flat_params(res["params"]), want_params,
                                   rtol=1e-4, atol=1e-4)


# ------------------------------- cli.train -------------------------------

def _torchrun(n, args, timeout=RUN_TIMEOUT):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
         "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
         "-m", "rnnt_tpu_torch.cli.train", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _steps(run_dir):
    rows = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: (r["loss/train"], r["total_norm/train"])
            for r in rows if "loss/train" in r}, rows


def test_cli_train_two_ranks_and_resume(vocab, tmp_path):
    """2 data ranks (device augmentation and dropout on): rank 0 writes the
    one run directory, whose steps equal the 1-rank run's; resuming the
    2-rank run from its checkpoint takes the same step 3 as resuming it on
    1 rank.  A rank-0 save is a whole checkpoint: every parameter and
    moment is replicated."""
    base = ["--config", "tiny_conv", "--device", "cpu"]
    for o in _overrides(vocab, "training.loss_impl=chunked", "data.augment=true",
                        "data.augment_device=full"):
        base += ["--set", o]
    two, one = tmp_path / "two", tmp_path / "one"
    out = _torchrun(2, base + ["--output-base", str(two), "--max-steps", "2",
                               "--set", "mesh.data=2"])
    assert out.count("final wer:") == 1  # rank 0 prints
    assert [p.name for p in (two / "tiny_conv").iterdir()] == ["run-1"]
    cli_train.main(base + ["--output-base", str(one), "--max-steps", "2"])
    got, rows = _steps(two / "tiny_conv" / "run-1")
    want, _ = _steps(one / "tiny_conv" / "run-1")
    assert sorted(got) == [1, 2]
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5)
    assert all(r["launches_by_rank/alpha_fwd"] == [0, 0] for r in rows if "loss/train" in r)
    assert sum("wer/eval" in r for r in rows) == 1

    ckpt = two / "tiny_conv" / "run-1" / "checkpoint_step_2"
    resume = ["--max-steps", "3", "--resume", str(ckpt)]
    _torchrun(2, base + ["--output-base", str(two)] + resume + ["--set", "mesh.data=2"])
    cli_train.main(base + ["--output-base", str(one)] + resume)
    got, _ = _steps(two / "tiny_conv" / "run-2")
    want, _ = _steps(one / "tiny_conv" / "run-2")
    assert sorted(got) == sorted(want) == [3]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)


# --------------------------------- guards ---------------------------------

def test_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli_train.rank_device("cuda", 0, 2) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="wants card cuda:1"):
        cli_train.rank_device("cuda", 1, 2)
    assert cli_train.rank_device("cuda:0", 1, 2) == torch.device("cuda", 0)  # asked to share
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="need a card each"):
        cli_train.init_distributed(torch.device("cuda", 0), None, 1, 2)
    with pytest.raises(ValueError, match="needs CUDA"):
        cli_train.init_distributed(torch.device("cpu"), "nccl", 1, 2)


@pytest.mark.parametrize("extra,data,model,match", [
    (["training.lattice_shard_t=true"], 1, 1, "lattice_shard_t"),
    (["training.global_batch_size=6"], 4, 1, "does not divide"),
    (["training.loss_impl=chunked"], 1, 2, "no tensor-parallel joint"),
], ids=["shard-t-without-model-axis", "batch-over-data", "chunked-tensor-parallel"])
def test_check_mesh_refuses(vocab, extra, data, model, match):
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config(
        "tiny_conv")), _overrides(vocab, *extra))
    with pytest.raises(ValueError, match=match):
        tconfig.check_mesh(cfg, data, model)


def test_lattice_shard_t_refuses_pruned(vocab):
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config(
        "tiny_conv")), _overrides(vocab, "training.loss_impl=pruned",
                                  "training.lattice_shard_t=true"))
    with pytest.raises(ValueError, match="lattice_shard_t"):
        tconfig.build_model_spec(cfg)
    cfg.training.lattice_shard_t = False
    spec = tconfig.build_model_spec(cfg)
    import dataclasses

    with pytest.raises(ValueError, match="lattice_shard_t"):
        step.make_loss_fn(dataclasses.replace(spec, lattice_shard_t=True),
                          tconfig.build_featurizer_spec(cfg))


# ------------------------------ launch device ------------------------------

def test_launch_runs_on_the_tensors_device_and_stream(monkeypatch):
    """A launch makes its tensors' device current and passes that device's
    current stream, whatever device was current; tensors on two devices
    are refused."""
    seen = []

    class Stream:
        cuda_stream = 4242

    class DeviceGuard:
        def __init__(self, dev):
            seen.append(("current", dev))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def current_stream(dev=None):
        seen.append(("stream of", dev))
        return Stream()

    def fake_fn(*args):
        seen.append(("launched with stream", args[-1].value))
        return 0

    monkeypatch.setattr(torch.cuda, "device", DeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    k = kernels.CudaKernel.__new__(kernels.CudaKernel)
    k.name, k.launches, k._fn = "fake", 0, fake_fn
    x = torch.empty((2, 3), device="meta")
    k.launch(x, x, 7)
    assert seen == [("current", x.device), ("stream of", x.device),
                    ("launched with stream", 4242)]
    assert k.launches == 1
    with pytest.raises(ValueError, match="one CUDA device"):
        k.launch(x, torch.empty(3), 7)
