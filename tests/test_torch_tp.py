"""The port's tensor-parallel layer and data-group batch norm on the CPU,
against rnnt_tpu and against the port's own 1-rank step.

* K1 and K2's plain versions with ``v0`` on two vocabulary slices (the
  blank on one, label 0 on the other) merge to the whole-V outputs and
  gradients, atol 1e-6;
* the sharded parameter names and shard shapes equal
  ``rnnt_tpu.parallel.mesh.param_shardings`` on a (4, 2) CPU mesh, for
  scaled_tp's and base_convjs's specs at small width, with leaves that do
  not divide;
* 4 gloo ranks at data 2 x model 2 (tests/torch_ranks.py) against JAX's
  jitted step on the (2, 2) CPU mesh for ``pallas``, ``pruned`` (band 8:
  the port rounds a band up to a multiple of 8, as the reference's fused
  path does, where JAX's CPU path keeps 4), ``pruned_warmup`` and
  ``chunked`` (the chunked joint on V slices), 2 steps
  of 8 targets (a lattice of 17 columns): loss and gradient norms within 1e-4 relative, the
  gathered parameters within 1e-4 (relative and absolute); against the
  port's 1-rank step, metrics within 1e-5 relative and parameters within
  1e-4, as tests/test_torch_distributed.py holds them; each rank
  holds ``joint.out.w``, the simple heads and their moments at V / 2 and
  ``encoder.out.w`` / ``predictor.linear.w`` at H / 2, and every rank's
  replicated parameters are bit-equal after the steps; a blank outside
  the vocabulary raises, whole or sliced;
* batch norm over the data group: 2 data ranks against JAX on a (2, 1)
  mesh and against 1 rank — loss, gradients and the new running
  statistics;
* ``cli.train`` on 2 tensor-parallel ranks saves a whole checkpoint that a
  1-rank ``cli.eval`` reads (after it found every rank's replicated
  parameters bit-equal), and a resume continues the straight run's
  loss (the loop starts a resumed run's data at epoch 0, as the
  reference's does, so the corpus there is one batch).

The model is test_train_sharding.py's tiny configuration (no Jasper
blocks, H = 64, V = 1024, fp32, no dropout); every side starts from one
seed's numpy weights (JAX's ``rnnt_init``, carried by ``compat``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.models.rnnt import rnnt_init as jrnnt_init  # noqa: E402
from rnnt_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from rnnt_tpu.parallel.mesh import param_shardings  # noqa: E402
from rnnt_tpu.train import optim as joptim  # noqa: E402
from rnnt_tpu.train import step as jstep  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import flatten_tree, from_jax  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.ops.transducer_pallas import (  # noqa: E402
    fused_joint_bwd_plain, fused_joint_outputs_plain)
from rnnt_tpu_torch.parallel.mesh import Mesh, shard_params  # noqa: E402
from torch_ranks import RUN_TIMEOUT, free_port, mesh_train_rank, run_ranks  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL_JAX = 1e-4
IMPLS = ("pallas", "pruned", "pruned_warmup", "chunked")


# --------------------------- K1 / K2 on V slices ---------------------------

@pytest.mark.parametrize("clamp", [-1.0, 0.01], ids=["clamp-off", "clamp-0.01"])
def test_plain_slices_merge_to_whole_vocabulary(clamp):
    """Two slices of V = 48 at v0 = 0 and 24: blank 47 on the second,
    every last column's label 0 on the first; lse merged by logsumexp,
    blank and label summed; K2 on each slice with the merged lse gives
    denc and dpred that sum, and dW, db that concatenate, to the whole."""
    rng = np.random.RandomState(3)
    B, T, U1, H, V = 2, 5, 4, 16, 48
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    enc, pred, w, b = t(B, T, H) * 0.5, t(B, U1, H) * 0.5, t(H, V) / 4, t(V) * 0.1
    labels = torch.from_numpy(rng.randint(0, V - 1, (B, U1)).astype(np.int32))
    labels[:, -1] = 0
    labels[0, 0] = 30  # a label on the second slice too
    blank = V - 1
    whole = fused_joint_outputs_plain(enc, pred, w, b, labels, blank)
    halves = [(v0, fused_joint_outputs_plain(enc, pred, w[:, v0:v0 + 24], b[v0:v0 + 24],
                                             labels, blank, v0)) for v0 in (0, 24)]
    assert torch.equal(halves[0][1][1], torch.zeros_like(whole[1]))   # no blank on 0
    assert torch.all(halves[1][1][2][:, :, -1] == 0)                  # no label 0 on 1
    lse = torch.logsumexp(torch.stack([h[1][0] for h in halves]), dim=0)
    np.testing.assert_allclose(lse, whole[0], atol=1e-6)
    for i in (1, 2):
        np.testing.assert_allclose(halves[0][1][i] + halves[1][1][i], whole[i], atol=1e-6)

    g = [t(B, T, U1) * 0.3 for _ in range(3)]
    want = fused_joint_bwd_plain(enc, pred, w, b, labels, blank, whole[0], *g, clamp)
    parts = [fused_joint_bwd_plain(enc, pred, w[:, v0:v0 + 24], b[v0:v0 + 24], labels,
                                   blank, lse, *g, clamp, v0) for v0 in (0, 24)]
    np.testing.assert_allclose(parts[0][0] + parts[1][0], want[0], atol=1e-6)
    np.testing.assert_allclose(parts[0][1] + parts[1][1], want[1], atol=1e-6)
    np.testing.assert_allclose(torch.cat([p[2] for p in parts], 1), want[2], atol=1e-6)
    np.testing.assert_allclose(torch.cat([p[3] for p in parts]), want[3], atol=1e-6)


# ------------------------------ the TP rules ------------------------------

def _small(cfg, H=64, V=None):
    """A config of either package cut to a small width in place."""
    blk = cfg.encoder.blocks[0]
    cfg.encoder.blocks = [blk]
    blk.in_channels = blk.out_channels = 16
    blk.num_sub_blocks, blk.kernel_size = 1, 3
    cfg.encoder.epilogue_features, cfg.encoder.epilogue_kernel_size = 16, 3
    cfg.encoder.output_features = cfg.predictor.output_dim = cfg.joint.hidden_features = H
    cfg.predictor.symbol_embedding_dim = 16
    if V is not None:
        cfg.num_total_symbols, cfg.num_text_tokens, cfg.blank_idx = V, V - 1, V - 1
    return cfg


@pytest.mark.parametrize("config,H,V", [
    ("scaled_tp", 64, 1024), ("base_convjs", 64, 1024),
    ("scaled_tp", 63, 1024),    # H does not divide: encoder.out, predictor.linear whole
    ("base_convjs", 64, 255),   # V does not divide: joint.out and the heads whole
], ids=["scaled_tp", "base_convjs", "scaled_tp-odd-H", "base_convjs-odd-V"])
def test_sharded_layout_matches_jax(config, H, V):
    path = tconfig.resolve_config(config)
    jcfg = _small(jconfig.load_config(path), H, V)
    tcfg = _small(tconfig.load_config(path), H, V)
    params, state = jax.tree.map(np.asarray, jrnnt_init(
        jax.random.PRNGKey(0), jconfig.build_model_spec(jcfg)))
    shardings = param_shardings(jmake_mesh(4, 2), params)
    want = {}
    for (path, leaf), sh in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves(shardings)):
        if any(d is not None for d in sh.spec):
            name = ".".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)
            want[name] = tuple(sh.shard_shape(leaf.shape))
    model = from_jax(params, state, tconfig.build_model_spec(tcfg))
    layout = shard_params(model, Mesh(data=4, model=2, rank=1))
    got = {n: tuple(p.shape) for n, p in model.named_parameters() if n in layout}
    assert got == want
    assert ("joint.out.w" in got) == (V % 2 == 0)
    assert ("encoder.out.w" in got) == (H % 2 == 0)
    assert ("joint.simple.am.w" in got) == (config == "base_convjs" and V % 2 == 0)


# --------------------------- the sharded train step ---------------------------

def _tiny(cfg, loss_impl="pallas"):
    """test_train_sharding.py's tiny configuration, on either package."""
    cfg.encoder.input_features = 201
    cfg.encoder.blocks = []
    cfg.encoder.epilogue_features = 32
    cfg.encoder.output_features = cfg.predictor.output_dim = cfg.joint.hidden_features = 64
    cfg.predictor.symbol_embedding_dim = 32
    cfg.predictor.dropout = 0.0
    cfg.training.loss_chunk_size = 8
    cfg.training.precision = "fp32"
    cfg.training.loss_impl = loss_impl
    cfg.training.pruned_band = 8
    return cfg


def _batch(fspec, B, seed, seconds=0.5, U=16, vocab=1024):
    rng = np.random.RandomState(seed)
    frames = fspec.num_frames(int(seconds * fspec.sample_rate))
    samples = fspec.win_length + (frames - 1) * fspec.hop_length
    return {"audio": rng.randn(B, samples).astype(np.float32) * 0.1,
            "audio_lens": np.full((B,), samples, np.int32),
            "targets": rng.randint(0, vocab - 1, size=(B, U)).astype(np.int32),
            "target_lens": np.full((B,), U // 2, np.int32)}


def _jax_sharded(batch, mesh):
    return {k: jax.device_put(v, NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))))
            for k, v in batch.items()}


def _init(impl, norm_type=None):
    """(JAX config, numpy params, state) of the tiny model for ``impl``
    (the pruned objectives carry the simple heads)."""
    cfg = _tiny(jconfig.Config(), "pruned" if impl.startswith("pruned") else impl)
    if norm_type:
        cfg.encoder.norm_type = norm_type
    spec = jconfig.build_model_spec(cfg)
    params, state = jax.tree.map(np.asarray, jrnnt_init(jax.random.PRNGKey(0), spec))
    return cfg, params, state


def _jax_steps(impl, params, state, batches, mesh_shape):
    """JAX's jitted step, params placed by ``param_shardings``: per-step
    metrics and the final params."""
    cfg = _init(impl)[0]
    spec = dataclasses.replace(jconfig.build_model_spec(cfg), loss_impl=impl)
    fspec = jconfig.build_featurizer_spec(cfg)
    mesh = jmake_mesh(*mesh_shape)
    tx, _ = joptim.make_optimizer(cfg.training, total_steps=100)
    p = jax.device_put(params, param_shardings(mesh, params))
    st = jstep.TrainState(p, jax.jit(tx.init)(p), state, jnp.zeros((), jnp.int32))
    fn = jax.jit(jstep.make_train_step(spec, fspec, tx, "fp32"))
    metrics = []
    for b in batches:
        st, m = fn(st, _jax_sharded(b, mesh), jax.random.PRNGKey(7))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k.replace("/", "."): v for k, v in
                     flatten_tree(jax.tree.map(np.asarray, st.params)).items()}


@pytest.fixture(scope="module")
def tp_runs():
    """The four objectives on 4 ranks (data 2 x model 2), on 1 rank in
    this process and in JAX on the (2, 2) mesh, 2 steps of batch 4."""
    tcfg = _tiny(tconfig.Config())
    fspec = tconfig.build_featurizer_spec(tcfg)
    batches = [_batch(fspec, 4, seed) for seed in range(2)]
    runs, jax_out = {}, {}
    for impl in IMPLS:
        _, params, state = _init(impl)
        runs[impl] = (impl, flatten_tree(params), flatten_tree(state))
        jax_out[impl] = _jax_steps(impl, params, state, batches, (2, 2))
    four = run_ranks(4, mesh_train_rank, 2, 2, tcfg, runs, batches)
    one = mesh_train_rank(1, 1, tcfg, runs, batches)
    return dict(four=four, one=one["runs"], jax=jax_out)


def _params_close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_tp_step_matches_jax(tp_runs, impl):
    want_metrics, want_params = tp_runs["jax"][impl]
    for res in tp_runs["four"]:
        run = res["runs"][impl]
        for got, want in zip(run["metrics"], want_metrics):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL_JAX, err_msg=k)
        _params_close(run["params"], want_params, RTOL_JAX)


@pytest.mark.parametrize("impl", IMPLS)
def test_tp_step_matches_one_rank(tp_runs, impl):
    one = tp_runs["one"][impl]
    assert one["layout"] == {}
    for res in tp_runs["four"]:
        run = res["runs"][impl]
        for got, want in zip(run["metrics"], one["metrics"]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        _params_close(run["params"], one["params"], 1e-4)


def test_tp_ranks_hold_their_shards(tp_runs):
    """Each rank holds V / 2 of joint.out and the heads, H / 2 of
    encoder.out and predictor.linear, and moments of its shards' shapes."""
    places = sorted(r["place"] for r in tp_runs["four"])
    assert places == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in tp_runs["four"]:
        for impl in IMPLS:
            held = res["runs"][impl]["held"]
            want = {"joint.out.w": (64, 512), "joint.out.b": (512,),
                    "encoder.out.w": (32, 32), "encoder.out.b": (32,),
                    "predictor.linear.w": (32, 32), "predictor.linear.b": (32,)}
            if impl.startswith("pruned"):
                want.update({f"joint.simple.{h}.{p}": s for h in ("am", "lm")
                             for p, s in (("w", (64, 512)), ("b", (512,)))})
            assert held == {n: [s, s, s] for n, s in want.items()}


def test_tp_replicas_stay_bit_equal(tp_runs):
    """The replicated parameters (encoder body, predictor, norms) are
    bit-equal on all 4 ranks after the 2 steps: each rank's digest of
    them, gathered over the world, is one value."""
    for res in tp_runs["four"]:
        for impl in IMPLS:
            digests = res["runs"][impl]["digests"]
            assert len(digests) == 4 and len(set(digests)) == 1, (impl, digests)


@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "slice"])
def test_blank_outside_vocabulary_raises(sharded):
    """A blank id outside [0, V) of the whole vocabulary raises, on the
    whole joint and on a rank's slice (V / 2 wide at model rank 1: the
    check runs before any collective)."""
    from rnnt_tpu_torch.ops.transducer_pallas import fused_joint_outputs

    g = torch.Generator().manual_seed(0)
    enc, pred = torch.randn(1, 3, 8, generator=g), torch.randn(1, 2, 8, generator=g)
    labels = torch.zeros(1, 2, dtype=torch.int32)
    mesh = Mesh(data=1, model=2, rank=1) if sharded else None
    V = 6
    held = V // 2 if sharded else V
    w, b = torch.randn(8, held, generator=g), torch.zeros(held)
    for blank in (V, -1):
        with pytest.raises(ValueError, match="outside the vocabulary"):
            fused_joint_outputs(enc, pred, w, b, labels, blank, mesh=mesh)
    if not sharded:
        assert fused_joint_outputs(enc, pred, w, b, labels, V - 1)[0].shape == (1, 3, 2)


# ------------------------ batch norm over the data group ------------------------

def test_batch_norm_over_data_group_matches_jax_and_one_rank():
    """tiny with batch norms, 2 data ranks: the loss, the gradients (the
    step's, averaged over the data group) and the new running statistics
    against JAX's jitted loss on a (2, 1) mesh and against 1 rank."""
    jcfg, params, state = _init("pallas", norm_type="batch")
    # Running statistics away from their (0, 1) start.
    rng = np.random.RandomState(5)
    state = jax.tree.map(lambda x: (rng.rand(*x.shape) + 0.5).astype(np.float32), state)
    tcfg = _tiny(tconfig.Config())
    tcfg.encoder.norm_type = "batch"
    fspec = tconfig.build_featurizer_spec(tcfg)
    batch = _batch(fspec, 4, 0)

    spec = jconfig.build_model_spec(jcfg)
    mesh = jmake_mesh(2, 1)
    loss_fn = jstep.make_loss_fn(spec, jconfig.build_featurizer_spec(jcfg), "fp32")
    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, state, _jax_sharded(batch, mesh), None, True), has_aux=True))(
        jax.device_put(params, param_shardings(mesh, params)))
    want_grads = {k.replace("/", "."): v for k, v in
                  flatten_tree(jax.tree.map(np.asarray, grads)).items()}
    want_state = flatten_tree(jax.tree.map(np.asarray, new_state))

    runs = {"bn": ("pallas", flatten_tree(params), flatten_tree(state))}
    two = run_ranks(2, mesh_train_rank, 2, 1, tcfg, runs, [batch])
    one = mesh_train_rank(1, 1, tcfg, runs, [batch])["runs"]["bn"]
    for res in two:
        run = res["runs"]["bn"]
        np.testing.assert_allclose(run["metrics"][0]["loss"], float(loss), rtol=RTOL_JAX)
        _params_close(run["grads"], want_grads, RTOL_JAX)
        buffers = {k: v for k, v in run["buffers"].items()}
        assert len(buffers) == len(want_state) == 4
        for k, v in want_state.items():  # encoder/prologue/mean -> encoder.prologue.norm.mean
            got = buffers[k.replace("/", ".").replace("logue.", "logue.norm.")]
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6, err_msg=k)
        for k in one["metrics"][0]:
            np.testing.assert_allclose(run["metrics"][0][k], one["metrics"][0][k],
                                       rtol=1e-5, err_msg=k)
        _params_close(run["grads"], one["grads"], 1e-5)
        for k in one["buffers"]:
            np.testing.assert_allclose(buffers[k], one["buffers"][k], rtol=1e-5, err_msg=k)
        _params_close(run["params"], one["params"], 1e-4)


# ------------------------------ cli.train on 2 ranks ------------------------------

def _torchrun(n, args):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
         "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
         "-m", "rnnt_tpu_torch.cli.train", *args],
        capture_output=True, text=True, timeout=RUN_TIMEOUT, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _losses(run_dir):
    rows = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: (r["loss/train"], r["total_norm/train"]) for r in rows
            if "loss/train" in r}


def test_cli_train_tp_saves_whole_checkpoint_eval_and_resume(tmp_path):
    """tiny_conv without dropout (V = 256, H = 256) on 2 model ranks with
    the pruned loss (1 warmup step), a corpus of one batch so that every
    epoch takes the same rows: the checkpoint holds the whole joint and
    moments, a 1-rank cli.eval reads it, and resuming from step 2 (whose
    first batch is again those rows) takes the straight run's step 3."""
    from rnnt_tpu_torch.cli import eval as cli_eval

    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table(255)))
    config = tmp_path / "tiny_conv.yaml"
    config.write_text((tconfig.CONFIG_DIR / "tiny_conv.yaml").read_text().replace(
        "dropout: 0.1", "dropout: 0.0"))
    args = ["--config", str(config), "--device", "cpu", "--output-base", str(tmp_path / "exp")]
    for o in ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
              "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
              "training.precision=fp32", "training.global_batch_size=4",
              "training.frame_buckets=[96]", "training.token_buckets=[12]",
              "training.eval_max_elements=4", "data.dataset=synthetic",
              "data.synthetic_size=4", "data.synthetic_seconds=0.9",
              "data.synthetic_max_words=6", "training.log_steps=1",
              "training.num_epochs=3", "training.lr_schedule.warmup_steps=2",
              "training.loss_impl=pruned", "training.pruned_warmup_steps=1",
              "training.pruned_band=8", "training.checkpoint_steps=2", "mesh.data=1",
              "mesh.model=2"]:
        args += ["--set", o]
    out = _torchrun(2, args + ["--max-steps", "3"])
    assert "tensor parallel over 2 model ranks: 10 tensors sharded" in out
    assert "replicated parameters bit-equal on the 2 ranks at step 3" in out
    run = tmp_path / "exp" / "tiny_conv" / "run-1"
    straight = _losses(run)
    assert sorted(straight) == [1, 2, 3]
    with np.load(run / "checkpoint_step_3" / "params.npz") as z:
        assert z["params/joint/out/w"].shape == (256, 256)
        assert z["params/encoder/out/w"].shape == (128, 256)
    with np.load(run / "checkpoint_step_3" / "opt_state.npz") as z:
        assert z["mu/joint/simple/am/w"].shape == z["nu/joint/out/w"].shape == (256, 256)
    res = cli_eval.main([str(run / "checkpoint_step_3"), "--device", "cpu"])
    assert res["utterances"] > 0 and np.isfinite(res["wer"])

    _torchrun(2, args + ["--max-steps", "3", "--resume", str(run / "checkpoint_step_2")])
    resumed = _losses(tmp_path / "exp" / "tiny_conv" / "run-2")
    assert sorted(resumed) == [3]
    np.testing.assert_allclose(resumed[3], straight[3], rtol=1e-5)
