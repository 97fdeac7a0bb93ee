"""Checkpoint import into rnnt_tpu_torch, against rnnt_tpu on the CPU.

* ``compat/torch_import``: a reference-format state dict, written here
  with seeded numpy values under the reference's key names and shapes
  (``AudioEncoder``'s flat ``blocks`` Sequential, ``ConvPredictor`` /
  ``LSTMPredictor``, ``JointNetwork``; DDP's ``module.`` prefix inside the
  ``save_model`` wrapper), goes through rnnt_tpu's
  ``import_reference_state_dict`` and the port's: the flat trees are
  bit-equal for every norm type and both predictors, and the imported
  models' logits agree within 1e-5 of their scale.
* ``cli.import_torch`` then ``cli.eval --device cpu``: the step is the
  .pt's ``completed_steps``, the pruned loss's simple heads are the
  port's fresh ones (a deliberate divergence: JAX draws them from
  ``PRNGKey(0)``), and ``cli.train --resume`` takes its first step at
  ``completed_steps + 1``.
* ``scripts/jax_checkpoint_to_torch.py``: an orbax checkpoint of a JAX
  ``TrainState`` with nonzero moments; ``train/checkpoint.restore`` of the
  converted checkpoint gives the parameters, batch-norm statistics, ``mu``,
  ``nu``, count and step bit-equal to JAX's.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.compat import torch_import as jimport  # noqa: E402
from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.models import joint as jjoint  # noqa: E402
from rnnt_tpu.models import rnnt as jrnnt  # noqa: E402
from rnnt_tpu.train import checkpoint as jckpt  # noqa: E402
from rnnt_tpu.train.optim import make_optimizer as jmake_optimizer  # noqa: E402
from rnnt_tpu.train.step import TrainState as JTrainState  # noqa: E402
from rnnt_tpu_torch.cli import eval as cli_eval  # noqa: E402
from rnnt_tpu_torch.cli import import_torch as cli_import  # noqa: E402
from rnnt_tpu_torch.cli import train as cli_train  # noqa: E402
from rnnt_tpu_torch.compat import torch_import as timport  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import flatten_tree, from_flat, to_jax  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.models import rnnt as trnnt  # noqa: E402
from rnnt_tpu_torch.models.rnnt import rnnt_init  # noqa: E402
from rnnt_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from reference_checkpoint import reference_state_dict  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# tiny_conv (instance_affine) and its variants: every norm type, the
# layer-normed LSTM predictor and the LSTM without layer norm.
LSTM = ["predictor.kind=lstm", "predictor.lstm_hidden_dim=32", "predictor.num_lstm_layers=2"]
CASES = {
    "tiny_conv": [],
    "batch_norm": ["encoder.norm_type=batch"],
    "instance_norm": ["encoder.norm_type=instance"],
    "lstm": LSTM,
    "lstm_no_layer_norm": LSTM + ["predictor.lstm_layer_norm=false"],
}


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(synthetic_piece_table()))
    return path


def _overrides(vocab, case):
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}", *CASES[case]]


def _configs(vocab, case, extra=()):
    """(JAX config, port config) of tiny_conv with the case's overrides."""
    ov = _overrides(vocab, case) + list(extra)
    jcfg = jconfig.load_config(tconfig.resolve_config("tiny_conv"))
    jconfig.apply_overrides(jcfg, ov)
    tcfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")), ov)
    return jcfg, tcfg


def _jax_flat(sd, jspec):
    params, state = jimport.import_reference_state_dict(sd, jspec)
    return (flatten_tree(jax.tree.map(np.asarray, params)),
            flatten_tree(jax.tree.map(np.asarray, state)))


@pytest.mark.parametrize("case", list(CASES))
def test_flat_tree_bit_equal_to_jax(vocab, case):
    jcfg, tcfg = _configs(vocab, case)
    jspec, tspec = jconfig.build_model_spec(jcfg), tconfig.build_model_spec(tcfg)
    sd = reference_state_dict(tspec, seed=len(case))
    want_p, want_s = _jax_flat(sd, jspec)
    got_p, got_s = timport.import_reference_state_dict(sd, tspec)
    assert bool(want_s) == (case == "batch_norm")
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # The bare state dict (no wrapper, no prefix) imports the same.
    bare = {k.removeprefix("module."): v for k, v in sd["model_state_dict"].items()}
    for a, b in zip(timport.import_reference_state_dict(bare, tspec), (got_p, got_s)):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["tiny_conv", "batch_norm", "lstm"])
def test_imported_logits_match_jax(vocab, case):
    jcfg, tcfg = _configs(vocab, case)
    jspec, tspec = jconfig.build_model_spec(jcfg), tconfig.build_model_spec(tcfg)
    sd = reference_state_dict(tspec, seed=3)
    model = from_flat(*timport.import_reference_state_dict(sd, tspec), tspec)
    jparams, jstate = jimport.import_reference_state_dict(sd, jspec)
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 48, 201).astype(np.float32)
    targets = rng.randint(0, 1023, (2, 5)).astype(np.int32)
    audio, text, _ = jrnnt.rnnt_forward(jparams, jstate, jnp.asarray(feats), jspec,
                                        jnp.asarray(targets))
    want = np.asarray(jjoint.joint_apply(jparams["joint"], audio, text))
    with torch.no_grad():
        a, t, _ = trnnt.rnnt_forward(model, torch.from_numpy(feats), torch.from_numpy(targets))
        got = tjoint.joint_apply(model.joint, a, t).numpy()
    assert got.shape == want.shape == (2, 24, 6, 1024)
    err, scale = np.abs(got - want).max(), max(1.0, float(np.abs(want).max()))
    assert err <= 1e-5 * scale, (err, scale)


TRAIN_TINY = ["training.global_batch_size=2", "training.precision=fp32",
              "data.synthetic_size=8", "data.synthetic_seconds=1",
              "training.frame_buckets=[128]", "training.token_buckets=[32]",
              "training.eval_max_elements=2", "training.log_steps=1"]


@pytest.fixture(scope="module")
def imported(vocab, tmp_path_factory):
    """cli.import_torch on a reference checkpoint of tiny_conv under the
    pruned loss: (output base, checkpoint directory, printed text)."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("import")
    _, tcfg = _configs(vocab, "tiny_conv")
    pt = root / "checkpoint_step_685656.pt"
    sd = reference_state_dict(tconfig.build_model_spec(tcfg), seed=11)
    sd["completed_steps"] = 5
    torch.save(sd, pt)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = cli_import.main([str(pt), str(root / "out"), "--config", "tiny_conv",
                                "--device", "cpu", "--set", "training.loss_impl=pruned",
                                *[f"--set={o}" for o in _overrides(vocab, "tiny_conv")
                                  + TRAIN_TINY]])
    return root / "out", path, out.getvalue(), sd


def test_import_cli_writes_a_checkpoint_at_completed_steps(imported):
    out, path, printed, sd = imported
    assert path == out / "checkpoint_step_5"
    assert (out / "config.yaml").exists() and (path / "config.yaml").exists()
    assert "initialized fresh pruned-loss simple heads" in printed
    assert "imported" in printed and str(path) in printed
    cfg = tconfig.load_config(path / "config.yaml")
    spec = tconfig.build_model_spec(cfg)
    model = rnnt_init(spec, seed=9)
    opt_state, step = tckpt.restore(path, model)
    assert step == 5 and opt_state.count == 0
    assert all(not v.any() for v in opt_state.mu.values())
    # The imported weights, and the port's fresh simple heads (seed 0).
    got = flatten_tree(to_jax(model)[0])
    want, _ = timport.import_reference_state_dict(sd, spec)
    want.update(cli_import.fresh_simple_heads(spec))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_import_then_eval_cli(imported, capsys):
    _, path, _, _ = imported
    res = cli_eval.main([str(path), "--device", "cpu", "--batch-size", "2",
                         "--max-elements", "4"])
    assert "WER:" in capsys.readouterr().out
    assert res["utterances"] > 0 and np.isfinite(res["wer"])


def test_resume_after_import_counts_on(imported, tmp_path, capsys):
    out, path, _, _ = imported
    cli_train.main(["--config", str(out / "config.yaml"), "--resume", str(path),
                    "--max-steps", "6", "--device", "cpu",
                    "--output-base", str(tmp_path)])
    printed = capsys.readouterr().out
    assert f"Resumed from {path} at step 5" in printed
    run = next((tmp_path / "tiny_conv").iterdir())
    steps = [json.loads(ln)["step"] for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert steps and min(steps) == 6
    assert (run / "checkpoint_step_6").exists()


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "scripts" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_checkpoint_converts_bit_equal(vocab, tmp_path):
    """A JAX TrainState (batch-norm model, nonzero moments, count 3, step
    7) through orbax and the converter: the port restores it bit-equal."""
    jcfg, tcfg = _configs(vocab, "batch_norm")
    jspec = jconfig.build_model_spec(jcfg)
    params, state = jrnnt.rnnt_init(jax.random.PRNGKey(2), jspec)
    rng = np.random.RandomState(6)
    state = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype), state)
    tx, _ = jmake_optimizer(jcfg.training, 10)
    opt = tx.init(params)
    adam = opt[1][0]._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32), params),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape), jnp.float32), params))
    opt = (opt[0], (adam,) + tuple(opt[1][1:]))
    run = tmp_path / "jax_run"
    jckpt.save_checkpoint(run, JTrainState(params, opt, state, jnp.asarray(7, jnp.int32)),
                          jcfg, wait=True)

    path = _converter().convert(jckpt.checkpoint_dir(run, 7), tmp_path / "port")
    assert path == tmp_path / "port" / "checkpoint_step_7"
    assert (tmp_path / "port" / "config.yaml").exists()
    model = rnnt_init(tconfig.build_model_spec(tcfg), seed=4)
    opt_state, step = tckpt.restore(path, model)
    assert step == 7 and opt_state.count == 3
    got_p, got_s = (flatten_tree(t) for t in to_jax(model))
    for got, want in ((got_p, params), (got_s, state),
                      ({k.replace(".", "/"): v.numpy() for k, v in opt_state.mu.items()},
                       adam.mu),
                      ({k.replace(".", "/"): v.numpy() for k, v in opt_state.nu.items()},
                       adam.nu)):
        want = flatten_tree(jax.tree.map(np.asarray, want))
        assert want and sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
