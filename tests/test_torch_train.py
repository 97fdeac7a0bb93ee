"""The port's training slice against rnnt_tpu, fp32 on the CPU.

* the optimizer against optax ``chain(clip_by_global_norm, adamw)``, its
  schedule and ``MultiSteps`` accumulation;
* train-mode batch norm against ``norm_apply(..., training=True)``;
* dropout's keep share and mean (its bits cannot equal JAX's);
* the train step against JAX's over 5 batches for the chunked, fused
  (plain kernels; JAX in interpret mode) and pruned-with-warmup losses;
* a run carried from JAX (params and optimizer state) continuing in the
  port, and the port's own checkpoint resume (augmentation on);
* one train step with device augmentation (``full``) and SpecAugment
  against JAX's, JAX's draws fed to the port's draw functions;
* ``train()`` with the flagship's data settings (``augment: true``,
  ``augment_device: full``, ``staging: auto``) taking JAX's cached batch
  order;
* ``cli.train --device cpu`` writing a checkpoint that ``cli.eval`` reads.

The model is tiny_conv with a 255-piece vocabulary (V = 256) and every
dropout rate 0 for the comparisons with JAX.  Tolerances: per-step loss and
gradient norms within 1e-4 relative; parameters after the steps within
5e-3 of the total update, in L2 norm.  Adam divides each moment by the
root of the second one, so an entry whose gradient is round-off moves by
up to the learning rate in a direction the round-off picks, in either
package: the conv biases in front of instance norms have a zero gradient
in exact arithmetic, and they alone make ~8e-4 of the total update here
(measured on this test's batches: ~1.2e-3 in all, ~3e-4 without them).
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.models.rnnt import rnnt_init as jrnnt_init  # noqa: E402
from rnnt_tpu.ops import norm as jnorm  # noqa: E402
from rnnt_tpu.train import optim as joptim  # noqa: E402
from rnnt_tpu.train import step as jstep  # noqa: E402
from rnnt_tpu_torch.cli import eval as tcli_eval  # noqa: E402
from rnnt_tpu_torch.cli import train as tcli_train  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import (  # noqa: E402
    flatten_tree, from_jax, opt_state_from_jax, opt_state_to_jax, to_jax)
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.models.encoder import dropout  # noqa: E402
from rnnt_tpu_torch.models.rnnt import rnnt_init  # noqa: E402
from rnnt_tpu_torch.ops import norm as tnorm  # noqa: E402
from rnnt_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402
from rnnt_tpu_torch.train import optim as toptim  # noqa: E402
from rnnt_tpu_torch.train import step as tstep  # noqa: E402

RTOL = 1e-4
PARAM_TOL = 5e-3
N_STEPS = 5


# ------------------------------ optimizer ------------------------------

def _tc(**kw):
    tc = jconfig.TrainingConfig(clip_grad_norm=kw.pop("clip", 1.0), **kw)
    tc.lr_schedule = jconfig.LRScheduleConfig(warmup_steps=3, min_lr_ratio=0.05)
    tc.optimizer = jconfig.OptimizerConfig(lr=1e-2, betas=(0.9, 0.99),
                                           weight_decay=0.01)
    return tc


@pytest.mark.parametrize("accumulate,clip", [(1, 1.0), (1, 1e3), (2, 1.0)],
                         ids=["clip", "no-clip", "accumulate2"])
def test_optimizer_matches_optax(accumulate, clip):
    """Params after 6 calls on the same random gradients: the clip (which
    triggers at max_norm 1), the warmup-cosine schedule with its +1 offset
    and floor, and MultiSteps(2)."""
    rng = np.random.RandomState(accumulate)
    params = {"a": rng.randn(7, 5).astype(np.float32),
              "b": {"c": rng.randn(3).astype(np.float32)}}
    tc = _tc(clip=clip, accumulate_steps=accumulate)
    tx, _ = joptim.make_optimizer(tc, total_steps=8)
    jp, js = params, tx.init(params)
    opt, _ = toptim.make_optimizer(tconfig.TrainingConfig(
        clip_grad_norm=clip, accumulate_steps=accumulate,
        optimizer=tconfig.OptimizerConfig(lr=1e-2, betas=(0.9, 0.99),
                                          weight_decay=0.01),
        lr_schedule=tconfig.LRScheduleConfig(warmup_steps=3, min_lr_ratio=0.05)),
        total_steps=8)
    tp = {k.replace("/", "."): torch.tensor(v) for k, v in flatten_tree(params).items()}
    ts = opt.init(tp)
    for _ in range(6):
        g = jax.tree.map(lambda x: (rng.randn(*x.shape) * 2).astype(np.float32), params)
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update(tp, {k.replace("/", "."): torch.tensor(v)
                             for k, v in flatten_tree(g).items()}, ts)
    for k, v in flatten_tree(jp).items():
        np.testing.assert_allclose(tp[k.replace("/", ".")].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-7)
    assert ts.count == 6 // accumulate


def test_schedule_matches_jax():
    want = joptim.warmup_cosine_schedule(3e-4, 10, 50, 0.05)
    got = toptim.warmup_cosine_schedule(3e-4, 10, 50, 0.05)
    for s in (0, 1, 8, 9, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)


# --------------------------- norm and dropout ---------------------------

def test_batch_norm_train_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 11, 6).astype(np.float32) * 2 + 1
    scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
    mean, var = rng.randn(6).astype(np.float32), rng.rand(6).astype(np.float32) + 0.5
    want, ws = jnorm.norm_apply({"scale": scale, "bias": bias},
                                {"mean": mean, "var": var}, jnp.asarray(x),
                                "batch", True)
    norm = tnorm.Norm(6, "batch")
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in
                          dict(scale=scale, bias=bias, mean=mean, var=var).items()})
    norm.state_key = "n"
    new = {}
    got = norm(torch.from_numpy(x), training=True, new_state=new)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new["n.mean"].numpy(), np.asarray(ws["mean"]), rtol=1e-5)
    np.testing.assert_allclose(new["n.var"].numpy(), np.asarray(ws["var"]), rtol=1e-5)
    assert torch.equal(norm.mean, torch.from_numpy(mean))  # returned, not written


def test_dropout_keep_share_and_mean():
    """Keep share near thresh / 65536 and E[y] = x (the mask's bits cannot
    equal JAX's): 2^20 draws, 6 standard errors."""
    x = torch.full((1 << 20,), 2.0)
    g = torch.Generator().manual_seed(0)
    for rate in (0.1, 0.3):
        thresh = int(round((1 - rate) * 65536))
        y = dropout(x, rate, True, g)
        keep = float((y != 0).float().mean())
        se = (thresh / 65536 * (1 - thresh / 65536) / x.numel()) ** 0.5
        assert abs(keep - thresh / 65536) < 6 * se
        assert abs(float(y.mean()) - 2.0) < 6 * 2.0 * se / (thresh / 65536)
        assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 2.0 * 65536 / thresh))
    assert dropout(x, 0.3, True, None) is x
    assert dropout(x, 0.3, False, g) is x


# ------------------------------ train step ------------------------------

def _overrides(vocab, loss_impl):
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
            "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
            "training.precision=fp32", "training.global_batch_size=2",
            "training.frame_buckets=[96]", "training.token_buckets=[12]",
            "training.eval_max_elements=4", "data.dataset=synthetic",
            "data.synthetic_size=16", "data.synthetic_seconds=0.9",
            "data.synthetic_max_words=6", f"training.loss_impl={loss_impl}",
            "training.pruned_warmup_steps=2", "training.pruned_band=8",
            "training.lr_schedule.warmup_steps=2", "data.augment=false"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(synthetic_piece_table(255)))
    return path


def _no_dropout(spec):
    enc = dataclasses.replace(spec.encoder, blocks=tuple(
        dataclasses.replace(b, dropout=0.0) for b in spec.encoder.blocks))
    return dataclasses.replace(spec, encoder=enc, predictor=dataclasses.replace(
        spec.predictor, dropout=0.0))


def _setup(vocab, loss_impl):
    ov = _overrides(vocab, loss_impl)
    jcfg = jconfig.apply_overrides(jconfig.load_config(
        tconfig.CONFIG_DIR / "tiny_conv.yaml"), ov)
    tcfg = tconfig.apply_overrides(tconfig.load_config(
        tconfig.resolve_config("tiny_conv")), ov)
    jspec = _no_dropout(jconfig.build_model_spec(jcfg))
    tspec = _no_dropout(tconfig.build_model_spec(tcfg))
    batches = list(tloop.BatchIterator(
        tloop._load_datasets(tcfg)[0], tloop._load_tokenizer(tcfg),
        tloop.Buckets.from_frames([96], [12], tconfig.build_featurizer_spec(tcfg)),
        batch_size=2, shuffle=True, seed=0, wire_dtype="int16"))[:N_STEPS]
    assert len(batches) == N_STEPS
    return jcfg, tcfg, jspec, tspec, batches


class _Jax:
    """JAX's step functions (with the pruned-warmup switch) and state."""

    def __init__(self, jcfg, jspec, params, state, opt_state=None, step=0):
        fs = jconfig.build_featurizer_spec(jcfg)
        self.tx, _ = joptim.make_optimizer(jcfg.training, 10)
        self.fns = {impl: jax.jit(jstep.make_train_step(
            dataclasses.replace(jspec, loss_impl=impl), fs, self.tx, "fp32"))
            for impl in {jspec.loss_impl, "pruned_warmup"}}
        self.warm = jcfg.training.pruned_warmup_steps if jspec.loss_impl == "pruned" else 0
        self.impl = jspec.loss_impl
        self.state = jstep.TrainState(
            params, opt_state if opt_state is not None else self.tx.init(params),
            state, jnp.asarray(step, jnp.int32))

    def step(self, batch):
        impl = "pruned_warmup" if int(self.state.step) < self.warm else self.impl
        self.state, m = self.fns[impl](self.state, {k: jnp.asarray(v) for k, v in
                                                    batch.items()}, jax.random.PRNGKey(0))
        return {k: float(v) for k, v in m.items()}


class _Port:
    def __init__(self, tcfg, tspec, model, opt_state=None, step=0):
        fs = tconfig.build_featurizer_spec(tcfg)
        self.opt, _ = toptim.make_optimizer(tcfg.training, 10)
        self.fns = {impl: tstep.make_train_step(
            dataclasses.replace(tspec, loss_impl=impl), fs, self.opt, "fp32")
            for impl in {tspec.loss_impl, "pruned_warmup"}}
        self.warm = tcfg.training.pruned_warmup_steps if tspec.loss_impl == "pruned" else 0
        self.impl = tspec.loss_impl
        self.state = tstep.TrainState(
            model, opt_state if opt_state is not None
            else self.opt.init(dict(model.named_parameters())), step)

    def step(self, batch):
        impl = "pruned_warmup" if self.state.step < self.warm else self.impl
        self.state, m = self.fns[impl](self.state, tstep.batch_to_device(batch, "cpu"),
                                       None)
        return {k: float(v) for k, v in m.items()}


def _compare_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def _compare_params(model, jparams, jparams0):
    tp = flatten_tree(to_jax(model)[0])
    jp, j0 = flatten_tree(jax.tree.map(np.asarray, jparams)), flatten_tree(jparams0)
    diff = np.sqrt(sum(np.sum((tp[k] - jp[k]) ** 2) for k in jp))
    moved = np.sqrt(sum(np.sum((jp[k] - j0[k]) ** 2) for k in jp))
    assert moved > 0
    assert diff <= PARAM_TOL * moved, (diff, moved)


@pytest.mark.parametrize("loss_impl", ["chunked", "pallas", "pruned"])
def test_train_step_matches_jax(vocab, loss_impl):
    """5 steps from the same weights on the same batches: loss and gradient
    norms per step, then the parameters.  ``pruned`` takes 2 warmup steps
    (exact + simple loss) then the banded loss with band 8."""
    jcfg, tcfg, jspec, tspec, batches = _setup(vocab, loss_impl)
    params, state = jax.tree.map(np.asarray, jrnnt_init(jax.random.PRNGKey(0), jspec))
    j = _Jax(jcfg, jspec, params, state)
    t = _Port(tcfg, tspec, from_jax(params, state, tspec))
    for b in batches:
        _compare_metrics(t.step(b), j.step(b))
    _compare_params(t.state.model, j.state.params, params)


def test_run_carried_from_jax_continues_in_port(vocab):
    """JAX takes 2 steps; its params, norm state and optax state go to the
    port; both take step 3, which must agree; the carried state converts
    back to optax's exactly."""
    jcfg, tcfg, jspec, tspec, batches = _setup(vocab, "chunked")
    params, state = jax.tree.map(np.asarray, jrnnt_init(jax.random.PRNGKey(1), jspec))
    j = _Jax(jcfg, jspec, params, state)
    j.step(batches[0])
    j.step(batches[1])
    adam = j.state.opt_state[1][0]
    assert int(j.state.opt_state[1][2].count) == int(adam.count) == 2
    p2 = jax.tree.map(np.asarray, j.state.params)
    model = from_jax(p2, jax.tree.map(np.asarray, j.state.model_state), tspec)
    opt = opt_state_from_jax(adam.count, jax.tree.map(np.asarray, adam.mu),
                             jax.tree.map(np.asarray, adam.nu), model)
    back = opt_state_to_jax(opt)
    assert int(back["count"]) == 2
    for k, v in flatten_tree(jax.tree.map(np.asarray, adam.mu)).items():
        np.testing.assert_array_equal(flatten_tree(back["mu"])[k], v)
    t = _Port(tcfg, tspec, model, opt_state=opt, step=2)
    _compare_metrics(t.step(batches[2]), j.step(batches[2]))
    _compare_params(t.state.model, j.state.params, p2)


def test_resume_equals_straight_run(vocab, tmp_path):
    """2 steps, checkpoint, restore into a fresh model, 1 step equals 3
    straight steps exactly (device augmentation ``full``, SpecAugment and
    dropout on, all drawn per step from the run seed)."""
    _, tcfg, _, _, batches = _setup(vocab, "chunked")
    spec = tconfig.build_model_spec(tcfg)
    fs = tconfig.build_featurizer_spec(tcfg)
    opt, _ = toptim.make_optimizer(tcfg.training, 10)
    step = tstep.make_train_step(spec, fs, opt, "fp32", spec_augment=True,
                                 device_augment="full")

    def run(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, tstep.batch_to_device(batches[i], "cpu"),
                            tloop.step_generator(torch.device("cpu"), 0, state.step))
        return state

    def fresh():
        m = rnnt_init(spec, seed=0)
        return tstep.TrainState(m, opt.init(dict(m.named_parameters())), 0)

    straight = run(fresh(), 0, 3)
    first = run(fresh(), 0, 2)
    path = tckpt.save(tmp_path, first, tcfg)
    model = rnnt_init(spec, seed=5)
    opt_state, at = tckpt.restore(path, model)
    assert at == 2
    resumed = run(tstep.TrainState(model, opt_state, at), 2, 3)
    assert resumed.step == straight.step == 3
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    for k in straight.opt_state.mu:
        assert torch.equal(straight.opt_state.mu[k], resumed.opt_state.mu[k])
        assert torch.equal(straight.opt_state.nu[k], resumed.opt_state.nu[k])


def test_cli_train_writes_checkpoint_cli_eval_reads(vocab, tmp_path, capsys):
    ov = _overrides(vocab, "chunked")
    args = ["--config", "tiny_conv", "--max-steps", "3", "--device", "cpu",
            "--output-base", str(tmp_path)]
    for o in ov + ["training.log_steps=1"]:
        args += ["--set", o]
    final_wer = tcli_train.main(args)
    ckpt = tmp_path / "tiny_conv" / "run-1" / "checkpoint_step_3"
    assert (ckpt / "params.npz").exists() and (ckpt / "opt_state.npz").exists()
    rows = [json.loads(x) for x in
            (tmp_path / "tiny_conv" / "run-1" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss/train" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss/train"]) for r in rows if "loss/train" in r)
    # Each step logs the kernels' launches: none on the CPU.
    launches = [{k: v for k, v in r.items() if k.startswith("launches/")}
                for r in rows if "loss/train" in r]
    assert all(set(x) == {"launches/joint_fwd", "launches/joint_bwd",
                          "launches/alpha_fwd", "launches/beta_bwd",
                          "launches/window_gather", "launches/alpha_chain",
                          "launches/beta_chain"}
               and not any(x.values()) for x in launches)
    out = capsys.readouterr().out
    assert "TF32 off" in out and f"final wer: {final_wer}" in out
    res = tcli_eval.main([str(ckpt), "--device", "cpu", "--batch-size", "2",
                          "--max-elements", "4"])
    assert res["utterances"] == 4 and np.isfinite(res["wer"])


@pytest.mark.parametrize("override,error,match", [
    ("mesh.data=2", ValueError, "mesh data=2 x model=1 needs 2 ranks"),
    ("data.dataset=librispeech", NotImplementedError, "dataset"),
])
def test_train_refuses_what_is_not_ported(vocab, tmp_path, override, error, match):
    """A mesh larger than the process group (one process here) and an
    unported dataset raise before a run is written."""
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config(
        "tiny_conv")), _overrides(vocab, "chunked") + [override])
    with pytest.raises(error, match=match):
        tloop.train(cfg, output_base=tmp_path, max_steps=1, device="cpu")
    assert not any(tmp_path.iterdir())


# --------------------------- augmented training ---------------------------

# Loss and per-submodel gradient norms with the time stretch on: the
# reference's step is jitted, and jitted XLA's float32 phase-vocoder sums
# put JAX's own stretch up to 2.4e-2 from the host's in the body (the port
# is held to eager JAX and the host at JAX's bounds in
# tests/test_torch_augment.py); that moves the features, the loss and the
# gradients: measured up to 1.8e-3 relative (grad_norm/encoder), varying
# between runs.  With the stretch off, RTOL.
STRETCH_RTOL = 1e-2


def _augmented_setup(vocab):
    """tiny_conv, fp32, dropout off, batch 2 of 0.6 s utterances in the
    96-frame (15,600-sample) bucket: at len <= 0.62 L the recipe's clamps
    (rate and ratio >= len/L) never bind (see test_torch_augment.py's
    ``batch``)."""
    ov = _overrides(vocab, "chunked") + ["data.synthetic_seconds=0.6"]
    jcfg = jconfig.apply_overrides(jconfig.load_config(
        tconfig.CONFIG_DIR / "tiny_conv.yaml"), ov)
    tcfg = tconfig.apply_overrides(tconfig.load_config(
        tconfig.resolve_config("tiny_conv")), ov)
    batch = next(iter(tloop.BatchIterator(
        tloop._load_datasets(tcfg)[0], tloop._load_tokenizer(tcfg),
        tloop.Buckets.from_frames([96], [12], tconfig.build_featurizer_spec(tcfg)),
        batch_size=2, shuffle=True, seed=0, wire_dtype="int16")))
    return (jcfg, tcfg, _no_dropout(jconfig.build_model_spec(jcfg)),
            _no_dropout(tconfig.build_model_spec(tcfg)), batch)


_JAX_AUGMENTED_STEP: dict = {}


def _jax_augmented_step(jcfg, jspec):
    """JAX's jitted train step with ``device_augment="full"`` and
    SpecAugment, and its optimizer, built once for both cases: the batch
    carries a "tempo_on" (B,) mask that replaces the recipe's first gate
    (the time stretch's); the other gates are drawn as the recipe draws
    them.  ``_gate`` is swapped in the reference module only while the
    step traces."""
    from rnnt_tpu.data import augment_device as jdev

    if _JAX_AUGMENTED_STEP:
        return _JAX_AUGMENTED_STEP["step"]
    fs = jconfig.build_featurizer_spec(jcfg)
    tx, _ = joptim.make_optimizer(jcfg.training, 10)
    step = jstep.make_train_step(jspec, fs, tx, "fp32", spec_augment=True,
                                 device_augment="full")

    def traced(state, batch, rng):
        batch = dict(batch)
        tempo_on = batch.pop("tempo_on")
        calls = iter(range(7))
        drawn = jdev._gate
        jdev._gate = lambda k, p, n: tempo_on if next(calls) == 0 else drawn(k, p, n)
        try:
            return step(state, batch, rng)
        finally:
            jdev._gate = drawn

    _JAX_AUGMENTED_STEP["step"] = jax.jit(traced), tx
    return _JAX_AUGMENTED_STEP["step"]


@pytest.mark.parametrize("stretch", [False, True], ids=["stretch-off", "stretch-on"])
def test_augmented_train_step_matches_jax(vocab, monkeypatch, stretch):
    """One step with ``device_augment="full"`` and SpecAugment: JAX's step
    (its key folded and split as ``rnnt_tpu/train/step.py:84-100`` does)
    against the port's step fed JAX's draws; with ``stretch`` off, the time
    stretch's gate is off in both."""
    from tests.test_torch_augment import jax_full_draws, jax_spec_draws, to_port
    from rnnt_tpu_torch.data import augment as taug
    from rnnt_tpu_torch.data import augment_device as tdev

    jcfg, tcfg, jspec, tspec, batch = _augmented_setup(vocab)
    jfn, tx = _jax_augmented_step(jcfg, jspec)
    B, L = batch["audio"].shape
    fs = jconfig.build_featurizer_spec(jcfg)
    key = jax.random.PRNGKey(3)
    rng = jax.random.fold_in(key, 0)
    rng, da_rng = jax.random.split(rng)
    _, sa_rng = jax.random.split(rng)
    draws = dict(jax_full_draws(da_rng, B, L))
    draws["tempo_on"] = np.full((B,), stretch)
    spec_draws = jax_spec_draws(sa_rng, B, fs.num_frames(L), fs.num_bins)
    params, state = jax.tree.map(np.asarray, jrnnt_init(jax.random.PRNGKey(0), jspec))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["tempo_on"] = jnp.asarray(draws["tempo_on"])
    _, jm = jfn(jstep.TrainState(params, tx.init(params), state, jnp.asarray(0, jnp.int32)),
                jbatch, key)
    monkeypatch.setattr(tdev, "device_augment_full_draws",
                        lambda *a, **k: to_port(draws))
    monkeypatch.setattr(taug, "spec_augment_draws", lambda *a, **k: to_port(spec_draws))
    opt, _ = toptim.make_optimizer(tcfg.training, 10)
    model = from_jax(params, state, tspec)
    tfn = tstep.make_train_step(tspec, tconfig.build_featurizer_spec(tcfg), opt, "fp32",
                                spec_augment=True, device_augment="full")
    _, tm = tfn(tstep.TrainState(model, opt.init(dict(model.named_parameters()))),
                tstep.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    want = {k: float(v) for k, v in jm.items()}
    got = {k: float(v) for k, v in tm.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STRETCH_RTOL if stretch else RTOL,
                                   err_msg=k)


def test_train_flagship_data_settings_take_jax_cached_order(vocab, tmp_path, monkeypatch):
    """``train()`` with ``augment: true, augment_device: full, staging:
    auto`` (the flagship's data settings) caches the corpus and trains 3
    steps on the batches JAX's ``DeviceSampleCache`` serves for epoch 0,
    in its order."""
    from rnnt_tpu.data.device_cache import DeviceSampleCache as JCache
    from rnnt_tpu.data.tokenizer import UnigramTokenizer as JTokenizer

    ov = _overrides(vocab, "chunked") + [
        "data.augment=true", "data.augment_device=full", "data.staging=auto",
        "training.frame_buckets=[64,96]", "training.eval_max_elements=2",
        "training.log_steps=1"]
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config(
        "tiny_conv")), ov)
    seen = []
    make = tloop.make_train_step

    def recording(*a, **k):
        assert k.get("device_augment") == "full"
        fn = make(*a, **k)

        def step(state, batch, gen):
            seen.append({n: v.clone() for n, v in batch.items()})
            return fn(state, batch, gen)
        return step

    monkeypatch.setattr(tloop, "make_train_step", recording)
    assert np.isfinite(tloop.train(cfg, output_base=tmp_path, max_steps=3, device="cpu"))
    fspec = tconfig.build_featurizer_spec(cfg)
    jc = JCache.build(tloop._load_datasets(cfg)[0], JTokenizer.from_vocab_json(vocab),
                      tloop.Buckets.from_frames([64, 96], [12], fspec),
                      wire_dtype=cfg.data.wire_dtype,
                      budget_bytes=cfg.data.device_cache_budget_mb << 20)
    want = [{k: np.asarray(v)[idx] for k, v in jc.groups[gi].items()}
            for gi, idx in jc.epoch_batches(2, seed=0)][:3]
    assert len(seen) == len(want) == 3
    for got, w in zip(seen, want):
        for k in w:
            np.testing.assert_array_equal(got[k].numpy(), w[k])
