"""The first slice end to end against rnnt_tpu, fp32 on the CPU: a
tiny_conv-shaped model scores and greedy-decodes a synthetic batch through
both packages with the same weights (rnnt_init, carried by from_jax).

* batches: the port's BatchIterator gives the JAX one's arrays exactly;
* exact NLL: the port's chunked and K1 (plain) paths within 1e-4 of JAX;
* greedy decode: token-equal, counts included, and W = 8 equal to W = 1;
* the port's cli/eval on a checkpoint directory gives evaluate()'s WER;
* config parity: both packages build equal specs from every YAML.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.data import dataset as jdata  # noqa: E402
from rnnt_tpu.decode.greedy import greedy_decode as jgreedy  # noqa: E402
from rnnt_tpu.models.rnnt import rnnt_init  # noqa: E402
from rnnt_tpu.train import loop as jloop  # noqa: E402
from rnnt_tpu.train import step as jstep  # noqa: E402
from rnnt_tpu.train.metrics import wer as jwer  # noqa: E402
from rnnt_tpu_torch.cli import eval as tcli_eval  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import from_jax, write_checkpoint  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.decode.greedy import greedy_decode  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402
from rnnt_tpu_torch.train import step as tstep  # noqa: E402

BLANK_BIAS = 0.5  # makes the random-init model emit a few tokens per utterance


def _overrides(vocab_json):
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab_json}",
            "training.precision=fp32", "training.global_batch_size=4",
            "training.frame_buckets=[128]", "training.token_buckets=[16]",
            "training.eval_max_elements=8", "data.dataset=synthetic",
            "data.synthetic_size=16", "data.synthetic_seconds=1.0"]


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    vocab = root / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    jcfg = jconfig.apply_overrides(
        jconfig.load_config(jconfig_path("tiny_conv")), _overrides(vocab))
    tcfg = tconfig.apply_overrides(
        tconfig.load_config(tconfig.resolve_config("tiny_conv")), _overrides(vocab))
    jspec, tspec = jconfig.build_model_spec(jcfg), tconfig.build_model_spec(tcfg)
    params, state = jax.tree.map(np.asarray, rnnt_init(jax.random.PRNGKey(0), jspec))
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.05, params)
    params["joint"]["out"]["b"][jspec.blank_idx] += BLANK_BIAS
    model = from_jax(params, state, tspec)
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, jspec=jspec, tspec=tspec,
                params=params, state=state, model=model)


def jconfig_path(name):
    return tconfig.CONFIG_DIR / f"{name}.yaml"


def _batches(s):
    jtok = jloop._load_tokenizer(s["jcfg"])
    _, jds = jloop._load_datasets(s["jcfg"])
    jfs = jconfig.build_featurizer_spec(s["jcfg"])
    tc = s["jcfg"].training
    jit = jdata.BatchIterator(
        jds, jtok, jdata.Buckets.from_frames(tc.frame_buckets, tc.token_buckets, jfs),
        batch_size=4, shuffle=False, drop_last=False, max_batches=2,
        wire_dtype=s["jcfg"].data.wire_dtype)
    tit = tloop.eval_batches(s["tcfg"], tloop._load_tokenizer(s["tcfg"]))
    return list(jit), list(tit)


def test_batches_match_jax(slice_setup):
    jb, tb = _batches(slice_setup)
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_slice_matches_jax_end_to_end(slice_setup):
    s = slice_setup
    jspec, tspec, model = s["jspec"], s["tspec"], s["model"]
    jfs = jconfig.build_featurizer_spec(s["jcfg"])
    tfs = tconfig.build_featurizer_spec(s["tcfg"])
    batch = _batches(s)[1][0]
    p, st = s["params"], s["state"]

    j_fwd = jax.jit(jstep.make_eval_forward(jspec, jfs, "fp32"))
    j_loss = jax.jit(lambda p, st, b: jstep.make_loss_fn(jspec, jfs, "fp32")(
        p, st, b, None, False)[0])
    j_dec = jax.jit(lambda p, a, tl: jgreedy(p, a, tl, jspec.predictor,
                                             jspec.joint, max_tokens=16))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_audio, j_tl = j_fwd(p, st, jb)
    want_nll = float(j_loss(p, st, jb))
    want_tok, want_n = map(np.asarray, j_dec(
        {"predictor": p["predictor"], "joint": p["joint"]}, j_audio, j_tl))

    tb = tstep.batch_to_device(batch, "cpu")
    with torch.inference_mode():
        audio, t_lens = tstep.make_eval_forward(tspec, tfs, "fp32")(model, tb)
        nll_auto = float(tstep.make_loss_fn(tspec, tfs, "fp32")(model, tb))
        nll_k1 = float(tstep.make_loss_fn(
            dataclasses.replace(tspec, loss_impl="pallas"), tfs, "fp32")(model, tb))
        outs = [greedy_decode(model.predictor, model.joint, audio, t_lens,
                              tspec.predictor, tspec.joint, max_tokens=16,
                              frames_per_step=w) for w in (8, 1)]
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_tl))
    np.testing.assert_allclose(audio.numpy(), np.asarray(j_audio), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(nll_auto, want_nll, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nll_k1, want_nll, rtol=1e-4, atol=1e-4)
    (tok, n), (tok1, n1) = outs
    assert n.numpy().min() >= 1, "the biased model should emit tokens"
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(tok1.numpy(), tok.numpy())
    np.testing.assert_array_equal(n1.numpy(), n.numpy())

    # evaluate() on the same stream scores the same NLL and WER.
    jtok = jloop._load_tokenizer(s["jcfg"])
    refs = [jtok.decode(batch["targets"][i, : batch["target_lens"][i]])
            for i in range(4)]
    hyps = [jtok.decode(want_tok[i, : want_n[i]]) for i in range(4)]
    res = tloop.evaluate(s["tcfg"], model, device="cpu", batches=[batch])
    np.testing.assert_allclose(res["nll"], want_nll, rtol=1e-4, atol=1e-4)
    assert res["wer"] == jwer(refs, hyps)
    assert res["utterances"] == 4


def test_cli_eval_matches_evaluate(slice_setup, capsys):
    s = slice_setup
    ckpt = write_checkpoint(s["root"] / "ckpt", s["tcfg"], s["params"], s["state"])
    out = tcli_eval.main([str(ckpt), "--device", "cpu", "--batch-size", "4",
                          "--max-elements", "8"])
    res = tloop.evaluate(s["tcfg"], s["model"], device="cpu", batch_size=4,
                         max_batches=2)
    assert out["utterances"] == res["utterances"] == 8
    assert out["wer"] == res["wer"]
    assert "WER:" in capsys.readouterr().out


# The port's copies of the JAX package's YAMLs (the port's own configs,
# such as parakeet_rnnt_0.6b, have none there).
JAX_YAMLS = {p.name for p in (Path(jconfig.__file__).parent / "configs").glob("*.yaml")}


def _port_spec_dict(spec) -> dict:
    """The port's model spec as a dict, without the joint's activation
    where it is tanh, the only one the JAX package has."""
    d = dataclasses.asdict(spec)
    if d["joint"].get("activation") == "tanh":
        del d["joint"]["activation"]
    return d


@pytest.mark.parametrize("path", sorted(p for p in tconfig.CONFIG_DIR.glob("*.yaml")
                                        if p.name in JAX_YAMLS),
                         ids=lambda p: p.stem)
def test_config_specs_match_jax(path):
    jcfg, tcfg = jconfig.load_config(path), tconfig.load_config(path)
    # config_to_dict leaves out the port's fields that hold their defaults.
    assert dataclasses.asdict(jcfg) == tconfig.config_to_dict(tcfg)
    jspec, tspec = jconfig.build_model_spec(jcfg), tconfig.build_model_spec(tcfg)
    assert dataclasses.asdict(jspec) == _port_spec_dict(tspec)
    assert type(jspec.predictor).__name__ == type(tspec.predictor).__name__
    if not jcfg.featurizer.global_stats:
        assert (dataclasses.asdict(jconfig.build_featurizer_spec(jcfg))
                == dataclasses.asdict(tconfig.build_featurizer_spec(tcfg)))
