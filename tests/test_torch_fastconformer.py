"""The FastConformer-Transducer (parakeet_rnnt_0.6b's YAML at tiny widths:
d_model 64 in 2 heads, 2 layers, 16 subsampling channels, the published
80-mel front end, 8x subsampling and kernel 9) in the port against the
benchmark's plain reference (``benchmark/reference/fastconformer.py``,
written apart from the port) on seeded random weights, float32 on the
CPU: the front end and the subsampled lengths, one attention (a padded
query's row 0 before ``out``), the conv module with batch norm, the whole
model's per-row NLL and every leaf's gradient, and the ``rnn`` predictor
against ``torch.nn.LSTM``.  Then ``cli.train`` for 2 steps on synthetic
data, greedy ``cli.eval`` on its checkpoint, and every path that does not
run this model refusing it by its key.

Tolerances: both sides compute in float32 in different orders (the port's
stft, conv2d and SDPA against the reference's rfft, explicit products and
softmax), so values agree to a few float32 ulps of their scale: 1e-4
absolute on unit-scale features and activations, 1e-5 relative on NLLs of
O(10^2), and 1e-4 relative on gradient norms (sums over up to 10^4 terms).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.config import config as tconfig
from rnnt_tpu_torch.models import fastconformer as fcm
from rnnt_tpu_torch.models.rnnt import RNNT, rnnt_forward
from rnnt_tpu_torch.ops.stft import make_featurizer
from rnnt_tpu_torch.ops.transducer import transducer_loss
from rnnt_tpu_torch.train.step import feature_lens_from_samples

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from benchmark.reference import fastconformer as ref  # noqa: E402

TINY = ["encoder.d_model=64", "encoder.num_layers=2", "encoder.num_heads=2",
        "encoder.subsampling_conv_channels=16", "predictor.symbol_embedding_dim=32",
        "predictor.lstm_hidden_dim=32", "predictor.output_dim=32",
        "joint.audio_features=64", "joint.text_features=32", "joint.hidden_features=32",
        "num_text_tokens=40", "num_total_symbols=41", "blank_idx=40",
        "training.precision=fp32", "training.loss_impl=chunked"]


def tiny_cfg(extra=()):
    return tconfig.apply_overrides(
        tconfig.load_config(tconfig.resolve_config("parakeet_rnnt_0.6b")), TINY + list(extra))


def model_dict(cfg) -> dict:
    return json.loads(json.dumps(tconfig.config_to_dict(cfg)))


def tiny_model(seed=0):
    """(cfg, model dict, the port's model with every parameter drawn, the
    parameters by name for the reference)."""
    cfg = tiny_cfg()
    model = RNNT(tconfig.build_model_spec(cfg), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # the zero-initialized positional biases too
        for n, p in model.named_parameters():
            if n.endswith(("pos_u.bias", "pos_v.bias")) or n.endswith(".scale"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    P = {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}
    return cfg, model_dict(cfg), model, P


def batch(B=3, seed=0, vocab=40):
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([19200, 15000, 9000][:B])
    L = 19200
    wave = torch.randn(B, L, generator=g) * 0.1
    wave = torch.where(torch.arange(L)[None] < lens[:, None], wave, 0.0)
    targets = torch.randint(0, vocab, (B, 6), generator=g)
    return wave, lens, targets, torch.tensor([6, 4, 2][:B])


def test_front_end_and_lengths():
    cfg, md, _, _ = tiny_model()
    wave, lens, _, _ = batch()
    fspec = tconfig.build_featurizer_spec(cfg)
    got = make_featurizer(fspec)(wave, lens)
    want = ref.featurize(wave, lens, md["featurizer"])
    assert got.shape == want.shape == (3, 19200 // 160 + 1, 80)
    assert (got - want).abs().max() < 1e-4
    frames = feature_lens_from_samples(lens, fspec)
    assert frames.tolist() == ref.num_frames(lens, md["featurizer"]).tolist()
    assert (got[2, frames[2]:] == 0).all()
    spec = tconfig.build_model_spec(cfg).encoder
    assert spec.out_len(frames).tolist() == ref.encoder_out_len(frames, md).tolist()
    assert [spec.out_len(n) for n in (1, 8, 9, 1601)] == [1, 1, 2, 201]


def test_one_attention_zeroes_padded_queries():
    cfg, md, model, P = tiny_model()
    att = model.encoder.layers[0].att
    B, T, d = 3, 11, 64
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, T, d, generator=g)
    valid = torch.arange(T)[None] < torch.tensor([11, 7, 2])[:, None]
    pe = fcm.relative_positions(T, d, "cpu")
    pair = (valid[:, :, None] & valid[:, None, :])[:, None]
    got = att(x, pe, pair, valid)
    want = ref.attention(P, "encoder.layers.0.att", x, ref.positions(T, d, "cpu"), valid, 2,
                         None)
    assert (got - want).abs().max() < 1e-4
    with torch.no_grad():  # out as the identity: its input's padded rows are 0
        att.out.w.copy_(torch.eye(d))
        att.out.b.zero_()
    o = att(x, pe, pair, valid)
    assert (o[~valid] == 0).all() and (o[valid].abs().sum(-1) > 0).all()


def test_conv_module_with_batch_norm():
    cfg, md, model, P = tiny_model()
    conv = model.encoder.layers[1].conv
    B, T, d = 3, 13, 64
    x = torch.randn(B, T, d, generator=torch.Generator().manual_seed(4))
    valid = torch.arange(T)[None] < torch.tensor([13, 9, 4])[:, None]
    state: dict = {}
    got = conv(x, valid, True, state)
    want = ref.conv_module(P, "encoder.layers.1.conv", x, valid, None)
    assert (got - want).abs().max() < 1e-4
    # Running statistics move by momentum 0.1 to the batch's (unbiased variance).
    assert set(state) == {"encoder.layers.1.conv.norm.mean", "encoder.layers.1.conv.norm.var"}


def test_whole_model_nll_and_every_gradient():
    cfg, md, model, P = tiny_model()
    wave, lens, targets, tlens = batch()
    fspec = tconfig.build_featurizer_spec(cfg)
    spec = model.spec
    feats = make_featurizer(fspec)(wave, lens)
    flens = feature_lens_from_samples(lens, fspec)
    audio, text, _ = rnnt_forward(model, feats, targets, training=True, feat_lens=flens)
    t_lens = spec.encoder.out_len(flens)
    got = transducer_loss(model.joint, audio, text, targets, t_lens, tlens, spec.blank_idx,
                          reduction="none")
    want = ref.rows_nll(P, md, wave, lens, targets, tlens)
    assert torch.allclose(got, want, rtol=1e-5, atol=0), (got, want)
    names = [n for n, _ in model.named_parameters()]
    gp = torch.autograd.grad(got.sum(), list(model.parameters()))
    gr = torch.autograd.grad(want.sum(), [P[n] for n in names])
    med = float(np.median([float(g.norm()) for g in gr]))
    for n, a, b in zip(names, gp, gr):
        if n == "predictor.embedding":  # the blank's row takes no gradient
            assert (a[40] == 0).all() and (b[40] == 0).all()
        assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), med), n


def test_rnn_predictor_is_torch_lstm():
    cfg, _, model, _ = tiny_model()
    pred = model.predictor
    lstm = torch.nn.LSTM(32, 32, batch_first=True)
    layer = pred.layers[0]
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(layer.x2g.w.T)
        lstm.weight_hh_l0.copy_(layer.p2g.w.T)
        lstm.bias_ih_l0.copy_(layer.x2g.b)
        lstm.bias_hh_l0.copy_(layer.p2g.b)
    tokens = torch.tensor([[40, 3, 7, 40, 1], [40, 0, 0, 2, 5]])
    x = pred.embedding[tokens] * (tokens != 40)[..., None]
    want, _ = lstm(x)
    got, state = pred(tokens)
    assert (got - want).abs().max() < 1e-6
    # One position at a time, as greedy decode steps it, gives the same.
    s, outs = None, []
    for u in range(tokens.shape[1]):
        o, s = pred(tokens[:, u:u + 1], s)
        outs.append(o)
    assert (torch.cat(outs, 1) - got).abs().max() < 1e-6
    assert (s["h"] - state["h"]).abs().max() < 1e-6


def test_rnn_predictor_stack_is_torch_lstm():
    """Two layers (one call each) against a 2-layer ``torch.nn.LSTM``, from
    a given state; the state comes back lanes first, a row per layer."""
    from rnnt_tpu_torch.models.predictor import RNNPredictor, RNNPredictorSpec

    pred = RNNPredictor(RNNPredictorSpec(41, 24, 2, 32), torch.Generator().manual_seed(3))
    lstm = torch.nn.LSTM(24, 32, num_layers=2, batch_first=True)
    with torch.no_grad():
        for i, layer in enumerate(pred.layers):
            getattr(lstm, f"weight_ih_l{i}").copy_(layer.x2g.w.T)
            getattr(lstm, f"weight_hh_l{i}").copy_(layer.p2g.w.T)
            getattr(lstm, f"bias_ih_l{i}").copy_(layer.x2g.b)
            getattr(lstm, f"bias_hh_l{i}").copy_(layer.p2g.b)
    g = torch.Generator().manual_seed(4)
    state = {k: torch.randn(2, 2, 32, generator=g) for k in ("h", "c")}
    tokens = torch.tensor([[40, 3, 7, 40, 1], [40, 0, 0, 2, 5]])
    x = pred.embedding[tokens] * (tokens != 40)[..., None]
    want, (h, c) = lstm(x, tuple(state[k].transpose(0, 1).contiguous() for k in ("h", "c")))
    got, new = pred(tokens, state)
    # float32 on both sides, the same products in the same order
    assert (got - want).abs().max() < 1e-6
    assert (new["h"] - h.transpose(0, 1)).abs().max() < 1e-6
    assert (new["c"] - c.transpose(0, 1)).abs().max() < 1e-6


def cli_yaml(tmp_path) -> Path:
    cfg = tiny_cfg(["num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
                    "data.dataset=synthetic", "data.synthetic_size=8",
                    "data.synthetic_seconds=1.5", "data.num_workers=0",
                    "training.global_batch_size=4", "training.log_steps=1",
                    "training.frame_buckets=[256]", "training.token_buckets=[32]"])
    path = tmp_path / "tiny_fc.yaml"
    tconfig.save_config(cfg, path)
    return path


def test_cli_train_and_greedy_eval(tmp_path):
    from rnnt_tpu_torch.cli import eval as tcli_eval
    from rnnt_tpu_torch.cli import train as tcli_train

    path = cli_yaml(tmp_path)
    tcli_train.main(["--config", str(path), "--max-steps", "2", "--device", "cpu",
                     "--output-base", str(tmp_path)])
    run = tmp_path / "parakeet_rnnt_0.6b" / "run-1"
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "loss/train" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(math.isfinite(r["loss/train"]) for r in steps)
    # Each step ran the 2 layers' attention cores on the CPU's math backend.
    assert [r["attn_calls/math"] for r in steps] == [2, 2]
    res = tcli_eval.main([str(run / "checkpoint_step_2"), "--device", "cpu",
                          "--batch-size", "2", "--max-elements", "2"])
    assert res["utterances"] == 2 and math.isfinite(res["wer"])


def _refusals(tmp_path):
    from rnnt_tpu_torch.cli import export as tcli_export
    from rnnt_tpu_torch.cli import serve as tcli_serve
    from rnnt_tpu_torch.decode.beam import beam_decode
    from rnnt_tpu_torch.decode.streaming import StreamingSession, StreamingSessionPool
    from rnnt_tpu_torch.parallel.mesh import Mesh, shard_params

    cfg = tiny_cfg()
    model = RNNT(tconfig.build_model_spec(cfg), torch.Generator().manual_seed(0))
    fspec = tconfig.build_featurizer_spec(cfg)
    spec = model.spec
    mesh = Mesh(data=1, model=2)

    def pruned_loss(cfg):
        from rnnt_tpu_torch.train.step import make_loss_fn

        make_loss_fn(tconfig.build_model_spec(cfg), tconfig.build_featurizer_spec(cfg))

    def pruned():
        pruned_loss(tiny_cfg(["training.loss_impl=pruned"]))

    def beam():
        beam_decode(model.predictor, model.joint, torch.zeros(1, 4, 64), torch.tensor([4]),
                    spec.predictor, spec.joint, beam_width=2)

    def cli_beam():
        from rnnt_tpu_torch.cli import eval as tcli_eval

        tcli_eval.main([str(tmp_path), "--config", str(cli_yaml(tmp_path)), "--beam", "2",
                        "--device", "cpu"])

    def cli_serve():
        from rnnt_tpu_torch.compat.jax_params import save_checkpoint

        served = tconfig.load_config(cli_yaml(tmp_path))
        ckpt = save_checkpoint(tmp_path / "checkpoint", served, RNNT(
            tconfig.build_model_spec(served), torch.Generator().manual_seed(0)))
        tcli_serve.model_runtime(argparse.Namespace(
            config=None, checkpoint=str(ckpt), overrides=[], slots=2, chunk_seconds=0.2),
            torch.device("cpu"))

    def cli_export():
        tcli_export.main([str(tmp_path), "--config", str(cli_yaml(tmp_path)),
                          "--out", str(tmp_path / "bundle"), "--device", "cpu"])

    return {
        "pruned": (pruned, "encoder.kind='fastconformer'"),
        "beam": (beam, "joint.activation='relu'"),
        "cli_beam": (cli_beam, "encoder.kind='fastconformer'"),
        "streaming": (lambda: StreamingSession(model, fspec), "encoder.kind='fastconformer'"),
        "pool": (lambda: StreamingSessionPool(model, fspec), "encoder.kind='fastconformer'"),
        "serve": (cli_serve, "encoder.kind='fastconformer'"),
        "bundle": (cli_export, "encoder.kind='fastconformer'"),
        "tp_config": (lambda: tconfig.check_mesh(cfg, 1, 2), "encoder.kind='fastconformer'"),
        "tp_shard": (lambda: shard_params(model, mesh), "encoder.kind='fastconformer'"),
        "relu_alone": (lambda: pruned_loss(tconfig.apply_overrides(
            tconfig.load_config(tconfig.resolve_config("tiny_conv")),
            ["joint.activation=relu", "training.loss_impl=pruned"])),
            "joint.activation='relu'"),
    }


@pytest.mark.parametrize("path", ["pruned", "beam", "cli_beam", "streaming", "pool", "serve",
                                  "bundle", "tp_config", "tp_shard", "relu_alone"])
def test_each_refusal_names_its_key(tmp_path, path):
    fn, key = _refusals(tmp_path)[path]
    with pytest.raises(ValueError, match=key.replace("(", r"\(")):
        fn()
