"""The plain reference against rnnt_tpu_torch on the CPU at small widths,
both in float32 on the same weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import port, workload
from benchmark.reference import common as ref
from benchmark.reference import jasper
from benchmark.tests.conftest import tiny_conf

# base_sp_lstm's front end: torchaudio MelSpectrogram framing, 80 mels.
MEL = ["featurizer.kind=mel", "featurizer.n_fft=512", "featurizer.num_mels=80",
       "featurizer.center=true", "encoder.input_features=80"]


def tiny(overrides=(), seed=3):
    conf = tiny_conf(overrides=["training.precision=fp32", *overrides])
    cfg = port.load_config(conf)
    model, weights = port.build_model(cfg, seed, torch.device("cpu"), 1.0)
    return conf, cfg, model, weights


def wave(n=2, seconds=2.0, seed=5):
    g = torch.Generator().manual_seed(seed)
    lens = np.array([int(seconds * 16000) - 1000 * i for i in range(n)])
    return workload.wire_audio(lens, int(lens.max()), g, "cpu"), lens


@pytest.mark.parametrize("kind", ["spectrogram", "old_piecewise", "mel"])
def test_featurizer(kind):
    """Each front end against the port's; ``mel`` is centred (a reflect pad)
    and compressed as ``old_piecewise``."""
    from rnnt_tpu_torch.config.config import build_featurizer_spec
    from rnnt_tpu_torch.ops.stft import make_featurizer

    conf, cfg, _, _ = tiny(MEL if kind == "mel" else [f"featurizer.kind={kind}"])
    pcm, lens = wave()
    x = pcm.float() / workload.WIRE_SCALE
    fspec = build_featurizer_spec(cfg)
    want = make_featurizer(fspec)(x)
    fz = conf["model"]["featurizer"]
    got = ref.featurize(x, fz)
    assert got.shape == want.shape
    assert got.shape[1] == fspec.num_frames(x.shape[1]) == ref.num_frames(x.shape[1], fz)
    assert [fspec.num_frames(int(n)) for n in lens] == list(ref.num_frames(lens, fz))
    assert ref.num_frames(workload.samples_for_frames(256, fz), fz) == 256
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("overrides", [
    [], ["encoder.norm_type=batch"], ["encoder.norm_type=instance"]])
def test_encoder_and_predictor(overrides):
    from rnnt_tpu_torch.models.rnnt import rnnt_forward

    conf, cfg, model, P = tiny(overrides)
    x = torch.randn(2, 120, conf["model"]["encoder"]["input_features"],
                    generator=torch.Generator().manual_seed(1))
    targets = torch.randint(0, 1023, (2, 9), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        audio, text, _ = rnnt_forward(model, x, targets)
        r_audio = jasper.encoder(P, conf["model"]["encoder"], x)
        r_text = ref.predictor(P, conf["model"]["predictor"], targets, 1023)
    torch.testing.assert_close(r_audio, audio, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(r_text, text, atol=1e-4, rtol=1e-4)
    assert int(jasper.encoder_out_len(120, conf["model"])) == audio.shape[1]


@pytest.mark.parametrize("layer_norm", [True, False])
def test_lstm_predictor(layer_norm):
    """The LSTM predictor against the port's ``LSTMPredictor``: with layer
    norm (base_sp_lstm's: ``x2g`` without bias, ``g_norm`` over the four
    gates, ``c_norm`` over the cell) and without (``x2g`` with its bias)."""
    from rnnt_tpu_torch.models.predictor import LSTMPredictor, predictor_apply

    conf, cfg, model, P = tiny(["predictor.kind=lstm", "predictor.num_lstm_layers=2",
                                "predictor.lstm_hidden_dim=96",
                                f"predictor.lstm_layer_norm={str(layer_norm).lower()}"])
    assert isinstance(model.predictor, LSTMPredictor)
    assert ("predictor.layers.0.x2g.b" in P) != layer_norm
    targets = torch.randint(0, 1023, (3, 11), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = predictor_apply(model.predictor, torch.cat(
            [torch.full((3, 1), 1023), targets], dim=1))
        got = ref.predictor(P, conf["model"]["predictor"], targets, 1023)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_build_model_refuses_an_undrawn_parameter(monkeypatch):
    """A parameter that none of ``build_model``'s rules draws would keep
    the memory ``to_empty`` left in it: it is refused, by name."""
    from rnnt_tpu_torch.models import rnnt

    class WithTable(rnnt.RNNT):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.encoder.pos_table = torch.nn.Parameter(torch.zeros(4, 8))

    conf = tiny_conf(overrides=["training.precision=fp32"])
    port.build_model(port.load_config(conf), 3, torch.device("cpu"))
    monkeypatch.setattr(rnnt, "RNNT", WithTable)
    with pytest.raises(ValueError, match=r"encoder\.pos_table"):
        port.build_model(port.load_config(conf), 3, torch.device("cpu"))


def test_encoder_lookahead():
    """The flagship's first block looks 2 frames ahead."""
    from rnnt_tpu_torch.models.encoder import Encoder, EncoderSpec, JasperBlockSpec

    enc = {"input_features": 201, "norm_type": "instance_affine", "prologue_kernel_size": 11,
           "prologue_stride": 2, "prologue_dilation": 1,
           "blocks": [{"kernel_size": 11, "in_channels": 64, "out_channels": 64, "dropout": 0.0,
                       "num_sub_blocks": 2, "additional_context": 2, "norm_type": ""}],
           "epilogue_features": 64, "epilogue_kernel_size": 29, "epilogue_stride": 1,
           "epilogue_dilation": 2, "output_features": 96}
    spec = EncoderSpec(201, 11, 2, 1, (JasperBlockSpec(11, 64, 64, 0.0, 2, "instance_affine", 2),),
                       64, 29, 1, 2, 96, "instance_affine")
    model = Encoder(spec, torch.Generator().manual_seed(0))
    P = {f"encoder.{n}": v for n, v in model.state_dict().items()}
    x = torch.randn(1, 64, 201, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = jasper.encoder(P, enc, x)
    assert int(jasper.encoder_out_len(64, {"encoder": enc})) == want.shape[1]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_loss_and_gradients():
    from rnnt_tpu_torch.ops.transducer import transducer_loss

    conf, cfg, model, P = tiny()
    g = torch.Generator().manual_seed(4)
    audio = torch.randn(3, 17, 256, generator=g)
    text = torch.randn(3, 6, 256, generator=g)
    targets = torch.randint(0, 1023, (3, 5), generator=g)
    t_lens, u_lens = torch.tensor([17, 12, 5]), torch.tensor([5, 3, 0])
    a1, t1 = audio.clone().requires_grad_(), text.clone().requires_grad_()
    want = transducer_loss(model.joint, a1, t1, targets, t_lens, u_lens, 1023, reduction="none")
    want.sum().backward()
    a2, t2 = audio.clone().requires_grad_(), text.clone().requires_grad_()
    lp = ref.lattice_log_probs(ref.joint_logits(P, a2, t2), targets, 1023)
    got = ref.nll(*lp, t_lens, u_lens)
    got.sum().backward()
    torch.testing.assert_close(got, want.detach(), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(a2.grad, a1.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(t2.grad, t1.grad, atol=1e-5, rtol=1e-4)


def test_adamw_follows_the_port():
    from rnnt_tpu_torch.train.optim import make_optimizer

    conf, cfg, model, _ = tiny(["training.clip_grad_norm=0.5"])
    tr = conf["model"]["training"]
    opt, _ = make_optimizer(cfg.training, tr["lr_schedule"]["total_steps"])
    params = {n: p.detach().clone() for n, p in list(model.named_parameters())[:6]}
    mine = {n: p.clone() for n, p in params.items()}
    state = opt.init(params)
    rstate = {"count": 0, "mu": {}, "nu": {}}
    o = {"lr": tr["optimizer"]["lr"], "b1": tr["optimizer"]["betas"][0],
         "b2": tr["optimizer"]["betas"][1], "eps": tr["optimizer"]["eps"],
         "weight_decay": tr["optimizer"]["weight_decay"], "clip": tr["clip_grad_norm"],
         "warmup_steps": tr["lr_schedule"]["warmup_steps"],
         "min_lr_ratio": tr["lr_schedule"]["min_lr_ratio"],
         "total_steps": tr["lr_schedule"]["total_steps"]}
    g = torch.Generator().manual_seed(9)
    for _ in range(4):
        grads = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}
        state = opt.update(params, grads, state)
        ref.adamw_step(mine, grads, rstate, o)
    for n in params:
        torch.testing.assert_close(mine[n], params[n], atol=1e-7, rtol=1e-5)
