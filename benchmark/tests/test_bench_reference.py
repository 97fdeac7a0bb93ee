"""The plain reference against rnnt_tpu_torch on the CPU at small widths,
both in float32 on the same weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import port, workload
from benchmark.reference import model as ref
from benchmark.tests.conftest import tiny_conf


def tiny(overrides=(), seed=3):
    conf = tiny_conf(overrides=["training.precision=fp32", *overrides])
    cfg = port.load_config(conf)
    model, weights = port.build_model(cfg, seed, torch.device("cpu"), 1.0)
    return conf, cfg, model, weights


def wave(n=2, seconds=2.0, seed=5):
    g = torch.Generator().manual_seed(seed)
    lens = np.array([int(seconds * 16000) - 1000 * i for i in range(n)])
    return workload.wire_audio(lens, int(lens.max()), g, "cpu"), lens


@pytest.mark.parametrize("kind", ["spectrogram", "old_piecewise"])
def test_featurizer(kind):
    from rnnt_tpu_torch.config.config import build_featurizer_spec
    from rnnt_tpu_torch.ops.stft import make_featurizer

    conf, cfg, _, _ = tiny([f"featurizer.kind={kind}"])
    pcm, _ = wave()
    x = pcm.float() / workload.WIRE_SCALE
    want = make_featurizer(build_featurizer_spec(cfg))(x)
    got = ref.featurize(x, conf["model"]["featurizer"])
    assert got.shape == want.shape
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
        r_audio = ref.encoder(P, conf["model"]["encoder"], x)
        r_text = ref.predictor(P, targets, 1023)
    torch.testing.assert_close(r_audio, audio, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(r_text, text, atol=1e-4, rtol=1e-4)
    assert int(ref.encoder_out_len(120, conf["model"]["encoder"])) == audio.shape[1]


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
        got = ref.encoder(P, enc, x)
    assert int(ref.encoder_out_len(64, enc)) == want.shape[1]
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
