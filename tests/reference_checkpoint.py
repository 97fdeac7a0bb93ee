"""A reference-format (PyTorch RNN-T) checkpoint synthesized from a seed,
for the port's import path: tests/test_torch_import.py holds what the
port imports from it against rnnt_tpu's ``import_reference_state_dict``,
and chip_smoke.py imports it at full width on the card.

Only numpy and torch: chip_smoke.py imports this file, and nothing there
may import JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def reference_state_dict(spec, seed: int) -> dict:
    """A reference ``RNNTModel`` state dict for ``spec``: the reference's
    key names and torch layouts (Conv1d (Cout, Cin, K), Linear (out, in),
    norms' weight / bias / running stats / num_batches_tracked), values
    from a seeded RandomState, each weight scaled by 1 / sqrt(fan in);
    wrapped as the reference's ``save_model`` writes it under DDP
    (``module.`` keys inside ``model_state_dict``, ``completed_steps``)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def put(key, *shape, fan_in=None, positive=False):
        a = rng.uniform(0.5, 1.5, shape) if positive else rng.randn(*shape)
        if fan_in:
            a = a / np.sqrt(fan_in)
        sd[key] = torch.from_numpy(a.astype(np.float32))

    def conv(pre, cout, cin, k):
        put(f"{pre}.conv.weight", cout, cin, k, fan_in=cin * k)
        put(f"{pre}.conv.bias", cout, fan_in=cin * k)

    def conv1x1(pre, cout, cin):
        put(f"{pre}.weight", cout, cin, 1, fan_in=cin)
        put(f"{pre}.bias", cout, fan_in=cin)

    def linear(pre, out, inp, bias=True):
        put(f"{pre}.weight", out, inp, fan_in=inp)
        if bias:
            put(f"{pre}.bias", out, fan_in=inp)

    def layer_norm(pre, c):
        put(f"{pre}.weight", c, positive=True)
        put(f"{pre}.bias", c, fan_in=c)

    def norm(pre, c, kind):
        if kind in ("batch", "instance_affine"):
            put(f"{pre}.weight", c, positive=True)
            put(f"{pre}.bias", c, fan_in=c)
        if kind == "batch":
            put(f"{pre}.running_mean", c, fan_in=c)
            put(f"{pre}.running_var", c, positive=True)
            sd[f"{pre}.num_batches_tracked"] = torch.tensor(1000)

    enc = spec.encoder
    pro, epi = enc.prologue_spec, enc.epilogue_spec
    conv("encoder.blocks.0", pro.out_channels, pro.in_channels, pro.kernel_size)
    norm("encoder.blocks.1", pro.out_channels, enc.norm_type)
    idx = 3
    for b in enc.blocks:
        pre = f"encoder.blocks.{idx}"
        for i in range(b.num_sub_blocks):
            cin = b.in_channels if i == 0 else b.out_channels
            conv(f"{pre}.convs.{i}", b.out_channels, cin, b.kernel_size)
            norm(f"{pre}.norms.{i}", b.out_channels, b.norm_type)
        conv1x1(f"{pre}.residual_conv", b.out_channels, b.in_channels)
        norm(f"{pre}.residual_norm", b.out_channels, b.norm_type)
        idx += 1
    conv(f"encoder.blocks.{idx}", epi.out_channels, epi.in_channels, epi.kernel_size)
    norm(f"encoder.blocks.{idx + 1}", epi.out_channels, enc.norm_type)
    conv1x1(f"encoder.blocks.{idx + 3}", enc.output_features, epi.out_channels)

    p = spec.predictor
    d = p.symbol_embedding_dim
    put("predictor.embedding.weight", p.num_symbols, d)
    layer_norm("predictor.input_layer_norm", d)
    if hasattr(p, "num_lstm_layers"):
        h = p.lstm_hidden_dim
        for i in range(p.num_lstm_layers):
            pre = f"predictor.lstm_layers.{i}"
            linear(f"{pre}.x2g", 4 * h, d if i == 0 else h, bias=not p.lstm_layer_norm)
            linear(f"{pre}.p2g", 4 * h, h, bias=False)
            if p.lstm_layer_norm:
                layer_norm(f"{pre}.c_norm", h)
                layer_norm(f"{pre}.g_norm", 4 * h)
        linear("predictor.linear", p.output_dim, h)
    else:
        conv("predictor.conv1", d, d, 3)
        conv("predictor.conv2", d, d, 5)
        linear("predictor.linear", p.output_dim, d)
    layer_norm("predictor.output_layer_norm", p.output_dim)
    j = spec.joint
    linear("joint.joint_ln", j.num_classes, j.hidden_features)
    return {"model_state_dict": {f"module.{k}": v for k, v in sd.items()},
            "completed_steps": 685656}
