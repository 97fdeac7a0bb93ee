"""Useful operations of a Jasper-encoder RNN-T's training step
(``benchmark/reference/jasper.py``): the forward and backward of the
encoder's convolutions, with the featurizer, predictor and joint of
``roofline.py``, at each utterance's unpadded lengths.  The encoder's
first convolution computes no input gradient: its input is the features.
"""

from __future__ import annotations

from benchmark.cost.roofline import featurizer_flops, joint_flops, predictor_flops


def conv_layers(enc: dict) -> list[tuple[int, int, int, int, int, int]]:
    """(cin, cout, kernel, stride, dilation, lookahead) of every encoder
    convolution in order, the 1x1 residual and output products included as
    kernel-1 convolutions; a residual is marked by stride 0 (it runs at its
    block's input length and does not change the running length)."""
    first = enc["blocks"][0]["in_channels"]
    out = [(enc["input_features"], first, enc["prologue_kernel_size"],
            enc["prologue_stride"], enc.get("prologue_dilation", 1), 0)]
    for b in enc["blocks"]:
        out.append((b["in_channels"], b["out_channels"], 1, 0, 1, 0))
        for i in range(b["num_sub_blocks"]):
            cin = b["in_channels"] if i == 0 else b["out_channels"]
            out.append((cin, b["out_channels"], b["kernel_size"], 1, 1,
                        b.get("additional_context", 0)))
    last = enc["blocks"][-1]["out_channels"]
    out.append((last, enc["epilogue_features"], enc["epilogue_kernel_size"],
                enc.get("epilogue_stride", 1), enc.get("epilogue_dilation", 2), 0))
    out.append((enc["epilogue_features"], enc["output_features"], 1, 1, 1, 0))
    return out


def _out_len(n: int, k: int, s: int, d: int, look: int) -> int:
    pad = (k - 1) * d - s + 1 - look
    return max((n + pad - d * (k - 1) - 1) // s + 1, 0)


def encoder_flops(enc: dict, frames: int) -> tuple[float, int]:
    """(forward flops, output frames) of the encoder over ``frames``
    feature frames of one utterance."""
    flops, n = 0.0, frames
    for cin, cout, k, s, d, look in conv_layers(enc):
        if s == 0:  # a residual product at the block input's length
            flops += 2.0 * n * cin * cout
            continue
        n = _out_len(n, k, s, d, look)
        flops += 2.0 * n * cin * cout * k
    return flops, n


def encoder_train_flops(enc: dict, frames: int) -> tuple[float, int]:
    """(forward and backward flops, output frames) of the encoder over
    ``frames`` feature frames of one utterance: the backward is twice the
    forward, less the first convolution's input gradient."""
    fwd, t = encoder_flops(enc, frames)
    cin, cout, k, s, d, look = conv_layers(enc)[0]
    return 3.0 * fwd - 2.0 * _out_len(frames, k, s, d, look) * cin * cout * k, t


def train_step_flops(model: dict, frames, tokens) -> float:
    """Useful operations of one training step over utterances of
    ``frames`` feature frames and ``tokens`` target tokens each."""
    total = 0.0
    for f, u in zip(frames, tokens):
        f, u1 = int(f), int(u) + 1
        enc, t = encoder_train_flops(model["encoder"], f)
        total += enc
        total += featurizer_flops(model["featurizer"], f)
        total += predictor_flops(model["predictor"], u1)
        total += joint_flops(model, t, u1)
    return total
