"""Useful operations of a FastConformer-Transducer's training step
(``benchmark/reference/fastconformer.py``), at each utterance's unpadded
lengths: the front end's products forward (the DFT and the mel
filterbank), and the forward and backward of every product of the
subsampling, the encoder's layers, the LSTM, both joint projections and
the joint's output.  A product's backward is two products (the input's and
the weight's gradients); the first convolution's input is the features
and the position projection's the fixed table, so neither has an input
gradient.  Nothing recomputed counts.

``attn_work`` is what the attention core (the SDPA call) needs of a layer
and a row, for ``benchmark/layers/attn_roofline.py``.
"""

from __future__ import annotations

import math

from benchmark.cost.roofline import joint_flops


def _half(n: int) -> int:
    return (n + 2 - 3) // 2 + 1


def frontend_flops(fz: dict, frames: int) -> float:
    bins = fz["n_fft"] // 2 + 1
    return 2.0 * frames * 2 * bins * fz["n_fft"] + 2.0 * frames * bins * fz["num_mels"]


def subsampling_train_flops(enc: dict, frames: int) -> tuple[float, int]:
    """(forward and backward flops, output frames) of the subsampling."""
    C = enc["subsampling_conv_channels"]
    t, f = _half(frames), _half(enc["input_features"])
    flops = 2.0 * 2.0 * t * f * C * 9             # conv0: forward and weight gradient
    for _ in range(int(round(math.log2(enc["subsampling_factor"]))) - 1):
        t, f = _half(t), _half(f)
        flops += 3.0 * 2.0 * t * f * C * (9 + C)   # depthwise and pointwise
    flops += 3.0 * 2.0 * t * C * f * enc["d_model"]
    return flops, t


def layer_train_flops(enc: dict, t: int) -> float:
    """Forward and backward flops of one layer over t frames."""
    d, e, K = enc["d_model"], enc["ff_expansion_factor"], enc["conv_kernel_size"]
    ff = 2 * 2.0 * 2.0 * t * d * e * d                   # FF1 and FF2, two products each
    proj = 4 * 2.0 * t * d * d                           # q, k, v, out
    scores = 2.0 * t * t * d + 2.0 * t * (2 * t - 1) * d + 2.0 * t * t * d   # ac, bd, PV
    conv = 2.0 * t * d * 2 * d + 2.0 * t * d * K + 2.0 * t * d * d
    pos = 2.0 * 2.0 * (2 * t - 1) * d * d                # forward and weight gradient
    return 3.0 * (ff + proj + scores + conv) + pos


def attn_work(d: int, heads: int, t: int) -> tuple[float, float]:
    """(operations, bytes) the attention core needs for one layer and row
    of t frames, forward and backward: q k^T and P v forward, dV, dP, dQ
    and dK backward (12 t^2 d); in bf16, q, k, v read and o written
    forward, q, k, v, o, dO read and dq, dk, dv written backward (12 t d),
    and the bias (heads x t x t) read twice and its gradient written once,
    with ``heads`` heads."""
    flops = 12.0 * t * t * d
    nbytes = 2.0 * (12 * t * d + 3 * heads * t * t)
    return flops, nbytes


def lstm_train_flops(pred: dict, u1: int) -> float:
    e, h = pred["symbol_embedding_dim"], pred["lstm_hidden_dim"]
    per = sum(((e if i == 0 else h) + h) * 4 * h for i in range(pred["num_lstm_layers"]))
    return 3.0 * 2.0 * u1 * per


def train_step_flops(model: dict, frames, tokens) -> float:
    """Useful operations of one training step over utterances of
    ``frames`` feature frames and ``tokens`` target tokens each."""
    enc, jc = model["encoder"], model["joint"]
    total = 0.0
    for f, u in zip(frames, tokens):
        f, u1 = int(f), int(u) + 1
        sub, t = subsampling_train_flops(enc, f)
        total += frontend_flops(model["featurizer"], f) + sub
        total += enc["num_layers"] * layer_train_flops(enc, t)
        total += lstm_train_flops(model["predictor"], u1)
        total += 3.0 * 2.0 * (t * jc["audio_features"] + u1 * jc["text_features"]) \
            * jc["hidden_features"]
        total += joint_flops(model, t, u1)
    return total
