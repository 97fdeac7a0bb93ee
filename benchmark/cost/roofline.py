"""Peaks of one H100 and the operations and bytes the timed work needs.

The K1/K2 bounds are frozen copies of ``chip_smoke.py``'s ``k1_bound_ms``
and ``k2_bound_ms`` (with its ``PEAK_BF16_FLOPS`` and ``PEAK_BYTES``): the
larger of the operations at the bf16 peak and every input read and output
written once at the HBM bandwidth.  ``k1_work_ms`` and ``k2_work_ms`` give
the same bound for the work a batch needs: its rows' unpadded lattices
(t, u + 1), ``cells`` = the sum of t (u + 1), ``frames`` = the sum of t,
``tokens`` = the sum of u + 1.  The kernels run over the padded (B, T',
U+1) lattice; what they do beyond the needed work is not counted, so a
kernel that skips the padding reads higher.

The rest counts the useful operations of the parts of a training step
that the architectures share, at one utterance's unpadded lengths: the
featurizer's products forward (the DFT, and for ``mel`` the filterbank),
and the forward and backward of the predictor's and the joint's output
products.  A product's backward is two products (the input's and the
weight's gradients); nothing recomputed counts.  Each architecture's
``benchmark/cost/<arch>.py`` adds its encoder in ``train_step_flops``.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def k1_work_ms(cells, frames, tokens, H, V) -> float:
    flops = 2.0 * cells * H * V
    nbytes = 2 * (frames * H + tokens * H + H * V) + 4 * V + 4 * tokens + 3 * 4 * cells
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def k2_work_ms(cells, frames, tokens, H, V) -> float:
    flops = 6.0 * cells * H * V
    nbytes = (2 * (frames * H + tokens * H + H * V) + 4 * V + 4 * tokens + 4 * 4 * cells
              + 4 * (frames * H + tokens * H + H * V + V))
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def k1_bound_ms(B, T, U1, H, V) -> float:
    """K1's bound on a dense (B, T, U1) lattice (chip_smoke.py's)."""
    return k1_work_ms(B * T * U1, B * T, B * U1, H, V)


def k2_bound_ms(B, T, U1, H, V) -> float:
    """K2's bound on a dense (B, T, U1) lattice (chip_smoke.py's)."""
    return k2_work_ms(B * T * U1, B * T, B * U1, H, V)


def featurizer_flops(fz: dict, frames: int) -> float:
    """The featurizer's products over ``frames`` frames (no gradient)."""
    bins = fz["n_fft"] // 2 + 1
    flops = 2.0 * frames * 2 * bins * fz["n_fft"]
    if fz["kind"] == "mel":
        flops += 2.0 * frames * bins * fz["num_mels"]
    return flops


def predictor_flops(pred: dict, u1: int) -> float:
    """Forward and backward of the predictor's products over ``u1``
    positions: the conv predictor's two convolutions (3 and 5 taps) and
    output layer, or each LSTM layer's ``x2g`` and ``p2g`` (four gates) and
    the output layer."""
    e, out = pred["symbol_embedding_dim"], pred["output_dim"]
    if pred["kind"] == "conv":
        return 3.0 * 2.0 * u1 * (e * e * 3 + e * e * 5 + e * out)
    if pred["kind"] == "lstm":
        h = pred["lstm_hidden_dim"]
        per = sum(((e if i == 0 else h) + h) * 4 * h for i in range(pred["num_lstm_layers"]))
        return 3.0 * 2.0 * u1 * (per + h * out)
    raise ValueError(f"predictor kind {pred['kind']!r} is not counted")


def joint_flops(model: dict, t: int, u1: int) -> float:
    """Forward and backward of the joint's output product over a (t, u1)
    lattice."""
    H, V = model["joint"]["hidden_features"], model["num_total_symbols"]
    return 3.0 * 2.0 * t * u1 * H * V
