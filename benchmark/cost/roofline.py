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

``train_step_flops`` counts the useful operations of one training step:
the featurizer's DFT product forward, and the forward and backward of the
encoder's convolutions, the predictor and the joint's output product at
each utterance's unpadded lengths.  A product's backward is two products
(the input's and the weight's gradients), except where the input needs no
gradient (the encoder's first convolution); nothing recomputed counts.
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


def train_step_flops(model: dict, frames, tokens) -> float:
    """Useful operations of one training step over utterances of
    ``frames`` feature frames and ``tokens`` target tokens each."""
    enc, pred = model["encoder"], model["predictor"]
    fz = model["featurizer"]
    H, V = model["joint"]["hidden_features"], model["num_total_symbols"]
    bins = fz["n_fft"] // 2 + 1
    first = conv_layers(enc)[0]
    total = 0.0
    for f, u in zip(frames, tokens):
        f, u1 = int(f), int(u) + 1
        fwd, t = encoder_flops(enc, f)
        # backward: 2x forward, less the first convolution's input gradient
        first_fwd = 2.0 * _out_len(f, *first[2:]) * first[0] * first[1] * first[2]
        total += 3.0 * fwd - first_fwd
        total += 2.0 * f * 2 * bins * fz["n_fft"]
        e = pred["symbol_embedding_dim"]
        total += 3.0 * 2.0 * u1 * (e * e * 3 + e * e * 5 + e * pred["output_dim"])
        total += 3.0 * 2.0 * t * u1 * H * V
    return total
