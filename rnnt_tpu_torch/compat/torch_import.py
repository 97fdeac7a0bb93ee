"""Reference (PyTorch RNN-T) checkpoints into the port.

Port of ``rnnt_tpu/compat/torch_import.py``: a reference state dict (the
``save_model`` wrapper ``{"model_state_dict": ...}`` or a bare state dict;
with or without DDP's ``module.`` prefix) becomes the flat JAX-layout
numpy tree of ``compat/jax_params.py`` (``/``-joined pytree paths, the
leaves the JAX importer produces), and from there an ``RNNT`` through
``jax_params.from_flat``.  The only layout code here is reference -> JAX:

* ``Conv1d`` weight ``(Cout, Cin, K)`` -> causal-conv ``w`` ``(K, Cin, Cout)``;
* 1x1 ``Conv1d`` (the residual and output convs) -> ``w`` ``(Cin, Cout)``;
* ``Linear`` weight ``(out, in)`` -> ``w`` ``(in, out)``;
* batch-norm running statistics -> the ``state`` tree (``mean``, ``var``);
  instance norms carry none, ``instance`` (no affine) no parameters either.

The encoder is one flat ``Sequential`` named ``blocks`` in the reference:
prologue conv, norm, GELU, one ``JasperBlock`` per block, epilogue conv,
norm, GELU, the 1x1 output conv; its indices are replayed from the spec.
"""

from __future__ import annotations

import numpy as np

from rnnt_tpu_torch.compat.jax_params import flatten_tree
from rnnt_tpu_torch.models.encoder import EncoderSpec
from rnnt_tpu_torch.models.predictor import ConvPredictorSpec, LSTMPredictorSpec
from rnnt_tpu_torch.models.rnnt import RNNTSpec


def _np(x) -> np.ndarray:
    """A float32 numpy copy (never a view of the tensor's memory)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float32, copy=True)


def _linear(sd, prefix: str) -> dict:
    """``Linear`` (out, in) -> {"w": (in, out), "b": (out,) when present}."""
    p = {"w": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _scale_bias(sd, prefix: str) -> dict:
    """A layer norm's or an affine norm's ``weight`` and ``bias``."""
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _causal_conv(sd, prefix: str) -> dict:
    """Reference ``CausalConv1d`` (inner ``conv``) -> {"w": (K, Cin, Cout), "b"}."""
    w = _np(sd[f"{prefix}.conv.weight"])
    return {"w": np.ascontiguousarray(np.transpose(w, (2, 1, 0))),
            "b": _np(sd[f"{prefix}.conv.bias"])}


def _conv1x1(sd, prefix: str) -> dict:
    w = _np(sd[f"{prefix}.weight"])  # (Cout, Cin, 1)
    return {"w": np.ascontiguousarray(w[:, :, 0].T), "b": _np(sd[f"{prefix}.bias"])}


def _norm(sd, prefix: str, norm_type: str) -> tuple[dict, dict]:
    """(params, state) of one norm in ``ops/norm.py``'s layout."""
    if norm_type == "instance":
        return {}, {}
    if norm_type == "instance_affine":
        return _scale_bias(sd, prefix), {}
    if norm_type == "batch":
        return _scale_bias(sd, prefix), {"mean": _np(sd[f"{prefix}.running_mean"]),
                                         "var": _np(sd[f"{prefix}.running_var"])}
    raise ValueError(f"unknown norm_type: {norm_type}")


def import_encoder(sd, spec: EncoderSpec, prefix: str = "") -> tuple[dict, dict]:
    """Reference ``AudioEncoder`` state dict -> (params, state) pytrees."""
    pre = f"{prefix}blocks"
    norm, state = _norm(sd, f"{pre}.1", spec.norm_type)
    params = {"prologue": {"conv": _causal_conv(sd, f"{pre}.0"), "norm": norm}}
    states = {"prologue": state}
    idx = 3  # past the prologue's conv, norm and GELU
    blocks, block_states = [], []
    for b in spec.blocks:
        bpre = f"{pre}.{idx}"
        norms = [_norm(sd, f"{bpre}.norms.{i}", b.norm_type)
                 for i in range(b.num_sub_blocks)]
        res_norm, res_state = _norm(sd, f"{bpre}.residual_norm", b.norm_type)
        blocks.append({"convs": [_causal_conv(sd, f"{bpre}.convs.{i}")
                                 for i in range(b.num_sub_blocks)],
                       "norms": [p for p, _ in norms],
                       "residual_conv": _conv1x1(sd, f"{bpre}.residual_conv"),
                       "residual_norm": res_norm})
        block_states.append({"norms": [s for _, s in norms], "residual_norm": res_state})
        idx += 1
    params["blocks"], states["blocks"] = blocks, block_states
    norm, state = _norm(sd, f"{pre}.{idx + 1}", spec.norm_type)
    params["epilogue"] = {"conv": _causal_conv(sd, f"{pre}.{idx}"), "norm": norm}
    states["epilogue"] = state
    params["out"] = _conv1x1(sd, f"{pre}.{idx + 3}")
    return params, states


def import_conv_predictor(sd, prefix: str = "") -> dict:
    """Reference ``ConvPredictor`` -> params."""
    return {"embedding": _np(sd[f"{prefix}embedding.weight"]),
            "input_ln": _scale_bias(sd, f"{prefix}input_layer_norm"),
            "conv1": _causal_conv(sd, f"{prefix}conv1"),
            "conv2": _causal_conv(sd, f"{prefix}conv2"),
            "linear": _linear(sd, f"{prefix}linear"),
            "output_ln": _scale_bias(sd, f"{prefix}output_layer_norm")}


def import_lstm_predictor(sd, spec: LSTMPredictorSpec, prefix: str = "") -> dict:
    """Reference ``LSTMPredictor`` -> params.  Its gates are in torch's
    chunk order i, f, g, o, the port's ``chunk(4)`` order: no permutation."""
    layers = []
    for i in range(spec.num_lstm_layers):
        lpre = f"{prefix}lstm_layers.{i}"
        layer = {"x2g": _linear(sd, f"{lpre}.x2g"), "p2g": _linear(sd, f"{lpre}.p2g")}
        if spec.lstm_layer_norm:
            layer["c_norm"] = _scale_bias(sd, f"{lpre}.c_norm")
            layer["g_norm"] = _scale_bias(sd, f"{lpre}.g_norm")
        layers.append(layer)
    return {"embedding": _np(sd[f"{prefix}embedding.weight"]),
            "input_ln": _scale_bias(sd, f"{prefix}input_layer_norm"),
            "layers": layers,
            "linear": _linear(sd, f"{prefix}linear"),
            "output_ln": _scale_bias(sd, f"{prefix}output_layer_norm")}


def import_joint(sd, prefix: str = "") -> dict:
    """Reference ``JointNetwork`` -> params; the per-side projections only
    where the reference has them."""
    params = {"out": _linear(sd, f"{prefix}joint_ln")}
    if f"{prefix}audio_ln.weight" in sd:
        params["audio_proj"] = _linear(sd, f"{prefix}audio_ln")
    if f"{prefix}text_ln.weight" in sd:
        params["text_proj"] = _linear(sd, f"{prefix}text_ln")
    return params


def _model_state_dict(sd) -> dict:
    """The reference model's state dict inside a ``save_model`` checkpoint
    or a bare one, DDP's ``module.`` prefix stripped."""
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    if any(k.startswith("module.") for k in sd):
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return sd


def import_reference_state_dict(sd, spec: RNNTSpec) -> tuple[dict, dict]:
    """A reference ``RNNTModel`` state dict (or checkpoint) -> (params,
    state) as flat JAX-layout numpy trees: ``"encoder/blocks/0/convs/1/w"``
    -> array, the state under ``"encoder/..."``."""
    sd = _model_state_dict(sd)
    enc, enc_state = import_encoder(sd, spec.encoder, "encoder.")
    if isinstance(spec.predictor, ConvPredictorSpec):
        pred = import_conv_predictor(sd, "predictor.")
    elif isinstance(spec.predictor, LSTMPredictorSpec):
        pred = import_lstm_predictor(sd, spec.predictor, "predictor.")
    else:
        raise TypeError(f"unknown predictor spec: {type(spec.predictor)}")
    params = {"encoder": enc, "predictor": pred, "joint": import_joint(sd, "joint.")}
    return flatten_tree(params), flatten_tree({"encoder": enc_state})
