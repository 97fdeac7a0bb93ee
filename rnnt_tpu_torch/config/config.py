"""Config system: YAML -> typed dataclasses -> model / featurizer specs.

The port's own copy of ``rnnt_tpu/config/config.py``: the same dataclass
schema, ``load_config``, Hydra-style ``apply_overrides``, and the spec
builders, returning the port's spec classes.  It reads the same YAML files
(``rnnt_tpu/config/configs/*.yaml``) as data and never edits them.  Fields
that select paths not ported yet (the LSTM predictor) are kept so that
every config parses and builds the same spec; ``check_mesh`` holds the
guards of a multi-rank run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import yaml

from rnnt_tpu_torch.models.encoder import EncoderSpec, JasperBlockSpec
from rnnt_tpu_torch.models.joint import JointSpec
from rnnt_tpu_torch.models.predictor import ConvPredictorSpec, LSTMPredictorSpec
from rnnt_tpu_torch.models.rnnt import RNNTSpec
from rnnt_tpu_torch.ops.stft import FeaturizerSpec

# The YAML configs are shared with the JAX package and read as data.
CONFIG_DIR = Path(__file__).resolve().parents[2] / "rnnt_tpu" / "config" / "configs"


def resolve_config(name: str | Path) -> Path:
    """A config name (``base_convjs``) in the shared config directory, or a
    path to a YAML file."""
    p = Path(name)
    if p.suffix in (".yaml", ".yml") and p.exists():
        return p
    cand = CONFIG_DIR / f"{name}.yaml"
    if cand.exists():
        return cand
    raise FileNotFoundError(f"config {name!r} not found (looked in {CONFIG_DIR})")


# The schema is the JAX package's, field for field (see that module for
# what each training, data and mesh knob does there); this slice reads the
# model, featurizer, tokenizer, eval and synthetic-data fields.

@dataclass
class TokenizerConfig:
    spm_model: str = ""
    vocab_json: str = ""


@dataclass
class FeaturizerConfig:
    kind: str = "spectrogram"  # spectrogram | old_piecewise | mel | log
    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 160
    num_mels: int = 0
    sample_rate: int = 16000
    mean: Any = 15.0           # float or list (per-channel)
    invstddev: Any = 0.25
    center: bool = False
    global_stats: str = ""


@dataclass
class PredictorConfig:
    kind: str = "conv"  # conv | lstm
    output_dim: int = 1024
    symbol_embedding_dim: int = 512
    dropout: float = 0.3
    num_lstm_layers: int = 2
    lstm_hidden_dim: int = 1024
    lstm_layer_norm: bool = True


@dataclass
class BlockConfig:
    kernel_size: int
    in_channels: int
    out_channels: int
    dropout: float
    num_sub_blocks: int
    norm_type: str = ""
    additional_context: int = 0


@dataclass
class EncoderConfig:
    input_features: int = 201
    norm_type: str = "instance_affine"
    prologue_kernel_size: int = 11
    prologue_stride: int = 2
    prologue_dilation: int = 1
    blocks: list[BlockConfig] = field(default_factory=list)
    epilogue_features: int = 512
    epilogue_kernel_size: int = 29
    epilogue_stride: int = 1
    epilogue_dilation: int = 2
    output_features: int = 1024


@dataclass
class JointConfig:
    audio_features: int = -1
    text_features: int = -1
    hidden_features: int = 1024


@dataclass
class OptimizerConfig:
    lr: float = 3e-4
    eps: float = 1e-8
    betas: tuple = (0.95, 0.9999)
    weight_decay: float = 0.01


@dataclass
class LRScheduleConfig:
    warmup_steps: int = 2000
    min_lr_ratio: float = 0.05
    total_steps: int = 0  # 0 => derived from dataset size at train time


@dataclass
class TrainingConfig:
    precision: str = "bf16"        # bf16 | fp32 (activation compute dtype)
    seed: int = 0
    num_epochs: int = 1
    total_steps: int = 0           # overrides epochs when > 0
    log_steps: int = 50
    hist_steps: int = 2000
    eval_steps: int = 20000
    eval_max_elements: int = 1000
    checkpoint_steps: int = 100000
    global_batch_size: int = 4
    clip_grad_norm: float = 10.0
    loss_chunk_size: int = 16
    loss_impl: str = "auto"  # auto | chunked | pallas | pruned
    pruned_band: int = 16
    pruned_simple_scale: float = 0.5
    pruned_scale: float = 1.0
    pruned_warmup_steps: int = 0
    rnnt_grad_clamp: float = -1.0
    lattice_shard_t: bool = False
    accumulate_steps: int = 1   # gradient accumulation microbatches
    spec_augment: bool = False  # device-side time/freq masking (train only)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_schedule: LRScheduleConfig = field(default_factory=LRScheduleConfig)
    frame_buckets: list[int] = field(default_factory=lambda: [512, 1024, 2048])
    token_buckets: list[int] = field(default_factory=lambda: [64, 128, 256])


@dataclass
class DataConfig:
    dataset: str = "synthetic"   # synthetic | librispeech | commonvoice
    cache_dir: str = ""
    train_splits: list[str] = field(default_factory=lambda: ["train.clean.100"])
    eval_split: str = "validation.clean"
    num_workers: int = 2
    worker_mode: str = "thread"  # thread | process (forked row workers)
    augment: bool = True
    augment_device: bool | str = False
    augmentations: list = field(default_factory=list)
    wire_dtype: str = "int16"
    staging: str = "auto"   # auto | stream | device
    device_cache_budget_mb: int = 2048
    synthetic_size: int = 256
    synthetic_seconds: float = 3.0
    synthetic_max_words: int = 12   # larger => flagship-scale target U
    eval_on_train: bool = False


@dataclass
class MeshConfig:
    data: int = -1
    model: int = 1


@dataclass
class Config:
    model_name: str = "rnnt_tpu"
    num_text_tokens: int = 1023
    num_total_symbols: int = 1024
    blank_idx: int = 1023
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    featurizer: FeaturizerConfig = field(default_factory=FeaturizerConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _from_dict(cls, d: dict):
    if d is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = fields[k].type
        if dataclasses.is_dataclass(_resolve(ftype)) and isinstance(v, dict):
            kwargs[k] = _from_dict(_resolve(ftype), v)
        elif k == "blocks" and isinstance(v, list):
            kwargs[k] = [_from_dict(BlockConfig, b) for b in v]
        else:
            kwargs[k] = v
    return cls(**kwargs)


_TYPES = {c.__name__: c for c in (
    TokenizerConfig, FeaturizerConfig, PredictorConfig, BlockConfig,
    EncoderConfig, JointConfig, OptimizerConfig, LRScheduleConfig,
    TrainingConfig, DataConfig, MeshConfig, Config)}


def _resolve(t):
    if isinstance(t, str):
        return _TYPES.get(t, str)
    return t


def load_config(path: str | Path) -> Config:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return _from_dict(Config, raw)


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Hydra-style dotted overrides: each item is ``a.b.c=value`` with the
    value YAML-parsed (ints/floats/bools/lists work).  Mutates and returns
    cfg; unknown paths raise."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key.path=value")
        path, _, raw = item.partition("=")
        parts = path.strip().split(".")
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise KeyError(f"unknown config path {path!r} (at {p!r})")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key {path!r}")
        setattr(obj, leaf, _coerce(yaml.safe_load(raw), getattr(obj, leaf),
                                   path))
    return cfg


def _coerce(value, current, path: str):
    """Coerce a YAML-parsed override to the existing field's type.

    PyYAML is YAML 1.1: ``1e-4`` (no dot before the exponent) parses as the
    STRING ``"1e-4"``, so ``training.optimizer.lr=1e-4`` would silently
    assign a str without this.  int->float widens; anything else that
    doesn't match the current field's type raises."""
    if current is None or value is None:
        return value
    if path.strip() == "data.augment_device":
        # bool | "full", whichever the field holds now (the reference
        # coerces to the current value's type, so a YAML "full" could not
        # be overridden with false or true).
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false", "full"):
            return {"true": True, "false": False}.get(value.lower(), "full")
        raise ValueError(f"override {path!r}: expected true, false or full, "
                         f"got {value!r}")
    want = type(current)
    if isinstance(value, want) and not (want is float and
                                        isinstance(value, bool)):
        return value
    if want is float and isinstance(value, (int, str)) and not isinstance(
            value, bool):
        try:
            return float(value)
        except ValueError:
            pass
    if want is int and isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
    if want is bool and isinstance(value, str):
        low = value.lower()
        if low in ("true", "false"):
            return low == "true"
        if low == "full":  # data.augment_device: bool | "full"
            return low     # normalized: "FULL" must still == "full" downstream
    if isinstance(current, (list, tuple)) and isinstance(value,
                                                         (list, tuple)):
        return want(value)
    raise ValueError(
        f"override {path!r}: cannot coerce {value!r} "
        f"({type(value).__name__}) to {want.__name__}")


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str | Path) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)


def check_mesh(cfg: Config, data: int, model: int) -> None:
    """The training guards of a data x model mesh: ``lattice_shard_t``
    needs a ``model`` axis to shard T over, and the global batch must split
    evenly over the ``data`` axis (the reference shrinks the data axis
    until it divides, ``rnnt_tpu/train/loop.py:158-164``; the port says
    so instead of training on another layout).  A ``model`` axis without
    ``lattice_shard_t`` is tensor-parallel (parallel/mesh.py), which every
    loss but ``chunked`` runs (its joint has no vocabulary-sharded
    version)."""
    if cfg.training.lattice_shard_t and model == 1:
        raise ValueError("training.lattice_shard_t shards the lattice's T axis "
                         "over mesh.model ranks; mesh.model is 1")
    if model > 1 and not cfg.training.lattice_shard_t \
            and cfg.training.loss_impl == "chunked":
        raise ValueError("training.loss_impl=chunked has no tensor-parallel joint; "
                         "use auto, pallas or pruned with mesh.model > 1")
    if cfg.training.global_batch_size % data:
        raise ValueError(f"training.global_batch_size="
                         f"{cfg.training.global_batch_size} does not divide "
                         f"over mesh.data={data} ranks")


def build_featurizer_spec(cfg: Config) -> FeaturizerSpec:
    fc = cfg.featurizer
    mean, invstd = fc.mean, fc.invstddev
    if fc.global_stats:
        import json
        stats = json.loads(Path(fc.global_stats).read_text())
        # Accept "mean" and the original project's "means".
        mean = stats.get("mean", stats.get("means"))
        invstd = stats["invstddev"]
    log_mode = {"spectrogram": "piecewise", "old_piecewise": "old_piecewise",
                "mel": "old_piecewise", "log": "log"}[fc.kind]
    return FeaturizerSpec(
        n_fft=fc.n_fft, win_length=fc.win_length, hop_length=fc.hop_length,
        num_mels=fc.num_mels if fc.kind == "mel" else 0,
        sample_rate=fc.sample_rate, log_mode=log_mode, center=fc.center,
        mean=tuple(mean) if isinstance(mean, (list, tuple)) else float(mean),
        invstddev=(tuple(invstd) if isinstance(invstd, (list, tuple))
                   else float(invstd)),
    )


def build_model_spec(cfg: Config) -> RNNTSpec:
    ec = cfg.encoder
    blocks = tuple(
        JasperBlockSpec(
            kernel_size=b.kernel_size, in_channels=b.in_channels,
            out_channels=b.out_channels, dropout=b.dropout,
            num_sub_blocks=b.num_sub_blocks,
            norm_type=b.norm_type or ec.norm_type,
            additional_context=b.additional_context)
        for b in ec.blocks)
    encoder = EncoderSpec(
        input_features=ec.input_features,
        prologue_kernel_size=ec.prologue_kernel_size,
        prologue_stride=ec.prologue_stride,
        prologue_dilation=ec.prologue_dilation,
        blocks=blocks,
        epilogue_features=ec.epilogue_features,
        epilogue_kernel_size=ec.epilogue_kernel_size,
        epilogue_stride=ec.epilogue_stride,
        epilogue_dilation=ec.epilogue_dilation,
        output_features=ec.output_features,
        norm_type=ec.norm_type)

    pc = cfg.predictor
    if pc.kind == "conv":
        predictor = ConvPredictorSpec(
            num_symbols=cfg.num_total_symbols, output_dim=pc.output_dim,
            symbol_embedding_dim=pc.symbol_embedding_dim, dropout=pc.dropout)
    elif pc.kind == "lstm":
        predictor = LSTMPredictorSpec(
            num_symbols=cfg.num_total_symbols, output_dim=pc.output_dim,
            symbol_embedding_dim=pc.symbol_embedding_dim,
            num_lstm_layers=pc.num_lstm_layers,
            lstm_hidden_dim=pc.lstm_hidden_dim,
            lstm_layer_norm=pc.lstm_layer_norm,
            lstm_dropout=pc.dropout)
    else:
        raise ValueError(f"unknown predictor kind: {pc.kind}")

    joint = JointSpec(
        audio_features=cfg.joint.audio_features,
        text_features=cfg.joint.text_features,
        hidden_features=cfg.joint.hidden_features,
        num_classes=cfg.num_total_symbols)

    if cfg.training.loss_impl == "pruned" and cfg.training.lattice_shard_t:
        # The pruned banded DP never materializes the full-T lattice per
        # device the way lattice_shard_t addresses (its band is O(T*band)),
        # and the two code paths don't compose — fail at config build
        # rather than silently dropping the sharding flag.
        raise ValueError(
            "training.lattice_shard_t is not supported with "
            "training.loss_impl='pruned': the banded lattice is already "
            "O(T*band) per device; use loss_impl='chunked' (or 'auto') for "
            "the T-sharded lattice, or drop lattice_shard_t for the pruned "
            "loss")

    return RNNTSpec(encoder=encoder, predictor=predictor, joint=joint,
                    loss_chunk_size=cfg.training.loss_chunk_size,
                    loss_impl=cfg.training.loss_impl,
                    pruned_band=cfg.training.pruned_band,
                    pruned_simple_scale=cfg.training.pruned_simple_scale,
                    pruned_scale=cfg.training.pruned_scale,
                    grad_clamp=cfg.training.rnnt_grad_clamp,
                    lattice_shard_t=cfg.training.lattice_shard_t)
