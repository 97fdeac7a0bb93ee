"""Guards of the port: rnnt_tpu_torch and chip_smoke.py import neither jax
nor rnnt_tpu, and every entry point refuses to run without CUDA unless it
is asked for the CPU."""

import ast
import json
from pathlib import Path

import pytest
import torch

from rnnt_tpu_torch.cli import eval as cli_eval
from rnnt_tpu_torch.cli import infer as cli_infer
from rnnt_tpu_torch.cli import serve as cli_serve
from rnnt_tpu_torch.cli import train as cli_train
from rnnt_tpu_torch.config.config import apply_overrides, load_config, resolve_config
from rnnt_tpu_torch.train.loop import evaluate, train
from rnnt_tpu_torch.utils import resolve_device

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "rnnt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_rnnt_tpu_imports(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "rnnt_tpu", "optax", "orbax"), (path, mod)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_refuses_missing_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_eval_refuses_missing_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_eval.main([str(tmp_path)])


def test_cli_serve_refuses_missing_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main([str(tmp_path), "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main([str(tmp_path), "--port", "0", "--device", "cuda"])


def test_cli_infer_refuses_missing_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_infer.main([str(tmp_path), str(tmp_path / "a.wav")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_infer.main([str(tmp_path), str(tmp_path / "a.wav"), "--streaming"])


def test_evaluate_refuses_missing_cuda(no_cuda, tmp_path):
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table
    from rnnt_tpu_torch.config.config import build_model_spec
    from rnnt_tpu_torch.models.rnnt import rnnt_init

    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    cfg = apply_overrides(load_config(resolve_config("tiny_conv")), [
        "tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}"])
    model = rnnt_init(build_model_spec(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate(cfg, model, batches=[])
    assert evaluate(cfg, model, device="cpu", batches=[])["utterances"] == 0


def test_cli_train_refuses_missing_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--config", "tiny_conv", "--output-base", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--config", "tiny_conv", "--device", "cuda",
                        "--output-base", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # refused before writing a run


def test_train_refuses_missing_cuda(no_cuda, tmp_path):
    cfg = load_config(resolve_config("tiny_conv"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, output_base=tmp_path, max_steps=1)
    assert not any(tmp_path.iterdir())


def test_kernels_refuse_other_devices():
    """Wrappers take the plain path only for CPU tensors."""
    from rnnt_tpu_torch.ops.lattice_pallas import (
        alpha_chain_forward, alpha_forward, beta_backward, beta_chain_backward)
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_backward, fused_joint_outputs)
    from rnnt_tpu_torch.ops.window_gather import gather_windows

    meta = torch.empty((1, 2, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        alpha_forward(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        fused_joint_outputs(meta, meta, meta, meta, meta, 0)
    with pytest.raises(ValueError, match="K4 runs on CUDA or the CPU"):
        beta_backward(meta, meta, meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="K2 runs on CUDA or the CPU"):
        fused_joint_backward(meta, meta, meta, meta, meta, 0, meta, meta, meta,
                             meta)
    with pytest.raises(ValueError, match="K5 runs on CUDA or the CPU"):
        gather_windows(meta[0], meta[0], 128)
    with pytest.raises(ValueError, match="K6 runs on CUDA or the CPU"):
        alpha_chain_forward(meta, meta, meta, meta, 3, meta)
    with pytest.raises(ValueError, match="K7 runs on CUDA or the CPU"):
        beta_chain_backward(meta, meta, meta, meta, meta, meta, meta, 3, meta)
    with pytest.raises(ValueError, match="t0 >= 0"):
        alpha_chain_forward(meta, meta, meta, meta, -1, meta)
