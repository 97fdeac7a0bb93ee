"""Guards of the port: rnnt_tpu_torch and chip_smoke.py import neither jax
nor rnnt_tpu and build no path into rnnt_tpu/, the port's YAML configs are
byte-equal copies of the JAX package's, and every entry point refuses to
run without CUDA unless it is asked for the CPU."""

import ast
import json
from pathlib import Path

import pytest
import torch

from rnnt_tpu_torch.cli import calc_global_features as cli_cgf
from rnnt_tpu_torch.cli import eval as cli_eval
from rnnt_tpu_torch.cli import export as cli_export
from rnnt_tpu_torch.cli import import_torch as cli_import_torch
from rnnt_tpu_torch.cli import infer as cli_infer
from rnnt_tpu_torch.cli import run_bundle as cli_run_bundle
from rnnt_tpu_torch.cli import serve as cli_serve
from rnnt_tpu_torch.cli import sweep as cli_sweep
from rnnt_tpu_torch.cli import train as cli_train
from rnnt_tpu_torch.config.config import (
    CONFIG_DIR, apply_overrides, load_config, resolve_config)
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


def _into_jax_package(node) -> bool:
    """A string constant naming rnnt_tpu or a path under it."""
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.split("/")[0] == "rnnt_tpu")


def _jax_paths(path):
    """Lines where a path into rnnt_tpu/ is built: such a constant as an
    operand of ``/`` or an argument of ``os.path.join``, ``Path``,
    ``PurePath`` or ``joinpath``."""
    lines = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            operands = [node.left, node.right]
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            operands = node.args if name in ("join", "Path", "PurePath", "joinpath") else []
        else:
            continue
        lines += [node.lineno for x in operands if _into_jax_package(x)]
    return sorted(lines)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_into_rnnt_tpu(path):
    assert not _jax_paths(path), (path, _jax_paths(path))


def test_path_guard_sees_a_path_into_rnnt_tpu(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('from pathlib import Path\nimport os\n'
                   'A = Path(__file__).parents[2] / "rnnt_tpu" / "config"\n'
                   'B = os.path.join(ROOT, "rnnt_tpu/config/configs")\n'
                   'C = Path("rnnt_tpu")\nD = "rnnt_tpu/ops/x.py:65"\n')
    assert _jax_paths(bad) == [3, 4, 5]
    assert CONFIG_DIR == REPO / "rnnt_tpu_torch" / "config" / "configs"


JAX_CONFIGS = sorted((REPO / "rnnt_tpu" / "config" / "configs").glob("*.yaml"))


@pytest.mark.parametrize("jax_yaml", JAX_CONFIGS, ids=lambda p: p.stem)
def test_config_copies_equal_jax(jax_yaml):
    assert len(JAX_CONFIGS) == 9
    assert (CONFIG_DIR / jax_yaml.name).read_bytes() == jax_yaml.read_bytes()
    assert resolve_config(jax_yaml.stem) == CONFIG_DIR / jax_yaml.name


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


@pytest.mark.parametrize("entry", ["export", "run_bundle", "import_torch", "serve_bundle",
                                   "bundle_runtime"])
def test_deployment_entry_points_refuse_missing_cuda(no_cuda, tmp_path, entry):
    """The deployment path's entry points, by default and with --device
    cuda, before they read anything."""
    from rnnt_tpu_torch.runtime.bundle import BundleRuntime

    for name in ("manifest.json", "tokenizer.json", "encoder_streaming_states.json"):
        (tmp_path / name).write_text("{}")
    calls = {
        "export": lambda *dev: cli_export.main([str(tmp_path), *dev]),
        "run_bundle": lambda *dev: cli_run_bundle.main([str(tmp_path), "a.wav", *dev]),
        "import_torch": lambda *dev: cli_import_torch.main(
            [str(tmp_path / "a.pt"), str(tmp_path / "out"), "--config", "tiny_conv", *dev]),
        "serve_bundle": lambda *dev: cli_serve.main(
            [str(tmp_path), "--bundle", "--port", "0", *dev]),
        "bundle_runtime": lambda *dev: BundleRuntime(tmp_path, *dev[1:]),
    }
    for dev in ((), ("--device", "cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            calls[entry](*dev)
    assert not (tmp_path / "out").exists() and not (tmp_path / "export").exists()


@pytest.mark.parametrize("entry", ["calc_global_features", "sweep"])
def test_tool_entry_points_refuse_missing_cuda(no_cuda, tmp_path, entry):
    """The training tools, by default and with --device cuda, before they
    read a config or write a file (render_augments uses no device)."""
    out = tmp_path / "out"
    calls = {
        "calc_global_features": lambda *dev: cli_cgf.main(
            ["--config", "tiny_conv", "--out", str(out), *dev]),
        "sweep": lambda *dev: cli_sweep.main(
            ["--config", "tiny_conv", "--trials", "1", "--study", str(out),
             "--output-base", str(tmp_path / "exp"), *dev]),
    }
    for dev in ((), ("--device", "cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            calls[entry](*dev)
    assert not any(tmp_path.iterdir())


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
