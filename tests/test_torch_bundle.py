"""Export bundles of rnnt_tpu_torch against rnnt_tpu's on the CPU.

The same weights (a JAX init, batch-norm statistics drawn in [0.5, 1.5],
the blank bias raised so the untrained model emits a few tokens) go
through rnnt_tpu's ``cli.export`` (orbax checkpoint, StableHLO graphs) and
the port's (``params.npz``, ``torch.export`` graphs, ``--device cpu``), for
a small batch-norm encoder (the ``fullcausal`` spec of
tests/test_torch_streaming.py) and a narrow instance_affine one with
lookahead:

* ``manifest.json``, ``tokenizer.json`` and ``encoder_streaming_states.json``
  are equal;
* each of the five graphs agrees on the same inputs within 1e-5 of each
  output's scale (its largest magnitude, at least 1), every carry port
  included;
* rnnt_tpu's ``BundleRuntime.transcribe`` and the port's give equal tokens
  on two waves, offline and fed in 0.2 s pieces;
* with batch norm the port's bundle tokens equal its live
  ``StreamingSession``'s.

The two repaired reference defects, with the divergence pinned: a wave
shorter than the overlap is decoded by the port's ``flush`` as one padded
chunk, where rnnt_tpu's returns nothing; ``run_bundle --streaming-chunks``
prints flush's tokens as an increment, where rnnt_tpu's does not.  And
``runtime/bundle.py`` and ``cli/run_bundle.py`` import nothing of the
port's models, train, decode or ops.
"""

import ast
import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import export as jexport  # noqa: E402

from rnnt_tpu.cli import export as jexport_cli  # noqa: E402
from rnnt_tpu.cli import run_bundle as jrun_bundle  # noqa: E402
from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.models import rnnt as jrnnt  # noqa: E402
from rnnt_tpu.runtime.bundle import BundleRuntime as JBundleRuntime  # noqa: E402
from rnnt_tpu.train import checkpoint as jckpt  # noqa: E402
from rnnt_tpu.train.step import TrainState as JTrainState  # noqa: E402
from rnnt_tpu_torch.cli import export as texport_cli  # noqa: E402
from rnnt_tpu_torch.cli import run_bundle as trun_bundle  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import load_checkpoint, write_checkpoint  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.decode.streaming import StreamingSession  # noqa: E402
from rnnt_tpu_torch.runtime.bundle import BundleRuntime  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GRAPHS = ("featurize", "encoder", "encoder_streaming", "predictor", "joint")
PIECES = {i: "<unk>" if i == 0 else f"▁p{i}" for i in range(63)}

ENCODERS = {
    "fullcausal": """
  norm_type: batch
  blocks:
    - {kernel_size: 5, in_channels: 32, out_channels: 32, dropout: 0.0, num_sub_blocks: 2}
  epilogue_features: 32
  epilogue_kernel_size: 9""",
    "convjs_narrow": """
  norm_type: instance_affine
  blocks:
    - {kernel_size: 11, in_channels: 24, out_channels: 24, dropout: 0.0, num_sub_blocks: 2,
       additional_context: 2}
    - {kernel_size: 13, in_channels: 24, out_channels: 32, dropout: 0.0, num_sub_blocks: 2}
  epilogue_features: 40
  epilogue_kernel_size: 29""",
}
# Blank biases at which each untrained model emits a few tokens a second.
BLANK_BIAS = {"fullcausal": 0.6, "convjs_narrow": 0.9}

CFG = """model_name: bundle_{kind}
num_text_tokens: 63
num_total_symbols: 64
blank_idx: 63
tokenizer: {{spm_model: '', vocab_json: {vocab}}}
featurizer: {{kind: spectrogram, mean: 15.0, invstddev: 0.25}}
predictor: {{kind: conv, output_dim: 48, symbol_embedding_dim: 24, dropout: 0.0}}
encoder:
  input_features: 201
  prologue_kernel_size: 11
  prologue_stride: 2{encoder}
  epilogue_dilation: 2
  output_features: 48
joint: {{audio_features: -1, text_features: -1, hidden_features: 48}}
training: {{precision: fp32}}
"""


@pytest.fixture(scope="module", params=list(ENCODERS))
def bundle(request, tmp_path_factory):
    """Both packages' bundles of one model: a dict of the kind, the two
    bundle directories, the port's checkpoint and both runtimes."""
    kind = request.param
    root = tmp_path_factory.mktemp(f"bundle_{kind}")
    (root / "vocab.json").write_text(json.dumps(PIECES))
    (root / "config.yaml").write_text(CFG.format(kind=kind, vocab=root / "vocab.json",
                                                 encoder=ENCODERS[kind]))
    jcfg = jconfig.load_config(root / "config.yaml")
    jspec = jconfig.build_model_spec(jcfg)
    params, state = jax.tree.map(np.array, jrnnt.rnnt_init(jax.random.PRNGKey(0), jspec))
    rng = np.random.RandomState(5)
    state = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    params["joint"]["out"]["b"][jspec.blank_idx] = BLANK_BIAS[kind]

    # jax arrays: orbax restores numpy leaves as numpy, which JAX's export cannot index
    # with a traced token array.
    jstate = JTrainState(*jax.tree.map(jnp.asarray, (params, None, state)),
                         jnp.ones((), jnp.int32))
    jckpt.save_checkpoint(root / "jax_run", jstate, jcfg, wait=True)
    jexport_cli.main([str(jckpt.checkpoint_dir(root / "jax_run", 1)), "--out",
                      str(root / "jax_bundle"), "--frames", "8"])
    ckpt = write_checkpoint(root / "port_ckpt", tconfig.load_config(root / "config.yaml"),
                            params, state)
    texport_cli.main([str(ckpt), "--out", str(root / "port_bundle"), "--frames", "8",
                      "--device", "cpu"])
    return dict(kind=kind, jax=root / "jax_bundle", port=root / "port_bundle", ckpt=ckpt,
                jrt=JBundleRuntime(root / "jax_bundle"),
                rt=BundleRuntime(root / "port_bundle", "cpu"))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err, scale = np.abs(got - want).max(), max(1.0, float(np.abs(want).max()))
    assert err <= 1e-5 * scale, (err, scale)


def _wave(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32) * 0.2
            + np.sin(2 * np.pi * 500 * np.arange(n) / 16000).astype(np.float32) * 0.3)


def test_bundle_metadata_equal(bundle):
    for name in ("manifest.json", "tokenizer.json", "encoder_streaming_states.json"):
        got = json.loads((bundle["port"] / name).read_text())
        assert got == json.loads((bundle["jax"] / name).read_text()), name
    manifest = bundle["rt"].manifest
    assert manifest["graphs"] == list(GRAPHS)
    assert manifest["chunk_samples"] == 8 * 160 + 240 and manifest["predictor_tokens"] == 16
    for name in GRAPHS:
        assert (bundle["port"] / f"{name}.pt2").exists(), name


def _graph_inputs(rt, name, rng):
    m = rt.manifest
    if name == "featurize":
        return [rng.randn(1, m["chunk_samples"]).astype(np.float32) * 0.2]
    if name == "encoder":
        return [rng.randn(1, 64, m["num_bins"]).astype(np.float32)]
    if name == "encoder_streaming":
        return [rng.randn(1, m["chunk_frames"], m["num_bins"]).astype(np.float32)] + [
            rng.randn(*s).astype(np.float32) for s in rt.state_shapes]
    if name == "predictor":
        return [rng.randint(0, m["num_classes"], (1, m["predictor_tokens"]))]
    return [rng.randn(1, 48).astype(np.float32), rng.randn(1, 48).astype(np.float32)]


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_agrees_with_jax(bundle, name):
    args = _graph_inputs(bundle["rt"], name, np.random.RandomState(len(name)))
    exported = jexport.deserialize((bundle["jax"] / f"{name}.stablehlo").read_bytes())
    want = exported.call(*[jnp.asarray(a, jnp.int32 if a.dtype.kind == "i" else jnp.float32)
                           for a in args])
    with torch.inference_mode():
        got = bundle["rt"].graphs[name](*[torch.from_numpy(a) for a in args])
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(want) == (1 + len(bundle["rt"].state_shapes)
                                     if name == "encoder_streaming" else 1)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


def _fed(rt, wave, piece=3200):
    stream = rt.open_stream()
    for i in range(0, len(wave), piece):
        stream.feed(wave[i:i + piece])
    stream.flush()
    return stream.tokens


def test_transcribe_equals_jax(bundle):
    total = 0
    for seed, n in ((1, 20800), (2, 14500)):
        wave = _wave(seed, n)
        want, want_text = bundle["jrt"].transcribe(wave)
        got, got_text = bundle["rt"].transcribe(wave)
        assert [int(t) for t in want] == got and got_text == want_text
        assert _fed(bundle["rt"], wave) == [int(t) for t in _fed(bundle["jrt"], wave)] == got
        total += len(got)
    assert 0 < total < 2 * 512, total


@pytest.mark.parametrize("bundle", ["fullcausal"], indirect=True)
def test_bundle_equals_live_session(bundle):
    """With batch norm the streamed encoder frames do not depend on the
    chunking, so the bundle's tokens are the live session's (the instance
    norm model is held against rnnt_tpu's bundle only); a wave of exactly
    5 chunks leaves no tail."""
    cfg = tconfig.load_config(bundle["ckpt"] / "config.yaml")
    model = load_checkpoint(bundle["ckpt"], tconfig.build_model_spec(cfg), "cpu")
    wave = _wave(3, 5 * 1280 + 240)
    session = StreamingSession(model, tconfig.build_featurizer_spec(cfg))
    for i in range(0, len(wave), 3200):
        session.feed(wave[i:i + 3200])
    got, _ = bundle["rt"].transcribe(wave, pad_tail=False)
    assert got == session.tokens() and got


def test_flush_decodes_an_utterance_shorter_than_the_overlap(bundle):
    """rnnt_tpu's flush returns nothing for a tail within the overlap even
    when no chunk was ever encoded (rnnt_tpu/runtime/bundle.py:164); the
    port's decodes it as one zero-padded chunk, as rnnt_tpu's stream fed
    that chunk does."""
    short = _wave(4, 200)
    chunk = bundle["rt"].manifest["chunk_samples"]
    jstream = bundle["jrt"].open_stream()
    assert jstream.feed(short) == [] and jstream.flush() == []
    assert all(not np.asarray(s).any() for s in jstream.states)  # nothing encoded

    stream = bundle["rt"].open_stream()
    assert stream.feed(short) == [] and stream.chunks == 0
    got = stream.flush()
    assert stream.chunks == 1 and stream.tokens == got
    padded = np.pad(short, (0, chunk - len(short)))
    assert got == bundle["rt"].open_stream().feed(padded)
    assert got == [int(t) for t in bundle["jrt"].open_stream().feed(padded)]
    assert stream.flush() == [] and bundle["rt"].open_stream().flush() == []


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.mark.parametrize("bundle", ["convjs_narrow"], indirect=True)
def test_run_bundle_prints_the_flush_increment(bundle, tmp_path, capsys):
    """``--streaming-chunks``: the port prints the tokens flush emits as a
    last ``+...`` line; rnnt_tpu's run_bundle drops them
    (rnnt_tpu/cli/run_bundle.py:58).  The wave is the first of a few whose
    tail emits at flush (the model that emits more often of the two)."""
    path = tmp_path / "a.wav"
    for seed in range(20):
        _write_wav(path, _wave(10 + seed, 9000 + 700 * seed))
        stream = bundle["rt"].open_stream()
        wav = trun_bundle.read_wav(str(path))
        for i in range(0, len(wav), 3200):
            stream.feed(wav[i:i + 3200])
        tail = stream.flush()
        if tail:
            break
    assert tail, "no wave of the search emitted at flush"

    jrun_bundle.main([str(bundle["jax"]), str(path), "--streaming-chunks", "0.2"])
    jlines = capsys.readouterr().out.splitlines()
    results = trun_bundle.main([str(bundle["port"]), str(path), "--streaming-chunks", "0.2",
                                "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    plus = [ln for ln in lines if ln.startswith("  +")]
    assert plus == [ln for ln in jlines if ln.startswith("  +")] + [
        f"  +{bundle['rt'].detokenize(tail)}"]
    assert results[0][1] == stream.tokens and lines[-3] == f"{path}: {stream.text()}"
    assert jlines[-2:] == lines[-3:-1]  # the same transcript: only the increments differ
    assert lines[-1].endswith("s)") and "audio-s/s" in lines[-1]


@pytest.mark.parametrize("bundle", ["convjs_narrow"], indirect=True)
def test_run_bundle_max_tokens(bundle, tmp_path, capsys):
    """``--max-tokens`` stops each file's decode at that many tokens,
    offline and streamed; without it the cap is 512, the JAX CLI's."""
    path = tmp_path / "a.wav"
    _write_wav(path, _wave(1, 20800))
    full, _ = bundle["rt"].transcribe(trun_bundle.read_wav(str(path)))
    assert 2 < len(full) < 512
    for extra in ([], ["--streaming-chunks", "0.2"]):
        argv = [str(bundle["port"]), str(path), "--device", "cpu", *extra]
        assert trun_bundle.main(argv)[0][1] == full
        assert trun_bundle.main(argv + ["--max-tokens", "2"])[0][1] == full[:2]
    capsys.readouterr()


def test_read_wav_refuses_other_formats(tmp_path):
    for name, width, channels, rate, match in (
            ("a8.wav", 1, 1, 16000, "16-bit"), ("st.wav", 2, 2, 16000, "mono"),
            ("r8.wav", 2, 1, 8000, "16000 Hz")):
        with wave.open(str(tmp_path / name), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(rate)
            w.writeframes(bytes(width * channels * 100))
        with pytest.raises(ValueError, match=match):
            trun_bundle.read_wav(str(tmp_path / name))


BANNED = tuple(f"rnnt_tpu_torch.{m}" for m in ("models", "train", "decode", "ops"))


@pytest.mark.parametrize("rel", ["rnnt_tpu_torch/runtime/bundle.py",
                                 "rnnt_tpu_torch/cli/run_bundle.py"])
def test_runtime_imports_no_model_code(rel):
    for node in ast.walk(ast.parse((REPO / rel).read_text())):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                else [])
        for mod in mods:
            assert not mod.startswith(BANNED), (rel, mod)


def test_run_bundle_loads_no_model_code():
    """Importing cli.run_bundle, transitively, loads no module of the
    port's models, train, decode or ops."""
    code = ("import sys, rnnt_tpu_torch.cli.run_bundle; "
            "print(sorted(m for m in sys.modules if m.startswith("
            f"{BANNED!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, check=True).stdout
    assert out.strip() == "[]"
