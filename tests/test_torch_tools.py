"""The port's training tools against rnnt_tpu, on the CPU.

* ``cli.calc_global_features`` and JAX's on tiny_conv's first 16
  synthetic utterances: equal frame counts, means and inverse standard
  deviations within 1e-5 relative, histogram totals equal per channel; a
  value moves to a neighbouring bin only when it lies within 1e-5
  relative of a bin edge (3 of 805,608 values moved here, of 5 that near
  an edge; the featurizers' float32 sums differ in their last bits);
* ``cli.render_augments``: every WAV's int16 PCM equal to JAX's;
* ``cli.sweep``: ``_sample`` draws JAX's parameters for the same seed and
  history, a study JAX's CLI wrote resumes in the port with the trial JAX
  would draw next, a trial that raises scores inf, and two real trials of
  tiny_conv (1 step each) complete;
* the native tokenizer (``rnnt_tpu_torch/native``), built by g++ into
  ``build/``: its ids equal JAX's tokenizer's and the port's Python path's
  on a fuzz corpus over a piece table made here, and
  ``rnnt_edit_distance`` equals ``train/metrics._edit_distance`` (skipped,
  saying why, only without g++);
* asynchronous checkpoints: the files of a save written on the thread
  hold the arrays of a synchronous save bit for bit; the step's tensors
  are copied before ``save`` returns; ``latest_checkpoint`` never returns
  the directory being written; a resume from an async save equals the
  straight run exactly;
* ``MetricsLogger.log_histograms`` on weights carried from JAX: the tags
  and values JAX's logger gives, through a recording fake tensorboardX;
  ``train`` logs them every ``hist_steps``;
* ``cli.train --profile``: a trace of steps 3-6 under ``trace/``;
  ``train/profiling.trace`` and ``time_fn`` on the CPU;
* ``save_tensor_json`` / ``load_tensor_json``: JAX's strings, exact round
  trips.
"""

import dataclasses
import gzip
import json
import math
import random
import re
import shutil
import sys
import threading
import types
import wave
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from rnnt_tpu import utils as jutils  # noqa: E402
from rnnt_tpu.cli import calc_global_features as jcgf  # noqa: E402
from rnnt_tpu.cli import render_augments as jrender  # noqa: E402
from rnnt_tpu.cli import sweep as jsweep  # noqa: E402
from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.data.tokenizer import UnigramTokenizer as JTokenizer  # noqa: E402
from rnnt_tpu.models.rnnt import rnnt_init as jrnnt_init  # noqa: E402
from rnnt_tpu.train import loop as jloop  # noqa: E402
from rnnt_tpu.train import metrics as jmetrics  # noqa: E402
from rnnt_tpu_torch import native, utils as tutils  # noqa: E402
from rnnt_tpu_torch.cli import calc_global_features as tcgf  # noqa: E402
from rnnt_tpu_torch.cli import render_augments as trender  # noqa: E402
from rnnt_tpu_torch.cli import sweep as tsweep  # noqa: E402
from rnnt_tpu_torch.cli import train as tcli_train  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import from_jax  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer as TTokenizer  # noqa: E402
from rnnt_tpu_torch.models.rnnt import rnnt_init  # noqa: E402
from rnnt_tpu_torch.ops.stft import make_featurizer  # noqa: E402
from rnnt_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402
from rnnt_tpu_torch.train import metrics as tmetrics  # noqa: E402
from rnnt_tpu_torch.train import optim as toptim  # noqa: E402
from rnnt_tpu_torch.train import profiling  # noqa: E402
from rnnt_tpu_torch.train import step as tstep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
STATS_RTOL = 1e-5
EDGE_RTOL = 1e-5


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(synthetic_piece_table(255)))
    return path


def _tiny(vocab, *extra):
    """tiny_conv at test size, float32, dropout at the config's 0.1."""
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
            "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
            "training.precision=fp32", "training.global_batch_size=2",
            "training.frame_buckets=[48]", "training.token_buckets=[12]",
            "training.eval_max_elements=2", "data.dataset=synthetic",
            "data.synthetic_size=12", "data.synthetic_seconds=0.5",
            "data.synthetic_max_words=6", "training.log_steps=1",
            "training.lr_schedule.warmup_steps=2", *extra]


def _tiny_yaml(vocab, path, *extra) -> Path:
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  _tiny(vocab, *extra))
    tconfig.save_config(cfg, path)
    return path


# --------------------------- calc_global_features ---------------------------

def test_calc_global_features_matches_jax(tmp_path, capsys):
    common = ["--config", "tiny_conv", "--max-utterances", "16", "--histogram-bins", "50"]
    jcgf.main(common + ["--out", str(tmp_path / "j.json"), "--histograms",
                        str(tmp_path / "jh"), "--histogram-pngs", "0", "--platform", "cpu"])
    jframes = int(re.search(r"wrote \S+: (\d+) frames", capsys.readouterr().out).group(1))
    got = tcgf.main(common + ["--out", str(tmp_path / "t.json"), "--histograms",
                              str(tmp_path / "th"), "--device", "cpu"])
    assert got["frames"] == jframes > 0 and got["utterances"] == 16
    want = json.loads((tmp_path / "j.json").read_text())
    mine = json.loads((tmp_path / "t.json").read_text())
    assert set(mine) == {"means", "invstddev"}
    for k in mine:
        np.testing.assert_allclose(mine[k], want[k], rtol=STATS_RTOL, atol=0)
    assert (tmp_path / "th" / "log_channel_0_histogram.png").exists()

    jh = json.loads((tmp_path / "jh" / "histograms.json").read_text())
    th = json.loads((tmp_path / "th" / "histograms.json").read_text())
    assert th["log_bin_edges"] == jh["log_bin_edges"]
    jc, tc = np.asarray(jh["counts"]), np.asarray(th["counts"])
    np.testing.assert_array_equal(tc.sum(axis=1), jc.sum(axis=1))
    # A value may change bins only where it lies within EDGE_RTOL of an edge.
    cfg = tconfig.load_config(tconfig.resolve_config("tiny_conv"))
    featurize = make_featurizer(dataclasses.replace(tconfig.build_featurizer_spec(cfg),
                                                    mean=0.0, invstddev=1.0))
    ds, _ = tloop._load_datasets(cfg)
    edges = np.asarray(th["log_bin_edges"])
    near = 0
    for i in range(16):
        f = featurize(torch.from_numpy(np.asarray(ds[i]["audio"]["array"], np.float32)))
        v = f.numpy().ravel()
        j = np.clip(np.searchsorted(edges, v), 1, len(edges) - 1)
        gap = np.minimum(np.abs(v - edges[j - 1]), np.abs(v - edges[j]))
        near += int(np.sum(gap <= EDGE_RTOL * np.abs(v)))
    moved = int(np.abs(tc - jc).sum()) // 2
    print(f"{moved} of {int(tc.sum())} values changed bins; {near} lie within "
          f"{EDGE_RTOL} of an edge")
    assert moved <= near, (moved, near)


# ------------------------------ render_augments ------------------------------

def _pcm(path: Path) -> tuple:
    with wave.open(str(path), "rb") as w:
        return (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                np.frombuffer(w.readframes(w.getnframes()), np.int16))


@pytest.mark.parametrize("source", ["tone", "wav"])
def test_render_augments_equals_jax(tmp_path, source):
    args = []
    if source == "wav":  # a 1.5 s clip of noise and a chirp, 16-bit
        rng = np.random.RandomState(3)
        t = np.arange(24_000) / 16_000
        clip = 0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t) + 0.05 * rng.randn(t.size)
        jrender.write_wav(tmp_path / "src.wav", clip.astype(np.float32))
        args = ["--wav", str(tmp_path / "src.wav")]
    jrender.main(args + ["--out", str(tmp_path / "j")])
    out = trender.main(args + ["--out", str(tmp_path / "t")])
    names = sorted(p.name for p in (tmp_path / "j").glob("*.wav"))
    assert len(names) == 15 and sorted(p.name for p in out.glob("*.wav")) == names
    for name in names:
        g, w = _pcm(out / name), _pcm(tmp_path / "j" / name)
        assert g[:3] == w[:3] == (1, 2, 16_000)
        np.testing.assert_array_equal(g[3], w[3], err_msg=name)
    html = (out / "index.html").read_text()
    assert all(f'src="{n}"' in html for n in names)


# ---------------------------------- sweep ----------------------------------

def _history(n: int, seed: int) -> list:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        out.append({"trial": i, "params": jsweep._sample(rng, out),
                    "wer": float("inf") if i % 3 == 2 else rng.uniform(0.2, 1.0)})
    return out


@pytest.mark.parametrize("n_prior", [0, 1, 2, 5, 9])
def test_sweep_sample_equals_jax(n_prior):
    assert tsweep.SPACE == jsweep.SPACE
    prior = _history(n_prior, seed=n_prior)
    for seed in range(4):
        got = tsweep._sample(random.Random(seed + n_prior), prior)
        want = jsweep._sample(random.Random(seed + n_prior), prior)
        assert got == want


def test_sweep_resumes_a_jax_study_and_failed_trials_score_inf(tmp_path, monkeypatch,
                                                                vocab, capsys):
    """JAX's CLI writes 2 trials (its train stubbed); the port resumes the
    file and draws JAX's trial 2; a trial whose train raises scores inf."""
    import rnnt_tpu.train.loop as jloop_mod

    config = _tiny_yaml(vocab, tmp_path / "tiny.yaml")
    wers = iter([0.75, 0.5, 0.25])
    monkeypatch.setattr(jloop_mod, "train", lambda cfg, max_steps=None: next(wers))
    study = tmp_path / "study.jsonl"
    jsweep.main(["--config", str(config), "--trials", "2", "--study", str(study),
                 "--platform", "cpu"])
    shutil.copy(study, tmp_path / "jax_next.jsonl")
    jsweep.main(["--config", str(config), "--trials", "3", "--study",
                 str(tmp_path / "jax_next.jsonl"), "--platform", "cpu"])
    want = json.loads((tmp_path / "jax_next.jsonl").read_text().splitlines()[2])

    def fails(cfg, **kw):
        assert cfg.model_name == "tiny_conv_sweep2" and kw["device"].type == "cpu"
        assert cfg.training.rnnt_grad_clamp == want["params"]["training.rnnt_grad_clamp"]
        raise RuntimeError("diverged")

    monkeypatch.setattr(tsweep, "train", fails)
    capsys.readouterr()
    trials = tsweep.main(["--config", str(config), "--trials", "3", "--study", str(study),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resuming study with 2 prior trials" in out
    assert "trial 2 failed: RuntimeError: diverged" in out
    lines = [json.loads(x) for x in study.read_text().splitlines()]
    assert len(lines) == len(trials) == 3
    assert lines[2]["params"] == want["params"] and lines[2]["trial"] == 2
    assert lines[2]["wer"] == math.inf and "Infinity" in study.read_text().splitlines()[2]
    assert [t["wer"] for t in lines[:2]] == [0.75, 0.5]


def test_sweep_two_real_trials_complete(tmp_path, vocab):
    config = _tiny_yaml(vocab, tmp_path / "tiny.yaml")
    trials = tsweep.main(["--config", str(config), "--trials", "2", "--max-steps", "1",
                          "--device", "cpu", "--study", str(tmp_path / "s.jsonl"),
                          "--output-base", str(tmp_path / "exp")])
    assert [t["trial"] for t in trials] == [0, 1]
    assert all(math.isfinite(t["wer"]) for t in trials)
    for i in range(2):
        assert (tmp_path / "exp" / f"tiny_conv_sweep{i}" / "run-1" / "checkpoint_step_1").is_dir()


# ------------------------------ native tokenizer ------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is not installed, so the native library "
                                      "cannot be built; the Python path is used")


def _fuzz_pieces():
    """A piece table with scores in multiples of 1/8 (exact in float32 and
    float64 over these lengths, so the C++ and Python Viterbi agree on
    ties): word-boundary pieces, sub-words, letters, a byte-ish piece,
    <unk> and a control piece."""
    rng = np.random.RandomState(7)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3)]
    words = ["the", "quick", "brown", "fox", "jump", "over", "lazy", "dog", "ing", "ed",
             "qu", "ck", "ow", "er", "az", "do"]
    for w in words:
        pieces.append(("▁" + w, -float(rng.randint(8, 80)) / 8, 1))
        pieces.append((w, -float(rng.randint(8, 80)) / 8, 1))
    for c in letters + "é":
        pieces.append((c, -float(rng.randint(40, 120)) / 8, 1))
    pieces.append(("▁", -3.0, 1))
    return pieces


def _fuzz_texts():
    rng = random.Random(11)
    alphabets = ["abcdefghijklmnopqrstuvwxyz ", "the quick brown fox jumps over lazy dogs ",
                 "äöüßéèêñç ab ", "0123 !? the "]
    texts = ["", " ", "the quick brown fox", "jumped over the lazy dog", "ééé zz"]
    for _ in range(300):
        a = rng.choice(alphabets)
        texts.append("".join(rng.choice(a) for _ in range(rng.randint(1, 50))))
    return texts


@needs_gxx
def test_native_tokenizer_built_in_build_and_equal_to_jax():
    pieces = _fuzz_pieces()
    tok, jtok = TTokenizer(pieces), JTokenizer(pieces)
    assert tok.native, native.load_error()
    lib = native.library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "rnnt_tpu_torch"
    assert not list((REPO / "rnnt_tpu_torch" / "native").glob("*.so"))
    for text in _fuzz_texts():
        got = tok.encode(text)
        assert got == jtok.encode(text), text
        assert got == tok._fuse_unk(tok._encode_py(tok._normalize(text))), text


@needs_gxx
def test_native_edit_distance_equals_metrics():
    rng = np.random.RandomState(5)
    for _ in range(200):
        ref = rng.randint(0, 6, rng.randint(0, 12)).tolist()
        hyp = rng.randint(0, 6, rng.randint(0, 12)).tolist()
        want = tmetrics._edit_distance(ref, hyp)
        assert native.edit_distance(ref, hyp) == want == jmetrics._edit_distance(ref, hyp)


def test_python_path_without_native_library(monkeypatch):
    """No library (no compiler): the tokenizer says so and encodes in
    Python with the same ids."""
    pieces = _fuzz_pieces()
    monkeypatch.setattr("rnnt_tpu_torch.data.tokenizer.load_native", lambda: None)
    tok = TTokenizer(pieces)
    assert not tok.native
    jtok = JTokenizer(pieces)
    for text in _fuzz_texts()[:60]:
        assert tok.encode(text) == jtok.encode(text)


# ------------------------------ async checkpoints ------------------------------

def _state(vocab, seed=0):
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  _tiny(vocab))
    spec = tconfig.build_model_spec(cfg)
    model = rnnt_init(spec, seed=seed)
    opt, _ = toptim.make_optimizer(cfg.training, 10)
    opt_state = opt.init(dict(model.named_parameters()))
    for k in opt_state.mu:  # nonzero moments
        opt_state.mu[k].normal_(generator=torch.Generator().manual_seed(1))
        opt_state.nu[k].uniform_(generator=torch.Generator().manual_seed(2))
    return cfg, tstep.TrainState(model, opt_state, 4)


def _same_checkpoint(a: Path, b: Path):
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    assert (a / "config.yaml").read_bytes() == (b / "config.yaml").read_bytes()
    for name in ("params.npz", tckpt.OPT_FILE):
        with np.load(a / name) as za, np.load(b / name) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes(), k


class _Gate:
    """Holds the writer thread inside ``write_checkpoint`` until opened."""

    def __init__(self, monkeypatch):
        self.entered, self.open = threading.Event(), threading.Event()
        inner = tckpt.write_checkpoint

        def gated(*args):
            out = inner(*args)
            self.entered.set()
            assert self.open.wait(60)
            return out

        monkeypatch.setattr(tckpt, "write_checkpoint", gated)


def test_async_save_equals_sync_save_and_snapshots_first(vocab, tmp_path, monkeypatch):
    cfg, state = _state(vocab)
    sync = tckpt.save(tmp_path / "sync", state, cfg)
    gate = _Gate(monkeypatch)
    path = tckpt.save(tmp_path / "async", state, cfg, wait=False)
    assert gate.entered.wait(60)
    with torch.no_grad():  # the next step updates the live tensors in place
        for p in state.model.parameters():
            p.add_(1.0)
        for k in state.opt_state.mu:
            state.opt_state.mu[k].zero_()
    # While the save is pending: only the temporary directory exists.
    assert tckpt.latest_checkpoint(tmp_path / "async") is None
    assert (tmp_path / "async" / ".writing_step_4").is_dir() and not path.exists()
    gate.open.set()
    tckpt.wait_for_checkpoints()
    assert tckpt.latest_checkpoint(tmp_path / "async") == path
    assert not (tmp_path / "async" / ".writing_step_4").exists()
    _same_checkpoint(path, sync)


def test_latest_checkpoint_skips_the_one_being_written(vocab, tmp_path, monkeypatch):
    cfg, state = _state(vocab)
    done = tckpt.save(tmp_path, state, cfg, wait=False)
    tckpt.wait_for_checkpoints()
    gate = _Gate(monkeypatch)
    state.step = 8
    pending = tckpt.save(tmp_path, state, cfg, wait=False)
    assert gate.entered.wait(60)
    assert tckpt.latest_checkpoint(tmp_path) == done  # not step 8 while it is written
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == [
        ".writing_step_8", "checkpoint_step_4"]
    gate.open.set()
    model = rnnt_init(tconfig.build_model_spec(cfg), seed=3)
    _, step = tckpt.restore(pending, model)  # restore waits for the pending save
    assert step == 8 and tckpt.latest_checkpoint(tmp_path) == pending


def test_resume_after_async_save_equals_straight_run(vocab, tmp_path):
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  _tiny(vocab, "data.augment=true", "data.augment_device=full",
                                        "training.spec_augment=true"))
    spec, fs = tconfig.build_model_spec(cfg), tconfig.build_featurizer_spec(cfg)
    opt, _ = toptim.make_optimizer(cfg.training, 10)
    step = tstep.make_train_step(spec, fs, opt, "fp32", spec_augment=True,
                                 device_augment="full")
    batches = list(tloop.eval_batches(cfg, tloop._load_tokenizer(cfg), batch_size=2,
                                      max_batches=3))

    def run(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, tstep.batch_to_device(batches[i], "cpu"),
                            tloop.step_generator(torch.device("cpu"), 0, state.step))
        return state

    def fresh():
        m = rnnt_init(spec, seed=0)
        return tstep.TrainState(m, opt.init(dict(m.named_parameters())), 0)

    straight = run(fresh(), 0, 3)
    first = run(fresh(), 0, 2)
    path = tckpt.save(tmp_path, first, cfg, wait=False)
    first = run(first, 2, 3)  # trains on while the save is written
    model = rnnt_init(spec, seed=5)
    opt_state, at = tckpt.restore(path, model)
    resumed = run(tstep.TrainState(model, opt_state, at), 2, 3)
    for st in (first, resumed):
        for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                                  st.model.state_dict().items()):
            assert torch.equal(a, b), n
        for k in straight.opt_state.mu:
            assert torch.equal(straight.opt_state.mu[k], st.opt_state.mu[k])
            assert torch.equal(straight.opt_state.nu[k], st.opt_state.nu[k])


# --------------------------------- histograms ---------------------------------

class _Writer:
    """A recording stand-in for tensorboardX's SummaryWriter."""
    instances: list = []

    def __init__(self, logdir=None, **kw):
        self.histograms, self.scalars = [], []
        _Writer.instances.append(self)

    def add_histogram(self, tag, values, step):
        self.histograms.append((tag, np.array(values), step))

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        pass


@pytest.fixture
def fake_tensorboard(monkeypatch):
    mod = types.ModuleType("tensorboardX")
    mod.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "tensorboardX", mod)
    _Writer.instances = []
    return _Writer


def test_histograms_equal_jax(vocab, tmp_path, fake_tensorboard):
    overrides = _tiny(vocab, "training.loss_impl=pruned", "encoder.norm_type=batch")
    path = tconfig.resolve_config("tiny_conv")
    jcfg = jconfig.apply_overrides(jconfig.load_config(path), list(overrides))
    tcfg = tconfig.apply_overrides(tconfig.load_config(path), list(overrides))
    params, state = jrnnt_init(jax.random.PRNGKey(3), jconfig.build_model_spec(jcfg))
    model = from_jax(params, state, tconfig.build_model_spec(tcfg))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jlog = jloop.MetricsLogger(tmp_path / "j", enabled=True)
    jlog.log_histograms(6, params)
    tlog = tloop.MetricsLogger(tmp_path / "t")
    tlog.log_histograms(6, model)
    jlog.close()
    tlog.close()
    want = {tag: (v, s) for tag, v, s in fake_tensorboard.instances[0].histograms}
    got = {tag: (v, s) for tag, v, s in fake_tensorboard.instances[1].histograms}
    assert sorted(got) == sorted(want) and any("simple" in t for t in got)
    assert len(got) == len(fake_tensorboard.instances[1].histograms)
    for tag, (v, s) in want.items():
        assert got[tag][1] == s == 6
        assert got[tag][0].dtype == v.dtype and got[tag][0].tobytes() == v.tobytes(), tag


def test_train_logs_histograms_every_hist_steps(vocab, tmp_path, fake_tensorboard):
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  _tiny(vocab, "training.hist_steps=2"))
    tloop.train(cfg, output_base=tmp_path, max_steps=5, device="cpu")
    (writer,) = fake_tensorboard.instances
    steps = sorted({s for _, _, s in writer.histograms})
    n_params = sum(1 for _ in rnnt_init(tconfig.build_model_spec(cfg)).parameters())
    assert steps == [2, 4] and len(writer.histograms) == 2 * n_params
    assert all(t.startswith("weights/") for t, _, _ in writer.histograms)


# ---------------------------------- profile ----------------------------------

def test_cli_train_profile_traces_steps_3_to_6(vocab, tmp_path, capsys):
    args = ["--config", "tiny_conv", "--max-steps", "7", "--device", "cpu", "--profile",
            "--output-base", str(tmp_path)]
    for o in _tiny(vocab, "training.frame_buckets=[32]", "data.synthetic_seconds=0.33",
                   "training.token_buckets=[8]", "data.synthetic_max_words=4"):
        args += ["--set", o]
    tcli_train.main(args)
    run = tmp_path / "tiny_conv" / "run-1"
    traces = list((run / "trace").iterdir())
    assert [p.name for p in traces] == ["rank0.json.gz"]
    assert "profiler trace of steps 3-6 written to" in capsys.readouterr().out
    with gzip.open(traces[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert sorted(n for n in spans if n.startswith("step ")) == [
        "step 3", "step 4", "step 5", "step 6"]
    for part in ("data", "train_step", "bookkeeping"):
        inside = [e for e in events if e.get("name") == part]
        assert len(inside) == 4
        for e in inside:
            assert any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                       for n, s in spans.items() if n.startswith("step "))
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::conv1d" for e in events)


def test_profiling_trace_and_time_fn(tmp_path):
    x = torch.ones(64)
    with profiling.trace(tmp_path, device="cpu", name="block") as prof:
        with torch.profiler.record_function("marked"):
            y = torch.mm(x[None], x[:, None])
    with gzip.open(tmp_path / "block.json.gz", "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"marked", "aten::mm"} <= names
    assert "aten::mm" in {e.key for e in prof.key_averages()}
    calls = []
    secs = profiling.time_fn(lambda a: calls.append(1) or {"out": [a * 2]}, y,
                             iters=3, warmup=2)
    assert secs > 0 and len(calls) == 5


# --------------------------------- tensor JSON ---------------------------------

@pytest.mark.parametrize("dtype,shape", [(np.float32, (3, 4)), (np.int32, (5,)),
                                         (np.float32, ()), (np.int32, (2, 0, 3))])
def test_tensor_json_matches_jax(dtype, shape):
    rng = np.random.RandomState(0)
    arr = np.asarray(rng.randn(*shape) * 100).astype(dtype)
    s = tutils.save_tensor_json(arr)
    assert s == jutils.save_tensor_json(arr)
    back = tutils.load_tensor_json(s)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert back.tobytes() == arr.tobytes() == jutils.load_tensor_json(s).tobytes()
    back[...] = 0  # a writable copy
    with pytest.raises(ValueError, match="unsupported dtype"):
        tutils.save_tensor_json(arr.astype(np.float64))
