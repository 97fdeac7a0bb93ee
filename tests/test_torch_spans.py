"""The port's spans (``train/profiling.py``) on the CPU.

* Two cached ``tiny_conv`` train steps under a torch profiler recording
  the host: the spans nest as ``gather``, ``train_step`` > ``forward``
  (> ``featurize``, ``predictor``, ``encoder``, ``loss``), ``backward``,
  ``grad_norm``, ``optimizer``, carry the step numbers 0 and 1, and share
  the profiler's clock: every ``aten::convolution`` lies inside a
  ``forward``, every ``aten::convolution_backward`` inside a
  ``backward``, AdamW's ``aten::sqrt`` inside an ``optimizer``.
* Off: ``span`` returns one shared object, allocates nothing, opens no
  ``record_function`` and records nothing; the steps' losses and
  parameters are bit-equal with spans on and off.
* A kernel launch (a fake C entry point) is counted with spans on and
  off, opens no ``record_function`` when off and records one ``launch
  <name>`` span when on.
* ``cli.train --profile``: ``forward``, ``backward``, ``grad_norm`` and
  ``optimizer`` inside each of the trace's 4 ``train_step`` ranges.
"""

import gzip
import itertools
import json
import threading
import tracemalloc

import pytest
import torch

from rnnt_tpu_torch.cli import train as tcli_train
from rnnt_tpu_torch.config import config as tconfig
from rnnt_tpu_torch.data.dataset import synthetic_piece_table
from rnnt_tpu_torch.data.device_cache import make_cached_train_step
from rnnt_tpu_torch.models.rnnt import rnnt_init
from rnnt_tpu_torch.ops import kernels
from rnnt_tpu_torch.train import profiling
from rnnt_tpu_torch.train.optim import make_optimizer
from rnnt_tpu_torch.train.step import TrainState, make_train_step

OVERRIDES = ["num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
             "training.precision=fp32", "training.loss_impl=auto"]
STEP_PHASES = ["forward", "backward", "grad_norm", "optimizer"]
FORWARD_PARTS = ["featurize", "predictor", "encoder", "loss"]


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off."""
    profiling.stop_spans()
    yield
    profiling.stop_spans()


def _cached_steps(seed=0, rows=6, batch=2, samples=400 + 47 * 160, tokens=8):
    """(state, cached step, group, row batches) of tiny_conv, float32."""
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  OVERRIDES)
    spec, fspec = tconfig.build_model_spec(cfg), tconfig.build_featurizer_spec(cfg)
    model = rnnt_init(spec, seed=seed)
    opt, _ = make_optimizer(cfg.training, 10)
    state = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_cached_train_step(make_train_step(spec, fspec, opt, "fp32"))
    g = torch.Generator().manual_seed(seed + 1)
    group = {"audio": (torch.randn(rows, samples, generator=g) * 3000).to(torch.int16),
             "audio_lens": torch.randint(samples // 2, samples + 1, (rows,), generator=g,
                                         dtype=torch.int32),
             "targets": torch.randint(0, 255, (rows, tokens), generator=g, dtype=torch.int32),
             "target_lens": torch.randint(1, tokens + 1, (rows,), generator=g,
                                          dtype=torch.int32)}
    batches = [list(range(i, i + batch)) for i in range(0, rows, batch)]
    return state, step, group, batches


def _run(state, step, group, batches, n=2):
    losses = []
    for idx in batches[:n]:
        state, metrics = step(state, group, idx, None)
        losses.append(metrics["loss"])
    return state, losses


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _inside(ev, spans, name):
    t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    return any(s.name == name and s.start_ns <= t0 and t1 <= s.end_ns for s in spans)


def test_spans_nest_carry_steps_and_share_the_profilers_clock():
    state, step, group, batches = _cached_steps()
    profiling.start_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(state, step, group, batches)
    spans = profiling.stop_spans()
    me = threading.get_native_id()
    assert all(s.thread == me and s.end_ns is not None and s.start_ns <= s.end_ns
               for s in spans)
    roots = [(i, s) for i, s in enumerate(spans) if s.parent is None]
    assert [(s.name, s.step) for _, s in roots] == [
        ("gather", 0), ("train_step", 0), ("gather", 1), ("train_step", 1)]
    for i, s in roots:
        assert all(c.step == s.step for c in spans if c.parent == i)
        if s.name == "gather":
            assert _children(spans, i) == []
            continue
        assert _children(spans, i) == STEP_PHASES
        fwd = next(j for j, c in enumerate(spans) if c.parent == i and c.name == "forward")
        assert _children(spans, fwd) == FORWARD_PARTS
        for j, c in enumerate(spans):
            if c.parent == i:
                assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
    events = [e for e in prof.profiler.kineto_results.events() if e.duration_ns() > 0]
    by_name = {n: [e for e in events if e.name() == n]
               for n in ("aten::convolution", "aten::convolution_backward", "aten::sqrt")}
    assert all(by_name.values())
    assert all(_inside(e, spans, "forward") for e in by_name["aten::convolution"])
    assert all(_inside(e, spans, "backward") for e in by_name["aten::convolution_backward"])
    sqrt_in = [e for e in by_name["aten::sqrt"] if _inside(e, spans, "optimizer")]
    assert sqrt_in
    assert all(_inside(e, spans, "optimizer") or _inside(e, spans, "grad_norm")
               for e in by_name["aten::sqrt"])


def _peak_bytes(make_span) -> int:
    tracemalloc.start()
    try:
        for _ in itertools.repeat(None, 3):
            with make_span("warm"):
                pass
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, 1000):
            with make_span("off"):
                pass
        return tracemalloc.get_traced_memory()[1] - start
    finally:
        tracemalloc.stop()


def test_spans_off_do_nothing_and_change_no_bit(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    off = profiling.span("a")
    assert profiling.span("b", step=3) is off
    with profiling.span("c"):
        pass
    # The most memory a loop of spans holds at once, over what a loop of a
    # function returning the shared object holds: 0 when a span allocates
    # nothing, even for a moment.
    assert _peak_bytes(profiling.span) == _peak_bytes(lambda name: off)

    off_state, off_losses = _run(*_cached_steps())
    assert profiling.stop_spans() == []
    monkeypatch.undo()
    profiling.start_spans()
    on_state, on_losses = _run(*_cached_steps())
    assert len(profiling.stop_spans()) == 2 * (2 + len(STEP_PHASES) + len(FORWARD_PARTS))
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    for (n, a), (_, b) in zip(off_state.model.named_parameters(),
                              on_state.model.named_parameters()):
        assert torch.equal(a, b), n


def test_a_launch_is_counted_and_spanned_only_when_on(monkeypatch, tmp_path):
    ranges = []

    class Stream:
        cuda_stream = 4242

    class DeviceGuard:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Range:
        def __init__(self, name):
            ranges.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.cuda, "device", DeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    k = kernels.CudaKernel.__new__(kernels.CudaKernel)
    k.name, k.launches, k._fn = "fake", 0, lambda *args: 0
    x = torch.empty((2, 3), device="meta")
    k.launch(x, x, 7)
    assert k.launches == 1 and ranges == []
    profiling.start_spans()
    k.launch(x, x, 7)
    spans = profiling.stop_spans()
    assert k.launches == 2 and ranges == []
    assert [(s.name, s.parent, s.thread) for s in spans] == [
        ("launch fake", None, threading.get_native_id())]
    prof = profiling.start_trace("cpu")
    try:
        k.launch(x, x, 7)
    finally:
        profiling.stop_trace(prof, tmp_path)
    assert k.launches == 3 and ranges == ["launch fake"]


def test_cli_train_profile_splits_each_train_step(tmp_path):
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table(255)))
    args = ["--config", "tiny_conv", "--max-steps", "7", "--device", "cpu", "--profile",
            "--output-base", str(tmp_path)]
    for o in ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}", *OVERRIDES,
              "training.global_batch_size=2", "training.frame_buckets=[32]",
              "training.token_buckets=[8]", "training.eval_max_elements=2",
              "data.dataset=synthetic", "data.synthetic_size=12",
              "data.synthetic_seconds=0.33", "data.synthetic_max_words=4",
              "training.log_steps=1", "training.lr_schedule.warmup_steps=2"]:
        args += ["--set", o]
    tcli_train.main(args)
    (trace,) = (tmp_path / "tiny_conv" / "run-1" / "trace").iterdir()
    with gzip.open(trace, "rt") as f:
        ranges = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    steps = [e for e in ranges if e["name"] == "train_step"]
    assert len(steps) == 4
    for s in steps:
        inside = [e["name"] for e in sorted(ranges, key=lambda e: e["ts"])
                  if s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                  and e["name"] in STEP_PHASES]
        assert inside == STEP_PHASES
