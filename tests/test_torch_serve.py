"""The port's serving entry points on the CPU (``--device cpu``).

* ``rnnt_tpu_torch.cli.serve`` on a checkpoint written by
  compat/jax_params.save_checkpoint, on a port the OS picks (``--port 0``):
  the HTTP surface (session, feed, text, stats, 503 when every slot is in
  use, delete), and 4 concurrent clients (one at 48 kHz) batched into
  shared pump steps by the background thread, as tests/test_serve.py
  drives the JAX server;
* ``rnnt_tpu_torch.cli.infer`` offline and ``--streaming`` on a WAV written
  in the test: the text of rnnt_tpu's eval forward + greedy decode, and of
  its StreamingSession, on the same weights;
* ``read_wav`` refuses a WAV whose samples are not 16-bit (8-bit here),
  where rnnt_tpu's reader decodes any bytes as int16;
* ``--bundle`` is refused with the reason.
"""

import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.decode.greedy import greedy_decode as jgreedy  # noqa: E402
from rnnt_tpu.decode.streaming import StreamingSession as JStreamingSession  # noqa: E402
from rnnt_tpu.train.step import make_eval_forward as jeval_forward  # noqa: E402
from rnnt_tpu_torch.cli import infer as cli_infer  # noqa: E402
from rnnt_tpu_torch.cli import serve as cli_serve  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import save_checkpoint, to_jax  # noqa: E402
from rnnt_tpu_torch.config.config import BlockConfig, Config, build_model_spec  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer  # noqa: E402
from rnnt_tpu_torch.models.rnnt import rnnt_init  # noqa: E402


def _tiny_cfg(vocab) -> Config:
    cfg = Config()
    cfg.model_name = "serve_test"
    cfg.tokenizer.vocab_json = str(vocab)
    cfg.encoder.blocks = [BlockConfig(5, 24, 24, 0.0, 1)]
    cfg.encoder.epilogue_features = 24
    cfg.encoder.output_features = 24
    cfg.predictor.output_dim = 24
    cfg.predictor.symbol_embedding_dim = 16
    cfg.predictor.dropout = 0.0
    cfg.joint.hidden_features = 24
    cfg.training.precision = "fp32"
    return cfg


def _checkpoint(root, seed, blank_bias=None):
    """A checkpoint directory of the tiny model; returns (path, cfg, model)."""
    vocab = root / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    cfg = _tiny_cfg(vocab)
    model = rnnt_init(build_model_spec(cfg), seed=seed)
    if blank_bias is not None:
        with torch.no_grad():
            model.joint.out.b[cfg.blank_idx] = blank_bias
    return save_checkpoint(root / "ckpt", cfg, model), cfg, model


class _Server:
    """cli.serve's server on a thread; ``close`` stops it and its pump."""

    def __init__(self, ckpt, slots):
        self.server = cli_serve.make_server(
            [str(ckpt), "--port", "0", "--slots", str(slots), "--device", "cpu"])
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def req(self, method, path, data=None, headers=None, timeout=120):
        r = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                   data=data, method=method, headers=headers or {})
        return json.loads(urllib.request.urlopen(r, timeout=timeout).read())

    def close(self):
        self.server.shutdown()
        self.server.runtime.stop()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        assert not self.server.runtime._thread.is_alive()


@pytest.fixture
def server(tmp_path, request):
    ckpt, _, _ = _checkpoint(tmp_path, seed=request.param["seed"])
    s = _Server(ckpt, request.param["slots"])
    try:
        yield s
    finally:
        s.close()


@pytest.mark.parametrize("server", [dict(seed=0, slots=2)], indirect=True)
def test_serve_http_surface(server):
    req = server.req
    sid = req("POST", "/session")["session"]
    pcm = (np.random.RandomState(0).randn(16000) * 3000).astype(np.int16)
    fed = req("POST", f"/feed/{sid}", pcm.tobytes())
    assert "new_tokens" in fed and "text" in fed
    assert req("GET", f"/text/{sid}")["text"] == fed["text"]
    st = req("GET", "/stats")
    assert st["active_slots"] == 1 and st["device_steps"] >= 1
    # Capacity: fill both slots, a third session gets 503.
    sid2 = req("POST", "/session")["session"]
    with pytest.raises(urllib.error.HTTPError) as e:
        req("POST", "/session")
    assert e.value.code == 503
    with pytest.raises(urllib.error.HTTPError) as e:
        req("GET", "/text/nosuchsession")
    assert e.value.code == 404
    assert "text" in req("DELETE", f"/session/{sid}")
    req("DELETE", f"/session/{sid2}")
    assert req("GET", "/stats")["active_slots"] == 0


@pytest.mark.parametrize("server", [dict(seed=1, slots=4)], indirect=True)
def test_serve_concurrent_load_batches_lanes(server):
    """4 concurrent feeders share device steps through the pump thread;
    client 0 sends 48 kHz audio, resampled on the server."""
    n_clients, n_feeds = 4, 5
    errors = []

    def client(ci):
        try:
            sid = server.req("POST", "/session")["session"]
            rng = np.random.RandomState(ci)
            for _ in range(n_feeds):
                if ci == 0:
                    pcm = (rng.randn(24000) * 3000).astype(np.int16)
                    out = server.req("POST", f"/feed/{sid}", pcm.tobytes(),
                                     headers={"X-Sample-Rate": "48000"})
                else:
                    pcm = (rng.randn(8000) * 3000).astype(np.int16)
                    out = server.req("POST", f"/feed/{sid}", pcm.tobytes())
                assert "new_tokens" in out
            assert "text" in server.req("DELETE", f"/session/{sid}")
        except Exception as e:  # surfaced in the main thread
            errors.append((ci, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors

    st = server.req("GET", "/stats")
    assert st["active_slots"] == 0
    assert st["device_steps"] >= 1 and st["step_ms_p99"] > 0
    assert st["max_batched_lanes"] >= 2, st


def test_serve_refuses_bundle(tmp_path):
    with pytest.raises(NotImplementedError, match="bundle runtime"):
        cli_serve.make_server([str(tmp_path), "--bundle", "--device", "cpu"])


def _write_wav(path, samples, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((samples * 32768).astype(np.int16).tobytes())


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_infer_matches_jax(tmp_path, capsys, streaming):
    ckpt, cfg, model = _checkpoint(tmp_path, seed=2, blank_bias=0.8)
    rng = np.random.RandomState(5)
    audio = (rng.randn(24000) * 0.2).astype(np.float32)
    _write_wav(tmp_path / "a.wav", audio)
    audio, _ = cli_infer.read_wav(str(tmp_path / "a.wav"))

    args = [str(ckpt), str(tmp_path / "a.wav"), "--device", "cpu"]
    text = cli_infer.main(args + (["--streaming"] if streaming else []))
    assert capsys.readouterr().out.strip() == text.strip()

    # rnnt_tpu on the same weights and samples.
    jcfg = jconfig.load_config(ckpt / "config.yaml")
    jspec, jfspec = jconfig.build_model_spec(jcfg), jconfig.build_featurizer_spec(jcfg)
    params, state = jax.tree.map(jnp.asarray, to_jax(model))
    if streaming:
        session = JStreamingSession(params, state, jspec, jfspec)
        for i in range(0, len(audio), 3200):
            session.feed(audio[i:i + 3200])
        ids = session.tokens()
    else:
        enc, t_lens = jeval_forward(jspec, jfspec, "fp32")(
            params, state, {"audio": audio[None], "audio_lens": np.array([len(audio)])})
        tokens, counts = jgreedy({"predictor": params["predictor"], "joint": params["joint"]},
                                 enc, t_lens, jspec.predictor, jspec.joint, max_tokens=400)
        ids = np.asarray(tokens)[0, : int(counts[0])].tolist()
    assert len(ids) > 0
    assert text == UnigramTokenizer.from_vocab_json(cfg.tokenizer.vocab_json).decode(ids)


def test_read_wav_refuses_8bit(tmp_path):
    """An 8-bit WAV (the ``wave`` module's unsigned bytes) raises ValueError.
    This diverges from ``rnnt_tpu/cli/infer.py:24-34``, which reads any
    WAV's bytes as int16 samples, so 8-bit audio decodes there as noise at
    half the length."""
    path = tmp_path / "a8.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(16000)
        w.writeframes(np.full(1600, 128, np.uint8).tobytes())
    with pytest.raises(ValueError, match="expected 16-bit samples, got 8-bit"):
        cli_infer.read_wav(str(path))


def test_infer_refuses_other_rates(tmp_path):
    ckpt, _, _ = _checkpoint(tmp_path, seed=0)
    _write_wav(tmp_path / "a.wav", np.zeros(8000, np.float32), rate=8000)
    with pytest.raises(ValueError, match="expected 16000 Hz"):
        cli_infer.main([str(ckpt), str(tmp_path / "a.wav"), "--device", "cpu"])


def test_serve_main_serves_until_shutdown(tmp_path, capsys, monkeypatch):
    """``main`` prints its address, serves, and stops its pump on the way
    out."""
    ckpt, _, _ = _checkpoint(tmp_path, seed=0)
    servers = []
    real = cli_serve.make_server
    monkeypatch.setattr(cli_serve, "make_server",
                        lambda argv: servers.append(real(argv)) or servers[-1])
    th = threading.Thread(target=cli_serve.main,
                          args=([str(ckpt), "--port", "0", "--device", "cpu"],),
                          daemon=True)
    th.start()
    out = ""
    for _ in range(200):
        out += capsys.readouterr().out
        if "serving on" in out:
            break
        time.sleep(0.05)
    assert f"serving on http://127.0.0.1:{servers[0].server_address[1]}" in out
    servers[0].shutdown()
    th.join(timeout=10)
    assert not th.is_alive() and not servers[0].runtime._thread.is_alive()


def test_pump_failure_reaches_requests():
    """A pump that raises ends the pump thread; a feed waiting on it raises
    with the pump's error instead of waiting out its timeout."""
    class FailingPool:
        def __init__(self):
            self.buffered = 0

        def open(self):
            return 0

        def feed(self, slot, audio):
            self.buffered += len(audio)

        def has_ready(self):
            return self.buffered > 0

        def slot_ready(self, slot):
            return self.buffered > 0

        def tokens(self, slot):
            return []

        def pump(self):
            raise ValueError("device step failed")

    runtime = cli_serve.ServerRuntime(FailingPool(), tokenizer=None)
    try:
        sid = runtime.open()
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="device step failed"):
            runtime.feed(sid, np.zeros(10, np.float32), timeout=30.0)
        assert time.perf_counter() - t0 < 10
    finally:
        runtime.stop()
    assert not runtime._thread.is_alive()
