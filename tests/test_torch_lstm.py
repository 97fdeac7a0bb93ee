"""The layer-normed LSTM predictor of rnnt_tpu_torch against rnnt_tpu on the
CPU, with the same weights (compat/jax_params) and inputs (numpy seeds),
through training, greedy decode, streaming and serving.

* ``LSTMPredictor`` features and per-layer (h, c) within 1e-5 of
  ``lstm_predictor_apply``, with layer norm on and off, 1 and 2 layers;
  one-token stateful steps equal to the full sequence;
* ``from_jax`` / ``to_jax`` round trip (the JAX pytree names: ``x2g.b``
  only without layer norm);
* the loss and every parameter gradient of a training forward (dropout
  off) within 1e-4 relative of JAX's, for the chunked and the fused loss
  (the fused kernels' plain versions here; JAX in interpret mode); a
  parameter's error is taken against its gradient's norm, floored at 1e-3
  of the global gradient norm (conv biases in front of instance norms have
  a zero gradient in exact arithmetic, so only round-off is left there);
* ``cli.train`` 2 steps on an LSTM config, then ``cli.eval`` greedy and
  ``--beam 2 --rescore`` on its checkpoint;
* greedy tokens equal to JAX's (blank-heavy, mixed, at the per-frame cap,
  at ``max_tokens``), and the incremental carry over three chunks equal to
  JAX's and its tokens to one call;
* a ``StreamingSession`` equal to JAX's, and with batch norm to offline
  featurize + encoder + greedy (tests/test_streaming_lstm.py); the pool's
  LSTM streams equal to dedicated sessions;
* ``cli.serve`` on an LSTM checkpoint (``--port 0``) answering a stream as
  the pool does, and ``cli.infer`` offline and ``--streaming``.
"""

import dataclasses
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.decode import greedy as jgreedy  # noqa: E402
from rnnt_tpu.decode.streaming import StreamingSession as JStreamingSession  # noqa: E402
from rnnt_tpu.models import encoder as jenc  # noqa: E402
from rnnt_tpu.models import joint as jjoint  # noqa: E402
from rnnt_tpu.models import predictor as jpred  # noqa: E402
from rnnt_tpu.models import rnnt as jrnnt  # noqa: E402
from rnnt_tpu.train import step as jstep  # noqa: E402
from rnnt_tpu_torch.cli import eval as tcli_eval  # noqa: E402
from rnnt_tpu_torch.cli import infer as tcli_infer  # noqa: E402
from rnnt_tpu_torch.cli import serve as tcli_serve  # noqa: E402
from rnnt_tpu_torch.cli import train as tcli_train  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import (  # noqa: E402
    flatten_tree, from_jax, load_jax_params, save_checkpoint, to_jax)
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.decode import greedy as tgreedy  # noqa: E402
from rnnt_tpu_torch.decode.streaming import (  # noqa: E402
    StreamingSession, StreamingSessionPool)
from rnnt_tpu_torch.models import encoder as tenc  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.models import predictor as tpred  # noqa: E402
from rnnt_tpu_torch.models import rnnt as trnnt  # noqa: E402
from rnnt_tpu_torch.models.rnnt import rnnt_init  # noqa: E402
from rnnt_tpu_torch.ops import stft as tstft  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402
from rnnt_tpu_torch.train import step as tstep  # noqa: E402

GEN = torch.Generator().manual_seed(0)
FEAT_TOL = 1e-5
RTOL = 1e-4
GRAD_FLOOR = 1e-3


def _np(x):
    return x.detach().cpu().numpy()


def _lstm_pair(seed, **kw):
    """(JAX spec, JAX params, port spec, port predictor) with equal weights."""
    jspec, tspec = jpred.LSTMPredictorSpec(**kw), tpred.LSTMPredictorSpec(**kw)
    params = jax.tree.map(np.array, jpred.lstm_predictor_init(jax.random.PRNGKey(seed), jspec))
    return jspec, params, tspec, load_jax_params(tpred.LSTMPredictor(tspec, GEN), params)


# ------------------------------ the module ------------------------------

@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "no-ln"])
@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_predictor_matches_jax(layer_norm, layers):
    jspec, params, _, pred = _lstm_pair(
        layers, num_symbols=32, output_dim=24, symbol_embedding_dim=16,
        num_lstm_layers=layers, lstm_hidden_dim=20, lstm_layer_norm=layer_norm)
    assert ("b" in params["layers"][0]["x2g"]) == (not layer_norm)
    tokens = np.random.RandomState(1).randint(0, 32, (3, 9))
    rng = np.random.RandomState(2)
    state0 = tuple({"h": rng.randn(3, 20).astype(np.float32),
                    "c": rng.randn(3, 20).astype(np.float32)} for _ in range(layers))
    for st in (None, state0):
        want, want_state = jpred.lstm_predictor_apply(
            params, jnp.asarray(tokens), jspec,
            state=None if st is None else jax.tree.map(jnp.asarray, st))
        with torch.no_grad():
            got, got_state = pred(torch.from_numpy(tokens), None if st is None else
                                  tgreedy.tree_map(torch.from_numpy, st))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=FEAT_TOL)
        for g, w in zip(got_state, want_state):
            np.testing.assert_allclose(_np(g["h"]), np.asarray(w["h"]), atol=FEAT_TOL)
            np.testing.assert_allclose(_np(g["c"]), np.asarray(w["c"]), atol=FEAT_TOL)


def test_lstm_stateful_steps_equal_full():
    _, _, _, pred = _lstm_pair(0, num_symbols=32, output_dim=24, symbol_embedding_dim=16,
                               num_lstm_layers=2, lstm_hidden_dim=20, lstm_layer_norm=True)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 32, (2, 9)))
    with torch.no_grad():
        full, full_state = pred(tokens)
        state, outs = pred.init_state(2), []
        for u in range(9):
            y, state = pred(tokens[:, u:u + 1], state)
            outs.append(y)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full), atol=FEAT_TOL)
    for a, b in zip(state, full_state):
        np.testing.assert_allclose(_np(a["c"]), _np(b["c"]), atol=FEAT_TOL)


def _rnnt_specs(layer_norm=True, layers=2):
    enc = dict(input_features=201, norm_type="batch", prologue_kernel_size=7,
               prologue_stride=2, epilogue_features=24, epilogue_kernel_size=9,
               epilogue_dilation=2, output_features=32)
    block = dict(kernel_size=5, in_channels=24, out_channels=24, dropout=0.0,
                 num_sub_blocks=1, norm_type="batch")
    pred = dict(num_symbols=48, output_dim=32, symbol_embedding_dim=16,
                num_lstm_layers=layers, lstm_hidden_dim=24, lstm_layer_norm=layer_norm)
    joint = dict(audio_features=-1, text_features=-1, hidden_features=32, num_classes=48)
    return [pkg_rnnt.RNNTSpec(
        encoder=pkg_enc.EncoderSpec(blocks=(pkg_enc.JasperBlockSpec(**block),), **enc),
        predictor=pkg_pred.LSTMPredictorSpec(**pred), joint=pkg_joint.JointSpec(**joint))
        for pkg_rnnt, pkg_enc, pkg_pred, pkg_joint in (
            (jrnnt, jenc, jpred, jjoint), (trnnt, tenc, tpred, tjoint))]


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "no-ln"])
def test_lstm_params_round_trip(layer_norm):
    jspec, tspec = _rnnt_specs(layer_norm)
    params, state = jax.tree.map(np.asarray, jrnnt.rnnt_init(jax.random.PRNGKey(0), jspec))
    model = from_jax(params, state, tspec)
    back_p, back_s = to_jax(model)
    want, got = flatten_tree(params), flatten_tree(back_p)
    assert sorted(got) == sorted(want)
    assert ("predictor/layers/0/x2g/b" in got) == (not layer_norm)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    fresh = flatten_tree(to_jax(rnnt_init(tspec, seed=1))[0])
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in want.items()}


# ------------------------------ training ------------------------------

LSTM_OVERRIDES = ["predictor.kind=lstm", "predictor.num_lstm_layers=2",
                  "predictor.lstm_hidden_dim=24", "predictor.lstm_layer_norm=true"]


def _train_overrides(vocab, loss_impl="chunked"):
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
            "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
            "training.precision=fp32", "training.global_batch_size=2",
            "training.frame_buckets=[96]", "training.token_buckets=[12]",
            "training.eval_max_elements=4", "data.dataset=synthetic",
            "data.synthetic_size=8", "data.synthetic_seconds=0.9",
            "data.synthetic_max_words=6", f"training.loss_impl={loss_impl}",
            "training.lr_schedule.warmup_steps=2", "data.augment=false",
            "training.loss_chunk_size=8", *LSTM_OVERRIDES]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(synthetic_piece_table(255)))
    return path


@pytest.mark.parametrize("loss_impl", ["chunked", "pallas"])
def test_lstm_training_gradients_match_jax(vocab, loss_impl):
    """Loss and every parameter's gradient of one batch, dropout off."""
    ov = _train_overrides(vocab, loss_impl)
    jcfg = jconfig.apply_overrides(jconfig.load_config(
        tconfig.CONFIG_DIR / "tiny_conv.yaml"), ov)
    tcfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")), ov)
    jspec, tspec = jconfig.build_model_spec(jcfg), tconfig.build_model_spec(tcfg)
    assert isinstance(tspec.predictor, tpred.LSTMPredictorSpec)
    fspec = tconfig.build_featurizer_spec(tcfg)
    batch = next(iter(tloop.BatchIterator(
        tloop._load_datasets(tcfg)[0], tloop._load_tokenizer(tcfg),
        tloop.Buckets.from_frames([96], [12], fspec), batch_size=2, shuffle=True,
        seed=0, wire_dtype="int16")))
    params, state = jax.tree.map(np.asarray, jrnnt.rnnt_init(jax.random.PRNGKey(0), jspec))

    jloss = jstep.make_loss_fn(jspec, jconfig.build_featurizer_spec(jcfg), "fp32")
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, state, {k: jnp.asarray(v) for k, v in batch.items()}, None, True),
        has_aux=True))(params)
    model = from_jax(params, state, tspec)
    loss = tstep.make_loss_fn(tspec, fspec, "fp32")(
        model, tstep.batch_to_device(batch, "cpu"), training=True)
    names, tparams = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, tparams)))

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    want_g = {k.replace("/", "."): np.asarray(v) for k, v in flatten_tree(want_g).items()}
    assert sorted(want_g) == sorted(grads)
    total = np.sqrt(sum(np.sum(g ** 2) for g in want_g.values()))
    worst = {}
    for k, w in want_g.items():
        err = np.linalg.norm(_np(grads[k]) - w)
        worst[k] = err / max(np.linalg.norm(w), GRAD_FLOOR * total)
    assert max(worst.values()) <= RTOL, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert np.linalg.norm(want_g["predictor.layers.1.p2g.w"]) > 0


def test_cli_train_and_eval_lstm(vocab, tmp_path, capsys):
    args = ["--config", "tiny_conv", "--max-steps", "2", "--device", "cpu",
            "--output-base", str(tmp_path)]
    for o in _train_overrides(vocab) + ["training.log_steps=1"]:
        args += ["--set", o]
    tcli_train.main(args)
    run = tmp_path / "tiny_conv" / "run-1"
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/train"] for r in rows if "loss/train" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = run / "checkpoint_step_2"
    for extra in ([], ["--beam", "2", "--rescore"]):
        res = tcli_eval.main([str(ckpt), "--device", "cpu", "--batch-size", "2",
                              "--max-elements", "4", *extra])
        assert res["utterances"] == 4 and np.isfinite(res["wer"])
    assert capsys.readouterr().out.count("Decoded : ") == 8


# ------------------------------ greedy decode ------------------------------

PK = dict(num_symbols=40, output_dim=32, symbol_embedding_dim=24, num_lstm_layers=2,
          lstm_hidden_dim=24, lstm_layer_norm=True)
JK = dict(audio_features=-1, text_features=-1, hidden_features=32, num_classes=40)


def _decoder(blank_bias, seed=0):
    jspec, pparams, tspec, pred = _lstm_pair(seed, **PK)
    jj, tj = jjoint.JointSpec(**JK), tjoint.JointSpec(**JK)
    jparams = jax.tree.map(np.array, jjoint.joint_init(jax.random.PRNGKey(seed + 1), jj))
    jparams["out"]["b"][39] += blank_bias
    joint = load_jax_params(tjoint.Joint(tj, GEN), jparams)
    dec = jax.tree.map(jnp.asarray, {"predictor": pparams, "joint": jparams})
    return dec, jspec, jj, pred, joint, tspec, tj


@pytest.mark.parametrize("blank_bias,max_tokens", [
    (3.0, 64), (0.0, 64), (-30.0, 300), (-30.0, 17)])
def test_lstm_greedy_matches_jax(blank_bias, max_tokens):
    dec, jspec, jj, pred, joint, tspec, tj = _decoder(blank_bias)
    rng = np.random.RandomState(2)
    audio = rng.randn(3, 23, 32).astype(np.float32)
    t_lens = np.array([23, 17, 1], np.int32)
    want_tok, want_n = map(np.asarray, jax.jit(lambda a, tl: jgreedy.greedy_decode(
        dec, a, tl, jspec, jj, max_tokens=max_tokens))(jnp.asarray(audio), jnp.asarray(t_lens)))
    with torch.inference_mode():
        outs = [tgreedy.greedy_decode(pred, joint, torch.from_numpy(audio),
                                      torch.from_numpy(t_lens), tspec, tj,
                                      max_tokens=max_tokens, frames_per_step=w)
                for w in (8, 1)]
    for tok, n in outs:
        np.testing.assert_array_equal(n.numpy(), want_n)
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert want_n.max() > 0 or blank_bias > 0


def test_lstm_greedy_incremental_matches_jax_and_one_call():
    dec, jspec, jj, pred, joint, tspec, tj = _decoder(0.3, seed=3)
    rng = np.random.RandomState(4)
    chunks = [rng.randn(3, T, 32).astype(np.float32) for T in (9, 4, 12)]
    jcarry = jgreedy.decode_init_carry(dec, jspec, jj, 3)
    with torch.inference_mode():
        tcarry = tgreedy.decode_init_carry(pred, tspec, tj, 3)
        np.testing.assert_allclose(_np(tcarry[0]), np.asarray(jcarry[0]), atol=FEAT_TOL)
        jdecode = jax.jit(lambda a, tl, c: jgreedy.greedy_decode_incremental(
            dec, a, tl, jspec, jj, max_tokens=128, carry=c))
        streamed = [[] for _ in range(3)]
        for audio in chunks:
            t_lens = np.full((3,), audio.shape[1], np.int32)
            jtok, jn, jcarry = jdecode(jnp.asarray(audio), jnp.asarray(t_lens), jcarry)
            ttok, tn, tcarry = tgreedy.greedy_decode_incremental(
                pred, joint, torch.from_numpy(audio), torch.from_numpy(t_lens), tspec, tj,
                max_tokens=128, carry=tcarry)
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            np.testing.assert_allclose(_np(tcarry[0]), np.asarray(jcarry[0]), atol=FEAT_TOL)
            for g, w in zip(tcarry[1], jcarry[1]):
                np.testing.assert_allclose(_np(g["h"]), np.asarray(w["h"]), atol=FEAT_TOL)
                np.testing.assert_allclose(_np(g["c"]), np.asarray(w["c"]), atol=FEAT_TOL)
            for b in range(3):
                streamed[b] += ttok[b, :int(tn[b])].tolist()
        whole = np.concatenate(chunks, axis=1)
        tok, n = tgreedy.greedy_decode(pred, joint, torch.from_numpy(whole),
                                       torch.full((3,), whole.shape[1]), tspec, tj,
                                       max_tokens=384)
    # No chunk's budget cut it short (128 > 10 emissions x 12 frames).
    assert [tok[b, :int(n[b])].tolist() for b in range(3)] == streamed
    assert sum(map(len, streamed)) > 0


# ------------------------------ streaming ------------------------------

def _stream_model(blank_bias=0.0):
    """tests/test_streaming_lstm.py's spec: batch norm, a 1-layer
    layer-normed LSTM predictor; JAX init from seed 4, where the blank's
    bias at 0 makes the model emit some tokens, not at every frame."""
    jspec, tspec = _rnnt_specs(True, layers=1)
    params, state = jax.tree.map(np.array, jrnnt.rnnt_init(jax.random.PRNGKey(4), jspec))
    params["joint"]["out"]["b"][47] = blank_bias
    return jspec, params, state, tspec, from_jax(params, state, tspec)


def _wave(n=12800, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32) * 0.3
            + np.sin(2 * np.pi * 700 * np.arange(n) / 16000).astype(np.float32) * 0.4)


def test_lstm_streaming_matches_jax_and_offline():
    jspec, params, state, tspec, model = _stream_model()
    wave_ = _wave()
    js = JStreamingSession(params, state, jspec, tstft.FeaturizerSpec())
    ts = StreamingSession(model, tstft.FeaturizerSpec())
    for i in range(0, len(wave_), 3200):
        assert ts.feed(wave_[i:i + 3200]) == js.feed(wave_[i:i + 3200]), i
    n = ts.encoder_frames_emitted
    assert n == js.encoder_frames_emitted > 0
    with torch.inference_mode():
        enc = model.encoder(tstft.make_featurizer(tstft.FeaturizerSpec())(
            torch.from_numpy(wave_))[None])
        tokens, counts = tgreedy.greedy_decode(model.predictor, model.joint, enc[:, :n],
                                               torch.tensor([n]), tspec.predictor,
                                               tspec.joint, max_tokens=64)
    offline = tokens[0, :int(counts[0])].tolist()
    assert ts.tokens() == js.tokens() == offline
    assert len(offline) > 0


def test_lstm_pool_matches_single_sessions():
    """Three LSTM streams on the pool at different paces (one starting
    late, one reusing a closed slot) emit what dedicated sessions emit: the
    lanes' (h, c) are gathered, stepped and scattered, and an opened lane
    restarts from the blank step's state."""
    *_, model = _stream_model()
    fspec = tstft.FeaturizerSpec()
    waves = [_wave(9600, seed=s) for s in range(3)]
    expected = []
    for w in waves:
        s = StreamingSession(model, fspec)
        for i in range(0, len(w), 3200):
            s.feed(w[i:i + 3200])
        expected.append(s.tokens())
    assert all(expected)

    pool = StreamingSessionPool(model, fspec, slots=2, chunk_seconds=0.2)
    slots = [pool.open() for _ in range(2)]
    for tick in range(4):
        pool.feed(slots[0], waves[0][tick * 3200:(tick + 1) * 3200])
        if tick % 2 == 0:
            pool.feed(slots[1], waves[1][tick * 3200:(tick + 2) * 3200])
        pool.pump()
    assert pool.tokens(slots[0]) == expected[0]
    assert pool.tokens(slots[1]) == expected[1]
    pool.close(slots[0])
    reused = pool.open()
    assert reused == slots[0]
    for i in range(0, len(waves[2]), 3200):
        pool.feed(reused, waves[2][i:i + 3200])
        pool.pump()
    assert pool.tokens(reused) == expected[2]


# ------------------------------ serving ------------------------------

def _lstm_checkpoint(root, blank_bias=0.5):
    vocab = root / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    cfg = tconfig.Config()
    cfg.model_name = "serve_lstm"
    cfg.tokenizer.vocab_json = str(vocab)
    cfg.encoder.norm_type = "batch"
    cfg.encoder.blocks = [tconfig.BlockConfig(5, 24, 24, 0.0, 1)]
    cfg.encoder.epilogue_features = 24
    cfg.encoder.output_features = 24
    cfg.predictor = dataclasses.replace(
        cfg.predictor, kind="lstm", output_dim=24, symbol_embedding_dim=16,
        dropout=0.0, num_lstm_layers=2, lstm_hidden_dim=24)
    cfg.joint.hidden_features = 24
    cfg.training.precision = "fp32"
    model = rnnt_init(tconfig.build_model_spec(cfg), seed=2)
    with torch.no_grad():
        model.joint.out.b[cfg.blank_idx] += blank_bias
    return save_checkpoint(root / "ckpt", cfg, model), cfg, model


def _pool_text(model, cfg, audio):
    """What the server's pool answers for one stream fed ``audio`` whole and
    flushed."""
    pool = StreamingSessionPool(model, tstft.FeaturizerSpec(), slots=2)
    slot = pool.open()
    pool.feed(slot, audio)
    pool.pump()
    pool.flush(slot)
    pool.pump()
    return tloop._load_tokenizer(cfg).decode(pool.tokens(slot))


def test_cli_serve_lstm_round_trip(tmp_path):
    ckpt, cfg, model = _lstm_checkpoint(tmp_path)
    pcm = (np.random.RandomState(7).randn(16000) * 0.3 * 32768).astype(np.int16)
    want = _pool_text(model, cfg, pcm.astype(np.float32) / 32768.0)
    assert want

    server = tcli_serve.make_server([str(ckpt), "--port", "0", "--slots", "2",
                                     "--device", "cpu"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        def req(method, path, data=None):
            r = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}{path}",
                                       data=data, method=method)
            return json.loads(urllib.request.urlopen(r, timeout=120).read())

        sid = req("POST", "/session")["session"]
        req("POST", f"/feed/{sid}", pcm.tobytes())
        got = req("DELETE", f"/session/{sid}")["text"]
    finally:
        server.shutdown()
        server.runtime.stop()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive() and not server.runtime._thread.is_alive()
    assert got == want


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_cli_infer_lstm(tmp_path, capsys, streaming):
    ckpt, cfg, model = _lstm_checkpoint(tmp_path)
    pcm = (np.random.RandomState(5).randn(24000) * 0.2 * 32768).astype(np.int16)
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    text = tcli_infer.main([str(ckpt), str(tmp_path / "a.wav"), "--device", "cpu"]
                           + (["--streaming"] if streaming else []))
    assert capsys.readouterr().out.strip() == text.strip()
    audio = pcm.astype(np.float32) / 32768.0
    spec, fspec = tconfig.build_model_spec(cfg), tconfig.build_featurizer_spec(cfg)
    if streaming:
        session = StreamingSession(model, fspec)
        for i in range(0, len(audio), 3200):
            session.feed(audio[i:i + 3200])
        ids = session.tokens()
    else:
        with torch.inference_mode():
            enc, t_lens = tstep.make_eval_forward(spec, fspec, "fp32")(
                model, {"audio": torch.from_numpy(audio[None]),
                        "audio_lens": torch.tensor([len(audio)])})
            tokens, counts = tgreedy.greedy_decode(model.predictor, model.joint, enc, t_lens,
                                                   spec.predictor, spec.joint, max_tokens=400)
        ids = tokens[0, :int(counts[0])].tolist()
    assert ids and text == tloop._load_tokenizer(cfg).decode(ids)
