"""Beam search and N-best marginal rescoring of rnnt_tpu_torch against
rnnt_tpu on the CPU, with the same weights (compat/jax_params) and inputs
(numpy seeds), at the tiny sizes of tests/test_beam.py (H 16, V 12).

* ``merge_duplicate_scores`` equal to JAX's on random cases with dead lanes
  and duplicate histories;
* ``beam_decode`` tokens and counts equal to JAX's and scores within 1e-5
  (relative and absolute), over beam width {1, 4, 8}, ``frames_per_step``
  {1, 8}, ``merge_paths``, ``search_norm`` and ``greedy_guard``, on the conv
  and the LSTM predictor, with a short lane and a buffer that fills;
* ``beam_decode_nbest``: every lane, dead ones included, equal to JAX's;
* ``marginal_rescore``: NLLs within 1e-4 relative of JAX's, the same pick
  (the lattice NLL is K3's plain version on CPU tensors);
* on the port alone: width 1 equals its greedy decode, window 8 equals
  window 1, and the exhaustive search on a tiny lattice;
* ``cli.eval --device cpu --beam 4`` and ``--beam 4 --rescore`` on a tiny
  checkpoint written by the port print the hypotheses of direct calls.
"""

import json
from itertools import product

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.decode import beam as jbeam  # noqa: E402
from rnnt_tpu.decode import rescore as jrescore  # noqa: E402
from rnnt_tpu.models import joint as jjoint  # noqa: E402
from rnnt_tpu.models import predictor as jpred  # noqa: E402
from rnnt_tpu_torch.cli import eval as tcli_eval  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import load_jax_params, save_checkpoint  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data.dataset import synthetic_piece_table  # noqa: E402
from rnnt_tpu_torch.decode import beam as tbeam  # noqa: E402
from rnnt_tpu_torch.decode.greedy import greedy_decode  # noqa: E402
from rnnt_tpu_torch.decode.rescore import marginal_rescore  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.models import predictor as tpred  # noqa: E402
from rnnt_tpu_torch.models.predictor import predictor_apply  # noqa: E402
from rnnt_tpu_torch.models.rnnt import rnnt_init  # noqa: E402
from rnnt_tpu_torch.ops.transducer import transducer_loss  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402
from rnnt_tpu_torch.train.step import batch_to_device, make_eval_forward  # noqa: E402

H, V = 16, 12
GEN = torch.Generator().manual_seed(0)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
NLL_RTOL = 1e-4
# Three lanes, one of them short; frames scaled as tests/test_beam.py does.
T_LENS = np.array([17, 11, 3], np.int32)


def _models(kind: str, seed: int, blank_bias: float):
    """(JAX params, JAX predictor spec, JAX joint spec, port predictor,
    port joint, port predictor spec, port joint spec) with equal weights;
    the blank's output bias is raised by ``blank_bias``."""
    if kind == "conv":
        kw = dict(num_symbols=V, output_dim=H, symbol_embedding_dim=8)
        jp, tp = jpred.ConvPredictorSpec(**kw), tpred.ConvPredictorSpec(**kw)
        pparams = jpred.conv_predictor_init(jax.random.PRNGKey(seed), jp)
        module = tpred.ConvPredictor(tp, GEN)
    else:
        kw = dict(num_symbols=V, output_dim=H, symbol_embedding_dim=8,
                  num_lstm_layers=2, lstm_hidden_dim=16, lstm_layer_norm=True)
        jp, tp = jpred.LSTMPredictorSpec(**kw), tpred.LSTMPredictorSpec(**kw)
        pparams = jpred.lstm_predictor_init(jax.random.PRNGKey(seed), jp)
        module = tpred.LSTMPredictor(tp, GEN)
    jk = dict(audio_features=-1, text_features=-1, hidden_features=H, num_classes=V)
    jj, tj = jjoint.JointSpec(**jk), tjoint.JointSpec(**jk)
    params = jax.tree.map(np.array, {
        "predictor": pparams, "joint": jjoint.joint_init(jax.random.PRNGKey(seed + 1), jj)})
    params["joint"]["out"]["b"][V - 1] += blank_bias
    pred = load_jax_params(module, params["predictor"])
    joint = load_jax_params(tjoint.Joint(tj, GEN), params["joint"])
    return params, jp, jj, pred, joint, tp, tj


def _audio(seed: int, T: int = 17, B: int = 3):
    return (np.random.RandomState(seed).randn(B, T, H) * 0.7).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------ path merging ------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_duplicate_scores_matches_jax(seed):
    rng = np.random.RandomState(seed)
    B, K, L, blank = 3, 6, 5, V - 1
    n = rng.randint(0, 4, (B, K))
    tokens = np.full((B, K, L), blank, np.int32)
    for b, k in product(range(B), range(K)):
        tokens[b, k, :n[b, k]] = rng.randint(0, 3, n[b, k])  # 3 labels: duplicates
    tokens[:, 3], n[:, 3] = tokens[:, 1], n[:, 1]  # one duplicate per utterance at least
    score = (rng.randn(B, K) * 3).astype(np.float32)
    score[rng.rand(B, K) < 0.3] = -1e30
    want = np.asarray(jbeam.merge_duplicate_scores(
        jnp.asarray(tokens), jnp.asarray(n, jnp.int32), jnp.asarray(score)))
    got = tbeam.merge_duplicate_scores(_t(tokens).long(), _t(n).long(), _t(score)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    assert (want <= -1e29).sum() > (score <= -1e29).sum()  # some lane was merged away


# ------------------------------ beam decode ------------------------------

# (beam width, frames_per_step, merge_paths, search_norm, greedy_guard,
# max_tokens): each value of each option and the defaults (8, 8, on, on,
# on).  Blank bias +1 for a buffer of 20 (raw ranking leaves lanes below
# it); at 0 a buffer of 5 fills.
BEAM_CASES = [
    (1, 1, False, False, False, 20),
    (1, 8, True, True, True, 20),
    (4, 1, True, True, True, 20),
    (4, 8, False, True, False, 5),
    (8, 8, True, True, True, 20),
    (8, 1, False, False, True, 20),
    (8, 8, True, False, False, 5),
]


@pytest.mark.parametrize("kind", ["conv", "lstm"])
@pytest.mark.parametrize("K,W,merge,norm,guard,max_tokens", BEAM_CASES)
def test_beam_decode_matches_jax(kind, K, W, merge, norm, guard, max_tokens):
    params, jp, jj, pred, joint, tp, tj = _models(
        kind, 3, blank_bias=0.0 if max_tokens == 5 else 1.0)
    audio = _audio(4)
    opts = dict(beam_width=K, max_tokens=max_tokens, merge_paths=merge,
                frames_per_step=W, search_norm=norm, greedy_guard=guard)
    want = [np.asarray(x) for x in jax.jit(lambda p, a, tl: jbeam.beam_decode(
        p, a, tl, jp, jj, **opts))(params, jnp.asarray(audio), jnp.asarray(T_LENS))]
    with torch.inference_mode():
        got = tbeam.beam_decode(pred, joint, _t(audio), _t(T_LENS), tp, tj, **opts)
    assert got[0].dtype == got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[2].numpy(), want[2], **SCORE_TOL)
    assert want[1].max() > 0
    if max_tokens == 5:
        assert want[1].max() == max_tokens


@pytest.mark.parametrize("kind,seed", [("conv", 5), ("lstm", 6)])
def test_beam_nbest_matches_jax_every_lane(kind, seed):
    """At blank bias +3 some lanes end dead (merged away at the last frame)."""
    params, jp, jj, pred, joint, tp, tj = _models(kind, seed, blank_bias=3.0)
    audio = _audio(6)
    want = [np.asarray(x) for x in jax.jit(lambda p, a, tl: jbeam.beam_decode_nbest(
        p, a, tl, jp, jj, beam_width=8, max_tokens=12))(
        params, jnp.asarray(audio), jnp.asarray(T_LENS))]
    with torch.inference_mode():
        got = tbeam.beam_decode_nbest(pred, joint, _t(audio), _t(T_LENS), tp, tj,
                                      beam_width=8, max_tokens=12)
    assert got[0].shape == (3, 9, 12)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[2].numpy(), want[2], **SCORE_TOL)
    assert (want[2] <= -1e29).any()  # dead lanes are compared too


@pytest.mark.parametrize("kind", ["conv", "lstm"])
def test_marginal_rescore_matches_jax(kind):
    params, jp, jj, pred, joint, tp, tj = _models(kind, 4, blank_bias=1.5)
    audio = _audio(9, T=12, B=2)
    t_lens = np.array([12, 9], np.int32)
    toks, cnts, _ = jax.jit(lambda p, a, tl: jbeam.beam_decode_nbest(
        p, a, tl, jp, jj, beam_width=4, max_tokens=10))(
        params, jnp.asarray(audio), jnp.asarray(t_lens))
    want_t, want_n, want_nll = [np.asarray(x) for x in jax.jit(
        lambda p, a, tl, tk, cn: jrescore.marginal_rescore(
            p, a, tl, tk, cn, jp, jj, chunk_size=4))(
        params, jnp.asarray(audio), jnp.asarray(t_lens), toks, cnts)]
    with torch.inference_mode():
        got_t, got_n, got_nll = marginal_rescore(
            pred, joint, _t(audio), _t(t_lens), _t(toks), _t(cnts), tp, tj, chunk_size=4)
    assert got_nll.shape == (2, 5)
    np.testing.assert_array_equal(np.isfinite(got_nll.numpy()), np.isfinite(want_nll))
    fin = np.isfinite(want_nll)
    np.testing.assert_allclose(got_nll.numpy()[fin], want_nll[fin], rtol=NLL_RTOL)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_nll.argmin(dim=1).numpy(), want_nll.argmin(axis=1))


# ------------------------------ the port alone ------------------------------

@pytest.mark.parametrize("kind", ["conv", "lstm"])
def test_beam_width_one_equals_greedy(kind):
    _, _, _, pred, joint, tp, tj = _models(kind, 2, blank_bias=1.0)
    audio, t_lens = _t(_audio(2)), _t(T_LENS)
    with torch.inference_mode():
        g_tok, g_n = greedy_decode(pred, joint, audio, t_lens, tp, tj, max_tokens=15,
                                   max_symbols_per_step=3)
        b_tok, b_n, _ = tbeam.beam_decode(pred, joint, audio, t_lens, tp, tj,
                                          beam_width=1, max_tokens=15,
                                          expansions_per_frame=3, search_norm=False,
                                          merge_paths=False, greedy_guard=False)
    np.testing.assert_array_equal(b_n.numpy(), g_n.numpy())
    np.testing.assert_array_equal(b_tok.numpy(), g_tok.numpy())
    assert 0 < int(g_n.max()) < 15


@pytest.mark.parametrize("kind", ["conv", "lstm"])
def test_window_skip_equals_frame_at_a_time(kind):
    _, _, _, pred, joint, tp, tj = _models(kind, 13, blank_bias=1.0)
    audio, t_lens = _t(_audio(21)), _t(T_LENS)
    with torch.inference_mode():
        runs = [tbeam.beam_decode(pred, joint, audio, t_lens, tp, tj, beam_width=4,
                                  max_tokens=20, frames_per_step=w) for w in (1, 8)]
    (tok1, n1, s1), (tok8, n8, s8) = runs
    np.testing.assert_array_equal(n8.numpy(), n1.numpy())
    np.testing.assert_array_equal(tok8.numpy(), tok1.numpy())
    np.testing.assert_allclose(s8.numpy(), s1.numpy(), **SCORE_TOL)
    assert int(n1.max()) > 0


def test_beam_matches_exhaustive_search_on_tiny_lattice():
    """T = 3, U <= 3, V = 5: every one of the 85 label sequences scored by
    the exact lattice NLL; the beam (K 96 >= 85, paths merged, raw ranking)
    returns the most probable one with its exact log-probability
    (tests/test_beam.py:102-165)."""
    Vt, T, U = 5, 3, 3
    kw = dict(num_symbols=Vt, output_dim=H, symbol_embedding_dim=8)
    jk = dict(audio_features=-1, text_features=-1, hidden_features=H, num_classes=Vt)
    tp, tj = tpred.ConvPredictorSpec(**kw), tjoint.JointSpec(**jk)
    pred = load_jax_params(tpred.ConvPredictor(tp, GEN), jax.tree.map(
        np.array, jpred.conv_predictor_init(jax.random.PRNGKey(31),
                                            jpred.ConvPredictorSpec(**kw))))
    joint = load_jax_params(tjoint.Joint(tj, GEN), jax.tree.map(
        np.array, jjoint.joint_init(jax.random.PRNGKey(32), jjoint.JointSpec(**jk))))
    audio = torch.from_numpy((np.random.RandomState(33).randn(2, T, H) * 0.8)
                             .astype(np.float32))
    t_lens = [3, 2]
    seqs = [list(s) for n in range(U + 1) for s in product(range(Vt - 1), repeat=n)]
    assert len(seqs) == 85
    targets = torch.zeros((85, U), dtype=torch.long)
    u_lens = torch.tensor([len(s) for s in seqs])
    for i, s in enumerate(seqs):
        targets[i, :len(s)] = torch.tensor(s, dtype=torch.long)
    with torch.inference_mode():
        text = predictor_apply(pred, torch.cat(
            [torch.full((85, 1), Vt - 1, dtype=torch.long), targets], dim=1))
        for b in range(2):
            exact = -transducer_loss(joint, audio[b:b + 1].expand(85, T, H), text, targets,
                                     torch.full((85,), t_lens[b]), u_lens, Vt - 1,
                                     chunk_size=4, reduction="none")
            best = int(exact.argmax())
            tok, n, score = tbeam.beam_decode(
                pred, joint, audio[b:b + 1], torch.tensor([t_lens[b]]), tp, tj,
                beam_width=96, max_tokens=U, expansions_per_frame=U, length_norm=False,
                merge_paths=True, search_norm=False)
            assert tok[0, :int(n[0])].tolist() == seqs[best], b
            np.testing.assert_allclose(float(score[0]), float(exact[best]),
                                       rtol=1e-4, atol=1e-4)


# ------------------------------ cli.eval ------------------------------

def _eval_checkpoint(root):
    vocab = root / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table(255)))
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")), [
        "tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}", "num_text_tokens=255",
        "num_total_symbols=256", "blank_idx=255", "training.precision=fp32",
        "training.frame_buckets=[96]", "training.token_buckets=[12]",
        "data.dataset=synthetic", "data.synthetic_size=8", "data.synthetic_seconds=0.9",
        "data.synthetic_max_words=6", "data.augment=false", "training.loss_chunk_size=8"])
    model = rnnt_init(tconfig.build_model_spec(cfg), seed=3)
    with torch.no_grad():
        model.joint.out.b[cfg.blank_idx] += 0.5
    return save_checkpoint(root / "ckpt", cfg, model), cfg, model


@pytest.mark.parametrize("rescore", [False, True], ids=["beam4", "beam4-rescore"])
def test_cli_eval_beam_equals_direct_calls(tmp_path, capsys, rescore):
    ckpt, cfg, model = _eval_checkpoint(tmp_path)
    argv = [str(ckpt), "--device", "cpu", "--batch-size", "2", "--max-elements", "4",
            "--beam", "4"] + (["--rescore"] if rescore else [])
    res = tcli_eval.main(argv)
    printed = [ln[len("Decoded : "):] for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Decoded : ")]
    assert res["utterances"] == 4 and np.isfinite(res["wer"])

    spec = tconfig.build_model_spec(cfg)
    fspec = tconfig.build_featurizer_spec(cfg)
    tokenizer = tloop._load_tokenizer(cfg)
    forward = make_eval_forward(spec, fspec, "fp32")
    dec, specs = (model.predictor, model.joint), (spec.predictor, spec.joint)
    want = []
    with torch.inference_mode():
        for batch in tloop.eval_batches(cfg, tokenizer, batch_size=2, max_batches=2):
            audio, t_lens = forward(model, batch_to_device(batch, "cpu"))
            if rescore:
                toks, cnts, _ = tbeam.beam_decode_nbest(*dec, audio, t_lens, *specs,
                                                        beam_width=4, max_tokens=12)
                tokens, counts, nll = marginal_rescore(*dec, audio, t_lens, toks, cnts,
                                                       *specs, chunk_size=8)
                assert torch.isfinite(nll).any(dim=1).all()
            else:
                tokens, counts, _ = tbeam.beam_decode(*dec, audio, t_lens, *specs,
                                                      beam_width=4, max_tokens=12)
            want += [tokenizer.decode(tokens[i, :int(counts[i])].tolist())
                     for i in range(len(counts)) if batch["target_lens"][i] > 0]
    assert printed == want
    assert any(want)
