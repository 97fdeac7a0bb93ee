"""Greedy decode, tokenizer and WER of rnnt_tpu_torch against rnnt_tpu on the
CPU, with the same weights and inputs.

* greedy decode is token-equal (counts included) to the JAX decode, and the
  W = 8 blank-skip window equals W = 1, across a blank-heavy model, a mixed
  one, one that never emits blank (so the per-frame cap of 10 emissions
  decides) and one that stops at ``max_tokens``;
* the pure-Python unigram tokenizer segments, decodes and parses a
  SentencePiece model file exactly as the JAX package's does;
* corpus WER is equal on random word sequences.
"""

import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.data import tokenizer as jtok  # noqa: E402
from rnnt_tpu.decode.greedy import greedy_decode as jgreedy  # noqa: E402
from rnnt_tpu.models import joint as jjoint  # noqa: E402
from rnnt_tpu.models import predictor as jpred  # noqa: E402
from rnnt_tpu.train.metrics import wer as jwer  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import load_jax_params  # noqa: E402
from rnnt_tpu_torch.data import tokenizer as ttok  # noqa: E402
from rnnt_tpu_torch.decode.greedy import greedy_decode  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.models import predictor as tpred  # noqa: E402
from rnnt_tpu_torch.train.metrics import wer  # noqa: E402

V, H, D = 40, 32, 24
GEN = torch.Generator().manual_seed(0)


@pytest.mark.parametrize("blank_bias,max_tokens", [
    (3.0, 64),     # mostly blank: whole windows are skipped
    (0.0, 64),     # mixed emissions
    (-30.0, 300),  # never blank: every frame stops at the 10-emission cap
    (-30.0, 17),   # lanes stop at max_tokens
])
def test_greedy_decode_matches_jax(blank_bias, max_tokens):
    pk = dict(num_symbols=V, output_dim=H, symbol_embedding_dim=D)
    jk = dict(audio_features=-1, text_features=-1, hidden_features=H,
              num_classes=V)
    params = {
        "predictor": jpred.conv_predictor_init(jax.random.PRNGKey(0),
                                               jpred.ConvPredictorSpec(**pk)),
        "joint": jjoint.joint_init(jax.random.PRNGKey(1), jjoint.JointSpec(**jk)),
    }
    params = jax.tree.map(np.array, params)
    params["joint"]["out"]["b"][V - 1] += blank_bias
    rng = np.random.RandomState(2)
    audio = rng.randn(3, 23, H).astype(np.float32)
    t_lens = np.array([23, 17, 1], np.int32)

    jspec_p, jspec_j = jpred.ConvPredictorSpec(**pk), jjoint.JointSpec(**jk)
    want_tok, want_n = map(np.asarray, jax.jit(
        lambda p, a, tl: jgreedy(p, a, tl, jspec_p, jspec_j,
                                 max_tokens=max_tokens))(
        params, jnp.asarray(audio), jnp.asarray(t_lens)))

    tspec_p, tspec_j = tpred.ConvPredictorSpec(**pk), tjoint.JointSpec(**jk)
    pred = load_jax_params(tpred.ConvPredictor(tspec_p, GEN), params["predictor"])
    joint = load_jax_params(tjoint.Joint(tspec_j, GEN), params["joint"])
    with torch.inference_mode():
        outs = [greedy_decode(pred, joint, torch.from_numpy(audio),
                              torch.from_numpy(t_lens), tspec_p, tspec_j,
                              max_tokens=max_tokens, frames_per_step=w)
                for w in (8, 1)]
    (tok, n), (tok1, n1) = outs
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(tok1.numpy(), tok.numpy())
    np.testing.assert_array_equal(n1.numpy(), n.numpy())
    if blank_bias < 0:
        np.testing.assert_array_equal(
            n.numpy(), np.minimum(10 * t_lens, max_tokens))


def _pieces(seed):
    """A scored piece table: <unk>, a control piece, word and sub-word
    pieces, single characters (some characters of the test text have none)."""
    rng = np.random.RandomState(seed)
    words = ["the", "cat", "sat", "on", "mat", "hat", "at", "a", "th", "ca"]
    chars = sorted(set("thecasonmx"))
    table = [("<unk>", 0.0, 2), ("<s>", 0.0, 3)]
    table += [("▁" + w, float(-rng.rand() * 5), 1) for w in words]
    table += [(w, float(-rng.rand() * 8), 1) for w in words[:6]]
    table += [(c, float(-5 - rng.rand() * 5), 1) for c in chars]
    table += [("▁", -6.0, 1)]
    return table


def _texts(seed, n=40):
    rng = np.random.RandomState(seed)
    alphabet = list("thecasonmxqz ") + ["  "]
    return [" ".join("".join(rng.choice(alphabet, rng.randint(1, 8))).split())
            for _ in range(n)] + ["", "the cat sat on the mat", "zzqq the"]


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenizer_matches_jax(seed):
    pieces = _pieces(seed)
    jt, tt = jtok.UnigramTokenizer(pieces), ttok.UnigramTokenizer(pieces)
    for text in _texts(seed):
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids) == jt.decode(ids)
    assert tt.piece_table() == jt.piece_table()


def _spm_bytes(pieces) -> bytes:
    """A minimal SentencePiece ModelProto: repeated pieces (field 1) plus an
    unrelated length-delimited field the parser must skip."""
    def varint(n):
        out = bytearray()
        while True:
            b, n = n & 0x7F, n >> 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def field_bytes(num, payload):
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    body = field_bytes(2, b"\x08\x01")  # trainer_spec stand-in
    for piece, score, ptype in pieces:
        msg = (field_bytes(1, piece.encode("utf-8"))
               + varint(2 << 3 | 5) + struct.pack("<f", score)
               + varint(3 << 3 | 0) + varint(ptype))
        body += field_bytes(1, msg)
    return body


def test_spm_model_parse_matches_jax(tmp_path):
    path = tmp_path / "tiny.model"
    path.write_bytes(_spm_bytes(_pieces(3)))
    got = ttok.parse_spm_model(path)
    assert got == jtok.parse_spm_model(path)
    assert [p for p, _, _ in got] == [p for p, _, _ in _pieces(3)]
    text = "the cat sat on a hat"
    assert (ttok.UnigramTokenizer.from_file(path).encode(text)
            == jtok.UnigramTokenizer.from_file(path).encode(text))


def test_wer_matches_jax():
    rng = np.random.RandomState(4)
    vocab = ["a", "b", "c", "d"]
    refs = [" ".join(rng.choice(vocab, rng.randint(0, 7))) for _ in range(30)]
    hyps = [" ".join(rng.choice(vocab, rng.randint(0, 7))) for _ in range(30)]
    assert wer(refs, hyps) == jwer(refs, hyps)
    assert wer(refs[:1] + ["a b"], refs[:1] + ["a b"]) == 0.0
    with pytest.raises(ValueError):
        wer(["a"], [])
