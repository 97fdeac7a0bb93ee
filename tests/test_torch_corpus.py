"""The port's corpus loaders and its per-rank streamed shards against
rnnt_tpu, on the CPU.

* ``librispeech_dataset`` / ``commonvoice_dataset`` over a fake ``datasets``
  module built here (put in ``sys.modules``; neither machine has the
  corpora): the same ``load_dataset``, ``cast_column``, ``map`` and
  ``concatenate_datasets`` calls as JAX's, and the same rows;
* ``concatenate_rows`` against JAX's: the same length and rows;
* ``train.loop._load_datasets`` with the mixed recipe's ``corpus:split``
  prefixes against JAX's, and the same ``ValueError`` for an unknown
  dataset or prefix;
* ``train.loop.stream_batches``, a rank's streamed batches with the host
  recipe on, bit-equal to JAX's ``BatchIterator(..., shard_id=d,
  num_shards=2, batch_size=G/2)``, every rank of a model group taking its
  group's shard;
* a 2-rank gloo ``train`` on the streamed path over a corpus whose two
  shards yield 2 and 4 batches: both ranks end the epoch together after
  2 steps, each having augmented only rows of its own shard.
"""

import sys
import types
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rnnt_tpu.config import config as jconfig  # noqa: E402
from rnnt_tpu.data import augment as jaug  # noqa: E402
from rnnt_tpu.data import dataset as jdata  # noqa: E402
from rnnt_tpu.data.tokenizer import UnigramTokenizer as JTokenizer  # noqa: E402
from rnnt_tpu.train import loop as jloop  # noqa: E402
from rnnt_tpu_torch.config import config as tconfig  # noqa: E402
from rnnt_tpu_torch.data import augment as taug  # noqa: E402
from rnnt_tpu_torch.data import dataset as tdata  # noqa: E402
from rnnt_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from rnnt_tpu_torch.train import loop as tloop  # noqa: E402

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
from torch_ranks import run_ranks, streamed_train_rank  # noqa: E402


# --------------------------- a fake `datasets` ---------------------------

class FakeAudio:
    def __init__(self, sampling_rate):
        self.sampling_rate = sampling_rate


class FakeDataset:
    """Rows behind ``__len__`` / ``__getitem__``, with the two methods the
    loaders call; every call goes to the module's log."""

    def __init__(self, rows, log):
        self.rows, self.log = rows, log

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        row = self.rows[idx]
        return {**row, "audio": dict(row["audio"])}

    def cast_column(self, column, feature):
        self.log.append(("cast_column", column, feature.sampling_rate))
        return FakeDataset([{**r, column: {**r[column], "sampling_rate": feature.sampling_rate}}
                            for r in self.rows], self.log)

    def map(self, fn):
        self.log.append(("map",))
        return FakeDataset([fn(self[i]) for i in range(len(self))], self.log)


def _rows(path, name, split):
    rng = np.random.RandomState(zlib.crc32(f"{path}/{name}/{split}".encode()))
    key = "sentence" if "common_voice" in path else "text"
    return [{"audio": {"array": rng.randn(rng.randint(50, 90)).astype(np.float32),
                       "sampling_rate": 48_000 if key == "sentence" else 16_000},
             key: f"{split} row {i}", "id": f"{split}-{i}"}
            for i in range(rng.randint(2, 5))]


def fake_datasets():
    log = []
    mod = types.ModuleType("datasets")

    def load_dataset(path, name=None, *, split, cache_dir=None):
        log.append(("load_dataset", path, name, split, cache_dir))
        return FakeDataset(_rows(path, name, split), log)

    def concatenate_datasets(parts):
        log.append(("concatenate_datasets", len(parts)))
        return FakeDataset([r for p in parts for r in p.rows], log)

    mod.load_dataset, mod.concatenate_datasets, mod.Audio = (
        load_dataset, concatenate_datasets, FakeAudio)
    mod.log = log
    return mod


def _same_rows(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["audio"]["array"], w["audio"]["array"])
        assert g["audio"]["sampling_rate"] == w["audio"]["sampling_rate"]
        assert {k: v for k, v in g.items() if k != "audio"} == \
            {k: v for k, v in w.items() if k != "audio"}


@pytest.fixture
def hf(monkeypatch):
    mod = fake_datasets()
    monkeypatch.setitem(sys.modules, "datasets", mod)
    return mod


def _logged(hf, fn):
    hf.log.clear()
    out = fn()
    return out, list(hf.log)


@pytest.mark.parametrize("call", [
    ("librispeech", (["train.clean.100"], "")),
    ("librispeech", (["train.clean.100", "train.clean.360", "train.other.500"], "/cache")),
    ("commonvoice", ("train", "")),
    ("commonvoice", ("validation", "/cache")),
], ids=["librispeech-one", "librispeech-three", "commonvoice", "commonvoice-cache"])
def test_loaders_make_jax_calls_and_rows(hf, call):
    corpus, args = call
    want, want_log = _logged(hf, lambda: getattr(jdata, f"{corpus}_dataset")(*args))
    got, got_log = _logged(hf, lambda: getattr(tdata, f"{corpus}_dataset")(*args))
    assert got_log == want_log and want_log
    _same_rows(got, want)
    if corpus == "commonvoice":
        assert all(got[i]["text"] == got[i]["sentence"] for i in range(len(got)))
        assert {got[i]["audio"]["sampling_rate"] for i in range(len(got))} == {16_000}


def test_concatenate_rows_matches_jax():
    parts = [[{"i": i, "p": p} for i in range(n)] for p, n in enumerate((3, 0, 5, 1))]
    want, got = jdata.concatenate_rows(parts), tdata.concatenate_rows(parts)
    assert len(got) == len(want) == 9
    for i in range(-9, 9):
        assert got[i] == want[i]
    for bad in (9, 100):
        with pytest.raises(IndexError):
            got[bad]
        with pytest.raises(IndexError):
            want[bad]
    assert tdata.concatenate_rows([parts[0]]) is parts[0]  # one part passes through
    assert len(tdata.concatenate_rows([])) == len(jdata.concatenate_rows([])) == 0


def _configs(*overrides):
    path = tconfig.resolve_config("base_convjs_fullcausal")
    return (jconfig.apply_overrides(jconfig.load_config(path), list(overrides)),
            tconfig.apply_overrides(tconfig.load_config(path), list(overrides)))


@pytest.mark.parametrize("overrides", [
    [],  # the mixed recipe: librispeech 100/360/500 + "commonvoice:train"
    ["data.dataset=commonvoice", "data.train_splits=[train, 'librispeech:train.clean.100']",
     "data.eval_split=validation", "data.cache_dir=/cache"],
    ["data.eval_on_train=true"],
], ids=["fullcausal-mixed", "commonvoice-prefixed", "eval-on-train"])
def test_load_datasets_matches_jax(hf, overrides):
    jcfg, tcfg = _configs(*overrides)
    (jtrain, jeval), want_log = _logged(hf, lambda: jloop._load_datasets(jcfg))
    (ttrain, teval), got_log = _logged(hf, lambda: tloop._load_datasets(tcfg))
    assert got_log == want_log
    _same_rows(ttrain, jtrain)
    _same_rows(teval, jeval)
    assert (teval is ttrain) == (jeval is jtrain)


@pytest.mark.parametrize("overrides,match", [
    (["data.dataset=timit"], "unknown dataset timit"),
    (["data.train_splits=['tedlium:train']"], "unknown corpus prefix 'tedlium'"),
], ids=["dataset", "prefix"])
def test_load_datasets_refusals_match_jax(hf, overrides, match):
    jcfg, tcfg = _configs(*overrides)
    for fn, cfg in ((jloop._load_datasets, jcfg), (tloop._load_datasets, tcfg)):
        with pytest.raises(ValueError, match=match):
            fn(cfg)


# --------------------------- per-rank streamed shards ---------------------------

@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    import json

    path = tmp_path_factory.mktemp("vocab") / "vocab.json"
    path.write_text(json.dumps(tdata.synthetic_piece_table(255)))
    return path


def _tiny(vocab, *extra):
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
            "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
            "training.precision=fp32", "training.global_batch_size=4",
            "training.frame_buckets=[64,96]", "training.token_buckets=[12]",
            "training.eval_max_elements=4", "data.dataset=synthetic",
            "data.synthetic_size=16", "data.synthetic_seconds=0.9",
            "data.synthetic_max_words=6", "data.augment=true",
            "data.augment_device=false", "training.log_steps=1",
            "training.num_epochs=1", *extra]


@pytest.mark.parametrize("data,model,rank,epoch,wire", [
    (2, 1, 0, 0, "int16"), (2, 1, 1, 0, "int16"), (2, 1, 1, 3, "float32"),
    (2, 2, 2, 0, "int16"), (2, 2, 3, 0, "int16"),
], ids=["d0", "d1", "d1-epoch3-f32", "d1m0", "d1m1"])
def test_stream_batches_equal_jax_process_shard(vocab, data, model, rank, epoch, wire):
    """Rank ``rank`` of a data x model mesh streams, with the host recipe
    on, exactly JAX's per-process shard ``rank // model`` of ``data`` at
    ``G / data`` rows a batch."""
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  _tiny(vocab, f"data.wire_dtype={wire}"))
    fspec = tconfig.build_featurizer_spec(cfg)
    buckets = tdata.Buckets.from_frames(cfg.training.frame_buckets,
                                        cfg.training.token_buckets, fspec)
    ds, _ = tloop._load_datasets(cfg)
    got = list(tloop.stream_batches(cfg, ds, tloop._load_tokenizer(cfg), buckets,
                                    taug.default_augmentor(), epoch,
                                    Mesh(data, model, rank=rank)))
    want = list(jdata.BatchIterator(
        ds, JTokenizer.from_vocab_json(vocab), buckets, batch_size=4 // data,
        augmentor=jaug.default_augmentor(), shuffle=True, seed=epoch,
        shard_id=rank // model, num_shards=data, wire_dtype=wire))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["audio"].shape[0] == 4 // data
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_two_ranks_with_uneven_shards_end_the_epoch_together(vocab, tmp_path):
    """The two shards of this corpus yield 2 and 4 batches after bucketing:
    a 2-rank run ends its one epoch after 2 steps on both ranks (no rank
    waits in a collective the other never joins), and each rank augmented
    only rows of its own shard (the whole shard on the rank that ran out)."""
    overrides = _tiny(vocab, "mesh.data=2")
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  overrides)
    fspec = tconfig.build_featurizer_spec(cfg)
    buckets = tdata.Buckets.from_frames(cfg.training.frame_buckets,
                                        cfg.training.token_buckets, fspec)
    ds, _ = tloop._load_datasets(cfg)
    tok = tloop._load_tokenizer(cfg)
    counts = [len(list(tloop.stream_batches(cfg, ds, tok, buckets, taug.default_augmentor(),
                                            0, Mesh(2, 1, rank=d)))) for d in range(2)]
    assert counts == [2, 4]

    results = run_ranks(2, streamed_train_rank, overrides, str(tmp_path))
    order = np.arange(len(ds))
    np.random.RandomState(0).shuffle(order)
    key = {ds[i]["audio"]["array"][:16].tobytes(): i for i in range(len(ds))}
    for r in results:
        rows = [key[k] for k in r["keys"]]
        shard = set(order[r["rank"]::2].tolist())
        assert set(rows) <= shard and len(rows) == len(set(rows))
        if counts[r["rank"]] == min(counts):
            assert set(rows) == shard
        assert np.isfinite(r["wer"])
    import json
    rows = [json.loads(x) for x in
            (tmp_path / "tiny_conv" / "run-1" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "loss/train" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:  # the all-reduced gradient: one norm on both ranks
        assert r["total_norm_by_rank/train"] == [r["total_norm/train"]] * 2
    assert (tmp_path / "tiny_conv" / "run-1" / "checkpoint_step_2").is_dir()
