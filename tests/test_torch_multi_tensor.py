"""The multi-tensor norm and AdamW passes (``ops/multi_tensor.py``) on the
CPU: the launch planner that cuts the leaves into the kernels' launches,
the grouping ``squared_norms`` hands it, and ``make_train_step`` taking the
squared norms once a step and handing their total to the clip.

The planner's cases: one leaf, 0- and 1-element leaves, leaves of sizes
that are not a multiple of 4, more leaves than a launch takes, and the
leaf sets of the benchmark's base_convjs (83 leaves) and
parakeet_rnnt_0.6b (911) read off models built on ``meta``.  Every element
of every leaf must lie in exactly one block, a block's partial slot in its
leaf's (submodule, sharded) group's range, and the launches must stay at
their ceiling: ceil(leaves with elements / cap) a pass.  The kernels
themselves run only on a card (``tests/test_torch_cuda_multi_tensor.py``).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.config import config as tconfig
from rnnt_tpu_torch.data.dataset import synthetic_piece_table
from rnnt_tpu_torch.models.rnnt import RNNT, rnnt_init
from rnnt_tpu_torch.ops import multi_tensor as mt
from rnnt_tpu_torch.parallel import mesh as tmesh
from rnnt_tpu_torch.train import loop as tloop
from rnnt_tpu_torch.train import optim as toptim
from rnnt_tpu_torch.train import step as tstep

REPO = Path(__file__).resolve().parents[1]
PASSES = {"norm": (mt.NORM_CAP, mt.NORM_CHUNK), "update": (mt.UPDATE_CAP, mt.UPDATE_CHUNK)}


def _bench_leaves(name: str) -> list[tuple[str, int]]:
    """(name, elements) of every parameter of the benchmark's configuration
    ``name``, the model built on ``meta``."""
    conf = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config(conf["port_yaml"])),
                                  list(conf.get("overrides", [])))
    with torch.device("meta"):
        model = RNNT(tconfig.build_model_spec(cfg), torch.Generator())
    return [(n, p.numel()) for n, p in model.named_parameters()]


def _synthetic(sizes) -> list[tuple[str, int]]:
    subs = ("encoder", "predictor", "joint")
    return [(f"{subs[i % 3]}.l{i}.w", n) for i, n in enumerate(sizes)]


LEAF_SETS = {
    "one_leaf": lambda: _synthetic([1000]),
    "empty_and_single": lambda: _synthetic([0, 1, 0, 1, 5, 0]),
    "ragged": lambda: _synthetic([3, 7, 4097, 16385, 8191, 2, 8193, 16383]),
    "over_a_launch": lambda: _synthetic([1 + i % 5 for i in range(2500)]),
    "base_convjs": lambda: _bench_leaves("base_convjs"),
    "parakeet_rnnt_0.6b": lambda: _bench_leaves("parakeet_rnnt_0.6b"),
}
LEAF_COUNTS = {"base_convjs": 83, "parakeet_rnnt_0.6b": 911}


def _sharded(names) -> dict:
    """A layout marking every third leaf sharded."""
    return {n: 0 for i, n in enumerate(names) if i % 3 == 1}


def _block_map(la, chunk):
    """(leaf, first element, end, partial slot or None) of each block of the
    launch ``la``, as the kernels map ``blockIdx.x``: the leaf is the last j
    with ``blk[j] <= b``."""
    b = np.arange(int(la.blk[-1]))
    j = np.searchsorted(la.blk, b, side="right") - 1
    start = (b - la.blk[j]).astype(np.int64) * chunk
    slot = None if la.out is None else la.out[j] + b - la.blk[j]
    return la.leaves[j], start, np.minimum(start + chunk, la.n[j]), slot


def _blocks(plan):
    """(leaf, start, stop, slot) of every block of every launch, in order."""
    rows = []
    for la in plan.launches:
        leaf, start, stop, slot = _block_map(la, plan.chunk)
        rows.append(np.stack([leaf, start, stop, leaf * 0 - 1 if slot is None else slot], 1))
    return np.concatenate(rows) if rows else np.zeros((0, 4), dtype=np.int64)


@pytest.mark.parametrize("which", list(PASSES))
@pytest.mark.parametrize("leaf_set", list(LEAF_SETS))
def test_plan_covers_every_element_once(leaf_set, which):
    leaves = LEAF_SETS[leaf_set]()
    if leaf_set in LEAF_COUNTS:
        assert len(leaves) == LEAF_COUNTS[leaf_set]
    names, sizes = zip(*leaves)
    cap, chunk = PASSES[which]
    subs, groups = tmesh.norm_groups(names, _sharded(names))
    plan = (mt.plan_launches(sizes, cap, chunk, tuple(groups), 2 * len(subs))
            if which == "norm" else mt.plan_launches(sizes, cap, chunk))
    live = [i for i, n in enumerate(sizes) if n > 0]
    assert len(plan.launches) == math.ceil(len(live) / cap)
    for la in plan.launches:
        assert 1 <= len(la.leaves) <= cap and la.blk[0] == 0
        assert (np.diff(la.blk) >= 1).all()
    blocks = _blocks(plan)
    assert len(blocks) == plan.blocks == sum(-(-n // chunk) for n in sizes)
    # Each live leaf's blocks tile [0, n) in chunks, in order; empty leaves have none.
    b = blocks[np.lexsort((blocks[:, 1], blocks[:, 0]))]
    leaf, start, stop = b[:, 0], b[:, 1], b[:, 2]
    assert sorted(set(leaf.tolist())) == live
    for i in live:
        mine = leaf == i
        n = sizes[i]
        assert (start[mine] == np.arange(0, n, chunk)).all()
        assert (stop[mine] == np.minimum(np.arange(0, n, chunk) + chunk, n)).all()
    if sum(sizes) <= 10 ** 6:  # element by element
        seen = [np.zeros(n, dtype=np.int64) for n in sizes]
        for i, s, e in zip(leaf, start, stop):
            seen[i][s:e] += 1
        assert all((x == 1).all() for x in seen)
    if which == "norm":
        # A block's partial slot: one per block, inside its leaf's group.
        assert sorted(blocks[:, 3].tolist()) == list(range(plan.blocks))
        gs = plan.group_start
        for i, s in zip(blocks[:, 0], blocks[:, 3]):
            sub, sharded = names[i].split(".")[0], i % 3 == 1
            g = subs.index(sub) + (len(subs) if sharded else 0)
            assert groups[i] == g and gs[g] <= s < gs[g + 1]


def test_launch_ceiling_at_parakeet():
    """Both passes over parakeet_rnnt_0.6b's 911 leaves: 1 norm launch and 2
    update launches a step, against ~20,000 launches of the per-leaf loops."""
    names, sizes = zip(*_bench_leaves("parakeet_rnnt_0.6b"))
    subs, groups = tmesh.norm_groups(names, {})
    norm = mt.plan_launches(sizes, mt.NORM_CAP, mt.NORM_CHUNK, tuple(groups), 2 * len(subs))
    upd = mt.plan_launches(sizes, mt.UPDATE_CAP, mt.UPDATE_CHUNK)
    assert (len(norm.launches), len(upd.launches)) == (1, 2)
    assert len(norm.launches) + len(upd.launches) <= 64


@pytest.mark.parametrize("leaf_set", ["empty_and_single", "ragged", "over_a_launch"])
def test_plan_emulated_norms_match_plain(leaf_set):
    """The norm pass emulated in numpy block by block on the plan (partials
    into their slots, each group's range summed) against the plain loop."""
    names, sizes = zip(*LEAF_SETS[leaf_set]())
    subs, groups = tmesh.norm_groups(names, _sharded(names))
    G = 2 * len(subs)
    rng = np.random.RandomState(0)
    leaves = [rng.randn(n).astype(np.float32) for n in sizes]
    plan = mt.plan_launches(sizes, mt.NORM_CAP, mt.NORM_CHUNK, tuple(groups), G)
    partials = np.full(plan.blocks, np.nan)
    for i, s, e, slot in _blocks(plan):
        partials[slot] = float((leaves[i][s:e].astype(np.float64) ** 2).sum())
    got = [partials[plan.group_start[g]:plan.group_start[g + 1]].sum() for g in range(G)]
    want = mt.sq_norms_plain([torch.from_numpy(x) for x in leaves], groups, G)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)


def test_plan_refuses_bad_groups():
    with pytest.raises(ValueError, match="groups"):
        mt.plan_launches((4, 4), 8, 4, (0, 2), 2)


@pytest.mark.parametrize("which", ["sq_norms", "adamw_update"])
def test_wrappers_refuse_other_devices(which):
    """No fall-back: a tensor neither on the CPU nor on CUDA is refused."""
    t = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        if which == "sq_norms":
            mt.sq_norms([t], [0], 1)
        else:
            h = mt.AdamWHyper(lr=1e-3, bc1=0.1, bc2=0.01, b1=0.9, b2=0.99, eps=1e-8,
                              weight_decay=0.0, max_norm=1.0)
            mt.adamw_update([t], [t], [t], [t], torch.zeros((), device="meta"), h)


def test_squared_norms_match_per_leaf_sums():
    """``squared_norms`` on the CPU: each submodule's replicated and sharded
    sums, bit for bit the per-leaf chain it computed before the pass."""
    rng = np.random.RandomState(1)
    names = ["encoder.a", "encoder.b", "joint.w", "predictor.e", "joint.b"]
    grads = {n: torch.from_numpy(rng.randn(3 + i, 5).astype(np.float32))
             for i, n in enumerate(names)}
    layout = {"encoder.b": 0, "joint.b": 1}
    got = tmesh.squared_norms(grads, layout, None)
    rep, sh = {}, {}
    for n, g in grads.items():
        into = sh if n in layout else rep
        sq = torch.sum(g.float() ** 2)
        sub = n.split(".")[0]
        into[sub] = into[sub] + sq if sub in into else sq
    zero = torch.zeros(())
    assert list(got) == ["encoder", "joint", "predictor"]
    for k in got:
        assert torch.equal(got[k], rep.get(k, zero) + sh.get(k, zero))


# ------------------------- the train step's norms -------------------------

def _overrides(vocab, clip, accumulate):
    return ["tokenizer.spm_model=''", f"tokenizer.vocab_json={vocab}",
            "num_text_tokens=255", "num_total_symbols=256", "blank_idx=255",
            "training.precision=fp32", "training.global_batch_size=2",
            "training.frame_buckets=[96]", "training.token_buckets=[12]",
            "data.dataset=synthetic", "data.synthetic_size=8",
            "data.synthetic_seconds=0.9", "data.synthetic_max_words=6",
            "training.loss_impl=chunked", "training.lr_schedule.warmup_steps=2",
            "data.augment=false", f"training.clip_grad_norm={clip}",
            f"training.accumulate_steps={accumulate}"]


class _TwoPass:
    """The optimizer as the step called it before: the clip's norm computed
    anew from the gradients it is handed."""

    def __init__(self, opt):
        self.opt = opt

    def update(self, params, grads, state, norm=None):
        return self.opt.update(params, grads, state, norm=(None, lambda gs: torch.sqrt(
            sum(tmesh.squared_norms(gs, {}, None).values()))))


@pytest.mark.parametrize("clip,accumulate", [(1e-2, 1), (1e9, 1), (1e-2, 2)],
                         ids=["clip", "no-clip", "accumulate2"])
def test_step_norms_once_and_clip_takes_their_total(tmp_path, monkeypatch, clip, accumulate):
    """3 steps of tiny_conv: ``squared_norms`` runs once a step and the
    clip is handed the ``grad_norm`` metric; the parameters, moments and
    metrics equal bit for bit the steps that computed the clip's norm in a
    second pass (under MultiSteps the clip's norm is the running mean's,
    computed on the applying step)."""
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table(255)))
    cfg = tconfig.apply_overrides(tconfig.load_config(tconfig.resolve_config("tiny_conv")),
                                  _overrides(vocab, clip, accumulate))
    spec, fs = tconfig.build_model_spec(cfg), tconfig.build_featurizer_spec(cfg)
    batches = list(tloop.BatchIterator(
        tloop._load_datasets(cfg)[0], tloop._load_tokenizer(cfg),
        tloop.Buckets.from_frames([96], [12], fs), batch_size=2, shuffle=True, seed=0,
        wire_dtype="int16"))[:3]
    calls, handed = [], []
    real = tstep.squared_norms

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tstep, "squared_norms", counted)
    monkeypatch.setattr(tmesh, "squared_norms", counted)

    def run(wrap):
        opt, _ = toptim.make_optimizer(cfg.training, 10)
        inner = wrap(opt)

        class Spy:
            def update(self, params, grads, state, norm=None):
                handed.append(norm[0])
                return inner.update(params, grads, state, norm=norm)

        step = tstep.make_train_step(spec, fs, Spy(), "fp32")
        model = rnnt_init(spec, seed=0)
        state = tstep.TrainState(model, opt.init(dict(model.named_parameters())))
        metrics, per_step = [], []
        for b in batches:
            calls.clear()
            handed.clear()
            state, m = step(state, tstep.batch_to_device(b, "cpu"), None)
            per_step.append(len(calls))
            if accumulate == 1:
                assert handed[0] is m["grad_norm"]
            metrics.append(m)
        return state, metrics, per_step

    state, metrics, once = run(lambda o: o)
    ref, ref_metrics, twice = run(_TwoPass)
    # MultiSteps applies on its 2nd call: the running mean's norm there.
    assert once == ([1, 1, 1] if accumulate == 1 else [1, 2, 1])
    assert twice == ([2, 2, 2] if accumulate == 1 else [1, 2, 1])
    assert state.opt_state.count == ref.opt_state.count == 3 // accumulate
    for m, r in zip(metrics, ref_metrics):
        assert m.keys() == r.keys() and all(torch.equal(m[k], r[k]) for k in m)
    for (n, a), (_, b) in zip(state.model.named_parameters(), ref.model.named_parameters()):
        assert torch.equal(a, b), n
    for k in state.opt_state.mu:
        assert torch.equal(state.opt_state.mu[k], ref.opt_state.mu[k])
        assert torch.equal(state.opt_state.nu[k], ref.opt_state.nu[k])
    if clip < 1:
        assert all(float(m["grad_norm"]) > clip for m in metrics)
