"""The port's T-sharded lattice (ops/lattice_tshard.py, the plain versions
of K6 and K7) against rnnt_tpu's, on the CPU.

* ``alpha_chain_plain`` / ``beta_chain_plain`` on one shard (the middle
  one with a carry in, the first and the last with a carry in that must
  be ignored, U1 = 1, a shard no t_len reaches), against JAX's
  ``_alpha_chain_pallas`` / ``_beta_chain_pallas`` in interpret mode on
  the same inputs, padded on the JAX side as
  ``lattice_tshard.py:41-50,183-188`` pads them;
* ``transducer_alpha_loss_tsharded`` on n = 2 and 4 gloo ranks against
  JAX's on ``make_mesh(8 // n, n)`` at the shapes of
  tests/test_lattice_tshard.py:32-61, and the data x model case of
  ``:64-91`` on a (data 2, model 2) group, with that file's tolerances;
* ``make_loss_fn`` with ``lattice_shard_t`` on a (data 2, model 2) group
  against JAX's loss at ``:94-137`` within 1e-5.

Multi-rank cases run in spawned processes (tests/torch_ranks.py), each
with its own timeout.  The chain stages are compared in float32, the
precision of the reference's kernels; the T-sharded loss runs the port's
lattice in float64 (as the CPU autograd path does) against JAX's float32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.ops.lattice_pallas import (  # noqa: E402
    _alpha_chain_pallas, _beta_chain_pallas, _pad_lattice)
from rnnt_tpu.ops.lattice_tshard import transducer_alpha_loss_tsharded as jax_tsharded  # noqa: E402
from rnnt_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rnnt_tpu_torch.ops import lattice_pallas as tlat  # noqa: E402
from rnnt_tpu_torch.ops.transducer import NEG  # noqa: E402
from torch_ranks import loss_fn_rank, run_ranks, tsharded_loss_rank  # noqa: E402

CHAIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(B, T, U1, seed=0):
    """tests/test_lattice_tshard.py's ``_problem``, in numpy."""
    rng = np.random.RandomState(seed)
    lpb = np.log(rng.uniform(0.2, 0.8, (B, T, U1))).astype(np.float32)
    lpl = np.log(rng.uniform(0.1, 0.6, (B, T, U1))).astype(np.float32)
    t_lens = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    u_lens = rng.randint(1, U1, (B,)).astype(np.int32)
    return lpb, lpl, t_lens, u_lens


def _jax_pad(x, B, Up, value):
    """(B, ...) -> (8, ..., Up) in JAX: batch to one B_TILE, U to 128."""
    pad = [(0, 8 - B)] + [(0, 0)] * (x.ndim - 2) + [(0, Up - x.shape[-1])]
    return jnp.pad(jnp.asarray(x), pad, constant_values=value)


# (U1, shard, t_lens, junk): shard s of a 3-shard lattice of 128-row shards
# (T_CHUNK) held against JAX.  junk: the stage under test takes a random
# carry_in that it must not read (K6 at t0 = 0 seeds row 0; K7 on the last
# shard seeds every sample that reaches it), in place of the chain's.
CHAIN_STAGE_CASES = {
    "middle": (9, 1, [200, 256, 100, 384], False),
    "first": (9, 0, [200, 256, 100, 384], True),
    "last": (9, 2, [200, 256, 100, 384], True),
    "u1-1": (1, 1, [200, 256, 100, 384], False),
    "unreached": (9, 2, [200, 256, 100, 129], False),
}


@pytest.mark.parametrize("case", list(CHAIN_STAGE_CASES))
def test_chain_stages_match_jax_chain_kernels(case):
    """One shard (T_CHUNK rows at t0 = 128 s) of a 3-shard lattice: t_lens
    end inside it, at its last row, before it and after it ("middle"); the
    first and last shards with a carry in that must be ignored; U1 = 1;
    a shard that no sample's t_len reaches.  The carries in are the
    stages' own on the neighbouring shards."""
    U1, shard, t_lens, junk = CHAIN_STAGE_CASES[case]
    B, rows = 4, 128
    t0 = shard * rows
    lpb, lpl, _, u_lens = _problem(B, 3 * rows, max(U1, 2), seed=4)
    lpb, lpl, u_lens = lpb[..., :U1], lpl[..., :U1], np.minimum(u_lens, U1 - 1)
    lpl = np.where(np.arange(U1)[None, None, :] < u_lens[:, None, None], lpl, NEG)
    lpl = lpl.astype(np.float32)
    t_lens = np.array(t_lens, np.int32)
    tt = [torch.from_numpy(x) for x in (lpb, lpl, t_lens, u_lens)]
    blocks = [(s * rows, tt[0][:, s * rows:(s + 1) * rows], tt[1][:, s * rows:(s + 1) * rows])
              for s in range(3)]  # float32, as the reference's kernels compute
    neg = torch.full((B, U1), NEG)
    carries_a, alphas, ll = [neg], [], 0.0
    for s0, b, l in blocks:
        a, part, carry = tlat.alpha_chain_plain(b, l, tt[2], tt[3], s0, carries_a[-1])
        alphas.append(a)
        ll = ll + part
        carries_a.append(carry)
    g = torch.tensor([1.0, 0.5, 2.0, 1.5])
    carries_b = [neg]
    for s in (2, 1):
        s0, b, l = blocks[s]
        carries_b.append(tlat.beta_chain_plain(b, l, alphas[s], tt[2], tt[3], ll, g, s0,
                                               carries_b[-1])[2])
    carry_a, carry_b = carries_a[shard], carries_b[2 - shard]
    if junk:
        rnd = torch.from_numpy(np.random.RandomState(7).randn(B, U1).astype(np.float32))
        carry_a, carry_b = (rnd, carry_b) if shard == 0 else (carry_a, rnd)
    _, b, l = blocks[shard]
    alphas, ll1, carry_out = tlat.alpha_chain_plain(b, l, tt[2], tt[3], t0, carry_a)
    glpb, glpl, beta_out = tlat.beta_chain_plain(b, l, alphas, tt[2], tt[3], ll, g, t0, carry_b)

    # JAX: the same shard, padded to (8, 128, 128) as the reference's chain pads.
    jb, jl = _pad_lattice(jnp.asarray(lpb[:, t0:t0 + rows]), jnp.asarray(lpl[:, t0:t0 + rows]))
    jb, jl = (jnp.pad(x, ((0, 8 - B), (0, 0), (0, 0))) for x in (jb, jl))
    Up = jb.shape[2]

    def lens(x, fill):
        return jnp.broadcast_to(jnp.pad(jnp.asarray(x), (0, 8 - B), constant_values=fill)
                                [:, None], (8, Up))

    tl, ul, t0_b = lens(t_lens, 1), lens(u_lens, 0), jnp.full((8, Up), t0, jnp.int32)
    ja, jllm, jcarry = _alpha_chain_pallas(
        jb, jl, tl, ul, t0_b, _jax_pad(carry_a.numpy(), B, Up, NEG))
    jgb, jgl, jbeta = _beta_chain_pallas(
        jb, jl, ja, tl, ul, lens(ll.numpy(), 0.0), lens(g.numpy(), 0.0), t0_b,
        _jax_pad(carry_b.numpy(), B, Up, NEG))

    live = np.asarray(ja)[:B, :, :U1] > NEG / 2
    np.testing.assert_allclose(alphas.numpy()[live], np.asarray(ja)[:B, :, :U1][live],
                               **CHAIN_TOL)
    np.testing.assert_allclose(ll1.numpy(), np.asarray(jllm).sum(axis=1)[:B], **CHAIN_TOL)
    np.testing.assert_allclose(carry_out.numpy(), np.asarray(jcarry)[:B, :U1], **CHAIN_TOL)
    np.testing.assert_allclose(glpb.numpy(), np.asarray(jgb)[:B, :, :U1], **CHAIN_TOL)
    np.testing.assert_allclose(glpl.numpy(), np.asarray(jgl)[:B, :, :U1], **CHAIN_TOL)
    # Beta at the shard's first row, for the samples whose t_len passes t0
    # (for the others the reference carries a row no path reaches; the port
    # passes NEG).
    on = t_lens > t0
    np.testing.assert_allclose(beta_out.numpy()[on], np.asarray(jbeta)[:B, :U1][on],
                               **CHAIN_TOL)
    assert (beta_out.numpy()[~on] == np.float32(NEG)).all()
    # ll parts: the samples whose row t_len - 1 the shard holds, 0 for the others.
    held = (t_lens - 1 >= t0) & (t_lens - 1 < t0 + rows)
    assert (ll1.numpy()[~held] == 0).all() and (ll1.numpy()[held] != 0).all()
    if junk:  # the carry in is not read
        ref = (tlat.alpha_chain_plain(b, l, tt[2], tt[3], t0, neg) if shard == 0 else
               tlat.beta_chain_plain(b, l, alphas, tt[2], tt[3], ll, g, t0, neg))
        got = (alphas, ll1, carry_out) if shard == 0 else (glpb, glpl, beta_out)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


def _jax_loss_and_grads(case, mesh, batch_axis=None):
    lpb, lpl, t_lens, u_lens = map(jnp.asarray, case)

    def loss(a, b):
        return jnp.sum(jax_tsharded(a, b, t_lens, u_lens, mesh, batch_axis=batch_axis))

    nll = jax.jit(lambda a, b: jax_tsharded(a, b, t_lens, u_lens, mesh,
                                            batch_axis=batch_axis))(lpb, lpl)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(lpb, lpl)
    return np.asarray(nll), [np.asarray(g) for g in grads]


def _gather(results, B):
    """The ranks' NLLs and gradients assembled: rows from each data rank,
    gradient blocks summed over its model ranks."""
    nll = np.zeros(B)
    grads = None
    for r in results:
        lo, hi = r["rows"]
        nll[lo:hi] = r["nll"]
        if grads is None:
            grads = [np.zeros((B,) + g.shape[1:]) for g in r["grads"]]
        for acc, g in zip(grads, r["grads"]):
            acc[lo:hi] += g
    return nll, grads


@pytest.mark.parametrize("n,T,seed", [(2, 2 * 128 + 37, 0), (4, 2 * 128 + 37, 0),
                                      (2, 150, 3)], ids=["n2", "n4", "n2-T150"])
def test_tsharded_loss_matches_jax(n, T, seed):
    """Every model rank's NLL within 1e-5 of JAX's (the reference test's
    loss tolerance); the ranks' gradient blocks, summed, within its
    gradient tolerance (rtol 1e-4, atol 1e-5) of JAX's T-sharded gradient."""
    case = _problem(2, T, 9 if T > 200 else 7, seed)
    want_nll, want_grads = _jax_loss_and_grads(case, jax_make_mesh(data=8 // n, model=n))
    results = run_ranks(n, tsharded_loss_rank, 1, n, *case)
    assert [r["place"] for r in results] == [(0, m) for m in range(n)]
    for r in results:
        np.testing.assert_allclose(r["nll"], want_nll, rtol=1e-5, atol=1e-5)
    _, grads = _gather(results, 2)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_tsharded_composes_with_data_parallel():
    """tests/test_lattice_tshard.py:64-91: B over a data axis, T over a
    model axis; here (data 2, model 2) against JAX's (2, 4) with
    ``batch_axis="data"``, at that test's tolerances."""
    case = _problem(4, 300, 6, seed=7)
    want_nll, want_grads = _jax_loss_and_grads(case, jax_make_mesh(data=2, model=4),
                                               batch_axis="data")
    results = run_ranks(4, tsharded_loss_rank, 2, 2, *case)
    assert [r["place"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    nll, grads = _gather(results, 4)
    np.testing.assert_allclose(nll, want_nll, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4)


def test_make_loss_fn_lattice_shard_t_matches_jax():
    """tests/test_lattice_tshard.py:94-137's model and batch: the port's
    ``make_loss_fn`` with ``lattice_shard_t`` on a (data 2, model 2) group
    (each data rank scores its 2 rows; the global loss is their mean)
    against JAX's loss on the same weights, within 1e-5."""
    from rnnt_tpu.config.config import Config as JConfig
    from rnnt_tpu.config.config import build_featurizer_spec as jfspec
    from rnnt_tpu.config.config import build_model_spec as jspec
    from rnnt_tpu.models.rnnt import rnnt_init as jrnnt_init
    from rnnt_tpu.train.step import make_loss_fn as jmake_loss_fn
    from rnnt_tpu_torch.compat.jax_params import from_jax
    from rnnt_tpu_torch.config import config as tconfig

    def shrink(cfg):
        cfg.encoder.blocks = []
        cfg.encoder.epilogue_features = 32
        cfg.encoder.output_features = 64
        cfg.predictor.output_dim = 64
        cfg.predictor.symbol_embedding_dim = 32
        cfg.predictor.dropout = 0.0
        cfg.joint.hidden_features = 64
        cfg.training.precision = "fp32"
        cfg.training.loss_impl = "chunked"
        return cfg

    jcfg, tcfg = shrink(JConfig()), shrink(tconfig.Config())
    rng = np.random.RandomState(0)
    B = 4
    batch = {"audio": (rng.randn(B, 16000) * 0.1).astype(np.float32),
             "audio_lens": np.array([16000, 12000, 9000, 15000], np.int32),
             "targets": rng.randint(0, 100, (B, 8)).astype(np.int32),
             "target_lens": np.array([8, 5, 3, 7], np.int32)}
    spec = jspec(jcfg)
    params, state = jax.tree.map(np.asarray, jrnnt_init(jax.random.PRNGKey(0), spec))
    want = float(jax.jit(lambda p: jmake_loss_fn(spec, jfspec(jcfg), "fp32")(
        p, state, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)[0])(params))

    tcfg.training.lattice_shard_t = True
    model = from_jax(params, state, tconfig.build_model_spec(tcfg))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    results = run_ranks(4, loss_fn_rank, 2, 2, tcfg, sd, batch)
    by_place = {r["place"]: r["loss"] for r in results}
    for d in (0, 1):  # the model ranks of a data row share the loss
        assert by_place[(d, 0)] == pytest.approx(by_place[(d, 1)], rel=1e-12)
    np.testing.assert_allclose((by_place[(0, 0)] + by_place[(1, 0)]) / 2, want,
                               rtol=1e-5, atol=1e-5)
