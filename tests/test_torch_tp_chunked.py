"""The chunked loss on a vocabulary-sharded joint, on 2 gloo ranks.

* ``joint_lattice_log_probs`` / ``transducer_loss`` with ``joint.out`` cut
  to V / 2 a rank (``parallel/partition.chunked_joint_log_probs_tp``)
  against JAX's ``transducer_loss`` and its chunk body
  ``_joint_chunk_log_probs`` on the whole W, from one numpy seed: V = 48
  split 24 / 24, the blank on the second slice, labels on both, label 0
  in every last column, T = 11 frames in chunks of 4; the lattice
  log-probs within 1e-5, the loss within 1e-5 relative, the gradients in
  audio, text and each rank's slice of W and b within 1e-4 of their
  largest entry, with ``grad_clamp`` off and at 0.01;
* routing: on a sharded joint on the CPU, ``auto`` and the pruned
  warmup's exact part take the chunked joint on the slice, not K1 and
  K2's plain versions, and give the whole model's loss.

Every multi-rank case runs in spawned processes with its own timeout
(tests/torch_ranks.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rnnt_tpu.ops import transducer as jtransducer  # noqa: E402
from torch_ranks import chunked_joint_rank, run_ranks, sharded_loss_route_rank  # noqa: E402

CLAMPS = (-1.0, 0.01)
B, T, U, H, V, CHUNK = 2, 11, 4, 16, 48, 4
BLANK = V - 1


def _arrays():
    rng = np.random.RandomState(11)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    targets = rng.randint(0, V - 1, (B, U)).astype(np.int32)
    targets[0, :2] = (3, 30)   # ids on both slices
    targets[1, :2] = (40, 7)
    return dict(audio=f(B, T, H) * 0.5, text=f(B, U + 1, H) * 0.5, w=f(H, V) / 4,
                b=f(V) * 0.1, targets=targets, t_lens=np.array([T, 8], np.int32),
                u_lens=np.array([U, 2], np.int32))


@pytest.fixture(scope="module")
def chunked_runs():
    a = _arrays()
    ranks = run_ranks(2, chunked_joint_rank, 1, 2, a, BLANK, CHUNK, CLAMPS)
    return a, ranks


def _jax_reference(a, clamp):
    """JAX's lattice log-probs, mean loss and its gradients in audio, text,
    w and b, on the whole joint."""
    joint = {"out": {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}}
    targets_pad = jnp.concatenate([a["targets"], np.zeros((B, 1), np.int32)], axis=1)
    u_mask = jnp.arange(U + 1)[None, :] < a["u_lens"][:, None]
    lpb, lpl = jtransducer._joint_chunk_log_probs(joint, jnp.asarray(a["audio"]),
                                                  jnp.asarray(a["text"]), targets_pad,
                                                  u_mask, BLANK, clamp)

    def loss_fn(audio, text, w, b):
        return jtransducer.transducer_loss(
            {"out": {"w": w, "b": b}}, audio, text, a["targets"], a["t_lens"],
            a["u_lens"], BLANK, chunk_size=CHUNK, grad_clamp=clamp)

    loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a[k]) for k in ("audio", "text", "w", "b")))
    return (np.asarray(lpb), np.asarray(lpl), float(loss),
            [np.asarray(g) for g in grads])


def _close_to_scale(got, want, rtol, name):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("clamp", CLAMPS, ids=["clamp-off", "clamp-0.01"])
def test_chunked_joint_on_v_slices_matches_jax(chunked_runs, clamp):
    a, ranks = chunked_runs
    assert BLANK >= V // 2 and (a["targets"] < V // 2).any() and (a["targets"] >= V // 2).any()
    assert T % CHUNK
    lpb, lpl, loss, (d_audio, d_text, d_w, d_b) = _jax_reference(a, clamp)
    assert sorted(r["model_rank"] for r in ranks) == [0, 1]
    for r in ranks:
        assert r["layout"] == {"joint.out.w": 1, "joint.out.b": 0}
        run = r["runs"][clamp]
        np.testing.assert_allclose(run["lp_blank"], lpb, rtol=0, atol=1e-5)
        np.testing.assert_allclose(run["lp_label"], lpl, rtol=0, atol=1e-5)
        np.testing.assert_allclose(run["loss"], loss, rtol=1e-5)
        cols = slice(r["model_rank"] * V // 2, (r["model_rank"] + 1) * V // 2)
        got_audio, got_text, got_w, got_b = run["grads"]
        assert got_w.shape == (H, V // 2) and got_b.shape == (V // 2,)
        _close_to_scale(got_audio, d_audio, 1e-4, "d audio")
        _close_to_scale(got_text, d_text, 1e-4, "d text")
        _close_to_scale(got_w, d_w[:, cols], 1e-4, "d w slice")
        _close_to_scale(got_b, d_b[cols], 1e-4, "d b slice")


ROUTES = ("auto", "pruned_warmup")


@pytest.fixture(scope="module")
def route_runs():
    from rnnt_tpu_torch.config import config as tconfig

    overrides = ["training.precision=fp32", "predictor.dropout=0.0",
                 "training.loss_chunk_size=8", "tokenizer.spm_model=''"]
    cfg = tconfig.apply_overrides(
        tconfig.load_config(tconfig.resolve_config("tiny_conv")), overrides)
    fspec = tconfig.build_featurizer_spec(cfg)
    rng = np.random.RandomState(2)
    samples = fspec.win_length + (fspec.num_frames(8000) - 1) * fspec.hop_length
    batch = {"audio": rng.randn(2, samples).astype(np.float32) * 0.1,
             "audio_lens": np.full((2,), samples, np.int32),
             "targets": rng.randint(0, 1023, (2, 6)).astype(np.int32),
             "target_lens": np.array([6, 4], np.int32)}
    return run_ranks(2, sharded_loss_route_rank, 1, 2, overrides, ROUTES, batch)


@pytest.mark.parametrize("impl", ROUTES)
def test_sharded_joint_routes_to_chunked_on_cpu(route_runs, impl):
    """Each rank's loss runs the chunked joint on its slice once, K1 and
    K2's plain versions never, no kernel launches, and the sharded loss is
    the whole model's."""
    for r in route_runs:
        run = r[impl]
        assert run["tp_mesh"]
        assert run["calls"] == {"chunked_joint_log_probs_tp": 1}, run["calls"]
        assert set(run["launches"].values()) == {0}, run["launches"]
        np.testing.assert_allclose(run["loss_sharded"], run["loss_whole"], rtol=1e-5)
