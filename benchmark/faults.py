"""Faults planted under the timed path, for the checks that ``correct``
catches them: each ``plant(patch)`` breaks the program through
``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
``setattr`` in a study process that ends after the run)."""

from __future__ import annotations


def unchanged_state(patch):
    """The optimizer applies nothing: the step returns its state unchanged."""
    from rnnt_tpu_torch.train import optim

    patch(optim.AdamWClip, "update", lambda self, params, grads, state, norm=None: state)


def half_batch(patch):
    """Half of each batch left out; the mean is taken over the rest."""
    from rnnt_tpu_torch.data import device_cache

    orig = device_cache.gather_rows
    patch(device_cache, "gather_rows", lambda group, idx: orig(group, idx[: len(idx) // 2]))


FAULTS = {"train": (unchanged_state, half_batch)}
