"""K2's wrapper contract, pinned on the CPU with a fake launcher in place
of the CUDA entry point: the h and dl workspaces (shape, dtype, rows of a
multiple of 16 bytes), zero-padding of enc, pred and W only where H or V
is not a multiple of 8, outputs cropped back to (H, V), one launch counted
per call, and a device that is neither the CPU nor CUDA refused."""

import ctypes

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.ops import kernels
from rnnt_tpu_torch.ops import transducer_pallas as ttp

_ARGS = ("enc", "pred", "w", "b", "labels", "lse", "g_blank", "g_label", "g_lse",
         "h_ws", "dl_ws", "denc", "dpred", "dw", "db", "B", "T", "U1", "Hp", "V",
         "Vp", "blank", "v0", "grad_clamp")


@pytest.fixture
def fake_k2(monkeypatch):
    """Replace K2's C function with one that records its arguments (as
    tensors) and writes each float32 output's flat index into it."""
    calls = []

    class DeviceGuard:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Stream:
        cuda_stream = 0

    def fake_fn(*args):
        got = dict(zip(_ARGS, args[:-1]))
        calls.append(got)
        for name in ("denc", "dpred", "dw", "db"):
            x = got[name]
            x.copy_(torch.arange(x.numel(), dtype=torch.float32).view(x.shape))
        return 0

    monkeypatch.setattr(torch.cuda, "device", DeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(kernels, "ptr", lambda t: t)
    monkeypatch.setattr(ttp.K2, "_fn", fake_fn)
    # The fake launches count; the counter is restored after the test so
    # that no later test in the process sees them.
    monkeypatch.setattr(ttp.K2, "launches", ttp.K2.launches)
    return calls


def _inputs(B, T, U1, H, V):
    rng = np.random.RandomState(0)
    bf = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    labels = torch.from_numpy(rng.randint(0, V - 1, size=(B, U1)).astype(np.int32))
    return [bf(B, T, H), bf(B, U1, H), bf(H, V), f32(V), labels, V - 1,
            f32(B, T, U1), f32(B, T, U1), f32(B, T, U1), f32(B, T, U1)]


@pytest.mark.parametrize("shape,padded", [
    ((2, 3, 4, 16, 24), ()),                      # the configs' case: no copy
    ((2, 3, 4, 12, 24), ("enc", "pred", "w")),    # H % 8 != 0
    ((1, 2, 5, 16, 21), ("w",)),                  # V % 8 != 0
    ((2, 3, 4, 20, 37), ("enc", "pred", "w")),    # both
])
def test_k2_wrapper_layout(fake_k2, shape, padded):
    B, T, U1, H, V = shape
    args = _inputs(*shape)
    Hp, Vp = -(-H // 8) * 8, -(-V // 8) * 8
    before = ttp.K2.launches
    denc, dpred, dw, db = ttp._joint_backward_kernel(*args, 0.5)
    assert ttp.K2.launches == before + 1
    (got,) = fake_k2
    n = B * T * U1
    for name, cols in (("h_ws", Hp), ("dl_ws", Vp)):
        ws = got[name]
        assert ws.dtype == torch.bfloat16 and tuple(ws.shape) == (n, cols)
        assert ws.is_contiguous() and ws.stride(0) * ws.element_size() % 16 == 0
    assert (got["B"], got["T"], got["U1"], got["Hp"], got["V"], got["Vp"]) == (
        B, T, U1, Hp, V, Vp)
    assert got["blank"] == V - 1 and got["v0"] == 0
    assert got["grad_clamp"] == pytest.approx(0.5)
    for i, name in enumerate(("enc", "pred", "w")):
        x, src = got[name], args[i]
        if name in padded:
            assert x.data_ptr() != src.data_ptr()
            want = torch.zeros(x.shape, dtype=x.dtype)
            want[tuple(slice(0, s) for s in src.shape)] = src
            assert torch.equal(x, want)
        else:
            assert x is src
    assert tuple(got["enc"].shape) == (B, T, Hp)
    assert tuple(got["pred"].shape) == (B, U1, Hp)
    assert tuple(got["w"].shape) == (Hp, Vp)
    # The outputs are the kernel's buffers cropped back, contiguous.
    for out, full, crop in ((denc, got["denc"], (B, T, H)), (dpred, got["dpred"], (B, U1, H)),
                            (dw, got["dw"], (H, V)), (db, got["db"], (V,))):
        assert full.dtype == torch.float32
        assert tuple(out.shape) == crop and out.is_contiguous()
        assert torch.equal(out, full[tuple(slice(0, s) for s in crop)])
    assert tuple(got["dw"].shape) == (Hp, Vp) and tuple(got["db"].shape) == (V,)


def test_k2_wrapper_refuses_other_devices():
    args = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in _inputs(1, 2, 3, 8, 8)]
    before = ttp.K2.launches
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ttp.fused_joint_backward(*args)
    assert ttp.K2.launches == before


def test_k2_entry_point_signature():
    """The ctypes signature matches the C entry point: 15 pointers, B, T,
    U1, Hp, V, Vp, blank and v0 as ints, the clamp as a float, the stream."""
    assert ttp.K2.argtypes == [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    assert len(_ARGS) == 24
