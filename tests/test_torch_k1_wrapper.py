"""K1's wrapper contract, pinned on the CPU with a fake launcher in place
of the CUDA entry point: the h workspace (shape, dtype, rows of a multiple
of 16 bytes), zero-padding of enc, pred and W only where H or V is not a
multiple of 8, the bias and labels passed as given, outputs of shape
(B, T, U1), one launch counted per call, a lattice too large for 32-bit
row indices refused before anything is allocated, a device that is
neither the CPU nor CUDA refused, and the ctypes signature matching the C
entry point."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.ops import kernels
from rnnt_tpu_torch.ops import transducer_pallas as ttp

_ARGS = ("enc", "pred", "w", "bias", "labels", "h_ws", "lse", "blank_out", "label_out",
         "B", "T", "U1", "Hp", "V", "Vp", "blank", "v0", "act")


@pytest.fixture
def fake_k1(monkeypatch):
    """Replace K1's C function with one that records its arguments (as
    tensors) and writes each output's flat index, times 1, 2 or 3, into it."""
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
        for i, name in enumerate(("lse", "blank_out", "label_out")):
            x = got[name]
            x.copy_((i + 1) * torch.arange(x.numel(), dtype=torch.float32).view(x.shape))
        return 0

    monkeypatch.setattr(torch.cuda, "device", DeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(kernels, "ptr", lambda t: t)
    monkeypatch.setattr(ttp.K1, "_fn", fake_fn)
    # The fake launches count; the counter is restored after the test so
    # that no later test in the process sees them.
    monkeypatch.setattr(ttp.K1, "launches", ttp.K1.launches)
    return calls


def _inputs(B, T, U1, H, V):
    rng = np.random.RandomState(0)
    bf = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    labels = torch.from_numpy(rng.randint(0, V - 1, size=(B, U1)).astype(np.int32))
    bias = torch.from_numpy(rng.randn(V).astype(np.float32))
    return [bf(B, T, H), bf(B, U1, H), bf(H, V), bias, labels, V - 1]


@pytest.mark.parametrize("shape,padded", [
    ((2, 3, 4, 16, 24), ()),                      # the configs' case: no copy
    ((2, 3, 4, 12, 24), ("enc", "pred", "w")),    # H % 8 != 0
    ((1, 2, 5, 16, 21), ("w",)),                  # V % 8 != 0
    ((2, 3, 4, 20, 37), ("enc", "pred", "w")),    # both
])
def test_k1_wrapper_layout(fake_k1, shape, padded):
    B, T, U1, H, V = shape
    args = _inputs(*shape)
    Hp, Vp = -(-H // 8) * 8, -(-V // 8) * 8
    before = ttp.K1.launches
    lse, blank_logit, label_logit = ttp._joint_forward_kernel(*args)
    assert ttp.K1.launches == before + 1
    (got,) = fake_k1
    ws = got["h_ws"]
    assert ws.dtype == torch.bfloat16 and tuple(ws.shape) == (B * T * U1, Hp)
    assert ws.is_contiguous() and ws.stride(0) * ws.element_size() % 16 == 0
    assert (got["B"], got["T"], got["U1"], got["Hp"], got["V"], got["Vp"]) == (
        B, T, U1, Hp, V, Vp)
    assert got["blank"] == V - 1 and got["v0"] == 0
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
    # The bias keeps its V entries (the kernel reads it only below V).
    assert got["bias"] is args[3] and got["labels"] is args[4]
    for i, (out, name) in enumerate(((lse, "lse"), (blank_logit, "blank_out"),
                                     (label_logit, "label_out"))):
        assert out is got[name]
        assert out.dtype == torch.float32 and tuple(out.shape) == (B, T, U1)
        assert torch.equal(out.view(-1), (i + 1) * torch.arange(B * T * U1, dtype=torch.float32))


def test_k1_wrapper_refuses_rows_past_32_bits(fake_k1, monkeypatch):
    """B*T*U1 at the limit: refused with a clear error before the (4 GB)
    h workspace is allocated or anything launched."""
    T = U1 = 1 << 14
    args = _inputs(1, 1, 1, 8, 16)
    args[0] = torch.zeros((1, T, 8), dtype=torch.bfloat16)
    args[1] = torch.zeros((1, U1, 8), dtype=torch.bfloat16)
    args[4] = torch.zeros((1, U1), dtype=torch.int32)
    assert T * U1 == ttp.MAX_ROWS

    def no_alloc(*a, **k):
        raise AssertionError("allocated before the row check")

    monkeypatch.setattr(torch, "empty", no_alloc)
    before = ttp.K1.launches
    with pytest.raises(ValueError, match="32-bit row indices"):
        ttp._joint_forward_kernel(*args)
    assert ttp.K1.launches == before and not fake_k1


def test_k1_wrapper_refuses_other_devices():
    args = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in _inputs(1, 2, 3, 8, 8)]
    before = ttp.K1.launches
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ttp.fused_joint_forward(*args)
    assert ttp.K1.launches == before


def test_k1_entry_point_signature():
    """The ctypes signature matches the C entry point in csrc/joint_fwd.cu:
    9 pointers, B, T, U1, Hp, V, Vp, blank, v0 and act as ints, the stream."""
    assert ttp.K1.argtypes == [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    src = (Path(ttp.__file__).resolve().parents[1] / "csrc" / "joint_fwd.cu").read_text()
    params = re.search(r'extern "C" int rnnt_joint_fwd\(([^)]*)\)', src).group(1).split(",")
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names == list(_ARGS) + ["stream"]
    kinds = ["int" if p.split()[0] == "int" else "ptr" for p in params]
    assert kinds == ["ptr"] * 9 + ["int"] * 9 + ["ptr"]
