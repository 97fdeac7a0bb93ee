"""Build and load the hand-written CUDA kernels in ``rnnt_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
for ``sm_90a`` into its own shared library under the repository's
``build/`` directory, then loaded with ctypes.  A library's file name
carries a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused.  ``build_all`` starts one nvcc per source at
once.  Nothing is built when a module is imported: the first launch (or
``build_all``) builds.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0.  A launch runs on the device its tensors
lie on (that device made current, its current stream), so a rank whose
card is ``cuda:1`` launches there, whatever device is current.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from rnnt_tpu_torch.train.profiling import span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rnnt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


KERNELS: list["CudaKernel"] = []  # every kernel defined, in import order


def launch_counts() -> dict[str, int]:
    """{kernel name: launches so far} of every kernel defined."""
    return {k.name: k.launches for k in KERNELS}


class CudaKernel:
    """One csrc source, its C entry point and the launch count of its
    wrapper (the wrapper adds one per launch; callers reset it to 0)."""

    def __init__(self, name: str, symbol: str, argtypes: list, *,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.source = CSRC / f"{name}.cu"
        self.launches = 0
        self.build_log = ""
        self._fn = None
        KERNELS.append(self)

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # the sources' shared headers
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _command(self, out: Path) -> list[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def fn(self):
        """The ctypes function, building the library first if needed."""
        if self._fn is None:
            self._fn = self.entry(self.symbol, self.argtypes)
        return self._fn

    def entry(self, symbol: str, argtypes: list):
        """The C entry point ``symbol`` of this kernel's library (built first
        if needed), returning int.  Calls through it are not counted."""
        build_all([self])
        fn = getattr(ctypes.CDLL(str(self.library_path())), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point with ``args`` (tensors become their data
        pointers; every tensor must lie on one CUDA device) on that
        device's current stream, with that device current, inside a
        ``launch <name>`` span (``train/profiling.py``); raise on a CUDA
        error; count the launch."""
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) != 1:
            raise ValueError(f"{self.name}: tensors on {sorted(map(str, devices))}, "
                             "expected one CUDA device")
        (dev,) = devices
        c_args = [ptr(a) if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(dev), span(f"launch {self.name}"):
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
            err = self.fn()(*c_args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


def build_all(kernels) -> float:
    """Compile every kernel whose library is missing, one nvcc per source,
    all started together.  Returns the wall seconds; raises with nvcc's
    output when one fails."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(k._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((k, proc, tmp, out))
    failed = []
    for k, proc, tmp, out in jobs:
        k.build_log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{k.name}:\n{k.build_log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.time() - t0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype and
    shape on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
