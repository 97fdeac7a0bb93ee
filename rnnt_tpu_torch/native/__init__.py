"""Native host-side code: the C++ unigram tokenizer and edit distance.

The port's own copy of ``rnnt_tpu/native``: ``tokenizer.cc`` (``rnnt_tok_*``
and ``rnnt_edit_distance``, a plain C interface) is compiled by g++ at
first use into the repository's gitignored ``build/rnnt_tpu_torch/``
(never into the package directory), under a name that carries a hash of
the source and flags, and loaded with ctypes.  As in the JAX package, a
host without a compiler gets None and its callers take their Python
path; ``UnigramTokenizer.native`` says which one a tokenizer took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "tokenizer.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rnnt_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librnnt_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``tokenizer.cc`` unless its library exists; the library is
    written under a temporary name and renamed, so processes building at
    once never load a partial file."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    return out


def load_native():
    """The loaded ctypes library, built if necessary, or None when it
    cannot be built or loaded (``load_error()`` says why)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    lib.rnnt_tok_create.restype = ctypes.c_void_p
    lib.rnnt_tok_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_float]
    lib.rnnt_tok_destroy.argtypes = [ctypes.c_void_p]
    lib.rnnt_tok_encode.restype = ctypes.c_int32
    lib.rnnt_tok_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.rnnt_edit_distance.restype = ctypes.c_int32
    lib.rnnt_edit_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    _lib = lib
    return _lib


def load_error() -> str | None:
    """Why ``load_native`` returned None (None before a failed load)."""
    return _error


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance of two int sequences through
    ``rnnt_edit_distance`` (raises when the library is unavailable)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    a = (ctypes.c_int32 * len(ref))(*ref)
    b = (ctypes.c_int32 * len(hyp))(*hyp)
    return int(lib.rnnt_edit_distance(a, len(ref), b, len(hyp)))
