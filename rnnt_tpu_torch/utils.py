"""Small helpers shared by the port's entry points.

``save_tensor_json`` / ``load_tensor_json`` are the port's copy of the
JAX package's base64 tensor interchange format (``rnnt_tpu/utils.py``):
``{"dtype", "shape", "data"}`` with the raw little-endian bytes in base64,
float32 and int32 only.  The JAX package's ``enable_compilation_cache``
configures XLA's compilation cache and has no counterpart here.
"""

from __future__ import annotations

import base64
import json
from typing import NamedTuple

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is wanted but missing — never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


def uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    """U(-bound, bound) float32 draw on the CPU (the ``*_init`` distribution
    of the JAX package; the numbers differ, the distribution does not)."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class RowGenerator(NamedTuple):
    """A step's generator as one data-parallel rank uses it: every draw is
    made at the global batch's shape and the rank keeps its own rows
    (``start`` onwards), so the ranks together draw what one process draws
    for the whole batch."""
    generator: torch.Generator
    start: int
    global_batch: int


def batch_draw(generator, batch: int, draw):
    """``draw(torch_generator, n)`` — a tensor, or a dict of tensors, with
    ``n`` leading rows — for a batch of ``batch`` rows: directly from a
    ``torch.Generator``; from a ``RowGenerator`` at the global batch,
    sliced to the rank's rows."""
    if not isinstance(generator, RowGenerator):
        return draw(generator, batch)
    out = draw(generator.generator, generator.global_batch)
    rows = slice(generator.start, generator.start + batch)
    return {k: v[rows] for k, v in out.items()} if isinstance(out, dict) else out[rows]


def save_tensor_json(array) -> str:
    """A float32 or int32 array (numpy, or a CPU tensor) as the tensor
    JSON string."""
    arr = np.asarray(array)
    if arr.dtype not in (np.float32, np.int32):
        raise ValueError(f"unsupported dtype {arr.dtype} (float32/int32 only)")
    return json.dumps({
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data": base64.b64encode(arr.tobytes()).decode("utf-8"),
    })


def load_tensor_json(payload: str) -> np.ndarray:
    """The array of a tensor JSON string (a writable copy)."""
    obj = json.loads(payload)
    data = base64.b64decode(obj["data"])
    return np.frombuffer(data, dtype=np.dtype(obj["dtype"])).reshape(
        obj["shape"]).copy()
