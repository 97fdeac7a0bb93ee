#!/usr/bin/env python3
"""Variant trees of K1 (``rnnt_tpu_torch/csrc/joint_fwd.cu`` with its
headers) for measuring its design on the card.

    python3 scripts/k1_tile_variants.py build/k1_variants         # write them
    python3 chip_smoke.py --parent-joint build/k1_variants/bn128_ctas2
    python3 scripts/k1_tile_variants.py --time build/k1_variants  # on a card

Each variant is a directory ``OUT/<name>`` holding an edited joint_fwd.cu
and copies of the headers.  Tile variants change only the lse pass's tile
width (BN), ring depth (STAGES) or blocks an SM (CTAS) and compute the same
function: ``chip_smoke.py --parent-joint DIR`` checks them against the
plain version and times them in turns with this tree's K1.  Diagnostic
variants (``diag_*``) cut a piece of the lse pass's epilogue to show what
it costs; their outputs are wrong and they are only timed.  ``--time``
builds every variant under OUT and prints, per variant, ``burst_ms`` of
its C entry point in turns with this tree's (other, this, this, other) at
the eval and banded shapes, and the device ms of its kernels.
"""

from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "rnnt_tpu_torch" / "csrc"

# name: the LsePass constants it sets.  bn128_ctas2: two blocks an SM on
# 128-wide V tiles (the register file holds two blocks' 64-float
# accumulators, not two of 128), 3 stages each, as K2's dl pass runs.
# stages3: a shallower ring.
TILE_VARIANTS = {
    "bn128_ctas2": dict(BN=128, STAGES=3, CTAS=2),
    "stages3": dict(STAGES=3),
}

# name: (text in reg_epilogue, its replacement).
_EPI = "                                                      int tid) {\n"
DIAG_VARIANTS = {
    # The mainloop and the V walk alone: the epilogue keeps two values live.
    "diag_no_epilogue": (_EPI, _EPI + "    if (p.blank >= 0) {\n"
                         "      st.s[0] += acc[0] + acc[BN / 2 - 1];\n      return;\n    }\n"),
    # Without catching the blank and label logits.
    "diag_no_catch": ("      if (j == jb) {", "      if (false) {"),
    # The h pass without tanh (bf16(enc + pred)): its memory-bound floor.
    "diag_h_no_tanh": ("  return __float2bfloat16(tanhf(s));", "  return __float2bfloat16(s);"),
    # Without the exps (the sum of the logits instead).
    "diag_no_exp": ("      s0 += exp2f(fmaf(acc[4 * j], LOG2E, n0)) + exp2f(fmaf(acc[4 * j + 1], "
                    "LOG2E, n0));\n      s1 += exp2f(fmaf(acc[4 * j + 2], LOG2E, n1)) + "
                    "exp2f(fmaf(acc[4 * j + 3], LOG2E, n1));",
                    "      s0 += acc[4 * j] + acc[4 * j + 1];\n"
                    "      s1 += acc[4 * j + 2] + acc[4 * j + 3];"),
}


# name: (text in joint_fwd.cu, its replacement), computing the same function.
_EX2 = ("__device__ __forceinline__ float ex2_ftz(float x) {\n  float y;\n"
        "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;\n}\n\n")
EDIT_VARIANTS = {
    # The epilogue's exps as one MUFU.EX2 each (terms below 2^-126 flush
    # to 0; exp2f also scales around the subnormal range).
    "ex2_ftz": ("struct LsePass {", _EX2 + "struct LsePass {"),
}


def _write(out: Path, text: str) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    (out / "joint_fwd.cu").write_text(text)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    return out


def write_tile_variant(out: Path, consts: dict[str, int]) -> Path:
    src = (CSRC / "joint_fwd.cu").read_text()
    at = src.index("struct LsePass {")
    body = src[at:]
    for name, value in consts.items():
        pat = rf"(static constexpr int {name} = )\d+;"
        if re.search(pat, body) is None:
            raise ValueError(f"LsePass has no constant {name}")
        body = re.sub(pat, rf"\g<1>{value};", body, count=1)
    return _write(out, src[:at] + body)


def write_diag_variant(out: Path, old: str, new: str) -> Path:
    """A copy of the tree with ``old`` replaced by ``new`` in the one file
    (joint_fwd.cu or a header) that holds it once."""
    _write(out, (CSRC / "joint_fwd.cu").read_text())
    hits = [f for f in sorted(out.iterdir()) if f.read_text().count(old) == 1]
    if len(hits) != 1:
        raise ValueError(f"{out.name}: the text to cut is not in exactly one source once")
    hits[0].write_text(hits[0].read_text().replace(old, new))
    return out


def write_all(root: Path) -> list[Path]:
    dirs = [write_tile_variant(root / n, c) for n, c in TILE_VARIANTS.items()]
    for n, (old, new) in EDIT_VARIANTS.items():
        d = write_diag_variant(root / n, old, new)
        if n == "ex2_ftz":
            text = (d / "joint_fwd.cu").read_text()
            at = text.index("struct LsePass {")
            (d / "joint_fwd.cu").write_text(text[:at] + text[at:].replace("exp2f(", "ex2_ftz("))
        dirs.append(d)
    return dirs + [write_diag_variant(root / n, *edit) for n, edit in DIAG_VARIANTS.items()]


def time_all(root: Path) -> None:
    import subprocess

    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = sorted(d for d in root.iterdir() if (d / "joint_fwd.cu").exists())
    fns = cs.build_joint_fwd_trees(dirs)
    device = torch.device("cuda")
    for tag, dims in (("eval", cs.EVAL_SHAPE), ("banded", cs.BANDED_SHAPE)):
        inputs = cs.k1_inputs(**dims, device=device)
        n = dims["B"] * dims["T"] * dims["U1"]
        outs = [torch.empty((dims["B"], dims["T"], dims["U1"]), device=device) for _ in range(3)]
        h_ws = torch.empty((n, dims["H"]), dtype=torch.bfloat16, device=device)
        runs = {who: cs.joint_fwd_call(fn, arity, inputs, h_ws, outs) for who, arity, fn in fns}
        for who, _, _ in fns:
            by_kernel = ", ".join(f"{k} {v:.4f}"
                                  for k, v in cs.device_ms_by_kernel(runs[who]).items())
            if who == "this":
                print(f"{tag} this tree: device ms {by_kernel}", flush=True)
                continue
            times = [cs.burst_ms(runs[w]) for w in (who, "this", "this", who)]
            print(f"{tag} {Path(who).name}: burst ms (other, this, this, other) "
                  + ", ".join(f"{t:.4f}" for t in times) + f"; device ms {by_kernel}",
                  flush=True)


def main(argv: list[str]) -> None:
    if len(argv) == 2 and argv[0] == "--time":
        return time_all(Path(argv[1]))
    if len(argv) != 1:
        sys.exit("usage: k1_tile_variants.py [--time] OUT_DIR")
    for d in write_all(Path(argv[0])):
        print(d)


if __name__ == "__main__":
    main(sys.argv[1:])
