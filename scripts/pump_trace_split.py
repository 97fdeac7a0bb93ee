#!/usr/bin/env python3
"""Where a streaming pool pump's time goes, from the Chrome trace that
``python3 chip_smoke.py --profile DIR`` writes of five pool pumps
(``DIR/serve_pool_trace.json.gz``).

    python3 scripts/pump_trace_split.py DIR/serve_pool_trace.json.gz

A pump featurizes and runs the streaming encoder (15 convolutions with no
argmax between them: the featurizer's and the encoder's 14), then runs the
greedy loop (two argmaxes and two predictor convolutions an iteration).
For each pump the script prints the host time of the two parts (from the
first encoder convolution to the loop's first argmax, and from there to
the next pump's encoder), their kernel launches (``cudaLaunchKernel``),
the loop's iterations and its synchronising runtime calls, and the device
time of the kernels that ran in each part.  The profiler slows the host
about twofold, so the parts' shares, not their milliseconds, carry over
to an untraced pump.
"""

from __future__ import annotations

import gzip
import json
import sys


def split(path: str) -> list[dict]:
    with gzip.open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted((e["ts"], e["name"]) for e in events if e.get("cat") == "cpu_op"
                 and e["name"] in ("aten::cudnn_convolution", "aten::argmax"))
    launches = [e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]]
    syncs = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
             and ("Synchronize" in e["name"] or "Memcpy" in e["name"])]
    kernels = [(e["ts"], e["dur"]) for e in events if e.get("cat") == "kernel"]
    end = max(e["ts"] + e.get("dur", 0) for e in events if e.get("cat") == "cpu_op")

    runs, i = [], 0  # runs of >= 10 convolutions: the encoders
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j][1] == "aten::cudnn_convolution":
            j += 1
        if j - i >= 10:
            runs.append((i, j))
        i = max(j, i + 1)

    def count(ts, a, b):
        return sum(a <= t < b for t in ts)

    def device_ms(a, b):
        return sum(min(t + d, b) - max(t, a) for t, d in kernels if t < b and t + d > a) / 1e3

    pumps = []
    for k, (i, j) in enumerate(runs):
        t_enc, t_dec = ops[i][0], ops[j][0]
        t_end = ops[runs[k + 1][0]][0] if k + 1 < len(runs) else end
        pumps.append(dict(
            encoder_ms=(t_dec - t_enc) / 1e3, encoder_launches=count(launches, t_enc, t_dec),
            encoder_device_ms=device_ms(t_enc, t_dec),
            decode_ms=(t_end - t_dec) / 1e3, decode_launches=count(launches, t_dec, t_end),
            decode_device_ms=device_ms(t_dec, t_end),
            iterations=sum(1 for t, n in ops if n == "aten::argmax" and t_dec <= t < t_end) // 2,
            decode_sync_calls=count(syncs, t_dec, t_end)))
    return pumps


def main() -> None:
    pumps = split(sys.argv[1])
    for k, p in enumerate(pumps):
        share = p["encoder_ms"] / (p["encoder_ms"] + p["decode_ms"])
        print(f"pump {k}: encoder {p['encoder_ms']:.1f} ms host ({share:.1%}), "
              f"{p['encoder_launches']} launches, {p['encoder_device_ms']:.2f} device ms; "
              f"greedy loop {p['decode_ms']:.1f} ms host, {p['iterations']} iterations, "
              f"{p['decode_launches']} launches, {p['decode_sync_calls']} memcpy/sync calls, "
              f"{p['decode_device_ms']:.2f} device ms")
    print(json.dumps({"pumps": pumps}))


if __name__ == "__main__":
    main()
