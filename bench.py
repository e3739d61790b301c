"""Headline benchmark: one JSON line, local score GCUPS on one GPU.

Workload: a BENCH_LEN x BENCH_LEN (default 100k) related pair (~5%
substitutions, seeded), local (Smith-Waterman) linear score through the
public ``align_score`` -- the reference's core workload class
(benchmark.sh / main.cpp score calls). The engine is whatever the router
picks (engine/route.py). Before timing, the result is checked against the
XLA engine (``engine="xla"``) on a BENCH_CHECK-long prefix.

Timing: one warm-up call, then BENCH_REPS calls, each ended with
``block_until_ready``; the line reports their median and count. Exits
non-zero without a GPU.

    python bench.py
"""
import json
import os
import sys

import numpy as np

from anyseq_tpu.bench.device import (
    NoGPU,
    card_line,
    device_record,
    gpu_devices,
    related_pair,
    timed,
)

MN = int(os.environ.get("BENCH_LEN", 100000))
REPS = int(os.environ.get("BENCH_REPS", 5))
CHECK = int(os.environ.get("BENCH_CHECK", 10000))


def main() -> int:
    try:
        dev = gpu_devices()
    except NoGPU as e:
        print(e, file=sys.stderr)
        return 2
    import anyseq_tpu
    from anyseq_tpu import LinearScoring

    sc = LinearScoring(2, -1, -1)
    q, s = related_pair(np.random.default_rng(0), MN)
    qc, sc_ = q[:CHECK], s[:CHECK]
    parity = (anyseq_tpu.align_score(qc, sc_, "local", sc)
              == anyseq_tpu.align_score(qc, sc_, "local", sc, engine="xla"))
    if not parity:
        print("parity check against the XLA engine failed", file=sys.stderr)
        return 1
    sec, n, score = timed(
        lambda: anyseq_tpu.align_score(q, s, "local", sc), REPS)
    print(json.dumps({
        "metric": f"local score GCUPS ({MN}x{MN})",
        "value": MN * MN / sec / 1e9,
        "unit": "GCUPS",
        "median_s": sec,
        "n": n,
        "score": score,
        "parity": parity,
        "device": device_record(dev),
        "card": card_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
