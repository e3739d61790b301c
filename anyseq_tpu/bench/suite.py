"""Benchmark suite: the reference benchmark.sh workload classes plus the
BASELINE.json configs, on seeded synthetic data (the reference's genome
FASTA files are not part of its checkout), through the public API.

Run on a GPU: python -m anyseq_tpu.bench.suite [--quick] [--json FILE]

Prints one JSON line per config -- median seconds over n timed calls after
one warm-up, each ended with ``block_until_ready`` -- then a summary line
with the device and the card. Each construction config is checked (its
score against ``align_score``) before it is timed. Exits non-zero without
a GPU.
"""
from __future__ import annotations

import argparse
import json
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


def run(quick=False, out=sys.stdout):
    dev = gpu_devices()
    import anyseq_tpu
    from anyseq_tpu.core.types import AffineScoring, LinearScoring
    from anyseq_tpu.dist import mesh as meshlib
    from anyseq_tpu.dist.sharded import score_pair_sharded

    sc = LinearScoring(2, -1, -1)
    aff = AffineScoring(2, -1, -3, -1)
    rng = np.random.default_rng(0)
    results = []

    def emit(name, fn, cells, reps=3):
        sec, n, _ = timed(fn, reps)
        rec = {"config": name, "median_s": sec, "n": n,
               "gcups": cells / sec / 1e9}
        results.append(rec)
        print(json.dumps(rec), file=out, flush=True)

    def construct(q, s, mode, scoring, traceback):
        aln = anyseq_tpu.align(q, s, mode, scoring, traceback=traceback)
        want = anyseq_tpu.align_score(q, s, mode, scoring)
        if aln.score != want:
            raise RuntimeError(f"{mode} {traceback} construction scored "
                               f"{aln.score}, align_score {want}")
        return lambda: anyseq_tpu.align(q, s, mode, scoring,
                                        traceback=traceback)

    # 1: ~1k bp global score-only
    q, s = related_pair(rng, 1000)
    emit("global score 1k",
         lambda: anyseq_tpu.align_score(q, s, "global", sc), 1000 * 1000)

    # 1b: local score at 10k, linear and affine
    n1 = 2000 if quick else 10000
    q, s = related_pair(rng, n1)
    emit(f"local score {n1 // 1000}k",
         lambda: anyseq_tpu.align_score(q, s, "local", sc), n1 * n1)
    emit(f"affine local score {n1 // 1000}k",
         lambda: anyseq_tpu.align_score(q, s, "local", aff), n1 * n1)

    # 2: local full-matrix traceback
    n2 = 2000 if quick else 10000
    q, s = related_pair(rng, n2)
    emit(f"local fulltb {n2 // 1000}k", construct(q, s, "local", sc, "full"),
         n2 * n2, reps=1)

    # 3: semiglobal Hirschberg construction
    n3 = 5000 if quick else 100000
    q, s = related_pair(rng, n3)
    emit(f"semiglobal hirschberg {n3 // 1000}k",
         construct(q, s, "semiglobal", sc, "hirschberg"), 2 * n3 * n3,
         reps=1)

    # 3a: affine (Gotoh) Myers-Miller construction
    n3a = 5000 if quick else 20000
    q, s = related_pair(rng, n3a)
    emit(f"affine global myers-miller {n3a // 1000}k",
         construct(q, s, "global", aff, "hirschberg"), 2 * n3a * n3a,
         reps=1)

    # 4: many-pair scores and constructions, end to end from host bytes
    npairs, plen = (100, 256) if quick else (2000, 256)
    qs, ss = zip(*(related_pair(rng, plen, 0.1) for _ in range(npairs)))
    emit(f"batch local {npairs}x{plen}bp",
         lambda: anyseq_tpu.align_scores_batch(qs, ss, "local", sc),
         npairs * plen * plen)
    nc = 50 if quick else 500
    emit(f"batch construct {nc}x{plen}bp",
         lambda: anyseq_tpu.align_batch(qs[:nc], ss[:nc], "local", sc),
         nc * plen * plen, reps=1)

    if not quick:
        # 5: genome scale, score and construction at 1 Mbp
        n5 = 1_000_000
        q, s = related_pair(rng, n5)
        emit("genome global score 1Mbp",
             lambda: anyseq_tpu.align_score(q, s, "global", sc), n5 * n5,
             reps=1)
        emit("genome global hirschberg 1Mbp",
             construct(q, s, "global", sc, "hirschberg"), 2 * n5 * n5,
             reps=1)

        # 6: subject-sharded wavefront over this host's devices
        n6 = 100_000
        q, s = related_pair(rng, n6)
        mesh = meshlib.make_mesh(sp=len(dev), dp=1)
        emit(f"sharded sp wavefront {n6 // 1000}k (K={len(dev)})",
             lambda: score_pair_sharded(q, s, "global", sc, mesh,
                                        H=8192)["last_col"],
             n6 * n6, reps=1)

    summary = {"metric": "suite peak GCUPS",
               "value": max(r["gcups"] for r in results), "unit": "GCUPS",
               "device": device_record(dev), "card": card_line()}
    print(json.dumps(summary), file=out, flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--json", metavar="FILE",
                   help="also write the full results list as JSON")
    args = p.parse_args(argv)
    try:
        res = run(quick=args.quick)
    except NoGPU as e:
        print(e, file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
