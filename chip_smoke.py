"""End-to-end smoke run of every public alignment path on one NVIDIA GPU.

    python chip_smoke.py              # phases (a)-(f) on one card
    python chip_smoke.py --cards 4    # phase (g) only, on four cards

Each phase drives the public API at full size, checks the result by the
repository's own means (the XLA engines, the numpy oracles in ref/, and a
host rescoring of every constructed alignment from its aligned strings),
and prints one JSON line: shapes, seconds after warm-up, parity, and the
card as nvidia-smi reports it. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and is printed only when every phase passed. Without a GPU the script
exits non-zero and prints no result.

Phases: (a) single-pair scores, (b) Hirschberg / Myers-Miller construction,
(c) full-matrix traceback, (d) batches, (e) the CLI, (f) the sweep kernel
against the XLA engine on every path the router sends to it, (g) four
cards: sharded construction, sharded score and data-parallel batch, each
against the one-card result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import traceback

import numpy as np

from anyseq_tpu.bench.device import (
    NoGPU,
    card_line,
    device_record,
    gpu_devices,
    related_pair,
    timed,
)


def rescore(aln, q: bytes, s: bytes, mode, sc):
    """(valid, score) of a constructed alignment, recomputed on the host
    from its aligned strings: the gapless strings must be the substrings
    of q and s that start at ``aln.start`` (the whole sequences for
    global), and the score is summed column by column (affine: one
    gap_open per gap run)."""
    from anyseq_tpu.core.types import AffineScoring, Mode

    qa, sa = aln.compact()
    qs = qa.replace("_", "").encode()
    ss = sa.replace("_", "").encode()
    i0, j0 = aln.start
    valid = (q[i0:i0 + len(qs)] == qs and s[j0:j0 + len(ss)] == ss)
    if Mode.parse(mode) is Mode.GLOBAL:
        valid = valid and len(qs) == len(q) and len(ss) == len(s)
    affine = isinstance(sc, AffineScoring)
    score, state = 0, None
    for a, b in zip(qa, sa):
        if a == "_" or b == "_":
            run = "E" if a == "_" else "F"
            if affine:
                score += sc.gap_extend + (sc.gap_open if state != run else 0)
            else:
                score += sc.gap
            state = run
        else:
            score += sc.match if a == b else sc.mismatch
            state = None
    return valid, score


def _outs(q, s, mode, sc, engine):
    """Score-pass outputs of one pair from ``engine`` (numpy dict)."""
    import jax

    from anyseq_tpu.core.types import Mode
    from anyseq_tpu.engine import api

    _, _, m, n, qp, sp = api._prep(q, s)
    return jax.device_get(api._run_score(qp, sp, m, n, Mode.parse(mode), sc,
                                         engine))


def _same_outs(a, b, m, n):
    """The score-pass outputs both engines return are equal within the
    problem's lengths."""
    keys = {"last_row": n, "last_col": m, "last_col_e": m}
    ok = all(np.array_equal(a[k][:ln], b[k][:ln])
             for k, ln in keys.items() if k in a and k in b)
    return ok and np.array_equal(a["best"], b["best"])


def phase_scores(L=100_000, La=20_000, Lo=2_000, seed=0):
    """(a) align_score: L local linear and La local affine; the routed
    outputs equal the XLA engine's at full size, and the oracles' scores
    at Lo."""
    import anyseq_tpu
    from anyseq_tpu import AffineScoring, LinearScoring
    from anyseq_tpu.ref import oracle, oracle_affine

    rng = np.random.default_rng(seed)
    lin, aff = LinearScoring(2, -1, -1), AffineScoring(2, -1, -3, -1)
    q, s = related_pair(rng, L)
    qa, sa = q[:La], s[:La]
    sec, n, _ = timed(lambda: anyseq_tpu.align_score(q, s, "local", lin))
    sec_a, _, _ = timed(lambda: anyseq_tpu.align_score(qa, sa, "local",
                                                        aff))
    parity = (_same_outs(_outs(q, s, "local", lin, "auto"),
                         _outs(q, s, "local", lin, "xla"), L, L)
              and _same_outs(_outs(qa, sa, "local", aff, "auto"),
                             _outs(qa, sa, "local", aff, "xla"), La, La))
    qo, so = q[:Lo], s[:Lo]
    for mode in ("global", "semiglobal", "local"):
        parity = parity and (
            anyseq_tpu.align_score(qo, so, mode, lin)
            == oracle.align_score(qo, so, mode, lin)
            and anyseq_tpu.align_score(qo, so, mode, aff)
            == oracle_affine.align_score_affine(qo, so, mode, aff))
    return {"shapes": {"local_linear": [L, L], "local_affine": [La, La],
                       "oracle": [Lo, Lo]},
            "seconds": {"local_linear": sec, "local_affine": sec_a},
            "n": n, "parity": bool(parity)}


def phase_construction(L=100_000, La=20_000, seed=1):
    """(b) align with Hirschberg (L semiglobal, linear) and Myers-Miller
    (La global, affine); each alignment rescored on the host equals its
    reported score and align_score."""
    import anyseq_tpu
    from anyseq_tpu import AffineScoring, LinearScoring

    rng = np.random.default_rng(seed)
    lin, aff = LinearScoring(2, -1, -1), AffineScoring(2, -1, -3, -1)
    q, s = related_pair(rng, L)
    qa, sa = related_pair(rng, La)
    runs = {}
    parity = True
    for name, args in (("semiglobal_hirschberg", (q, s, "semiglobal", lin)),
                       ("global_myers_miller", (qa, sa, "global", aff))):
        sec, _, aln = timed(lambda: anyseq_tpu.align(
            *args, traceback="hirschberg"), reps=1)
        valid, score = rescore(aln, *args)
        parity = parity and valid and score == aln.score == (
            anyseq_tpu.align_score(*args))
        runs[name] = sec
    return {"shapes": {"semiglobal_hirschberg": [L, L],
                       "global_myers_miller": [La, La]},
            "seconds": runs, "n": 1, "parity": bool(parity)}


def phase_fulltb(L=10_000, seed=2):
    """(c) align_full_tb at L local, linear and affine, rescored."""
    import anyseq_tpu
    from anyseq_tpu import AffineScoring, LinearScoring

    rng = np.random.default_rng(seed)
    q, s = related_pair(rng, L)
    runs = {}
    parity = True
    for name, sc in (("linear", LinearScoring(2, -1, -1)),
                     ("affine", AffineScoring(2, -1, -3, -1))):
        sec, _, aln = timed(lambda: anyseq_tpu.align_full_tb(
            q, s, "local", sc), reps=1)
        valid, score = rescore(aln, q, s, "local", sc)
        parity = parity and valid and score == aln.score == (
            anyseq_tpu.align_score(q, s, "local", sc))
        runs[name] = sec
    return {"shapes": {"local": [L, L]}, "seconds": runs, "n": 1,
            "parity": bool(parity)}


def phase_batches(pairs=2_000, plen=256, construct=500, sample=50, seed=3):
    """(d) align_scores_batch on ``pairs`` local pairs, linear and affine,
    checked against the oracles on a seeded sample; align_batch on
    ``construct`` global pairs, every alignment rescored."""
    import anyseq_tpu
    from anyseq_tpu import AffineScoring, LinearScoring
    from anyseq_tpu.ref import oracle, oracle_affine

    rng = np.random.default_rng(seed)
    lin, aff = LinearScoring(2, -1, -1), AffineScoring(2, -1, -3, -1)
    qs, ss = zip(*(related_pair(rng, plen, 0.1) for _ in range(pairs)))
    pick = rng.choice(pairs, size=min(sample, pairs), replace=False)
    runs = {}
    parity = True
    for name, sc, ref in (("scores_linear", lin, oracle.align_score),
                          ("scores_affine", aff,
                           oracle_affine.align_score_affine)):
        sec, n, got = timed(lambda: anyseq_tpu.align_scores_batch(
            qs, ss, "local", sc))
        parity = parity and all(
            int(got[i]) == ref(qs[i], ss[i], "local", sc) for i in pick)
        runs[name] = sec
    cq, cs = qs[:construct], ss[:construct]
    sec, _, alns = timed(lambda: anyseq_tpu.align_batch(
        cq, cs, "global", lin), reps=1)
    for aln, q, s in zip(alns, cq, cs):
        valid, score = rescore(aln, q, s, "global", lin)
        parity = parity and valid and score == aln.score
    runs["align_batch_global"] = sec
    return {"shapes": {"scores": [pairs, plen, plen],
                       "align_batch": [construct, plen, plen],
                       "oracle_sample": int(len(pick))},
            "seconds": runs, "n": n, "parity": bool(parity)}


def phase_cli(lo=1000, hi=4000):
    """(e) the CLI's random mode in-process: exit 0 and the reference's
    six timing lines."""
    from anyseq_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-r", str(lo), str(hi)])
    sec = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("testing ")]
    return {"shapes": {"rand": [lo, hi]}, "seconds": sec, "n": 1,
            "parity": rc == 0 and len(lines) == 6}


def phase_kernel_vs_xla(L=100_000, pairs=2_000, plen=256, seed=4):
    """(f) each path the router sends to the sweep kernel, timed with
    engine "auto" and "xla" at the phase (a), (b) and (d) shapes; plus
    the compiled 100k sweep's memory analysis."""
    import jax
    import jax.numpy as jnp

    import anyseq_tpu
    from anyseq_tpu import LinearScoring
    from anyseq_tpu.engine import api, route

    rng = np.random.default_rng(seed)
    lin = LinearScoring(2, -1, -1)
    q, s = related_pair(rng, L)
    qs, ss = zip(*(related_pair(rng, plen, 0.1) for _ in range(pairs)))
    paths = {
        "score": (lambda e: anyseq_tpu.align_score(q, s, "local", lin,
                                                   engine=e), 3),
        "levels": (lambda e: anyseq_tpu.align(
            q, s, "semiglobal", lin, traceback="hirschberg", engine=e), 1),
        "batch": (lambda e: anyseq_tpu.align_scores_batch(
            qs, ss, "local", lin, engine=e), 3),
    }
    res = {}
    parity = True
    for path, (fn, reps) in paths.items():
        if path not in route.KERNEL_PATHS:
            continue
        t_k, _, a = timed(lambda: fn("auto"), reps)
        t_x, _, b = timed(lambda: fn("xla"), 1)
        same = (np.array_equal(a, b) if path == "batch"
                else a == b)
        parity = parity and bool(same)
        res[path] = {"kernel_s": t_k, "xla_s": t_x, "kernel_n": reps,
                     "xla_n": 1}
    mem = None
    if "score" in route.KERNEL_PATHS and route.platform() == "gpu":
        from anyseq_tpu.core.types import Mode
        from anyseq_tpu.kernels import sweep

        _, _, m, n, qp, sp = api._prep(q, s)
        lowered = jax.jit(lambda a, b: sweep.sweep(
            a, b, jnp.array([m]), jnp.array([n]), Mode.LOCAL, lin,
        )).lower(qp[None], sp[None])
        mem = str(lowered.compile().memory_analysis())
    return {"shapes": {"score": [L, L], "levels": [L, L],
                       "batch": [pairs, plen, plen]},
            "seconds": res, "memory_analysis_100k_sweep": mem,
            "parity": parity}


def phase_four_cards(L=100_000, pairs=512, plen=256, seed=5):
    """(g) on four cards: align(mesh=make_mesh(sp=4)) at L global,
    score_pair_sharded at L local, align_batch(mesh=make_mesh(dp=4));
    each equal to the one-card result of the same process."""
    import jax

    import anyseq_tpu
    from anyseq_tpu import LinearScoring
    from anyseq_tpu.dist.mesh import make_mesh
    from anyseq_tpu.dist.sharded import score_pair_sharded
    from anyseq_tpu.engine import xla_linmem

    rng = np.random.default_rng(seed)
    lin = LinearScoring(2, -1, -1)
    q, s = related_pair(rng, L)
    qs, ss = zip(*(related_pair(rng, plen, 0.1) for _ in range(pairs)))
    k = len(jax.devices())
    runs = {}
    sp_mesh, dp_mesh = make_mesh(sp=k), make_mesh(dp=k)

    def aln_tuple(a):
        return (a.score, a.query_aligned, a.subject_aligned, a.start)

    one = aln_tuple(anyseq_tpu.align(q, s, "global", lin))
    sec, _, aln = timed(lambda: anyseq_tpu.align(q, s, "global", lin,
                                                 mesh=sp_mesh), reps=1)
    parity = aln_tuple(aln) == one
    runs["align_sp"] = sec

    def sharded_score():
        outs = jax.device_get(score_pair_sharded(q, s, "local", lin,
                                                 sp_mesh))
        return xla_linmem.extract_score_from_outputs(outs, L, L, "local",
                                                     lin)

    sec, _, (score, end) = timed(sharded_score, reps=1)
    ref = _outs(q, s, "local", lin, "auto")
    ref_score, ref_end = xla_linmem.extract_score_from_outputs(
        ref, L, L, "local", lin)
    parity = parity and (score, tuple(end)) == (ref_score, tuple(ref_end))
    runs["score_pair_sharded"] = sec

    one_b = [aln_tuple(a) for a in anyseq_tpu.align_batch(qs, ss, "global",
                                                          lin)]
    sec, _, alns = timed(lambda: anyseq_tpu.align_batch(
        qs, ss, "global", lin, mesh=dp_mesh), reps=1)
    parity = parity and [aln_tuple(a) for a in alns] == one_b
    runs["align_batch_dp"] = sec
    return {"shapes": {"align_sp": [L, L], "score_pair_sharded": [L, L],
                       "align_batch_dp": [pairs, plen, plen]},
            "cards": k, "seconds": runs, "n": 1, "parity": bool(parity)}


PHASES = {
    "a": phase_scores,
    "b": phase_construction,
    "c": phase_fulltb,
    "d": phase_batches,
    "e": phase_cli,
    "f": phase_kernel_vs_xla,
}


def run_phase(key, fn, card, **kw) -> bool:
    """Run one phase, print its JSON line, return whether it passed."""
    try:
        rec = fn(**kw)
    except Exception:  # report the phase as failed and go on
        rec = {"parity": False, "error": traceback.format_exc(limit=8)}
    rec = {"phase": key, "name": fn.__name__, **rec, "card": card}
    print(json.dumps(rec), flush=True)
    return rec["parity"] is True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase (g)")
    args = ap.parse_args(argv)

    try:
        dev = gpu_devices(args.cards)
    except NoGPU as e:
        print(e, file=sys.stderr)
        return 2

    card = card_line()
    print(card, flush=True)
    if args.cards == 4:
        ok = run_phase("g", phase_four_cards, card)
    else:
        from anyseq_tpu.kernels import sweep

        t0 = time.perf_counter()
        sweep.build()
        print(json.dumps({"phase": "build", "seconds":
                          time.perf_counter() - t0}), flush=True)
        ok = all([run_phase(k, fn, card) for k, fn in PHASES.items()])
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": device_record(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
