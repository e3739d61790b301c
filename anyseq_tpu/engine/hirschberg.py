"""Linear-memory (Hirschberg) traceback engine.

Capability parity with the reference's default alignment-construction path
(``traceback_lintime``, align.impala:237-311 + traceback_lintime.impala),
re-designed for correctness and batched device sweeps:

* The divide step aligns the left subject half forward and the right half
  on *reversed* sequences, then merges the two boundary columns with
  ``argmax_k L[k] + R[h-k-2]`` including the +-1 edge cases -- exactly the
  reference's ``hb_sum`` (traceback_lintime.impala:44-135) and reversed
  half accessors (traceback_lintime.impala:137-148).

* Deliberate deviations (documented; the reference's construct paths for
  non-global schemes are semantically unreliable, see SURVEY.md Q1/Q6):
  - semiglobal/local alignments are reduced to a global Hirschberg on the
    end-point rectangle found by forward + reverse score passes (the
    standard score-preserving reduction); the returned score is the true
    DP score (the reference returns a bogus score from a fresh unwritten
    matrix for these paths, align.impala:244+264).
  - split ties resolve to the smallest k (reference ties depend on block
    iteration order).
  - subject splits at n//2 instead of the reference's next-pow-2 part
    grid; equal-score alignments may differ in tie cells only.

Memory: O(m + n) per level plus O(h * MIN_WIDTH) for the final predecessor
stripes -- the reference's ragged blockwise predecessor matrix
(predecessors.impala:36-46).
"""
from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from anyseq_tpu.core.types import (
    EMPTY_SYM,
    PAD_Q,
    PAD_S,
    AffineScoring,
    Alignment,
    LinearScoring,
    Mode,
    as_u8,
)
from anyseq_tpu.engine import route, tb

# Width at which divide-and-conquer stops and a predecessor stripe is
# materialized (reference MIN_PART_WIDTH_HB = 128, align.impala:18; we use a
# wider stripe since the engines vectorize over 128-lane windows anyway).
MIN_WIDTH = 256

# Env ANYSEQ_TIMING=1: print per-phase construction timings (stderr)
# and append them to TIMING_LOG (consumed by bench/suite.py for the
# committed per-phase breakdown artifact).
TIMING_LOG: list[str] = []


def _tlog(msg):
    if os.environ.get("ANYSEQ_TIMING") == "1":
        import sys

        TIMING_LOG.append(msg)
        print(f"[hb] {msg}", file=sys.stderr, flush=True)


class _HbCheckpoint:
    """Durable level-granular state for the Hirschberg construction
    (VERDICT r1 item 7; the reference's Splits vector is morally this
    state, traceback_lintime.impala:9-42). Each completed level (and each
    completed terminal chunk) atomically rewrites one npz; a killed run
    resumes at the last completed unit, producing a byte-identical
    alignment."""

    def __init__(self, path, key: str):
        self.path = path
        self.key = key

    def load(self):
        import os

        if not self.path or not os.path.exists(self.path):
            return None
        ck = np.load(self.path, allow_pickle=False)
        if str(ck["key"]) != self.key:
            raise ValueError("checkpoint does not match this problem")
        return ck

    def save(self, **arrays):
        import os
        import tempfile

        if not self.path:
            return
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(self.path)) or "."
        )
        os.close(fd)
        np.savez(tmp, key=self.key, **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   self.path)


def _ckpt_key(q8, s8, mode, scoring, min_width) -> str:
    import hashlib

    h = hashlib.sha256()
    h.update(q8.tobytes())
    h.update(s8.tobytes())
    h.update(repr((mode.value, scoring, min_width)).encode())
    return h.hexdigest()


def _score_outputs(q8, s8, mode, scoring, engine, mesh=None):
    """Run a score pass, returning numpy outputs dict. With ``mesh`` the
    pass runs subject-sharded over the mesh (dist/sharded.py)."""
    from anyseq_tpu.engine import api

    if mesh is not None:
        from anyseq_tpu.dist.sharded import score_pair_sharded

        outs = score_pair_sharded(q8, s8, mode, scoring, mesh,
                                  engine=engine)
        return jax.device_get(outs)
    _, _, m, n, qp, sp = api._prep(q8, s8)
    outs = api._run_score(qp, sp, m, n, mode, scoring, engine)
    return jax.device_get(outs)  # one round trip for all outputs


def _level_cols(q, s, ms, ns, scoring, engine, sgaps=None):
    """Boundary columns of one construction level's half-problems, from
    the engine the router picks: (M, B) H columns, plus (M, B) E columns
    for affine scoring (``sgaps``: per-half start-in-gap flags)."""
    from anyseq_tpu.engine import batch

    if route.use_kernel("levels", engine, q.shape[1]):
        from anyseq_tpu.kernels import sweep

        return sweep.last_cols_batch(q, s, ms, ns, scoring, sgap=sgaps)
    if isinstance(scoring, AffineScoring):
        return batch.last_cols_batch_affine(q, s, ms, ns, scoring, sgaps)
    return batch.last_cols_batch(q, s, ms, ns, scoring)


def _write_all_gap_subject(s8, off_i, off_j, out_q, out_s):
    """Emit subject symbols against query gaps (empty query side).

    These ops belong to boundary cells (-1, j), whose sparse position is
    i + j + 1 = j (reference traceback.impala:61 with i = -1). Vectorized
    numpy slice writes: a degenerate h==0 part at Mbp scale must not burn
    interpreter time per symbol."""
    n = len(s8)
    if n == 0:
        return
    base = off_i + off_j
    out_q[base: base + n] = ord("_")
    out_s[base: base + n] = (
        s8 if isinstance(s8, np.ndarray) else np.frombuffer(s8, np.uint8)
    )


def _write_all_gap_query(q8, off_i, off_j, out_q, out_s):
    m = len(q8)
    if m == 0:
        return
    base = off_i + off_j
    out_q[base: base + m] = (
        q8 if isinstance(q8, np.ndarray) else np.frombuffer(q8, np.uint8)
    )
    out_s[base: base + m] = ord("_")


def _merge_halves(L, Rv, h, mid_w, right_w, g):
    """hb_sum: F(k) = L[k] + R[h-k-2], k in [-1, h-1]; edges use the
    all-gap init scores (reference hb_sum edge handling,
    traceback_lintime.impala:69-83). Returns (k, score); ties -> smallest
    k."""
    F = np.empty(h + 1, dtype=np.int64)
    F[0] = mid_w * g + Rv[h - 1]        # k = -1: left half all gaps
    F[1:h] = L[: h - 1] + Rv[: h - 1][::-1]
    F[h] = L[h - 1] + right_w * g       # k = h-1: right half all gaps
    k = int(np.argmax(F)) - 1
    return k, int(F[k + 1])


def _hb_global(q8, s8, off_i, off_j, out_q, out_s, scoring, engine,
               min_width=MIN_WIDTH, mesh=None, sp_min_width=None,
               ckpt=None):
    """Level-synchronous global Hirschberg; returns the global score.

    All forward-left and reversed-right halves of one level run as ONE
    batched device sweep (the reference's iteration_partitioned wavefront
    over all halves of all parts, iteration_cpu.impala:59-119), and all
    terminal predecessor stripes run as a handful of batched sweeps (the
    reference's iteration_blockwise, iteration_cpu.impala:121-157). Host
    work per level is the tiny argmax merge. This keeps the number of
    device round-trips at O(log n) instead of O(n / min_width).

    With ``mesh``, every phase is distributed (SURVEY.md:148-150,
    "Hirschberg across chips"): shallow wide halves run subject-sharded
    over the mesh (boundary columns via the pipelined stripe wavefront,
    dist/sharded.py), deep levels and terminal stripes run data-parallel
    over all devices (dist/batch.py), and the hb_sum argmax merge stays
    on host (O(m) per level). Results are bit-identical to the
    single-device path (same integer recurrences, same tie-breaks).
    ``sp_min_width``: minimum half width for the subject-sharded phase
    (default: 2048 columns per device).
    """
    from anyseq_tpu.engine import api, batch, xla_linmem

    m, n = len(q8), len(s8)
    g = scoring.gap
    if m == 0:
        _write_all_gap_subject(s8, off_i, off_j, out_q, out_s)
        return g * n
    if n == 0:
        _write_all_gap_query(q8, off_i, off_j, out_q, out_s)
        return g * m

    q32 = q8.astype(np.int32)
    s32 = s8.astype(np.int32)

    if n <= min_width or n < 2 or m <= 1:
        # Single terminal stripe: one pred pass, exact score.
        _, _, _, _, qp, sp = api._prep(q8, s8)
        outs = xla_linmem.score_rows_with_preds(
            qp, sp, m, n, Mode.GLOBAL, scoring
        )
        P = api._haloed_preds(np.asarray(outs["preds"]), m, n, Mode.GLOBAL)
        tb.walk_linear(q8, s8, P, (m - 1, n - 1), out_q, out_s,
                       off_i, off_j)
        return int(np.asarray(outs["last_col"])[m - 1])

    root_score = None
    active = [(0, m, 0, n)]            # (qlo, qhi, slo, shi)
    terminals = []
    term_done = 0
    _RS_NONE = -(2**62)

    if ckpt is not None:
        ck = ckpt.load()
        if ck is not None:
            active = [tuple(map(int, r)) for r in ck["active"].reshape(-1, 4)]
            terminals = [tuple(map(int, r))
                         for r in ck["terminals"].reshape(-1, 4)]
            out_q[:] = ck["out_q"]
            out_s[:] = ck["out_s"]
            rs = int(ck["root_score"])
            root_score = None if rs == _RS_NONE else rs
            term_done = int(ck["term_done"])

    def _save_level():
        if ckpt is not None:
            ckpt.save(
                active=np.asarray(active, np.int64).reshape(-1, 4),
                terminals=np.asarray(terminals, np.int64).reshape(-1, 4),
                out_q=out_q, out_s=out_s,
                root_score=np.int64(
                    _RS_NONE if root_score is None else root_score
                ),
                term_done=np.int64(term_done),
            )

    def classify(part):
        qlo, qhi, slo, shi = part
        h, w = qhi - qlo, shi - slo
        if h == 0:
            _write_all_gap_subject(s8[slo:shi], off_i + qlo, off_j + slo,
                                   out_q, out_s)
        elif w <= min_width or w < 2 or h <= 1:
            terminals.append(part)
        else:
            active.append(part)

    from anyseq_tpu.dist import batch as dist_batch  # fetch() on all paths

    if mesh is not None:
        import math

        from anyseq_tpu.dist.sharded import score_pair_sharded

        n_dev = math.prod(mesh.shape.values())
        if sp_min_width is None:
            sp_min_width = 2048 * n_dev

    while active:
        _lt0 = time.perf_counter()
        parts = active
        active = []
        P = len(parts)
        hs = [p[1] - p[0] for p in parts]
        mids = [(p[3] - p[2]) // 2 for p in parts]

        if mesh is not None and P <= 4 and min(mids) >= sp_min_width:
            # Wide halves: subject-sharded pipelined wavefront per half
            # over the whole mesh; the half's boundary column is the
            # sweep's last-column output. Dispatches are async; fetch
            # everything in ONE device round trip.
            cols_dev = []
            for p, (qlo, qhi, slo, shi) in enumerate(parts):
                h, mid = hs[p], mids[p]
                for qa, sa in (
                    (q8[qlo:qhi], s8[slo:slo + mid]),
                    (q8[qlo:qhi][::-1], s8[slo + mid:shi][::-1]),
                ):
                    outs = score_pair_sharded(
                        np.ascontiguousarray(qa),
                        np.ascontiguousarray(sa),
                        Mode.GLOBAL, scoring, mesh, engine=engine,
                    )
                    cols_dev.append(outs["last_col"])
            import jax as _jax

            cols_list = [c[:hs[i // 2]]
                         for i, c in enumerate(_jax.device_get(cols_dev))]
            for p, (qlo, qhi, slo, shi) in enumerate(parts):
                h, mid = hs[p], mids[p]
                L = cols_list[2 * p].astype(np.int64)
                Rv = cols_list[2 * p + 1].astype(np.int64)
                k, score = _merge_halves(
                    L, Rv, h, mid, shi - slo - mid, g
                )
                if root_score is None:
                    root_score = score
                classify((qlo, qlo + k + 1, slo, slo + mid))
                classify((qlo + k + 1, qhi, slo + mid, shi))
            _tlog(f"level P={P} maxh={max(hs)} maxmid={max(mids)} "
                  f"path=mesh-sp {(time.perf_counter()-_lt0)*1e3:.0f}ms")
            _save_level()
            continue

        Mb = batch._bucket(max(hs))
        Nb = batch._bucket(max(max(mids), max(
            (p[3] - p[2]) - mi for p, mi in zip(parts, mids)
        )), 128)
        B = 2 * P
        qarr = np.full((B, Mb), PAD_Q, np.int32)
        sarr = np.full((B, Nb), PAD_S, np.int32)
        ms = np.empty(B, np.int32)
        ns = np.empty(B, np.int32)
        for p, (qlo, qhi, slo, shi) in enumerate(parts):
            h, mid = hs[p], mids[p]
            qarr[2 * p, :h] = q32[qlo:qhi]
            qarr[2 * p + 1, :h] = q32[qlo:qhi][::-1]
            sarr[2 * p, :mid] = s32[slo:slo + mid]
            sarr[2 * p + 1, : shi - slo - mid] = s32[slo + mid:shi][::-1]
            ms[2 * p] = ms[2 * p + 1] = h
            ns[2 * p] = mid
            ns[2 * p + 1] = shi - slo - mid
        if mesh is not None:
            cols = dist_batch.fetch(dist_batch.last_cols_batch_sharded(
                jnp.asarray(qarr), jnp.asarray(sarr),
                jnp.asarray(ms), jnp.asarray(ns), scoring, mesh,
            )).T                                   # -> (B, M)
        else:
            cols = np.asarray(_level_cols(
                jnp.asarray(qarr), jnp.asarray(sarr),
                jnp.asarray(ms), jnp.asarray(ns), scoring, engine,
            )).T                                   # -> (B, M)
        for p, (qlo, qhi, slo, shi) in enumerate(parts):
            h, mid = hs[p], mids[p]
            L = cols[2 * p, :h].astype(np.int64)
            Rv = cols[2 * p + 1, :h].astype(np.int64)
            k, score = _merge_halves(L, Rv, h, mid, shi - slo - mid, g)
            if root_score is None:
                root_score = score
            classify((qlo, qlo + k + 1, slo, slo + mid))
            classify((qlo + k + 1, qhi, slo + mid, shi))
        _tlog(f"level P={P} maxh={max(hs)} maxmid={max(mids)} "
              f"path=batched {(time.perf_counter()-_lt0)*1e3:.0f}ms")
        _save_level()

    _tt0 = time.perf_counter()
    # Terminal stripes, batched by shape bucket (chunk index `ci` is the
    # checkpoint resume unit).
    groups: dict[tuple[int, int], list] = {}
    for t in terminals:
        h, w = t[1] - t[0], t[3] - t[2]
        groups.setdefault(
            (batch._bucket(h), batch._bucket(w, 128)), []
        ).append(t)
    ci = -1
    for (Hb, Wb), ts in groups.items():
        for lo in range(0, len(ts), 512):
            ci += 1
            if ci < term_done:
                continue
            chunk = ts[lo: lo + 512]
            B = len(chunk)
            qarr = np.full((B, Hb), PAD_Q, np.int32)
            sarr = np.full((B, Wb), PAD_S, np.int32)
            ms = np.empty(B, np.int32)
            ns = np.empty(B, np.int32)
            for b, (qlo, qhi, slo, shi) in enumerate(chunk):
                h, w = qhi - qlo, shi - slo
                qarr[b, :h] = q32[qlo:qhi]
                sarr[b, :w] = s32[slo:shi]
                ms[b] = h
                ns[b] = w
            if mesh is not None:
                preds, _ = dist_batch.preds_batch_sharded(
                    jnp.asarray(qarr), jnp.asarray(sarr),
                    jnp.asarray(ms), jnp.asarray(ns), scoring, mesh,
                )
                preds = dist_batch.fetch(preds)
                for b, (qlo, qhi, slo, shi) in enumerate(chunk):
                    h, w = qhi - qlo, shi - slo
                    Pm = api._haloed_preds(
                        preds[b, :h, :w], h, w, Mode.GLOBAL
                    )
                    tb.walk_linear(
                        q8[qlo:qhi], s8[slo:shi], Pm, (h - 1, w - 1),
                        out_q, out_s, off_i + qlo, off_j + slo,
                    )
            else:
                # On-device batched walk: only the O(B*(H+W)) aligned
                # strings leave the device, not the dense O(B*H*W)
                # preds. Pred sweep + walk fused in ONE dispatch, ONE
                # fetch.
                oq, osub = jax.device_get(batch.preds_walk_batch(
                    jnp.asarray(qarr), jnp.asarray(sarr),
                    jnp.asarray(ms), jnp.asarray(ns), scoring,
                ))
                from anyseq_tpu.core.types import EMPTY_SYM
                for b, (qlo, qhi, slo, shi) in enumerate(chunk):
                    h, w = qhi - qlo, shi - slo
                    base = off_i + qlo + off_j + slo
                    # Replicate the host walk's write pattern exactly:
                    # only the walked path positions (EMPTY positions
                    # are skipped-by-diagonal slots that may belong to
                    # other writers in the shared sparse buffer). The
                    # walk's halo tail (cells at i = -1 or j = -1)
                    # reaches local position 0, so the copy starts at
                    # local 0 = global `base`.
                    ln = min(h + w, len(out_q) - base)
                    seg_q = oq[b, :ln]
                    seg_s = osub[b, :ln]
                    sel = (seg_q != EMPTY_SYM) | (seg_s != EMPTY_SYM)
                    out_q[base: base + ln][sel] = seg_q[sel]
                    out_s[base: base + ln][sel] = seg_s[sel]
            term_done = ci + 1
            _save_level()
    _tlog(f"terminals n={len(terminals)} "
          f"{(time.perf_counter()-_tt0)*1e3:.0f}ms")
    return root_score


def _merge_halves_affine(HL, EL, HR, ER, h, mid_w, right_w, sc,
                         sgap, egap):
    """Myers-Miller merge at a subject cut: over k in [-1, h-1],
    type1 (cut crossed in H state)  = HL[k] + HR[h-2-k]
    type2 (one horizontal gap run spans the cut) = EL[k] + ER[h-2-k] - go
    with closed-form k = -1 / r = -1 boundary entries (an all-gap
    boundary-row run, whose gap_open is dropped when the part's own
    start/end flag says the run is paid by the caller).

    Returns (k, crosses_in_gap, score); ties -> smallest k, type1 first.
    """
    go, ge = sc.gap_open, sc.gap_extend
    HLv = np.empty(h + 1, np.int64)
    ELv = np.empty(h + 1, np.int64)
    HLv[0] = ELv[0] = mid_w * ge + (0 if sgap else go)
    HLv[1:] = HL[:h]
    ELv[1:] = EL[:h]
    HRv = np.empty(h + 1, np.int64)
    ERv = np.empty(h + 1, np.int64)
    HRv[:h] = HR[:h][::-1]
    ERv[:h] = ER[:h][::-1]
    HRv[h] = ERv[h] = right_w * ge + (0 if egap else go)
    t1 = HLv + HRv
    t2 = ELv + ERv - go
    b1, b2 = int(np.max(t1)), int(np.max(t2))
    if b1 >= b2:
        return int(np.argmax(t1)) - 1, False, b1
    return int(np.argmax(t2)) - 1, True, b2


def _haloed_affine_preds_mm(packed, h, w, sgap):
    """Haloed PH/PE/PF planes for a Myers-Miller terminal stripe (always
    GLOBAL scheme; ``sgap`` selects the continuing-run boundary-row
    convention: the boundary E run never 'opens' inside the stripe)."""
    from anyseq_tpu.core.types import PRED_GAP_Q, PRED_GAP_S

    PH = np.zeros((h + 1, w + 1), dtype=np.uint8)
    PE = np.zeros((h + 1, w + 1), dtype=np.uint8)
    PF = np.zeros((h + 1, w + 1), dtype=np.uint8)
    PH[1:, 1:] = packed & 3
    PE[1:, 1:] = (packed >> 2) & 1
    PF[1:, 1:] = (packed >> 3) & 1
    PH[0, 1:] = PRED_GAP_Q
    PH[1:, 0] = PRED_GAP_S
    if sgap:
        PE[0, 1:] = 1     # run continues past the stripe boundary
    else:
        PE[0, 2:] = 1     # run opens at column 0 (from the corner)
    PF[2:, 0] = 1
    return PH, PE, PF


def _hb_global_affine(q8, s8, off_i, off_j, out_q, out_s, sc, engine,
                      min_width=MIN_WIDTH, sgap=False, egap=False,
                      ckpt=None, mesh=None, sp_min_width=None):
    """Linear-memory affine (Gotoh) alignment construction: the
    Myers-Miller divide-and-conquer. Level-synchronous like
    :func:`_hb_global`; parts carry (start-in-gap, end-in-gap) flags so
    horizontal gap runs crossing a cut are charged exactly one gap_open
    (engine passes: batch.last_cols_batch_affine / preds_batch_affine).

    With ``mesh``, wide levels run subject-sharded over the device mesh
    (full Gotoh state in the superstep messages, incl. the start_gap
    continuing-run init per crossing flag) and deep levels / terminal
    stripes run data-parallel -- bit-identical to the single-device
    result.

    Beyond-reference capability (the reference's affine scoring is dead
    code, align.impala:153-166 / SURVEY.md Q3); returns the true global
    affine score."""
    from anyseq_tpu.engine import batch

    m, n = len(q8), len(s8)
    go, ge = sc.gap_open, sc.gap_extend
    if m == 0:
        _write_all_gap_subject(s8, off_i, off_j, out_q, out_s)
        return (0 if sgap else go) + ge * n if n else 0
    if n == 0:
        _write_all_gap_query(q8, off_i, off_j, out_q, out_s)
        return go + ge * m

    q32 = q8.astype(np.int32)
    s32 = s8.astype(np.int32)

    root_score = None
    active = []
    terminals = []
    term_done = 0
    _RS_NONE = -(2**62)

    def classify(part):
        qlo, qhi, slo, shi, sg, eg = part
        h, w = qhi - qlo, shi - slo
        if h == 0:
            _write_all_gap_subject(s8[slo:shi], off_i + qlo, off_j + slo,
                                   out_q, out_s)
        elif w <= min_width or w < 2 or h <= 1:
            terminals.append(part)
        else:
            active.append(part)

    classify((0, m, 0, n, sgap, egap))

    if ckpt is not None:
        ck = ckpt.load()
        if ck is not None:
            active = [tuple(map(int, r))
                      for r in ck["active"].reshape(-1, 6)]
            terminals = [tuple(map(int, r))
                         for r in ck["terminals"].reshape(-1, 6)]
            out_q[:] = ck["out_q"]
            out_s[:] = ck["out_s"]
            rs = int(ck["root_score"])
            root_score = None if rs == _RS_NONE else rs
            term_done = int(ck["term_done"])

    def _save_level():
        if ckpt is not None:
            ckpt.save(
                active=np.asarray(active, np.int64).reshape(-1, 6),
                terminals=np.asarray(terminals, np.int64).reshape(-1, 6),
                out_q=out_q, out_s=out_s,
                root_score=np.int64(
                    _RS_NONE if root_score is None else root_score
                ),
                term_done=np.int64(term_done),
            )

    from anyseq_tpu.dist import batch as dist_batch  # fetch() on all paths

    if mesh is not None:
        import math

        from anyseq_tpu.dist.sharded import score_pair_sharded

        n_dev = math.prod(mesh.shape.values())
        if sp_min_width is None:
            sp_min_width = 2048 * n_dev

    while active:
        _lt0 = time.perf_counter()
        parts = active
        active = []
        P = len(parts)
        hs = [p[1] - p[0] for p in parts]
        mids = [(p[3] - p[2]) // 2 for p in parts]

        if mesh is not None and P <= 4 and min(mids) >= sp_min_width:
            # Wide halves: subject-sharded Gotoh wavefront per half over
            # the whole mesh (H and E last columns; start_gap per
            # crossing flag); one fetch per level.
            cols_dev = []
            for p, (qlo, qhi, slo, shi, sg, eg) in enumerate(parts):
                h, mid = hs[p], mids[p]
                for (qa, sa, fl) in (
                    (q8[qlo:qhi], s8[slo:slo + mid], sg),
                    (q8[qlo:qhi][::-1], s8[slo + mid:shi][::-1], eg),
                ):
                    outs = score_pair_sharded(
                        np.ascontiguousarray(qa),
                        np.ascontiguousarray(sa),
                        Mode.GLOBAL, sc, mesh, engine=engine,
                        start_gap=bool(fl),
                    )
                    cols_dev.append((outs["last_col"],
                                     outs["last_col_e"]))
            import jax as _jax

            cols_host = _jax.device_get(cols_dev)
            for p, (qlo, qhi, slo, shi, sg, eg) in enumerate(parts):
                h, mid = hs[p], mids[p]
                HL, EL = cols_host[2 * p]
                HR, ER = cols_host[2 * p + 1]
                k, in_gap, score = _merge_halves_affine(
                    HL[:h].astype(np.int64), EL[:h].astype(np.int64),
                    HR[:h].astype(np.int64), ER[:h].astype(np.int64),
                    h, mid, shi - slo - mid, sc, sg, eg,
                )
                if root_score is None:
                    root_score = score
                classify((qlo, qlo + k + 1, slo, slo + mid, sg, in_gap))
                classify((qlo + k + 1, qhi, slo + mid, shi, in_gap, eg))
            _tlog(f"aff level P={P} maxh={max(hs)} maxmid={max(mids)} "
                  f"path=mesh-sp {(time.perf_counter()-_lt0)*1e3:.0f}ms")
            _save_level()
            continue

        Mb = batch._bucket(max(hs))
        Nb = batch._bucket(max(max(mids), max(
            (p[3] - p[2]) - mi for p, mi in zip(parts, mids)
        )), 128)
        B = 2 * P
        qarr = np.full((B, Mb), PAD_Q, np.int32)
        sarr = np.full((B, Nb), PAD_S, np.int32)
        ms = np.empty(B, np.int32)
        ns = np.empty(B, np.int32)
        sgaps = np.zeros(B, bool)
        for p, (qlo, qhi, slo, shi, sg, eg) in enumerate(parts):
            h, mid = hs[p], mids[p]
            qarr[2 * p, :h] = q32[qlo:qhi]
            qarr[2 * p + 1, :h] = q32[qlo:qhi][::-1]
            sarr[2 * p, :mid] = s32[slo:slo + mid]
            sarr[2 * p + 1, : shi - slo - mid] = s32[slo + mid:shi][::-1]
            ms[2 * p] = ms[2 * p + 1] = h
            ns[2 * p] = mid
            ns[2 * p + 1] = shi - slo - mid
            sgaps[2 * p] = sg       # forward half inherits start flag
            sgaps[2 * p + 1] = eg   # reversed half: end flag -> start
        if mesh is not None:
            cols_h, cols_e = dist_batch.last_cols_batch_affine_sharded(
                jnp.asarray(qarr), jnp.asarray(sarr),
                jnp.asarray(ms), jnp.asarray(ns), sc,
                jnp.asarray(sgaps), mesh,
            )
            cols_h = dist_batch.fetch(cols_h).T    # -> (B, M)
            cols_e = dist_batch.fetch(cols_e).T
        else:
            cols_h, cols_e = _level_cols(
                jnp.asarray(qarr), jnp.asarray(sarr),
                jnp.asarray(ms), jnp.asarray(ns), sc, engine,
                jnp.asarray(sgaps),
            )
            cols_h = np.asarray(cols_h).T          # -> (B, M)
            cols_e = np.asarray(cols_e).T
        for p, (qlo, qhi, slo, shi, sg, eg) in enumerate(parts):
            h, mid = hs[p], mids[p]
            k, in_gap, score = _merge_halves_affine(
                cols_h[2 * p, :h].astype(np.int64),
                cols_e[2 * p, :h].astype(np.int64),
                cols_h[2 * p + 1, :h].astype(np.int64),
                cols_e[2 * p + 1, :h].astype(np.int64),
                h, mid, shi - slo - mid, sc, sg, eg,
            )
            if root_score is None:
                root_score = score
            classify((qlo, qlo + k + 1, slo, slo + mid, sg, in_gap))
            classify((qlo + k + 1, qhi, slo + mid, shi, in_gap, eg))
        _tlog(f"aff level P={P} maxh={max(hs)} maxmid={max(mids)} "
              f"path={'mesh-batch' if mesh is not None else 'batched'} "
              f"{(time.perf_counter()-_lt0)*1e3:.0f}ms")
        _save_level()

    # Terminal stripes, batched by shape bucket (chunk index `ci` is the
    # checkpoint resume unit).
    _tt0 = time.perf_counter()
    from anyseq_tpu.core.types import PRED_GAP_Q
    from anyseq_tpu.engine import tb

    groups: dict[tuple[int, int], list] = {}
    for t in terminals:
        h, w = t[1] - t[0], t[3] - t[2]
        groups.setdefault(
            (batch._bucket(h), batch._bucket(w, 128)), []
        ).append(t)
    ci = -1
    for (Hb, Wb), ts in groups.items():
        for lo in range(0, len(ts), 512):
            ci += 1
            if ci < term_done:
                continue
            chunk = ts[lo: lo + 512]
            B = len(chunk)
            qarr = np.full((B, Hb), PAD_Q, np.int32)
            sarr = np.full((B, Wb), PAD_S, np.int32)
            ms = np.empty(B, np.int32)
            ns = np.empty(B, np.int32)
            sgaps = np.zeros(B, bool)
            egaps = np.zeros(B, bool)
            for b, (qlo, qhi, slo, shi, sg, eg) in enumerate(chunk):
                h, w = qhi - qlo, shi - slo
                qarr[b, :h] = q32[qlo:qhi]
                sarr[b, :w] = s32[slo:shi]
                ms[b] = h
                ns[b] = w
                sgaps[b] = sg
                egaps[b] = eg
            if mesh is not None:
                preds, cols_h, cols_e = dist_batch.preds_batch_affine_sharded(
                    jnp.asarray(qarr), jnp.asarray(sarr),
                    jnp.asarray(ms), jnp.asarray(ns), sc,
                    jnp.asarray(sgaps), mesh,
                )
                preds = dist_batch.fetch(preds)
                cols_h = dist_batch.fetch(cols_h)
                cols_e = dist_batch.fetch(cols_e)
                for b, (qlo, qhi, slo, shi, sg, eg) in enumerate(chunk):
                    h, w = qhi - qlo, shi - slo
                    if (root_score is None
                            and (qhi - qlo, shi - slo) == (m, n)):
                        # The whole problem was one terminal stripe.
                        root_score = int(
                            (cols_e if eg else cols_h)[h - 1, b]
                        )
                    PH, PE, PF = _haloed_affine_preds_mm(
                        preds[b, :h, :w], h, w, sg
                    )
                    if eg:
                        # Start the walk in E state: the path must leave
                        # the stripe's last cell inside a horizontal run.
                        PH[h, w] = PRED_GAP_Q
                    tb.walk_affine(
                        q8[qlo:qhi], s8[slo:shi], PH, PE, PF,
                        (h - 1, w - 1),
                        out_q, out_s, off_i + qlo, off_j + slo,
                    )
            else:
                # Fused pred sweep + on-device 3-state walk: ONE
                # dispatch, ONE fetch of the O(B*(H+W)) aligned strings
                # instead of the dense packed preds and host walks.
                oq, osub, tscores = jax.device_get(
                    batch.preds_walk_batch_affine(
                        jnp.asarray(qarr), jnp.asarray(sarr),
                        jnp.asarray(ms), jnp.asarray(ns), sc,
                        jnp.asarray(sgaps), jnp.asarray(egaps),
                    )
                )
                from anyseq_tpu.core.types import EMPTY_SYM
                for b, (qlo, qhi, slo, shi, sg, eg) in enumerate(chunk):
                    h, w = qhi - qlo, shi - slo
                    if (root_score is None
                            and (qhi - qlo, shi - slo) == (m, n)):
                        root_score = int(tscores[b])
                    base = off_i + qlo + off_j + slo
                    # Copy only walked path positions (EMPTY slots may
                    # belong to other writers of the shared sparse
                    # buffer), exactly as the linear terminal phase.
                    ln = min(h + w, len(out_q) - base)
                    seg_q = oq[b, :ln]
                    seg_s = osub[b, :ln]
                    sel = (seg_q != EMPTY_SYM) | (seg_s != EMPTY_SYM)
                    out_q[base: base + ln][sel] = seg_q[sel]
                    out_s[base: base + ln][sel] = seg_s[sel]
            term_done = ci + 1
            _save_level()
    _tlog(f"aff terminals n={len(terminals)} "
          f"{(time.perf_counter()-_tt0)*1e3:.0f}ms")
    return root_score


def _find_end(q8, s8, mode, scoring, engine, mesh=None):
    """Forward score pass: (score, end position)."""
    from anyseq_tpu.engine import xla_linmem

    outs = _score_outputs(q8, s8, mode, scoring, engine, mesh=mesh)
    return xla_linmem.extract_score_from_outputs(
        outs, len(q8), len(s8), mode, scoring
    )


def align_hirschberg(query, subject, mode, scoring=LinearScoring(),
                     engine="auto", min_width=None, mesh=None,
                     sp_min_width=None, checkpoint_path=None) -> Alignment:
    """Linear-memory alignment construction: Hirschberg for linear gap
    scoring, Myers-Miller for affine (Gotoh). With ``mesh`` the linear
    construction is distributed over the device mesh and bit-identical
    to the single-device result (see :func:`_hb_global`).

    ``checkpoint_path``: durable npz state updated after every completed
    unit of work; a killed run re-invoked with the same arguments resumes
    and produces a byte-identical alignment. A checkpoint from different
    inputs or parameters is rejected. Covers every construction mode:
    GLOBAL saves divide levels + terminal chunks under ``checkpoint_path``
    itself (affine Myers-Miller included); semiglobal/local additionally
    save the endpoint-reduction stages (forward end, reverse start) under
    ``checkpoint_path`` with the rectangle construction state in
    ``checkpoint_path + ".rect"``."""
    mode = Mode.parse(mode)
    affine = isinstance(scoring, AffineScoring)
    q8 = as_u8(query)
    s8 = as_u8(subject)
    m, n = len(q8), len(s8)
    if m == 0 or n == 0:
        raise ValueError("empty sequences are not supported")
    route.check(engine)
    if min_width is None:
        min_width = MIN_WIDTH

    def hb_rect(qr8, sr8, oi, oj):
        rc = None
        if checkpoint_path is not None:
            path = (checkpoint_path if mode is Mode.GLOBAL
                    else checkpoint_path + ".rect")
            rc = _HbCheckpoint(
                path,
                _ckpt_key(qr8, sr8, Mode.GLOBAL, scoring, min_width),
            )
        if affine:
            return _hb_global_affine(qr8, sr8, oi, oj, out_q, out_s,
                                     scoring, engine, min_width, ckpt=rc,
                                     mesh=mesh, sp_min_width=sp_min_width)
        return _hb_global(qr8, sr8, oi, oj, out_q, out_s, scoring,
                          engine, min_width, mesh=mesh,
                          sp_min_width=sp_min_width, ckpt=rc)

    out_q = np.full(m + n, EMPTY_SYM, dtype=np.uint8)
    out_s = np.full(m + n, EMPTY_SYM, dtype=np.uint8)

    if mode is Mode.GLOBAL:
        score = hb_rect(q8, s8, 0, 0)
        return Alignment(score, bytes(out_q), bytes(out_s), (0, 0))

    # semiglobal / local: endpoint reduction to a global sub-rectangle.
    # The two reduction passes are the checkpoint stages for these modes
    # (stage 1 = forward end found, stage 2 = reverse start found); the
    # rectangle construction then has its own level-granular state.
    outer = None
    stage = None
    if checkpoint_path is not None:
        outer = _HbCheckpoint(
            checkpoint_path, _ckpt_key(q8, s8, mode, scoring, min_width)
        )
        ck = outer.load()
        if ck is not None:
            stage = {k: int(ck[k]) for k in
                     ("stage", "score", "ei", "ej", "rscore", "ri", "rj")}

    if stage is not None and stage["stage"] >= 1:
        score, (ei, ej) = stage["score"], (stage["ei"], stage["ej"])
    else:
        _ft0 = time.perf_counter()
        score, end = _find_end(q8, s8, mode, scoring, engine, mesh=mesh)
        _tlog(f"fwd pass {(time.perf_counter()-_ft0)*1e3:.0f}ms")
        ei, ej = end
        if outer is not None:
            outer.save(stage=np.int64(1), score=np.int64(score),
                       ei=np.int64(ei), ej=np.int64(ej),
                       rscore=np.int64(0), ri=np.int64(0),
                       rj=np.int64(0))
    if ei < 0 or ej < 0 or (mode is Mode.LOCAL and score <= 0):
        # Empty alignment (boundary maximum / all-negative local matrix)
        return Alignment(score, bytes(out_q), bytes(out_s), (ei + 1, ej + 1))

    # Reverse pass on the end-prefix finds the start position.
    #
    # local: a plain reverse local pass (symmetric).
    # semiglobal: the reverse problem must pin its start to the original
    # end cell, which means GLOBAL boundary inits with semiglobal-style
    # max-over-last-row/col extraction (free original start on the top/left
    # boundary maps to the reverse matrix's last row/column).
    qr = q8[: ei + 1][::-1]
    sr = s8[: ej + 1][::-1]
    _rt0 = time.perf_counter()
    if stage is not None and stage["stage"] >= 2:
        rscore, ri, rj = stage["rscore"], stage["ri"], stage["rj"]
    elif mode is Mode.LOCAL:
        rscore, rend = _find_end(qr, sr, mode, scoring, engine, mesh=mesh)
        ri, rj = rend
    else:
        outs = _score_outputs(qr, sr, Mode.GLOBAL, scoring, engine,
                              mesh=mesh)
        mr, nr = len(qr), len(sr)
        # Candidates include the -1 boundary entries of the reverse-global
        # matrix (all-gap overlap: H_rev[mr-1][-1] = mr*g, H_rev[-1][nr-1]
        # = nr*g), which can tie the interior maxima when the optimal
        # semiglobal path degenerates to pure gaps. Interior candidates
        # win ties (strict > below) so the picked rectangle is non-empty
        # whenever a non-empty representation of the score exists.
        lrow = outs["last_row"][:nr]
        lcol = outs["last_col"][:mr]
        rj_ = int(np.argmax(lrow))
        rscore = int(lrow[rj_])
        ri, rj = mr - 1, rj_
        ci = int(np.argmax(lcol))
        if int(lcol[ci]) > rscore:
            rscore = int(lcol[ci])
            ri, rj = ci, nr - 1
        def all_gap(L):
            if affine:
                return scoring.gap_open + scoring.gap_extend * L
            return scoring.gap * L

        if all_gap(mr) > rscore:
            rscore = all_gap(mr)
            ri, rj = mr - 1, -1
        if all_gap(nr) > rscore:
            rscore = all_gap(nr)
            ri, rj = -1, nr - 1
    _tlog(f"rev pass {(time.perf_counter()-_rt0)*1e3:.0f}ms")
    if outer is not None and (stage is None or stage["stage"] < 2):
        outer.save(stage=np.int64(2), score=np.int64(score),
                   ei=np.int64(ei), ej=np.int64(ej),
                   rscore=np.int64(rscore), ri=np.int64(ri),
                   rj=np.int64(rj))
    si = ei - ri
    sj = ej - rj
    # si/sj may be ei+1/ej+1 if the reverse max sits on the -1 boundary
    # (empty overlap); the rectangle is then empty.
    sub_q = q8[si: ei + 1]
    sub_s = s8[sj: ej + 1]
    if len(sub_q) == 0 or len(sub_s) == 0:
        return Alignment(score, bytes(out_q), bytes(out_s), (si, sj))
    sub_score = hb_rect(sub_q, sub_s, si, sj)
    if not (sub_score == score == rscore):
        raise RuntimeError(
            f"hirschberg endpoint reduction mismatch: fwd={score} "
            f"rev={rscore} rect={sub_score} (mode={mode}, m={m}, n={n}, "
            f"end=({ei},{ej}), start=({si},{sj})) -- please report"
        )
    return Alignment(score, bytes(out_q), bytes(out_s), (si, sj))
