"""Batched many-pair alignment engine.

The reference aligns exactly one pair per process (main.cpp:180-211); batched
many-pair alignment is a new capability called for by BASELINE.json's
data-parallel config. Design:

* pairs are bucketed by (query, subject) length into padded (B, M), (B, N)
  int32 arrays (distinct symbols pad each side so padding never matches);
* scoring runs as a single jitted row-sweep vectorized over the batch
  dimension: each step relaxes one row of every pair (B x N cells);
* per-pair lengths are traced arrays, so one compilation serves every
  batch of the same bucket shape.

Scores are bit-identical to the single-pair engines (same int32 max-plus
recurrence).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from anyseq_tpu.core.types import (
    PAD_Q,
    PAD_S,
    SCORE_MIN,
    LinearScoring,
    Mode,
    Score,
    as_u8,
)
from anyseq_tpu.engine import route


def _bucket(x: int, mult: int = 256) -> int:
    return max(mult, (x + mult - 1) // mult * mult)


def _stage(chunk, qs, ss, M, N):
    """Pad the pairs ``chunk`` indexes into (B, M) / (B, N) int32 arrays
    plus (B,) length arrays."""
    B = len(chunk)
    qarr = np.full((B, M), PAD_Q, np.int32)
    sarr = np.full((B, N), PAD_S, np.int32)
    ms = np.empty(B, np.int32)
    ns = np.empty(B, np.int32)
    for r, i in enumerate(chunk):
        qarr[r, : len(qs[i])] = qs[i]
        sarr[r, : len(ss[i])] = ss[i]
        ms[r] = len(qs[i])
        ns[r] = len(ss[i])
    return qarr, sarr, ms, ns


def _score_batch(q, s, ms, ns, mode: Mode, sc: LinearScoring):
    """q: (B, M) int32, s: (B, N) int32, ms/ns: (B,) int32 lengths.

    Returns (B,) int32 scores (+ (B,2) end positions for local).

    Row sweep with the same max-plus prefix-scan trick as
    xla_linmem.score_rows, vmapped over the batch; masking handles ragged
    lengths (rows beyond m keep the carry unchanged).

    SEMIGLOBAL is rejected: its score needs max over the last column too,
    which this sweep does not track -- use :func:`_score_batch_semiglobal`
    (``align_scores_batch`` routes there automatically).
    """
    mode = Mode.parse(mode)
    if mode is Mode.SEMIGLOBAL:
        raise ValueError(
            "_score_batch does not support SEMIGLOBAL (needs last-column "
            "tracking); use _score_batch_semiglobal"
        )
    return _score_batch_jit(q, s, ms, ns, mode, sc)


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def _score_batch_jit(q, s, ms, ns, mode: Mode, sc: LinearScoring):
    B, M = q.shape
    N = s.shape[1]
    jg = jnp.arange(N, dtype=Score) * sc.gap  # (N,)
    jidx = jnp.arange(N)

    def init_col(i):
        if mode is Mode.GLOBAL:
            return (i + 1) * sc.gap
        return jnp.zeros_like(i)

    row0 = init_col(jnp.arange(N, dtype=Score))[None, :].repeat(B, 0)

    jmask = jidx[None, :] < ns[:, None]  # (B, N)

    def body(i, carry):
        prev, last_col, best, best_pos = carry
        active = i < ms  # (B,)
        col_i = init_col(jnp.full((B,), i, Score))
        col_im1 = init_col(jnp.full((B,), i - 1, Score))
        diag = jnp.concatenate([col_im1[:, None], prev[:, :-1]], axis=1)
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )  # (B,1)
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        cand = jnp.maximum(diag + sub, prev + sc.gap)
        if mode is Mode.LOCAL:
            cand = jnp.maximum(cand, 0)
        run = jnp.maximum(
            jax.lax.cummax(cand - jg[None, :], axis=1),
            (col_i + sc.gap)[:, None],
        )
        row = run + jg[None, :]
        row = jnp.where(active[:, None], row, prev)

        lc = jnp.take_along_axis(row, (ns - 1)[:, None], axis=1)[:, 0]
        last_col = jnp.where(active, lc, last_col)
        # per-pair last_col history replaced by running semiglobal max below
        masked = jnp.where(jmask, row, SCORE_MIN)
        rmax = jnp.max(masked, axis=1)
        rarg = jnp.argmax(masked, axis=1).astype(Score)
        take = jnp.logical_and(active, rmax > best)
        best = jnp.where(take, rmax, best)
        best_pos = jnp.where(
            take[:, None],
            jnp.stack([jnp.full((B,), i, Score), rarg], axis=1),
            best_pos,
        )
        return row, last_col, best, best_pos

    init = (
        row0,
        jnp.full((B,), SCORE_MIN, Score),
        jnp.full((B,), SCORE_MIN, Score),
        jnp.full((B, 2), -1, Score),
    )
    last_row_f, _, best, best_pos = jax.lax.fori_loop(
        0, jnp.max(ms), body, init
    )

    if mode is Mode.GLOBAL:
        # H[m-1][n-1] = value of the final row at column n-1
        score = jnp.take_along_axis(last_row_f, (ns - 1)[:, None], axis=1)[:, 0]
        return score, best_pos
    return jnp.maximum(best, 0), best_pos  # LOCAL


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def _score_batch_semiglobal(q, s, ms, ns, mode: Mode, sc: LinearScoring):
    """Semiglobal needs max over last row AND last column; track the
    column max during the sweep."""
    B, M = q.shape
    N = s.shape[1]
    jg = jnp.arange(N, dtype=Score) * sc.gap
    jidx = jnp.arange(N)
    row0 = jnp.zeros((B, N), Score)
    jmask = jidx[None, :] < ns[:, None]

    def body(i, carry):
        prev, col_max = carry
        active = i < ms
        diag = jnp.concatenate(
            [jnp.zeros((B, 1), Score), prev[:, :-1]], axis=1
        )
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        cand = jnp.maximum(diag + sub, prev + sc.gap)
        run = jnp.maximum(jax.lax.cummax(cand - jg[None, :], axis=1),
                          jnp.full((B, 1), sc.gap, Score))
        row = run + jg[None, :]
        row = jnp.where(active[:, None], row, prev)
        lc = jnp.take_along_axis(row, (ns - 1)[:, None], axis=1)[:, 0]
        col_max = jnp.where(active, jnp.maximum(col_max, lc), col_max)
        return row, col_max

    last_row, col_max = jax.lax.fori_loop(
        0, jnp.max(ms), body, (row0, jnp.full((B,), SCORE_MIN, Score))
    )
    lr = jnp.where(jmask, last_row, SCORE_MIN)
    row_max = jnp.max(lr, axis=1)
    # boundary candidates (empty overlap) are 0 for semiglobal
    return jnp.maximum(jnp.maximum(row_max, col_max), 0)


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def _score_batch_affine(q, s, ms, ns, mode: Mode, sc):
    """Batched Gotoh (affine-gap) scores for all three modes in one sweep.

    Same batched row-sweep architecture as :func:`_score_batch` with the
    extra E prefix-scan of engine/xla_affine.score_rows_affine (the affine
    upgrade is one more ``lax.cummax`` per row, not a sequential loop).
    Score extraction matches xla_linmem.extract_score_from_outputs:
    GLOBAL = H[m-1][n-1]; SEMIGLOBAL = max(last row, last column, 0
    empty-overlap boundary); LOCAL = running clamped max.
    """
    from anyseq_tpu.engine.xla_affine import NEG

    B, M = q.shape
    N = s.shape[1]
    go, ge = sc.gap_open, sc.gap_extend
    jge = jnp.arange(N, dtype=Score) * ge
    jmask = jnp.arange(N)[None, :] < ns[:, None]

    if mode is Mode.GLOBAL:
        row0 = (go + (jnp.arange(N, dtype=Score) + 1) * ge)[None, :].repeat(
            B, 0
        )
    else:
        row0 = jnp.zeros((B, N), Score)

    def col_bound(i):
        # H[i][-1] per pair; i is (B,) int32 (corner H[-1][-1] = 0)
        if mode is Mode.GLOBAL:
            return jnp.where(i < 0, 0, go + (i + 1) * ge).astype(Score)
        return jnp.zeros_like(i, Score)

    def body(i, carry):
        H_prev, F_prev, col_max, best = carry
        active = i < ms
        ib = jnp.full((B,), i, Score)
        col_i = col_bound(ib)
        col_im1 = col_bound(ib - 1)
        F = jnp.maximum(H_prev + (go + ge), F_prev + ge)
        diag = jnp.concatenate([col_im1[:, None], H_prev[:, :-1]], axis=1)
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        T = jnp.maximum(diag + sub, F)
        if mode is Mode.LOCAL:
            T = jnp.maximum(T, 0)
        cm = jax.lax.cummax(T - jge[None, :], axis=1)
        E = go + jge[None, :] + jnp.maximum(
            jnp.concatenate(
                [jnp.full((B, 1), NEG, Score), cm[:, :-1]], axis=1
            ),
            (col_i + ge)[:, None],
        )
        H = jnp.maximum(T, E)
        H = jnp.where(active[:, None], H, H_prev)
        F = jnp.where(active[:, None], F, F_prev)
        lc = jnp.take_along_axis(H, (ns - 1)[:, None], axis=1)[:, 0]
        col_max = jnp.where(active, jnp.maximum(col_max, lc), col_max)
        if mode is Mode.LOCAL:
            rmax = jnp.max(jnp.where(jmask, H, SCORE_MIN), axis=1)
            best = jnp.where(active, jnp.maximum(best, rmax), best)
        return H, F, col_max, best

    init = (
        row0,
        jnp.full((B, N), NEG, Score),
        jnp.full((B,), SCORE_MIN, Score),
        jnp.full((B,), SCORE_MIN, Score),
    )
    last_row, _, col_max, best = jax.lax.fori_loop(0, jnp.max(ms), body, init)

    if mode is Mode.GLOBAL:
        return jnp.take_along_axis(last_row, (ns - 1)[:, None], axis=1)[:, 0]
    if mode is Mode.SEMIGLOBAL:
        row_max = jnp.max(jnp.where(jmask, last_row, SCORE_MIN), axis=1)
        return jnp.maximum(jnp.maximum(row_max, col_max), 0)
    return jnp.maximum(best, 0)  # LOCAL


@functools.partial(jax.jit, static_argnames=("sc",))
def last_cols_batch(q, s, ms, ns, sc: LinearScoring):
    """Global-DP boundary columns for a batch of pairs, in one sweep.

    q: (B, M) int32, s: (B, N) int32, ms/ns: (B,) lengths.
    Returns (M, B) int32: entry [i, b] = H_b[i][ns_b - 1] (garbage for
    i >= ms_b). This is the one device call per Hirschberg level: every
    forward left half and reversed right half of the level is a row of
    the batch (reference runs them as one partitioned wavefront,
    iteration_cpu.impala:59-119)."""
    B, M = q.shape
    N = s.shape[1]
    g = sc.gap
    jg = jnp.arange(N, dtype=Score) * g

    row0 = ((jnp.arange(N, dtype=Score) + 1) * g)[None, :].repeat(B, 0)

    def body(i, carry):
        prev, cols = carry
        active = i < ms
        diag = jnp.concatenate(
            [jnp.full((B, 1), i * g, Score), prev[:, :-1]], axis=1
        )
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        cand = jnp.maximum(diag + sub, prev + g)
        run = jnp.maximum(
            jax.lax.cummax(cand - jg[None, :], axis=1),
            jnp.full((B, 1), (i + 2) * g, Score),  # col_i + g
        )
        row = run + jg[None, :]
        row = jnp.where(active[:, None], row, prev)
        lc = jnp.take_along_axis(row, (ns - 1)[:, None], axis=1)[:, 0]
        cols = jax.lax.dynamic_update_slice(cols, lc[None, :], (i, 0))
        return row, cols

    _, cols = jax.lax.fori_loop(
        0, jnp.max(ms), body, (row0, jnp.zeros((M, B), Score))
    )
    return cols


@functools.partial(jax.jit, static_argnames=("sc",))
def preds_batch(q, s, ms, ns, sc: LinearScoring):
    """Global-DP predecessor matrices for a batch of pairs, one sweep.

    Returns ((B, M, N) uint8 preds, (M, B) int32 last columns). Used for
    the terminal stripes of the level-synchronous Hirschberg (reference
    predecessors_blockwise + iteration_blockwise, predecessors.impala:
    36-46, iteration_cpu.impala:121-157). Predecessor priority is
    diag > gap_q > gap_s (align.impala:49-64)."""
    from anyseq_tpu.core.types import (
        PRED_GAP_Q, PRED_GAP_S, PRED_NO_GAP, PRED_NONE,
    )

    B, M = q.shape
    N = s.shape[1]
    g = sc.gap
    jg = jnp.arange(N, dtype=Score) * g

    row0 = ((jnp.arange(N, dtype=Score) + 1) * g)[None, :].repeat(B, 0)

    def body(i, carry):
        prev, preds, cols = carry
        active = i < ms
        col_i = jnp.full((B, 1), (i + 1) * g, Score)
        diag = jnp.concatenate(
            [jnp.full((B, 1), i * g, Score), prev[:, :-1]], axis=1
        )
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        cand = jnp.maximum(diag + sub, prev + g)
        run = jnp.maximum(
            jax.lax.cummax(cand - jg[None, :], axis=1), col_i + g
        )
        row = run + jg[None, :]
        left = jnp.concatenate([col_i, row[:, :-1]], axis=1)
        pred = jnp.where(
            row == diag + sub,
            PRED_NO_GAP,
            jnp.where(
                row == left + g,
                PRED_GAP_Q,
                jnp.where(row == prev + g, PRED_GAP_S, PRED_NONE),
            ),
        ).astype(jnp.uint8)
        row = jnp.where(active[:, None], row, prev)
        preds = jax.lax.dynamic_update_slice(
            preds, pred[:, None, :], (0, i, 0)
        )
        lc = jnp.take_along_axis(row, (ns - 1)[:, None], axis=1)[:, 0]
        cols = jax.lax.dynamic_update_slice(cols, lc[None, :], (i, 0))
        return row, preds, cols

    _, preds, cols = jax.lax.fori_loop(
        0, jnp.max(ms), body,
        (row0, jnp.zeros((B, M, N), jnp.uint8), jnp.zeros((M, B), Score)),
    )
    return preds, cols


@functools.partial(jax.jit, static_argnames=("sc",))
def last_cols_batch_affine(q, s, ms, ns, sc, sgap):
    """Global affine (Gotoh) boundary columns for a batch of pairs.

    q: (B, M) int32, s: (B, N) int32, ms/ns: (B,) lengths, sgap: (B,)
    bool -- per-pair Myers-Miller start-in-gap flag (the pair's top
    boundary row continues a horizontal gap run paid by the caller: init
    row drops gap_open, corner and left column are unreachable; see
    engine/xla_affine.score_rows_affine).

    Returns ((M, B) H columns, (M, B) E columns): entry [i, b] =
    H_b[i][ns_b - 1] / E_b[i][ns_b - 1]. One device call per
    Myers-Miller level (the affine analog of last_cols_batch).
    """
    from anyseq_tpu.engine.xla_affine import NEG

    B, M = q.shape
    N = s.shape[1]
    go, ge = sc.gap_open, sc.gap_extend
    jge = jnp.arange(N, dtype=Score) * ge

    row0 = ((jnp.arange(N, dtype=Score) + 1) * ge)[None, :] + jnp.where(
        sgap, 0, go
    )[:, None].astype(Score)

    def body(i, carry):
        H_prev, F_prev, cols_h, cols_e = carry
        active = i < ms
        col_i = jnp.where(sgap, NEG, go + (i + 1) * ge).astype(Score)
        col_im1 = jnp.where(
            sgap, NEG, jnp.where(i == 0, 0, go + i * ge)
        ).astype(Score)
        F = jnp.maximum(H_prev + (go + ge), F_prev + ge)
        diag = jnp.concatenate([col_im1[:, None], H_prev[:, :-1]], axis=1)
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        T = jnp.maximum(diag + sub, F)
        cm = jax.lax.cummax(T - jge[None, :], axis=1)
        E = go + jge[None, :] + jnp.maximum(
            jnp.concatenate(
                [jnp.full((B, 1), NEG, Score), cm[:, :-1]], axis=1
            ),
            (col_i + ge)[:, None],
        )
        H = jnp.maximum(T, E)
        H = jnp.where(active[:, None], H, H_prev)
        F = jnp.where(active[:, None], F, F_prev)
        lh = jnp.take_along_axis(H, (ns - 1)[:, None], axis=1)[:, 0]
        le = jnp.take_along_axis(E, (ns - 1)[:, None], axis=1)[:, 0]
        cols_h = jax.lax.dynamic_update_slice(cols_h, lh[None, :], (i, 0))
        cols_e = jax.lax.dynamic_update_slice(cols_e, le[None, :], (i, 0))
        return H, F, cols_h, cols_e

    init = (
        row0,
        jnp.full((B, N), NEG, Score),
        jnp.zeros((M, B), Score),
        jnp.full((M, B), NEG, Score),
    )
    _, _, cols_h, cols_e = jax.lax.fori_loop(0, jnp.max(ms), body, init)
    return cols_h, cols_e


@functools.partial(jax.jit, static_argnames=("sc",))
def preds_batch_affine(q, s, ms, ns, sc, sgap):
    """Global affine predecessor matrices for a batch (terminal stripes
    of the Myers-Miller construction). Packing as
    xla_affine.score_rows_affine_with_preds: bits 0-1 PH, bit 2 PE
    extend, bit 3 PF extend. Returns ((B, M, N) uint8, (M, B) H cols,
    (M, B) E cols)."""
    from anyseq_tpu.core.types import (
        PRED_GAP_Q, PRED_GAP_S, PRED_NO_GAP, PRED_NONE,
    )
    from anyseq_tpu.engine.xla_affine import NEG

    B, M = q.shape
    N = s.shape[1]
    go, ge = sc.gap_open, sc.gap_extend
    jge = jnp.arange(N, dtype=Score) * ge

    row0 = ((jnp.arange(N, dtype=Score) + 1) * ge)[None, :] + jnp.where(
        sgap, 0, go
    )[:, None].astype(Score)

    def body(i, carry):
        H_prev, F_prev, preds, cols_h, cols_e = carry
        active = i < ms
        col_i = jnp.where(sgap, NEG, go + (i + 1) * ge).astype(Score)
        col_im1 = jnp.where(
            sgap, NEG, jnp.where(i == 0, 0, go + i * ge)
        ).astype(Score)
        F = jnp.maximum(H_prev + (go + ge), F_prev + ge)
        diag = jnp.concatenate([col_im1[:, None], H_prev[:, :-1]], axis=1)
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        T = jnp.maximum(diag + sub, F)
        cm = jax.lax.cummax(T - jge[None, :], axis=1)
        E = go + jge[None, :] + jnp.maximum(
            jnp.concatenate(
                [jnp.full((B, 1), NEG, Score), cm[:, :-1]], axis=1
            ),
            (col_i + ge)[:, None],
        )
        H = jnp.maximum(T, E)
        ph = jnp.where(
            H == diag + sub,
            PRED_NO_GAP,
            jnp.where(
                H == E,
                PRED_GAP_Q,
                jnp.where(H == F, PRED_GAP_S, PRED_NONE),
            ),
        )
        h_left = jnp.concatenate([col_i[:, None], H[:, :-1]], axis=1)
        pe = jnp.where(E == h_left + (go + ge), 0, 1)
        pf = jnp.where(F == H_prev + (go + ge), 0, 1)
        packed = (ph + pe * 4 + pf * 8).astype(jnp.uint8)
        preds = jax.lax.dynamic_update_slice(
            preds, packed[:, None, :], (0, i, 0)
        )
        H = jnp.where(active[:, None], H, H_prev)
        F = jnp.where(active[:, None], F, F_prev)
        lh = jnp.take_along_axis(H, (ns - 1)[:, None], axis=1)[:, 0]
        le = jnp.take_along_axis(E, (ns - 1)[:, None], axis=1)[:, 0]
        cols_h = jax.lax.dynamic_update_slice(cols_h, lh[None, :], (i, 0))
        cols_e = jax.lax.dynamic_update_slice(cols_e, le[None, :], (i, 0))
        return H, F, preds, cols_h, cols_e

    init = (
        row0,
        jnp.full((B, N), NEG, Score),
        jnp.zeros((B, M, N), jnp.uint8),
        jnp.zeros((M, B), Score),
        jnp.full((M, B), NEG, Score),
    )
    _, _, preds, cols_h, cols_e = jax.lax.fori_loop(
        0, jnp.max(ms), body, init
    )
    return preds, cols_h, cols_e


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def preds_batch_full(q, s, ms, ns, mode: Mode, sc: LinearScoring):
    """Batched analog of xla_linmem.score_rows_with_preds for any scheme:
    one sweep emits per-pair predecessor matrices plus the outputs needed
    for score/end extraction.

    Returns (preds (B,M,N) uint8, last_row (B,N), last_col (B,M),
    best (B,3)); feed each pair's slice to
    xla_linmem.extract_score_from_outputs. Many-pair construction is a
    new capability (the reference aligns one pair per process,
    main.cpp:180-211); the per-part traceback parallelism analog is
    iteration_cpu.impala:159-173."""
    from anyseq_tpu.core.types import (
        PRED_GAP_Q, PRED_GAP_S, PRED_NO_GAP, PRED_NONE,
    )

    B, M = q.shape
    N = s.shape[1]
    g = sc.gap
    jg = jnp.arange(N, dtype=Score) * g
    jidx = jnp.arange(N)
    jmask = jidx[None, :] < ns[:, None]

    def init_col(i):
        if mode is Mode.GLOBAL:
            return (i + 1) * g
        return jnp.zeros_like(i)

    row0 = init_col(jnp.arange(N, dtype=Score))[None, :].repeat(B, 0)

    def body(i, carry):
        prev, preds, last_col, best, best_pos = carry
        active = i < ms
        col_i = init_col(jnp.full((B,), i, Score))
        col_im1 = init_col(jnp.full((B,), i - 1, Score))
        diag = jnp.concatenate([col_im1[:, None], prev[:, :-1]], axis=1)
        qi = jnp.take_along_axis(
            q, jnp.minimum(i, ms - 1)[:, None].astype(jnp.int32), axis=1
        )
        sub = jnp.where(qi == s, sc.match, sc.mismatch).astype(Score)
        cand = jnp.maximum(diag + sub, prev + g)
        if mode is Mode.LOCAL:
            cand = jnp.maximum(cand, 0)
        run = jnp.maximum(
            jax.lax.cummax(cand - jg[None, :], axis=1),
            (col_i + g)[:, None],
        )
        row = run + jg[None, :]
        left = jnp.concatenate([col_i[:, None], row[:, :-1]], axis=1)
        pred = jnp.where(
            row == diag + sub,
            PRED_NO_GAP,
            jnp.where(
                row == left + g,
                PRED_GAP_Q,
                jnp.where(row == prev + g, PRED_GAP_S, PRED_NONE),
            ),
        ).astype(jnp.uint8)
        row = jnp.where(active[:, None], row, prev)
        preds = jax.lax.dynamic_update_slice(
            preds, pred[:, None, :], (0, i, 0)
        )
        lc = jnp.take_along_axis(row, (ns - 1)[:, None], axis=1)[:, 0]
        last_col = jax.lax.dynamic_update_slice(
            last_col, jnp.where(active, lc, SCORE_MIN)[:, None], (0, i)
        )
        masked = jnp.where(jmask, row, SCORE_MIN)
        rmax = jnp.max(masked, axis=1)
        rarg = jnp.argmax(masked, axis=1).astype(Score)
        take = jnp.logical_and(active, rmax > best)
        best = jnp.where(take, rmax, best)
        best_pos = jnp.where(
            take[:, None],
            jnp.stack([jnp.full((B,), i, Score), rarg], axis=1),
            best_pos,
        )
        return row, preds, last_col, best, best_pos

    init = (
        row0,
        jnp.zeros((B, M, N), jnp.uint8),
        jnp.full((B, M), SCORE_MIN, Score),
        jnp.full((B,), SCORE_MIN, Score),
        jnp.full((B, 2), -1, Score),
    )
    last_row, preds, last_col, best, best_pos = jax.lax.fori_loop(
        0, jnp.max(ms), body, init
    )
    best3 = jnp.concatenate([best[:, None], best_pos], axis=1)
    return preds, last_row, last_col, best3


def align_batch(queries, subjects, mode="global", scoring=LinearScoring(),
                batch_size: int = 256, mesh=None, engine="auto"):
    """Construct alignments for many pairs (BASELINE's 10k-pair
    data-parallel config, now with alignments rather than scores only --
    VERDICT r1 item 6).

    Returns a list of Alignment in input order. Pairs are bucketed by
    padded shape; each bucket runs one batched XLA predecessor sweep
    (:func:`preds_batch_full`) and host walks. With ``mesh``, each batch
    sweep is distributed over all devices via an explicit shard_map
    (dist/batch.py). Affine scoring runs per-pair Myers-Miller.
    """
    from anyseq_tpu.core.types import AffineScoring, Alignment, EMPTY_SYM
    from anyseq_tpu.engine import api, tb, xla_linmem

    route.check(engine)
    mode = Mode.parse(mode)
    qs = [as_u8(x) for x in queries]
    ss = [as_u8(x) for x in subjects]
    if len(qs) != len(ss):
        raise ValueError("queries and subjects must have equal length")
    if isinstance(scoring, AffineScoring):
        return [api.align(a, b, mode, scoring) for a, b in zip(qs, ss)]
    out: list = [None] * len(qs)

    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (a, b) in enumerate(zip(qs, ss)):
        if len(a) == 0 or len(b) == 0:
            raise ValueError("empty sequences are not supported")
        key = (_bucket(len(a)), _bucket(len(b)))
        buckets.setdefault(key, []).append(idx)

    for (M, N), idxs in buckets.items():
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo: lo + batch_size]
            B = len(chunk)
            qarr, sarr, ms, ns = _stage(chunk, qs, ss, M, N)
            args = (jnp.asarray(qarr), jnp.asarray(sarr),
                    jnp.asarray(ms), jnp.asarray(ns))
            if mesh is not None:
                from anyseq_tpu.dist import batch as dist_batch

                preds, last_row, last_col, best = (
                    dist_batch.preds_batch_full_sharded(
                        *args, mode, scoring, mesh
                    )
                )
            else:
                preds, last_row, last_col, best = preds_batch_full(
                    *args, mode, scoring
                )
            preds = np.asarray(preds)
            last_row = np.asarray(last_row)
            last_col = np.asarray(last_col)
            best = np.asarray(best)
            for r, i in enumerate(chunk):
                m_i, n_i = int(ms[r]), int(ns[r])
                score, end = xla_linmem.extract_score_from_outputs(
                    {
                        "last_row": last_row[r],
                        "last_col": last_col[r],
                        "best": best[r],
                    },
                    m_i, n_i, mode, scoring,
                )
                out_q = np.full(m_i + n_i, EMPTY_SYM, dtype=np.uint8)
                out_s = np.full(m_i + n_i, EMPTY_SYM, dtype=np.uint8)
                if mode is Mode.LOCAL and score <= 0:
                    start = (end[0] + 1, end[1] + 1)
                else:
                    P = api._haloed_preds(
                        preds[r, :m_i, :n_i], m_i, n_i, mode
                    )
                    start = tb.walk_linear(
                        qs[i], ss[i], P, end, out_q, out_s
                    )
                out[i] = Alignment(
                    score, bytes(out_q), bytes(out_s), tuple(start)
                )
    return out


def align_scores_batch(queries, subjects, mode="global",
                       scoring=LinearScoring(), batch_size: int = 512,
                       engine="auto"):
    """Score many pairs. queries/subjects: sequences of str/bytes/uint8.

    Returns np.ndarray of int64 scores, one per pair. Pairs are
    internally grouped into shape buckets; order is preserved. Each
    bucket chunk is one batched sweep: the kernel where the router sends
    batches (engine/route.py), else the batched XLA row sweep."""
    from anyseq_tpu.core.types import AffineScoring

    route.check(engine)
    mode = Mode.parse(mode)
    qs = [as_u8(x) for x in queries]
    ss = [as_u8(x) for x in subjects]
    if len(qs) != len(ss):
        raise ValueError("queries and subjects must have equal length")
    n_pairs = len(qs)
    out = np.zeros(n_pairs, dtype=np.int64)

    # bucket by padded shape
    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (a, b) in enumerate(zip(qs, ss)):
        if len(a) == 0 or len(b) == 0:
            raise ValueError("empty sequences are not supported")
        key = (_bucket(len(a)), _bucket(len(b)))
        buckets.setdefault(key, []).append(idx)

    for (M, N), idxs in buckets.items():
        kernel = route.use_kernel("batch", engine, M)
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo: lo + batch_size]
            args = tuple(jnp.asarray(a)
                         for a in _stage(chunk, qs, ss, M, N))
            if kernel:
                from anyseq_tpu.kernels import sweep

                scores = sweep.scores_batch(*args, mode, scoring)
            elif isinstance(scoring, AffineScoring):
                scores = _score_batch_affine(*args, mode, scoring)
            elif mode is Mode.SEMIGLOBAL:
                scores = _score_batch_semiglobal(*args, mode, scoring)
            else:
                scores, _ = _score_batch(*args, mode, scoring)
            out[np.asarray(chunk)] = np.asarray(scores)
    return out


@functools.partial(jax.jit, static_argnames=("sc",))
def preds_walk_batch(q, s, ms, ns, sc):
    """Terminal-stripe pred sweep + on-device batched walk fused in ONE
    jitted call (one dispatch, one fetch). Returns (out_q, out_s)."""
    preds, _ = preds_batch(q, s, ms, ns, sc)
    return walk_batch(preds, q, s, ms, ns)


@jax.jit
def walk_batch(preds, q, s, ms, ns):
    """On-device batched GLOBAL traceback walk over dense predecessor
    matrices -- the terminal-stripe phase of the level-synchronous
    Hirschberg without the O(B*M*N) pred fetch (reference analog:
    iteration_tb's per-part walks, iteration_cpu.impala:159-173, which
    run after a full pred D2H copy; here only the O(B*(M+N)) aligned
    strings leave the device).

    preds: (B, M, N) uint8 (unhaloed); q: (B, M) int32; s: (B, N) int32;
    ms/ns: (B,) true lengths. Returns (out_q, out_s): (B, M+N+1) uint8
    prefilled EMPTY_SYM, the walked pair of cell (i, j) written at
    position i + j + 1 with '_' gaps (traceback.impala:47-80 semantics;
    the GLOBAL halo is applied arithmetically: i < 0 -> PRED_GAP_Q,
    j < 0 -> PRED_GAP_S, both -> PRED_NONE)."""
    ends = jnp.stack([ms.astype(jnp.int32) - 1,
                      ns.astype(jnp.int32) - 1], axis=1)
    oq, os_, _ = walk_batch_ends(preds, q, s, ms, ns, ends, Mode.GLOBAL)
    return oq, os_


@functools.partial(jax.jit, static_argnames=("mode",))
def walk_batch_ends(preds, q, s, ms, ns, ends, mode: Mode):
    """Mode-aware batched device walk from per-problem END cells
    (semiglobal/local construction: the walk starts at the extraction
    end, halo cells are PRED_NONE outside GLOBAL -- reference
    predecessors.impala:11-34). ``ends``: (B, 2) int32; a (-1, -1) end
    yields a dead walk (empty strings, start = (0, 0)).

    The walk runs as a ``lax.scan`` whose per-step outputs are the
    (pos, sym_q, sym_s) rows, placed by ONE batched scatter at the end
    (path positions strictly decrease, so updates never collide), rather
    than a scatter per step into a loop-carried buffer."""
    from anyseq_tpu.core.types import (
        EMPTY_SYM, GAP_SYM, PRED_GAP_Q, PRED_GAP_S, PRED_NO_GAP,
        PRED_NONE,
    )

    is_global = mode is Mode.GLOBAL
    B, M, N = preds.shape
    L = M + N + 1
    steps = M + N
    flat = preds.reshape(B, M * N)
    ms = ms.astype(jnp.int32)
    ns = ns.astype(jnp.int32)
    barange = jnp.arange(B)

    def code_at(i, j):
        # (B,) gather; halo cells resolve arithmetically
        interior = jnp.take_along_axis(
            flat,
            (jnp.maximum(i, 0) * N + jnp.maximum(j, 0))[:, None],
            axis=1,
        )[:, 0].astype(jnp.int32)
        if is_global:
            bdy = jnp.where(
                jnp.logical_and(i < 0, j < 0),
                PRED_NONE,
                jnp.where(i < 0, PRED_GAP_Q, PRED_GAP_S),
            )
        else:
            bdy = jnp.full((B,), PRED_NONE, jnp.int32)
        return jnp.where(jnp.logical_or(i < 0, j < 0), bdy, interior)

    def body(st, _):
        i, j = st
        code = code_at(i, j)
        live = code != PRED_NONE
        takes_q = jnp.logical_or(code == PRED_NO_GAP, code == PRED_GAP_S)
        takes_s = jnp.logical_or(code == PRED_NO_GAP, code == PRED_GAP_Q)
        sym_q = jnp.where(
            takes_q,
            jnp.take_along_axis(
                q, jnp.maximum(i, 0)[:, None], axis=1)[:, 0]
            .astype(jnp.int32),
            jnp.int32(GAP_SYM),
        )
        sym_s = jnp.where(
            takes_s,
            jnp.take_along_axis(
                s, jnp.maximum(j, 0)[:, None], axis=1)[:, 0]
            .astype(jnp.int32),
            jnp.int32(GAP_SYM),
        )
        pos = jnp.where(live, i + j + 1, L - 1)
        i = i - jnp.logical_and(live, takes_q).astype(jnp.int32)
        j = j - jnp.logical_and(live, takes_s).astype(jnp.int32)
        return (i, j), (pos, sym_q.astype(jnp.uint8),
                        sym_s.astype(jnp.uint8))

    (i, j), (posb, sqb, ssb) = jax.lax.scan(
        body,
        (ends[:, 0].astype(jnp.int32), ends[:, 1].astype(jnp.int32)),
        None, length=steps,
    )

    oq0 = jnp.full((B, L), EMPTY_SYM, jnp.uint8)
    oq = oq0.at[barange[None, :], posb].set(sqb)
    os_ = oq0.at[barange[None, :], posb].set(ssb)
    oq = oq.at[:, L - 1].set(EMPTY_SYM)
    os_ = os_.at[:, L - 1].set(EMPTY_SYM)
    starts = jnp.stack([i + 1, j + 1], axis=1)
    return oq, os_, starts


@functools.partial(jax.jit, static_argnames=("sc",))
def preds_walk_batch_affine(q, s, ms, ns, sc, sgap, egap):
    """Affine terminal stripes: pred sweep + on-device batched 3-state
    walk fused in ONE jitted call (the Myers-Miller terminal phase
    without the O(B*M*N) packed-pred fetch; linear analog:
    preds_walk_batch). Returns (out_q, out_s, scores) where scores[b]
    is the stripe's global affine score read from the H (or, when the
    path must leave the stripe inside a horizontal run, E) boundary
    column -- the root score when the whole problem is one terminal."""
    preds, cols_h, cols_e = preds_batch_affine(q, s, ms, ns, sc, sgap)
    oq, os_, _ = walk_batch_affine(preds, q, s, ms, ns, sgap, egap)
    barange = jnp.arange(q.shape[0])
    hm = (ms - 1).astype(jnp.int32)
    scores = jnp.where(egap, cols_e[hm, barange], cols_h[hm, barange])
    return oq, os_, scores


@jax.jit
def walk_batch_affine(preds, q, s, ms, ns, sgap, egap):
    """On-device batched affine (Gotoh) 3-state traceback walk over
    packed predecessor planes (bits 0-1 PH, bit 2 PE-extend, bit 3
    PF-extend; preds_batch_affine packing) with the Myers-Miller
    terminal halo applied arithmetically (host analog:
    hirschberg._haloed_affine_preds_mm feeding
    ref/oracle_affine.traceback_affine):

      i < 0 -> PH = PRED_GAP_Q; PE = 1 if sgap else (j >= 1); PF = 0
      j < 0 -> PH = PRED_GAP_S; PE = 0; PF = (i >= 1)
      both  -> walk ends

    ``egap`` starts the walk inside a horizontal run (E state) -- the
    device form of the host path's PH[h, w] = PRED_GAP_Q injection.
    State transitions are fused with their first gap emission (the host
    walk spends a no-write iteration switching state), so every live
    step writes exactly one output position and the walk finishes
    within M + N steps. Output convention as walk_batch_ends: (B, L)
    uint8 sparse buffers, cell (i, j) at position i + j + 1, '_' gaps.
    Returns (out_q, out_s, starts)."""
    from anyseq_tpu.core.types import (
        EMPTY_SYM, GAP_SYM, PRED_GAP_Q, PRED_GAP_S, PRED_NO_GAP,
        PRED_NONE,
    )

    B, M, N = preds.shape
    L = M + N + 1
    steps = M + N
    flat = preds.reshape(B, M * N).astype(jnp.int32)
    ms = ms.astype(jnp.int32)
    ns = ns.astype(jnp.int32)
    barange = jnp.arange(B)
    sgap = jnp.asarray(sgap)
    egap = jnp.asarray(egap)

    def body(st, _):
        i, j, state, dead = st
        c = jnp.take_along_axis(
            flat, (jnp.maximum(i, 0) * N + jnp.maximum(j, 0))[:, None],
            axis=1,
        )[:, 0]
        ineg = i < 0
        jneg = j < 0
        ph = jnp.where(
            ineg, PRED_GAP_Q, jnp.where(jneg, PRED_GAP_S, c & 3)
        )
        pe = jnp.where(
            ineg, jnp.where(sgap, 1, (j >= 1).astype(jnp.int32)),
            jnp.where(jneg, 0, (c >> 2) & 1),
        )
        pf = jnp.where(
            jneg, (i >= 1).astype(jnp.int32),
            jnp.where(ineg, 0, (c >> 3) & 1),
        )

        in_h = state == 0
        dead = dead | (ineg & jneg) | (in_h & (ph == PRED_NONE))
        eff = jnp.where(
            in_h, ph, jnp.where(state == 1, PRED_GAP_Q, PRED_GAP_S)
        )
        diag = (~dead) & (eff == PRED_NO_GAP)
        eact = (~dead) & (eff == PRED_GAP_Q)
        fact = (~dead) & (eff == PRED_GAP_S)

        qsym = jnp.take_along_axis(
            q, jnp.maximum(i, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        ssym = jnp.take_along_axis(
            s, jnp.maximum(j, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        sym_q = jnp.where(diag | fact, qsym, jnp.int32(GAP_SYM))
        sym_s = jnp.where(diag | eact, ssym, jnp.int32(GAP_SYM))
        live = diag | eact | fact
        pos = jnp.where(live, i + j + 1, L - 1)
        # next state: diag -> H; E/F stay iff the packed bit says the
        # run EXTENDS past this cell (bit == 1)
        nstate = jnp.where(
            eact & (pe != 0), 1, jnp.where(fact & (pf != 0), 2, 0)
        )
        i = i - (diag | fact).astype(jnp.int32)
        j = j - (diag | eact).astype(jnp.int32)
        state = jnp.where(dead, state, nstate)
        return (i, j, state, dead), (
            pos, sym_q.astype(jnp.uint8), sym_s.astype(jnp.uint8)
        )

    state0 = jnp.where(egap, 1, 0).astype(jnp.int32)
    (i, j, _, _), (posb, sqb, ssb) = jax.lax.scan(
        body,
        (ms - 1, ns - 1, state0, jnp.zeros(B, bool)),
        None, length=steps,
    )
    oq0 = jnp.full((B, L), EMPTY_SYM, jnp.uint8)
    oq = oq0.at[barange[None, :], posb].set(sqb)
    os_ = oq0.at[barange[None, :], posb].set(ssb)
    oq = oq.at[:, L - 1].set(EMPTY_SYM)
    os_ = os_.at[:, L - 1].set(EMPTY_SYM)
    starts = jnp.stack([i + 1, j + 1], axis=1)
    return oq, os_, starts
