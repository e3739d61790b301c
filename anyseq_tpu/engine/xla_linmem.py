"""Portable linear-memory scoring engine in pure XLA.

Row-vector reformulation of the DP recurrence: instead of the reference's
cell-antidiagonal wavefront (src/iteration_cpu.impala:15-57), each DP row is
computed as one vector operation using the max-plus prefix-scan identity.

For linear gap penalty g <= 0 the within-row dependency

    H[i][j] = max(C[j], H[i][j-1] + g),   C[j] = max(diag + sub, up + g [, 0])

has the closed form

    H[i][j] = j*g + max( cummax_k<=j ( C[k] - k*g ),  col_i + g )

where ``col_i`` is the boundary H[i][-1]. The clamp-at-zero of local
alignment folds into C (proof: C >= 0 and g <= 0 imply the scanned value
equals the clamped recurrence). This turns the sequential j-loop into a
``lax.cummax`` that runs as a parallel scan -- no scalar loops, fully
fused by XLA. Scores are int32, bit-identical to the reference recurrence
(align.impala:46-79) because max-plus is exact in integer arithmetic.

This engine runs on every platform and is the reference the GPU sweep
kernel (kernels/sweep.cu) is checked against; engine/route.py picks
between them.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from anyseq_tpu.core.types import (
    PRED_GAP_Q,
    PRED_GAP_S,
    PRED_NO_GAP,
    PRED_NONE,
    SCORE_MIN,
    LinearScoring,
    Mode,
    Score,
)


def _row_update(prev_row, q_sym, s, col_i, col_im1, jg, mode, sc):
    """One DP row from the previous row. All int32 vectors of width N."""
    diag = jnp.concatenate(
        [jnp.reshape(col_im1, (1,)).astype(Score), prev_row[:-1]]
    )
    sub = jnp.where(q_sym == s, sc.match, sc.mismatch).astype(Score)
    cand = jnp.maximum(diag + sub, prev_row + sc.gap)
    if mode is Mode.LOCAL:
        cand = jnp.maximum(cand, 0)
    shifted = cand - jg
    run = jnp.maximum(jax.lax.cummax(shifted), col_i + sc.gap)
    return run + jg


def _pred_row(row, prev_row, q_sym, s, col_i, col_im1, mode, sc):
    """Recover predecessors from final row values, reference priority
    diag > gap_q > gap_s (align.impala:49-64); PRED_NONE marks clamped
    local cells."""
    diag = jnp.concatenate(
        [jnp.reshape(col_im1, (1,)).astype(Score), prev_row[:-1]]
    )
    sub = jnp.where(q_sym == s, sc.match, sc.mismatch).astype(Score)
    left = jnp.concatenate(
        [jnp.reshape(col_i, (1,)).astype(Score), row[:-1]]
    )
    pred = jnp.where(
        row == diag + sub,
        PRED_NO_GAP,
        jnp.where(
            row == left + sc.gap,
            PRED_GAP_Q,
            jnp.where(row == prev_row + sc.gap, PRED_GAP_S, PRED_NONE),
        ),
    ).astype(jnp.uint8)
    return pred


def _init_col(mode, sc, i):
    if mode is Mode.GLOBAL:
        return (i + 1) * sc.gap
    return jnp.zeros_like(i)


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def score_rows(q, s, m, n, mode: Mode, sc: LinearScoring):
    """Run the full DP, linear memory.

    Args:
      q: (M,) int32 padded query symbols; only q[:m] is meaningful.
      s: (N,) int32 padded subject symbols; only s[:n] is meaningful.
      m, n: actual lengths (traced scalars).

    Returns dict with:
      last_row: (N,) int32 = H[m-1][0..N)   (garbage beyond n)
      last_col: (M,) int32 = H[i][n-1]      (garbage beyond m)
      best: (3,) int32 (score, i, j) running max over all cells,
            row-major first occurrence on ties (local extraction).
    """
    N = s.shape[0]
    M = q.shape[0]
    jg = jnp.arange(N, dtype=Score) * sc.gap
    jmask = jnp.arange(N) < n

    row0 = _init_col(mode, sc, jnp.arange(N, dtype=Score))  # H[-1][j]

    def body(i, carry):
        prev_row, last_col, best = carry
        col_i = _init_col(mode, sc, i).astype(Score)
        col_im1 = _init_col(mode, sc, i - 1).astype(Score)
        row = _row_update(prev_row, q[i], s, col_i, col_im1, jg, mode, sc)
        last_col = last_col.at[i].set(row[n - 1])
        masked = jnp.where(jmask, row, SCORE_MIN)
        rmax = jnp.max(masked)
        rarg = jnp.argmax(masked)
        take = rmax > best[0]
        best = jnp.where(
            take,
            jnp.stack([rmax, i.astype(Score), rarg.astype(Score)]),
            best,
        )
        return row, last_col, best

    init = (
        row0,
        jnp.full((M,), SCORE_MIN, Score),
        jnp.array([SCORE_MIN, -1, -1], Score),
    )
    last_row, last_col, best = jax.lax.fori_loop(0, m, body, init)
    return {"last_row": last_row, "last_col": last_col, "best": best}


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def score_rows_with_preds(q, s, m, n, mode: Mode, sc: LinearScoring):
    """Same as :func:`score_rows` but also emits the (M, N) uint8
    predecessor matrix (full-matrix traceback mode, reference
    traceback_full align.impala:190-216)."""
    N = s.shape[0]
    M = q.shape[0]
    jg = jnp.arange(N, dtype=Score) * sc.gap
    jmask = jnp.arange(N) < n

    row0 = _init_col(mode, sc, jnp.arange(N, dtype=Score))

    def body(i, carry):
        prev_row, preds, last_col, best = carry
        col_i = _init_col(mode, sc, i).astype(Score)
        col_im1 = _init_col(mode, sc, i - 1).astype(Score)
        row = _row_update(prev_row, q[i], s, col_i, col_im1, jg, mode, sc)
        pred = _pred_row(row, prev_row, q[i], s, col_i, col_im1, mode, sc)
        preds = jax.lax.dynamic_update_slice(preds, pred[None, :], (i, 0))
        last_col = last_col.at[i].set(row[n - 1])
        masked = jnp.where(jmask, row, SCORE_MIN)
        rmax = jnp.max(masked)
        rarg = jnp.argmax(masked)
        take = rmax > best[0]
        best = jnp.where(
            take,
            jnp.stack([rmax, i.astype(Score), rarg.astype(Score)]),
            best,
        )
        return row, preds, last_col, best

    init = (
        row0,
        jnp.zeros((M, N), jnp.uint8),
        jnp.full((M,), SCORE_MIN, Score),
        jnp.array([SCORE_MIN, -1, -1], Score),
    )
    last_row, preds, last_col, best = jax.lax.fori_loop(0, m, body, init)
    return {
        "last_row": last_row,
        "last_col": last_col,
        "best": best,
        "preds": preds,
    }


def extract_score_from_outputs(outs, m, n, mode: Mode, sc: LinearScoring):
    """Final score + end position from engine outputs (host-side numpy).

    Mirrors the oracle extraction (anyseq_tpu/ref/oracle.py:extract_score),
    reference scoring.impala:29-137.
    """
    import numpy as np

    mode = Mode.parse(mode)
    last_row = np.asarray(outs["last_row"])[:n]
    last_col = np.asarray(outs["last_col"])[:m]
    if mode is Mode.GLOBAL:
        return int(last_col[m - 1]), (m - 1, n - 1)
    if mode is Mode.SEMIGLOBAL:
        row = np.concatenate([[0], last_row])  # boundary init at j = -1
        ri = int(np.argmax(row))
        score = int(row[ri])
        pos = (m - 1, ri - 1)
        col = np.concatenate([[0], last_col])
        ci = int(np.argmax(col))
        if int(col[ci]) > score:
            score = int(col[ci])
            pos = (ci - 1, n - 1)
        return score, pos
    best = np.asarray(outs["best"])
    return int(best[0]), (int(best[1]), int(best[2]))
