"""A numpy model of kernels/sweep.cu, step for step.

The CUDA kernel has no interpret mode, so the tests check its tiling and
boundary protocol through this model instead: the same launches (one per
block anti-diagonal), the same tile-local state (lane registers, the shared
top row, the boundary row and column arrays with the corner in column
slot 0), the same warp shuffles (as shifts over the lane axis) and the same
per-tile-row best merge. ``ffi_sweep`` has the signature and outputs of
``kernels.sweep._ffi_sweep``, so a test can put it in that function's place
and drive the real wrapper on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from anyseq_tpu.core.types import SCORE_MIN, AffineScoring, Mode
from anyseq_tpu.kernels import sweep

LANES = sweep.LANES
R = sweep.ROWS_PER_LANE
TM = sweep.TM
TN = sweep.TN
NEG = -(1 << 29)


def _bounds(mode, affine, sg, sc):
    """(top(j), left(i), corner) boundary H values, as sweep.cu."""
    if mode is not Mode.GLOBAL:
        return (lambda j: np.zeros_like(j)), (lambda i: np.zeros_like(i)), 0
    if not affine:
        return (lambda j: (j + 1) * sc.gap), (lambda i: (i + 1) * sc.gap), 0
    top = lambda j: (0 if sg else sc.gap_open) + (j + 1) * sc.gap_extend
    if sg:
        return top, (lambda i: np.full_like(i, NEG)), NEG
    return top, (lambda i: sc.gap_open + (i + 1) * sc.gap_extend), 0


def _lex_better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and (a[1] < b[1] or (
        a[1] == b[1] and a[2] < b[2])))


def _tile(st, p, bi, bj, mode, sc, affine, need_best):
    q, s, ms, ns, sgap = st["in"]
    m, n = int(ms[p]), int(ns[p])
    i0, j0 = bi * TM, bj * TN
    if i0 >= m or j0 >= n:
        return
    sg = affine and mode is Mode.GLOBAL and bool(sgap[p])
    top, left, corner = _bounds(mode, affine, sg, sc)
    go, ge = (sc.gap_open, sc.gap_extend) if affine else (0, 0)
    lanes = np.arange(LANES)
    row0 = i0 + lanes * R
    cols = j0 + np.arange(TN)
    s_sym = s[p, cols]
    s_top = top(cols) if bi == 0 else st["hrow"][p, cols].copy()
    s_topf = (np.full(TN, NEG) if bi == 0 else st["frow"][p, cols].copy())
    vcol = st["vcol"][p, bi]
    vcole = st["vcole"][p, bi]

    lft = np.empty((LANES, R + 1), np.int64)
    for r in range(R + 1):
        i = row0 - 1 + r
        if bj > 0:
            lft[:, r] = vcol[lanes * R + r]
        else:
            lft[:, r] = np.where(i < 0, corner, left(i))
    hcur = lft[:, 1:].copy()
    if affine and bj > 0:
        ecur = vcole[lanes[:, None] * R + np.arange(R)].astype(np.int64)
    else:
        ecur = np.full((LANES, R), NEG + go - ge, np.int64)
    qsym = q[p, row0[:, None] + np.arange(R)]
    prev_up = lft[:, 0].copy()
    bot_h = np.zeros(LANES, np.int64)
    bot_f = np.full(LANES, NEG, np.int64)
    rb = np.full((LANES, R), SCORE_MIN, np.int64)
    rj = np.full((LANES, R), -1, np.int64)
    active_row = (row0[:, None] + np.arange(R)) < m

    for t in range(TN + LANES - 1):
        c = t - lanes
        act = (c >= 0) & (c < TN)
        cc = np.clip(c, 0, TN - 1)
        up = np.concatenate([bot_h[:1], bot_h[:-1]])     # __shfl_up_sync
        upf = np.concatenate([bot_f[:1], bot_f[:-1]])
        if act[0]:
            up[0] = s_top[cc[0]]
            upf[0] = s_topf[cc[0]]
        j = j0 + c
        sym = s_sym[cc]
        dg = prev_up.copy()
        prev_up = np.where(act, up, prev_up)
        new_h = hcur.copy()
        new_e = ecur.copy()
        for r in range(R):
            sub = np.where(qsym[:, r] == sym, sc.match, sc.mismatch)
            lft_r = hcur[:, r]
            if affine:
                f = np.maximum(up + go + ge, upf + ge)
                e = np.maximum(lft_r + go + ge, ecur[:, r] + ge)
                h = np.maximum(np.maximum(dg + sub, f), e)
                new_e[:, r] = e
            else:
                f = np.full(LANES, NEG, np.int64)
                h = np.maximum(np.maximum(dg + sub, up + sc.gap),
                               lft_r + sc.gap)
            if mode is Mode.LOCAL:
                h = np.maximum(h, 0)
            h = np.where(active_row[:, r], h, up)
            f = np.where(active_row[:, r], f, upf)
            if need_best:
                take = act & active_row[:, r] & (j < n) & (h > rb[:, r])
                rb[:, r] = np.where(take, h, rb[:, r])
                rj[:, r] = np.where(take, j, rj[:, r])
            dg = lft_r
            new_h[:, r] = h
            up, upf = h, f
        hcur = np.where(act[:, None], new_h, hcur)
        ecur = np.where(act[:, None], new_e, ecur)
        bot_h = np.where(act, up, bot_h)
        bot_f = np.where(act, upf, bot_f)
        for k in np.nonzero(act & (j == n - 1))[0]:
            st["last_col"][p, row0[k]: row0[k] + R] = hcur[k]
            if affine:
                st["last_col_e"][p, row0[k]: row0[k] + R] = ecur[k]
        for k in np.nonzero(act & (c == TN - 1))[0]:
            if k == 0:
                vcol[0] = prev_up[0]
            vcol[k * R + 1: k * R + R + 1] = hcur[k]
            if affine:
                vcole[k * R: k * R + R] = ecur[k]
        if act[LANES - 1]:
            s_top[cc[LANES - 1]] = bot_h[LANES - 1]
            s_topf[cc[LANES - 1]] = bot_f[LANES - 1]
    st["hrow"][p, cols] = s_top
    st["frow"][p, cols] = s_topf

    if need_best:
        best = (SCORE_MIN, -1, -1)
        for k in range(LANES):
            for r in range(R):
                cand = (int(rb[k, r]), int(row0[k] + r), int(rj[k, r]))
                if _lex_better(cand, best):
                    best = cand
        acc = st["best_rows"][p, bi]
        if bj == 0 or _lex_better(best, tuple(int(x) for x in acc)):
            acc[:] = best


def model_sweep(q, s, ms, ns, sgap, mode: Mode, sc, need_best: bool):
    """Numpy run of every launch; returns the four outputs of
    sweep._ffi_sweep as numpy int32 arrays."""
    q, s = np.asarray(q), np.asarray(s)
    P, M = q.shape
    N = s.shape[1]
    tmb, tnb = M // TM, N // TN
    affine = isinstance(sc, AffineScoring)
    st = {
        "in": (q, s, np.asarray(ms), np.asarray(ns), np.asarray(sgap)),
        "hrow": np.zeros((P, N), np.int64),
        "frow": np.zeros((P, N), np.int64),
        "vcol": np.zeros((P, tmb, TM + 1), np.int64),
        "vcole": np.zeros((P, tmb, TM), np.int64),
        "last_col": np.zeros((P, M), np.int64),
        "last_col_e": np.zeros((P, M), np.int64),
        "best_rows": np.zeros((P, tmb, 3), np.int64),
    }
    for d in range(tmb + tnb - 1):
        for bi in range(max(0, d - tnb + 1), min(d, tmb - 1) + 1):
            for p in range(P):
                _tile(st, p, bi, d - bi, mode, sc, affine, need_best)
    return tuple(st[k].astype(np.int32) for k in
                 ("hrow", "last_col", "last_col_e", "best_rows"))


def ffi_sweep(q, s, ms, ns, sgap, mode: Mode, sc, need_best: bool):
    """Drop-in for sweep._ffi_sweep that runs ``model_sweep`` on the host
    through ``jax.pure_callback``."""
    P, M = q.shape
    N = s.shape[1]
    i32 = jnp.int32
    shapes = (
        jax.ShapeDtypeStruct((P, N), i32),
        jax.ShapeDtypeStruct((P, M), i32),
        jax.ShapeDtypeStruct((P, M), i32),
        jax.ShapeDtypeStruct((P, M // TM, 3), i32),
    )
    return jax.pure_callback(
        lambda *a: model_sweep(*a, mode, sc, need_best), shapes,
        q, s, ms, ns, sgap,
    )
