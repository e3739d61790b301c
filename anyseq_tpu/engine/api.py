"""User-facing alignment API: padding, engine dispatch, result assembly.

Mirrors the reference's C ABI capabilities (src/import.h:14-41 /
src/export.impala): score-only, full-matrix traceback, and linear-memory
(Hirschberg) traceback for global / semiglobal / local schemes -- with the
scoring scheme a real parameter instead of the reference's hard-coded
``linear_scoring_scheme(2,-1,-1)`` (export.impala:14).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from anyseq_tpu.core.types import (
    EMPTY_SYM,
    PAD_Q,
    PAD_S,
    PRED_GAP_Q,
    PRED_GAP_S,
    AffineScoring,
    Alignment,
    LinearScoring,
    Mode,
    as_u8,
)
from anyseq_tpu.engine import route, xla_linmem

_BUCKET = 256


def _bucket(x: int, mult: int = _BUCKET) -> int:
    return max(mult, (x + mult - 1) // mult * mult)


def _pad_i32(arr: np.ndarray, size: int, fill: int) -> jnp.ndarray:
    out = np.full(size, fill, dtype=np.int32)
    out[: len(arr)] = arr
    return jnp.asarray(out)


def _prep(query, subject):
    q = as_u8(query)
    s = as_u8(subject)
    m, n = len(q), len(s)
    if m == 0 or n == 0:
        raise ValueError("empty sequences are not supported")
    qp = _pad_i32(q, _bucket(m), PAD_Q)
    sp = _pad_i32(s, _bucket(n), PAD_S)
    return q, s, m, n, qp, sp


def _run_score(qp, sp, m, n, mode, scoring, engine):
    """Score-pass outputs (xla_linmem.score_rows contract) from the engine
    the router picks."""
    mode = Mode.parse(mode)
    if route.use_kernel("score", engine, qp.shape[0]):
        from anyseq_tpu.kernels import sweep

        return sweep.score_rows(qp, sp, m, n, mode, scoring)
    if isinstance(scoring, AffineScoring):
        from anyseq_tpu.engine import xla_affine

        return xla_affine.score_rows_affine(qp, sp, m, n, mode, scoring)
    return xla_linmem.score_rows(qp, sp, m, n, mode, scoring)


def align_score(query, subject, mode="global", scoring=LinearScoring(),
                engine="auto") -> int:
    """Score-only alignment (reference: *_alignment_score, export.impala)."""
    mode = Mode.parse(mode)
    _, _, m, n, qp, sp = _prep(query, subject)
    outs = _run_score(qp, sp, m, n, mode, scoring, engine)
    score, _ = xla_linmem.extract_score_from_outputs(outs, m, n, mode, scoring)
    return score


def _haloed_preds(preds: np.ndarray, m: int, n: int, mode: Mode) -> np.ndarray:
    """(m+1, n+1) predecessor matrix with the -1 boundary row/column
    initialized per scheme (reference: predecessors.impala:11-34)."""
    P = np.zeros((m + 1, n + 1), dtype=np.uint8)
    P[1:, 1:] = preds[:m, :n]
    if mode is Mode.GLOBAL:
        P[1:, 0] = PRED_GAP_S
        P[0, 1:] = PRED_GAP_Q
    return P


def align_full_tb(query, subject, mode="global", scoring=LinearScoring(),
                  engine="auto") -> Alignment:
    """Full-matrix traceback alignment (reference: construct_*_fulltb,
    align.impala:190-216). O(m*n) memory; use :func:`align` (Hirschberg)
    for long sequences.

    Note: unlike the reference, semiglobal/local fulltb use the correct
    scheme (the reference's semiglobal/local fulltb entry points mistakenly
    use global_scheme -- copy-paste bug, export.impala:108,165; see
    SURVEY.md quirk Q1).
    """
    mode = Mode.parse(mode)
    route.check(engine)  # one engine: the XLA predecessor sweep
    q, s, m, n, qp, sp = _prep(query, subject)
    if isinstance(scoring, AffineScoring):
        from anyseq_tpu.engine import xla_affine

        outs = xla_affine.score_rows_affine_with_preds(
            qp, sp, m, n, mode, scoring
        )
        score, end = xla_linmem.extract_score_from_outputs(
            outs, m, n, mode, scoring
        )
        PH, PE, PF = _haloed_affine_preds(
            np.asarray(outs["preds"]), m, n, mode
        )
        from anyseq_tpu.engine import tb

        out_q = np.full(m + n, EMPTY_SYM, dtype=np.uint8)
        out_s = np.full(m + n, EMPTY_SYM, dtype=np.uint8)
        start = tb.walk_affine(q, s, PH, PE, PF, end, out_q, out_s)
        return Alignment(score, bytes(out_q), bytes(out_s), start)
    outs = xla_linmem.score_rows_with_preds(qp, sp, m, n, mode, scoring)
    score, end = xla_linmem.extract_score_from_outputs(outs, m, n, mode, scoring)
    P = _haloed_preds(np.asarray(outs["preds"]), m, n, mode)
    from anyseq_tpu.engine import tb

    out_q = np.full(m + n, EMPTY_SYM, dtype=np.uint8)
    out_s = np.full(m + n, EMPTY_SYM, dtype=np.uint8)
    start = tb.walk_linear(q, s, P, end, out_q, out_s)
    return Alignment(score, bytes(out_q), bytes(out_s), start)


def _haloed_affine_preds(packed: np.ndarray, m: int, n: int, mode: Mode):
    """Unpack the engine's packed affine predecessors into haloed
    (m+1, n+1) PH/PE/PF planes (boundaries per ref/oracle_affine.py)."""
    PH = np.zeros((m + 1, n + 1), dtype=np.uint8)
    PE = np.zeros((m + 1, n + 1), dtype=np.uint8)
    PF = np.zeros((m + 1, n + 1), dtype=np.uint8)
    blk = packed[:m, :n]
    PH[1:, 1:] = blk & 3
    PE[1:, 1:] = (blk >> 2) & 1
    PF[1:, 1:] = (blk >> 3) & 1
    if mode is Mode.GLOBAL:
        PH[0, 1:] = PRED_GAP_Q
        PH[1:, 0] = PRED_GAP_S
        PE[0, 2:] = 1
        PF[2:, 0] = 1
    return PH, PE, PF


def align(query, subject, mode="global", scoring=LinearScoring(),
          traceback="auto", engine="auto", mesh=None) -> Alignment:
    """Construct an alignment (reference: construct_*_alignment, which
    defaults to the linear-memory Hirschberg path, align.impala:237-311).

    traceback: "hirschberg" (linear memory), "full" (O(m*n) predecessor
    matrix), or "auto" (hirschberg for large problems, full for small).

    mesh: optional jax.sharding.Mesh -- distributes the Hirschberg
    construction over the device mesh (forces traceback="hirschberg";
    bit-identical to the single-device result).
    """
    mode = Mode.parse(mode)
    route.check(engine)
    if mesh is not None:
        from anyseq_tpu.engine import hirschberg

        return hirschberg.align_hirschberg(query, subject, mode, scoring,
                                           engine, mesh=mesh)
    if traceback == "auto":
        q8, s8 = as_u8(query), as_u8(subject)
        traceback = "full" if len(q8) * len(s8) <= (1 << 22) else "hirschberg"
    if traceback == "full":
        return align_full_tb(query, subject, mode, scoring, engine)
    from anyseq_tpu.engine import hirschberg

    return hirschberg.align_hirschberg(query, subject, mode, scoring, engine)
