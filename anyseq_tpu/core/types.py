"""Core scalar types, predecessor codes and scheme descriptions.

Semantics pinned against the reference (cited for parity checking, the code
is a fresh design):

- Score is int32 on device (reference: ``Score = MatrixElem`` = i32,
  /root/reference/src/dynprog.impala:10); the public API widens to Python int.
- Predecessor codes (reference: src/align.impala:37-40)::

    PRED_NONE   = 0   # stop marker / local-alignment zero cell
    PRED_GAP_Q  = 1   # came from (i, j-1)  -- gap in the query
    PRED_GAP_S  = 2   # came from (i-1, j)  -- gap in the subject
    PRED_NO_GAP = 3   # came from (i-1, j-1)

- ``SCORE_MIN`` matches the reference sentinel (src/align.impala:16).
"""
from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np

Score = jnp.int32
NP_SCORE = np.int32

SCORE_MIN = -2147483647  # reference SCORE_MIN_VALUE (align.impala:16)

# Symbols that pad query and subject arrays to their bucket sizes. They
# differ, so a padded row never matches a padded column; padded cells lie
# outside (0..m, 0..n) and no engine output reads them.
PAD_Q = 254
PAD_S = 255

PRED_NONE = 0
PRED_GAP_Q = 1
PRED_GAP_S = 2
PRED_NO_GAP = 3

GAP_SYM = ord("_")  # reference: src/traceback.impala:1
EMPTY_SYM = ord(" ")  # reference: src/traceback.impala:2


class Mode(enum.Enum):
    """Alignment scheme (reference: src/align.impala:96-124)."""

    GLOBAL = "global"
    SEMIGLOBAL = "semiglobal"
    LOCAL = "local"

    @classmethod
    def parse(cls, value: "Mode | str") -> "Mode":
        if isinstance(value, Mode):
            return value
        return cls(str(value).lower())


@dataclasses.dataclass(frozen=True)
class LinearScoring:
    """Linear (constant) gap scoring scheme.

    The reference hard-codes ``linear_scoring_scheme(2, -1, -1)`` at its API
    boundary (src/export.impala:14); here the parameters are user-visible.
    ``gap`` must be <= 0 (a positive gap reward would break the
    linear-memory prefix-scan formulation and makes no biological sense).
    """

    match: int = 2
    mismatch: int = -1
    gap: int = -1

    def __post_init__(self):
        if self.gap > 0:
            raise ValueError("gap penalty must be <= 0")


@dataclasses.dataclass(frozen=True)
class AffineScoring:
    """Gotoh affine gap scoring: gap cost = gap_open + k * gap_extend.

    Beyond-reference capability: the reference sketches affine scoring but it
    is dead/non-functional there (src/align.impala:153-166, see SURVEY.md
    quirk Q3). We implement the real 3-matrix Gotoh recurrence.

    Convention: opening a gap of length 1 costs ``gap_open + gap_extend``;
    each additional gap symbol costs ``gap_extend``. Both must be <= 0.
    """

    match: int = 2
    mismatch: int = -1
    gap_open: int = -2
    gap_extend: int = -1

    def __post_init__(self):
        if self.gap_open > 0 or self.gap_extend > 0:
            raise ValueError("gap penalties must be <= 0")


Scoring = LinearScoring | AffineScoring


def init_score(mode: Mode, scoring: LinearScoring, i):
    """Boundary score of cell (i, -1) / (-1, i); i = -1 is the corner.

    Reference: init_scores_global = (i+1)*gap (align.impala:85),
    init_scores_local = 0 (align.impala:86).
    Works for numpy scalars and arrays.
    """
    if mode is Mode.GLOBAL:
        return (i + 1) * scoring.gap
    return i * 0


@dataclasses.dataclass(frozen=True)
class Alignment:
    """Result of an alignment construction.

    ``query_aligned`` / ``subject_aligned`` follow the reference's buffer
    convention (src/traceback.impala:47-80): byte buffers of length
    ``len(query) + len(subject)`` prefilled with ``' '``; the aligned pair of
    cell (i, j) is written at offset ``i + j + 1``; gaps are ``'_'``.
    Use :meth:`compact` for the conventional dense gapped strings.
    """

    score: int
    query_aligned: bytes
    subject_aligned: bytes
    start: tuple[int, int]

    def compact(self) -> tuple[str, str]:
        """Strip the sparse ' ' padding, returning dense aligned strings."""
        q = []
        s = []
        for cq, cs in zip(self.query_aligned, self.subject_aligned):
            if cq == EMPTY_SYM and cs == EMPTY_SYM:
                continue
            q.append(chr(cq))
            s.append(chr(cs))
        return "".join(q), "".join(s)


def as_u8(seq) -> np.ndarray:
    """Coerce a sequence (str | bytes | uint8 array) to a numpy uint8 array."""
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    arr = np.asarray(seq)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr
