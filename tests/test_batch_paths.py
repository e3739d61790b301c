"""The batched XLA sweeps that serve many-pair scoring and construction
(engine/batch.py) against the single-pair engines and the oracles, on
ragged batches: scores, local end positions, boundary outputs, start-gap
columns and predecessor matrices, and the public batch entry points."""
import numpy as np
import jax.numpy as jnp
import pytest

import anyseq_tpu
from anyseq_tpu.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu.engine import api, batch as beng, xla_affine, xla_linmem
from anyseq_tpu.ref import oracle, oracle_affine

SC = LinearScoring(2, -1, -1)
SCW = LinearScoring(3, -2, -2)
SCA = AffineScoring(2, -1, -3, -1)
MODES = ["local", "global", "semiglobal"]


def _pairs(rng, B, maxm, maxn):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    qs = [bytes(alpha[rng.integers(0, 4, int(rng.integers(1, maxm + 1)))])
          for _ in range(B)]
    ss = [bytes(alpha[rng.integers(0, 4, int(rng.integers(1, maxn + 1)))])
          for _ in range(B)]
    return qs, ss


def _staged(qs, ss):
    M = beng._bucket(max(map(len, qs)))
    N = beng._bucket(max(map(len, ss)))
    arrs = beng._stage(list(range(len(qs))), [np.frombuffer(q, np.uint8)
                                              for q in qs],
                       [np.frombuffer(s, np.uint8) for s in ss], M, N)
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sc", [SC, SCW], ids=["ref", "wide"])
def test_scores_batch_linear_vs_oracle(rng, mode, sc):
    qs, ss = _pairs(rng, 37, 90, 70)
    got = anyseq_tpu.align_scores_batch(qs, ss, mode, sc)
    want = [oracle.align_score(q, s, mode, sc) for q, s in zip(qs, ss)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_scores_batch_affine_vs_oracle(rng, mode):
    qs, ss = _pairs(rng, 23, 80, 60)
    got = anyseq_tpu.align_scores_batch(qs, ss, mode, SCA)
    want = [oracle_affine.align_score_affine(q, s, mode, SCA)
            for q, s in zip(qs, ss)]
    np.testing.assert_array_equal(got, want)


def test_score_batch_local_end_positions(rng):
    """The batched local sweep reports each pair's row-major first best
    cell, as the single-pair engine does."""
    qs, ss = _pairs(rng, 15, 70, 90)
    q, s, ms, ns = _staged(qs, ss)
    _, pos = beng._score_batch(q, s, ms, ns, Mode.LOCAL, SC)
    for b, (qa, sa) in enumerate(zip(qs, ss)):
        _, _, m, n, qp, sp = api._prep(qa, sa)
        best = np.asarray(xla_linmem.score_rows(qp, sp, m, n, Mode.LOCAL,
                                                SC)["best"])
        assert tuple(np.asarray(pos)[b]) == tuple(best[1:])


def test_batch_boundary_outputs(rng):
    """preds_batch_full's last rows and columns equal the single-pair
    engine's per pair."""
    qs, ss = _pairs(rng, 11, 60, 50)
    q, s, ms, ns = _staged(qs, ss)
    _, last_row, last_col, _ = beng.preds_batch_full(q, s, ms, ns,
                                                     Mode.GLOBAL, SC)
    for b, (qa, sa) in enumerate(zip(qs, ss)):
        _, _, m, n, qp, sp = api._prep(qa, sa)
        ref = xla_linmem.score_rows(qp, sp, m, n, Mode.GLOBAL, SC)
        np.testing.assert_array_equal(np.asarray(last_row)[b, :n],
                                      np.asarray(ref["last_row"])[:n])
        np.testing.assert_array_equal(np.asarray(last_col)[b, :m],
                                      np.asarray(ref["last_col"])[:m])


@pytest.mark.parametrize("sgap", [False, True])
def test_last_cols_batch_affine_start_gap(rng, sgap):
    """Myers-Miller level columns (H and E) per pair equal the single-pair
    affine engine's with the same start-in-gap flag."""
    qs, ss = _pairs(rng, 9, 70, 60)
    q, s, ms, ns = _staged(qs, ss)
    flags = jnp.full((len(qs),), sgap)
    cols_h, cols_e = beng.last_cols_batch_affine(q, s, ms, ns, SCA, flags)
    for b, (qa, sa) in enumerate(zip(qs, ss)):
        _, _, m, n, qp, sp = api._prep(qa, sa)
        ref = xla_affine.score_rows_affine(qp, sp, m, n, Mode.GLOBAL, SCA,
                                           start_gap=sgap, emit_col_e=True)
        np.testing.assert_array_equal(np.asarray(cols_h)[:m, b],
                                      np.asarray(ref["last_col"])[:m])
        np.testing.assert_array_equal(np.asarray(cols_e)[:m, b],
                                      np.asarray(ref["last_col_e"])[:m])


@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.LOCAL])
def test_preds_batch_full_vs_single(rng, mode):
    qs, ss = _pairs(rng, 7, 50, 60)
    q, s, ms, ns = _staged(qs, ss)
    preds, _, _, _ = beng.preds_batch_full(q, s, ms, ns, mode, SC)
    for b, (qa, sa) in enumerate(zip(qs, ss)):
        _, _, m, n, qp, sp = api._prep(qa, sa)
        ref = xla_linmem.score_rows_with_preds(qp, sp, m, n, mode, SC)
        np.testing.assert_array_equal(np.asarray(preds)[b, :m, :n],
                                      np.asarray(ref["preds"])[:m, :n])


@pytest.mark.parametrize("mode", MODES)
def test_align_batch_ragged_matches_full_tb(rng, mode):
    """align_batch over a ragged, multi-bucket batch gives every pair the
    single-pair full-traceback alignment."""
    qs, ss = _pairs(rng, 9, 300, 120)
    got = anyseq_tpu.align_batch(qs, ss, mode, SC)
    for aln, q, s in zip(got, qs, ss):
        assert aln == anyseq_tpu.align_full_tb(q, s, mode, SC)


@pytest.mark.parametrize("mode", MODES)
def test_align_scores_batch_engines_agree(rng, mode):
    qs, ss = _pairs(rng, 12, 40, 300)
    np.testing.assert_array_equal(
        anyseq_tpu.align_scores_batch(qs, ss, mode, SC, engine="auto"),
        anyseq_tpu.align_scores_batch(qs, ss, mode, SC, engine="xla"))


def test_scores_batch_small_chunks_keep_order(rng):
    qs, ss = _pairs(rng, 10, 300, 300)
    got = anyseq_tpu.align_scores_batch(qs, ss, "local", SC, batch_size=3)
    want = [oracle.align_score(q, s, "local", SC) for q, s in zip(qs, ss)]
    np.testing.assert_array_equal(got, want)
