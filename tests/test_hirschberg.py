"""Hirschberg engine tests: score parity with the oracle, alignment
validity (re-scoring + subsequence reconstruction), and fulltb equivalence
(SURVEY.md §4 oracle (d): fulltb vs lintime equal scores and
equivalent-score alignments)."""
import numpy as np
import pytest

import anyseq_tpu
from anyseq_tpu.core.types import LinearScoring, Mode
from anyseq_tpu.engine.hirschberg import align_hirschberg
from anyseq_tpu.ref import oracle

from conftest import random_dna, mutate

SC = LinearScoring(2, -1, -1)
MODES = [Mode.GLOBAL, Mode.SEMIGLOBAL, Mode.LOCAL]


def rescore(aln, sc=SC):
    """Score the constructed alignment by walking its columns."""
    dq, ds = aln.compact()
    total = 0
    for cq, cs in zip(dq, ds):
        if cq == "_" or cs == "_":
            total += sc.gap
        elif cq == cs:
            total += sc.match
        else:
            total += sc.mismatch
    return total


def reconstructs(aln, q: bytes, s: bytes):
    """The gapped strings must reconstruct contiguous subsequences of the
    inputs (entire inputs for global)."""
    dq, ds = aln.compact()
    rq = dq.replace("_", "").encode()
    rs = ds.replace("_", "").encode()
    return rq in q and rs in s, rq, rs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_hb_score_and_validity(mode, seed):
    rng = np.random.default_rng(seed)
    q = random_dna(rng, 150)
    s = mutate(rng, q)
    exp = oracle.align_score(q, s, mode, SC)
    aln = align_hirschberg(q, s, mode, SC, min_width=32)
    assert aln.score == exp
    assert rescore(aln) == exp
    ok, rq, rs = reconstructs(aln, q, s)
    assert ok
    if mode is Mode.GLOBAL:
        assert rq == q and rs == s


@pytest.mark.parametrize("mode", MODES)
def test_hb_vs_fulltb_equivalent(mode):
    rng = np.random.default_rng(5)
    q = random_dna(rng, 120)
    s = mutate(rng, q)
    full = anyseq_tpu.align_full_tb(q, s, mode, SC)
    hb = align_hirschberg(q, s, mode, SC, min_width=32)
    assert hb.score == full.score
    # alignments may differ in tie cells but must re-score identically
    assert rescore(hb) == rescore(full) == full.score


def test_hb_self_alignment():
    s = b"ACGTTGCA" * 20
    aln = align_hirschberg(s, s, Mode.GLOBAL, SC, min_width=32)
    assert aln.score == 2 * len(s)
    dq, ds = aln.compact()
    assert dq == ds == s.decode()


def test_hb_unrelated_local_positive():
    rng = np.random.default_rng(9)
    q = random_dna(rng, 100)
    s = random_dna(rng, 100)
    exp = oracle.align_score(q, s, Mode.LOCAL, SC)
    aln = align_hirschberg(q, s, Mode.LOCAL, SC, min_width=32)
    assert aln.score == exp
    assert rescore(aln) == exp


def test_hb_skewed_shapes():
    rng = np.random.default_rng(10)
    q = random_dna(rng, 20)
    s = random_dna(rng, 400)
    for mode in MODES:
        exp = oracle.align_score(q, s, mode, SC)
        aln = align_hirschberg(q, s, mode, SC, min_width=64)
        assert aln.score == exp, mode
        assert rescore(aln) == exp, mode


def test_api_routes_hirschberg():
    rng = np.random.default_rng(11)
    q = random_dna(rng, 80)
    s = mutate(rng, q)
    aln = anyseq_tpu.align(q, s, "global", SC, traceback="hirschberg")
    assert aln.score == oracle.align_score(q, s, Mode.GLOBAL, SC)


@pytest.mark.parametrize("mode", MODES)
def test_hb_all_same_letter(mode):
    """Degenerate tie-heavy input: every cell relaxation ties."""
    q = b"A" * 130
    s = b"A" * 97
    exp = oracle.align_score(q, s, mode, SC)
    aln = align_hirschberg(q, s, mode, SC, min_width=32)
    assert aln.score == exp
    assert rescore(aln) == exp
    ok, _, _ = reconstructs(aln, q, s)
    assert ok


@pytest.mark.parametrize("mode", MODES)
def test_hb_gap_heavy(mode):
    """Harsh mismatch vs mild gap forces gap-dominated paths."""
    sc = LinearScoring(2, -9, -1)
    rng = np.random.default_rng(3)
    q = random_dna(rng, 90)
    s = random_dna(rng, 140)
    exp = oracle.align_score(q, s, mode, sc)
    aln = align_hirschberg(q, s, mode, sc, min_width=32)
    assert aln.score == exp
    assert rescore(aln, sc) == exp


def test_hb_semiglobal_empty_overlap():
    """Unrelated inputs where the best semiglobal path can degenerate to
    the all-gap boundary (exercises the -1-boundary candidates of the
    reverse pass)."""
    sc = LinearScoring(1, -10, -1)
    q = b"AAAA"
    s = b"TTTT"
    exp = oracle.align_score(q, s, Mode.SEMIGLOBAL, sc)
    aln = align_hirschberg(q, s, Mode.SEMIGLOBAL, sc, min_width=2)
    assert aln.score == exp
    assert rescore(aln, sc) == exp


def test_hb_semiglobal_single_cell_shapes():
    sc = LinearScoring(2, -1, -1)
    for q, s in [(b"A", b"ACGT"), (b"ACGT", b"A"), (b"A", b"A"),
                 (b"G", b"T")]:
        for mode in MODES:
            exp = oracle.align_score(q, s, mode, sc)
            aln = align_hirschberg(q, s, mode, sc, min_width=2)
            assert aln.score == exp, (q, s, mode)
