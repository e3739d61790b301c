"""Multi-device subject-sharded wavefront tests on the virtual 8-device
CPU mesh (SURVEY.md §4 oracle (e): multi-chip == single-chip scores)."""
import jax
import numpy as np
import pytest

from anyseq_tpu.core.types import LinearScoring, Mode
from anyseq_tpu.dist import mesh as meshlib
from anyseq_tpu.dist.sharded import score_pair_sharded
from anyseq_tpu.engine import xla_linmem
from anyseq_tpu.ref import oracle

from conftest import random_dna, mutate

SC = LinearScoring(2, -1, -1)
MODES = [Mode.GLOBAL, Mode.SEMIGLOBAL, Mode.LOCAL]


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return meshlib.make_mesh(sp=8, dp=1)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_score_matches_oracle(mesh8, mode):
    rng = np.random.default_rng(31)
    q = random_dna(rng, 300)
    s = mutate(rng, random_dna(rng, 1500))
    m, n = len(q), len(s)
    outs = score_pair_sharded(q, s, mode, SC, mesh8, H=128)
    outs = {k: np.asarray(v) for k, v in outs.items()}
    score, pos = xla_linmem.extract_score_from_outputs(outs, m, n, mode, SC)
    exp_H, _ = oracle.dp_full(q, s, mode, SC)
    exp_score, exp_pos = oracle.extract_score(exp_H, mode, SC)
    assert score == exp_score
    if mode is Mode.LOCAL:
        assert tuple(pos) == tuple(exp_pos)
    # boundary vectors must be bit-identical to the single-chip engine
    np.testing.assert_array_equal(outs["last_row"][:n], exp_H[m, 1:])
    np.testing.assert_array_equal(outs["last_col"][:m], exp_H[1:, n])


def test_sharded_large_multiband(mesh8):
    rng = np.random.default_rng(32)
    q = random_dna(rng, 700)
    s = random_dna(rng, 2000)
    outs = score_pair_sharded(q, s, Mode.GLOBAL, SC, mesh8, H=256)
    score, _ = xla_linmem.extract_score_from_outputs(
        {k: np.asarray(v) for k, v in outs.items()},
        len(q), len(s), Mode.GLOBAL, SC,
    )
    assert score == oracle.align_score(q, s, Mode.GLOBAL, SC)


def test_mesh_shapes():
    m = meshlib.make_mesh(sp=4, dp=2)
    assert m.shape["sp"] == 4 and m.shape["dp"] == 2
    with pytest.raises(ValueError):
        meshlib.make_mesh(sp=3, dp=3)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_affine_matches_oracle(mesh8, mode):
    """Affine (Gotoh) subject-sharded wavefront: the superstep message
    carries the full E/F gap state; bit-identical to the affine oracle
    (VERDICT r2 item 5)."""
    from anyseq_tpu.core.types import AffineScoring
    from anyseq_tpu.ref import oracle_affine

    asc = AffineScoring(2, -1, -3, -1)
    rng = np.random.default_rng(34)
    q = random_dna(rng, 150)
    s = mutate(rng, random_dna(rng, 900))
    m, n = len(q), len(s)
    outs = score_pair_sharded(q, s, mode, asc, mesh8, H=128)
    outs = {k: np.asarray(v) for k, v in outs.items()}
    score, _ = xla_linmem.extract_score_from_outputs(outs, m, n, mode,
                                                     asc)
    assert score == oracle_affine.align_score_affine(q, s, mode, asc)


@pytest.mark.parametrize("sgap", [False, True])
def test_sharded_affine_start_gap_bitexact(mesh8, sgap):
    """start_gap (Myers-Miller continuing-run init) through the sharded
    path must match the single-chip affine engine bit-for-bit."""
    from anyseq_tpu.core.types import AffineScoring
    from anyseq_tpu.engine import xla_affine

    asc = AffineScoring(2, -1, -3, -1)
    rng = np.random.default_rng(35)
    q = random_dna(rng, 120)
    s = mutate(rng, random_dna(rng, 700))
    m, n = len(q), len(s)
    outs = score_pair_sharded(q, s, Mode.GLOBAL, asc, mesh8, H=128,
                              start_gap=sgap)
    outs = {k: np.asarray(v) for k, v in outs.items()}
    qp = np.frombuffer(q, np.uint8).astype(np.int32)
    sp = np.frombuffer(s, np.uint8).astype(np.int32)
    ref = xla_affine.score_rows_affine(qp, sp, m, n, Mode.GLOBAL, asc,
                                       start_gap=sgap, emit_col_e=True)
    np.testing.assert_array_equal(outs["last_row"][:n],
                                  np.asarray(ref["last_row"])[:n])
    np.testing.assert_array_equal(outs["last_col"][:m],
                                  np.asarray(ref["last_col"])[:m])
    np.testing.assert_array_equal(outs["last_col_e"][:m],
                                  np.asarray(ref["last_col_e"])[:m])


def test_distributed_affine_construction(mesh8):
    """align(mesh=) with affine scoring: distributed Myers-Miller must be
    bit-identical to the single-device construction."""
    from anyseq_tpu.core.types import AffineScoring
    from anyseq_tpu.engine.hirschberg import align_hirschberg

    asc = AffineScoring(2, -1, -3, -1)
    rng = np.random.default_rng(36)
    q = random_dna(rng, 220)
    s = mutate(rng, random_dna(rng, 500))
    single = align_hirschberg(q, s, Mode.GLOBAL, asc, min_width=64)
    dist = align_hirschberg(q, s, Mode.GLOBAL, asc, min_width=64,
                            mesh=mesh8, sp_min_width=128)
    assert dist.score == single.score
    assert dist.query_aligned == single.query_aligned
    assert dist.subject_aligned == single.subject_aligned


@pytest.mark.parametrize("mode", MODES)
def test_sharded_auto_engine_bitexact(mesh8, mode):
    """The routed ("auto") stripe engine under shard_map must be
    bit-identical to the oracle in every boundary output, with bands
    shorter than the query (several supersteps per stripe)."""
    rng = np.random.default_rng(33)
    q = random_dna(rng, 200)
    s = mutate(rng, random_dna(rng, 1800))
    m, n = len(q), len(s)
    outs = score_pair_sharded(q, s, mode, SC, mesh8, H=128,
                              engine="auto")
    outs = {k: np.asarray(v) for k, v in outs.items()}
    score, pos = xla_linmem.extract_score_from_outputs(outs, m, n, mode, SC)
    exp_H, _ = oracle.dp_full(q, s, mode, SC)
    exp_score, exp_pos = oracle.extract_score(exp_H, mode, SC)
    assert score == exp_score
    if mode is Mode.LOCAL:
        assert tuple(pos) == tuple(exp_pos)
    np.testing.assert_array_equal(outs["last_row"][:n], exp_H[m, 1:])
    np.testing.assert_array_equal(outs["last_col"][:m], exp_H[1:, n])
