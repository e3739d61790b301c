"""The Hopper sweep kernel (kernels/sweep.cu) and its Python wrapper.

On the CPU the compiled kernel cannot run, so these tests put the numpy
model of the kernel (tests/sweep_model.py: same launches, tiles, boundary
arrays, shuffles and best merge) in place of the FFI call and drive the
real wrapper -- padding, the problem axis, the output contract, the best
reduction -- against the XLA engines and the oracles, bit for bit. The
tests marked ``gpu`` run the compiled kernel itself and skip elsewhere.
"""
import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import mutate, random_dna
from anyseq_tpu.core.types import (
    PAD_Q,
    PAD_S,
    SCORE_MIN,
    AffineScoring,
    LinearScoring,
    Mode,
)
from anyseq_tpu.engine import api, batch, xla_affine, xla_linmem
from anyseq_tpu.kernels import sweep
from anyseq_tpu.ref import oracle, oracle_affine

import sweep_model

LIN = LinearScoring(2, -1, -1)
AFF = AffineScoring(2, -1, -3, -1)
MODES = [Mode.GLOBAL, Mode.SEMIGLOBAL, Mode.LOCAL]
# one tile, several tiles in both directions, and ragged edges on both
SHAPES = {"single": (40, 90), "multi": (300, 280), "ragged": (129, 257)}


@pytest.fixture
def model_kernel(monkeypatch):
    monkeypatch.setattr(sweep, "_ffi_sweep", sweep_model.ffi_sweep)


def _xla(qp, sp, m, n, mode, sc, start_gap=False):
    if isinstance(sc, AffineScoring):
        return xla_affine.score_rows_affine(qp, sp, m, n, mode, sc,
                                            start_gap=start_gap,
                                            emit_col_e=True)
    return xla_linmem.score_rows(qp, sp, m, n, mode, sc)


def _assert_same(k, x, m, n):
    np.testing.assert_array_equal(np.asarray(k["last_row"])[:n],
                                  np.asarray(x["last_row"])[:n])
    np.testing.assert_array_equal(np.asarray(k["last_col"])[:m],
                                  np.asarray(x["last_col"])[:m])
    np.testing.assert_array_equal(np.asarray(k["best"]),
                                  np.asarray(x["best"]))
    if "last_col_e" in x:
        np.testing.assert_array_equal(np.asarray(k["last_col_e"])[:m],
                                      np.asarray(x["last_col_e"])[:m])


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("scheme", ["linear", "affine"])
@pytest.mark.parametrize("mode", MODES)
def test_model_kernel_matches_xla_and_oracle(model_kernel, mode, scheme,
                                             shape):
    sc = AFF if scheme == "affine" else LIN
    rng = np.random.default_rng(zlib.crc32(f"{mode}{scheme}{shape}".encode()))
    mq, ns = SHAPES[shape]
    q = random_dna(rng, mq)
    s = mutate(rng, random_dna(rng, ns))
    _, _, m, n, qp, sp = api._prep(q, s)
    k = sweep.score_rows(qp, sp, m, n, mode, sc)
    _assert_same(k, _xla(qp, sp, m, n, mode, sc), m, n)
    score, _ = xla_linmem.extract_score_from_outputs(
        {key: np.asarray(v) for key, v in k.items()}, m, n, mode, sc)
    ref = (oracle_affine.align_score_affine(q, s, mode, sc)
           if scheme == "affine" else oracle.align_score(q, s, mode, sc))
    assert score == ref


@pytest.mark.parametrize("shape", ["single", "multi"])
def test_model_kernel_affine_start_gap(model_kernel, shape):
    """Myers-Miller crossing subproblems: the top row continues a paid
    gap run (no gap_open; left column and corner unreachable)."""
    rng = np.random.default_rng(7)
    mq, ns = SHAPES[shape]
    q, s = random_dna(rng, mq), random_dna(rng, ns)
    _, _, m, n, qp, sp = api._prep(q, s)
    k = sweep.sweep(qp[None], sp[None], jnp.array([m]), jnp.array([n]),
                    Mode.GLOBAL, AFF, sgap=jnp.array([True]))
    x = _xla(qp, sp, m, n, Mode.GLOBAL, AFF, start_gap=True)
    _assert_same({key: v[0] for key, v in k.items()}, x, m, n)


def _ragged_batch(rng, B, M, N):
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    q = np.full((B, M), PAD_Q, np.int32)
    s = np.full((B, N), PAD_S, np.int32)
    for b in range(B):
        q[b, :ms[b]] = rng.integers(65, 69, ms[b])
        s[b, :ns[b]] = rng.integers(65, 69, ns[b])
    return tuple(jnp.asarray(a) for a in (q, s, ms, ns))


@pytest.mark.parametrize("scheme", ["linear", "affine"])
@pytest.mark.parametrize("mode", MODES)
def test_model_kernel_batch_scores(model_kernel, mode, scheme):
    """Ragged problems on the kernel's problem axis score as the batched
    XLA sweeps do."""
    sc = AFF if scheme == "affine" else LIN
    rng = np.random.default_rng(11)
    args = _ragged_batch(rng, 5, 200, 300)
    got = np.asarray(sweep.scores_batch(*args, mode, sc))
    if scheme == "affine":
        want = batch._score_batch_affine(*args, mode, sc)
    elif mode is Mode.SEMIGLOBAL:
        want = batch._score_batch_semiglobal(*args, mode, sc)
    else:
        want = batch._score_batch(*args, mode, sc)[0]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_model_kernel_level_columns_linear(model_kernel):
    rng = np.random.default_rng(12)
    q, s, ms, ns = _ragged_batch(rng, 4, 260, 200)
    got = np.asarray(sweep.last_cols_batch(q, s, ms, ns, LIN))
    want = np.asarray(batch.last_cols_batch(q, s, ms, ns, LIN))
    for b, m in enumerate(np.asarray(ms)):
        np.testing.assert_array_equal(got[:m, b], want[:m, b])


def test_model_kernel_level_columns_affine(model_kernel):
    """H and E boundary columns with per-problem start-in-gap flags."""
    rng = np.random.default_rng(13)
    q, s, ms, ns = _ragged_batch(rng, 4, 200, 260)
    sg = jnp.asarray([True, False, True, False])
    gh, ge = sweep.last_cols_batch(q, s, ms, ns, AFF, sgap=sg)
    wh, we = batch.last_cols_batch_affine(q, s, ms, ns, AFF, sg)
    for b, m in enumerate(np.asarray(ms)):
        np.testing.assert_array_equal(np.asarray(gh)[:m, b],
                                      np.asarray(wh)[:m, b])
        np.testing.assert_array_equal(np.asarray(ge)[:m, b],
                                      np.asarray(we)[:m, b])


@pytest.mark.parametrize("scheme", ["linear", "affine"])
def test_model_kernel_best_tie_order(model_kernel, scheme):
    """Equal maxima in several rows and tiles: ``best`` is the row-major
    first one, as the XLA engine reports it."""
    sc = AFF if scheme == "affine" else LIN
    unit = b"ACGTTGCA" * 4
    q = unit * 6                   # the same local hit in many rows
    s = b"T" * 70 + unit + b"A" * 90 + unit + b"C" * 60
    _, _, m, n, qp, sp = api._prep(q, s)
    k = sweep.score_rows(qp, sp, m, n, Mode.LOCAL, sc)
    x = _xla(qp, sp, m, n, Mode.LOCAL, sc)
    np.testing.assert_array_equal(np.asarray(k["best"]),
                                  np.asarray(x["best"]))


def test_reduce_best_is_lexicographic():
    rows = jnp.asarray([[[5, 10, 40], [7, 130, 9], [7, 140, 1]],
                        [[3, 2, 2], [SCORE_MIN, -1, -1], [9, 300, 0]]],
                       jnp.int32)
    # problem 1 has one tile row of query: later rows do not count
    got = np.asarray(sweep._reduce_best(rows, jnp.asarray([300, 100])))
    np.testing.assert_array_equal(got, [[7, 130, 9], [3, 2, 2]])


def test_reduce_best_ties_within_a_row_take_first_column():
    rows = jnp.asarray([[[4, 3, 200], [4, 3, 100]]], jnp.int32)
    got = np.asarray(sweep._reduce_best(rows, jnp.asarray([256])))
    np.testing.assert_array_equal(got, [[4, 3, 100]])


def test_wrapper_pads_to_tiles_and_slices_back(monkeypatch):
    seen = {}

    def fake(q, s, ms, ns, sgap, mode, sc, need_best):
        seen["shapes"] = (q.shape, s.shape)
        P, M = q.shape
        return (jnp.zeros((P, s.shape[1]), jnp.int32),
                jnp.zeros((P, M), jnp.int32), jnp.zeros((P, M), jnp.int32),
                jnp.zeros((P, M // sweep.TM, 3), jnp.int32))

    monkeypatch.setattr(sweep, "_ffi_sweep", fake)
    q = jnp.zeros((3, 130), jnp.int32)
    s = jnp.zeros((3, 300), jnp.int32)
    n = jnp.ones((3,), jnp.int32)
    out = sweep.sweep(q, s, n, n, Mode.LOCAL, LIN)
    assert seen["shapes"] == ((3, 2 * sweep.TM), (3, 3 * sweep.TN))
    assert out["last_row"].shape == (3, 300)
    assert out["last_col"].shape == (3, 130)
    assert out["best"].shape == (3, 3)
    assert "last_col_e" not in out


def test_wrapper_affine_and_no_best_outputs(model_kernel):
    rng = np.random.default_rng(3)
    q, s, ms, ns = _ragged_batch(rng, 2, 50, 60)
    out = sweep.sweep(q, s, ms, ns, Mode.GLOBAL, AFF, need_best=False)
    assert set(out) == {"last_row", "last_col", "last_col_e"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without the CUDA toolkit the kernel build
    fails loudly."""
    monkeypatch.setattr(sweep, "_LIB", str(tmp_path / "lib.so"))
    monkeypatch.setattr(sweep, "_CUDA_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(sweep.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        sweep.build()


def test_build_targets_sm90a(monkeypatch, tmp_path):
    calls = []

    class Done:
        returncode = 0
        stderr = ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return Done()

    monkeypatch.setattr(sweep, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sweep, "_LIB", str(tmp_path / "lib.so"))
    monkeypatch.setattr(sweep, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    assert sweep.build() == str(tmp_path / "lib.so")
    cmd = calls[0]
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == sweep._SRC
    # a library newer than the source is reused without a rebuild
    sweep.build()
    assert len(calls) == 1


def test_tile_constants_match_the_cuda_source():
    src = open(sweep._SRC).read()
    assert f"constexpr int R = {sweep.ROWS_PER_LANE};" in src
    assert f"constexpr int TN = {sweep.TN};" in src
    assert f"constexpr int LANES = {sweep.LANES};" in src


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["linear", "affine"])
@pytest.mark.parametrize("mode", MODES)
def test_compiled_kernel_matches_xla(mode, scheme):
    sc = AFF if scheme == "affine" else LIN
    rng = np.random.default_rng(21)
    q = random_dna(rng, 1000)
    s = mutate(rng, random_dna(rng, 3000))
    _, _, m, n, qp, sp = api._prep(q, s)
    k = sweep.score_rows(qp, sp, m, n, mode, sc)
    _assert_same(k, _xla(qp, sp, m, n, mode, sc), m, n)


@pytest.mark.gpu
def test_compiled_kernel_batch_matches_xla():
    rng = np.random.default_rng(22)
    args = _ragged_batch(rng, 64, 300, 270)
    for sc in (LIN, AFF):
        got = np.asarray(sweep.scores_batch(*args, Mode.LOCAL, sc))
        want = (batch._score_batch_affine(*args, Mode.LOCAL, sc)
                if sc is AFF else batch._score_batch(*args, Mode.LOCAL,
                                                     sc)[0])
        np.testing.assert_array_equal(got, np.asarray(want))
