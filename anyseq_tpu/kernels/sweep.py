"""Python side of the Hopper wavefront sweep kernel (kernels/sweep.cu).

The kernel relaxes the alignment DP of a batch of problems and returns what
the XLA row-scan engines return: the last row, the column at ``n - 1`` (and
for affine scoring its E state), and the row-major first best cell. This
module builds the CUDA source with ``nvcc`` on first use (into ``_build``
beside it), registers the handler with XLA's foreign function interface,
pads the batch to whole tiles and reduces the kernel's per-tile-row bests.

Only the call into the compiled kernel needs the card; the padding, the
output contract and the best reduction are plain JAX and run anywhere.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from anyseq_tpu.core.types import (
    PAD_Q,
    PAD_S,
    SCORE_MIN,
    AffineScoring,
    Mode,
)

LANES = 32
ROWS_PER_LANE = 4
TM = LANES * ROWS_PER_LANE  # tile height, as in sweep.cu
TN = 128                    # tile width, as in sweep.cu
# A launch's grid has at most 65535 tile rows (CUDA's grid.y limit).
MAX_ROWS = 65535 * TM

_MODE_CODE = {Mode.GLOBAL: 0, Mode.SEMIGLOBAL: 1, Mode.LOCAL: 2}
_TARGET = "anyseq_sweep"
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sweep.cu")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_BUILD_DIR, "libanyseq_sweep.so")
_lock = threading.Lock()
_registered = False


_CUDA_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_CUDA_NVCC):
        return _CUDA_NVCC
    raise RuntimeError("the sweep kernel needs nvcc (CUDA toolkit) to build")


def build() -> str:
    """Compile sweep.cu for sm_90a unless the library is newer than it.
    Returns the library's path."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, _LIB)
    return _LIB


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.AnyseqSweep), platform="CUDA"
        )
        _registered = True


def _ffi_sweep(q, s, ms, ns, sgap, mode: Mode, sc, need_best: bool):
    """The kernel call on tile-padded (P, M), (P, N) int32 arrays. Returns
    (last_row (P, N), last_col (P, M), last_col_e (P, M),
    best_rows (P, M // TM, 3))."""
    _register()
    P, M = q.shape
    N = s.shape[1]
    affine = isinstance(sc, AffineScoring)
    i32 = jnp.int32
    out_types = (
        jax.ShapeDtypeStruct((P, N), i32),               # last_row
        jax.ShapeDtypeStruct((P, M), i32),               # last_col
        jax.ShapeDtypeStruct((P, M), i32),               # last_col_e
        jax.ShapeDtypeStruct((P, M // TM, 3), i32),      # best_rows
        jax.ShapeDtypeStruct((P, N), i32),               # F row
        jax.ShapeDtypeStruct((P, (M // TM) * (TM + 1)), i32),
        jax.ShapeDtypeStruct((P, M), i32),               # E columns
    )
    gap = 0 if affine else sc.gap
    go, ge = (sc.gap_open, sc.gap_extend) if affine else (0, 0)
    outs = jax.ffi.ffi_call(_TARGET, out_types)(
        q, s, ms, ns, sgap,
        mode=np.int32(_MODE_CODE[mode]), affine=np.int32(affine),
        best=np.int32(need_best), match=np.int32(sc.match),
        mismatch=np.int32(sc.mismatch), gap=np.int32(gap),
        gap_open=np.int32(go), gap_extend=np.int32(ge),
    )
    return outs[:4]


def _reduce_best(best_rows, ms):
    """Lexicographic (max score, min i, min j) over each problem's tile
    rows that hold query rows: the row-major first maximum."""
    tmb = best_rows.shape[1]
    valid = jnp.arange(tmb)[None, :] < (ms[:, None] + TM - 1) // TM
    score = jnp.where(valid, best_rows[..., 0], SCORE_MIN)
    top = jnp.max(score, axis=1)
    big = jnp.iinfo(jnp.int32).max
    cand = valid & (score == top[:, None])
    bi = jnp.min(jnp.where(cand, best_rows[..., 1], big), axis=1)
    cand = cand & (best_rows[..., 1] == bi[:, None])
    bj = jnp.min(jnp.where(cand, best_rows[..., 2], big), axis=1)
    return jnp.stack([top, bi, bj], axis=1)


@functools.partial(jax.jit, static_argnames=("mode", "sc", "need_best"))
def sweep(q, s, ms, ns, mode: Mode, sc, sgap=None, need_best: bool = True):
    """Relax P problems at once.

    q: (P, M) int32, s: (P, N) int32 padded symbols; ms, ns: (P,) lengths
    (at least 1); sgap: (P,) bool, affine GLOBAL only -- the problem's top
    row continues a horizontal gap whose gap_open the caller paid
    (xla_affine.score_rows_affine ``start_gap``).

    Returns a dict of per-problem outputs with the contract of
    xla_linmem.score_rows: ``last_row`` (P, N) = H[m-1][:], ``last_col``
    (P, M) = H[:][n-1], ``best`` (P, 3) = row-major first maximum (when
    ``need_best``), and for affine scoring ``last_col_e`` (P, M) =
    E[:][n-1]. Entries beyond a problem's lengths are unspecified.
    """
    P, M = q.shape
    N = s.shape[1]
    Mp = -(-M // TM) * TM
    Np = -(-N // TN) * TN
    q = jnp.pad(q.astype(jnp.int32), ((0, 0), (0, Mp - M)),
                constant_values=PAD_Q)
    s = jnp.pad(s.astype(jnp.int32), ((0, 0), (0, Np - N)),
                constant_values=PAD_S)
    ms = ms.astype(jnp.int32)
    ns = ns.astype(jnp.int32)
    if sgap is None:
        sgap = jnp.zeros((P,), jnp.int32)
    sgap = jnp.asarray(sgap).astype(jnp.int32)
    last_row, last_col, last_col_e, best_rows = _ffi_sweep(
        q, s, ms, ns, sgap, mode, sc, need_best
    )
    out = {"last_row": last_row[:, :N], "last_col": last_col[:, :M]}
    if need_best:
        out["best"] = _reduce_best(best_rows, ms)
    if isinstance(sc, AffineScoring):
        out["last_col_e"] = last_col_e[:, :M]
    return out


def score_rows(q, s, m, n, mode: Mode, sc):
    """One pair with the contract of xla_linmem.score_rows /
    xla_affine.score_rows_affine (q, s padded 1-D; m, n lengths)."""
    outs = sweep(q[None, :], s[None, :], jnp.reshape(m, (1,)),
                 jnp.reshape(n, (1,)), Mode.parse(mode), sc)
    return {k: v[0] for k, v in outs.items()}


def last_cols_batch(q, s, ms, ns, sc, sgap=None):
    """Kernel form of batch.last_cols_batch (linear) and
    batch.last_cols_batch_affine (affine): (M, B) H columns at each
    problem's ``n - 1``, and for affine scoring the (M, B) E columns."""
    outs = sweep(q, s, ms, ns, Mode.GLOBAL, sc, sgap=sgap, need_best=False)
    if isinstance(sc, AffineScoring):
        return outs["last_col"].T, outs["last_col_e"].T
    return outs["last_col"].T


@functools.partial(jax.jit, static_argnames=("mode", "sc"))
def scores_batch(q, s, ms, ns, mode: Mode, sc):
    """(B,) scores with the extraction of batch._score_batch,
    _score_batch_semiglobal and _score_batch_affine."""
    outs = sweep(q, s, ms, ns, mode, sc, need_best=mode is Mode.LOCAL)
    if mode is Mode.GLOBAL:
        return jnp.take_along_axis(
            outs["last_row"], (ns - 1)[:, None].astype(jnp.int32), axis=1
        )[:, 0]
    if mode is Mode.LOCAL:
        return jnp.maximum(outs["best"][:, 0], 0)
    row = jnp.where(jnp.arange(s.shape[1])[None, :] < ns[:, None],
                    outs["last_row"], SCORE_MIN)
    col = jnp.where(jnp.arange(q.shape[1])[None, :] < ms[:, None],
                    outs["last_col"], SCORE_MIN)
    return jnp.maximum(jnp.maximum(row.max(axis=1), col.max(axis=1)), 0)
