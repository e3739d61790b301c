"""Explicit data-parallel sharding of the batched many-pair engines.

The reference has no many-pair mode at all (one pair per process,
main.cpp:180-211); these wrappers distribute the batch dimension of the
engine/batch.py sweeps over ALL devices of a mesh with an explicit
``shard_map`` contract (PartitionSpec over the flattened (dp, sp) axes) --
no reliance on XLA auto-spmd. Each device relaxes its own slice of pairs;
there is no cross-device communication (the pairs are independent), so
scaling is embarrassingly linear.

Used stand-alone for large score batches and by the distributed Hirschberg
construction (engine/hirschberg.py, ``mesh=``) for level sweeps and
terminal stripes.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from anyseq_tpu.core.types import PAD_Q, PAD_S, LinearScoring, Mode
from anyseq_tpu.engine import batch as _batch


def _device_count(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())


def fetch(x) -> np.ndarray:
    """Host numpy copy of a possibly globally-sharded array.

    In a multi-process (multi-host DCN) run, a dp-sharded shard_map
    output spans non-addressable devices and plain ``np.asarray`` raises;
    gather the global value across processes first. Single-process runs
    take the direct path."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _axes(mesh: Mesh):
    return tuple(mesh.axis_names)


def _pad_batch(q, s, ms, ns, K):
    """Pad the batch dim to a multiple of K with dummy 1x1 problems."""
    B = q.shape[0]
    Bp = -(-B // K) * K
    if Bp == B:
        return q, s, ms, ns, B
    pad = Bp - B
    q = jnp.concatenate(
        [q, jnp.full((pad, q.shape[1]), PAD_Q, q.dtype)]
    )
    s = jnp.concatenate(
        [s, jnp.full((pad, s.shape[1]), PAD_S, s.dtype)]
    )
    ms = jnp.concatenate([ms, jnp.ones((pad,), ms.dtype)])
    ns = jnp.concatenate([ns, jnp.ones((pad,), ns.dtype)])
    return q, s, ms, ns, B


def last_cols_batch_sharded(q, s, ms, ns, sc: LinearScoring, mesh: Mesh):
    """dp-sharded :func:`engine.batch.last_cols_batch`: (M, B) boundary
    columns, batch dim distributed over every device of ``mesh``."""
    K = _device_count(mesh)
    q, s, ms, ns, B = _pad_batch(q, s, ms, ns, K)
    ax = _axes(mesh)
    fn = jax.shard_map(
        lambda q_, s_, ms_, ns_: _batch.last_cols_batch(q_, s_, ms_, ns_, sc),
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax)),
        out_specs=P(None, ax),
        check_vma=False,
    )
    return fn(q, s, ms, ns)[:, :B]


def preds_batch_sharded(q, s, ms, ns, sc: LinearScoring, mesh: Mesh):
    """dp-sharded :func:`engine.batch.preds_batch`: per-pair predecessor
    matrices + boundary columns, batch dim distributed over ``mesh``."""
    K = _device_count(mesh)
    q, s, ms, ns, B = _pad_batch(q, s, ms, ns, K)
    ax = _axes(mesh)
    fn = jax.shard_map(
        lambda q_, s_, ms_, ns_: _batch.preds_batch(q_, s_, ms_, ns_, sc),
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax)),
        out_specs=(P(ax, None, None), P(None, ax)),
        check_vma=False,
    )
    preds, cols = fn(q, s, ms, ns)
    return preds[:B], cols[:, :B]


def _pad_flags(flags, K):
    B = flags.shape[0]
    Bp = -(-B // K) * K
    if Bp == B:
        return flags
    return jnp.concatenate([flags, jnp.zeros((Bp - B,), flags.dtype)])


def last_cols_batch_affine_sharded(q, s, ms, ns, sc, sgaps, mesh: Mesh):
    """dp-sharded :func:`engine.batch.last_cols_batch_affine`: (M, B) H
    and E boundary columns for the distributed Myers-Miller levels."""
    K = _device_count(mesh)
    sgaps = _pad_flags(sgaps, K)
    q, s, ms, ns, B = _pad_batch(q, s, ms, ns, K)
    ax = _axes(mesh)
    fn = jax.shard_map(
        lambda q_, s_, ms_, ns_, sg_: _batch.last_cols_batch_affine(
            q_, s_, ms_, ns_, sc, sg_
        ),
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax), P(ax)),
        out_specs=(P(None, ax), P(None, ax)),
        check_vma=False,
    )
    cols_h, cols_e = fn(q, s, ms, ns, sgaps)
    return cols_h[:, :B], cols_e[:, :B]


def preds_batch_affine_sharded(q, s, ms, ns, sc, sgaps, mesh: Mesh):
    """dp-sharded :func:`engine.batch.preds_batch_affine` (terminal
    Myers-Miller stripes)."""
    K = _device_count(mesh)
    sgaps = _pad_flags(sgaps, K)
    q, s, ms, ns, B = _pad_batch(q, s, ms, ns, K)
    ax = _axes(mesh)
    fn = jax.shard_map(
        lambda q_, s_, ms_, ns_, sg_: _batch.preds_batch_affine(
            q_, s_, ms_, ns_, sc, sg_
        ),
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax), P(ax)),
        out_specs=(P(ax, None, None), P(None, ax), P(None, ax)),
        check_vma=False,
    )
    preds, cols_h, cols_e = fn(q, s, ms, ns, sgaps)
    return preds[:B], cols_h[:, :B], cols_e[:, :B]


def preds_batch_full_sharded(q, s, ms, ns, mode: Mode, sc: LinearScoring,
                             mesh: Mesh):
    """dp-sharded :func:`engine.batch.preds_batch_full` (batched
    construction sweeps for any scheme)."""
    K = _device_count(mesh)
    q, s, ms, ns, B = _pad_batch(q, s, ms, ns, K)
    ax = _axes(mesh)
    fn = jax.shard_map(
        lambda q_, s_, ms_, ns_: _batch.preds_batch_full(
            q_, s_, ms_, ns_, mode, sc
        ),
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax)),
        out_specs=(P(ax, None, None), P(ax), P(ax), P(ax)),
        check_vma=False,
    )
    preds, last_row, last_col, best = fn(q, s, ms, ns)
    return preds[:B], last_row[:B], last_col[:B], best[:B]


def align_scores_batch_sharded(queries, subjects, mode="global",
                               scoring=LinearScoring(), mesh: Mesh | None = None,
                               batch_size: int = 4096):
    """Distributed version of :func:`engine.batch.align_scores_batch`:
    same bucketing/order semantics, each shape bucket dispatched as one
    dp-sharded sweep."""
    from anyseq_tpu.core.types import as_u8

    if mesh is None:
        return _batch.align_scores_batch(queries, subjects, mode, scoring,
                                         batch_size)
    mode = Mode.parse(mode)
    qs = [as_u8(x) for x in queries]
    ss = [as_u8(x) for x in subjects]
    if len(qs) != len(ss):
        raise ValueError("queries and subjects must have equal length")
    out = np.zeros(len(qs), dtype=np.int64)
    K = _device_count(mesh)
    ax = _axes(mesh)

    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (a, b) in enumerate(zip(qs, ss)):
        if len(a) == 0 or len(b) == 0:
            raise ValueError("empty sequences are not supported")
        key = (_batch._bucket(len(a)), _batch._bucket(len(b)))
        buckets.setdefault(key, []).append(idx)

    from anyseq_tpu.core.types import AffineScoring

    if isinstance(scoring, AffineScoring):
        inner = lambda q_, s_, ms_, ns_: _batch._score_batch_affine(
            q_, s_, ms_, ns_, mode, scoring
        )
        out_specs = P(ax)
    elif mode is Mode.SEMIGLOBAL:
        inner = lambda q_, s_, ms_, ns_: _batch._score_batch_semiglobal(
            q_, s_, ms_, ns_, mode, scoring
        )
        out_specs = P(ax)
    else:
        inner = lambda q_, s_, ms_, ns_: _batch._score_batch(
            q_, s_, ms_, ns_, mode, scoring
        )[0]
        out_specs = P(ax)

    for (M, N), idxs in buckets.items():
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo: lo + batch_size]
            qarr, sarr, ms, ns = _batch._stage(chunk, qs, ss, M, N)
            q_, s_, ms_, ns_, B0 = _pad_batch(
                jnp.asarray(qarr), jnp.asarray(sarr),
                jnp.asarray(ms), jnp.asarray(ns), K,
            )
            fn = jax.shard_map(
                inner, mesh=mesh,
                in_specs=(P(ax), P(ax), P(ax), P(ax)),
                out_specs=out_specs, check_vma=False,
            )
            scores = fn(q_, s_, ms_, ns_)[:B0]
            out[np.asarray(chunk)] = fetch(scores)[:B0]
    return out
