"""Subject-sharded single-pair wavefront over a device mesh ("sp" mode).

The DP matrix's subject axis is split into K contiguous stripes, one per
device on the "sp" mesh axis. Bands of H query rows flow through the chips
as a software pipeline: at super-step u, device k relaxes band (u - k) of
its stripe and then sends its right-edge boundary column (H values + the
corner) to device k+1 with ``jax.lax.ppermute``, which XLA hands to the
collective library (NCCL over NVLink on GPUs) -- the distributed analog of
the reference's corner/row/column boundary vectors between blocks
(scoring_cpu.impala:11-33). All devices work concurrently on successive
bands after a K-step fill, like the reference's intra-device block
wavefront (iteration_cpu.impala:23-27) lifted across devices.

Pipeline efficiency: (B bands) / (B + K - 1 super-steps); choose H so that
B >> K. Each band of a stripe is relaxed by the XLA row-scan with
max-plus prefix scans (engine/xla_linmem.py, engine/xla_affine.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from anyseq_tpu.core.types import (
    PAD_Q,
    PAD_S,
    SCORE_MIN,
    AffineScoring,
    LinearScoring,
    Mode,
    Score,
)
from anyseq_tpu.engine import route, xla_linmem
from anyseq_tpu.engine.xla_affine import NEG, _shift1


def _round_up(x, m):
    return (x + m - 1) // m * m


def _band_compute(q_band, s_loc, row_in, col_in, j0, i0, h_local, n,
                  mode, sc):
    """Relax one band (H rows) of one stripe.

    q_band: (H,) query symbols of the band.
    s_loc: (Nl,) stripe subject symbols.
    row_in: (Nl,) boundary row = cells (i0-1, j) for this stripe.
    col_in: (H+1,) [0] = corner cell(i0-1, j0-1), [r+1] = cell(i0+r, j0-1).
    Returns (row_out, col_out, ecol, best) where row_out = cells
    (i0+h_local-1, j), col_out has the same layout as col_in but for the
    stripe's right edge, ecol[r] = cell(i0+r, n-1) if this stripe owns
    column n-1 (garbage otherwise), best = (score, i, j) running local max.
    """
    H = q_band.shape[0]
    Nl = s_loc.shape[0]
    jg = jnp.arange(Nl, dtype=Score) * sc.gap
    jmask = j0 + jnp.arange(Nl) < n
    e_loc = jnp.clip(n - 1 - j0, 0, Nl - 1)

    def body(r, carry):
        prev, col_out, ecol, best = carry
        active = r < h_local
        row = xla_linmem._row_update(
            prev, q_band[r], s_loc, col_in[r + 1], col_in[r], jg, mode, sc
        )
        row = jnp.where(active, row, prev)
        col_out = col_out.at[r + 1].set(
            jnp.where(active, row[Nl - 1], col_out[r + 1])
        )
        ecol = ecol.at[r].set(row[e_loc])
        if mode is Mode.LOCAL:
            masked = jnp.where(jmask, row, SCORE_MIN)
            rmax = jnp.max(masked)
            rarg = jnp.argmax(masked)
            take = jnp.logical_and(active, rmax > best[0])
            best = jnp.where(
                take,
                jnp.stack([rmax, (i0 + r).astype(Score),
                           (j0 + rarg).astype(Score)]),
                best,
            )
        return row, col_out, ecol, best

    col_out0 = jnp.zeros((H + 1,), Score).at[0].set(row_in[Nl - 1])
    init = (
        row_in,
        col_out0,
        jnp.zeros((H,), Score),
        jnp.array([SCORE_MIN, -1, -1], Score),
    )
    row_out, col_out, ecol, best = jax.lax.fori_loop(0, H, body, init)
    return row_out, col_out, ecol, best


def _band_compute_affine(q_band, s_loc, row_in, rowf_in, col_in, cole_in,
                         j0, i0, h_local, n, mode, sc):
    """Affine (Gotoh) analog of :func:`_band_compute`: the portable XLA
    row-scan over one band of one stripe, with explicit H/F boundary rows
    and H/E boundary columns (the reference's linear-memory boundary
    vectors, scoring.impala:218-259, extended with the Gotoh gap state).

    col_in: (H+1,) H boundary column incl. corner (same layout as the
    linear path); cole_in: (H,) E boundary column E[i0+r][j0-1].
    Returns (row_out, rowf_out, col_out, cole_out, ecol, ecol_e, best).
    """
    go, ge = sc.gap_open, sc.gap_extend
    H = q_band.shape[0]
    Nl = s_loc.shape[0]
    jge = jnp.arange(Nl, dtype=Score) * ge
    jmask = j0 + jnp.arange(Nl) < n
    e_loc = jnp.clip(n - 1 - j0, 0, Nl - 1)

    def body(r, carry):
        (H_prev, F_prev, col_out, cole_out, ecol, ecole, best) = carry
        active = r < h_local
        F = jnp.maximum(H_prev + go + ge, F_prev + ge)
        diag = _shift1(H_prev, col_in[r])
        sub = jnp.where(q_band[r] == s_loc, sc.match,
                        sc.mismatch).astype(Score)
        T = jnp.maximum(diag + sub, F)
        if mode is Mode.LOCAL:
            T = jnp.maximum(T, 0)
        cm = jax.lax.cummax(T - jge)
        # E-run candidates: open after any T[k<j], open from the H
        # boundary column, or continue the E boundary run.
        E = jge + jnp.maximum(
            go + jnp.maximum(_shift1(cm, NEG), col_in[r + 1] + ge),
            cole_in[r] + ge,
        )
        Hrow = jnp.maximum(T, E)
        Hrow = jnp.where(active, Hrow, H_prev)
        F = jnp.where(active, F, F_prev)
        col_out = col_out.at[r + 1].set(
            jnp.where(active, Hrow[Nl - 1], col_out[r + 1])
        )
        cole_out = cole_out.at[r].set(
            jnp.where(active, E[Nl - 1], cole_out[r])
        )
        ecol = ecol.at[r].set(Hrow[e_loc])
        ecole = ecole.at[r].set(E[e_loc])
        if mode is Mode.LOCAL:
            masked = jnp.where(jmask, Hrow, SCORE_MIN)
            rmax = jnp.max(masked)
            rarg = jnp.argmax(masked)
            take = jnp.logical_and(active, rmax > best[0])
            best = jnp.where(
                take,
                jnp.stack([rmax, (i0 + r).astype(Score),
                           (j0 + rarg).astype(Score)]),
                best,
            )
        return Hrow, F, col_out, cole_out, ecol, ecole, best

    col_out0 = jnp.zeros((H + 1,), Score).at[0].set(row_in[Nl - 1])
    init = (
        row_in,
        rowf_in,
        col_out0,
        jnp.full((H,), NEG, Score),
        jnp.zeros((H,), Score),
        jnp.full((H,), NEG, Score),
        jnp.array([SCORE_MIN, -1, -1], Score),
    )
    row_out, rowf_out, col_out, cole_out, ecol, ecole, best = (
        jax.lax.fori_loop(0, H, body, init)
    )
    return row_out, rowf_out, col_out, cole_out, ecol, ecole, best


@functools.partial(
    jax.jit,
    static_argnames=("mode", "sc", "H", "mesh", "axis", "start_gap"),
)
def _sharded_score(q, s_sh, row0_sh, rowf0_sh, m, n, mode: Mode, sc,
                   H: int, mesh: Mesh, axis: str = "sp",
                   start_gap: bool = False):
    """q: (M_pad,) replicated; s_sh/row0_sh (affine: + rowf0_sh): (N_pad,)
    sharded over axis. The superstep ppermute message carries the H
    boundary column (+ corner); affine scoring appends the E boundary
    column (H more values) to the same message and also carries the F
    boundary row between bands -- the full Gotoh state of the reference's
    boundary vectors."""
    affine = isinstance(sc, AffineScoring)
    go, ge = ((sc.gap_open, sc.gap_extend) if affine else (0, 0))
    M_pad = q.shape[0]
    B = M_pad // H
    K = mesh.shape[axis]

    def run(q_full, s_loc, row_loc, rowf_loc):
        k = jax.lax.axis_index(axis)
        Nl = s_loc.shape[0]
        j0 = k * Nl
        S = B + K - 1

        def superstep(carry, u):
            (row_loc, rowf_loc, col_in, ecol_acc, ecole_acc,
             best) = carry
            band = u - k
            active = jnp.logical_and(band >= 0, band < B)
            i0 = jnp.where(active, band, 0) * H
            h_local = jnp.clip(m - i0, 0, H)
            q_band = jax.lax.dynamic_slice(q_full, (i0,), (H,))

            # chip 0's left boundary is the init formula, not a message
            if mode is Mode.GLOBAL and affine:
                if start_gap:
                    # Myers-Miller continuing-run init: unreachable left
                    # column and corner.
                    col_form = jnp.full((H + 1,), NEG, Score)
                else:
                    col_form = go + (
                        i0 + jnp.arange(H + 1, dtype=Score)
                    ) * ge
                    col_form = col_form.at[0].set(
                        jnp.where(i0 == 0, 0, col_form[0])
                    )
                cole_form = jnp.full((H,), NEG, Score)
            elif mode is Mode.GLOBAL:
                col_form = (i0 + jnp.arange(H + 1, dtype=Score)) * sc.gap
                cole_form = None
            else:
                col_form = jnp.zeros((H + 1,), Score)
                cole_form = (jnp.full((H,), NEG, Score)
                             if affine else None)
            if affine:
                col_bnd = jnp.where(k == 0, col_form, col_in[:H + 1])
                cole_bnd = jnp.where(k == 0, cole_form, col_in[H + 1:])
            else:
                col_bnd = jnp.where(k == 0, col_form, col_in)

            if affine:
                (row2, rowf2, col_out, cole_out, ecol, ecole,
                 bbest) = _band_compute_affine(
                    q_band, s_loc, row_loc, rowf_loc, col_bnd, cole_bnd,
                    j0, i0, h_local, n, mode, sc,
                )
            else:
                row2, col_out, ecol, bbest = _band_compute(
                    q_band, s_loc, row_loc, col_bnd, j0, i0, h_local, n,
                    mode, sc,
                )
            row_loc = jnp.where(active, row2, row_loc)
            ecol_acc = jnp.where(
                active,
                jax.lax.dynamic_update_slice(ecol_acc, ecol, (i0,)),
                ecol_acc,
            )
            if affine:
                rowf_loc = jnp.where(active, rowf2, rowf_loc)
                ecole_acc = jnp.where(
                    active,
                    jax.lax.dynamic_update_slice(ecole_acc, ecole, (i0,)),
                    ecole_acc,
                )
            if mode is Mode.LOCAL:
                take = jnp.logical_and(active, bbest[0] > best[0])
                best = jnp.where(take, bbest, best)

            if affine:
                col_all = jnp.concatenate([col_out, cole_out])
            else:
                col_all = col_out
            col_msg = jnp.where(active, col_all, col_in)
            col_in_next = jax.lax.ppermute(
                col_msg, axis, [(i, (i + 1) % K) for i in range(K)]
            )
            return (row_loc, rowf_loc, col_in_next, ecol_acc, ecole_acc,
                    best), None

        msg_len = (2 * H + 1) if affine else (H + 1)
        init = (
            row_loc,
            rowf_loc,
            jnp.zeros((msg_len,), Score),
            jnp.zeros((M_pad,), Score),
            (jnp.full((M_pad,), NEG, Score) if affine
             else jnp.zeros((1,), Score)),
            jnp.array([SCORE_MIN, -1, -1], Score),
        )
        (row_loc, rowf_loc, _, ecol_acc, ecole_acc, best), _ = (
            jax.lax.scan(superstep, init, jnp.arange(S))
        )

        # Only the stripe owning column n-1 has a valid ecol; zero others
        # then psum to replicate.
        owns = jnp.logical_and(j0 <= n - 1, n - 1 < j0 + Nl)
        ecol_acc = jnp.where(owns, ecol_acc, 0)
        ecol_all = jax.lax.psum(ecol_acc, axis)
        ecole_all = jax.lax.psum(
            jnp.where(owns, ecole_acc, 0), axis
        ) if affine else ecole_acc

        # local best: lexicographic (score, -i, -j) max across chips.
        if mode is Mode.LOCAL:
            from anyseq_tpu.dist.mesh import lex_best_merge

            best = lex_best_merge(best, axis, K)
        return row_loc, rowf_loc, ecol_all, ecole_all, best

    row_out, rowf_out, ecol, ecole, best = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(), P(), P()),
        check_vma=False,
    )(q, s_sh, row0_sh, rowf0_sh)

    out = {"last_row": row_out, "last_col": ecol, "best": best}
    if affine:
        out["last_col_e"] = ecole
        out["last_row_f"] = rowf_out
    return out


def score_pair_sharded(query, subject, mode, sc, mesh: Mesh,
                       H: int = 4096, axis: str = "sp",
                       engine: str = "auto", start_gap: bool = False):
    """Distributed score-only alignment of one (large) pair. ``sc`` may
    be LinearScoring or AffineScoring (full Gotoh state in the superstep
    messages; ``start_gap`` is the Myers-Miller continuing-run init for
    distributed affine construction).

    engine: "auto" or "xla"; every band of every stripe is relaxed by
    the XLA row-scan.

    Returns the same outputs dict as xla_linmem.score_rows; combine with
    xla_linmem.extract_score_from_outputs.
    """
    from anyseq_tpu.core.types import as_u8

    mode = Mode.parse(mode)
    q8 = as_u8(query)
    s8 = as_u8(subject)
    m, n = len(q8), len(s8)
    if m == 0 or n == 0:
        raise ValueError("empty sequences are not supported")
    route.check(engine)
    affine = isinstance(sc, AffineScoring)
    if start_gap and not (affine and mode is Mode.GLOBAL):
        raise ValueError("start_gap is an affine GLOBAL (Myers-Miller) "
                         "subproblem flag")
    K = mesh.shape[axis]
    Nl = _round_up(max(n, 1), 128 * K) // K
    N_pad = Nl * K
    M_pad = _round_up(m, H)

    q = jnp.full((M_pad,), PAD_Q,
                 jnp.int32).at[:m].set(q8.astype(np.int32))
    s = jnp.full((N_pad,), PAD_S,
                 jnp.int32).at[:n].set(s8.astype(np.int32))
    jarr = jnp.arange(N_pad, dtype=Score)
    if mode is Mode.GLOBAL and affine:
        row0 = ((jarr + 1) * sc.gap_extend
                + (0 if start_gap else sc.gap_open))
    elif mode is Mode.GLOBAL:
        row0 = (jarr + 1) * sc.gap
    else:
        row0 = jnp.zeros_like(jarr)
    rowf0 = jnp.full((N_pad,), NEG if affine else 0, Score)

    shard = NamedSharding(mesh, P(axis))
    s = jax.device_put(s, shard)
    row0 = jax.device_put(row0, shard)
    rowf0 = jax.device_put(rowf0, shard)

    return _sharded_score(q, s, row0, rowf0, jnp.int32(m), jnp.int32(n),
                          mode, sc, H, mesh, axis, start_gap=start_gap)
