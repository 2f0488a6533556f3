"""Full jitted distributed solvers — CG / PCG across the device mesh.

The whole solver — ``lax.while_loop`` recurrence, per-lane convergence
masks, tolerance exit, error history — runs inside one ``shard_map``,
so a multi-device solve is a single dispatch, with all_gather/psum
inside the loop body.

Parity targets:
  * ``cg_solve_sharded``        — CGSolveSingle
    (``work_2025/main/single_strategy.hpp:105-170``).
  * ``cg_solve_multi_sharded``  — CGSolveMultiple with per-vector
    alpha/beta masking and max-relative-error recording
    (``no_pretreatment.hpp:35-197``, masking :109-155).
  * ``pcg_solve_multi_sharded`` — PCGSolveMultiple
    (``incomplete_cholesky.hpp:36-199``): z = (L L^T)^{-1} r via
    *sharded* fixed-sweep Jacobi triangular solves (each sweep is an
    all_gather + per-shard SpMM; exact at nilpotency depth).
  * ``spai_solve_multi_sharded`` — SPAISolveMultiple
    (``sparse_approximate_inverse.hpp:31-230``): z = M r as one more
    sharded SpMM per iteration.

All vectors live in the padded shard row layout (``D * rows_per_shard``
global rows; see ``parallel.sharded.to_padded_layout``); matrices are
row-sharded CSR (:class:`~sparsela.parallel.sharded.ShardedCsr`) whose
``col_padded`` indexes that layout. Every operand of one solve must
share one row split (``shard_csr(..., bounds=...)``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparsela.parallel.sharded import ShardedCsr, local_matvec
from sparsela.solvers.cg import CgResult


def _lsum(v):
    """Local-shard partial reduction along axis 0 feeding a psum —
    scalar for (n,) operands, (L,) for (n, L)."""
    return jnp.sum(v, axis=0)


def _mat_args(A: ShardedCsr):
    return (A.row_offsets, A.col_padded, A.values)


def _gathered_matvec(axis):
    """Local product with the full (all-gathered) operand vector."""

    def mv(ro, cp, va, v_loc):
        v_full = jax.lax.all_gather(v_loc, axis, axis=0, tiled=True)
        return local_matvec(ro[0], cp[0], va[0], v_full)

    return mv


def _put_padded(v, mesh: Mesh, axis: str):
    return jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(axis)))


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "max_iters",
                              "tolerance", "record_history"),
)
def _cg_sharded_jit(mat, b, *, mesh, axis, max_iters, tolerance,
                    record_history):
    gmv = _gathered_matvec(axis)

    def solve(ro, cp, va, b_loc):
        def mv(p):
            return gmv(ro, cp, va, p)

        b_norm = jnp.sqrt(jax.lax.psum(_lsum(b_loc * b_loc), axis))
        b_norm = jnp.where(b_norm == 0.0, 1.0, b_norm)
        x = jnp.zeros_like(b_loc)
        r = b_loc
        p = b_loc
        rs = jax.lax.psum(_lsum(r * r), axis)
        hist0 = (
            jnp.full((max_iters,), jnp.nan, dtype=b_loc.dtype)
            if record_history
            else jnp.zeros((0,), dtype=b_loc.dtype)
        )

        def cond(state):
            i, x, r, p, rs, hist = state
            return (i < max_iters) & (jnp.sqrt(rs)
                                      >= b_norm * tolerance)

        def body(state):
            i, x, r, p, rs, hist = state
            Ap = mv(p)
            pAp = jax.lax.psum(_lsum(p * Ap), axis)
            alpha = jnp.where(pAp == 0, 0.0, rs / pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = jax.lax.psum(_lsum(r * r), axis)
            if record_history:
                hist = hist.at[i].set(jnp.sqrt(rs_new) / b_norm)
            beta = jnp.where(rs == 0, 0.0, rs_new / rs)
            p = r + beta * p
            return (i + 1, x, r, p, rs_new, hist)

        i, x, r, p, rs, hist = jax.lax.while_loop(
            cond, body, (jnp.int32(0), x, r, p, rs, hist0)
        )
        rel = jnp.sqrt(rs) / b_norm
        return x, i, rel < tolerance, rel, hist

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis),) * 4,
        out_specs=(P(axis), P(), P(), P(), P()),
    )(*mat, b)


def cg_solve_sharded(A: ShardedCsr, b, mesh: Mesh,
                     axis: str = "rows", max_iters: int = 10000,
                     tolerance: float = 1e-5,
                     record_history: bool = False) -> CgResult:
    """Single-RHS CG across the mesh in ONE dispatch. ``b`` is in the
    padded shard layout (D * rows_per_shard,); so is the returned x."""
    x, i, conv, rel, hist = _cg_sharded_jit(
        _mat_args(A), _put_padded(b, mesh, axis), mesh=mesh, axis=axis,
        max_iters=int(max_iters), tolerance=float(tolerance),
        record_history=bool(record_history),
    )
    return CgResult(x=x, iterations=i, converged=conv, residual=rel,
                    history=hist)


def _multi_recurrence(matmat, precond, b_loc, axis, max_iters,
                      tolerance, record_history):
    """Shared blocked-CG/PCG recurrence on local shards. ``precond``
    maps the local residual block to the local z block (identity for
    plain CG); ``matmat`` consumes the LOCAL search block and owns its
    communication (all_gather for row-sharded CSR, ppermute halo
    exchange for the DIA path — see parallel.sharded_dia)."""
    L = b_loc.shape[1]
    b_norms = jnp.sqrt(jax.lax.psum(_lsum(b_loc * b_loc),
                                    axis))
    b_norms = jnp.where(b_norms == 0.0, 1.0, b_norms)
    X = jnp.zeros_like(b_loc)
    R = b_loc
    Z = precond(R)
    Pd = Z
    rho = jax.lax.psum(_lsum(R * Z), axis)
    converged0 = jnp.zeros((L,), dtype=bool)
    hist0 = (
        jnp.full((max_iters,), jnp.nan, dtype=b_loc.dtype)
        if record_history
        else jnp.zeros((0,), dtype=b_loc.dtype)
    )

    def cond(state):
        i, X, R, Pd, rho, converged, hist = state
        return (i < max_iters) & ~jnp.all(converged)

    def body(state):
        i, X, R, Pd, rho, converged, hist = state
        AP = matmat(Pd)
        pAp = jax.lax.psum(_lsum(Pd * AP), axis)
        # converged lanes freeze (alpha = beta = 0), SpMM stays
        # full-width — exactly no_pretreatment.hpp:109-120
        alpha = jnp.where(converged | (pAp == 0), 0.0, rho / pAp)
        X = X + alpha[None, :] * Pd
        R = R - alpha[None, :] * AP
        rs = jax.lax.psum(_lsum(R * R), axis)
        rel = jnp.sqrt(rs) / b_norms
        converged = converged | (rel < tolerance)
        if record_history:
            hist = hist.at[i].set(jnp.max(rel))
        Z = precond(R)
        rho_new = jax.lax.psum(_lsum(R * Z), axis)
        beta = jnp.where(converged | (rho == 0), 0.0, rho_new / rho)
        Pd = Z + beta[None, :] * Pd
        return (i + 1, X, R, Pd, rho_new, converged, hist)

    i, X, R, Pd, rho, converged, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, R, Pd, rho, converged0, hist0)
    )
    rs = jax.lax.psum(_lsum(R * R), axis)
    rel = jnp.sqrt(rs) / b_norms
    return X, i, converged, rel, hist


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "max_iters",
                              "tolerance", "record_history"),
)
def _cg_multi_sharded_jit(mat, B, *, mesh, axis, max_iters, tolerance,
                          record_history):
    gmv = _gathered_matvec(axis)

    def solve(ro, cp, va, B_loc):
        return _multi_recurrence(
            lambda Pl: gmv(ro, cp, va, Pl), lambda R: R, B_loc, axis,
            max_iters, tolerance, record_history,
        )

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis),) * 4,
        out_specs=(P(axis), P(), P(), P(), P()),
    )(*mat, B)


def cg_solve_multi_sharded(A: ShardedCsr, B, mesh: Mesh,
                           axis: str = "rows", max_iters: int = 10000,
                           tolerance: float = 1e-5,
                           record_history: bool = True) -> CgResult:
    """Blocked multi-RHS CG across the mesh in ONE dispatch. ``B`` is
    (D * rows_per_shard, L) in the padded layout."""
    X, i, conv, rel, hist = _cg_multi_sharded_jit(
        _mat_args(A), _put_padded(B, mesh, axis), mesh=mesh, axis=axis,
        max_iters=int(max_iters), tolerance=float(tolerance),
        record_history=bool(record_history),
    )
    return CgResult(x=X, iterations=i, converged=conv, residual=rel,
                    history=hist)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "max_iters", "tolerance",
                              "record_history", "sweeps"),
)
def _pcg_multi_sharded_jit(mat, lmat, umat, inv_d, B, *, mesh, axis,
                           max_iters, tolerance, record_history,
                           sweeps):
    gmv = _gathered_matvec(axis)

    def solve(ro, cp, va, lro, lcp, lva, uro, ucp, uva, d_loc, B_loc):
        def jacobi(strict, rhs):
            # fixed-sweep Jacobi on a triangular system: exact once
            # sweeps >= dependency depth (strict part is nilpotent);
            # the factor may be stored wider than the system dtype
            d = d_loc[:, None]

            def sweep(_, x):
                return ((rhs - gmv(*strict, x)) * d).astype(rhs.dtype)

            return jax.lax.fori_loop(0, sweeps, sweep,
                                     (rhs * d).astype(rhs.dtype))

        def precond(R):
            return jacobi((uro, ucp, uva), jacobi((lro, lcp, lva), R))

        return _multi_recurrence(
            lambda Pl: gmv(ro, cp, va, Pl), precond, B_loc, axis,
            max_iters, tolerance, record_history,
        )

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis),) * 11,
        out_specs=(P(axis), P(), P(), P(), P()),
    )(*mat, *lmat, *umat, inv_d, B)


def pcg_solve_multi_sharded(A: ShardedCsr, lt: ShardedCsr,
                            ut: ShardedCsr, inv_diag,
                            B, mesh: Mesh, axis: str = "rows",
                            max_iters: int = 10000,
                            tolerance: float = 1e-5,
                            sweeps: int = 2,
                            record_history: bool = True) -> CgResult:
    """Blocked multi-RHS PCG-IC(0) across the mesh in ONE dispatch.

    ``lt``/``ut``: the STRICT parts of the IC(0) factor L and of L^T,
    row-sharded in ``A``'s padded layout; ``inv_diag``: the factor's
    reciprocal diagonal in that layout (zero on padding rows). Use
    :func:`shard_ic0_factor`. Default sweeps=2 matches the single-device
    default (solvers.pcg.make_ic0_preconditioner — truncation is
    PCG-safe: the composite is A_f^T A_f)."""
    X, i, conv, rel, hist = _pcg_multi_sharded_jit(
        _mat_args(A), _mat_args(lt), _mat_args(ut),
        _put_padded(inv_diag, mesh, axis), _put_padded(B, mesh, axis),
        mesh=mesh, axis=axis,
        max_iters=int(max_iters), tolerance=float(tolerance),
        record_history=bool(record_history), sweeps=int(sweeps),
    )
    return CgResult(x=X, iterations=i, converged=conv, residual=rel,
                    history=hist)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "max_iters", "tolerance",
                              "record_history"),
)
def _spai_multi_sharded_jit(mat, mmat, B, *, mesh, axis, max_iters,
                            tolerance, record_history):
    gmv = _gathered_matvec(axis)

    def solve(ro, cp, va, mro, mcp, mva, B_loc):
        return _multi_recurrence(
            lambda Pl: gmv(ro, cp, va, Pl),
            lambda R: gmv(mro, mcp, mva, R), B_loc, axis,
            max_iters, tolerance, record_history,
        )

    return jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(P(axis),) * 7,
        out_specs=(P(axis), P(), P(), P(), P()),
    )(*mat, *mmat, B)


def spai_solve_multi_sharded(A: ShardedCsr, M: ShardedCsr, B,
                             mesh: Mesh, axis: str = "rows",
                             max_iters: int = 10000,
                             tolerance: float = 1e-5,
                             record_history: bool = True) -> CgResult:
    """Blocked multi-RHS SPAI-CG across the mesh in ONE dispatch:
    both A and the explicit approximate inverse M are row-sharded CSR
    in one padded layout."""
    X, i, conv, rel, hist = _spai_multi_sharded_jit(
        _mat_args(A), _mat_args(M), _put_padded(B, mesh, axis),
        mesh=mesh, axis=axis, max_iters=int(max_iters),
        tolerance=float(tolerance), record_history=bool(record_history),
    )
    return CgResult(x=X, iterations=i, converged=conv, residual=rel,
                    history=hist)


def shard_bounds(A: ShardedCsr):
    """The (n_shards + 1,) row split of ``A`` — pass it to
    ``shard_csr(..., bounds=...)`` so another matrix shares A's padded
    layout."""
    import numpy as np

    return np.concatenate(
        [np.asarray(A.row_start, dtype=np.int64), [A.num_rows]])


def shard_ic0_factor(L_host, A: ShardedCsr, dtype=None):
    """Prepare the sharded IC(0) preconditioner operands from a host
    lower-triangular factor: strict(L) and strict(L^T) as row-sharded
    CSR in A's padded layout, plus the reciprocal diagonal in that
    layout.

    ``dtype`` casts the factor before sharding (the IC(0) factor is
    fp64 from the host factorization; fp32 systems should pass fp32 so
    the sweep SpMMs don't run in f64 — see
    precond.trisolve.jacobi_trisolve_lower).

    Returns (lt, ut, inv_diag)."""
    import numpy as np

    from sparsela.parallel.sharded import shard_csr, to_padded_layout
    from sparsela.precond.trisolve import split_diag

    if dtype is not None:
        L_host = L_host.astype(dtype)
    bounds = shard_bounds(A)
    strict_l, diag = split_diag(L_host)
    strict_u, _ = split_diag(L_host.transpose())
    lt = shard_csr(strict_l, A.num_shards, bounds=bounds)
    ut = shard_csr(strict_u, A.num_shards, bounds=bounds)
    slabs = shard_csr(L_host, A.num_shards, bounds=bounds)
    inv_d = to_padded_layout(1.0 / diag, slabs)
    return lt, ut, np.asarray(inv_d)
