"""PCG — preconditioned conjugate gradient with IC(0).

Capability parity with ``PCGSolveMultiple``
(``work_2025/main/incomplete_cholesky.hpp:36-199``):
CG with z = (L L^T)^{-1} r applied each iteration via two triangular
solves, rho = r.z recurrences, per-lane convergence masks identical to
the unpreconditioned solver. The preconditioner application is
pluggable: a :class:`sparsela.precond.trisolve.JacobiTriSolver` pair
(fully jitted device path) or exact level-scheduled solves (parity
oracle).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from sparsela.ops.blas import (
    axpy_multiple,
    dot_multiple,
    update_p_multiple,
)
from sparsela.ops.spmv import spmm
from sparsela.solvers.cg import CgResult


def pcg_solve_multi(
    A,
    B,
    apply_precond: Callable,
    max_iters: int = 10000,
    tolerance: float = 1e-5,
    strategy: str = "auto",
    matmat: Callable | None = None,
    record_history: bool = True,
) -> CgResult:
    """Blocked multi-RHS PCG. ``apply_precond(R) -> Z`` applies
    z = M^{-1} r column-wise (e.g. forward+backward Jacobi tri-solves
    for IC(0), or an SpMM for SPAI — see spai_cg.py).

    Pure-DIA plans take the transposed-space path (state in (L, n);
    the apply stays a black-box (n, L) callable behind two boundary
    transposes), as ``cg_solve_multi`` does. Multi-RHS dots are plain
    column sums on both paths."""
    if matmat is None:
        from sparsela.solvers.cg import _transposed_matmat_of

        mm_t = _transposed_matmat_of(A)
        if mm_t is not None:
            return _pcg_solve_multi_transposed(
                mm_t, jnp.asarray(B), apply_precond, max_iters,
                tolerance, record_history)
    mm = matmat if matmat is not None else (
        lambda V: spmm(A, V, strategy=strategy)
    )
    n, L = B.shape
    X = jnp.zeros_like(B)
    R = B
    # the preconditioner may apply in a different precision (the IC(0)
    # factor is fp64); cast back so the CG recurrence stays in B's dtype
    Z = apply_precond(R).astype(B.dtype)
    P = Z
    b_norms = jnp.sqrt(dot_multiple(B, B))
    b_norms = jnp.where(b_norms == 0.0, 1.0, b_norms)
    rho_old = dot_multiple(R, Z)
    converged0 = jnp.zeros((L,), dtype=bool)
    hist0 = (
        jnp.full((max_iters,), jnp.nan, dtype=B.dtype)
        if record_history
        else jnp.zeros((0,), dtype=B.dtype)
    )

    def cond(state):
        i, X, R, P, rho_old, converged, hist = state
        return (i < max_iters) & ~jnp.all(converged)

    def body(state):
        i, X, R, P, rho_old, converged, hist = state
        AP = mm(P)
        pAp = dot_multiple(P, AP)
        alpha = jnp.where(converged | (pAp == 0), 0.0, rho_old / pAp)
        X = axpy_multiple(X, alpha, P)
        R = axpy_multiple(R, -alpha, AP)
        r_norms = dot_multiple(R, R)
        rel = jnp.sqrt(r_norms) / b_norms
        converged = converged | (rel < tolerance)
        if record_history:
            hist = hist.at[i].set(jnp.max(rel))
        Z = apply_precond(R).astype(B.dtype)
        rho_new = dot_multiple(R, Z)
        beta = jnp.where(converged | (rho_old == 0), 0.0,
                         rho_new / rho_old)
        P = update_p_multiple(Z, beta, P)
        return (i + 1, X, R, P, rho_new, converged, hist)

    i, X, R, P, rho, converged, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, R, P, rho_old, converged0, hist0)
    )
    rs = dot_multiple(R, R)
    rel = jnp.sqrt(rs) / b_norms
    return CgResult(
        x=X, iterations=i, converged=converged, residual=rel, history=hist
    )


def _pcg_solve_multi_transposed(spmm_t, B, apply_precond, max_iters,
                                tolerance, record_history) -> CgResult:
    """PCG with state in (L, n) (see pcg_solve_multi): the A-matvec is
    a transposed-layout callable (cg._transposed_matmat_of), per-RHS
    alpha/beta/masks are (L, 1) broadcasts; ``apply_precond`` keeps
    its (n, L) contract behind two boundary transposes per iteration.
    Recurrences, masking, and history match the generic path
    (incomplete_cholesky.hpp:36-199); only the dots' fp reduction
    order differs (axis-1 sums)."""
    BT = B.T  # (L, n)
    L = BT.shape[0]

    def apply_t(RT):
        return apply_precond(RT.T).astype(B.dtype).T

    X = jnp.zeros_like(BT)
    R = BT
    Z = apply_t(R)
    P = Z
    b_norms = jnp.sqrt(jnp.sum(BT * BT, axis=1))
    b_norms = jnp.where(b_norms == 0.0, 1.0, b_norms)
    rho_old = jnp.sum(R * Z, axis=1)
    converged0 = jnp.zeros((L,), dtype=bool)
    hist0 = (
        jnp.full((max_iters,), jnp.nan, dtype=B.dtype)
        if record_history
        else jnp.zeros((0,), dtype=B.dtype)
    )

    def cond(state):
        i, X, R, P, rho_old, converged, hist = state
        return (i < max_iters) & ~jnp.all(converged)

    def body(state):
        i, X, R, P, rho_old, converged, hist = state
        AP = spmm_t(P).astype(B.dtype)
        pAp = jnp.sum(P * AP, axis=1)
        alpha = jnp.where(converged | (pAp == 0), 0.0, rho_old / pAp)
        X = X + alpha[:, None] * P
        R = R - alpha[:, None] * AP
        r_norms = jnp.sum(R * R, axis=1)
        rel = jnp.sqrt(r_norms) / b_norms
        converged = converged | (rel < tolerance)
        if record_history:
            hist = hist.at[i].set(jnp.max(rel))
        Z = apply_t(R)
        rho_new = jnp.sum(R * Z, axis=1)
        beta = jnp.where(converged | (rho_old == 0), 0.0,
                         rho_new / rho_old)
        P = Z + beta[:, None] * P
        return (i + 1, X, R, P, rho_new, converged, hist)

    i, X, R, P, rho, converged, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, R, P, rho_old, converged0, hist0)
    )
    rs = jnp.sum(R * R, axis=1)
    rel = jnp.sqrt(rs) / b_norms
    return CgResult(
        x=X.T, iterations=i, converged=converged,
        residual=rel,
        history=hist,
    )


def make_ic0_preconditioner(L_host, sweeps: int = 2, to_plan=None,
                            num_rhs: int = 16, dtype=None):
    """Build the z = (L L^T)^{-1} r application from a host IC(0) factor
    using device Jacobi triangular solves (exact once ``sweeps`` reaches
    the factor's dependency depth — strictly triangular iteration
    matrices are nilpotent).

    The truncated composite is PCG-safe at ANY sweep count: the
    backward operator is exactly the transpose of the forward one, so
    M^{-1} = A_f^T A_f is symmetric PSD regardless of truncation.
    Default sweeps=2: deeper sweeps buy a few percent fewer PCG
    iterations at several times the per-iteration cost (time to
    tolerance on the card: not measured).

    Pass ``dtype`` = the system dtype for fp32 solves: the IC(0)
    factor is fp64 (host factorization), and planning it uncast makes
    every sweep SpMM run in fp64 (see jacobi_trisolve_lower)."""
    from sparsela.precond.trisolve import (
        jacobi_trisolve_lower,
        jacobi_trisolve_upper,
    )

    fwd = jacobi_trisolve_lower(L_host, sweeps=sweeps, to_plan=to_plan,
                                num_rhs=num_rhs, dtype=dtype)
    bwd = jacobi_trisolve_upper(L_host, sweeps=sweeps, to_plan=to_plan,
                                num_rhs=num_rhs, dtype=dtype)

    def apply_precond(R):
        Y = fwd.solve(R)
        return bwd.solve(Y)

    return apply_precond


def make_exact_ic0_preconditioner(L_host):
    """Reference-parity IC(0) application: EXACT forward/backward
    triangular solves via level scheduling
    (precond.trisolve.LevelScheduledSolver) — z = (L L^T)^{-1} r to
    machine precision, so PCG iteration counts are directly comparable
    to the reference's exact-substitution PCG
    (``incomplete_cholesky.hpp:36-199``,
    ``cg/incomplete_cholesky_decomp.hpp:246-341``); parity is pinned
    (±1 iteration vs a host oracle) in tests/test_solvers.py.

    The Jacobi ``make_ic0_preconditioner`` (sweeps=2) is the default:
    its truncated composite M^{-1} = A_f^T A_f costs a few percent
    extra PCG iterations, while level scheduling serializes on the
    factor's dependency depth (a 3-D Laplacian factor has
    O(grid-width) levels -> O(width) sequential device steps per
    application)."""
    from sparsela.precond.trisolve import (
        level_trisolve_lower,
        level_trisolve_upper,
    )

    fwd = level_trisolve_lower(L_host)
    bwd = level_trisolve_upper(L_host)

    def apply_precond(R):
        return bwd.solve(fwd.solve(R))

    return apply_precond
