"""Conjugate-gradient solvers: single-RHS and blocked multi-RHS.

Capability parity with the reference solvers, re-designed as jitted
``lax.while_loop`` programs:

  * ``cg_solve``       — CGSolveSingle
    (``work_2025/main/single_strategy.hpp:105-170``).
  * ``cg_solve_multi`` — CGSolveMultiple
    (``work_2025/main/no_pretreatment.hpp:35-197``):
    simultaneous CG over L right-hand sides with per-vector alpha/beta
    and convergence masks — converged lanes get alpha = beta = 0 (x and
    r freeze, p follows r), while the SpMM keeps running full-width,
    exactly as the reference does for SIMD efficiency.

Convergence rule (parity with ``no_pretreatment.hpp:130-155``):
``sqrt(r.r) / ||b|| < tolerance`` per lane, with ``||b|| == 0``
replaced by 1. The per-iteration maximum relative error across lanes is
recorded (the reference's ``max_errors`` history, written to CSV by
``cpu_multicg.cpp:67-86``) into a fixed-size device array.

Preconditioned variants live in :mod:`sparsela.solvers.pcg` (IC(0)) and
:mod:`sparsela.solvers.spai_cg` (SPAI).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from sparsela.ops.blas import (
    axpy_multiple,
    dot_multiple,
    dot_single,
    update_p_multiple,
)
from sparsela.ops.spmv import spmm, spmv


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CgResult:
    x: Any              # solution (n,) or (n, L)
    iterations: Any     # int32 scalar — iterations executed
    converged: Any      # bool scalar or (L,) mask
    residual: Any       # final relative residual(s)
    history: Any        # (max_iters,) max relative error per iteration
                        # (NaN beyond the executed range)

    def tree_flatten(self):
        return (
            (self.x, self.iterations, self.converged, self.residual,
             self.history),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _matvec(A, strategy):
    return lambda v: spmv(A, v, strategy=strategy)


def _matmat(A, strategy):
    return lambda V: spmm(A, V, strategy=strategy)


def _plan_bakeable(A) -> bool:
    """True when the jitted solve closes over the plan as compile-time
    constants instead of tracing it as an operand.

    DIA-family plans qualify: their planes (or bitmask words) are
    elementwise operands XLA can fuse and place as constants; gather
    plans keep the shape-cached argument dispatch and its
    compile-sharing across same-shaped matrices. Constants are compiled
    into the executable, so plans above ``BAKE_MAX_BYTES`` keep
    argument dispatch to bound compile time and executable size."""
    from sparsela.formats.dia import DiaDevice
    from sparsela.ops.hybrid import HybridPlan
    from sparsela.ops.reorder import ReorderedPlan

    if isinstance(A, ReorderedPlan):
        return _plan_bakeable(A.inner)
    if not isinstance(A, (HybridPlan, DiaDevice)):
        return False
    nbytes = sum(
        getattr(leaf, "nbytes", 0)
        for leaf in jax.tree_util.tree_leaves(A)
    )
    return nbytes <= BAKE_MAX_BYTES


# Largest plan (bytes) baked as executable constants; see
# _plan_bakeable.
BAKE_MAX_BYTES = 64 * 1024 * 1024


def _baked_worker(A, key, build):
    """Per-plan cache of jitted solvers with the plan closed over.

    The cache lives on the plan object itself (``_sparsela_baked``),
    so executables die with the plan — no global registry, no stale
    ``id()`` reuse. Returns None when the plan can't carry a cache
    (fall back to the argument dispatch)."""
    try:
        cache = A.__dict__.setdefault("_sparsela_baked", {})
    except (AttributeError, TypeError):
        return None
    fn = cache.get(key)
    if fn is None:
        fn = build()
        cache[key] = fn
    return fn


def cg_solve(
    A,
    b,
    max_iters: int = 10000,
    tolerance: float = 1e-5,
    strategy: str = "auto",
    x0=None,
    matvec: Callable | None = None,
    record_history: bool = False,
    bake: bool | None = None,
) -> CgResult:
    """Single-RHS CG (parity: CGSolveSingle, single_strategy.hpp:105-170).

    Textbook CG from x0 = 0: r = p = b; per iteration
    alpha = rs/(p.Ap); x += alpha p; r -= alpha Ap;
    converged when sqrt(rs_new) < ||b|| * tolerance;
    beta = rs_new/rs_old; p = r + beta p.

    Jit-dispatched for the common case (no custom matvec / x0): the
    whole solve is one device dispatch.

    ``bake`` closes the plan over the jitted solve as a compile-time
    constant instead of tracing it as an operand (see
    ``_plan_bakeable``). None = auto (DIA-family plans within the size
    bound); the executable is cached
    on the plan object, keyed by (b shape/dtype, solver statics), so
    repeated solves with new right-hand sides reuse it.
    """
    if matvec is None and x0 is None:
        if bake is None:
            bake = _plan_bakeable(A)
        if bake:
            b = jnp.asarray(b)
            key = ("cg", b.shape, str(b.dtype),
                   int(max_iters), float(tolerance), str(strategy),
                   bool(record_history))
            fn = _baked_worker(A, key, lambda: jax.jit(
                lambda b_: _cg_solve_impl(
                    A, b_, int(max_iters), float(tolerance), strategy,
                    None, None, bool(record_history))))
            if fn is not None:
                return fn(b)
        return _cg_solve_jit(A, b, int(max_iters), float(tolerance),
                             strategy, bool(record_history))
    return _cg_solve_impl(A, b, max_iters, tolerance, strategy, x0,
                          matvec, record_history)


def _cg_solve_impl(A, b, max_iters, tolerance, strategy, x0, matvec,
                   record_history) -> CgResult:
    from sparsela.ops.reorder import ReorderedPlan

    unpermute = None
    if isinstance(A, ReorderedPlan) and matvec is None and x0 is None:
        # solve in the permuted space (traced INSIDE the jitted
        # worker — still one host dispatch): one gather of b in, one
        # of x out, instead of two per iteration. Residual norms and
        # the iteration trajectory are permutation-invariant.
        b = A.apply_perm(b)
        unpermute = A.apply_inv
        A = A.inner
    mv = matvec if matvec is not None else _matvec(A, strategy)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - mv(x) if x0 is not None else b
    p = r
    rs = dot_single(r, r)
    b_norm = jnp.sqrt(dot_single(b, b))
    b_norm = jnp.where(b_norm == 0.0, 1.0, b_norm)
    threshold = b_norm * tolerance
    hist0 = (
        jnp.full((max_iters,), jnp.nan, dtype=b.dtype)
        if record_history
        else jnp.zeros((0,), dtype=b.dtype)
    )

    def cond(state):
        i, x, r, p, rs, hist = state
        return (i < max_iters) & (jnp.sqrt(rs) >= threshold)

    def body(state):
        i, x, r, p, rs, hist = state
        Ap = mv(p)
        pAp = dot_single(p, Ap)
        alpha = jnp.where(pAp == 0, 0.0, rs / pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dot_single(r, r)
        if record_history:
            hist = hist.at[i].set(jnp.sqrt(rs_new) / b_norm)
        # rs == 0 means the residual underflowed to exactly zero (fp32
        # long past convergence — e.g. a tolerance=0 measurement run):
        # 0/0 would NaN the state and break the loop's iteration count;
        # freeze p on r instead, mirroring the multi-RHS mask.
        beta = jnp.where(rs == 0, 0.0, rs_new / rs)
        p = r + beta * p
        return (i + 1, x, r, p, rs_new, hist)

    i, x, r, p, rs, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x, r, p, rs, hist0)
    )
    rel = jnp.sqrt(rs) / b_norm
    return CgResult(
        x=x if unpermute is None else unpermute(x),
        iterations=i,
        converged=rel < tolerance,
        residual=rel,
        history=hist,
    )


def cg_solve_multi(
    A,
    B,
    max_iters: int = 10000,
    tolerance: float = 1e-5,
    strategy: str = "auto",
    matmat: Callable | None = None,
    record_history: bool = True,
    bake: bool | None = None,
) -> CgResult:
    """Blocked multi-RHS CG (parity: CGSolveMultiple,
    no_pretreatment.hpp:35-197). B is (n, L); solves A X = B for all L
    columns simultaneously with per-lane convergence masking.

    Jit-dispatched when no custom matmat is given (see cg_solve);
    ``bake`` as in cg_solve (plan closed over as a constant on the
    DIA/Hybrid path)."""
    if matmat is None:
        if bake is None:
            bake = _plan_bakeable(A)
        if bake:
            B = jnp.asarray(B)
            key = ("cg_multi", B.shape, str(B.dtype),
                   int(max_iters), float(tolerance), str(strategy),
                   bool(record_history))
            fn = _baked_worker(A, key, lambda: jax.jit(
                lambda B_: _cg_solve_multi_impl(
                    A, B_, int(max_iters), float(tolerance), strategy,
                    None, bool(record_history))))
            if fn is not None:
                return fn(B)
        return _cg_solve_multi_jit(A, B, int(max_iters),
                                   float(tolerance), strategy,
                                   bool(record_history))
    return _cg_solve_multi_impl(A, B, max_iters, tolerance, strategy,
                                matmat, record_history)


def _pure_dia_of(A):
    """The DiaDevice behind a plan when the WHOLE matrix is diagonal
    runs (HybridPlan with no scattered remainder, or a bare DiaDevice);
    None otherwise. Gates the transposed-space multi-RHS fast path."""
    from sparsela.formats.dia import DiaDevice
    from sparsela.ops.hybrid import HybridPlan

    if isinstance(A, DiaDevice):
        return A
    if (isinstance(A, HybridPlan) and A.rest is None
            and isinstance(A.dia, DiaDevice)):
        return A.dia
    return None


def _transposed_matmat_of(A):
    """Transposed-layout SpMM callable ``(L, n) -> (L, n)`` when the
    whole plan is diagonal runs (a bare DiaDevice, or a HybridPlan with
    no scattered remainder); None otherwise. Gates the multi-RHS
    transposed-state path, whose state keeps rows on the contiguous
    axis for any L."""
    from sparsela.ops.dia import spmm_dia_t

    D = _pure_dia_of(A)
    if D is None:
        return None
    return lambda P: spmm_dia_t(D, P)


def _cg_solve_multi_impl(A, B, max_iters, tolerance, strategy, matmat,
                         record_history) -> CgResult:
    from sparsela.ops.reorder import ReorderedPlan

    inv_perm = None
    if isinstance(A, ReorderedPlan) and matmat is None:
        # permuted-space solve (see _cg_solve_impl): two gathers per
        # SOLVE instead of two per iteration, still one dispatch
        B = jnp.asarray(B)[A.perm]
        inv_perm = A.inv_perm
        A = A.inner
    if matmat is None:
        mm_t = _transposed_matmat_of(A)
        if mm_t is not None:
            return _cg_solve_multi_transposed(
                mm_t, jnp.asarray(B), max_iters, tolerance,
                record_history, inv_perm)
    mm = matmat if matmat is not None else _matmat(A, strategy)
    n, L = B.shape
    X = jnp.zeros_like(B)
    R = B
    P = B
    b_norms = jnp.sqrt(dot_multiple(B, B))
    b_norms = jnp.where(b_norms == 0.0, 1.0, b_norms)
    rs_old = dot_multiple(R, R)
    converged0 = jnp.zeros((L,), dtype=bool)
    hist0 = (
        jnp.full((max_iters,), jnp.nan, dtype=B.dtype)
        if record_history
        else jnp.zeros((0,), dtype=B.dtype)
    )

    def cond(state):
        i, X, R, P, rs_old, converged, hist = state
        return (i < max_iters) & ~jnp.all(converged)

    def body(state):
        i, X, R, P, rs_old, converged, hist = state
        AP = mm(P)
        pAp = dot_multiple(P, AP)
        # Converged lanes freeze: alpha = 0 (no_pretreatment.hpp:109-120).
        # pAp == 0 means P = 0 (A SPD), i.e. the lane already converged in
        # exact arithmetic — guard the division so such lanes freeze
        # instead of propagating NaN.
        alpha = jnp.where(converged | (pAp == 0), 0.0, rs_old / pAp)
        X = axpy_multiple(X, alpha, P)
        R = axpy_multiple(R, -alpha, AP)
        rs_new = dot_multiple(R, R)
        rel = jnp.sqrt(rs_new) / b_norms
        converged = converged | (rel < tolerance)
        if record_history:
            hist = hist.at[i].set(jnp.max(rel))
        beta = jnp.where(converged | (rs_old == 0), 0.0, rs_new / rs_old)
        P = update_p_multiple(R, beta, P)
        return (i + 1, X, R, P, rs_new, converged, hist)

    i, X, R, P, rs, converged, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, R, P, rs_old, converged0, hist0)
    )
    rel = jnp.sqrt(rs) / b_norms
    return CgResult(
        x=X if inv_perm is None else X[inv_perm],
        iterations=i,
        converged=converged,
        residual=rel,
        history=hist,
    )


def _cg_solve_multi_transposed(spmm_t, B, max_iters, tolerance,
                               record_history, inv_perm) -> CgResult:
    """Multi-RHS CG with the whole state in (L, n): rows on the
    contiguous axis, per-RHS alpha/beta/masks as (L, 1) broadcasts,
    SpMM via a transposed-layout callable (see _transposed_matmat_of)
    with no boundary transposes. Same recurrences and masking
    semantics as the generic path (no_pretreatment.hpp:35-197); only
    the fp reduction order of the dots differs (axis-1 sums)."""
    BT = B.T  # (L, n)
    L = BT.shape[0]
    X = jnp.zeros_like(BT)
    R = BT
    P = BT
    b_norms = jnp.sqrt(jnp.sum(BT * BT, axis=1))
    b_norms = jnp.where(b_norms == 0.0, 1.0, b_norms)
    rs_old = jnp.sum(R * R, axis=1)
    converged0 = jnp.zeros((L,), dtype=bool)
    hist0 = (
        jnp.full((max_iters,), jnp.nan, dtype=B.dtype)
        if record_history
        else jnp.zeros((0,), dtype=B.dtype)
    )

    def cond(state):
        i, X, R, P, rs_old, converged, hist = state
        return (i < max_iters) & ~jnp.all(converged)

    def body(state):
        i, X, R, P, rs_old, converged, hist = state
        AP = spmm_t(P).astype(B.dtype)
        pAp = jnp.sum(P * AP, axis=1)
        alpha = jnp.where(converged | (pAp == 0), 0.0, rs_old / pAp)
        X = X + alpha[:, None] * P
        R = R - alpha[:, None] * AP
        rs_new = jnp.sum(R * R, axis=1)
        rel = jnp.sqrt(rs_new) / b_norms
        converged = converged | (rel < tolerance)
        if record_history:
            hist = hist.at[i].set(jnp.max(rel))
        beta = jnp.where(converged | (rs_old == 0), 0.0,
                         rs_new / rs_old)
        P = R + beta[:, None] * P
        return (i + 1, X, R, P, rs_new, converged, hist)

    i, X, R, P, rs, converged, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, R, P, rs_old, converged0, hist0)
    )
    rel = jnp.sqrt(rs) / b_norms
    XO = X.T
    return CgResult(
        x=XO if inv_perm is None else XO[inv_perm],
        iterations=i,
        converged=converged,
        residual=rel,
        history=hist,
    )


# Jitted workers: the matrix plan and RHS are traced operands (every
# plan type is a registered pytree); loop bounds / tolerances /
# strategy strings are static. One cache entry per (plan structure,
# shapes, params) — repeated solves are a single device dispatch.
import functools as _functools


@_functools.partial(
    jax.jit, static_argnums=(2, 3, 4, 5)
)
def _cg_solve_jit(A, b, max_iters, tolerance, strategy, record_history):
    return _cg_solve_impl(A, b, max_iters, tolerance, strategy, None,
                          None, record_history)


@_functools.partial(
    jax.jit, static_argnums=(2, 3, 4, 5)
)
def _cg_solve_multi_jit(A, B, max_iters, tolerance, strategy,
                        record_history):
    return _cg_solve_multi_impl(A, B, max_iters, tolerance, strategy,
                                None, record_history)
