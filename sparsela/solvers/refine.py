"""Mixed-precision iterative refinement — fp64 solutions at fp32 speed.

The reference solves in fp64 end-to-end (``cpu_spmv.cpp:979-986``
default dtype; CG recurrences in ``work_2025/main/*``). fp64 runs
natively on every route here; classic iterative refinement (Wilkinson;
the same structure mixed-precision HPL-AI uses) reaches fp64 accuracy
while every inner iteration moves fp32 bytes:

    x = 0
    repeat:
        r = b - A x          in fp64
        d = CG_solve(A32, r) in fp32
        x = x + d            in fp64

Each refinement contracts the residual by roughly the fp32 solve's
relative accuracy (~1e-6), so ~2-4 refinements reach the 1e-12
BASELINE bar. Each refinement step (accurate residual + whole inner
solve + update) is one jitted dispatch.

Beyond-reference capability; the accuracy target is BASELINE.md's
"fp64 SpMV results within 1e-12 of the CPU reference".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from sparsela.ops.blas import dot_multiple, dot_single
from sparsela.ops.spmv import spmv, spmm
from sparsela.solvers.cg import (
    _cg_solve_impl,
    _cg_solve_multi_impl,
)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RefineResult:
    x: Any               # fp64 solution (n,) or (n, L)
    refinements: Any     # outer iterations executed
    inner_iterations: Any  # total fp32 CG iterations
    residual: Any        # final fp64 relative residual(s)

    def tree_flatten(self):
        return ((self.x, self.refinements, self.inner_iterations,
                 self.residual), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _refine_step(A32, A_acc, state, inner_max_iters, inner_tolerance,
                 strategy, multi):
    """One refinement: fp64 residual -> fp32 CG correction -> update."""
    x, b, total_inner = state
    r = b - (spmm(A_acc, x) if multi else spmv(A_acc, x))
    r = r.astype(jnp.float64)
    solve = _cg_solve_multi_impl if multi else _cg_solve_impl
    if multi:
        res = solve(A32, r.astype(jnp.float32), inner_max_iters,
                    inner_tolerance, strategy, None, False)
    else:
        res = solve(A32, r.astype(jnp.float32), inner_max_iters,
                    inner_tolerance, strategy, None, None, False)
    x = x + res.x.astype(jnp.float64)
    return (x, b, total_inner + res.iterations), r


def _solve_refined(A32, A_acc, b, multi, tolerance, inner_tolerance,
                   inner_max_iters, max_refinements, strategy):
    if not jax.config.jax_enable_x64:
        raise TypeError(
            "iterative refinement needs jax_enable_x64=True: the "
            "residual and solution updates are fp64 ops"
        )
    b = jnp.asarray(b, dtype=jnp.float64)
    bn = jnp.sqrt(
        dot_multiple(b, b) if multi else dot_single(b, b)
    )
    bn = jnp.where(bn == 0.0, 1.0, bn)
    x = jnp.zeros_like(b)
    state = (x, b, jnp.int32(0))
    rel = None
    refinements = 0
    # host loop: a handful of outer steps, each ONE jitted dispatch
    for k in range(max_refinements):
        state, r = _refine_step(
            A32, A_acc, state, int(inner_max_iters),
            float(inner_tolerance), strategy, multi
        )
        rn = jnp.sqrt(
            dot_multiple(r, r) if multi else dot_single(r, r)
        )
        rel = rn / bn
        refinements = k + 1
        if float(jnp.max(rel)) < tolerance and k > 0:
            break
    x, b, total_inner = state
    # final residual after the last correction
    r = b - (spmm(A_acc, x) if multi else spmv(A_acc, x))
    rn = jnp.sqrt(dot_multiple(r, r) if multi else dot_single(r, r))
    rel = rn / bn
    return RefineResult(
        x=x,
        refinements=refinements,
        inner_iterations=total_inner,
        residual=rel,
    )


def cg_solve_refined(A32, A_acc, b, tolerance: float = 1e-12,
                     inner_tolerance: float = 1e-7,
                     inner_max_iters: int = 10000,
                     max_refinements: int = 8,
                     strategy: str = "auto") -> RefineResult:
    """Single-RHS fp64 solve via fp32 CG + fp64 residual refinement.

    ``A32``: any fp32 plan; ``A_acc``: an fp64 plan for residuals
    (``plan_matrix(csr, dtype=np.float64)``)."""
    return _solve_refined(A32, A_acc, b, False, tolerance,
                          inner_tolerance, inner_max_iters,
                          max_refinements, strategy)


def cg_solve_multi_refined(A32, A_acc, B, tolerance: float = 1e-12,
                           inner_tolerance: float = 1e-7,
                           inner_max_iters: int = 10000,
                           max_refinements: int = 8,
                           strategy: str = "auto") -> RefineResult:
    """Blocked multi-RHS variant of :func:`cg_solve_refined`."""
    return _solve_refined(A32, A_acc, B, True, tolerance,
                          inner_tolerance, inner_max_iters,
                          max_refinements, strategy)


# ---------------------------------------------------------------------------
# bf16-plane refinement: f32 accuracy from a bf16-plane inner operator.
#
# The f64 refinement above trades fp64 residuals against an fp32 inner
# solve; this is the same shape one precision level down, aimed at the
# PLANE-STREAM-BOUND solve regime (variable-coefficient diagonal
# operators, io.generators.make_variable_stencil — the SuiteSparse
# FD/FEM reality, ref sparse_matrix.h:458-623): the inner CG runs on
# a plan whose value planes are stored bf16 (ops.spmv.plan_dia_bf16,
# ~half the dominant HBM term), the outer residual runs on the exact
# f32 plan, and each refinement contracts the error by roughly the
# bf16 OPERATOR's relative perturbation (~4e-3 * kappa), recovering
# the f32-CG solution quality. Unlike the f64 path, the whole
# refinement — outer while_loop of inner-CG while_loops — is ONE
# jitted dispatch.
# ---------------------------------------------------------------------------


def _refined_f32_impl(A16, A32, b, multi, tolerance, inner_tolerance,
                      inner_max_iters, max_refinements, strategy):
    dot = dot_multiple if multi else dot_single
    b = jnp.asarray(b, jnp.float32)
    bn = jnp.sqrt(dot(b, b))
    bn = jnp.where(bn == 0.0, 1.0, bn)
    mv32 = (lambda V: spmm(A32, V)) if multi else \
        (lambda v: spmv(A32, v))

    def inner(r):
        if multi:
            res = _cg_solve_multi_impl(
                A16, r, inner_max_iters, inner_tolerance, strategy,
                None, False)
        else:
            res = _cg_solve_impl(
                A16, r, inner_max_iters, inner_tolerance, strategy,
                None, None, False)
        return res.x, res.iterations

    x0 = jnp.zeros_like(b)
    state0 = (jnp.int32(0), x0, b, jnp.float32(1.0), jnp.int32(0))

    def cond(s):
        k, x, r, rel, ti = s
        return (k < max_refinements) & (rel >= tolerance)

    def body(s):
        k, x, r, rel, ti = s
        d, it = inner(r)
        x = x + d
        r = b - mv32(x)                      # EXACT f32 residual
        rel = jnp.max(jnp.sqrt(dot(r, r)) / bn).astype(jnp.float32)
        return (k + 1, x, r, rel, ti + it)

    k, x, r, rel, ti = jax.lax.while_loop(cond, body, state0)
    return RefineResult(
        x=x,
        refinements=k,
        inner_iterations=ti,
        residual=jnp.sqrt(dot(r, r)) / bn,
    )


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _refined_f32_jit(A16, A32, b, multi, tolerance, inner_tolerance,
                     inner_max_iters, max_refinements, strategy):
    return _refined_f32_impl(A16, A32, b, multi, tolerance,
                             inner_tolerance, inner_max_iters,
                             max_refinements, strategy)


def _solve_refined_f32(A16, A32, b, multi, tolerance, inner_tolerance,
                       inner_max_iters, max_refinements, strategy,
                       bake):
    from sparsela.solvers.cg import _baked_worker, _plan_bakeable

    b = jnp.asarray(b, jnp.float32)
    statics = (bool(multi), float(tolerance), float(inner_tolerance),
               int(inner_max_iters), int(max_refinements),
               str(strategy))
    if bake is None:
        bake = _plan_bakeable(A16) and _plan_bakeable(A32)
    if bake:
        # the executable closes over BOTH plans but the cache lives on
        # A16 — key A32's identity too, or a reused A16 would silently
        # serve a solve baked over a stale exact operator (round-5
        # review; the cached closure keeps A32 alive, so id() is
        # stable and unique for the entry's lifetime)
        key = ("refine_f32", id(A32), b.shape,
               str(b.dtype)) + statics
        fn = _baked_worker(A16, key, lambda: jax.jit(
            lambda b_: _refined_f32_impl(
                A16, A32, b_, *statics[:5], statics[5])))
        if fn is not None:
            return fn(b)
    return _refined_f32_jit(A16, A32, b, *statics[:5], statics[5])


def cg_solve_refined_f32(A16, A32, b, tolerance: float = 1e-5,
                         inner_tolerance: float = 1e-2,
                         inner_max_iters: int = 1000,
                         max_refinements: int = 12,
                         strategy: str = "auto",
                         bake: bool | None = None) -> RefineResult:
    """Single-RHS f32 solve at bf16-plane speed: inner CG on ``A16``
    (a ``plan_dia_bf16`` plan — bf16 value planes, ~half the HBM
    plane traffic), exact-f32 outer residuals on ``A32``. Reaches the
    same final relative residual as plain f32 CG on ``A32`` (the
    parity contract tests pin); the cost of the approximation is
    extra inner iterations, reported in ``inner_iterations``.

    ``inner_tolerance`` defaults to 1e-2: the bf16 operator's own
    accuracy floor is ~4e-3 relative, so tighter inner solves buy
    nothing per outer step (measured-A/B default).

    Whole solve = ONE jitted dispatch (outer ``lax.while_loop`` of
    inner-CG ``while_loop``s); plans bake as executable constants
    exactly like ``cg_solve`` (``bake=None`` auto)."""
    return _solve_refined_f32(A16, A32, b, False, tolerance,
                              inner_tolerance, inner_max_iters,
                              max_refinements, strategy, bake)


def cg_solve_multi_refined_f32(A16, A32, B, tolerance: float = 1e-5,
                               inner_tolerance: float = 1e-2,
                               inner_max_iters: int = 1000,
                               max_refinements: int = 12,
                               strategy: str = "auto",
                               bake: bool | None = None
                               ) -> RefineResult:
    """Blocked multi-RHS variant of :func:`cg_solve_refined_f32`
    (B is (n, L); the loop exit is the max lane residual)."""
    return _solve_refined_f32(A16, A32, B, True, tolerance,
                              inner_tolerance, inner_max_iters,
                              max_refinements, strategy, bake)


# ---------------------------------------------------------------------------
# Residual-replacement bf16 CG — the production bf16-plane solver.
#
# Restart-free alternative to the inner/outer refinement above. A numpy
# design study (iteration counts, host arithmetic) measured, at equal
# final f32 residual on variable-coefficient stencils:
#   * inner/outer refinement (cg_solve_refined_f32): 1.33-1.48x extra
#     iterations even well-conditioned — each inner CG restarts from
#     p = r and repays the Krylov transient, so the bf16 matvec's
#     traffic win is spent on restarts.
#   * residual replacement (van der Vorst/Sleijpen shape): run ONE
#     textbook CG whose matvec is the bf16-plane operator, and every
#     ``replace_every`` iterations recompute r = b - A32 x with the
#     exact f32 operator while KEEPING the search direction p — 1.06x
#     extra iterations at sigma=1/shift=1 (vs 1.48), because the
#     conjugacy history survives.
# Limits (measured, documented honest): at kappa*eps_bf16 >~ 0.1
# (e.g. near-singular shift=1e-2 operators) the recurrence drifts
# faster than replacement repairs it (1e37 blowup at
# replace_every=20) — the verified outer guard hard-restarts and
# reports; plain f32 CG is the right tool there.
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ReplCgResult:
    x: Any             # f32 solution
    iterations: Any    # total bf16-matvec CG iterations
    converged: Any     # VERIFIED against the exact f32 operator
    residual: Any      # exact f32 relative residual
    replacements: Any  # exact-residual replacements performed
    restarts: Any      # hard restarts after a failed verification

    def tree_flatten(self):
        return ((self.x, self.iterations, self.converged,
                 self.residual, self.replacements, self.restarts),
                None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _cg_bf16_impl(A16, A32, b, tolerance, max_iters, replace_every,
                  max_restarts, strategy):
    b = jnp.asarray(b, jnp.float32)
    bn = jnp.sqrt(dot_single(b, b))
    bn = jnp.where(bn == 0.0, 1.0, bn)
    thr = bn * tolerance

    def mv32(v):
        return spmv(A32, v, strategy=strategy)

    def mv16(v):
        return spmv(A16, v, strategy=strategy)

    def cg_steps(x, r, p, rs, it, budget):
        """Up to ``replace_every`` textbook CG steps on the bf16
        operator, with no conditional in the body: the replacement
        with its f32 matvec lives BETWEEN loop nests instead."""

        def cond(s):
            j, x, r, p, rs, it = s
            return ((j < replace_every) & (it < budget)
                    & (jnp.sqrt(rs) >= thr))

        def body(s):
            j, x, r, p, rs, it = s
            Ap = mv16(p)
            pAp = dot_single(p, Ap)
            alpha = jnp.where(pAp == 0, 0.0, rs / pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = dot_single(r, r)
            beta = jnp.where(rs == 0, 0.0, rs_new / rs)
            p = r + beta * p
            return (j + 1, x, r, p, rs_new, it + 1)

        _, x, r, p, rs, it = jax.lax.while_loop(
            cond, body, (jnp.int32(0), x, r, p, rs, it))
        return x, r, p, rs, it

    def sweep(x, p, it, nrep):
        """Replacement loop: exact f32 residual (KEEPING p), then a
        conditional-free block of ``replace_every`` bf16 CG steps;
        repeats until the recurrence converges or the budget ends."""

        def cond(s):
            x, p, rs, it, nrep = s
            return (it < max_iters) & (jnp.sqrt(rs) >= thr)

        def body(s):
            x, p, rs, it, nrep = s
            r = b - mv32(x)                  # EXACT f32 residual
            rs = dot_single(r, r)
            x, r, p, rs, it = cg_steps(x, r, p, rs, it, max_iters)
            return (x, p, rs, it, nrep + 1)

        # enter with rs = +inf: the first body always refreshes
        x, p, rs, it, nrep = jax.lax.while_loop(
            cond, body,
            (x, p, jnp.float32(np.inf), it, nrep))
        return x, it, nrep

    # outer guard: verify against the EXACT operator; hard-restart
    # (fresh p from the true residual) while unconverged and budgeted
    def outer_cond(s):
        x, p, rel, it, nrep, nres = s
        return ((rel >= tolerance) & (it < max_iters)
                & (nres <= max_restarts))

    def outer_body(s):
        x, p, rel, it, nrep, nres = s
        x, it, nrep = sweep(x, p, it, nrep)
        rt = b - mv32(x)
        rel = (jnp.sqrt(dot_single(rt, rt)) / bn).astype(jnp.float32)
        return (x, rt, rel, it, nrep, nres + 1)  # restart p = rt

    x0 = jnp.zeros_like(b)
    x, _, rel, it, nrep, nres = jax.lax.while_loop(
        outer_cond, outer_body,
        (x0, b, jnp.float32(1.0), jnp.int32(0), jnp.int32(0),
         jnp.int32(0)))
    return ReplCgResult(
        x=x, iterations=it, converged=rel < tolerance, residual=rel,
        replacements=nrep, restarts=nres - 1,
    )


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _cg_bf16_jit(A16, A32, b, tolerance, max_iters, replace_every,
                 max_restarts, strategy):
    return _cg_bf16_impl(A16, A32, b, tolerance, max_iters,
                         replace_every, max_restarts, strategy)


def cg_solve_bf16(A16, A32, b, tolerance: float = 1e-5,
                  max_iters: int = 10000, replace_every: int = 8,
                  max_restarts: int = 3, strategy: str = "auto",
                  bake: bool | None = None) -> ReplCgResult:
    """Single-RHS f32-accurate CG at bf16-plane matvec speed.

    Runs textbook CG with the bf16-plane operator ``A16``
    (``ops.spmv.plan_dia_bf16`` — ~half the plane traffic of the
    f32 plan on plane-stream-bound variable-coefficient stencils),
    replacing the recurrence residual with the EXACT f32 residual
    ``b - A32 x`` every ``replace_every`` iterations while keeping
    the search direction (restart-free — a numpy study of iteration
    counts chose this over inner/outer refinement).
    Convergence is VERIFIED against ``A32``; a failed verification
    hard-restarts (``max_restarts`` budget) and ``converged`` reports
    honestly. Whole solve = ONE jitted dispatch.

    Single-RHS by design: a multi-RHS DIA product reads each plane
    once per call regardless of L, so plane traffic — the term bf16
    halves — only dominates at L=1. Multi-RHS callers wanting bf16
    economics should use L=1 solves per RHS, or accept the refinement
    path (cg_solve_multi_refined_f32)."""
    from sparsela.solvers.cg import _baked_worker, _plan_bakeable

    b = jnp.asarray(b, jnp.float32)
    statics = (float(tolerance), int(max_iters), int(replace_every),
               int(max_restarts), str(strategy))
    if bake is None:
        bake = _plan_bakeable(A16) and _plan_bakeable(A32)
    if bake:
        # id(A32) in the key: see _solve_refined_f32 (stale-operator
        # hazard when one A16 is reused against a re-planned A32)
        key = ("cg_bf16", id(A32), b.shape, str(b.dtype)) + statics
        fn = _baked_worker(A16, key, lambda: jax.jit(
            lambda b_: _cg_bf16_impl(A16, A32, b_, *statics)))
        if fn is not None:
            return fn(b)
    return _cg_bf16_jit(A16, A32, b, *statics)
