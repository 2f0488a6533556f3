"""Differentiable solves — implicit-function-theorem gradients.

Beyond-reference capability for embedding the solvers in jit/grad
programs (the reference is a standalone benchmark suite; a JAX
library should compose with JAX autodiff). For SPD ``A`` and
``x = A^{-1} b``, the vector-Jacobian product is

    d/db <x̄, x> = A^{-1} x̄          (A symmetric)

so the backward pass is ONE MORE CG solve with the same matrix plan —
no differentiation through the ``while_loop``, no storage of the
iteration trajectory (the classic adjoint/implicit treatment). The
sparse routes never need their own gradient rules: both passes call
them as black boxes.

Gradients flow through ``b`` only; the matrix is a constant of the
returned solver (gradients w.r.t. the nonzero values would need the
sparse outer product -A^{-1} x̄ ⊗ x restricted to the pattern — out of
scope until a consumer needs it).
"""

from __future__ import annotations

import jax

from sparsela.solvers.cg import cg_solve, cg_solve_multi


def make_cg_solver(A, max_iters: int = 10000, tolerance: float = 1e-8,
                   strategy: str = "auto"):
    """Return ``solve(b) -> x`` for SPD ``A``, differentiable w.r.t.
    ``b`` via the implicit adjoint (backward = one CG solve on the
    cotangent). Composes with jit/vmap/grad."""

    @jax.custom_vjp
    def solve(b):
        return cg_solve(A, b, max_iters=max_iters, tolerance=tolerance,
                        strategy=strategy).x

    def fwd(b):
        return solve(b), None

    def bwd(_res, xbar):
        return (cg_solve(A, xbar, max_iters=max_iters,
                         tolerance=tolerance, strategy=strategy).x,)

    solve.defvjp(fwd, bwd)
    return solve


def make_cg_solver_multi(A, max_iters: int = 10000,
                         tolerance: float = 1e-8,
                         strategy: str = "auto"):
    """Blocked multi-RHS variant: ``solve(B) -> X`` with the adjoint
    solve running all cotangent columns simultaneously."""

    @jax.custom_vjp
    def solve(B):
        return cg_solve_multi(A, B, max_iters=max_iters,
                              tolerance=tolerance,
                              strategy=strategy).x

    def fwd(B):
        return solve(B), None

    def bwd(_res, Xbar):
        return (cg_solve_multi(A, Xbar, max_iters=max_iters,
                               tolerance=tolerance,
                               strategy=strategy).x,)

    solve.defvjp(fwd, bwd)
    return solve
