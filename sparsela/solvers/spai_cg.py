"""SPAI-CG — CG preconditioned by a sparse approximate inverse.

Capability parity with ``SPAISolveMultiple``
(``work_2025/main/sparse_approximate_inverse.hpp:31-230``):
identical to PCG except the preconditioner application z = M r is an
explicit SpMM with the SPAI matrix (no triangular solves) — one more
sparse product per iteration, on whatever route the plan of M takes.
"""

from __future__ import annotations

from sparsela.ops.spmv import spmm
from sparsela.solvers.cg import CgResult
from sparsela.solvers.pcg import pcg_solve_multi


def spai_cg_solve_multi(
    A,
    M,
    B,
    max_iters: int = 10000,
    tolerance: float = 1e-5,
    strategy: str = "auto",
    record_history: bool = True,
) -> CgResult:
    """Blocked multi-RHS CG with z = M r (M = SPAI approximate inverse,
    see sparsela.precond.spai). ``A`` and ``M`` are any matrix objects
    accepted by ops.spmm (any ``plan_matrix`` plan)."""
    return pcg_solve_multi(
        A,
        B,
        apply_precond=lambda R: spmm(M, R, strategy=strategy),
        max_iters=max_iters,
        tolerance=tolerance,
        strategy=strategy,
        record_history=record_history,
    )
