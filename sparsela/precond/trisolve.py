"""Triangular solves for the IC(0) preconditioner.

The reference applies z = (L L^T)^{-1} r with two *sequential-over-rows*
substitutions per CG iteration (``ForwardSolveMultiple`` /
``BackwardSolveMultiple``,
``work_2025/cg/incomplete_cholesky_decomp.hpp:246-345``),
SIMD only over the RHS lanes. A row-sequential loop is the one shape an
accelerator cannot run fast, so this module provides two re-designs
plus the host oracle:

  * ``forward_solve_host`` / ``backward_solve_host`` — exact numpy
    substitutions (the oracle, and the parity path for iteration-count
    validation against the reference).
  * ``jacobi_trisolve_lower/upper`` — fixed-iteration Jacobi relaxation
    of the triangular system: z_{k+1} = D^{-1} (b - (T - D) z_k).
    Every step is an SpMV/SpMM on the strictly-triangular part, and
    for a triangular system
    the iteration is *exactly* convergent in nilpotency-index steps
    (T - D strictly triangular => nilpotent), so with enough sweeps it
    reproduces the exact solve; with few sweeps it is an approximate
    preconditioner application (convergence validated in tests).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from sparsela.ops.spmv import spmv, spmm


def forward_solve_host(L, b):
    """Solve L x = b, L lower-triangular CSR with sorted columns
    (diagonal last per row). b: (n,) or (n, L_rhs)."""
    ro = np.asarray(L.row_offsets)
    ci = np.asarray(L.col_indices)
    va = np.asarray(L.values)
    b = np.asarray(b)
    x = np.zeros_like(b, dtype=np.float64)
    n = L.num_rows
    for i in range(n):
        s0, s1 = ro[i], ro[i + 1]
        cols = ci[s0 : s1 - 1]
        x[i] = (b[i] - va[s0 : s1 - 1] @ x[cols]) / va[s1 - 1]
    return x


def backward_solve_host(L, b):
    """Solve L^T x = b given lower-triangular L (via its transpose,
    an upper-triangular CSR with the diagonal first per row)."""
    U = L.transpose()
    ro = np.asarray(U.row_offsets)
    ci = np.asarray(U.col_indices)
    va = np.asarray(U.values)
    b = np.asarray(b)
    x = np.zeros_like(b, dtype=np.float64)
    n = U.num_rows
    for i in range(n - 1, -1, -1):
        s0, s1 = ro[i], ro[i + 1]
        # diagonal is the first entry of row i in U = L^T
        cols = ci[s0 + 1 : s1]
        x[i] = (b[i] - va[s0 + 1 : s1] @ x[cols]) / va[s0]
    return x


def split_diag(T):
    """Host helper: split a triangular CSR into (strict part, diag)."""
    from sparsela.formats.csr import CsrMatrix

    ro = np.asarray(T.row_offsets)
    ci = np.asarray(T.col_indices)
    va = np.asarray(T.values)
    rows = T.row_ids()
    is_diag = ci == rows
    diag = np.zeros(T.num_rows, dtype=va.dtype)
    diag[rows[is_diag]] = va[is_diag]
    keep = ~is_diag
    counts = np.bincount(rows[keep], minlength=T.num_rows)
    new_ro = np.zeros(T.num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=new_ro[1:])
    strict = CsrMatrix(T.num_rows, T.num_cols, new_ro,
                       ci[keep].astype(np.int32), va[keep].copy())
    return strict, diag


class JacobiTriSolver:
    """Device-side fixed-sweep Jacobi solver for T x = b (T triangular).

    ``strict`` may be any matrix object accepted by ops.spmv (device
    CsrMatrix or merge-tile plan) holding T - diag(T); ``inv_diag`` is
    the reciprocal diagonal. ``sweeps`` bounds the nilpotent recursion:
    sweeps >= longest dependency chain gives the exact solve.
    """

    def __init__(self, strict, inv_diag, sweeps: int = 12,
                 strategy: str = "auto"):
        self.strict = strict
        self.inv_diag = inv_diag
        self.sweeps = sweeps
        self.strategy = strategy

    def solve(self, b):
        d = self.inv_diag
        if b.ndim == 1:
            x = b * d
            for _ in range(self.sweeps):
                x = (b - spmv(self.strict, x, strategy=self.strategy)) * d
            return x
        x = b * d[:, None]
        for _ in range(self.sweeps):
            x = (b - spmm(self.strict, x, strategy=self.strategy)) * d[:, None]
        return x


def _default_plan(strict, num_rhs):
    """Route the strict triangular part through the AUTO planner, so
    every Jacobi sweep runs on the general CSR route."""
    from sparsela.ops.spmv import plan_matrix

    return plan_matrix(strict, strategy="auto", L=num_rhs)


def jacobi_trisolve_lower(L_host, sweeps: int = 12, to_plan=None,
                          num_rhs: int = 16, dtype=None):
    """Build a JacobiTriSolver for L x = b from a host lower CSR.
    ``to_plan`` overrides the device plan builder (default: the AUTO
    kernel planner, sized for ``num_rhs`` right-hand sides).

    ``dtype`` casts the factor BEFORE planning: ic0_factorize returns
    an fp64 factor regardless of the system dtype (the host
    factorization runs in f64 for pivot robustness), and without the
    cast an fp32 solve would silently plan fp64 sweep SpMMs — every
    PCG iteration runs 2*sweeps of them."""
    strict, diag = split_diag(L_host)
    if dtype is not None:
        strict = strict.astype(dtype)
        diag = diag.astype(dtype)
    dev = (to_plan(strict) if to_plan
           else _default_plan(strict, num_rhs))
    return JacobiTriSolver(dev, jnp.asarray(1.0 / diag), sweeps)


def jacobi_trisolve_upper(L_host, sweeps: int = 12, to_plan=None,
                          num_rhs: int = 16, dtype=None):
    """Build a JacobiTriSolver for L^T x = b (see
    jacobi_trisolve_lower for ``dtype`` semantics)."""
    strict, diag = split_diag(L_host.transpose())
    if dtype is not None:
        strict = strict.astype(dtype)
        diag = diag.astype(dtype)
    dev = (to_plan(strict) if to_plan
           else _default_plan(strict, num_rhs))
    return JacobiTriSolver(dev, jnp.asarray(1.0 / diag), sweeps)


# ---------------------------------------------------------------------------
# Level-scheduled exact triangular solve
# ---------------------------------------------------------------------------


def _dependency_levels(ro, ci, n, lower):
    """Topological levels of a triangular CSR: level[i] = 1 + max level
    of row i's strict dependencies. Native O(nnz) walk when the C++
    library is available (utils/native.tri_levels); numpy frontier
    propagation otherwise (O(nlev) vectorized passes — the fallback,
    not the fast path)."""
    from sparsela.utils import native

    lev, _ = native.tri_levels(ro, ci, n, lower=lower)
    if lev is not None:
        return lev

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    strict = ci != rows
    srow, scol = rows[strict], ci[strict]
    level = np.full(n, -1, dtype=np.int64)
    # roots: rows with no strict dependencies
    ndeps = np.bincount(srow, minlength=n)
    level[ndeps == 0] = 0
    while True:
        dep_lev = level[scol]
        pending = level[srow] < 0
        if not pending.any():
            break
        # a pending row becomes ready when ALL its deps are assigned
        ready_min = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(ready_min, srow[pending], dep_lev[pending])
        ready_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(ready_max, srow[pending], dep_lev[pending])
        ready = (level < 0) & (ready_min >= 0) & (
            ready_min < np.iinfo(np.int64).max
        )
        if not ready.any():
            raise ValueError("cycle in triangular structure")
        level[ready] = ready_max[ready] + 1
    return level

class LevelScheduledSolver:
    """Exact triangular solve via dependency levels — the classic
    parallel re-expression of the reference's row-sequential
    substitution (incomplete_cholesky_decomp.hpp:246-345): rows within
    a level have no mutual dependencies and solve simultaneously;
    levels run as a sequential `lax.fori_loop`. Host precomputes the
    level schedule and pads it to static shapes (rows per level x
    slots per row), so the solve jits.

    Exact in exactly `nlevels` steps (vs the Jacobi solver's
    nilpotency-bound sweeps); best when the factor's dependency depth
    is small."""

    def __init__(self, T, lower: bool = True):
        import jax.numpy as jnp

        ro = np.asarray(T.row_offsets).astype(np.int64)
        ci = np.asarray(T.col_indices).astype(np.int64)
        va = np.asarray(T.values)
        n = T.num_rows
        rows = T.row_ids().astype(np.int64)
        is_diag = ci == rows
        diag = np.zeros(n, dtype=np.float64)
        diag[rows[is_diag]] = va[is_diag]

        level = _dependency_levels(ro, ci, n, lower)
        nlev = int(level.max()) + 1 if n else 1

        # pad levels to (nlev, R) rows and (K,) strict slots per row —
        # all scatter passes, no per-row/per-nnz Python loops (round-2
        # weak #4: millions of interpreted iterations on big factors)
        strict_counts = np.bincount(rows[~is_diag], minlength=n)
        R = max(int(np.bincount(level, minlength=nlev).max()), 1)
        K = max(int(strict_counts.max()) if n else 0, 1)

        order = np.argsort(level, kind="stable")
        lvl_sorted = level[order]
        starts = np.searchsorted(lvl_sorted, np.arange(nlev))
        rank = np.arange(n, dtype=np.int64) - starts[lvl_sorted]
        rows_of_level = np.full((nlev, R), n, dtype=np.int32)  # pad -> n
        rows_of_level[lvl_sorted, rank] = order.astype(np.int32)

        # strict slot index within the row: position in the CSR stream
        # minus one if the row's diagonal entry precedes it
        within = np.arange(ci.size, dtype=np.int64) - ro[rows]
        diag_within = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        diag_within[rows[is_diag]] = within[is_diag]
        k_slot = within - (diag_within[rows] < within)
        cols_pad = np.full((n + 1, K), n, dtype=np.int32)
        vals_pad = np.zeros((n + 1, K), dtype=va.dtype)
        strict = ~is_diag
        cols_pad[rows[strict], k_slot[strict]] = ci[strict].astype(
            np.int32
        )
        vals_pad[rows[strict], k_slot[strict]] = va[strict]

        self.n = n
        self.nlev = nlev
        self.rows_of_level = jnp.asarray(rows_of_level)
        self.cols_pad = jnp.asarray(cols_pad)
        self.vals_pad = jnp.asarray(vals_pad)
        self.inv_diag = jnp.asarray(
            np.concatenate([1.0 / diag, [0.0]]).astype(va.dtype)
        )

    def solve(self, b):
        import jax
        import jax.numpy as jnp

        n = self.n
        single = b.ndim == 1
        B = b[:, None] if single else b
        L = B.shape[1]
        # x padded with a zero sentinel row n
        x0 = jnp.zeros((n + 1, L), dtype=B.dtype)
        Bp = jnp.concatenate(
            [B, jnp.zeros((1, L), dtype=B.dtype)], axis=0
        )

        def body(lv, x):
            r = self.rows_of_level[lv]                 # (R,) row ids
            cols = jnp.take(self.cols_pad, r, axis=0)  # (R, K)
            vals = jnp.take(self.vals_pad, r, axis=0)
            gathered = jnp.take(x, cols.reshape(-1), axis=0).reshape(
                cols.shape + (L,)
            )
            s = jnp.einsum("rk,rkl->rl", vals, gathered,
                           precision=jax.lax.Precision.HIGHEST)
            xr = (jnp.take(Bp, r, axis=0) - s) * jnp.take(
                self.inv_diag, r
            )[:, None]
            return x.at[r].set(xr)

        x = jax.lax.fori_loop(0, self.nlev, body, x0)
        x = x[:n]
        return x[:, 0] if single else x


def level_trisolve_lower(L_host):
    """Exact lower solve L x = b with level scheduling."""
    return LevelScheduledSolver(L_host, lower=True)


def level_trisolve_upper(L_host):
    """Exact upper solve L^T x = b with level scheduling."""
    return LevelScheduledSolver(L_host.transpose(), lower=False)
