"""Symmetric relabeling + bandwidth-reducing (RCM) reordering.

Reference capability: ``CooMatrix::InitCsrRelabel``
(``sparse_matrix.h:184-207``) — rebuild a matrix under
a vertex relabeling ``A_new[relabel[i], relabel[j]] = A[i, j]``. The
reference ships the mechanism only (no caller computes an ordering);
here a reverse-Cuthill-McKee pre-order collapses a scrambled-banded
matrix back to a low-bandwidth form, so a row's gathers of x touch
nearby cache lines, and a matrix with diagonal structure can reach the
DIA path again. Solvers are unaffected numerically:
``P A P^T`` is similar to ``A``, so CG trajectories (and iteration
counts) match up to rounding.

``ReorderedPlan`` wraps any inner device plan built on the permuted
matrix; ``ops.spmv.spmv``/``spmm`` dispatch on it and apply the
permutation as two device gathers per call (O(n) — negligible next to
any sparse kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from sparsela.formats.csr import CsrMatrix

# reorder='auto' gate: apply RCM only when it recovers substantial
# locality — the RCM bandwidth must undercut a quarter of the original
# (plus a 128-column dead band below which the layout barely changes
# which cache lines a row's gathers touch). Already-banded inputs keep
# their native order.
RCM_GAIN = 0.25
RCM_SLACK = 128


def bandwidth(csr: CsrMatrix) -> int:
    """max |i - j| over the stored entries (0 for empty matrices)."""
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    if ci.size == 0:
        return 0
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64),
                     np.diff(ro))
    return int(np.abs(rows - ci).max())


def permute_symmetric(csr: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """``A_p[i, j] = A[perm[i], perm[j]]`` for a permutation array
    ``perm`` (row i of the result is row perm[i] of the input).

    Equivalent to the reference's ``InitCsrRelabel``
    (``sparse_matrix.h:184-207``) with ``relabel = argsort(perm)``:
    the reference names the OLD->NEW map, this names NEW->OLD (the
    gather convention, which is what device-side vector permutation
    wants). Square matrices only.
    """
    if csr.num_rows != csr.num_cols:
        raise ValueError("symmetric permutation needs a square matrix")
    n = csr.num_rows
    perm = np.asarray(perm, dtype=np.int64)
    if perm.shape != (n,):
        raise ValueError(f"perm must have shape ({n},)")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)

    ro = np.asarray(csr.row_offsets).astype(np.int64)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    va = np.asarray(csr.values)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    new_rows = inv[rows]
    new_cols = inv[ci]
    # CSR invariant: entries sorted by (row, col) — native counting
    # sort when available (the lexsort costs seconds at 10M nnz)
    o = None
    try:
        from sparsela.utils import native

        o = native.coo_sort_order(n, new_rows, new_cols)
    except ImportError:
        o = None
    if o is None:
        o = np.lexsort((new_cols, new_rows))
    new_rows, new_cols, va2 = new_rows[o], new_cols[o], va[o]
    ro2 = np.zeros(n + 1, dtype=ro.dtype)
    np.cumsum(np.bincount(new_rows, minlength=n), out=ro2[1:])
    return CsrMatrix(
        num_rows=n, num_cols=n,
        row_offsets=ro2.astype(np.asarray(csr.row_offsets).dtype),
        col_indices=new_cols.astype(np.asarray(csr.col_indices).dtype),
        values=va2,
    )


def degree_order(csr: CsrMatrix) -> np.ndarray:
    """Column-degree-descending ordering (hub columns first), gather
    convention (``permute_symmetric(csr, perm)`` has the hot columns
    packed into the leading 128-column blocks). Stable, so ties keep
    their native relative order — uniform-degree matrices come back
    unchanged."""
    ci = np.asarray(csr.col_indices).astype(np.int64)
    deg = np.bincount(ci, minlength=csr.num_cols)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def rcm_order(csr: CsrMatrix) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of the symmetrized pattern:
    ``perm`` in the gather convention (``permute_symmetric(csr, perm)``
    has the reduced bandwidth)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    sp = csr.to_scipy().tocsr()
    return np.asarray(
        reverse_cuthill_mckee(sp, symmetric_mode=False), dtype=np.int64
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ReorderedPlan:
    """Any device plan built on ``P A P^T``, plus the permutation as
    device gather indices. ``spmv``/``spmm`` dispatch:
    ``y = (alpha * A_p @ x[perm])[inv_perm] + beta * y``."""

    num_rows: int
    num_cols: int
    nnz: int
    inner: Any
    perm: Any        # (n,) int32 device — new -> old
    inv_perm: Any    # (n,) int32 device — old -> new
    order: str = "rcm"   # which ordering built the permutation
                         # ('rcm' | 'degree') — the plan_kind prefix

    def tree_flatten(self):
        return ((self.inner, self.perm, self.inv_perm),
                (self.num_rows, self.num_cols, self.nnz, self.order))

    @classmethod
    def tree_unflatten(cls, aux, children):
        inner, perm, inv = children
        nr, nc, nnz, order = aux
        return cls(nr, nc, nnz, inner, perm, inv, order)

    def apply_perm(self, x):
        """``x[perm]`` (original -> permuted space), rows of 1-D or 2-D."""
        return jnp.asarray(x)[self.perm]

    def apply_inv(self, y):
        """``y[inv_perm]`` (permuted -> original space)."""
        return jnp.asarray(y)[self.inv_perm]

    @property
    def dtype(self):
        return self.inner.dtype


def _wrap_reordered(csr, perm, inv, strategy, dtype, L, order_name):
    from sparsela.ops.spmv import plan_matrix

    inner = plan_matrix(permute_symmetric(csr, perm), strategy=strategy,
                        dtype=dtype, L=L)
    return ReorderedPlan(
        num_rows=csr.num_rows, num_cols=csr.num_cols, nnz=csr.nnz,
        inner=inner,
        perm=jnp.asarray(perm.astype(np.int32)),
        inv_perm=jnp.asarray(inv.astype(np.int32)),
        order=order_name,
    )


def plan_reorder(csr: CsrMatrix, strategy="auto", dtype=None,
                 L: int = 1, order: str = "rcm"):
    """Build a plan on a symmetrically permuted matrix, wrapped so
    callers use it exactly like any other plan.

    ``order='rcm'`` / ``order='degree'`` always permute (bandwidth
    recovery / hot-column clustering); ``order='auto'`` applies RCM
    only when it cuts the bandwidth below :data:`RCM_GAIN` of the
    original, and otherwise returns a plain un-permuted plan.
    """
    from sparsela.ops.spmv import plan_matrix

    if order not in ("rcm", "degree", "auto"):
        raise ValueError(f"unknown order {order!r}")
    if csr.num_rows != csr.num_cols or csr.nnz == 0:
        return plan_matrix(csr, strategy=strategy, dtype=dtype, L=L)
    if order == "degree":
        perm = degree_order(csr)
        return _wrap_reordered(csr, perm, np.argsort(perm), strategy,
                               dtype, L, "degree")
    perm = rcm_order(csr)
    inv = np.argsort(perm)
    if order == "rcm":
        return _wrap_reordered(csr, perm, inv, strategy, dtype, L,
                               "rcm")
    # order == 'auto': permuted bandwidth straight from the relabeling
    # — O(nnz), no need to build the permuted matrix to reject the gate
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64),
                     np.diff(ro))
    d_orig = int(np.abs(rows - ci).max())
    d_perm = int(np.abs(inv[rows] - inv[ci]).max())
    if d_perm + RCM_SLACK <= RCM_GAIN * d_orig:
        return _wrap_reordered(csr, perm, inv, strategy, dtype, L, "rcm")
    return plan_matrix(csr, strategy=strategy, dtype=dtype, L=L)
