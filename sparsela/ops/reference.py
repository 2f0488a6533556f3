"""Golden-model sparse ops in plain jnp — the correctness trust anchor.

These mirror the reference's sequential golden model ``SpmvGold``
(``work_2025/spmm/sample.hpp:14-34``): y = alpha*A@x + beta*y.
They are pure XLA (gather + segment_sum), differentiable, and run on any
backend — the oracle in tests and the explicit ``strategy='reference'``
route. ``to_cusparse`` / ``to_bcoo`` build the
``jax.experimental.sparse`` operands of the library routes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def expand_row_ids(row_offsets, nnz: int):
    """Per-nonzero row ids from CSR row offsets, shape (nnz,).

    XLA-friendly expansion: searchsorted over the offsets. Traceable
    (static nnz)."""
    # row_id[k] = (number of row starts <= k) - 1
    return (
        jnp.searchsorted(row_offsets, jnp.arange(nnz, dtype=row_offsets.dtype),
                         side="right") - 1
    ).astype(jnp.int32)


def spmv_reference(csr, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y (golden model, parity with SpmvGold)."""
    nnz = csr.col_indices.shape[0]
    rows = expand_row_ids(csr.row_offsets, nnz)
    gathered = jnp.take(x, csr.col_indices)
    y_new = jax.ops.segment_sum(
        csr.values * gathered, rows, num_segments=csr.num_rows,
        indices_are_sorted=True,
    )
    if beta == 0.0 or y is None:
        return alpha * y_new
    return alpha * y_new + beta * y


def spmm_reference(csr, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y with X (num_cols, L) — golden SpMM
    (parity with the multi-RHS drivers, cpu_spmm_v2.cpp)."""
    nnz = csr.col_indices.shape[0]
    rows = expand_row_ids(csr.row_offsets, nnz)
    gathered = jnp.take(X, csr.col_indices, axis=0)  # (nnz, L)
    Y_new = jax.ops.segment_sum(
        csr.values[:, None] * gathered, rows, num_segments=csr.num_rows,
        indices_are_sorted=True,
    )
    if beta == 0.0 or Y is None:
        return alpha * Y_new
    return alpha * Y_new + beta * Y


def to_cusparse(csr, dtype=None):
    """Convert to ``jax.experimental.sparse.CSR``, whose matvec and
    matmat lower to cuSPARSE on CUDA for f32/f64 (other dtypes fall back
    with a ``CuSparseEfficiencyWarning``) — the vendor baseline, as MKL
    is the reference's (cpu_spmv.cpp:631-664). Off CUDA the same
    primitives lower to XLA's generic gather/scatter."""
    import jax.experimental.sparse as jsparse

    vals = np.asarray(csr.values)
    if dtype is not None:
        vals = vals.astype(dtype)
    return jsparse.CSR(
        (jnp.asarray(vals),
         jnp.asarray(np.asarray(csr.col_indices), dtype=jnp.int32),
         jnp.asarray(np.asarray(csr.row_offsets), dtype=jnp.int32)),
        shape=(csr.num_rows, csr.num_cols),
    )


def to_bcoo(csr, dtype=None):
    """Convert to jax.experimental.sparse BCOO — the JAX ecosystem's
    built-in sparse type. Its products lower to XLA's generic
    gather/scatter here (``jax_bcoo_cusparse_lowering`` stays off)."""
    import jax.experimental.sparse as jsparse

    rows = jnp.asarray(
        np.repeat(
            np.arange(csr.num_rows, dtype=np.int32),
            np.diff(np.asarray(csr.row_offsets)),
        )
    )
    idx = jnp.stack(
        [rows, jnp.asarray(np.asarray(csr.col_indices), dtype=jnp.int32)],
        axis=1,
    )
    vals = np.asarray(csr.values)
    if dtype is not None:
        vals = vals.astype(dtype)
    return jsparse.BCOO(
        (jnp.asarray(vals), idx),
        shape=(csr.num_rows, csr.num_cols),
    )


def spmv_numpy(csr, x, alpha=1.0, beta=0.0, y=None):
    """Pure-numpy golden model (host oracle, independent of XLA)."""
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices)
    va = np.asarray(csr.values)
    x = np.asarray(x)
    lengths = np.diff(ro)
    rows = np.repeat(np.arange(csr.num_rows), lengths)
    y_new = np.zeros(csr.num_rows, dtype=np.result_type(va, x))
    np.add.at(y_new, rows, va * x[ci])
    if beta == 0.0 or y is None:
        return alpha * y_new
    return alpha * y_new + beta * np.asarray(y)
