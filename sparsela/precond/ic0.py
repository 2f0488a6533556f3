"""IC(0) incomplete Cholesky factorization.

Capability parity with ``IncompleteCholesky``
(``work_2025/cg/incomplete_cholesky_decomp.hpp:85-239``):

  * pattern = lower triangle of A (columns <= row), diagonal stored last
    within each row (CSR column-sorted order guarantees this);
  * up-looking factorization with sorted-merge partial dot products;
  * pivot breakdown (diagonal <= 0) retries up to 20 times, restoring
    the original values and adding a diagonal shift of 1e-3 growing
    10x per retry.

The factorization is inherently sequential and data-dependent, so it
runs on host (the reference's is sequential too); only the per-iteration
triangular solves need device speed (see trisolve.py). A C++ native
implementation is used when the shared library is built
(sparsela.utils.native); this numpy/Python version is the reference
implementation and fallback.
"""

from __future__ import annotations

import numpy as np

from sparsela.formats.csr import CsrMatrix


def _lower_triangle(csr: CsrMatrix) -> CsrMatrix:
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices)
    va = np.asarray(csr.values)
    rows = csr.row_ids()
    keep = ci <= rows
    counts = np.bincount(rows[keep], minlength=csr.num_rows)
    new_ro = np.zeros(csr.num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=new_ro[1:])
    return CsrMatrix(csr.num_rows, csr.num_cols, new_ro,
                     ci[keep].astype(np.int32), va[keep].copy())


def _try_factorize(ro, ci, vals) -> bool:
    """One up-looking IC(0) attempt, in place on ``vals``. Returns False
    on pivot breakdown (diag <= 0)."""
    n = ro.shape[0] - 1
    # per-row python dict would be slow; rely on sorted columns and
    # two-pointer merges exactly like the reference
    for i in range(n):
        for k_off in range(ro[i], ro[i + 1]):
            k = ci[k_off]
            s = 0.0
            jl = ro[i]
            jk = ro[k]
            end_k = ro[k + 1]
            while jl < k_off and jk < end_k:
                cl, ck = ci[jl], ci[jk]
                if cl == ck:
                    s += vals[jl] * vals[jk]
                    jl += 1
                    jk += 1
                elif cl < ck:
                    jl += 1
                else:
                    jk += 1
            vals[k_off] -= s
            if k == i:
                if vals[k_off] <= 0:
                    return False
                vals[k_off] = np.sqrt(vals[k_off])
            else:
                # diagonal of row k is its last entry (sorted columns)
                vals[k_off] /= vals[ro[k + 1] - 1]
    return True


def ic0_factorize(csr: CsrMatrix, max_attempts: int = 20,
                  initial_shift: float = 1e-3) -> CsrMatrix:
    """Factor A ~= L L^T on the lower-triangle pattern of A.

    Raises RuntimeError after ``max_attempts`` diagonal-shift retries
    (parity: incomplete_cholesky_decomp.hpp:159-236).
    """
    try:
        from sparsela.utils import native

        if native.available():
            return native.ic0_factorize(csr, max_attempts, initial_shift)
    except ImportError:
        pass
    L = _lower_triangle(csr.to_host())
    ro = np.asarray(L.row_offsets).astype(np.int64)
    ci = np.asarray(L.col_indices).astype(np.int64)
    backup = np.asarray(L.values, dtype=np.float64).copy()
    diag_mask = ci == L.row_ids()

    shift = 0.0
    for attempt in range(max_attempts):
        vals = backup.copy()
        if attempt > 0:
            vals[diag_mask] += shift
        if _try_factorize(ro, ci, vals):
            return CsrMatrix(L.num_rows, L.num_cols, L.row_offsets,
                             L.col_indices, vals)
        shift = initial_shift if shift == 0.0 else shift * 10.0
    raise RuntimeError(
        f"IC(0) failed after {max_attempts} diagonal-shift attempts"
    )
