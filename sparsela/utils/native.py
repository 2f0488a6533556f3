"""ctypes bindings for the native C++ runtime (libsparsela.so).

Native components (built via ``make -C native``):
  * ``mtx_read``      — OpenMP-chunked Matrix Market parser (the
    reference's data-loading path is C++ too, sparse_matrix.h:211-380).
  * ``coo_sort_order`` — stable (row, col) order for COO -> CSR.
  * ``ic0_factorize`` — sequential IC(0) with diagonal-shift retries.
  * ``tri_levels``    — dependency levels of a triangular factor.

Everything degrades gracefully: if the library is missing, callers use
the pure-Python implementations (market.py, precond/ic0.py).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "native",
        "libsparsela.so",
    )


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    # (re)build on use: a no-op when the .so is fresh, and keeps a
    # stale .so (missing newly added symbols) from breaking the
    # bindings below
    native_dir = os.path.dirname(path)
    if os.path.exists(os.path.join(native_dir, "Makefile")):
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", native_dir], check=False,
                capture_output=True, timeout=120,
            )
        except Exception:
            pass
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.mtx_read.restype = ctypes.c_int
        lib.mtx_read.argtypes = [
            ctypes.c_char_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mtx_free.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        lib.coo_sort_order.restype = None
        lib.coo_sort_order.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, i64p,
        ]
        lib.ic0_factorize.restype = ctypes.c_int
        lib.ic0_factorize.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int, ctypes.c_double,
        ]
        lib.tri_levels.restype = ctypes.c_int32
        lib.tri_levels.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
        ]
        _LIB = lib
    except (OSError, AttributeError):  # missing .so or stale symbols
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def read_market(path, default_value=1.0, dtype=np.float64):
    """Native .mtx parse -> CooMatrix. Raises on unsupported (array
    format) so the caller can fall back."""
    from sparsela.formats.coo import CooMatrix

    lib = _load()
    nr = ctypes.c_int64()
    nc = ctypes.c_int64()
    nnz = ctypes.c_int64()
    prow = ctypes.POINTER(ctypes.c_int32)()
    pcol = ctypes.POINTER(ctypes.c_int32)()
    pval = ctypes.POINTER(ctypes.c_double)()
    is_array = ctypes.c_int32()
    rc = lib.mtx_read(
        str(path).encode(), float(default_value),
        ctypes.byref(nr), ctypes.byref(nc), ctypes.byref(nnz),
        ctypes.byref(prow), ctypes.byref(pcol), ctypes.byref(pval),
        ctypes.byref(is_array),
    )
    if rc == 4:  # array format: python path handles it
        raise ImportError("array-format .mtx — python parser required")
    if rc != 0:
        raise IOError(f"native mtx_read failed with code {rc}: {path}")
    n = nnz.value
    rows = np.ctypeslib.as_array(prow, shape=(n,)).copy()
    cols = np.ctypeslib.as_array(pcol, shape=(n,)).copy()
    vals = np.ctypeslib.as_array(pval, shape=(n,)).copy()
    lib.mtx_free(prow, pcol, pval)
    return CooMatrix(int(nr.value), int(nc.value), rows, cols,
                     vals.astype(dtype))


def coo_sort_order(num_rows, rows, cols):
    """Stable (row, col) sort order for COO entries — counting sort by
    row + per-row stable column sort. Returns an int64 permutation, or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    # the native counting sort indexes start[rows[e] + 1] unchecked, so
    # out-of-range / non-int32 values would corrupt memory rather than
    # raise — validate here and let callers fall back to lexsort
    if rows.size:
        if int(rows.min()) < 0 or int(rows.max()) >= int(num_rows):
            return None
        if int(cols.min()) < 0 or int(cols.max()) > np.iinfo(np.int32).max:
            return None
    if int(num_rows) > np.iinfo(np.int32).max:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    order = np.empty(rows.size, dtype=np.int64)
    lib.coo_sort_order(int(num_rows), int(rows.size), rows, cols, order)
    return order


def tri_levels(row_offsets, col_indices, num_rows, lower=True):
    """Dependency levels of a triangular CSR (level-scheduled solve
    setup) in one native O(nnz) walk. Returns (level int64 array,
    nlevels) or (None, None) when the library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "tri_levels"):
        return None, None
    ro = np.ascontiguousarray(row_offsets, dtype=np.int64)
    ci = np.ascontiguousarray(col_indices, dtype=np.int32)
    out = np.zeros(max(int(num_rows), 1), dtype=np.int32)
    nlev = lib.tri_levels(int(num_rows), ro, ci,
                          1 if lower else 0, out)
    return out[:num_rows].astype(np.int64), int(nlev)


def ic0_factorize(csr, max_attempts=20, initial_shift=1e-3):
    """Native IC(0). ``csr`` is the full SPD matrix; lower-triangle
    extraction happens here (same as the Python path)."""
    from sparsela.formats.csr import CsrMatrix
    from sparsela.precond.ic0 import _lower_triangle

    lib = _load()
    L = _lower_triangle(csr.to_host())
    ro = np.ascontiguousarray(np.asarray(L.row_offsets), dtype=np.int64)
    ci = np.ascontiguousarray(np.asarray(L.col_indices), dtype=np.int64)
    vin = np.ascontiguousarray(np.asarray(L.values), dtype=np.float64)
    vout = np.empty_like(vin)
    attempts = lib.ic0_factorize(
        L.num_rows, ro, ci, vin, vout, int(max_attempts),
        float(initial_shift),
    )
    if attempts == 0:
        raise RuntimeError(
            f"IC(0) failed after {max_attempts} diagonal-shift attempts"
        )
    return CsrMatrix(L.num_rows, L.num_cols, L.row_offsets,
                     L.col_indices, vout)
