"""Matrix Market (.mtx) reader/writer.

Capability parity with the reference parser ``CooMatrix::InitMarket``
(``sparse_matrix.h:211-380``):

  * coordinate and array formats;
  * ``symmetric`` and ``skew-symmetric`` expansion (mirror entries added
    for off-diagonal nonzeros; skew flips the sign);
  * ``pattern`` files (no value field) take ``default_value``;
  * 1-based indices converted to 0-based;
  * malformed value fields fall back to ``default_value`` (the reference
    does the same when ``strtod`` fails).

Re-designed for speed: the hot path is ``numpy.fromstring``-style bulk
parsing rather than a per-line loop (the reference's strtol/strtod loop
is its file-I/O hot spot, ``SURVEY.md §3.1``). A native C++ parser hook
(:mod:`sparsela.utils.native`) is used when the shared library is built.
"""

from __future__ import annotations

import gzip
import io as _io
import os

import numpy as np

from sparsela.formats.coo import CooMatrix


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_market(
    path, default_value: float = 1.0, dtype=np.float64
) -> CooMatrix:
    """Parse a Matrix Market file into a CooMatrix."""
    try:
        from sparsela.utils import native

        if native.available() and not str(path).endswith(".gz"):
            return native.read_market(path, default_value, dtype)
    except ImportError:
        pass
    except IOError:
        # native parser rejected the file (e.g. entry count differs
        # from the declared nnz); re-diagnose through the Python path,
        # which raises a more specific error for genuinely bad files
        pass
    with _open(path) as f:
        return _read_market_stream(f, default_value, dtype)


def _read_market_stream(f, default_value, dtype) -> CooMatrix:
    header = f.readline()
    if not header.startswith("%%MatrixMarket"):
        raise ValueError(f"not a MatrixMarket file (banner: {header[:60]!r})")
    banner = header.lower()
    symmetric = "symmetric" in banner and "skew" not in banner
    skew = "skew" in banner
    hermitian = "hermitian" in banner
    array = "array" in banner
    pattern = "pattern" in banner
    complex_ = "complex" in banner

    # skip comments
    line = f.readline()
    while line.startswith("%"):
        line = f.readline()

    dims = line.split()
    if array:
        num_rows, num_cols = int(dims[0]), int(dims[1])
        data = np.loadtxt(f, dtype=np.float64, ndmin=1)
        if complex_:
            data = data.reshape(-1, 2)[:, 0]
        if symmetric or skew or hermitian:
            # array symmetric stores the lower triangle column-major
            rows_l, cols_l = [], []
            for c in range(num_cols):
                rr = np.arange(c, num_rows)
                rows_l.append(rr)
                cols_l.append(np.full(rr.size, c))
            rows = np.concatenate(rows_l)
            cols = np.concatenate(cols_l)
            vals = data.astype(dtype)
            off = rows != cols
            rows_f = np.concatenate([rows, cols[off]])
            cols_f = np.concatenate([cols, rows[off]])
            vals_f = np.concatenate(
                [vals, -vals[off] if skew else vals[off]]
            )
            return CooMatrix(
                num_rows, num_cols, rows_f.astype(np.int32),
                cols_f.astype(np.int32), vals_f,
            )
        # dense array, column-major (parity: sparse_matrix.h:311-318)
        n = num_rows * num_cols
        vals = data[:n].astype(dtype)
        idx = np.arange(n)
        cols = (idx // num_rows).astype(np.int32)
        rows = (idx - cols.astype(np.int64) * num_rows).astype(np.int32)
        return CooMatrix(num_rows, num_cols, rows, cols, vals)

    num_rows, num_cols = int(dims[0]), int(dims[1])
    nnz_declared = int(dims[2])

    body = f.read()
    # Fast path: bulk-parse every whitespace-separated token as float64
    # (indices are exact in f64 up to 2^53). The field count comes from
    # the FIRST data line, not from token-count divisibility — a
    # truncated parse whose count happens to divide nnz must not
    # silently build a wrong matrix. Any unparseable token or a field
    # mismatch falls back to the per-line loop.
    tokens = body.split()
    first_fields = 0
    for line in body.splitlines():
        stripped = line.split()
        if stripped:
            first_fields = len(stripped)
            break
    try:
        raw = np.asarray(tokens, dtype=np.float64)
    except ValueError:
        raw = None
    if (
        raw is not None
        and nnz_declared > 0
        and first_fields >= 2
        and raw.size == nnz_declared * first_fields
    ):
        fields = first_fields
    else:
        return _read_market_slow(
            body, num_rows, num_cols, nnz_declared,
            symmetric or hermitian, skew, pattern, default_value, dtype,
        )

    toks = raw.reshape(nnz_declared, fields)
    rows = toks[:, 0].astype(np.int64) - 1
    cols = toks[:, 1].astype(np.int64) - 1
    if fields >= 3 and not pattern:
        vals = toks[:, 2].astype(dtype)
    else:
        vals = np.full(nnz_declared, default_value, dtype=dtype)

    if symmetric or hermitian or skew:
        off = rows != cols
        rows_f = np.concatenate([rows, cols[off]])
        cols_f = np.concatenate([cols, rows[off]])
        vals_f = np.concatenate([vals, -vals[off] if skew else vals[off]])
    else:
        rows_f, cols_f, vals_f = rows, cols, vals

    idt = np.int32 if max(num_rows, num_cols) < 2**31 else np.int64
    return CooMatrix(
        num_rows, num_cols, rows_f.astype(idt), cols_f.astype(idt), vals_f
    )


def _read_market_slow(
    body, num_rows, num_cols, nnz_declared, symmetric, skew, pattern,
    default_value, dtype,
):
    rows, cols, vals = [], [], []
    n_primitive = 0
    for line in _io.StringIO(body):
        parts = line.split()
        if len(parts) < 2:
            continue
        r, c = int(parts[0]) - 1, int(parts[1]) - 1
        if len(parts) >= 3 and not pattern:
            try:
                v = float(parts[2])
            except ValueError:
                v = default_value
        else:
            v = default_value
        rows.append(r)
        cols.append(c)
        vals.append(v)
        n_primitive += 1
        if symmetric or skew:
            if r != c:
                rows.append(c)
                cols.append(r)
                vals.append(-v if skew else v)
    if n_primitive != nnz_declared:
        # reference parity: InitMarket errors when the body holds a
        # different entry count than the size line declares
        raise ValueError(
            f"matrix body holds {n_primitive} entries but the header "
            f"declares {nnz_declared}"
        )
    return CooMatrix(
        num_rows,
        num_cols,
        np.array(rows, dtype=np.int32),
        np.array(cols, dtype=np.int32),
        np.array(vals, dtype=dtype),
    )


def write_market(path, m, comment: str = "") -> None:
    """Write a CooMatrix / CsrMatrix to a MatrixMarket coordinate file.

    Entries are written in (row, col) order so a reload's COO->CSR
    conversion takes the sorted-identity fast path (one linear check
    instead of a multi-second sort at 10M+ nnz)."""
    coo = m.to_coo() if hasattr(m, "to_coo") else m
    coo = coo.sorted_by_row()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{coo.num_rows} {coo.num_cols} {coo.nnz}\n")
        for r, c, v in zip(coo.rows, coo.cols, coo.vals):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v)!r}\n")
