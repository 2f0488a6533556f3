"""CSR sparse matrix as a JAX pytree.

Capability parity with the reference's ``CsrMatrix``
(``sparse_matrix.h:636-985``): COO→CSR conversion via a
stable (row, col) sort, row-length statistics (``Stats``,
``sparse_matrix.h:797``) and the log-scale degree histogram
(``DisplayHistogram``, ``sparse_matrix.h:929``).

Re-design for JAX: a ``CsrMatrix`` is a pytree of arrays
(row_offsets, col_indices, values) with static (num_rows, num_cols) aux
data, so it can be passed through ``jax.jit`` / ``shard_map`` directly.
The reference's NUMA placement of values vs. indices
(``sparse_matrix.h:691-697``) maps to HBM device placement /
``NamedSharding`` handled in :mod:`sparsela.parallel`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CsrMatrix:
    """Compressed Sparse Row matrix.

    Attributes:
      num_rows / num_cols: static dimensions (pytree aux data).
      row_offsets: (num_rows + 1,) int32 — row i occupies
        [row_offsets[i], row_offsets[i+1]) of the nnz streams.
      col_indices: (nnz,) int32. INVARIANT: non-decreasing within each
        row (the (row, col)-sorted CSR stream every plan builder
        assumes; ``from_scipy``/``from_coo`` guarantee it — hand-built
        instances must too).
      values: (nnz,) float32/float64.

    Arrays may be numpy (host) or jax (device); ``to_device()`` /
    ``to_host()`` convert.
    """

    num_rows: int
    num_cols: int
    row_offsets: Any
    col_indices: Any
    values: Any

    # --- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (
            (self.row_offsets, self.col_indices, self.values),
            (self.num_rows, self.num_cols),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], *children)

    # --- basic properties ------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @property
    def dtype(self):
        return self.values.dtype

    # --- construction ----------------------------------------------------
    @classmethod
    def from_coo(cls, coo, sum_dups: bool = False) -> "CsrMatrix":
        """Build from a CooMatrix with a stable (row, col) sort.

        Mirrors the reference conversion (``sparse_matrix.h:668-704``):
        duplicates are *kept* by default (the reference keeps them too);
        pass ``sum_dups=True`` to coalesce.
        """
        if sum_dups:
            coo = coo.sum_duplicates()
        else:
            coo = coo.sorted_by_row()
        counts = np.bincount(coo.rows, minlength=coo.num_rows)
        row_offsets = np.zeros(coo.num_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=row_offsets[1:])
        return cls(
            coo.num_rows,
            coo.num_cols,
            row_offsets,
            np.ascontiguousarray(coo.cols, dtype=np.int32),
            np.ascontiguousarray(coo.vals),
        )

    @classmethod
    def from_scipy(cls, m) -> "CsrMatrix":
        m = m.tocsr()
        # Establish the package-wide invariant that column indices are
        # sorted within each row (scipy's tocsr() does not guarantee
        # it), so every route and planner sees one canonical order.
        if not m.has_sorted_indices:
            m = m.copy()
            m.sort_indices()
        return cls(
            m.shape[0],
            m.shape[1],
            m.indptr.astype(np.int32),
            m.indices.astype(np.int32),
            m.data,
        )

    @classmethod
    def from_dense(cls, d: np.ndarray) -> "CsrMatrix":
        d = np.asarray(d)
        rows, cols = np.nonzero(d)
        from sparsela.formats.coo import CooMatrix

        return cls.from_coo(
            CooMatrix(d.shape[0], d.shape[1], rows.astype(np.int32),
                      cols.astype(np.int32), d[rows, cols])
        )

    # --- conversion ------------------------------------------------------
    def to_coo(self):
        from sparsela.formats.coo import CooMatrix

        return CooMatrix(
            self.num_rows,
            self.num_cols,
            self.row_ids(),
            np.asarray(self.col_indices),
            np.asarray(self.values),
        )

    def row_ids(self) -> np.ndarray:
        """Expand row_offsets into a per-nonzero row-id array (nnz,)."""
        ro = np.asarray(self.row_offsets)
        lengths = np.diff(ro)
        return np.repeat(
            np.arange(self.num_rows, dtype=np.int32), lengths
        )

    def row_lengths(self) -> np.ndarray:
        return np.diff(np.asarray(self.row_offsets))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (
                np.asarray(self.values),
                np.asarray(self.col_indices),
                np.asarray(self.row_offsets),
            ),
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def to_device(self, dtype=None) -> "CsrMatrix":
        import jax.numpy as jnp

        vals = self.values if dtype is None else np.asarray(self.values).astype(dtype)
        return CsrMatrix(
            self.num_rows,
            self.num_cols,
            jnp.asarray(np.asarray(self.row_offsets), dtype=jnp.int32),
            jnp.asarray(np.asarray(self.col_indices), dtype=jnp.int32),
            jnp.asarray(vals),
        )

    def to_host(self) -> "CsrMatrix":
        return CsrMatrix(
            self.num_rows,
            self.num_cols,
            np.asarray(self.row_offsets),
            np.asarray(self.col_indices),
            np.asarray(self.values),
        )

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(
            self.num_rows, self.num_cols, self.row_offsets,
            self.col_indices, self.values.astype(dtype),
        )

    def transpose(self) -> "CsrMatrix":
        """Counting-sort CSR transpose (parity with ``TransposeCsr``,
        ``work_2025/cg/incomplete_cholesky_decomp.hpp:13-78``)."""
        cols = np.asarray(self.col_indices)
        vals = np.asarray(self.values)
        rows = self.row_ids()
        order = np.lexsort((rows, cols))  # sort by (col, row) — stable
        counts = np.bincount(cols, minlength=self.num_cols)
        new_offsets = np.zeros(self.num_cols + 1, dtype=np.int32)
        np.cumsum(counts, out=new_offsets[1:])
        return CsrMatrix(
            self.num_cols,
            self.num_rows,
            new_offsets,
            rows[order].astype(np.int32),
            vals[order],
        )

    # --- statistics (parity with Stats/DisplayHistogram) ------------------
    def stats(self) -> "CsrStats":
        lengths = self.row_lengths().astype(np.float64)
        n = max(self.num_rows, 1)
        mean = lengths.mean() if n else 0.0
        std = lengths.std() if n else 0.0
        cv = std / mean if mean > 0 else 0.0
        if std > 0:
            skew = float(np.mean(((lengths - mean) / std) ** 3))
        else:
            skew = 0.0
        return CsrStats(
            num_rows=self.num_rows,
            num_cols=self.num_cols,
            nnz=self.nnz,
            density=self.nnz / max(self.num_rows * self.num_cols, 1),
            row_length_mean=float(mean),
            row_length_std=float(std),
            row_length_cv=float(cv),
            row_length_skew=float(skew),
            row_length_max=int(lengths.max()) if lengths.size else 0,
            row_length_min=int(lengths.min()) if lengths.size else 0,
        )

    def graph_stats(self) -> dict:
        """Row/column-degree structure statistics (parity:
        ``CsrMatrix::GraphStats``, sparse_matrix.h:59-107: row-vs-col
        degree Pearson correlation; the reference fits a Deming
        regression, of which the Pearson r is the symmetric core)."""
        row_deg = self.row_lengths().astype(np.float64)
        col_deg = np.bincount(
            np.asarray(self.col_indices), minlength=self.num_cols
        ).astype(np.float64)
        n = min(self.num_rows, self.num_cols)
        r, c = row_deg[:n], col_deg[:n]
        denom = r.std() * c.std()
        pearson = float(((r - r.mean()) * (c - c.mean())).mean() / denom) \
            if denom > 0 else 0.0
        return {
            "row_degree_mean": float(row_deg.mean()) if row_deg.size else 0,
            "col_degree_mean": float(col_deg.mean()) if col_deg.size else 0,
            "row_col_pearson_r": pearson,
        }

    def degree_histogram(self) -> tuple[np.ndarray, np.ndarray]:
        """Log2-bucketed row-degree histogram (parity with
        ``DisplayHistogram``, ``sparse_matrix.h:929``). Returns
        (bucket_upper_bounds, counts); bucket 0 counts empty rows."""
        lengths = self.row_lengths()
        max_len = int(lengths.max()) if lengths.size else 0
        n_buckets = max_len.bit_length() + 1
        bounds = np.concatenate([[0], 2 ** np.arange(n_buckets)])
        counts = np.zeros(bounds.size, dtype=np.int64)
        counts[0] = int((lengths == 0).sum())
        nz = lengths[lengths > 0]
        if nz.size:
            bucket = np.floor(np.log2(nz)).astype(int) + 1
            np.add.at(counts, bucket, 1)
        return bounds, counts

    def is_symmetric(self, tol: float = 0.0) -> bool:
        s = self.to_scipy()
        d = abs(s - s.T)
        return d.nnz == 0 or d.max() <= tol


@dataclasses.dataclass
class CsrStats:
    """Row-length statistics (parity with ``CsrMatrix::Stats``,
    ``sparse_matrix.h:59-107,797``)."""

    num_rows: int
    num_cols: int
    nnz: int
    density: float
    row_length_mean: float
    row_length_std: float
    row_length_cv: float
    row_length_skew: float
    row_length_max: int
    row_length_min: int

    def display(self) -> str:
        return (
            f"{self.num_rows}x{self.num_cols}, {self.nnz} nnz "
            f"(density {self.density:.2e}), row len "
            f"mean {self.row_length_mean:.2f} std {self.row_length_std:.2f} "
            f"cv {self.row_length_cv:.2f} skew {self.row_length_skew:.2f} "
            f"min {self.row_length_min} max {self.row_length_max}"
        )
