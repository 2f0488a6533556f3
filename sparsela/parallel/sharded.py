"""Multi-chip sparse linear algebra via shard_map over a device Mesh.

The reference is single-node: its only "distribution" is OpenMP threads
+ NUMA placement (``sparse_matrix.h:691-697`` pins values and indices on
different sockets). The generalization here (SURVEY.md §2.4) is 1-D row
sharding over a ``jax.sharding.Mesh``:

  * matrix rows (and y) are sharded across devices on the ``rows`` axis,
  * x is replicated (each shard gathers arbitrary columns),
  * CG dot products are ``psum``-reduced partial dots,
  * everything else in the CG iteration is lane-local.

Each shard is itself a standard CSR slab, multiplied locally by the
plain gather + ``segment_sum`` of ``ops.reference``. Shards are padded
to equal nnz so shapes are uniform under ``shard_map`` (the load
imbalance a padded split causes is bounded when the row split is chosen
by nnz, which ``shard_csr`` does).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparsela.formats.csr import CsrMatrix


def make_mesh(n_devices: int | None = None, axis: str = "rows") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedCsr:
    """Row-sharded CSR: leading axis is the device shard.

    row_offsets: (D, rows_per_shard + 1) int32 — local offsets per shard.
    col_indices: (D, nnz_pad) int32 (padding: column 0).
    col_padded:  (D, nnz_pad) int32 — columns remapped into the padded
                 shard row layout (square matrices only): global column c
                 owned by shard s sits at s*rows_per_shard + c -
                 row_start[s]. Lets the CG step gather directly from an
                 all-gathered row-sharded vector.
    values:      (D, nnz_pad)        (padding: 0.0 — contributes nothing).
    row_start:   (D,) int32 — global row of each shard's first row.
    """

    num_rows: int
    num_cols: int
    rows_per_shard: int
    row_offsets: Any
    col_indices: Any
    col_padded: Any
    values: Any
    row_start: Any

    def tree_flatten(self):
        return (
            (self.row_offsets, self.col_indices, self.col_padded,
             self.values, self.row_start),
            (self.num_rows, self.num_cols, self.rows_per_shard),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def num_shards(self) -> int:
        return int(self.values.shape[0])


def shard_csr(csr: CsrMatrix, n_shards: int, by_nnz: bool = True,
              bounds=None) -> ShardedCsr:
    """Split a host CSR into ``n_shards`` row slabs.

    ``by_nnz=True`` picks the row split by balancing nonzeros (the
    merge-path equal-work idea applied at the shard level); rows per
    shard are then padded to the max so shapes are uniform.
    ``bounds`` overrides the row split (n_shards+1 boundaries) so
    several matrices — e.g. a system matrix and its preconditioner
    factors — can share ONE padded shard layout."""
    ro = np.asarray(csr.row_offsets).astype(np.int64)
    ci = np.asarray(csr.col_indices)
    va = np.asarray(csr.values)
    M = csr.num_rows
    if bounds is not None:
        bounds = np.asarray(bounds, dtype=np.int64)
        if bounds.shape[0] != n_shards + 1 or bounds[-1] != M:
            raise ValueError("bounds must be (n_shards+1,) ending at "
                             "num_rows")
    elif by_nnz and csr.nnz > 0:
        targets = (np.arange(1, n_shards) * csr.nnz) // n_shards
        cuts = np.searchsorted(ro, targets, side="left")
        bounds = np.concatenate([[0], cuts, [M]])
    else:
        bounds = np.linspace(0, M, n_shards + 1).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)

    rows_per_shard = int(np.max(np.diff(bounds))) if n_shards else 0
    rows_per_shard = max(rows_per_shard, 1)
    nnz_per = [int(ro[bounds[i + 1]] - ro[bounds[i]])
               for i in range(n_shards)]
    nnz_pad = max(max(nnz_per), 1)

    offs = np.zeros((n_shards, rows_per_shard + 1), dtype=np.int32)
    cols = np.zeros((n_shards, nnz_pad), dtype=np.int32)
    vals = np.zeros((n_shards, nnz_pad), dtype=va.dtype)
    row_start = np.zeros(n_shards, dtype=np.int32)
    for i in range(n_shards):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        s0, s1 = int(ro[r0]), int(ro[r1])
        local = (ro[r0:r1 + 1] - ro[r0]).astype(np.int32)
        offs[i, : r1 - r0 + 1] = local
        offs[i, r1 - r0 + 1 :] = local[-1]  # empty padded rows
        cols[i, : s1 - s0] = ci[s0:s1]
        vals[i, : s1 - s0] = va[s0:s1]
        row_start[i] = r0

    # Remap global columns into the padded shard row layout (square case):
    # shard owning row r, and r's position within the padded layout.
    col_pad = np.zeros_like(cols)
    if csr.num_cols == M:
        shard_of = np.searchsorted(bounds[1:], np.arange(M), side="right")
        pos = (
            shard_of.astype(np.int64) * rows_per_shard
            + np.arange(M)
            - bounds[shard_of]
        ).astype(np.int32)
        col_pad = pos[cols]
    return ShardedCsr(
        num_rows=M,
        num_cols=csr.num_cols,
        rows_per_shard=rows_per_shard,
        row_offsets=offs,
        col_indices=cols,
        col_padded=col_pad,
        values=vals,
        row_start=row_start,
    )


def device_put_sharded(sharded: ShardedCsr, mesh: Mesh, axis: str = "rows"
                       ) -> ShardedCsr:
    """Place each shard's slab on its device (row sharding — the
    answer to the reference's NUMA socket placement)."""
    spec = NamedSharding(mesh, P(axis))
    return ShardedCsr(
        sharded.num_rows,
        sharded.num_cols,
        sharded.rows_per_shard,
        jax.device_put(jnp.asarray(sharded.row_offsets), spec),
        jax.device_put(jnp.asarray(sharded.col_indices), spec),
        jax.device_put(jnp.asarray(sharded.col_padded), spec),
        jax.device_put(jnp.asarray(sharded.values), spec),
        jax.device_put(jnp.asarray(sharded.row_start), spec),
    )


def to_padded_layout(v: np.ndarray, A: ShardedCsr) -> np.ndarray:
    """Scatter a row-space array (num_rows, ...) into the padded shard
    layout (num_shards * rows_per_shard, ...), zero-filling pad rows."""
    v = np.asarray(v)
    D, rps = A.num_shards, A.rows_per_shard
    out = np.zeros((D * rps,) + v.shape[1:], dtype=v.dtype)
    rstart = np.asarray(A.row_start)
    bounds = np.concatenate([rstart, [A.num_rows]])
    for i in range(D):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        out[i * rps : i * rps + (r1 - r0)] = v[r0:r1]
    return out


def from_padded_layout(v, A: ShardedCsr) -> np.ndarray:
    """Inverse of :func:`to_padded_layout` (drops pad rows)."""
    v = np.asarray(v)
    D, rps = A.num_shards, A.rows_per_shard
    rstart = np.asarray(A.row_start)
    bounds = np.concatenate([rstart, [A.num_rows]])
    parts = [
        v[i * rps : i * rps + int(bounds[i + 1] - bounds[i])]
        for i in range(D)
    ]
    return np.concatenate(parts, axis=0)


def local_matvec(row_offsets, col_indices, values, x):
    """One shard's CSR product ``A_s @ x`` for x (n,) or (n, L): rows
    (rows_per_shard,) or (rows_per_shard, L). Padding entries sit past
    the last row offset, so their row id is out of range and the
    segment sum drops them."""
    from sparsela.ops.reference import expand_row_ids

    rows = expand_row_ids(row_offsets, col_indices.shape[0])
    g = jnp.take(x, col_indices, axis=0)
    prod = values * g if g.ndim == 1 else values[:, None] * g
    return jax.ops.segment_sum(prod, rows,
                               num_segments=row_offsets.shape[0] - 1,
                               indices_are_sorted=True)


def spmv_sharded(A: ShardedCsr, x, mesh: Mesh, axis: str = "rows"):
    """y = A @ x with rows sharded over the mesh; x replicated.

    Returns y sharded over rows, shape (D * rows_per_shard,) — padded
    rows at slab boundaries hold zeros and the caller slices them out
    with gather_rows()."""
    def shard_fn(ro, ci, va, x):
        return local_matvec(ro[0], ci[0], va[0], x)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )(A.row_offsets, A.col_indices, A.values, x)


def spmm_sharded(A: ShardedCsr, X, mesh: Mesh, axis: str = "rows"):
    """Y = A @ X, rows sharded, X (num_cols, L) replicated."""
    def shard_fn(ro, ci, va, X):
        return local_matvec(ro[0], ci[0], va[0], X)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )(A.row_offsets, A.col_indices, A.values, X)


def cg_step_sharded(A: ShardedCsr, state, mesh: Mesh, axis: str = "rows"):
    """One multi-RHS CG iteration with explicit collectives: the SpMM is
    row-local, dot products are psum-reduced partial dots — the
    collective re-expression of the reference's omp-reduction dots
    (``cg/utils_multiple.hpp:9-26``).

    ``state`` = (X, R, P_dir, rs_old) where the (D*rows_per_shard, L)
    arrays are row-sharded in the *padded* shard layout (the layout
    ``col_padded`` indexes into). Padded rows stay zero throughout.
    """
    def step(ro, cp, va, X, R, Pd, rs_old):
        # Matrix slabs arrive as (1, ...) per shard; row-space vectors
        # arrive as (rows_per_shard, L). All-gather the search direction,
        # then gather columns through the padded-layout index map
        # precomputed on host.
        Pd_full = jax.lax.all_gather(Pd, axis, axis=0, tiled=True)
        AP = local_matvec(ro[0], cp[0], va[0], Pd_full)
        pAp = jax.lax.psum(jnp.sum(Pd * AP, axis=0), axis)
        alpha = jnp.where(pAp == 0, 0.0, rs_old / pAp)
        Xn = X + alpha[None, :] * Pd
        Rn = R - alpha[None, :] * AP
        rs_new = jax.lax.psum(jnp.sum(Rn * Rn, axis=0), axis)
        beta = jnp.where(rs_old == 0, 0.0, rs_new / rs_old)
        Pn = Rn + beta[None, :] * Pd
        return Xn, Rn, Pn, rs_new

    X, R, Pd, rs_old = state
    Xn, Rn, Pn, rs = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(),
        ),
        out_specs=(P(axis), P(axis), P(axis), P()),
    )(A.row_offsets, A.col_padded, A.values, X, R, Pd, rs_old)
    return Xn, Rn, Pn, rs
