"""Synthetic matrix generators — built-in benchmark fixtures.

Capability parity with the reference generators
(``sparse_matrix.h``):

  * ``make_dense``   — InitDense   (:385): all-ones dense matrix in COO.
  * ``make_wheel``   — InitWheel   (:417): hub-and-rim wheel graph; the
    hub row has ``spokes`` nonzeros — the pathological row-length-skew
    stress test for load-balanced SpMV.
  * ``make_grid2d``  — InitGrid2d  (:458): 2-D 4/5-point stencil.
  * ``make_grid3d``  — InitGrid3d  (:533): 3-D 6/7-point stencil.

Plus ``make_random_spd`` / ``make_laplacian_*`` for the CG solver tests
(the reference relies on downloaded SPD SuiteSparse matrices; a built-in
SPD source makes the test pyramid hermetic).
"""

from __future__ import annotations

import numpy as np

from sparsela.formats.coo import CooMatrix


def make_dense(num_rows: int, num_cols: int, default_value: float = 1.0,
               dtype=np.float64) -> CooMatrix:
    """Dense matrix in COO form (parity: InitDense, sparse_matrix.h:385)."""
    rows = np.repeat(np.arange(num_rows, dtype=np.int32), num_cols)
    cols = np.tile(np.arange(num_cols, dtype=np.int32), num_rows)
    vals = np.full(num_rows * num_cols, default_value, dtype=dtype)
    return CooMatrix(num_rows, num_cols, rows, cols, vals)


def make_wheel(spokes: int, default_value: float = 1.0,
               dtype=np.float64) -> CooMatrix:
    """Wheel graph: hub row 0 with ``spokes`` nonzeros plus the rim cycle
    (parity: InitWheel, sparse_matrix.h:417-450). The hub row's extreme
    length is the row-skew stress test."""
    i = np.arange(spokes, dtype=np.int32)
    hub_rows = np.zeros(spokes, dtype=np.int32)
    hub_cols = i + 1
    rim_rows = i + 1
    rim_cols = ((i + 1) % spokes) + 1
    rows = np.concatenate([hub_rows, rim_rows])
    cols = np.concatenate([hub_cols, rim_cols])
    vals = np.full(2 * spokes, default_value, dtype=dtype)
    return CooMatrix(spokes + 1, spokes + 1, rows, cols, vals)


def _grid_neighbors(shape_dims, self_loop, default_value, dtype):
    """Shared stencil builder: nodes on a dense grid, one nonzero per
    (node, axis-neighbor) pair, optional self loop."""
    nd = len(shape_dims)
    n = int(np.prod(shape_dims))
    coords = np.unravel_index(np.arange(n), shape_dims)
    coords = np.stack(coords, axis=0)  # (nd, n)
    strides = np.ones(nd, dtype=np.int64)
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * shape_dims[d + 1]
    me = np.arange(n, dtype=np.int64)
    rows_l, cols_l = [], []
    for d in range(nd):
        for delta in (-1, +1):
            ok = (
                (coords[d] + delta >= 0) & (coords[d] + delta < shape_dims[d])
            )
            rows_l.append(me[ok])
            cols_l.append(me[ok] + delta * strides[d])
    if self_loop:
        rows_l.append(me)
        cols_l.append(me)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.full(rows.size, default_value, dtype=dtype)
    idt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idt), cols.astype(idt), vals)


def make_grid2d(width: int, self_loop: bool = False,
                default_value: float = 1.0, dtype=np.float64) -> CooMatrix:
    """2-D grid stencil (parity: InitGrid2d, sparse_matrix.h:458)."""
    return _grid_neighbors((width, width), self_loop, default_value, dtype)


def make_grid3d(width: int, self_loop: bool = False,
                default_value: float = 1.0, dtype=np.float64) -> CooMatrix:
    """3-D grid stencil (parity: InitGrid3d, sparse_matrix.h:533)."""
    return _grid_neighbors((width, width, width), self_loop, default_value,
                           dtype)


def make_laplacian_grid2d(width: int, dtype=np.float64) -> CooMatrix:
    """SPD 5-point Laplacian on a 2-D grid: 4 on the diagonal, -1 on
    neighbors. Standard SPD fixture for CG convergence tests."""
    g = _grid_neighbors((width, width), False, -1.0, dtype)
    n = g.num_rows
    rows = np.concatenate([g.rows, np.arange(n, dtype=g.rows.dtype)])
    cols = np.concatenate([g.cols, np.arange(n, dtype=g.cols.dtype)])
    vals = np.concatenate([g.vals, np.full(n, 4.0, dtype=dtype)])
    return CooMatrix(n, n, rows, cols, vals)


def make_laplacian_grid3d(width: int, dtype=np.float64) -> CooMatrix:
    """SPD 7-point Laplacian on a 3-D grid (6 on diagonal, -1 neighbors)."""
    g = _grid_neighbors((width, width, width), False, -1.0, dtype)
    n = g.num_rows
    rows = np.concatenate([g.rows, np.arange(n, dtype=g.rows.dtype)])
    cols = np.concatenate([g.cols, np.arange(n, dtype=g.cols.dtype)])
    vals = np.concatenate([g.vals, np.full(n, 6.0, dtype=dtype)])
    return CooMatrix(n, n, rows, cols, vals)


def make_variable_stencil(width: int, dims: int = 3,
                          full: bool = False, seed: int = 0,
                          sigma: float = 1.0, shift: float = 1e-2,
                          dtype=np.float64) -> CooMatrix:
    """Variable-coefficient SPD diffusion stencil on a ``dims``-D grid.

    The reference's synthetic grids (``InitGrid2d/3d``,
    ``sparse_matrix.h:458-623``) are CONSTANT-coefficient — the masked
    DIA path's best case; its real targets (SuiteSparse FD/FEM
    operators) have per-entry coefficients, which land on the
    *unmasked* plane-stream-bound value-plane path. This generator models
    ``div(c grad u)`` with lognormal edge conductivities
    ``c = exp(sigma * N(0, 1))``: the weighted graph Laplacian (diag =
    sum of incident conductivities) plus ``shift`` on the diagonal —
    symmetric, strictly diagonally dominant, SPD. Same diagonal
    PATTERN as the constant fixtures (every nonzero on a stencil
    diagonal — the DIA planner applies), but every plane carries
    per-row values, so ``formats.dia.plane_constants`` rejects masking
    and the plan streams full value planes.

    ``full=False``: axis neighbors only (5-point 2-D / 7-point 3-D).
    ``full=True``: all ``3^dims - 1`` neighbors (9-point / 27-point —
    the trilinear-FEM-on-hexahedra pattern; K=27 planes make the
    matvec decisively plane-bound, the bf16-plane refinement A/B
    regime). ``sigma`` sets coefficient contrast (condition number
    grows with it); ``shift`` regularizes the Neumann-singular
    Laplacian."""
    nd = int(dims)
    n = int(width) ** nd
    shape_dims = (width,) * nd
    rng = np.random.default_rng(seed)
    coords = np.stack(
        np.unravel_index(np.arange(n), shape_dims), axis=0)  # (nd, n)
    strides = np.ones(nd, dtype=np.int64)
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * shape_dims[d + 1]
    me = np.arange(n, dtype=np.int64)

    if full:
        # undirected edges once: keep lexicographically-positive
        # deltas (exactly one of each +-pair compares > the 0 tuple)
        deltas = []
        for raw in np.ndindex(*(3,) * nd):
            dl = tuple(x - 1 for x in raw)
            if dl > (0,) * nd:
                deltas.append(dl)
    else:
        deltas = [
            tuple(1 if k == d else 0 for k in range(nd))
            for d in range(nd)
        ]

    rows_l, cols_l, vals_l = [], [], []
    diag = np.full(n, float(shift), dtype=np.float64)
    for dl in deltas:
        ok = np.ones(n, dtype=bool)
        for d, dd in enumerate(dl):
            if dd:
                ok &= (coords[d] + dd >= 0) & (coords[d] + dd < width)
        i = me[ok]
        j = i + int(np.dot(dl, strides))
        c = np.exp(sigma * rng.standard_normal(i.size))
        rows_l += [i, j]
        cols_l += [j, i]
        vals_l += [-c, -c]
        np.add.at(diag, i, c)
        np.add.at(diag, j, c)
    rows = np.concatenate(rows_l + [me])
    cols = np.concatenate(cols_l + [me])
    vals = np.concatenate(
        [v.astype(dtype) for v in vals_l] + [diag.astype(dtype)])
    idt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idt), cols.astype(idt), vals)


def make_random_spd(n: int, row_nnz: int = 8, seed: int = 0,
                    dtype=np.float64, bandwidth: int | None = None,
                    ) -> CooMatrix:
    """Random sparse SPD matrix: symmetric pattern with random values plus
    a diagonal shift making it strictly diagonally dominant. When
    ``bandwidth`` is given, off-diagonals are confined to a band — the
    RCM-ordered-matrix model."""
    rng = np.random.default_rng(seed)
    k = max(row_nnz // 2, 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    if bandwidth:
        offs = rng.integers(1, max(bandwidth, 2), size=rows.size)
        cols = np.minimum(rows + offs, n - 1)
    else:
        cols = rng.integers(0, n, size=rows.size)
    vals = rng.standard_normal(rows.size).astype(dtype)
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    # symmetrize
    rows_s = np.concatenate([rows, cols])
    cols_s = np.concatenate([cols, rows])
    vals_s = np.concatenate([vals, vals])
    # diagonal dominance: diag = (sum |offdiag| per row) + 1
    abssum = np.zeros(n, dtype=np.float64)
    np.add.at(abssum, rows_s, np.abs(vals_s))
    rows_f = np.concatenate([rows_s, np.arange(n, dtype=np.int64)])
    cols_f = np.concatenate([cols_s, np.arange(n, dtype=np.int64)])
    vals_f = np.concatenate([vals_s, (abssum + 1.0).astype(dtype)])
    idt = np.int32 if n < 2**31 else np.int64
    coo = CooMatrix(n, n, rows_f.astype(idt), cols_f.astype(idt), vals_f)
    return coo.sum_duplicates()


def make_block_random(block_grid: int, blocks_per_row: int = 4,
                      block_rows: int = 8, block_cols: int = 128,
                      fill: float = 1.0, seed: int = 0,
                      dtype=np.float64) -> CooMatrix:
    """Block-sparse random matrix: a (block_grid x block_grid) grid of
    (block_rows x block_cols) tiles, ``blocks_per_row`` dense-ish tiles
    per block row (one always on the diagonal), each tile filled to
    ``fill`` density. The multi-DOF-FEM-style pattern the reference's
    BcsrMatrix targets (sparse_matrix.h:993-1258) — the fixture where
    the BSR route's dense panels carry no padding."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    per_tile = block_rows * block_cols
    k = max(int(per_tile * fill), 1)
    for br in range(block_grid):
        bcs = set([br % block_grid])
        while len(bcs) < min(blocks_per_row, block_grid):
            bcs.add(int(rng.integers(0, block_grid)))
        for bc in bcs:
            if fill >= 1.0:
                lr = np.repeat(np.arange(block_rows), block_cols)
                lc = np.tile(np.arange(block_cols), block_rows)
            else:
                flat = rng.choice(per_tile, size=k, replace=False)
                lr, lc = flat // block_cols, flat % block_cols
            rows_l.append(br * block_rows + lr)
            cols_l.append(bc * block_cols + lc)
    rows = np.concatenate(rows_l).astype(np.int64)
    cols = np.concatenate(cols_l).astype(np.int64)
    vals = rng.standard_normal(rows.size).astype(dtype)
    n_r = block_grid * block_rows
    n_c = block_grid * block_cols
    idt = np.int32
    coo = CooMatrix(n_r, n_c, rows.astype(idt), cols.astype(idt), vals)
    return coo.sum_duplicates()


def make_rmat(scale: int, edge_factor: int = 16,
              a: float = 0.57, b: float = 0.19, c: float = 0.19,
              seed: int = 0, symmetric: bool = True,
              dtype=np.float64) -> CooMatrix:
    """R-MAT (Graph500 Kronecker) power-law graph: 2^scale vertices,
    ~edge_factor * 2^scale edges sampled by recursive quadrant
    probabilities (a, b, c, d). This is the standard realistic-skew
    synthetic — heavy-tailed degree distributions like the SuiteSparse
    web/social matrices the reference's dataset pipeline targets
    (``ufl_matrices.txt``; fetch offline-blocked, see data/ufl/).

    Duplicate edges accumulate (CSR semantics); ``symmetric=True``
    mirrors edges so the pattern is structurally symmetric.
    """
    n = 1 << scale
    ne = edge_factor * n
    rng = np.random.default_rng(seed)
    rows = np.zeros(ne, dtype=np.int64)
    cols = np.zeros(ne, dtype=np.int64)
    for lvl in range(scale):
        u = rng.random(ne)
        # quadrant thresholds: a | b | c | d
        hi_r = u >= a + b                      # lower half (c or d)
        hi_c = (u >= a) & (u < a + b) | (u >= a + b + c)  # right (b|d)
        rows |= hi_r.astype(np.int64) << lvl
        cols |= hi_c.astype(np.int64) << lvl
    vals = rng.standard_normal(ne).astype(dtype)
    if symmetric:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
        vals = np.concatenate([vals, vals])
    idt = np.int32 if n <= np.iinfo(np.int32).max else np.int64
    return CooMatrix(n, n, rows.astype(idt), cols.astype(idt),
                     vals)


def make_rmat_spd(scale: int, edge_factor: int = 8, seed: int = 0,
                  dtype=np.float64) -> CooMatrix:
    """SPD power-law fixture: symmetric R-MAT with |values| off the
    diagonal made diagonally dominant (graph-Laplacian style), so CG
    convergence tests can run on realistic heavy-tailed patterns."""
    g = make_rmat(scale, edge_factor, seed=seed, symmetric=True,
                  dtype=np.float64)
    import scipy.sparse as sp

    S = sp.coo_matrix(
        (np.abs(g.vals), (g.rows, g.cols)), shape=g.shape
    ).tocsr()
    S.sum_duplicates()
    S.setdiag(0)
    S.eliminate_zeros()
    off = -S
    d = np.asarray(S.sum(axis=1)).ravel() + 1.0
    A = (off + sp.diags(d)).tocoo()
    return CooMatrix(g.num_rows, g.num_cols,
                     A.row.astype(np.int32), A.col.astype(np.int32),
                     A.data.astype(dtype))


def make_fem2d(n_points: int, seed: int = 0, lump: float = 1e-3,
               dtype=np.float64) -> CooMatrix:
    """P1 finite-element stiffness matrix on a random Delaunay
    triangulation of the unit square — the SuiteSparse structural /
    FEM class (``bcsstk*``, ``nasa*`` in the reference's
    ``ufl_matrices.txt``; fetch offline-blocked, see data/ufl/) built
    hermetically: genuinely irregular node numbering and bandwidth
    (random point insertion order), ~6-7 nnz/row, SPD.

    Element assembly is the textbook barycentric-gradient form: for a
    triangle with vertices p0,p1,p2 and opposite edge vectors
    e_i = p_{i+2} - p_{i+1}, the local stiffness is
    K_ij = (e_i . e_j) / (4 |T|). Pure-Neumann stiffness is singular;
    a lumped-mass shift ``lump * area_i`` on the diagonal makes it SPD
    (the discrete Helmholtz operator), keeping CG fixtures honest.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    tri = Delaunay(pts).simplices                 # (T, 3) int32
    p = pts[tri]                                  # (T, 3, 2)
    # e[:, i] = p[:, (i+2)%3] - p[:, (i+1)%3]
    e = p[:, [2, 0, 1]] - p[:, [1, 2, 0]]         # (T, 3, 2)
    area2 = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area = 0.5 * np.abs(area2)
    k = np.einsum("tix,tjx->tij", e, e) / (4.0 * area)[:, None, None]
    rows = np.repeat(tri, 3, axis=1).ravel()      # i index of K_ij
    cols = np.tile(tri, (1, 3)).ravel()           # j index of K_ij
    vals = k.ravel()
    # lumped-mass diagonal shift: area/3 per incident triangle vertex
    rows = np.concatenate([rows, tri.ravel()])
    cols = np.concatenate([cols, tri.ravel()])
    vals = np.concatenate(
        [vals, lump * np.repeat(area / 3.0, 3)]
    )
    # coalesce shared-element contributions so nnz is the true FEM
    # pattern (~7/row), not per-triangle duplicates
    import scipy.sparse as sp

    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(n_points, n_points)).tocsr().tocoo()
    return CooMatrix(n_points, n_points,
                     A.row.astype(np.int32), A.col.astype(np.int32),
                     A.data.astype(dtype))
