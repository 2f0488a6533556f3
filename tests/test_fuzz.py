"""Randomized cross-strategy fuzzing — many small random matrices with
assorted shapes/densities through every route against the numpy
oracle (the property-test layer SURVEY §4 calls for)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.formats.coo import CooMatrix
from sparsela.formats.csr import CsrMatrix
from sparsela.io import generators
from sparsela.ops.reference import spmv_numpy
from sparsela.ops.spmv import plan_matrix, spmm, spmv

ROUTES = ("auto", "reference", "cusparse", "bcoo", "bsr", "dia")


def random_matrix(rng, seed):
    r = np.random.default_rng(seed)
    m = int(r.integers(1, 400))
    n = int(r.integers(1, 400))
    nnz = int(r.integers(1, max(m * n // 4, 2)))
    shape_kind = seed % 4
    rows = r.integers(0, m, nnz).astype(np.int32)
    if shape_kind == 0:      # uniform random
        cols = r.integers(0, n, nnz).astype(np.int32)
    elif shape_kind == 1:    # banded
        cols = np.clip(rows * n // m + r.integers(-8, 9, nnz), 0,
                       n - 1).astype(np.int32)
    elif shape_kind == 2:    # few hot columns
        cols = r.choice(
            r.integers(0, n, max(n // 16, 1)), nnz
        ).astype(np.int32)
    else:                    # skewed rows (one hub)
        rows[: nnz // 2] = 0
        cols = r.integers(0, n, nnz).astype(np.int32)
    vals = r.standard_normal(nnz)
    return CsrMatrix.from_coo(
        CooMatrix(m, n, rows, cols, vals), sum_dups=True
    )


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_kernels_vs_oracle(seed, rng):
    """Every route, SpMV and SpMM (L=8), on degenerate shapes (1-row,
    tiny-nnz, hot-column, hub rows) against the numpy oracle."""
    csr = random_matrix(rng, seed)
    x = np.random.default_rng(seed + 999).standard_normal(csr.num_cols)
    golden = spmv_numpy(csr, x)
    scale = np.abs(golden).max() + 1.0
    X = np.tile(x[:, None], (1, 8)).astype(np.float32)
    for route in ROUTES:
        A = plan_matrix(csr, strategy=route, dtype=np.float32)
        y = np.asarray(spmv(A, jnp.asarray(x.astype(np.float32))))
        np.testing.assert_allclose(y / scale, golden / scale, atol=5e-5,
                                   err_msg=route)
        Y = np.asarray(spmm(A, jnp.asarray(X)))
        np.testing.assert_allclose(Y[:, 0] / scale, golden / scale,
                                   atol=5e-5, err_msg=route)


def test_cg_single_csr_plan(rng):
    """Single-RHS CG on the general CSR route (cpu_singlecg parity):
    converges to the fp32-appropriate tolerance."""
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_laplacian_grid2d(16).to_csr()
    A = plan_matrix(csr, strategy="cusparse", dtype=np.float32)
    b = rng.standard_normal(csr.num_rows).astype(np.float32)
    res = cg_solve(A, jnp.asarray(b), max_iters=1000, tolerance=1e-5)
    assert bool(res.converged)
    x = np.asarray(res.x)
    rel = np.linalg.norm(b - csr.to_scipy() @ x) / np.linalg.norm(b)
    assert rel < 1e-4


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_dia_bands(seed):
    """The DIA apply against scipy on random banded matrices: random
    offset sets (both signs, wide and narrow), ragged n, random L, value
    planes in f32/f64 and the masked form."""
    import scipy.sparse as sp

    from sparsela.formats.dia import partition_dia, to_device_dia
    from sparsela.ops.dia import spmm_dia_t

    r = np.random.default_rng(1000 + seed)
    n = int(r.integers(50, 2000))
    K = int(r.integers(1, 8))
    cand = np.unique(np.concatenate([r.integers(-n + 1, n, K), [0]]))
    offsets = cand.astype(np.int64)
    const = bool(seed % 2)
    diags = [np.full(n - abs(int(o)), float(r.integers(1, 5)))
             if const else r.standard_normal(n - abs(int(o)))
             for o in offsets]
    A = sp.diags(diags, offsets, shape=(n, n), format="csr")
    csr = CsrMatrix.from_scipy(A.tocsr())
    dia, rest = partition_dia(csr, offsets)
    assert rest.nnz == 0
    L = int(r.integers(1, 6))
    XT = r.standard_normal((L, n))
    refM = (A @ XT.T).T
    scale = max(np.abs(refM).max(), 1e-6)
    for dt, atol in ((np.float32, 5e-5), (np.float64, 1e-12)):
        D = to_device_dia(dia, dtype=dt)
        assert D.masked == const
        YT = np.asarray(spmm_dia_t(D, jnp.asarray(XT.astype(dt))))
        np.testing.assert_allclose(YT / scale, refM / scale, atol=atol)
