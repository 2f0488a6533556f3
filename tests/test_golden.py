"""Golden tests of every route against scipy: AUTO and each explicit
strategy x the matrix classes the library serves (stencils, skew,
power law, FEM, variable coefficients, block structure, the committed
real collection matrices) x {f32, f64} x L in {1, 8}; the AUTO routing
table; reordering parity; solver iteration parity per route.

Oracle: scipy.sparse in f64 (the reference's SpmvGold semantics,
work_2025/spmm/sample.hpp:14-34)."""

import functools
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.io import generators
from sparsela.io.market import read_market
from sparsela.ops.spmv import (
    plan_kind,
    plan_matrix,
    plan_semantics,
    spmm,
    spmv,
)

_REAL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "real")

MATRICES = {
    "lap2d": lambda: generators.make_laplacian_grid2d(12),
    "lap3d": lambda: generators.make_laplacian_grid3d(6),
    "wheel": lambda: generators.make_wheel(300),
    "rmat": lambda: generators.make_rmat(8, edge_factor=8, seed=1),
    "fem2d": lambda: generators.make_fem2d(400, seed=2),
    "varcoef27": lambda: generators.make_variable_stencil(
        6, dims=3, full=True, shift=1.0),
    "block_random": lambda: generators.make_block_random(
        6, blocks_per_row=3, block_rows=8, block_cols=16, seed=3),
    **{name: functools.partial(
        lambda n: read_market(os.path.join(_REAL, f"{n}.mtx")), name)
       for name in ("Trefethen_20", "Trefethen_200", "bibd_9_3",
                    "gr_30_30", "karate", "lesmis", "mycielskian7")},
}
STRATEGIES = ("auto", "reference", "cusparse", "bcoo", "bsr", "dia")
TOL = {np.float32: 5e-5, np.float64: 1e-12}


@functools.lru_cache(maxsize=None)
def _csr(name):
    return MATRICES[name]().to_csr()


def _rel(y, ref):
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", list(MATRICES))
def test_route_matches_scipy(name, strategy, dtype, L):
    csr = _csr(name)
    S = csr.to_scipy().astype(np.float64)
    A = plan_matrix(csr, strategy=strategy, dtype=dtype, L=L)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{L}".encode()))
    if L == 1:
        x = rng.standard_normal(csr.num_cols).astype(dtype)
        y = spmv(A, jnp.asarray(x))
    else:
        x = rng.standard_normal((csr.num_cols, L)).astype(dtype)
        y = spmm(A, jnp.asarray(x))
    assert np.asarray(y).dtype == dtype
    assert _rel(y, S @ x.astype(np.float64)) < TOL[dtype]
    assert plan_semantics(A) == ("f32" if dtype == np.float32
                                 else "ieee-f64")


# AUTO's route per matrix class (L=1 and L=8 plan alike): stencils and
# constant-coefficient grids go masked DIA, variable coefficients go
# value-plane DIA, the wheel's rim peels off its hub, and everything
# without diagonal structure takes the general CSR route.
AUTO_KIND = {
    "lap2d": "dia_masked",
    "lap3d": "dia_masked",
    "wheel": "hybrid_dia_masked",
    "rmat": "cusparse",
    "fem2d": "cusparse",
    "varcoef27": "dia",
    "block_random": "hybrid_dia",
    "Trefethen_20": "hybrid_dia",
    "Trefethen_200": "dia",
    "bibd_9_3": "hybrid_dia_masked",
    "gr_30_30": "dia_masked",
    "karate": "cusparse",
    "lesmis": "cusparse",
    "mycielskian7": "cusparse",
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(MATRICES))
def test_auto_routing_table(name, dtype):
    A = plan_matrix(_csr(name), dtype=dtype)
    assert plan_kind(A) == AUTO_KIND[name]
    assert np.dtype(A.dtype) == dtype


@pytest.mark.parametrize("L,kind", [(1, "cusparse"), (2, "cusparse"),
                                    (4, "bsr"), (8, "bsr"), (16, "bsr")])
def test_auto_bsr_gate_by_rhs_width(L, kind):
    """Dense 8x128 blocks: AUTO takes BSR only for wide RHS blocks."""
    csr = generators.make_block_random(8, blocks_per_row=3, seed=4
                                       ).to_csr()
    assert plan_kind(plan_matrix(csr, dtype=np.float32, L=L)) == kind


@pytest.mark.parametrize("order", ["rcm", "degree", "auto"])
@pytest.mark.parametrize("name", ["lap2d", "wheel", "rmat", "fem2d",
                                  "gr_30_30"])
def test_reorder_parity(name, order):
    csr = _csr(name)
    S = csr.to_scipy()
    rng = np.random.default_rng(5)
    x = rng.standard_normal(csr.num_cols)
    X = rng.standard_normal((csr.num_cols, 3))
    A = plan_matrix(csr, dtype=np.float64, reorder=order)
    assert _rel(spmv(A, jnp.asarray(x)), S @ x) < 1e-12
    assert _rel(spmm(A, jnp.asarray(X)), S @ X) < 1e-12


def _host_cg_iters(S, b, tol, max_iters=5000):
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    thr = tol * np.linalg.norm(b)
    it = 0
    while it < max_iters and np.sqrt(rs) >= thr:
        Ap = S @ p
        alpha = rs / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        rs_new = r @ r
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return it


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_cg_iteration_parity_per_route(strategy):
    """f64 CG on every route matches the host oracle's iteration count
    (±1: only the reduction order differs) and solves the system."""
    from sparsela.solvers.cg import cg_solve, cg_solve_multi

    csr = _csr("lap2d")
    S = csr.to_scipy()
    b = np.random.default_rng(6).standard_normal(csr.num_rows)
    A = plan_matrix(csr, strategy=strategy, dtype=np.float64, L=4)
    res = cg_solve(A, jnp.asarray(b), tolerance=1e-10)
    assert abs(int(res.iterations) - _host_cg_iters(S, b, 1e-10)) <= 1
    x = np.asarray(res.x)
    assert np.linalg.norm(b - S @ x) / np.linalg.norm(b) < 1e-9
    B = np.stack([b, 2 * b[::-1], b + 1, -b], axis=1)
    resm = cg_solve_multi(A, jnp.asarray(B), tolerance=1e-10)
    want = max(_host_cg_iters(S, B[:, j].copy(), 1e-10) for j in range(4))
    assert abs(int(resm.iterations) - want) <= 1
