"""Symmetric relabeling + RCM reordering (ops/reorder.py).

Reference capability: ``CooMatrix::InitCsrRelabel``
(``sparse_matrix.h:184-207``). The RCM pre-order
recovers a low-bandwidth form from a scrambled-banded matrix (local
gathers of x, and the DIA path again where diagonals reappear); CG
trajectories are permutation-invariant.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sparsela.io import generators
from sparsela.ops.reorder import (
    ReorderedPlan,
    bandwidth,
    degree_order,
    permute_symmetric,
    plan_reorder,
    rcm_order,
)
from sparsela.ops.spmv import plan_matrix, spmm, spmv
from sparsela.ops.reference import spmv_numpy


def _scrambled_lap2d(width=40, seed=7):
    """2-D Laplacian under a random symmetric permutation — banded
    structure hidden behind a scattered-looking pattern."""
    csr = generators.make_laplacian_grid2d(width, dtype=np.float64
                                           ).to_csr()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(csr.num_rows)
    return permute_symmetric(csr, perm), csr


def test_permute_symmetric_dense_parity(rng):
    m = generators.make_random_spd(300, row_nnz=6, seed=3).to_csr()
    perm = np.random.default_rng(0).permutation(300)
    mp = permute_symmetric(m, perm)
    d = m.to_dense()
    np.testing.assert_allclose(mp.to_dense(), d[np.ix_(perm, perm)],
                               rtol=0, atol=0)
    # InitCsrRelabel convention: relabel = argsort(perm) maps old->new
    relabel = np.argsort(perm)
    d2 = np.zeros_like(d)
    d2[np.ix_(relabel, relabel)] = d
    np.testing.assert_allclose(mp.to_dense(), d2, rtol=0, atol=0)


def test_rcm_recovers_bandwidth():
    scr, orig = _scrambled_lap2d(40)
    assert bandwidth(scr) > 800          # scrambled: O(n)
    rec = permute_symmetric(scr, rcm_order(scr))
    assert bandwidth(rec) <= 4 * bandwidth(orig)


def test_reordered_plan_spmv_matches_oracle(rng):
    scr, _ = _scrambled_lap2d(32)
    A = plan_reorder(scr, dtype=np.float32, order="rcm")
    assert isinstance(A, ReorderedPlan)
    x = rng.standard_normal(scr.num_cols)
    golden = spmv_numpy(scr, x)
    y = np.asarray(spmv(A, jnp.asarray(x.astype(np.float32))))
    scale = np.abs(golden).max()
    np.testing.assert_allclose(y / scale, golden / scale, atol=5e-5)
    # beta path
    y0 = rng.standard_normal(scr.num_rows).astype(np.float32)
    y2 = np.asarray(spmv(A, jnp.asarray(x.astype(np.float32)),
                         alpha=2.0, beta=0.5, y=jnp.asarray(y0)))
    np.testing.assert_allclose(
        y2 / scale, (2 * golden + 0.5 * y0) / scale, atol=1e-4)


def test_reordered_plan_spmm_matches_oracle(rng):
    scr, _ = _scrambled_lap2d(24)
    A = plan_reorder(scr, dtype=np.float32, L=8, order="rcm")
    X = rng.standard_normal((scr.num_cols, 8)).astype(np.float32)
    Y = np.asarray(spmm(A, jnp.asarray(X)))
    ref = scr.to_scipy() @ X.astype(np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(Y / scale, ref / scale, atol=5e-5)


def test_auto_gate():
    # scrambled-banded: gate fires
    scr, orig = _scrambled_lap2d(40)
    assert isinstance(
        plan_matrix(scr, dtype=np.float32, reorder="auto"),
        ReorderedPlan)
    # natively banded: already local, keep order
    assert not isinstance(
        plan_matrix(orig, dtype=np.float32, reorder="auto"),
        ReorderedPlan)
    # power-law: RCM cannot compress, keep order
    rm = generators.make_rmat(11, edge_factor=8, seed=1).to_csr()
    assert not isinstance(
        plan_matrix(rm, dtype=np.float32, reorder="auto"),
        ReorderedPlan)


def test_auto_gate_keeps_hub_pinned_order():
    """Hub rows pin the max bandwidth, so RCM cannot pass the
    bandwidth gate on sparse R-MAT, and 'auto' never picks the degree
    order: the plan stays in the native order."""
    from sparsela.ops.reorder import RCM_GAIN, RCM_SLACK

    scr = generators.make_rmat(14, edge_factor=4, seed=1).to_csr()
    rec = permute_symmetric(scr, rcm_order(scr))
    assert bandwidth(rec) + RCM_SLACK > RCM_GAIN * bandwidth(scr)
    A = plan_matrix(scr, dtype=np.float32, reorder="auto")
    assert not isinstance(A, ReorderedPlan)


def test_degree_order_spmv_parity(rng):
    """order='degree' clusters hot columns and still computes the
    original-coordinate y = A x."""
    from sparsela.ops.spmv import plan_kind

    csr = generators.make_rmat(12, dtype=np.float32).to_csr()
    A = plan_reorder(csr, strategy="cusparse", dtype=np.float32,
                     order="degree")
    assert isinstance(A, ReorderedPlan) and A.order == "degree"
    assert plan_kind(A) == "degree+cusparse"
    x = rng.standard_normal(csr.num_cols)
    golden = spmv_numpy(csr, x)
    y = np.asarray(spmv(A, jnp.asarray(x.astype(np.float32))))
    scale = np.abs(golden).max()
    np.testing.assert_allclose(y / scale, golden / scale, atol=5e-5)


def test_degree_order_hot_columns_first():
    """The ordering itself: column degrees are non-increasing in the
    permuted matrix, and a uniform-degree matrix (ring: every column
    degree 2) comes back in its native order — the stable sort of
    equal keys."""
    from sparsela.formats.coo import CooMatrix
    from sparsela.formats.csr import CsrMatrix

    csr = generators.make_rmat(12, dtype=np.float32).to_csr()
    rec = permute_symmetric(csr, degree_order(csr))
    deg = np.bincount(np.asarray(rec.col_indices), minlength=rec.num_cols)
    assert (np.diff(deg) <= 0).all()
    m = 2048
    i = np.arange(m, dtype=np.int64)
    ring = CsrMatrix.from_coo(CooMatrix(
        m, m,
        np.concatenate([i, i]),
        np.concatenate([(i + 1) % m, (i - 1) % m]),
        np.ones(2 * m, dtype=np.float32)))
    np.testing.assert_array_equal(degree_order(ring), np.arange(m))


def test_cg_iteration_parity_under_reorder(rng):
    """P A P^T is similar to A: CG converges in the same iterations
    (±2 for rounding) and to the same solution."""
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_laplacian_grid2d(24, dtype=np.float64
                                           ).to_csr()
    scram = np.random.default_rng(3).permutation(csr.num_rows)
    scr = permute_symmetric(csr, scram)
    b = rng.standard_normal(scr.num_rows).astype(np.float32)

    A0 = plan_matrix(scr, strategy="cusparse", dtype=np.float32)
    r0 = cg_solve(A0, jnp.asarray(b), max_iters=2000, tolerance=1e-5)
    A1 = plan_reorder(scr, strategy="cusparse", dtype=np.float32,
                      order="rcm")
    r1 = cg_solve(A1, jnp.asarray(b), max_iters=2000, tolerance=1e-5)
    assert bool(r0.converged) and bool(r1.converged)
    assert abs(int(r0.iterations) - int(r1.iterations)) <= 2
    rel = np.linalg.norm(
        b - scr.to_scipy() @ np.asarray(r1.x, dtype=np.float64)
    ) / np.linalg.norm(b)
    assert rel < 1e-4


def test_rcm_restores_dia_route():
    """The point of the exercise on the card: a scrambled stencil plans
    onto the general CSR route, and its RCM-recovered order brings the
    diagonals back to the DIA path (plan_kind 'rcm+dia...')."""
    from sparsela.ops.spmv import plan_kind

    scr, _ = _scrambled_lap2d(64)
    assert plan_kind(plan_matrix(scr, dtype=np.float32)) == "cusparse"
    A = plan_matrix(scr, dtype=np.float32, reorder="rcm")
    assert plan_kind(A).startswith("rcm+")


def test_cg_multi_reordered_fast_path(rng):
    """cg_solve_multi on a ReorderedPlan solves in the permuted space
    (one gather in, one out) and returns original-order solutions."""
    from sparsela.solvers.cg import cg_solve_multi

    scr, _ = _scrambled_lap2d(20, seed=9)
    A = plan_reorder(scr, strategy="cusparse", dtype=np.float32,
                     order="rcm")
    B = rng.standard_normal((scr.num_rows, 4)).astype(np.float32)
    res = cg_solve_multi(A, jnp.asarray(B), max_iters=2000,
                         tolerance=1e-5)
    assert bool(np.all(np.asarray(res.converged)))
    X = np.asarray(res.x, dtype=np.float64)
    rel = np.linalg.norm(B - scr.to_scipy() @ X) / np.linalg.norm(B)
    assert rel < 1e-4


def test_pcg_reordered_plan_dispatch_route(rng):
    """Preconditioned solvers take the dispatch route for a
    ReorderedPlan (the preconditioner lives in original coordinates,
    which stays a valid SPD preconditioner): multicg's --reorder
    combination converges."""
    from sparsela.precond.ic0 import ic0_factorize
    from sparsela.solvers.pcg import (
        make_ic0_preconditioner,
        pcg_solve_multi,
    )

    csr = generators.make_laplacian_grid2d(16, dtype=np.float64).to_csr()
    scram = np.random.default_rng(4).permutation(csr.num_rows)
    scr = permute_symmetric(csr, scram)
    A = plan_reorder(scr, strategy="cusparse", dtype=np.float32,
                     order="rcm")
    Lf = ic0_factorize(scr)
    prec = make_ic0_preconditioner(Lf, sweeps=40)
    B = rng.standard_normal((scr.num_rows, 4)).astype(np.float32)
    res = pcg_solve_multi(A, jnp.asarray(B), prec, max_iters=2000,
                          tolerance=1e-5)
    assert bool(np.all(np.asarray(res.converged)))
    X = np.asarray(res.x, dtype=np.float64)
    rel = np.linalg.norm(B - scr.to_scipy() @ X) / np.linalg.norm(B)
    assert rel < 1e-4
