"""Realistic irregular-pattern validation.

The reference's dataset is 2,757 SuiteSparse matrices
(``ufl_matrices.txt``, vendored at data/ufl/); this host has no
network egress, so the heavy-tailed R-MAT (Graph500 Kronecker)
generator stands in for the web/social-graph class — the patterns
where merge-path load balance and the AUTO gates earn their keep.
Every test drives the FULL pipeline: generator -> .mtx write ->
(native) parse -> AUTO plan -> golden check / solve.
"""

import numpy as np
import pytest

from sparsela.formats.csr import CsrMatrix
from sparsela.io import generators
from sparsela.io.market import read_market, write_market
from sparsela.ops.spmv import plan_matrix, spmv
from sparsela.solvers.cg import cg_solve_multi


def _degrees(csr):
    return np.diff(np.asarray(csr.row_offsets))


def test_rmat_is_heavy_tailed():
    csr = generators.make_rmat(12, 16, seed=1).to_csr()
    deg = _degrees(csr)
    mean = deg.mean()
    # a power-law-ish graph: hub degree far above the mean, positive
    # skewness (the wheel is the extreme case; RMAT is the realistic one)
    assert deg.max() > 20 * mean
    skew = ((deg - mean) ** 3).mean() / max(deg.std() ** 3, 1e-30)
    assert skew > 5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rmat_mtx_pipeline_golden(tmp_path, dtype):
    """generator -> write_market -> read_market (native parser when
    built) -> AUTO plan -> SpMV golden vs scipy."""
    coo = generators.make_rmat(10, 8, seed=3, dtype=np.float64)
    p = tmp_path / "rmat10.mtx"
    write_market(str(p), coo.to_csr())
    csr = CsrMatrix.from_coo(read_market(str(p), dtype=np.float64))
    S = csr.to_scipy()

    plan = plan_matrix(csr, dtype=dtype)
    x = np.random.default_rng(0).standard_normal(
        csr.num_cols
    ).astype(dtype)
    y = np.asarray(spmv(plan, x))
    ref = S.astype(dtype) @ x
    tol = 2e-5 if dtype == np.float32 else 1e-10
    scale = np.abs(ref).max() + 1.0
    assert np.abs(y - ref).max() / scale < tol


@pytest.mark.slow
def test_rmat_spd_cg_iteration_parity():
    """CG on a heavy-tailed SPD pattern: every route (AUTO, cusparse,
    reference) converges in IEEE f64, within a few iterations of each
    other (the routes sum each row in different orders) — the
    reference's cross-implementation-agreement test shape
    (cpu_spmv.cpp:866-895) on a realistic matrix."""
    import jax.numpy as jnp

    csr = generators.make_rmat_spd(10, 8, seed=5).to_csr()
    L = 3
    B = np.random.default_rng(1).standard_normal(
        (csr.num_rows, L)
    ).astype(np.float64)
    iters = {}
    for strat in ("auto", "cusparse", "reference"):
        A = plan_matrix(csr.astype(np.float64), strategy=strat,
                        dtype=np.float64, L=L)
        res = cg_solve_multi(A, jnp.asarray(B), max_iters=2000,
                             tolerance=1e-8)
        assert bool(np.all(np.asarray(res.converged))), strat
        iters[strat] = int(res.iterations)
    # every route is IEEE f64; only the summation order differs, which
    # moves CG's finite-precision trajectory by a few iterations at most
    for k in ("cusparse", "auto"):
        assert iters[k] <= iters["reference"] + max(
            2, iters["reference"] // 10
        ), iters


def test_rmat_auto_plan_handles_skew():
    """The planner must not blow up the payload on hub rows; whatever
    strategy AUTO picks, the result is correct on the skewed pattern."""
    csr = generators.make_rmat(11, 12, seed=7).to_csr()
    plan = plan_matrix(csr, dtype=np.float32)
    S = csr.to_scipy()
    x = np.random.default_rng(2).standard_normal(
        csr.num_cols
    ).astype(np.float32)
    y = np.asarray(spmv(plan, x))
    ref = (S @ x).astype(np.float32)
    scale = np.abs(ref).max() + 1.0
    assert np.abs(y - ref).max() / scale < 2e-5


def test_ufl_lists_vendored():
    """The reference's SuiteSparse manifests ship with the repo so the
    fetch pipeline is one command when the network allows
    (get_uf_datasets.sh; reference get_uf_datasets.sh:10-24)."""
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "ufl")
    mats = open(os.path.join(root, "ufl_matrices.txt")).read().split()
    urls = open(os.path.join(root, "ufl_urls.txt")).read().split()
    assert len(mats) == 2757 and len(urls) == 2757
    assert all(u.endswith(".tar.gz") for u in urls[:10])


class TestFem2d:
    """P1 FEM stiffness on random Delaunay triangulations — the
    hermetic stand-in for the SuiteSparse structural class (bcsstk*,
    reference dataset pipeline ufl_matrices.txt)."""

    def test_structure(self):
        csr = generators.make_fem2d(3000, seed=2).to_csr()
        S = csr.to_scipy()
        assert abs(S - S.T).max() == 0.0
        # true FEM pattern, not per-triangle duplicates
        assert 6.0 <= csr.nnz / csr.num_rows <= 8.0
        # irregular natural numbering: bandwidth is O(n), not banded
        coo = S.tocoo()
        assert np.abs(coo.row - coo.col).max() > csr.num_rows // 4

    def test_spd_and_golden_spmv(self):
        from sparsela.ops.reference import spmv_numpy
        from sparsela.ops.spmv import spmv

        import jax.numpy as jnp

        csr = generators.make_fem2d(2000, seed=0).to_csr()
        S = csr.to_scipy()
        rng = np.random.default_rng(1)
        # SPD: random quadratic forms positive
        for _ in range(3):
            v = rng.standard_normal(csr.num_rows)
            assert v @ (S @ v) > 0
        x = rng.standard_normal(csr.num_cols)
        A = plan_matrix(csr, strategy="auto", dtype=np.float64)
        y = np.asarray(spmv(A, jnp.asarray(x)))
        ref = spmv_numpy(csr, x)
        scale = np.abs(ref).max() + 1.0
        assert np.abs(y - ref).max() / scale < 1e-10

    @pytest.mark.slow
    def test_cg_iteration_parity(self):
        """FEM stiffness is ill-conditioned (cond ~1/lump), so CG's
        iteration count depends on rounding: the IEEE-f64 routes sum
        rows in different orders and must land within 15% of the
        reference route at tol 1e-8."""
        import jax.numpy as jnp

        csr = generators.make_fem2d(1500, seed=4).to_csr()
        b = np.random.default_rng(2).standard_normal(
            (csr.num_rows, 1))
        iters = {}
        for strat in ("auto", "cusparse", "reference"):
            A = plan_matrix(csr, strategy=strat, dtype=np.float64, L=1)
            res = cg_solve_multi(A, jnp.asarray(b), max_iters=5000,
                                 tolerance=1e-8)
            assert bool(np.all(np.asarray(res.converged))), strat
            iters[strat] = int(res.iterations)
        for k in ("cusparse", "auto"):
            assert iters[k] <= int(iters["reference"] * 1.15), iters

    def test_rcm_recovers_fem_bandwidth(self):
        """The FEM class is exactly where RCM reordering earns its
        keep: random node numbering -> O(n) bandwidth, RCM -> O(
        sqrt(n))-ish band, so x reads stay local."""
        from sparsela.ops.reorder import rcm_order, permute_symmetric

        csr = generators.make_fem2d(3000, seed=2).to_csr()
        perm = rcm_order(csr)
        csr_p = permute_symmetric(csr, perm)
        coo0 = csr.to_scipy().tocoo()
        coo1 = csr_p.to_scipy().tocoo()
        bw0 = int(np.abs(coo0.row - coo0.col).max())
        bw1 = int(np.abs(coo1.row - coo1.col).max())
        assert bw1 * 4 < bw0, (bw0, bw1)

    def test_reorder_auto_gate_fires_on_fem(self):
        """reorder='auto' permutes exactly the FEM class (random node
        numbering, large recoverable bandwidth) and leaves
        already-banded stencils alone."""
        from sparsela.ops.reorder import ReorderedPlan

        fem = generators.make_fem2d(20000, seed=1,
                                    dtype=np.float32).to_csr()
        lap = generators.make_laplacian_grid2d(
            128, dtype=np.float32).to_csr()
        assert isinstance(
            plan_matrix(fem, dtype=np.float32, reorder="auto"),
            ReorderedPlan)
        assert not isinstance(
            plan_matrix(lap, dtype=np.float32, reorder="auto"),
            ReorderedPlan)
