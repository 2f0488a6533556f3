"""Full jitted distributed solvers on the 8-device virtual CPU mesh.

Parity bar: the sharded solvers must converge with the SAME iteration
count (±1) as their single-device counterparts — the distributed
recurrence is mathematically identical (psum dots, all_gathered
row-sharded CSR SpMM), only the data layout differs. Reference solvers:
no_pretreatment.hpp:35-197, incomplete_cholesky.hpp:36-199,
sparse_approximate_inverse.hpp:31-230.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.io import generators
from sparsela.parallel import sharded as sh
from sparsela.parallel import solvers as ps


@pytest.fixture(scope="module")
def mesh():
    return sh.make_mesh()


def _spd_lap2d(width=20, dtype=np.float32):
    return generators.make_laplacian_grid2d(width, dtype=dtype).to_csr()


def _setup(csr, mesh):
    st = sh.shard_csr(csr, mesh.devices.size)
    return sh.device_put_sharded(st, mesh), st


def test_cg_solve_sharded_matches_single_device(mesh, rng):
    from sparsela.ops.spmv import plan_matrix
    from sparsela.solvers.cg import cg_solve

    csr = _spd_lap2d()
    std, st = _setup(csr, mesh)
    b = rng.standard_normal(csr.num_rows).astype(np.float32)
    bp = sh.to_padded_layout(b, st)

    res = ps.cg_solve_sharded(std, bp, mesh, max_iters=800,
                              tolerance=1e-6, record_history=True)
    assert bool(res.converged)
    x = sh.from_padded_layout(np.asarray(res.x), st)
    r = b - csr.to_scipy() @ x
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5

    single = cg_solve(
        plan_matrix(csr, strategy="cusparse", dtype=np.float32),
        jnp.asarray(b), max_iters=800, tolerance=1e-6,
    )
    assert abs(int(res.iterations) - int(single.iterations)) <= 1
    # history recorded up to the executed iteration count
    hist = np.asarray(res.history)
    assert np.isfinite(hist[: int(res.iterations)]).all()
    assert np.isnan(hist[int(res.iterations):]).all()


def test_cg_solve_multi_sharded_per_lane_masks(mesh, rng):
    from sparsela.ops.spmv import plan_matrix
    from sparsela.solvers.cg import cg_solve_multi

    csr = _spd_lap2d()
    std, st = _setup(csr, mesh)
    L = 4
    B = rng.standard_normal((csr.num_rows, L)).astype(np.float32)
    # scale lanes differently so they converge at different iterations
    B *= np.array([1.0, 10.0, 0.1, 5.0], dtype=np.float32)[None, :]
    Bp = sh.to_padded_layout(B, st)

    res = ps.cg_solve_multi_sharded(std, Bp, mesh, max_iters=800,
                                    tolerance=1e-6)
    assert bool(np.all(np.asarray(res.converged)))
    X = sh.from_padded_layout(np.asarray(res.x), st)
    R = B - csr.to_scipy() @ X
    rel = np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-5

    single = cg_solve_multi(
        plan_matrix(csr, strategy="cusparse", dtype=np.float32, L=L),
        jnp.asarray(B), max_iters=800, tolerance=1e-6,
    )
    assert abs(int(res.iterations) - int(single.iterations)) <= 1


def test_pcg_solve_sharded_ic0(mesh, rng):
    from sparsela.precond.ic0 import ic0_factorize

    csr = _spd_lap2d(16)
    std, st = _setup(csr, mesh)
    Lf = ic0_factorize(csr)
    lt, ut, inv_d = ps.shard_ic0_factor(Lf, st)
    ltd = sh.device_put_sharded(lt, mesh)
    utd = sh.device_put_sharded(ut, mesh)

    L = 3
    B = rng.standard_normal((csr.num_rows, L)).astype(np.float32)
    Bp = sh.to_padded_layout(B, st)
    inv_dp = inv_d.astype(np.float32)

    res = ps.pcg_solve_multi_sharded(
        std, ltd, utd, inv_dp, Bp, mesh, max_iters=400,
        tolerance=1e-6, sweeps=24,
    )
    assert bool(np.all(np.asarray(res.converged)))
    X = sh.from_padded_layout(np.asarray(res.x), st)
    R = B - csr.to_scipy() @ X
    rel = np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-5

    # preconditioning must actually help: fewer iterations than CG
    plain = ps.cg_solve_multi_sharded(std, Bp, mesh, max_iters=400,
                                      tolerance=1e-6)
    assert int(res.iterations) < int(plain.iterations)


def test_spai_solve_sharded(mesh, rng):
    from sparsela.precond.spai import spai_inverse

    csr = _spd_lap2d(16)
    std, st = _setup(csr, mesh)
    M = spai_inverse(csr)
    mt = sh.shard_csr(M.astype(np.float32), st.num_shards,
                      bounds=ps.shard_bounds(st))
    mtd = sh.device_put_sharded(mt, mesh)

    L = 3
    B = rng.standard_normal((csr.num_rows, L)).astype(np.float32)
    Bp = sh.to_padded_layout(B, st)
    res = ps.spai_solve_multi_sharded(std, mtd, Bp, mesh,
                                      max_iters=400, tolerance=1e-6)
    assert bool(np.all(np.asarray(res.converged)))
    X = sh.from_padded_layout(np.asarray(res.x), st)
    R = B - csr.to_scipy() @ X
    rel = np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-5


def test_shared_bounds_layout_agrees(mesh):
    """The IC(0) factor shards must reuse the system matrix's padded
    layout (round-2 lesson: heterogeneous shard layouts are where the
    silent bugs live)."""
    csr = _spd_lap2d(16)
    _, st = _setup(csr, mesh)
    from sparsela.precond.ic0 import ic0_factorize

    Lf = ic0_factorize(csr)
    lt, ut, inv_d = ps.shard_ic0_factor(Lf, st)
    assert lt.rows_per_shard == st.rows_per_shard
    assert ut.rows_per_shard == st.rows_per_shard
    np.testing.assert_array_equal(np.asarray(lt.row_start),
                                  np.asarray(st.row_start))
    assert inv_d.shape[0] == st.num_shards * st.rows_per_shard
