"""Halo-exchange distributed DIA on the 8-device virtual CPU mesh.

Parity bar: same as test_parallel_solvers — the halo recurrence is
mathematically identical to the single-device CG (psum dots, exact
matvec), so iteration counts must match ±1. The matvec itself must be
exact vs scipy including across every shard boundary (that is what
the halo exchange is for). Reference: stencil fixtures
sparse_matrix.h:458-623 under no_pretreatment.hpp:35-197.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from sparsela.formats.csr import CsrMatrix
from sparsela.formats.dia import partition_dia, select_diagonals
from sparsela.io import generators
from sparsela.parallel import sharded as sh
from sparsela.parallel import sharded_dia as sd


@pytest.fixture(scope="module")
def mesh():
    return sh.make_mesh()


def _dia_of(csr):
    offs = select_diagonals(csr)
    dia, rest = partition_dia(csr, offs)
    assert rest.nnz == 0
    return dia


def _setup(csr, mesh):
    dia = _dia_of(csr)
    s = sd.shard_dia(dia, mesh.devices.size)
    return sd.device_put_sharded_dia(s, mesh), s


def test_fits_halo_and_shard_errors(mesh):
    n = 64
    A = sp.diags([np.ones(n - 40)], [40], shape=(n, n), format="csr")
    dia, _ = partition_dia(CsrMatrix.from_scipy(A), np.array([40]))
    # 8 shards of 8 rows: offset 40 reaches 5 shards away
    assert not sd.fits_halo(dia, 8)
    with pytest.raises(ValueError, match="halo"):
        sd.shard_dia(dia, 8)
    assert sd.fits_halo(dia, 1)


def test_spmv_sharded_exact_across_boundaries(mesh, rng):
    """Offsets wider than one lane and non-divisible n: every halo
    path (left edge, right edge, ragged tail) must agree with scipy."""
    n = 1003  # not divisible by 8 -> padded tail
    offsets = [-100, -3, 0, 1, 97]
    diags = [rng.standard_normal(n) for _ in offsets]
    A = sp.diags(diags, offsets, shape=(n, n), format="csr")
    csr = CsrMatrix.from_scipy(A.tocsr().astype(np.float64))
    std, s = _setup(csr, mesh)
    x = rng.standard_normal(n)
    xp = sh.to_padded_layout(x, s)
    y = sd.spmv_dia_sharded(std, xp, mesh)
    got = sh.from_padded_layout(np.asarray(y), s)
    np.testing.assert_allclose(got, A @ x, rtol=1e-12, atol=1e-12)


def test_spmm_sharded_parity(mesh, rng):
    csr = generators.make_laplacian_grid2d(22, dtype=np.float64).to_csr()
    std, s = _setup(csr, mesh)
    X = rng.standard_normal((csr.num_rows, 5))
    Xp = sh.to_padded_layout(X, s)
    Y = sd.spmm_dia_sharded(std, Xp, mesh)
    got = sh.from_padded_layout(np.asarray(Y), s)
    np.testing.assert_allclose(got, csr.to_scipy() @ X,
                               rtol=1e-12, atol=1e-12)


def test_cg_solve_dia_sharded_iteration_parity(mesh, rng):
    from sparsela.formats.dia import to_device_dia
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_laplacian_grid2d(20, dtype=np.float64).to_csr()
    std, s = _setup(csr, mesh)
    b = rng.standard_normal(csr.num_rows)
    bp = sh.to_padded_layout(b, s)
    res = sd.cg_solve_dia_sharded(std, bp, mesh, max_iters=800,
                                  tolerance=1e-6, record_history=True)
    assert bool(res.converged)
    x = sh.from_padded_layout(np.asarray(res.x), s)
    r = b - csr.to_scipy() @ x
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5

    single = cg_solve(
        to_device_dia(_dia_of(csr), dtype=np.float64),
        jnp.asarray(b), max_iters=800, tolerance=1e-6,
    )
    assert abs(int(res.iterations) - int(single.iterations)) <= 1
    hist = np.asarray(res.history)
    assert np.isfinite(hist[: int(res.iterations)]).all()


def test_cg_solve_multi_dia_sharded_masks(mesh, rng):
    from sparsela.formats.dia import to_device_dia
    from sparsela.solvers.cg import cg_solve_multi

    csr = generators.make_laplacian_grid2d(20, dtype=np.float64).to_csr()
    std, s = _setup(csr, mesh)
    L = 4
    B = rng.standard_normal((csr.num_rows, L))
    B *= np.array([1.0, 10.0, 0.1, 5.0])[None, :]
    Bp = sh.to_padded_layout(B, s)
    res = sd.cg_solve_multi_dia_sharded(std, Bp, mesh, max_iters=800,
                                        tolerance=1e-6)
    assert bool(np.all(np.asarray(res.converged)))
    X = sh.from_padded_layout(np.asarray(res.x), s)
    R = B - csr.to_scipy() @ X
    rel = np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-5

    single = cg_solve_multi(
        to_device_dia(_dia_of(csr), dtype=np.float64),
        jnp.asarray(B), max_iters=800, tolerance=1e-6,
    )
    assert abs(int(res.iterations) - int(single.iterations)) <= 1


def test_masked_sharded_dia_matches_plane_form(mesh, rng):
    """The constant-coefficient bitmask
    sharded form — values identical to the plane form, solver parity,
    non-maskable operators rejected."""
    csr = generators.make_laplacian_grid2d(20,
                                           dtype=np.float32).to_csr()
    dia = _dia_of(csr)
    s_m = sd.shard_dia(dia, mesh.devices.size, masked=True)
    assert s_m.vals is not None and s_m.data.dtype == np.int32
    s_p = sd.shard_dia(dia, mesh.devices.size)
    std_m = sd.device_put_sharded_dia(s_m, mesh)
    std_p = sd.device_put_sharded_dia(s_p, mesh)
    x = rng.standard_normal(csr.num_rows).astype(np.float32)
    xp = sh.to_padded_layout(x, s_m)
    y_m = np.asarray(sd.spmv_dia_sharded(std_m, xp, mesh))
    y_p = np.asarray(sd.spmv_dia_sharded(std_p, xp, mesh))
    np.testing.assert_array_equal(y_m, y_p)  # identical values
    b = rng.standard_normal(csr.num_rows).astype(np.float32)
    bp = sh.to_padded_layout(b, s_m)
    r_m = sd.cg_solve_dia_sharded(std_m, bp, mesh, max_iters=800,
                                  tolerance=1e-5)
    r_p = sd.cg_solve_dia_sharded(std_p, bp, mesh, max_iters=800,
                                  tolerance=1e-5)
    assert bool(r_m.converged)
    assert int(r_m.iterations) == int(r_p.iterations)
    # variable-coefficient operators are not maskable
    var = generators.make_variable_stencil(
        8, dims=2, seed=1, dtype=np.float32).to_csr()
    with pytest.raises(ValueError, match="constant-coefficient"):
        sd.shard_dia(_dia_of(var), mesh.devices.size, masked=True)


def test_fp64_sharded_dia_cg(mesh, rng):
    """Genuine XLA f64 halo-DIA CG across the mesh,
    iteration parity with the single-device fp64 solve."""
    from sparsela.formats.dia import to_device_dia
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_laplacian_grid2d(18,
                                           dtype=np.float64).to_csr()
    std, s = _setup(csr, mesh)
    assert std.data.dtype == jnp.float64
    b = rng.standard_normal(csr.num_rows)
    bp = sh.to_padded_layout(b, s)
    res = sd.cg_solve_dia_sharded(std, bp, mesh, max_iters=800,
                                  tolerance=1e-10)
    assert bool(res.converged)
    x = sh.from_padded_layout(np.asarray(res.x), s)
    rel = np.linalg.norm(b - csr.to_scipy() @ x) / np.linalg.norm(b)
    assert rel < 1e-9
    single = cg_solve(
        to_device_dia(_dia_of(csr), dtype=np.float64),
        jnp.asarray(b), max_iters=800, tolerance=1e-10)
    assert abs(int(res.iterations) - int(single.iterations)) <= 1
