"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.io import generators
from sparsela.parallel import sharded as sh


@pytest.fixture(scope="module")
def mesh():
    return sh.make_mesh()


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8


def test_shard_csr_partition_is_lossless(rng):
    csr = generators.make_laplacian_grid2d(20).to_csr()
    A = sh.shard_csr(csr, 8)
    # reassemble
    total = 0
    d = np.zeros(csr.shape)
    bounds = np.concatenate([np.asarray(A.row_start), [A.num_rows]])
    for i in range(A.num_shards):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        offs = np.asarray(A.row_offsets[i])
        for lr in range(r1 - r0):
            s0, s1 = offs[lr], offs[lr + 1]
            for k in range(s0, s1):
                d[r0 + lr, A.col_indices[i][k]] += A.values[i][k]
            total += s1 - s0
    assert total == csr.nnz
    np.testing.assert_allclose(d, csr.to_dense())


def test_spmv_sharded_matches_scipy(mesh, rng):
    csr = generators.make_laplacian_grid2d(20).to_csr()
    A = sh.shard_csr(csr, mesh.devices.size)
    Ad = sh.device_put_sharded(A, mesh)
    x = rng.standard_normal(csr.num_cols)
    y_pad = np.asarray(sh.spmv_sharded(Ad, jnp.asarray(x), mesh))
    y = sh.from_padded_layout(y_pad, A)
    np.testing.assert_allclose(y, csr.to_scipy() @ x, rtol=1e-12)


def test_spmm_sharded(mesh, rng):
    csr = generators.make_laplacian_grid2d(16).to_csr()
    A = sh.shard_csr(csr, mesh.devices.size)
    Ad = sh.device_put_sharded(A, mesh)
    X = rng.standard_normal((csr.num_cols, 4))
    Y_pad = np.asarray(sh.spmm_sharded(Ad, jnp.asarray(X), mesh))
    Y = sh.from_padded_layout(Y_pad, A)
    np.testing.assert_allclose(Y, csr.to_scipy() @ X, rtol=1e-12)


def test_cg_step_sharded_matches_single_device(mesh, rng):
    """One sharded CG step == one reference CG step (to fp64 tolerance)."""
    csr = generators.make_laplacian_grid2d(12).to_csr()
    n = csr.num_rows
    L = 3
    B = rng.standard_normal((n, L))
    A = sh.shard_csr(csr, mesh.devices.size)
    Ad = sh.device_put_sharded(A, mesh)

    Bp = sh.to_padded_layout(B, A)
    X = jnp.zeros_like(jnp.asarray(Bp))
    R = jnp.asarray(Bp)
    Pd = jnp.asarray(Bp)
    rs_old = jnp.sum(jnp.asarray(B) ** 2, axis=0)

    step = jax.jit(
        lambda X, R, Pd, rs: sh.cg_step_sharded(Ad, (X, R, Pd, rs), mesh)
    )
    Xn, Rn, Pn, rs = step(X, R, Pd, rs_old)

    # reference single-device step
    S = csr.to_scipy()
    AP = S @ B
    pAp = (B * AP).sum(0)
    alpha = rs_old / pAp
    Xe = alpha[None, :] * B
    Re = B - alpha[None, :] * AP
    rs_e = (Re * Re).sum(0)

    np.testing.assert_allclose(
        sh.from_padded_layout(np.asarray(Xn), A), Xe, rtol=1e-10
    )
    np.testing.assert_allclose(
        sh.from_padded_layout(np.asarray(Rn), A), Re, rtol=1e-10
    )
    np.testing.assert_allclose(np.asarray(rs), rs_e, rtol=1e-10)


def test_cg_full_solve_sharded(mesh, rng):
    """Iterating the sharded step converges to the true solution."""
    csr = generators.make_laplacian_grid2d(10).to_csr()
    n = csr.num_rows
    B = rng.standard_normal((n, 2))
    A = sh.shard_csr(csr, mesh.devices.size)
    Ad = sh.device_put_sharded(A, mesh)
    Bp = jnp.asarray(sh.to_padded_layout(B, A))
    X, R, Pd = jnp.zeros_like(Bp), Bp, Bp
    rs = jnp.sum(jnp.asarray(B) ** 2, axis=0)
    step = jax.jit(
        lambda X, R, Pd, rs: sh.cg_step_sharded(Ad, (X, R, Pd, rs), mesh)
    )
    for _ in range(300):
        X, R, Pd, rs = step(X, R, Pd, rs)
        if float(jnp.max(rs)) < 1e-20:
            break
    Xh = sh.from_padded_layout(np.asarray(X), A)
    err = np.linalg.norm(B - csr.to_scipy() @ Xh) / np.linalg.norm(B)
    assert err < 1e-8
