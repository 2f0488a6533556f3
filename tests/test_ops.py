"""SpMV/SpMM reference-op tests vs scipy, and BLAS-1 op tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.formats.coo import CooMatrix
from sparsela.formats.csr import CsrMatrix
from sparsela.io import generators
from sparsela.ops import blas
from sparsela.ops import reference as ref
from sparsela.ops.spmv import spmv, spmm, SpmvStrategy


def cases():
    return [
        ("grid2d", generators.make_grid2d(12).to_csr()),
        ("wheel", generators.make_wheel(300).to_csr()),
        ("dense", generators.make_dense(20, 30).to_csr()),
        ("spd", generators.make_random_spd(150, row_nnz=8).to_csr()),
        ("lap3d", generators.make_laplacian_grid3d(6).to_csr()),
    ]


@pytest.mark.parametrize("name,csr", cases())
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_reference_vs_scipy(name, csr, dtype, rng):
    x = rng.standard_normal(csr.num_cols).astype(dtype)
    d = csr.to_device(dtype=dtype)
    y = np.asarray(ref.spmv_reference(d, jnp.asarray(x)))
    expect = csr.to_scipy().astype(dtype) @ x
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(y, expect, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,csr", cases()[:3])
def test_spmv_alpha_beta(name, csr, rng):
    x = rng.standard_normal(csr.num_cols)
    y0 = rng.standard_normal(csr.num_rows)
    d = csr.to_device()
    got = np.asarray(
        ref.spmv_reference(d, jnp.asarray(x), alpha=2.5, beta=-0.5,
                           y=jnp.asarray(y0))
    )
    expect = 2.5 * (csr.to_scipy() @ x) - 0.5 * y0
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("L", [1, 8, 32])
def test_spmm_reference_vs_scipy(L, rng):
    csr = generators.make_laplacian_grid2d(10).to_csr()
    X = rng.standard_normal((csr.num_cols, L))
    d = csr.to_device()
    got = np.asarray(ref.spmm_reference(d, jnp.asarray(X)))
    expect = csr.to_scipy() @ X
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_spmv_numpy_oracle(rng):
    csr = generators.make_grid2d(10).to_csr()
    x = rng.standard_normal(csr.num_cols)
    np.testing.assert_allclose(
        ref.spmv_numpy(csr, x), csr.to_scipy() @ x, rtol=1e-13
    )


def test_spmv_public_dispatch(rng):
    csr = generators.make_grid2d(8).to_csr()
    x = rng.standard_normal(csr.num_cols)
    got = np.asarray(spmv(csr.to_device(), jnp.asarray(x)))
    np.testing.assert_allclose(got, csr.to_scipy() @ x, rtol=1e-12)


def test_strategy_aliases():
    # the reference's vendor baseline (MKL) maps onto cuSPARSE
    assert SpmvStrategy.parse("mkl") == SpmvStrategy.CUSPARSE
    assert SpmvStrategy.parse("csr") == SpmvStrategy.CUSPARSE
    assert SpmvStrategy.parse("hybrid") == SpmvStrategy.DIA
    assert SpmvStrategy.parse(SpmvStrategy.BSR) == SpmvStrategy.BSR
    # reference decompositions and removed families raise with guidance
    for name in ("simple", "merge", "nonzero_split", "row_split",
                 "ell", "nmajor"):
        with pytest.raises(ValueError, match="cusparse"):
            SpmvStrategy.parse(name)
    with pytest.raises(ValueError):
        SpmvStrategy.parse("no_such_route")


def test_plan_matrix_auto(rng):
    import jax.experimental.sparse as jsparse

    from sparsela.ops.hybrid import HybridPlan
    from sparsela.ops.spmv import plan_matrix

    # regular stencil -> pure masked DIA for any L/dtype
    csr = generators.make_laplacian_grid2d(16).to_csr()
    for L in (1, 16):
        A = plan_matrix(csr, dtype=np.float32, L=L)
        assert isinstance(A, HybridPlan) and A.rest is None
        assert A.dia.masked
    # fp64 stencil -> IEEE f64 masked DIA
    A3 = plan_matrix(csr, dtype=np.float64)
    assert isinstance(A3, HybridPlan) and A3.dia.dtype == np.float64
    # skewed wheel: ring diagonals peel to DIA, hub/spokes -> cuSPARSE
    wheel = generators.make_wheel(2000).to_csr()
    for dt in (np.float32, np.float64):
        A2 = plan_matrix(wheel, dtype=dt, L=16)
        assert isinstance(A2, HybridPlan)
        assert isinstance(A2.rest, jsparse.CSR)
        assert A2.rest.dtype == dt
    # no diagonal structure -> the general CSR route at any L/dtype
    from sparsela.formats.coo import CooMatrix

    n = 40000
    scatter = CsrMatrix.from_coo(CooMatrix(
        n, n, np.arange(n), (np.arange(n) * 131) % n, np.ones(n)))
    for dt in (np.float32, np.float64):
        for L in (1, 8):
            A5 = plan_matrix(scatter, dtype=dt, L=L)
            assert isinstance(A5, jsparse.CSR) and A5.dtype == dt
    # _allow_dia=False plans the remainder of a hybrid
    Ae = plan_matrix(csr, dtype=np.float32, L=16, _allow_dia=False)
    assert isinstance(Ae, jsparse.CSR)


def test_empty_rows_produce_zeros():
    coo = CooMatrix(4, 4, np.array([0, 3]), np.array([1, 2]),
                    np.array([1.0, 2.0]))
    d = CsrMatrix.from_coo(coo).to_device()
    y = np.asarray(ref.spmv_reference(d, jnp.ones(4)))
    np.testing.assert_allclose(y, [1.0, 0.0, 0.0, 2.0])


def test_jit_and_grad():
    csr = generators.make_laplacian_grid2d(6).to_csr()
    d = csr.to_device()
    x = jnp.ones(csr.num_cols, dtype=jnp.float64)

    f = jax.jit(lambda x: jnp.sum(ref.spmv_reference(d, x) ** 2))
    g = jax.grad(f)(x)
    # grad of ||Ax||^2 = 2 A^T A x
    A = csr.to_dense()
    np.testing.assert_allclose(
        np.asarray(g), 2 * A.T @ (A @ np.ones(csr.num_cols)), rtol=1e-10
    )


class TestBlas:
    def test_dot_multiple(self, rng):
        a = rng.standard_normal((50, 4))
        b = rng.standard_normal((50, 4))
        got = np.asarray(blas.dot_multiple(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, (a * b).sum(0), rtol=1e-12)

    def test_axpy_multiple(self, rng):
        y = rng.standard_normal((50, 4))
        x = rng.standard_normal((50, 4))
        al = rng.standard_normal(4)
        got = np.asarray(
            blas.axpy_multiple(jnp.asarray(y), jnp.asarray(al), jnp.asarray(x))
        )
        np.testing.assert_allclose(got, y + al[None, :] * x, rtol=1e-12)

    def test_update_p_multiple(self, rng):
        r = rng.standard_normal((50, 4))
        p = rng.standard_normal((50, 4))
        be = rng.standard_normal(4)
        got = np.asarray(
            blas.update_p_multiple(jnp.asarray(r), jnp.asarray(be),
                                   jnp.asarray(p))
        )
        np.testing.assert_allclose(got, r + be[None, :] * p, rtol=1e-12)
