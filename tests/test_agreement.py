"""Cross-implementation agreement — the reference's core test pattern
(SURVEY §4: every op runs through all implementations against one
golden model, cpu_spmv.cpp:866-895). Here: the XLA reference in f64
and every route in f32 and f64 against the numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.io import generators
from sparsela.ops.reference import spmv_numpy
from sparsela.ops.spmv import plan_matrix, spmv, spmm


MATRICES = [
    ("lap2d", lambda: generators.make_laplacian_grid2d(24).to_csr()),
    ("lap3d", lambda: generators.make_laplacian_grid3d(8).to_csr()),
    ("spd_band", lambda: generators.make_random_spd(
        1000, row_nnz=12, seed=9, bandwidth=200).to_csr()),
    ("wheel", lambda: generators.make_wheel(1500).to_csr()),
]


@pytest.mark.parametrize("name,make", MATRICES)
def test_all_strategies_agree_spmv(name, make, rng):
    csr = make()
    x = rng.standard_normal(csr.num_cols)
    golden = spmv_numpy(csr, x)
    scale = np.abs(golden).max() + 1.0

    for strat in ("reference", "cusparse", "bcoo", "bsr", "dia", "auto"):
        for dtype, tol in ((np.float32, 3e-5), (np.float64, 1e-12)):
            A = plan_matrix(csr, strategy=strat, dtype=dtype)
            y = np.asarray(spmv(A, jnp.asarray(x.astype(dtype))))
            err = np.abs(y - golden).max() / scale
            assert err < tol, f"{name}/{strat}/{dtype}: err {err:.2e}"


@pytest.mark.parametrize("name,make", MATRICES[:2])
def test_all_strategies_agree_spmm(name, make, rng):
    csr = make()
    L = 8
    X = rng.standard_normal((csr.num_cols, L))
    golden = csr.to_scipy() @ X
    scale = np.abs(golden).max() + 1.0
    for strat, dtype, tol in [
        ("reference", np.float64, 1e-12),
        ("cusparse", np.float32, 5e-5),
        ("cusparse", np.float64, 1e-12),
        ("bsr", np.float32, 5e-5),
        ("dia", np.float32, 5e-5),
    ]:
        A = plan_matrix(csr, strategy=strat, dtype=dtype, L=L)
        Y = np.asarray(spmm(A, jnp.asarray(X.astype(dtype))))
        err = np.abs(Y - golden).max() / scale
        assert err < tol, f"{name}/{strat}: err {err:.2e}"


def test_bcoo_baseline_agrees(rng):
    """jax.experimental.sparse BCOO agrees with the numpy oracle."""
    from sparsela.ops.reference import to_bcoo

    csr = generators.make_laplacian_grid2d(16).to_csr()
    x = rng.standard_normal(csr.num_cols)
    golden = spmv_numpy(csr, x)
    m = to_bcoo(csr)
    y = np.asarray(m @ jnp.asarray(x))
    np.testing.assert_allclose(y, golden, rtol=1e-12)
