"""BLAS-1 helper tests and the solver iteration-pinning guard."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from sparsela.io import generators
from sparsela.ops import blas
from sparsela.solvers.cg import cg_solve


def test_dot_helpers_match_numpy(rng):
    a = rng.standard_normal((512, 4))
    b = rng.standard_normal((512, 4))
    np.testing.assert_allclose(
        np.asarray(blas.dot_multiple(jnp.asarray(a), jnp.asarray(b))),
        (a * b).sum(axis=0), rtol=1e-12)
    np.testing.assert_allclose(
        float(blas.dot_single(jnp.asarray(a[:, 0]), jnp.asarray(b[:, 0]))),
        a[:, 0] @ b[:, 0], rtol=1e-12)


def test_cg_tolerance_zero_pins_iteration_count():
    """tolerance=0 must run exactly max_iters (the --device_rate
    contract): long past fp32 convergence the residual underflows to
    exactly zero and an unguarded beta = rs_new/0 NaN-ed the state,
    exiting the while_loop at a data-dependent iteration."""
    csr = generators.make_laplacian_grid2d(16, dtype=np.float32).to_csr()
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(csr.num_rows).astype(np.float32))
    res = cg_solve(csr.to_device(), b, max_iters=1500, tolerance=0.0)
    assert int(res.iterations) == 1500
