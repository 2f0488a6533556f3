"""Preconditioner tests: IC(0) vs direct Cholesky on the pattern,
triangular solves vs scipy, SPAI properties, PCG / SPAI-CG convergence
and iteration-count reduction."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from sparsela.io import generators
from sparsela.precond.ic0 import ic0_factorize
from sparsela.precond.spai import spai_inverse
from sparsela.precond import trisolve
from sparsela.solvers.cg import cg_solve_multi
from sparsela.solvers.pcg import make_ic0_preconditioner, pcg_solve_multi
from sparsela.solvers.spai_cg import spai_cg_solve_multi


@pytest.fixture(scope="module")
def spd():
    return generators.make_laplacian_grid2d(12).to_csr()


class TestIc0:
    def test_pattern_is_lower_triangle(self, spd):
        L = ic0_factorize(spd)
        rows = L.row_ids()
        assert np.all(np.asarray(L.col_indices) <= rows)
        # diagonal present and last in each row
        ro = np.asarray(L.row_offsets)
        diag_idx = ro[1:] - 1
        np.testing.assert_array_equal(
            np.asarray(L.col_indices)[diag_idx], np.arange(L.num_rows)
        )

    def test_exact_on_dense_band(self):
        # For a tridiagonal SPD matrix IC(0) == exact Cholesky
        n = 50
        d = np.full(n, 2.0)
        e = np.full(n - 1, -1.0)
        A = sp.diags([e, d, e], [-1, 0, 1]).tocsr()
        from sparsela.formats.csr import CsrMatrix

        L = ic0_factorize(CsrMatrix.from_scipy(A))
        Lref = np.linalg.cholesky(A.toarray())
        np.testing.assert_allclose(L.to_dense(), Lref, rtol=1e-12)

    def test_residual_small_on_laplacian(self, spd):
        L = ic0_factorize(spd)
        Ld = L.to_dense()
        A = spd.to_dense()
        # IC(0) residual is restricted to fill-in positions; on the
        # pattern itself A == (L L^T)
        prod = Ld @ Ld.T
        mask = A != 0
        np.testing.assert_allclose(prod[mask], A[mask], rtol=1e-8,
                                   atol=1e-8)

    def test_shift_retry_on_indefinite(self):
        # matrix with negative diagonal pivot forces shift retries
        from sparsela.formats.csr import CsrMatrix

        A = sp.csr_matrix(
            np.array([[1.0, 2.0], [2.0, 1.0]])  # indefinite
        )
        L = ic0_factorize(CsrMatrix.from_scipy(A))
        assert np.all(np.isfinite(np.asarray(L.values)))


class TestTrisolve:
    def test_forward_host_vs_scipy(self, spd, rng):
        L = ic0_factorize(spd)
        b = rng.standard_normal(spd.num_rows)
        x = trisolve.forward_solve_host(L, b)
        xe = scipy.linalg.solve_triangular(L.to_dense(), b, lower=True)
        np.testing.assert_allclose(x, xe, rtol=1e-10)

    def test_backward_host_vs_scipy(self, spd, rng):
        L = ic0_factorize(spd)
        b = rng.standard_normal(spd.num_rows)
        x = trisolve.backward_solve_host(L, b)
        xe = scipy.linalg.solve_triangular(L.to_dense().T, b, lower=False)
        np.testing.assert_allclose(x, xe, rtol=1e-10)

    def test_jacobi_converges_to_exact(self, spd, rng):
        L = ic0_factorize(spd)
        b = rng.standard_normal((spd.num_rows, 3))
        xe = trisolve.forward_solve_host(L, b)
        solver = trisolve.jacobi_trisolve_lower(L, sweeps=200)
        x = np.asarray(solver.solve(jnp.asarray(b)))
        np.testing.assert_allclose(x, xe, rtol=1e-6, atol=1e-8)

    def test_jacobi_upper(self, spd, rng):
        L = ic0_factorize(spd)
        b = rng.standard_normal((spd.num_rows, 2))
        xe = trisolve.backward_solve_host(L, b)
        solver = trisolve.jacobi_trisolve_upper(L, sweeps=200)
        x = np.asarray(solver.solve(jnp.asarray(b)))
        np.testing.assert_allclose(x, xe, rtol=1e-6, atol=1e-8)


class TestSpai:
    def test_pattern_and_symmetry(self, spd):
        M = spai_inverse(spd, batched=False)
        Md = M.to_dense()
        np.testing.assert_allclose(Md, Md.T, rtol=1e-10, atol=1e-12)

    def test_batched_matches_loop(self, spd):
        M1 = spai_inverse(spd, batched=False)
        M2 = spai_inverse(spd, batched=True)
        np.testing.assert_allclose(
            M1.to_dense(), M2.to_dense(), rtol=1e-6, atol=1e-8
        )

    def test_approximates_inverse(self, spd):
        M = spai_inverse(spd, batched=False)
        A = spd.to_dense()
        # ||AM - I||_F should beat the trivial scaling preconditioner
        resid = np.linalg.norm(A @ M.to_dense() - np.eye(spd.num_rows))
        trivial = np.linalg.norm(
            A * (1.0 / np.trace(A) * spd.num_rows) - np.eye(spd.num_rows)
        )
        assert resid < trivial


class TestPreconditionedSolvers:
    def test_pcg_converges_fewer_iterations(self, spd, rng):
        B = rng.standard_normal((spd.num_rows, 4))
        d = spd.to_device()
        base = cg_solve_multi(d, jnp.asarray(B), max_iters=2000,
                              tolerance=1e-8)
        L = ic0_factorize(spd)
        prec = make_ic0_preconditioner(L, sweeps=40)
        res = pcg_solve_multi(d, jnp.asarray(B), prec, max_iters=2000,
                              tolerance=1e-8)
        assert bool(np.all(np.asarray(res.converged)))
        X = np.asarray(res.x)
        rel = np.linalg.norm(B - spd.to_scipy() @ X, axis=0)
        rel /= np.linalg.norm(B, axis=0)
        assert rel.max() < 1e-7
        assert int(res.iterations) < int(base.iterations)

    def test_pcg_fp32_rhs_jits_and_keeps_dtype(self, spd, rng):
        """Regression: the fp64 IC(0) apply promoted the fp32 while-
        loop carry — a silent promotion when eager, a type-mismatch
        error under jit. The apply result must cast back to the RHS
        dtype and the whole solve must be jittable."""
        import functools

        import jax

        B = rng.standard_normal((spd.num_rows, 4)).astype(np.float32)
        d = spd.to_device(dtype=np.float32)
        Lf = ic0_factorize(spd)
        prec = make_ic0_preconditioner(Lf, sweeps=40)
        solve = jax.jit(functools.partial(
            pcg_solve_multi, d, apply_precond=prec, max_iters=2000,
            tolerance=1e-5))
        res = solve(jnp.asarray(B))
        assert res.x.dtype == jnp.float32
        assert bool(np.all(np.asarray(res.converged)))

    def test_pcg_dtype_casts_factor_before_planning(self, spd, rng):
        """dtype= must cast the fp64 IC(0) factor BEFORE planning so
        an fp32 solve's 2*sweeps-per-iteration tri-solve SpMMs run in
        fp32 (uncast they silently planned fp64, at twice the bytes),
        and convergence must be unaffected."""
        from sparsela.precond.trisolve import jacobi_trisolve_lower

        Lf = ic0_factorize(spd)
        fwd = jacobi_trisolve_lower(Lf, sweeps=4, dtype=np.float32)
        assert np.asarray(fwd.inv_diag).dtype == np.float32
        # fp32 input stays fp32 through the sweeps: with x64 on, an
        # uncast (fp64) plan would promote the solve to f64
        y = fwd.solve(jnp.ones(spd.num_rows, dtype=jnp.float32))
        assert y.dtype == jnp.float32

        B = rng.standard_normal((spd.num_rows, 4)).astype(np.float32)
        d = spd.to_device(dtype=np.float32)
        prec32 = make_ic0_preconditioner(Lf, sweeps=40,
                                         dtype=np.float32)
        res32 = pcg_solve_multi(d, jnp.asarray(B), prec32,
                                max_iters=2000, tolerance=1e-5)
        prec64 = make_ic0_preconditioner(Lf, sweeps=40)
        res64 = pcg_solve_multi(d, jnp.asarray(B), prec64,
                                max_iters=2000, tolerance=1e-5)
        assert bool(np.all(np.asarray(res32.converged)))
        assert abs(int(res32.iterations) - int(res64.iterations)) <= 2

    def test_spai_cg_converges(self, spd, rng):
        B = rng.standard_normal((spd.num_rows, 4))
        d = spd.to_device()
        base = cg_solve_multi(d, jnp.asarray(B), max_iters=2000,
                              tolerance=1e-8)
        M = spai_inverse(spd, batched=False)
        res = spai_cg_solve_multi(d, M.to_device(), jnp.asarray(B),
                                  max_iters=2000, tolerance=1e-8)
        assert bool(np.all(np.asarray(res.converged)))
        X = np.asarray(res.x)
        rel = np.linalg.norm(B - spd.to_scipy() @ X, axis=0)
        rel /= np.linalg.norm(B, axis=0)
        assert rel.max() < 1e-7
        assert int(res.iterations) <= int(base.iterations)


def test_spai_batched_lap3d_regression(rng):
    """Regression: bucket padding must keep the padded least-squares
    systems nonsingular when |I| lands exactly on a power of two
    (produced NaN columns and a diverging SPAI-CG on 3-D Laplacians)."""
    csr = generators.make_laplacian_grid3d(8).to_csr()
    M_l = spai_inverse(csr, batched=False)
    M_b = spai_inverse(csr, batched=True)
    assert np.isfinite(np.asarray(M_b.values)).all()
    np.testing.assert_allclose(
        M_b.to_dense(), M_l.to_dense(), rtol=1e-10, atol=1e-12
    )
    B = rng.standard_normal((csr.num_rows, 2))
    res = spai_cg_solve_multi(
        csr.to_device(), M_b.to_device(), jnp.asarray(B),
        max_iters=2000, tolerance=1e-8,
    )
    assert bool(np.all(np.asarray(res.converged)))


class TestLevelScheduled:
    def test_lower_exact(self, spd, rng):
        L = ic0_factorize(spd)
        solver = trisolve.level_trisolve_lower(L)
        b = rng.standard_normal((spd.num_rows, 3))
        x = np.asarray(solver.solve(jnp.asarray(b)))
        xe = trisolve.forward_solve_host(L, b)
        np.testing.assert_allclose(x, xe, rtol=1e-10, atol=1e-12)

    def test_upper_exact(self, spd, rng):
        L = ic0_factorize(spd)
        solver = trisolve.level_trisolve_upper(L)
        b = rng.standard_normal(spd.num_rows)
        x = np.asarray(solver.solve(jnp.asarray(b)))
        xe = trisolve.backward_solve_host(L, b)
        np.testing.assert_allclose(x, xe, rtol=1e-10, atol=1e-12)

    def test_jits(self, spd, rng):
        import jax

        L = ic0_factorize(spd)
        solver = trisolve.level_trisolve_lower(L)
        f = jax.jit(solver.solve)
        b = jnp.asarray(rng.standard_normal(spd.num_rows))
        np.testing.assert_allclose(
            np.asarray(f(b)), np.asarray(solver.solve(b)), rtol=1e-12
        )

    def test_exact_pcg_preconditioner(self, spd, rng):
        """PCG with exact level-scheduled tri-solves: iteration parity
        with the host-oracle preconditioner application."""
        L = ic0_factorize(spd)
        fwd = trisolve.level_trisolve_lower(L)
        bwd = trisolve.level_trisolve_upper(L)
        B = rng.standard_normal((spd.num_rows, 2))
        res = pcg_solve_multi(
            spd.to_device(), jnp.asarray(B),
            apply_precond=lambda R: bwd.solve(fwd.solve(R)),
            max_iters=500, tolerance=1e-8,
        )
        assert bool(np.all(np.asarray(res.converged)))

        def host_prec(Rn):
            return trisolve.backward_solve_host(
                L, trisolve.forward_solve_host(L, Rn)
            )

        # host-oracle PCG loop for iteration parity
        import numpy as np_
        X = np.zeros_like(B)
        R = B.copy()
        Z = host_prec(R)
        P = Z.copy()
        bn = np.linalg.norm(B, axis=0)
        rho = (R * Z).sum(0)
        S = spd.to_scipy()
        it = 0
        conv = np.zeros(B.shape[1], bool)
        while it < 500 and not conv.all():
            AP = S @ P
            alpha = np.where(conv, 0, rho / (P * AP).sum(0))
            X += alpha * P
            R -= alpha * AP
            rel = np.linalg.norm(R, axis=0) / bn
            conv |= rel < 1e-8
            Z = host_prec(R)
            rho_new = (R * Z).sum(0)
            beta = np.where(conv, 0, rho_new / rho)
            P = Z + beta * P
            rho = rho_new
            it += 1
        assert abs(int(res.iterations) - it) <= 1


def test_spai_cap_bounds_pattern_and_converges(rng):
    """cap= sparsifies to the cap largest-|v| entries per row
    (+diagonal) before SPAI construction — the practical remedy for
    power-law hubs whose uncapped dense problems reach degree^2 rows
    (minutes of set-up on a 16k-row R-MAT uncapped). The
    capped M must keep the bounded pattern, stay symmetric, and the
    preconditioned solve must still converge and beat plain CG."""
    from sparsela.precond.spai import _cap_pattern

    spd = generators.make_rmat_spd(9, edge_factor=8, seed=2).to_csr()
    capped = _cap_pattern(spd, 8)
    per_row = np.diff(np.asarray(capped.row_offsets))
    assert per_row.max() <= 9  # cap + diagonal
    # diagonal survives capping
    rows = np.repeat(np.arange(capped.num_rows), per_row)
    assert np.all(np.bincount(
        rows[np.asarray(capped.col_indices) == rows],
        minlength=capped.num_rows) == 1)

    M = spai_inverse(spd, cap=8)
    Ms = M.to_scipy()
    assert abs(Ms - Ms.T).max() < 1e-12  # symmetrized
    B = rng.standard_normal((spd.num_rows, 4))
    d = spd.to_device()
    base = cg_solve_multi(d, jnp.asarray(B), max_iters=4000,
                          tolerance=1e-8)
    res = spai_cg_solve_multi(d, M.to_device(), jnp.asarray(B),
                              max_iters=4000, tolerance=1e-8)
    assert bool(np.all(np.asarray(res.converged)))
    assert int(res.iterations) < int(base.iterations)


def test_spai_hub_auto_guard(rng, monkeypatch):
    """Construction-time hub detection. cap='auto' (the default)
    applies the symmetric cap with a warning when a padded problem
    exceeds the guard; cap=None preserves the reference's literal
    uncapped pattern (guard off) — both pinned."""
    import warnings

    import sparsela.precond.spai as spai_mod
    from sparsela.precond.spai import spai_inverse

    # a hub fixture: one dense-ish column on a sparse band. Shrink the
    # guard so the small fixture trips it (the MECHANISM is what this
    # pins).
    n = 400
    csr = generators.make_random_spd(n, row_nnz=6, seed=5)
    S = csr.to_scipy().tolil()
    S[:, 0] = 1.0
    S[0, :] = 1.0
    from sparsela.formats.csr import CsrMatrix

    hub = CsrMatrix.from_scipy(S.tocsr())
    monkeypatch.setattr(spai_mod, "SPAI_GUARD_CELLS", 1 << 14)
    with pytest.warns(UserWarning, match="auto-applying the symmetric"):
        M = spai_inverse(hub)  # default cap='auto'
    Ms = M.to_scipy()
    assert abs(Ms - Ms.T).max() < 1e-12
    # the capped pattern is strictly smaller than the uncapped one
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # guard OFF: no notice
        M_ref = spai_inverse(hub, cap=None)  # reference parity
    assert M.nnz < M_ref.nnz
    # below the guard, cap='auto' leaves the pattern untouched
    monkeypatch.setattr(spai_mod, "SPAI_GUARD_CELLS", 1 << 62)
    M_auto = spai_inverse(hub)
    assert M_auto.nnz == M_ref.nnz


def test_pcg_transposed_dia_path_matches_generic(rng):
    """The transposed-space PCG fast path (pure-DIA fp32 plans; state
    in (L, n), apply behind boundary transposes) must agree with the
    generic (n, L) path on the reference-strategy operand: solution,
    iteration count within 1, all lanes converged."""
    import numpy as np
    from sparsela.io import generators
    from sparsela.ops.spmv import plan_matrix
    from sparsela.solvers.cg import _pure_dia_of

    csr = generators.make_laplacian_grid3d(6, dtype=np.float32).to_csr()
    A = plan_matrix(csr, dtype=np.float32, L=32)
    assert _pure_dia_of(A) is not None
    A_ref = plan_matrix(csr, dtype=np.float32, strategy="reference")
    Lf = ic0_factorize(csr)
    prec = make_ic0_preconditioner(Lf, sweeps=2, num_rhs=32,
                                   dtype=np.float32)
    B = rng.standard_normal((csr.num_rows, 32)).astype(np.float32)
    r_t = pcg_solve_multi(A, jnp.asarray(B), prec, max_iters=600,
                          tolerance=1e-5)
    r_g = pcg_solve_multi(A_ref, jnp.asarray(B), prec, max_iters=600,
                          tolerance=1e-5)
    assert abs(int(r_t.iterations) - int(r_g.iterations)) <= 1
    assert bool(np.all(np.asarray(r_t.converged)))
    np.testing.assert_allclose(
        np.asarray(r_t.x), np.asarray(r_g.x), rtol=2e-4, atol=2e-4
    )
