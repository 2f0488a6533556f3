"""DIA format + hybrid DIA/CSR partition tests.

Parity oracle: scipy.sparse (the reference's SpmvGold semantics,
work_2025/spmm/sample.hpp:14-34).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from sparsela.formats.csr import CsrMatrix
from sparsela.formats.dia import (
    DiaHost,
    diagonal_profile,
    partition_dia,
    select_diagonals,
    to_device_dia,
)
from sparsela.io import generators
from sparsela.ops.dia import spmm_dia, spmv_dia
from sparsela.ops.hybrid import HybridPlan
from sparsela.ops.spmv import plan_matrix, spmm, spmv


def _rng():
    return np.random.default_rng(0)


def test_diagonal_profile_tridiag():
    n = 100
    T = sp.diags(
        [np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
        [-1, 0, 1], format="csr",
    )
    csr = CsrMatrix.from_scipy(T.tocsr())
    offs, counts, lengths = diagonal_profile(csr)
    assert list(offs) == [-1, 0, 1]
    assert list(counts) == [n - 1, n, n - 1]
    assert list(lengths) == [n - 1, n, n - 1]


def test_select_respects_occupancy_and_cap():
    n = 200
    # dense main diagonal + a single scattered entry far off-diagonal
    rows = np.concatenate([np.arange(n), [0]])
    cols = np.concatenate([np.arange(n), [n - 3]])
    vals = np.ones(n + 1)
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    csr = CsrMatrix.from_scipy(S)
    offs = select_diagonals(csr)
    assert list(offs) == [0]  # the lone far entry's occupancy ~ 1/3


def test_partition_exact_split():
    n = 300
    A = sp.diags([np.ones(n), 2 * np.ones(n - 7)], [0, 7],
                 format="csr") + sp.random(
        n, n, density=0.001, random_state=3, format="csr"
    )
    A = A.tocsr()
    csr = CsrMatrix.from_scipy(A)
    offs = select_diagonals(csr)
    dia, rest = partition_dia(csr, offs)
    # dia + rest reassembles the matrix exactly
    D = sp.dia_matrix(
        (np.zeros((len(dia.offsets), n)), dia.offsets), shape=(n, n)
    ).tocsr()
    recon = rest.to_scipy().astype(np.float64)
    for k, off in enumerate(dia.offsets):
        idx = np.arange(max(0, -off), min(n, n - off))
        recon += sp.coo_matrix(
            (dia.data[k, idx], (idx, idx + off)), shape=(n, n)
        )
    assert np.abs((recon - A).toarray()).max() < 1e-14


def test_partition_accumulates_duplicates():
    rows = np.array([0, 0, 1], dtype=np.int32)
    cols = np.array([0, 0, 1], dtype=np.int32)
    vals = np.array([1.0, 2.0, 5.0])
    from sparsela.formats.coo import CooMatrix

    csr = CsrMatrix.from_coo(CooMatrix(2, 2, rows, cols, vals))
    dia, rest = partition_dia(csr, np.array([0]))
    assert rest.nnz == 0
    assert dia.data[0, 0] == 3.0 and dia.data[0, 1] == 5.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pure_dia_spmv_spmm_parity(dtype):
    csr = generators.make_laplacian_grid3d(12, dtype=dtype).to_csr()
    S = csr.to_scipy()
    offs = select_diagonals(csr)
    dia, rest = partition_dia(csr, offs)
    assert rest.nnz == 0  # the stencil is entirely diagonal
    D = to_device_dia(dia, dtype=dtype)
    x = _rng().standard_normal(csr.num_cols).astype(dtype)
    tol = 1e-5 if dtype == np.float32 else 1e-13
    y = np.asarray(spmv_dia(D, x))
    ref = S @ x
    assert np.abs(y - ref).max() / np.abs(ref).max() < tol
    X = _rng().standard_normal((csr.num_cols, 8)).astype(dtype)
    Y = np.asarray(spmm_dia(D, X))
    refM = S @ X
    assert np.abs(Y - refM).max() / np.abs(refM).max() < tol


def test_dia_alpha_beta():
    csr = generators.make_laplacian_grid2d(16, dtype=np.float64).to_csr()
    S = csr.to_scipy()
    offs = select_diagonals(csr)
    dia, _ = partition_dia(csr, offs)
    D = to_device_dia(dia, dtype=np.float64)
    x = _rng().standard_normal(csr.num_cols)
    y0 = _rng().standard_normal(csr.num_rows)
    got = np.asarray(spmv_dia(D, x, alpha=2.5, beta=-0.5, y=y0))
    want = 2.5 * (S @ x) - 0.5 * y0
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def test_rectangular_dia():
    n, m = 130, 170
    A = sp.diags([np.ones(n), np.ones(n)], [0, 30], shape=(n, m),
                 format="csr")
    csr = CsrMatrix.from_scipy(A.tocsr())
    plan = plan_matrix(csr, strategy="dia", dtype=np.float64)
    x = _rng().standard_normal(m)
    y = np.asarray(spmv(plan, x))
    ref = A @ x
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-13


def test_negative_offset_only():
    n = 90
    A = sp.diags([np.ones(n - 11)], [-11], shape=(n, n), format="csr")
    csr = CsrMatrix.from_scipy(A.tocsr())
    plan = plan_matrix(csr, strategy="dia", dtype=np.float32)
    x = _rng().standard_normal(n).astype(np.float32)
    y = np.asarray(spmv(plan, x))
    ref = A @ x
    assert np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-9) < 1e-5


class TestAutoGating:
    def test_stencil_goes_pure_dia(self):
        csr = generators.make_laplacian_grid3d(
            12, dtype=np.float32
        ).to_csr()
        plan = plan_matrix(csr, dtype=np.float32)
        assert isinstance(plan, HybridPlan) and plan.rest is None

    def test_fp64_stencil_goes_dia(self):
        csr = generators.make_laplacian_grid3d(
            12, dtype=np.float64
        ).to_csr()
        plan = plan_matrix(csr, dtype=np.float64)
        assert isinstance(plan, HybridPlan)
        assert plan.dia.dtype == np.float64

    def test_random_stays_merge(self):
        R = sp.random(2000, 2000, density=0.002, random_state=1,
                      format="csr")
        csr = CsrMatrix.from_scipy(R.tocsr().astype(np.float32))
        plan = plan_matrix(csr, dtype=np.float32)
        assert not isinstance(plan, HybridPlan)

    @pytest.mark.slow
    def test_band_plus_noise_goes_hybrid(self):
        n = 3000
        T = sp.diags(
            [np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
            [-1, 0, 1], format="csr",
        )
        N = sp.random(n, n, density=0.001, random_state=2, format="csr")
        csr = CsrMatrix.from_scipy((T + N).tocsr().astype(np.float32))
        plan = plan_matrix(csr, dtype=np.float32)
        assert isinstance(plan, HybridPlan) and plan.rest is not None
        S = csr.to_scipy()
        x = _rng().standard_normal(n).astype(np.float32)
        y = np.asarray(spmv(plan, x))
        ref = S @ x
        assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5
        X = _rng().standard_normal((n, 4)).astype(np.float32)
        Y = np.asarray(spmm(plan, X))
        refM = S @ X
        assert np.abs(Y - refM).max() / np.abs(refM).max() < 1e-5

    def test_explicit_dia_on_undiagonal_falls_back(self):
        R = sp.random(800, 800, density=0.003, random_state=4,
                      format="csr")
        csr = CsrMatrix.from_scipy(R.tocsr().astype(np.float32))
        plan = plan_matrix(csr, strategy="dia", dtype=np.float32)
        # no usable diagonals -> graceful fallback, still correct
        x = _rng().standard_normal(800).astype(np.float32)
        y = np.asarray(spmv(plan, x))
        ref = R @ x
        assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_multirhs_ultra_sparse_scatter_routes_to_csr():
    """Ultra-sparse uniform scatter (no diagonal structure) at L=32:
    AUTO takes the general CSR route, and the SpMM is correct."""
    import jax.experimental.sparse as jsparse

    n, m = 4096, 600
    rng = np.random.default_rng(11)
    Nz = sp.coo_matrix(
        (rng.random(m), (rng.integers(0, n, m), rng.integers(0, n, m))),
        shape=(n, n),
    ).tocsr()
    S = (0.1 * (Nz + Nz.T)).tocsr().astype(np.float32)
    S.eliminate_zeros()
    csr = CsrMatrix.from_scipy(S)
    plan = plan_matrix(csr, dtype=np.float32, L=32)
    assert isinstance(plan, jsparse.CSR), type(plan)
    X = _rng().standard_normal((n, 32)).astype(np.float32)
    Y = np.asarray(spmm(plan, X))
    refM = (S @ X).astype(np.float32)
    assert np.abs(Y - refM).max() / np.abs(refM).max() < 1e-5


def test_cg_on_hybrid_plan():
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_laplacian_grid3d(8, dtype=np.float64).to_csr()
    plan = plan_matrix(csr, dtype=np.float64)
    assert isinstance(plan, HybridPlan)
    import jax.numpy as jnp

    b = jnp.asarray(_rng().standard_normal(csr.num_rows))
    res = cg_solve(plan, b, max_iters=2000, tolerance=1e-10)
    x = np.asarray(res.x)
    r = np.asarray(b) - csr.to_scipy() @ x
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-9


def _band(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n) for _ in offsets]
    A = sp.diags(diags, offsets, shape=(n, n), format="csr")
    return CsrMatrix.from_scipy(A.tocsr().astype(np.float32)), A


def _const_band(n, offsets, consts, seed=0, zero_frac=0.3):
    """Constant-coefficient band with IRREGULAR (random, not periodic)
    structural-zero patterns per plane — the general two-valued-plane
    case masked compression must cover."""
    rng = np.random.default_rng(seed)
    diags = []
    for o, c in zip(offsets, consts):
        d = np.full(n - abs(int(o)), float(c))
        d[rng.random(d.size) < zero_frac] = 0.0
        diags.append(d)
    A = sp.diags(diags, offsets, shape=(n, n), format="csr")
    return CsrMatrix.from_scipy(A.tocsr().astype(np.float32)), A


class TestMaskedDia:
    """The masked DIA form: one int32 bit word per row plus K
    coefficients, read as ``((mask >> k) & 1) ? coef[k] : 0``."""

    def test_plane_constants_detection(self):
        from sparsela.formats.dia import plane_constants

        n = 600
        offsets = [-7, 0, 7]
        csr, _ = _const_band(n, offsets, [1.5, 4.0, 1.5], seed=3)
        dia, _ = partition_dia(csr, np.array(offsets))
        vals, ok = plane_constants(dia.data)
        assert ok.all()
        np.testing.assert_allclose(vals, [1.5, 4.0, 1.5])
        dia.data[1, 10] = 9.0  # plane 1 no longer two-valued
        vals, ok = plane_constants(dia.data)
        assert ok[0] and not ok[1] and ok[2]

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_masked_bit_identical_and_parity(self, dtype):
        """The flat mask reproduces the value planes bit for bit: the
        per-element coefficient IS the stored plane value and the FMA
        sequence is the same."""
        from sparsela.ops.dia import spmm_dia_t

        n = 1300
        offsets = [-512, -129, -1, 0, 1, 129, 512]
        consts = [2.5, -1.25, 0.75, 6.0, 0.75, -1.25, 2.5]
        csr, A = _const_band(n, offsets, consts, seed=29)
        dia, rest = partition_dia(csr, np.array(offsets))
        assert rest.nnz == 0
        Dm = to_device_dia(dia, dtype=dtype)
        Du = to_device_dia(dia, dtype=dtype, masked=False)
        assert Dm.masked and Dm.mask.shape == (n,) and Dm.data is None
        assert not Du.masked
        XT = _rng().standard_normal((4, n)).astype(dtype)
        Ym = np.asarray(spmm_dia_t(Dm, jnp.asarray(XT)))
        Yu = np.asarray(spmm_dia_t(Du, jnp.asarray(XT)))
        np.testing.assert_array_equal(Ym, Yu)
        ref = A @ XT.T.astype(np.float64)
        tol = 1e-5 if dtype == np.float32 else 1e-13
        assert np.abs(Ym.T - ref).max() / np.abs(ref).max() < tol

    def test_masked_autodetect_fallback_and_force(self):
        n = 700
        offsets = [-3, 0, 3]
        csr, _ = _const_band(n, offsets, [1.0, 4.0, 1.0], seed=5)
        dia, _ = partition_dia(csr, np.array(offsets))
        assert to_device_dia(dia).masked
        dia.data[0, 11] = 2.0  # break plane 0's constancy
        D = to_device_dia(dia)
        assert not D.masked and D.data is not None
        with pytest.raises(ValueError):
            to_device_dia(dia, masked=True)

    def test_masked_plan_solver_parity_and_roundtrip(self):
        """cg_solve_multi on a masked plan: iteration parity with the
        value-plane plan, and save/load roundtrip preserves the masked
        payload (io/plans)."""
        from sparsela.io.plans import load_plan, save_plan
        from sparsela.solvers.cg import cg_solve_multi

        n = 1500
        offsets = np.array([-40, -1, 0, 1, 40])
        diags = [np.full(n - 40, -1.0), np.full(n - 1, -1.0),
                 np.full(n, 4.2), np.full(n - 1, -1.0),
                 np.full(n - 40, -1.0)]
        A = sp.diags(diags, offsets, shape=(n, n), format="csr")
        csr = CsrMatrix.from_scipy(A.astype(np.float32))
        dia, _ = partition_dia(csr, offsets)
        Dm = to_device_dia(dia, dtype=np.float32)
        Du = to_device_dia(dia, dtype=np.float32, masked=False)
        assert Dm.masked
        B = _rng().standard_normal((n, 3)).astype(np.float32)
        rm = cg_solve_multi(Dm, B, tolerance=1e-6)
        ru = cg_solve_multi(Du, B, tolerance=1e-6)
        assert int(rm.iterations) == int(ru.iterations)
        X = np.asarray(rm.x, np.float64)
        rel = np.linalg.norm(B - A @ X) / np.linalg.norm(B)
        assert rel < 1e-5
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/m.plan"
            save_plan(path, Dm)
            D2 = load_plan(path)
            assert D2.masked and D2.offsets == Dm.offsets
            np.testing.assert_array_equal(np.asarray(D2.mask),
                                          np.asarray(Dm.mask))
            np.testing.assert_array_equal(np.asarray(D2.coef),
                                          np.asarray(Dm.coef))

    def test_cg_baked_matvec_parity(self):
        """cg_solve closes DIA plans over the jitted solve (bake); the
        iteration trajectory must match the operand-dispatch solve."""
        from sparsela.solvers.cg import _plan_bakeable, cg_solve

        n = 1500
        offsets = np.array([-40, -1, 0, 1, 40])
        diags = [np.full(n - 40, -1.0), np.full(n - 1, -1.0),
                 np.full(n, 4.2), np.full(n - 1, -1.0),
                 np.full(n - 40, -1.0)]
        A = sp.diags(diags, offsets, shape=(n, n), format="csr")
        csr = CsrMatrix.from_scipy(A.astype(np.float32))
        plan = plan_matrix(csr, dtype=np.float32)
        assert isinstance(plan, HybridPlan) and plan.rest is None
        assert _plan_bakeable(plan)
        b = _rng().standard_normal(n).astype(np.float32)
        rb = cg_solve(plan, b, tolerance=1e-6)
        ru = cg_solve(plan, b, tolerance=1e-6, bake=False)
        assert abs(int(rb.iterations) - int(ru.iterations)) <= 1
        x = np.asarray(rb.x, np.float64)
        rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        assert rel < 1e-5

    @pytest.mark.parametrize("masked", [True, False])
    def test_spmm_t_parity(self, masked):
        from sparsela.ops.dia import spmm_dia_t

        n = 1024
        offsets = [-200, -1, 0, 1, 200]
        csr, A = (_const_band(n, offsets, [1.0, -2.0, 5.0, -2.0, 1.0])
                  if masked else _band(n, offsets, seed=5))
        dia, _ = partition_dia(csr, np.array(offsets))
        D = to_device_dia(dia, dtype=np.float32)
        assert D.masked == masked
        XT = _rng().standard_normal((4, n)).astype(np.float32)
        YT = np.asarray(spmm_dia_t(D, jnp.asarray(XT)))
        refM = (A @ XT.T).astype(np.float32)
        assert np.abs(YT.T - refM).max() / np.abs(refM).max() < 1e-5

    def test_too_many_planes_stay_unmasked(self):
        from sparsela.formats.dia import MASK_MAX_PLANES, mask_words

        n = 400
        offsets = list(range(MASK_MAX_PLANES + 1))
        csr, _ = _const_band(n, offsets, [1.0] * len(offsets),
                             zero_frac=0.0)
        dia, _ = partition_dia(csr, np.array(offsets))
        assert not to_device_dia(dia).masked
        with pytest.raises(ValueError):
            mask_words(dia)


def test_masked_32_planes_no_overflow():
    """K = MASK_MAX_PLANES = 32 exercises bit 31 (the int32 sign bit):
    the apply must read the word with (m >> k) & 1 — the literal
    ``1 << 31`` overflows int32."""
    from sparsela.formats.dia import MASK_MAX_PLANES

    n = 2048
    offsets = list(range(32))          # 32 constant diagonals
    assert len(offsets) == MASK_MAX_PLANES
    diags = [np.full(n - o, float(k + 1))
             for k, o in enumerate(offsets)]
    A = sp.diags(diags, offsets, shape=(n, n), format="csr")
    csr = CsrMatrix.from_scipy(A.astype(np.float32))
    dia, rest = partition_dia(csr, select_diagonals(csr, max_diags=32))
    assert rest.nnz == 0 and len(dia.offsets) == 32
    D = to_device_dia(dia, dtype=np.float32, masked=True)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_dia(D, jnp.asarray(x)))
    ref = A @ x
    assert np.abs(y - ref).max() / (np.abs(ref).max() + 1) < 1e-5
