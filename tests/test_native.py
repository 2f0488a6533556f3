"""Native C++ library tests (skipped when the library isn't built)."""

import numpy as np
import pytest

from sparsela.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libsparsela.so not built"
)


def test_native_mtx_matches_python(tmp_path):
    from sparsela.io.market import _read_market_stream
    import io

    text = (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "% comment\n"
        "4 4 5\n"
        "1 1 2.0\n"
        "2 1 -1.0\n"
        "3 2 -1.5\n"
        "4 4 3.0\n"
        "4 1 0.25\n"
    )
    p = tmp_path / "m.mtx"
    p.write_text(text)
    m_native = native.read_market(p)
    m_py = _read_market_stream(io.StringIO(text), 1.0, np.float64)
    np.testing.assert_allclose(m_native.to_dense(), m_py.to_dense())


def test_native_mtx_pattern_and_skew(tmp_path):
    p = tmp_path / "p.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 3 2\n1 2\n2 3\n"
    )
    m = native.read_market(p, default_value=7.0)
    np.testing.assert_allclose(
        m.to_dense(), [[0, 7, 0], [0, 0, 7]]
    )
    p2 = tmp_path / "s.mtx"
    p2.write_text(
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n2 1 5.0\n3 2 -2.0\n"
    )
    m2 = native.read_market(p2)
    d = m2.to_dense()
    np.testing.assert_allclose(d, -d.T)


@pytest.mark.slow
def test_native_mtx_large_roundtrip(tmp_path):
    # big enough to hit the multi-threaded chunked path
    from sparsela.io import generators
    from sparsela.io.market import write_market, read_market

    rng = np.random.default_rng(0)
    coo = generators.make_grid2d(100)  # 39k nnz
    coo.vals[:] = rng.standard_normal(coo.nnz)
    p = tmp_path / "big.mtx"
    write_market(p, coo)
    m = native.read_market(p)
    np.testing.assert_allclose(m.to_dense(), coo.to_dense())


def test_native_ic0_matches_python(rng):
    from sparsela.io import generators
    from sparsela.precond import ic0

    csr = generators.make_laplacian_grid2d(10).to_csr()
    L_native = native.ic0_factorize(csr)
    # force the python path
    L_py_vals = None
    L = ic0._lower_triangle(csr)
    ro = np.asarray(L.row_offsets).astype(np.int64)
    ci = np.asarray(L.col_indices).astype(np.int64)
    vals = np.asarray(L.values, dtype=np.float64).copy()
    assert ic0._try_factorize(ro, ci, vals)
    np.testing.assert_allclose(
        np.asarray(L_native.values), vals, rtol=1e-14
    )


def test_native_coo_sort_order(rng):
    """The native counting sort is the stable (row, col) lexsort."""
    rows = rng.integers(0, 500, 20000).astype(np.int32)
    cols = rng.integers(0, 800, 20000).astype(np.int32)
    order = native.coo_sort_order(500, rows, cols)
    np.testing.assert_array_equal(order, np.lexsort((cols, rows)))
    # out-of-range rows are refused, not written past the buffer
    assert native.coo_sort_order(10, rows, cols) is None


def test_native_tri_levels_matches_fallback():
    """Native O(nnz) level walk == the numpy frontier fallback, lower
    and upper, on an IC(0) factor of a stencil."""
    from sparsela.io import generators
    from sparsela.precond import trisolve
    from sparsela.precond.ic0 import ic0_factorize

    csr = generators.make_laplacian_grid2d(14).to_csr()
    Lf = ic0_factorize(csr)
    for T, lower in ((Lf, True), (Lf.transpose(), False)):
        ro = np.asarray(T.row_offsets).astype(np.int64)
        ci = np.asarray(T.col_indices).astype(np.int64)
        lev_native, nlev = native.tri_levels(ro, ci, T.num_rows,
                                             lower=lower)
        assert lev_native is not None

        # frontier fallback (bypass the native path)
        import unittest.mock as mock

        with mock.patch.object(native, "tri_levels",
                               return_value=(None, None)):
            lev_py = trisolve._dependency_levels(ro, ci, T.num_rows,
                                                 lower)
        np.testing.assert_array_equal(lev_native, lev_py)
        assert nlev == int(lev_py.max()) + 1
