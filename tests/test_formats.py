"""Format tests: COO/CSR/BCSR roundtrips vs scipy oracles."""

import numpy as np
import pytest
import scipy.sparse as sp

from sparsela.formats.bcsr import BcsrMatrix
from sparsela.formats.coo import CooMatrix
from sparsela.formats.csr import CsrMatrix
from sparsela.io import generators


def random_coo(rng, m=50, n=40, nnz=300, dtype=np.float64):
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    return CooMatrix(m, n, rows, cols, vals)


class TestCoo:
    def test_dense_roundtrip(self, rng):
        coo = random_coo(rng)
        d = coo.to_dense()
        s = coo.to_scipy().toarray()
        np.testing.assert_allclose(d, s)

    def test_sum_duplicates(self, rng):
        coo = random_coo(rng, m=10, n=10, nnz=500)
        d_before = coo.to_dense()
        c2 = coo.sum_duplicates()
        np.testing.assert_allclose(c2.to_dense(), d_before)
        # no duplicates remain
        keys = set(zip(c2.rows.tolist(), c2.cols.tolist()))
        assert len(keys) == c2.nnz


class TestCsr:
    def test_from_coo_matches_scipy(self, rng):
        coo = random_coo(rng)
        csr = CsrMatrix.from_coo(coo, sum_dups=True)
        s = coo.to_scipy().tocsr()
        s.sum_duplicates()
        np.testing.assert_array_equal(csr.row_offsets, s.indptr)
        np.testing.assert_allclose(csr.to_dense(), s.toarray())

    def test_duplicates_kept_by_default(self):
        coo = CooMatrix(2, 2, np.array([0, 0]), np.array([1, 1]),
                        np.array([2.0, 3.0]))
        csr = CsrMatrix.from_coo(coo)
        assert csr.nnz == 2  # parity: reference keeps duplicates
        np.testing.assert_allclose(csr.to_dense()[0, 1], 5.0)

    def test_transpose(self, rng):
        coo = random_coo(rng)
        csr = CsrMatrix.from_coo(coo, sum_dups=True)
        t = csr.transpose()
        np.testing.assert_allclose(t.to_dense(), csr.to_dense().T)

    def test_row_ids(self, rng):
        csr = CsrMatrix.from_coo(random_coo(rng), sum_dups=True)
        rid = csr.row_ids()
        s = csr.to_scipy().tocoo()
        np.testing.assert_array_equal(rid, s.row)

    def test_stats(self):
        csr = generators.make_wheel(100).to_csr()
        st = csr.stats()
        assert st.nnz == 200
        assert st.row_length_max == 100  # the hub row
        assert st.row_length_skew > 5  # extreme skew by construction

    def test_degree_histogram(self):
        csr = generators.make_wheel(64).to_csr()
        bounds, counts = csr.degree_histogram()
        assert counts.sum() == csr.num_rows

    def test_empty_rows(self):
        coo = CooMatrix(5, 5, np.array([0, 4]), np.array([1, 2]),
                        np.array([1.0, 2.0]))
        csr = CsrMatrix.from_coo(coo)
        np.testing.assert_array_equal(csr.row_offsets, [0, 1, 1, 1, 1, 2])
        np.testing.assert_array_equal(csr.row_ids(), [0, 4])


class TestBcsr:
    @pytest.mark.parametrize("br,bc", [(2, 2), (3, 3), (8, 128), (4, 16)])
    def test_roundtrip(self, rng, br, bc):
        coo = random_coo(rng, m=37, n=61, nnz=400)
        csr = CsrMatrix.from_coo(coo, sum_dups=True)
        bcsr = BcsrMatrix.from_csr(csr, br, bc)
        np.testing.assert_allclose(bcsr.to_csr().to_dense(), csr.to_dense())

    def test_fill_ratio(self, rng):
        csr = generators.make_grid2d(16).to_csr()
        bcsr = BcsrMatrix.from_csr(csr, 2, 2)
        assert 0 < bcsr.fill_ratio <= 1
