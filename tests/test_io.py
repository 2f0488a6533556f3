"""Matrix Market parser tests — parity semantics vs scipy.io.mmread."""

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from sparsela.io.market import read_market, write_market
from sparsela.io import generators


def test_general_coordinate(tmp_path):
    p = tmp_path / "g.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "% comment\n"
        "3 4 5\n"
        "1 1 1.5\n"
        "2 3 -2.0\n"
        "3 4 7\n"
        "1 2 0.25\n"
        "3 1 1e-3\n"
    )
    m = read_market(p)
    ref = sio.mmread(str(p)).toarray()
    np.testing.assert_allclose(m.to_dense(), ref)


def test_symmetric_expansion(tmp_path):
    p = tmp_path / "s.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n"
        "1 1 2.0\n"
        "2 1 -1.0\n"
        "3 2 -1.0\n"
        "3 3 2.0\n"
    )
    m = read_market(p)
    ref = sio.mmread(str(p)).toarray()
    np.testing.assert_allclose(m.to_dense(), ref)
    # diagonal entries must not be duplicated (sparse_matrix.h:361-372)
    assert m.nnz == 6


def test_skew_symmetric(tmp_path):
    p = tmp_path / "k.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n"
        "2 1 5.0\n"
        "3 2 -2.5\n"
    )
    m = read_market(p)
    ref = sio.mmread(str(p)).toarray()
    np.testing.assert_allclose(m.to_dense(), ref)


def test_pattern(tmp_path):
    p = tmp_path / "p.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 2 2\n"
        "1 2\n"
        "2 1\n"
    )
    m = read_market(p, default_value=1.0)
    np.testing.assert_allclose(
        m.to_dense(), [[0, 1], [1, 0]]
    )


def test_array_format(tmp_path):
    p = tmp_path / "a.mtx"
    p.write_text(
        "%%MatrixMarket matrix array real general\n"
        "2 3\n"
        "1\n2\n3\n4\n5\n6\n"
    )
    m = read_market(p)
    ref = sio.mmread(str(p))
    np.testing.assert_allclose(m.to_dense(), ref)


def test_array_symmetric(tmp_path):
    p = tmp_path / "as.mtx"
    p.write_text(
        "%%MatrixMarket matrix array real symmetric\n"
        "3 3\n"
        "1\n2\n3\n4\n5\n6\n"
    )
    m = read_market(p)
    ref = sio.mmread(str(p))
    np.testing.assert_allclose(m.to_dense(), ref)


def test_write_read_roundtrip(tmp_path, rng):
    coo = generators.make_grid2d(8)
    p = tmp_path / "rt.mtx"
    write_market(p, coo)
    back = read_market(p)
    np.testing.assert_allclose(back.to_dense(), coo.to_dense())


def test_gzip(tmp_path):
    import gzip

    p = tmp_path / "z.mtx.gz"
    with gzip.open(p, "wt") as f:
        f.write(
            "%%MatrixMarket matrix coordinate real general\n"
            "2 2 1\n"
            "1 1 3.0\n"
        )
    m = read_market(p)
    np.testing.assert_allclose(m.to_dense(), [[3.0, 0], [0, 0]])


def test_generators_match_reference_counts():
    # nnz counts per the reference formulas (sparse_matrix.h:458-545)
    w = 10
    g2 = generators.make_grid2d(w)
    interior, edge, corner = (w - 2) ** 2, (w - 2) * 4, 4
    assert g2.nnz == interior * 4 + edge * 3 + corner * 2
    g2l = generators.make_grid2d(w, self_loop=True)
    assert g2l.nnz == g2.nnz + w * w

    g3 = generators.make_grid3d(6)
    w = 6
    interior = (w - 2) ** 3
    face = (w - 2) ** 2 * 6
    edge = (w - 2) * 12
    corner = 8
    assert g3.nnz == interior * 6 + face * 5 + edge * 4 + corner * 3

    wh = generators.make_wheel(7)
    assert wh.shape == (8, 8)
    assert wh.nnz == 14


def test_spd_fixture_is_spd():
    csr = generators.make_random_spd(200, row_nnz=6, seed=1).to_csr()
    d = csr.to_dense()
    np.testing.assert_allclose(d, d.T)
    w = np.linalg.eigvalsh(d)
    assert w.min() > 0
