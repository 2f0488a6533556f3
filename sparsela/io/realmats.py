"""Real SuiteSparse-collection matrices, reconstructed offline.

The reference's entire evaluation runs over matrices downloaded from
the UFL/SuiteSparse collection (``get_uf_datasets.sh:10-24``,
``eval_csrmv.sh:14-17``); this environment has no network egress, so
downloading is impossible.  A subset of the collection, however, is
*exactly algorithmically defined* by its published documentation, and
those entries can be reconstructed bit-for-bit offline:

* ``JGD_Trefethen/Trefethen_N`` — Problem 7 of Trefethen's "hundred
  dollar, hundred digit challenge": A[i,i] = (i+1)-th prime,
  A[i,j] = 1 where |i-j| is a power of two.  SPD.  All nine
  non-``b`` sizes in the reference's manifest (``data/ufl``) are
  reproduced, values included.
* ``HB/gr_30_30`` — "finite difference Laplacian on a 30x30 grid,
  nine point star".  The pattern is forced (nnz = 7744 matches the
  published count exactly); values use the standard 9-point star
  (diagonal 8, all eight neighbours -1), which keeps the published
  SPD property.  Values are reconstruction-standard, not
  file-verified (no network).
* ``Newman/karate`` — Zachary's karate club (the real 1977 social
  network), unweighted symmetric pattern; read from the committed
  ``data/real/karate.mtx``.
* ``Newman/lesmis`` — Les Misérables character co-appearances
  (Knuth's Stanford GraphBase data), weighted symmetric; read from the
  committed ``data/real/lesmis.mtx``.
* ``Mycielski/mycielskianK`` — the Mycielski construction starting
  from K2; adjacency matrices of the collection's Mycielski group
  (added to the collection post-UFL-manifest; reproducible exactly
  by the published recurrence n_{k+1} = 2 n_k + 1,
  m_{k+1} = 3 m_k + n_k).  Round 5 extends to K = 3, 14, 15 via a
  vectorized builder (m_15 = 6M edges).
* ``JGD_BIBD/bibd_v_k`` (round 5) — incidence matrices of the
  balanced-incomplete-block-design search problem: rows are the
  C(v,2) unordered pairs of a v-set, columns the C(v,k) blocks, a 1
  where the pair lies in the block (nnz = C(v,k) C(k,2)).  Names
  verified against the vendored UFL manifest
  (``data/ufl/ufl_matrices.txt:1920-1940``); these are the corpus's
  RECTANGULAR pattern entries (the non-square SpMV path).

Every builder asserts its published dimension/nonzero counts before
returning, so a reconstruction drift fails loudly.  ``ensure_mtx``
writes the matrix in SuiteSparse's storage convention (symmetric
lower triangle) so reloading exercises the MatrixMarket symmetric
expansion path of :mod:`sparsela.io.market`.
"""

from __future__ import annotations

import os

import numpy as np

from math import comb as _comb

from sparsela.formats.coo import CooMatrix


def _primes(k: int) -> np.ndarray:
    """First k primes (sieve; p_20000 = 224737 so 250k bounds k<=20000)."""
    limit = 250_000 if k <= 20_000 else int(k * (np.log(k) + np.log(np.log(k))) * 1.2)
    sieve = np.ones(limit, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    primes = np.flatnonzero(sieve)
    assert primes.size >= k, (primes.size, k)
    return primes[:k].astype(np.float64)


def _trefethen(n: int) -> CooMatrix:
    """JGD_Trefethen/Trefethen_n: diag = first n primes, A[i,j] = 1
    where |i-j| is a power of two. SPD (diagonally dominant)."""
    rows = [np.arange(n, dtype=np.int64)]
    cols = [np.arange(n, dtype=np.int64)]
    vals = [_primes(n)]
    d = 1
    while d < n:
        i = np.arange(n - d, dtype=np.int64)
        rows += [i, i + d]
        cols += [i + d, i]
        vals += [np.ones(n - d), np.ones(n - d)]
        d *= 2
    return CooMatrix(n, n, np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals))


def _gr_30_30() -> CooMatrix:
    """HB/gr_30_30: 9-point star Laplacian on a 30x30 grid (Dirichlet
    truncation). Pattern-exact (900 rows / 7744 nnz, the published
    counts); values standard (+8 diagonal, -1 neighbours) -> SPD."""
    w = 30
    idx = np.arange(w * w).reshape(w, w)
    rows, cols, vals = [], [], []
    rows.append(idx.reshape(-1))
    cols.append(idx.reshape(-1))
    vals.append(np.full(w * w, 8.0))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            src = idx[max(0, -di):w - max(0, di),
                      max(0, -dj):w - max(0, dj)]
            dst = idx[max(0, di):w + min(0, di),
                      max(0, dj):w + min(0, dj)]
            rows.append(src.reshape(-1))
            cols.append(dst.reshape(-1))
            vals.append(np.full(src.size, -1.0))
    return CooMatrix(w * w, w * w,
                     np.concatenate(rows).astype(np.int64),
                     np.concatenate(cols).astype(np.int64),
                     np.concatenate(vals))


# Repo-committed copies of the two graph entries (written by
# ``ensure_mtx``; reading them keeps the build free of graph packages).
_COMMITTED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data", "real")


def _committed(name: str) -> CooMatrix:
    from sparsela.io.market import read_market

    return read_market(os.path.join(_COMMITTED, f"{name}.mtx"))


def _karate() -> CooMatrix:
    return _committed("karate")


def _lesmis() -> CooMatrix:
    return _committed("lesmis")


def _mycielskian(k: int) -> CooMatrix:
    """Mycielski/mycielskianK: iterate the Mycielski construction from
    K2. Given G = (V, E) with |V| = n, M(G) has vertices
    {v_0..v_{n-1}} + shadows {u_0..u_{n-1}} + apex z; edges E +
    {u_i v_j, u_j v_i for (v_i,v_j) in E} + {u_i z}.

    Vectorized (round 5): the edge list triples per level (m_14 = 2M,
    m_15 = 6M), far past what the former per-edge set build handled.
    Normalized first < second endpoints make the three edge groups
    disjoint by construction (second endpoint < n / >= n split), so
    no dedup pass is needed — equality with the set construction is
    test-pinned for small k."""
    assert k >= 2
    e = np.array([[0, 1]], dtype=np.int64)
    n = 2
    for _ in range(k - 2):
        i, j = e[:, 0], e[:, 1]
        apex = np.full(n, 2 * n, dtype=np.int64)
        e = np.concatenate([
            e,
            np.stack([i, n + j], axis=1),
            np.stack([j, n + i], axis=1),
            np.stack([n + np.arange(n, dtype=np.int64), apex], axis=1),
        ])
        n = 2 * n + 1
    r = np.concatenate([e[:, 0], e[:, 1]])
    c = np.concatenate([e[:, 1], e[:, 0]])
    return CooMatrix(n, n, r, c, np.ones(r.size, dtype=np.float64))


def _bibd(v: int, k: int) -> CooMatrix:
    """JGD_BIBD/bibd_v_k: incidence matrix of the balanced-incomplete-
    block-design search problem — rows are the C(v,2) unordered pairs
    of a v-set, columns the C(v,k) k-subsets ("blocks"), with a 1
    where the pair is contained in the block. Exactly defined by the
    published description; nnz = C(v,k) * C(k,2). Rectangular pattern
    matrices — the corpus's non-square SpMV coverage."""
    from itertools import combinations
    from math import comb

    pair_id = np.full((v, v), -1, dtype=np.int64)
    for i, (a, b) in enumerate(combinations(range(v), 2)):
        pair_id[a, b] = i
    rows, cols = [], []
    for j, S in enumerate(combinations(range(v), k)):
        for a, b in combinations(S, 2):
            rows.append(pair_id[a, b])
            cols.append(j)
    nr, nc = comb(v, 2), comb(v, k)
    return CooMatrix(nr, nc, np.asarray(rows, dtype=np.int64),
                     np.asarray(cols, dtype=np.int64),
                     np.ones(len(rows), dtype=np.float64))


def _myc_counts(k: int):
    n, m = 2, 1
    for _ in range(k - 2):
        n, m = 2 * n + 1, 3 * m + n
    return n, 2 * m


# name -> (group, builder, published (num_rows, nnz), value provenance)
REAL_MATRICES = {
    "karate": ("Newman", _karate, (34, 156), "exact (pattern)"),
    "lesmis": ("Newman", _lesmis, (77, 508), "exact (GraphBase weights)"),
    "gr_30_30": ("HB", _gr_30_30, (900, 7744),
                 "pattern exact; standard 9-point values"),
    **{f"Trefethen_{n}": ("JGD_Trefethen", (lambda n=n: _trefethen(n)),
                          (n, n + 2 * sum(n - 2**j
                                          for j in range(20) if 2**j < n)),
                          "exact (published definition)")
       for n in (20, 150, 200, 300, 500, 700, 2000, 20000)},
    **{f"mycielskian{k}": ("Mycielski", (lambda k=k: _mycielskian(k)),
                           (_myc_counts(k)[0], _myc_counts(k)[1]),
                           "exact (published construction)")
       for k in (3, *range(4, 14), 14, 15)},
    # JGD_BIBD incidence matrices (round 5): exactly defined
    # (pairs x k-subsets), names verified against the vendored UFL
    # manifest (data/ufl/ufl_matrices.txt:1920-1940); the tractable
    # sizes of the group (bibd_22_8 at 8.9M nnz excluded)
    **{f"bibd_{v}_{k}": ("JGD_BIBD", (lambda v=v, k=k: _bibd(v, k)),
                         ((_comb(v, 2), _comb(v, k)),
                          _comb(v, k) * _comb(k, 2)),
                         "exact (pattern, incidence definition)")
       for v, k in ((9, 3), (9, 5), (11, 5), (12, 4), (12, 5),
                    (13, 6), (14, 7), (15, 3), (16, 8), (17, 3),
                    (17, 4), (49, 3), (81, 2), (81, 3))},
}


def list_real():
    return sorted(REAL_MATRICES)


def build_real(name: str) -> CooMatrix:
    """Reconstruct a collection matrix; asserts the published
    dimension / nonzero counts."""
    if name not in REAL_MATRICES:
        raise ValueError(
            f"unknown real matrix {name!r}; available: {list_real()}")
    group, builder, (shape_pub, nnz_pub), _ = REAL_MATRICES[name]
    coo = builder()
    nr_pub, nc_pub = (shape_pub if isinstance(shape_pub, tuple)
                      else (shape_pub, shape_pub))
    assert coo.num_rows == nr_pub and coo.num_cols == nc_pub, (
        name, coo.num_rows, coo.num_cols, shape_pub)
    assert coo.nnz == nnz_pub, (name, coo.nnz, nnz_pub)
    return coo


def ensure_mtx(name: str, directory: str = "data/real") -> str:
    """Write ``<directory>/<name>.mtx`` in the SuiteSparse storage
    convention (symmetric square entries: lower triangle only;
    rectangular entries: general coordinate) if absent; returns the
    path."""
    path = os.path.join(directory, f"{name}.mtx")
    if os.path.exists(path):
        return path
    os.makedirs(directory, exist_ok=True)
    group, _, _, provenance = REAL_MATRICES[name]
    coo = build_real(name)
    symmetric = coo.num_rows == coo.num_cols
    if symmetric:
        keep = coo.rows >= coo.cols
        r, c, v = coo.rows[keep], coo.cols[keep], coo.vals[keep]
    else:
        r, c, v = coo.rows, coo.cols, coo.vals
    order = np.lexsort((r, c))  # column-major, as SuiteSparse stores
    r, c, v = r[order], c[order], v[order]
    pattern = bool(np.all(v == 1.0))
    field = "pattern" if pattern else "real"
    kind = "symmetric" if symmetric else "general"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {kind}\n")
        f.write(f"% {group}/{name} — SuiteSparse collection entry,\n")
        f.write("% reconstructed offline from its published "
                "definition (no network\n")
        f.write(f"% egress); values: {provenance}.\n")
        f.write("% See sparsela/io/realmats.py; counts asserted "
                "against published stats.\n")
        f.write(f"{coo.num_rows} {coo.num_cols} {r.size}\n")
        for i in range(r.size):
            if pattern:
                f.write(f"{int(r[i]) + 1} {int(c[i]) + 1}\n")
            else:
                f.write(f"{int(r[i]) + 1} {int(c[i]) + 1} "
                        f"{float(v[i]):.17g}\n")
    return path
