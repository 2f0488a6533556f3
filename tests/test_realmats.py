"""Real SuiteSparse-collection matrices (io.realmats) through the full
parse -> plan -> solve pipeline.

The reference's evaluation corpus is the UFL/SuiteSparse collection
(``get_uf_datasets.sh:10-24``, ``eval_csrmv.sh:14-17``); with no
network egress the exactly-reproducible subset is reconstructed
offline and pushed through the same pipeline the downloaded corpus
would ride.  Counts are asserted against published collection stats
inside ``build_real`` itself.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from sparsela.io.market import read_market
from sparsela.io.realmats import (
    REAL_MATRICES,
    build_real,
    ensure_mtx,
    list_real,
)
from sparsela.ops.spmv import plan_matrix, spmv

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "real")

# the committed .mtx subset (small files checked into data/real);
# bibd_9_3 is the RECTANGULAR entry — exercises the general-form
# (non-symmetric) writer/reader path (round 5)
COMMITTED = ["karate", "lesmis", "gr_30_30", "Trefethen_20",
             "Trefethen_200", "mycielskian7", "bibd_9_3"]


def test_all_entries_build_with_published_counts():
    # build_real asserts (shape, nnz) against the published stats;
    # corpus size floor: at least 35 entries
    assert len(list_real()) >= 35
    for name in list_real():
        if name in ("mycielskian14", "mycielskian15"):
            continue  # multi-M-edge builds: covered by the slow battery
        coo = build_real(name)
        shape = REAL_MATRICES[name][2][0]
        nr = shape[0] if isinstance(shape, tuple) else shape
        assert coo.num_rows == nr


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_mtx_roundtrip(name):
    """The checked-in .mtx files parse back to the exact
    reconstruction (symmetric-expansion path of io.market)."""
    path = ensure_mtx(name, DATA_DIR)
    coo = read_market(path)
    ref = build_real(name)
    import scipy.sparse as sp

    S = sp.coo_matrix((coo.vals, (coo.rows, coo.cols)),
                      shape=(coo.num_rows, coo.num_cols))
    R = sp.coo_matrix((ref.vals, (ref.rows, ref.cols)),
                      shape=(ref.num_rows, ref.num_cols))
    assert coo.num_rows == ref.num_rows
    assert coo.nnz == ref.nnz
    assert abs(S - R).max() == 0.0


@pytest.mark.parametrize("name", ["Trefethen_200", "gr_30_30",
                                  "mycielskian9", "lesmis"])
def test_auto_plan_golden(name):
    """AUTO-planned SpMV matches scipy on real matrices."""
    csr = build_real(name).to_csr()
    A = plan_matrix(csr, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(
        csr.num_cols).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x)))
    ref = csr.to_scipy() @ x
    assert np.abs(y - ref).max() / (np.abs(ref).max() + 1) < 2e-5


@pytest.mark.parametrize("name", ["Trefethen_200", "gr_30_30"])
def test_cg_iteration_parity_vs_scipy(name):
    """SPD entries solve with CG; iteration count matches a numpy
    oracle with the same recurrence to ±1."""
    from sparsela.solvers.cg import cg_solve

    csr = build_real(name).to_csr()
    S = csr.to_scipy()
    b = np.random.default_rng(1).standard_normal(csr.num_rows)
    tol = 1e-8

    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    bn = np.sqrt(b @ b)
    want = 0
    for it in range(1, 2001):
        ap = S @ p
        alpha = rs / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        if np.sqrt(rs_new) / bn < tol:
            want = it
            break
        p = r + (rs_new / rs) * p
        rs = rs_new

    A = plan_matrix(csr, dtype=np.float64)
    res = cg_solve(A, jnp.asarray(b), tolerance=tol, max_iters=2000)
    assert bool(res.converged.all())
    assert abs(int(res.iterations) - want) <= 1, (
        int(res.iterations), want)


# ---------------------------------------------------------------------------
# The real-matrix battery as a CI gate: EVERY entry through parse ->
# AUTO plan -> golden SpMV, and CG iteration parity on every SPD entry,
# split by published nnz so the fast tier stays fast (big builds ride
# the slow tier).
# ---------------------------------------------------------------------------

def _published_nnz(name):
    return REAL_MATRICES[name][2][1]


_FAST = [n for n in list_real() if _published_nnz(n) <= 400_000]
_SLOW = [n for n in list_real() if _published_nnz(n) > 400_000]
_SPD_FAST = [n for n in list_real()
             if (n.startswith("Trefethen") or n == "gr_30_30")
             and REAL_MATRICES[n][2][0] <= 1000]
_SPD_SLOW = [n for n in list_real()
             if (n.startswith("Trefethen") or n == "gr_30_30")
             and n not in _SPD_FAST]


def _battery_golden(name):
    csr = build_real(name).to_csr()
    A = plan_matrix(csr, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(
        csr.num_cols).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x)))
    ref = csr.to_scipy() @ x
    assert np.abs(y - ref).max() / (np.abs(ref).max() + 1) < 2e-5


def _battery_cg_parity(name):
    from sparsela.solvers.cg import cg_solve

    csr = build_real(name).to_csr()
    S = csr.to_scipy()
    b = np.random.default_rng(1).standard_normal(csr.num_rows)
    tol = 1e-8
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    bn = np.sqrt(b @ b)
    want = -1
    for it in range(1, 4001):
        ap = S @ p
        alpha = rs / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        if np.sqrt(rs_new) / bn < tol:
            want = it
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    A = plan_matrix(csr, dtype=np.float64)
    res = cg_solve(A, jnp.asarray(b), tolerance=tol, max_iters=4000)
    assert bool(res.converged.all())
    assert abs(int(res.iterations) - want) <= 1, (
        name, int(res.iterations), want)


@pytest.mark.parametrize("name", _FAST)
def test_battery_golden_fast(name):
    _battery_golden(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", _SLOW)
def test_battery_golden_slow(name):
    _battery_golden(name)


@pytest.mark.parametrize("name", _SPD_FAST)
def test_battery_cg_parity_fast(name):
    _battery_cg_parity(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", _SPD_SLOW)
def test_battery_cg_parity_slow(name):
    _battery_cg_parity(name)


def test_trefethen_spd():
    """Trefethen matrices are diagonally dominant SPD by construction."""
    csr = build_real("Trefethen_150").to_csr()
    d = csr.to_scipy().toarray()
    assert np.all(np.linalg.eigvalsh(d) > 0)


def test_cli_real_flag(capsys):
    """`--real NAME` feeds any subcommand from the offline
    reconstruction registry (reference: the UFL corpus feeds every
    driver via --mtx, eval_csrmv.sh:14-17)."""
    from sparsela.bench.run import main as cli_main

    cli_main(["stats", "--real", "karate", "--quiet"])
    out = capsys.readouterr().out.strip()
    parts = out.split(",")
    assert parts[0] == "karate"
    assert int(parts[3]) == 156
