"""chip_smoke.py: its phases at tiny sizes on the CPU backend (the same
code paths and host oracles the card run uses), its refusal to run
without a GPU, and — marked ``chip`` — the phases at their real sizes
on the card."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = [
    (chip_smoke.phase_spmv, dict(width=12, rmat_scale=8, L=4)),
    (chip_smoke.phase_cg, dict(width=16)),
    (chip_smoke.phase_cg_multi, dict(width=12, L=4)),
    (chip_smoke.phase_precond, dict(width=8, L=4)),
    (chip_smoke.phase_fp64, dict(points=1500)),
    (chip_smoke.phase_bf16, dict(width=12)),
    (chip_smoke.phase_four, dict(width=16)),
]


@pytest.mark.parametrize("phase,sizes", SMALL,
                         ids=[p.__name__ for p, _ in SMALL])
def test_phase_small(phase, sizes):
    phase(**sizes)


def test_host_pcg_matches_scipy_cg():
    """The oracle's stopping rule and count: a 1-D Laplacian solved to
    1e-8 agrees with a dense solve."""
    import numpy as np
    import scipy.sparse as sp

    n = 50
    S = sp.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    b = np.arange(n, dtype=np.float64)
    x, it = chip_smoke.host_pcg(S, b, 1e-8, 1000)
    assert 0 < it <= n
    np.testing.assert_allclose(x, np.linalg.solve(S.toarray(), b),
                               rtol=1e-6, atol=1e-8)


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_gpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo
    cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.chip
@pytest.mark.parametrize("phase", [
    chip_smoke.phase_spmv, chip_smoke.phase_cg, chip_smoke.phase_cg_multi,
    chip_smoke.phase_precond, chip_smoke.phase_fp64, chip_smoke.phase_bf16,
], ids=lambda p: p.__name__)
def test_phase_on_card(gpu, phase):
    phase()
