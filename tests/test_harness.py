"""Benchmark harness / CLI tests (small matrices, reference strategy)."""

import json
import os

import numpy as np
import pytest

from sparsela.bench import models
from sparsela.bench.run import main as cli_main


def test_flop_byte_models():
    assert models.spmv_flops(100, 4) == 800
    # fp64 byte model parity (cpu_spmv.cpp:721-727)
    assert models.spmv_bytes(10, 5, L=1, value_bytes=8) == 10 * 20 + 5 * 12
    assert models.cg_flops(100, 10, 2, 3) == (200 + 100) * 2 * 3


def test_cli_stats(capsys):
    cli_main(["stats", "--wheel", "64", "--quiet"])
    out = capsys.readouterr().out.strip()
    parts = out.split(",")
    assert parts[0] == "wheel_64"
    assert int(parts[3]) == 128  # nnz


def test_cli_spmv_reference(capsys):
    cli_main(["spmv", "--lap2d", "8", "--fp64",
              "--strategy", "reference", "--quiet"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "PASS" in out


@pytest.mark.slow
def test_cli_spmv_fp64_default_rows(capsys):
    """Default fp64 mode benches AUTO and the general CSR routes —
    parity with the reference benching its kernels in fp64
    (cpu_spmv.cpp:979-986) — all in IEEE f64."""
    cli_main(["spmv", "--lap2d", "16", "--quiet"])
    rows = [ln for ln in capsys.readouterr().out.strip().splitlines()
            if "," in ln]
    kinds = {r.split(",")[1] for r in rows}
    assert {"cusparse", "reference", "bcoo"} <= kinds
    assert all(r.split(",")[7] == "PASS" for r in rows)
    assert all(r.split(",")[8] == "ieee-f64" for r in rows)


def test_cli_fp64_subprocess_no_conftest():
    """The CLI's default fp64 mode must pass its golden check OUTSIDE
    pytest: conftest enables x64 globally and masked the round-1 bug
    where bench.run never enabled it (default mode silently downcast to
    f32 and FAILed). Run in a clean subprocess on the CPU backend."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');"
         "from sparsela.bench.run import main;"
         "main(['spmv', '--lap2d', '8', '--strategy',"
         " 'reference,bcoo', '--quiet'])"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [ln for ln in r.stdout.strip().splitlines() if "," in ln]
    assert len(rows) == 2
    for row in rows:
        # columns: name,kind,rows,nnz,ms,gf,bw,status,semantics
        assert row.split(",")[7] == "PASS", row
        # real fp64 (not a silent f32 downcast): the semantics column
        # must say so
        assert row.split(",")[8] == "ieee-f64", row
    assert {r.split(",")[1] for r in rows} == {"reference", "bcoo"}


def test_cli_spmv_bcoo_vendor_row(capsys):
    """`--strategy mkl` is the vendor baseline (cuSPARSE CSR), not an
    alias of reference (cpu_spmv.cpp:631-664 parity); `bcoo` is its own
    row."""
    cli_main(["spmv", "--lap2d", "8", "--fp64",
              "--strategy", "mkl,bcoo", "--quiet"])
    rows = capsys.readouterr().out.strip().splitlines()[-2:]
    assert [r.split(",")[1] for r in rows] == ["cusparse", "bcoo"]
    assert all("PASS" in r for r in rows)


def test_cli_spmm(capsys):
    cli_main(["spmm", "--lap2d", "8", "--fp64", "--num_vectors", "4",
              "--strategy", "reference", "--quiet"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "PASS" in out


def test_cli_multicg(tmp_path, capsys):
    out = str(tmp_path / "err")
    cli_main(["multicg", "--lap2d", "8", "--fp64", "--num_vectors", "2",
              "--strategy", "reference", "--tolerance", "1e-6",
              "--output", out, "--quiet"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(printed)
    assert res["cg"]["converged"]
    assert res["pcg_ic0"]["converged"]
    assert res["spai_cg"]["converged"]
    assert res["pcg_ic0"]["iters"] <= res["cg"]["iters"]
    assert os.path.exists(os.path.join(out, "lap2d_8_cg_errors.csv"))


def test_cli_stats_dir_sweep(tmp_path, capsys):
    """Directory-sweep stats CSV (matrix_stats.cpp:18-70 parity)."""
    from sparsela.io import generators
    from sparsela.io.market import write_market

    write_market(tmp_path / "a.mtx", generators.make_laplacian_grid2d(8))
    write_market(tmp_path / "b.mtx", generators.make_wheel(50))
    out = tmp_path / "stats.csv"
    cli_main(["stats", "--dir", str(tmp_path), "--output", str(out)])
    capsys.readouterr()
    lines = out.read_text().strip().splitlines()
    assert lines[0].startswith("matrix,rows,cols,nnz")
    assert len(lines) == 3
    assert lines[1].startswith("a.mtx,64,64")


def test_cli_precond_summary(tmp_path, capsys):
    """NONE/IC0/SPAI summary harness
    (preconditioner_benchmark.cpp:398-484 parity)."""
    from sparsela.io import generators
    from sparsela.io.market import write_market

    mdir = tmp_path / "m"
    mdir.mkdir()
    write_market(mdir / "lap.mtx", generators.make_laplacian_grid2d(8))
    out = tmp_path / "out"
    cli_main(["precond", "--dir", str(mdir), "--num_vectors", "2",
              "--tolerance", "1e-6", "--strategy", "reference",
              "--output", str(out), "--quiet"])
    capsys.readouterr()
    csv = (out / "precond_summary.csv").read_text().strip().splitlines()
    assert csv[0] == ("matrix,solver,iters,prep_ms,solve_ms,total_ms,"
                      "speedup_vs_cg")
    solvers = {ln.split(",")[1] for ln in csv[1:]}
    assert solvers == {"cg", "pcg_ic0", "spai_cg"}
    # CG's speedup vs itself is 1.0 by construction
    cg_row = [ln for ln in csv[1:] if ln.split(",")[1] == "cg"][0]
    assert cg_row.split(",")[-1] == "1.000"


def test_plots(tmp_path):
    from sparsela.analysis import plots

    # error plot
    csv1 = tmp_path / "a_errors.csv"
    csv1.write_text(
        "iteration,max_relative_error\n0,1.0\n1,0.1\n2,0.01\n"
    )
    png = tmp_path / "err.png"
    plots.plot_errors({"cg": str(csv1)}, str(png))
    assert png.exists()

    # efficiency plot
    png2 = tmp_path / "eff.png"
    plots.plot_efficiency([1, 2, 4, 8], [8.0, 4.2, 2.3, 1.4], str(png2))
    assert png2.exists()

    # pivot + precond summary
    rows = [("m1", "cusparse", 32, 100, 1.0, 5.0, "PASS"),
            ("m1", "reference", 32, 100, 9.0, 0.5, "PASS")]
    out_csv = tmp_path / "pivot.csv"
    plots.plot_gflops_pivot(rows, str(out_csv))
    assert "cusparse" in out_csv.read_text()

    summary = tmp_path / "precond.csv"
    plots.plot_precond_summary(
        {"m1": {"cg": dict(iters=10, prep_ms=0, solve_ms=10),
                "pcg_ic0": dict(iters=4, prep_ms=2, solve_ms=3)}},
        str(summary),
    )
    txt = summary.read_text()
    assert "pcg_ic0" in txt


def test_suitesparse_local_enumeration(tmp_path):
    from sparsela.io.suitesparse import local_mtx_files, matrix_url

    (tmp_path / "a.mtx").write_text("x")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "b.mtx").write_text("x")
    files = local_mtx_files(str(tmp_path))
    assert len(files) == 2
    assert matrix_url("HB", "bcsstk01").endswith("/HB/bcsstk01.tar.gz")


def test_ulp_comparator():
    from sparsela.utils.compare import compare_results, ulp_distance

    a = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    ok, _ = compare_results(a, a.copy())
    assert ok
    # tiny fp difference passes the length-scaled tolerance
    b = a * (1 + 1e-7)
    ok, _ = compare_results(b, a)
    assert ok
    # gross difference fails
    c = a.copy()
    c[1] = 5.0
    ok, worst = compare_results(c, a)
    assert not ok and worst == 1
    # integers compare exactly
    ok, _ = compare_results(np.array([1, 2]), np.array([1, 3]))
    assert not ok
    assert ulp_distance(np.float32(1.0), np.float32(1.0))[()] == 0


def test_graph_stats():
    from sparsela.io import generators

    csr = generators.make_laplacian_grid2d(10).to_csr()
    gs = csr.graph_stats()
    # symmetric matrix: row and col degrees identical -> r == 1
    assert abs(gs["row_col_pearson_r"] - 1.0) < 1e-12


@pytest.mark.slow
def test_cli_efficiency(tmp_path, capsys):
    from sparsela.bench.run import main as cli

    out = str(tmp_path / "eff")
    res = cli(["efficiency", "--lap2d", "16", "--fp64",
               "--num_vectors", "2", "--output", out, "--quiet",
               "--max_iters", "1000"])
    counts = [c for c, _ in res]
    assert counts == [1, 2, 4, 8]
    assert os.path.exists(os.path.join(out, "lap2d_16_efficiency.csv"))


def test_rng_parity_utils():
    from sparsela.utils.rng import mersenne, random_bits, random_values

    g = mersenne(7)
    b = random_bits(g, (100,), entropy_reduction=2)
    b0 = random_bits(mersenne(7), (100,), entropy_reduction=0)
    # entropy reduction biases bits low: fewer set bits on average
    assert np.unpackbits(b.view(np.uint8)).mean() < \
        np.unpackbits(b0.view(np.uint8)).mean()
    assert random_bits(g, (4,), entropy_reduction=-1).tolist() == \
        [0xFFFFFFFF] * 4
    v = random_values(g, (50,), np.float32)
    assert v.dtype == np.float32 and (0 <= v).all() and (v < 1).all()


def test_bandwidth_plot(tmp_path):
    from sparsela.analysis.plots import plot_bandwidth_curve

    p = tmp_path / "bw.png"
    plot_bandwidth_curve([1e3, 1e6, 1e9], [100, 400, 600], str(p),
                         annotations={"L2": 5e7})
    assert p.exists()


def test_cli_cg(capsys):
    from sparsela.bench.run import main as cli

    cli(["cg", "--lap2d", "8", "--fp64", "--num_vectors", "2",
         "--strategy", "reference", "--tolerance", "1e-6", "--quiet"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    parts = out.split(",")
    assert parts[0] == "lap2d_8"
    assert int(parts[5]) > 0  # total iterations


def test_cli_cg_device_rate(capsys):
    """--device_rate appends a per-iteration rate row (a solve pinned
    to a fixed trip count by tolerance=0, timed to block_until_ready)."""
    from sparsela.bench.run import main as cli

    cli(["cg", "--lap2d", "8", "--fp64", "--num_vectors", "1",
         "--strategy", "reference", "--tolerance", "1e-6", "--quiet",
         "--device_rate"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) >= 2
    parts = lines[-1].split(",")
    assert parts[0] == "lap2d_8"
    assert float(parts[2]) > 0  # us/iter


@pytest.mark.slow
def test_cli_multicg_device_rate(tmp_path, capsys):
    from sparsela.bench.run import main as cli

    cli(["multicg", "--lap2d", "8", "--fp64", "--num_vectors", "2",
         "--strategy", "reference", "--tolerance", "1e-6",
         "--max_iters", "100", "--quiet", "--device_rate",
         "--output", str(tmp_path)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for solver in ("cg", "pcg_ic0", "spai_cg"):
        assert "dev_iter_us" in res[solver], solver
        assert res[solver]["dev_iter_us"] >= 0


def test_cli_sweep(capsys):
    from sparsela.bench.run import main as cli

    cli(["sweep", "--lap2d", "8", "--fp64",
         "--strategy", "reference", "--vector_counts", "1,2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("matrix,kernel,L")
    assert len(out) >= 3  # header + 2 sweep rows


def test_cli_mtx_file_roundtrip(tmp_path, capsys):
    """The most user-visible path: write an .mtx, benchmark it through
    the CLI --mtx flag (golden check included)."""
    from sparsela.bench.run import main as cli
    from sparsela.io import generators
    from sparsela.io.market import write_market

    p = tmp_path / "m.mtx"
    write_market(p, generators.make_laplacian_grid2d(8))
    cli(["spmv", "--mtx", str(p), "--fp64",
         "--strategy", "reference", "--quiet"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    # matrix names in CSV rows drop the .mtx extension (reference
    # naming, eval_simple_gflops.sh:55)
    assert "PASS" in out and out.startswith("m,")


def test_cli_bsr_strategy(capsys):
    from sparsela.bench.run import main as cli

    cli(["spmv", "--lap2d", "8", "--fp32", "--strategy", "bsr",
         "--quiet"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "PASS" in out and "bsr" in out


@pytest.mark.slow
def test_sweep_scripts_smoke(tmp_path):
    """The one-command reproduction scripts (eval_spmm/eval_para/
    eval_simple_gflops — parity with the reference's eval_csrmm.sh /
    eval_para.sh / eval_simple_gflops.sh) run end-to-end on a tiny
    matrix. Subprocesses pin JAX_PLATFORMS=cpu so the smoke test is
    hermetic."""
    import subprocess

    from sparsela.io import generators
    from sparsela.io.market import write_market

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mdir = tmp_path / "mtx"
    mdir.mkdir()
    write_market(str(mdir / "lap2d8.mtx"),
                 generators.make_laplacian_grid2d(8).to_csr())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out1 = tmp_path / "spmm.csv"
    r = subprocess.run(
        ["bash", os.path.join(repo, "scripts", "eval_spmm.sh"),
         str(mdir), "4", str(out1)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out1.read_text().count("\n") >= 2  # header + >= 1 row

    out2 = tmp_path / "eff"
    r = subprocess.run(
        ["bash", os.path.join(repo, "scripts", "eval_para.sh"),
         str(mdir), "2", str(out2)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out2 / "lap2d8_efficiency.csv").exists()

    out3 = tmp_path / "simple"
    r = subprocess.run(
        ["bash", os.path.join(repo, "scripts",
                              "eval_simple_gflops.sh"),
         str(mdir), "0", str(out3)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out3 / "lap2d8_gflops.csv").exists()


def test_cli_spmv_reorder(capsys, tmp_path):
    """--reorder rcm plans on the RCM-permuted matrix (kind prefixed
    rcm+) and still passes the golden check against the un-permuted
    oracle (the permutation is internal to the plan)."""
    import jax.numpy as jnp  # noqa: F401  (backend init before CLI)

    from sparsela.io import generators
    from sparsela.io.market import write_market
    from sparsela.ops.reorder import permute_symmetric

    csr = generators.make_laplacian_grid2d(24, dtype=np.float64).to_csr()
    perm = np.random.default_rng(5).permutation(csr.num_rows)
    p = tmp_path / "scr.mtx"
    write_market(str(p), permute_symmetric(csr, perm))
    cli_main(["spmv", "--mtx", str(p), "--fp32", "--strategy",
              "cusparse", "--reorder", "rcm", "--quiet"])
    rows = [ln for ln in capsys.readouterr().out.strip().splitlines()
            if "," in ln]
    assert rows and all(r.split(",")[7] == "PASS" for r in rows)
    assert any(r.split(",")[1].startswith("rcm+") for r in rows)


@pytest.mark.slow
def test_cli_multicg_reorder(capsys, tmp_path):
    """multicg --reorder factors the preconditioners on the permuted
    matrix and solves in the permuted space (iteration counts are
    permutation-invariant; IC(0) quality improves with the RCM
    order)."""
    from sparsela.io import generators
    from sparsela.io.market import write_market
    from sparsela.ops.reorder import permute_symmetric

    csr = generators.make_laplacian_grid2d(12, dtype=np.float64).to_csr()
    perm = np.random.default_rng(6).permutation(csr.num_rows)
    p = tmp_path / "scr.mtx"
    write_market(str(p), permute_symmetric(csr, perm))
    out = cli_main(["multicg", "--mtx", str(p), "--fp32",
                    "--num_vectors", "2", "--max_iters", "500",
                    "--reorder", "rcm", "--quiet",
                    "--output", str(tmp_path)])
    assert out["cg"]["converged"]
    assert out["pcg_ic0"]["converged"]
    assert out["pcg_ic0"]["iters"] <= out["cg"]["iters"]


def test_bench_headline_smoke():
    """bench.py measures the card or nothing: on the CPU backend it
    exits non-zero and prints no result line (a CPU number never goes
    out under the device metric's name)."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable,
         os.path.join(os.path.dirname(__file__), "..", "bench.py")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "no GPU" in r.stderr
