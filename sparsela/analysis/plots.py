"""Analysis plots — parity with the reference's verification plotters.

  * ``plot_errors``        — ``verification/error/plot_errors.py:38-121``:
    log-y max relative error vs iteration for CG / PCG-IC(0) / SPAI-CG.
  * ``plot_gflops_pivot``  — ``verification/gflops/gflop_analyze.py``:
    per-kernel pivot tables "gflops(iters)".
  * ``plot_efficiency``    — ``verification/efficiency/efficiency_plot.py``:
    speedup + parallel-efficiency plots; thread counts become device
    counts.
  * ``plot_precond_summary`` — ``verification/precondition/
    preconditioner_summary.py``: preprocess/solve/total + speedup table.
"""

from __future__ import annotations

import csv


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_errors(error_csvs: dict[str, str], out_png: str,
                title: str = "") -> None:
    """error_csvs: {solver_name: csv_path} with iteration,error rows."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 5))
    for solver, path in error_csvs.items():
        its, errs = [], []
        with open(path) as f:
            for row in csv.DictReader(f):
                its.append(int(row["iteration"]))
                errs.append(float(row["max_relative_error"]))
        ax.semilogy(its, errs, label=solver)
    ax.set_xlabel("iteration")
    ax.set_ylabel("max relative residual")
    ax.set_title(title or "convergence history")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)


def plot_gflops_pivot(rows, out_csv: str) -> None:
    """rows: (matrix, kernel, L, nnz, ms, gflops, check) tuples from the
    sweep; writes a matrix x kernel pivot of "gflops"."""
    kernels = sorted({r[1] for r in rows})
    matrices = sorted({r[0] for r in rows})
    with open(out_csv, "w") as f:
        f.write("matrix," + ",".join(kernels) + "\n")
        for m in matrices:
            vals = []
            for k in kernels:
                match = [r for r in rows if r[0] == m and r[1] == k]
                vals.append(f"{match[0][5]:.2f}" if match else "")
            f.write(m + "," + ",".join(vals) + "\n")


def plot_efficiency(device_counts, times_s, out_png: str) -> None:
    """Speedup/efficiency vs device count (the multi-device analogue of
    the reference's thread-scaling study, parallel_efficiency.cpp:4-10)."""
    plt = _mpl()
    t1 = times_s[0]
    speedup = [t1 / t for t in times_s]
    eff = [s / d for s, d in zip(speedup, device_counts)]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax1.plot(device_counts, speedup, "o-")
    ax1.plot(device_counts, device_counts, "k--", alpha=0.4,
             label="ideal")
    ax1.set_xlabel("devices")
    ax1.set_ylabel("speedup")
    ax1.legend()
    ax1.grid(alpha=0.3)
    ax2.bar([str(d) for d in device_counts], eff)
    ax2.set_xlabel("devices")
    ax2.set_ylabel("parallel efficiency")
    ax2.set_ylim(0, 1.1)
    ax2.grid(alpha=0.3, axis="y")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)


def plot_precond_summary(results: dict[str, dict], out_csv: str) -> None:
    """results: {matrix: {solver: {iters, prep_ms, solve_ms, ...}}};
    writes the preprocess/solve/total/speedup-vs-CG table."""
    with open(out_csv, "w") as f:
        f.write("matrix,solver,iters,prep_ms,solve_ms,total_ms,"
                "speedup_vs_cg\n")
        for m, solvers in results.items():
            base = solvers.get("cg", {})
            base_total = base.get("prep_ms", 0) + base.get("solve_ms", 0)
            for s, d in solvers.items():
                total = d.get("prep_ms", 0) + d.get("solve_ms", 0)
                sp = base_total / total if total else float("nan")
                f.write(f"{m},{s},{d.get('iters')},"
                        f"{d.get('prep_ms', 0):.2f},"
                        f"{d.get('solve_ms', 0):.2f},{total:.2f},"
                        f"{sp:.3f}\n")


def plot_bandwidth_curve(sizes_bytes, gbs, out_png: str,
                         annotations=None) -> None:
    """Memory-bandwidth curve over working-set size (parity:
    verification/ram_speed/ram_speed_plot.py — the cache-hierarchy
    annotated STREAM plot; on the GPU the annotations are L2/HBM
    capacities instead of L1/L2/L3)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.semilogx(sizes_bytes, gbs, "o-")
    for label, x in (annotations or {}).items():
        ax.axvline(x, color="gray", ls="--", alpha=0.5)
        ax.text(x, max(gbs) * 0.95, label, rotation=90, va="top",
                fontsize=8)
    ax.set_xlabel("working set (bytes)")
    ax.set_ylabel("effective GB/s")
    ax.grid(alpha=0.3, which="both")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
