"""On-card smoke test: the library's main path at real sizes on one GPU.

    python chip_smoke.py          # one card: device, SpMV/SpMM, solves
    python chip_smoke.py --four   # four cards: the two sharded solves

One process. Every phase runs through the normal entry points
(``plan_matrix`` + ``spmv``/``spmm``, the solvers, the sharded
solvers), compares the result on the card with a plain host reference
(scipy in f64, or a numpy CG oracle) and prints one line with the
error, the tolerance and the precision. A cuSPARSE lowering that falls
back to XLA's generic path raises (``CuSparseEfficiencyWarning`` is an
error here). Any failed phase exits non-zero; without a GPU the script
exits non-zero before any phase. The last line of a passing run is
``{"ok": true, "device": {...}}``.

The phase functions take their sizes as arguments so the CPU tests can
run them small (tests/test_chip_smoke.py); ``main`` runs the real sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings

import numpy as np


def _rel(y, ref) -> float:
    """max |y - ref| / max |ref| (inf-norm relative error)."""
    y = np.asarray(y, dtype=np.float64)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300))


def _line(name, err, tol, precision, extra=""):
    ok = bool(err <= tol)
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: err {err:.3e} "
          f"(tol {tol:.0e}, {precision}){extra}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def _iters_line(name, got, oracle, window, extra=""):
    ok = abs(int(got) - int(oracle)) <= window
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {int(got)} iterations "
          f"vs host oracle {int(oracle)} (window ±{window}){extra}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: iterations {got} vs {oracle}")


# --------------------------------------------------------------------
# host oracles
# --------------------------------------------------------------------


def host_pcg(S, B, tol, max_iters, apply_m=None):
    """Textbook (P)CG on the host, vectorized over RHS columns, with the
    library's stopping rule (sqrt(r.r) < tol * ||b|| per column,
    converged columns frozen). Returns (X, iterations) — iterations is
    the count of the slowest column, as the blocked solvers report."""
    dt = S.dtype
    B = np.asarray(B, dtype=dt)
    single = B.ndim == 1
    B = B[:, None] if single else B
    if apply_m is None:
        def apply_m(R):
            return R
    X = np.zeros_like(B)
    R = B.copy()
    Z = apply_m(R).astype(dt)
    P = Z.copy()
    bn = np.sqrt((B * B).sum(0))
    bn[bn == 0] = 1
    rho = (R * Z).sum(0)
    conv = np.sqrt((R * R).sum(0)) < tol * bn
    it = 0
    while it < max_iters and not conv.all():
        AP = S @ P
        pap = (P * AP).sum(0)
        alpha = np.where(conv | (pap == 0), 0, rho / np.where(pap == 0, 1,
                                                              pap))
        X += alpha * P
        R -= alpha * AP
        conv |= np.sqrt((R * R).sum(0)) < tol * bn
        Z = apply_m(R).astype(dt)
        rho_new = (R * Z).sum(0)
        beta = np.where(conv | (rho == 0), 0, rho_new / np.where(
            rho == 0, 1, rho))
        P = Z + beta * P
        rho = rho_new
        it += 1
    return (X[:, 0] if single else X), it


def _host_jacobi_ic0(Lf, dtype, sweeps):
    """Host twin of solvers.pcg.make_ic0_preconditioner: forward then
    backward fixed-sweep Jacobi triangular solves on the IC(0) factor."""
    from sparsela.precond.trisolve import split_diag

    parts = []
    for T in (Lf, Lf.transpose()):
        strict, diag = split_diag(T)
        parts.append((strict.astype(dtype).to_scipy(),
                      (1.0 / diag).astype(dtype)[:, None]))

    def apply_m(R):
        for S, d in parts:
            x = R * d
            for _ in range(sweeps):
                x = (R - S @ x) * d
            R = x
        return R

    return apply_m


# --------------------------------------------------------------------
# phases
# --------------------------------------------------------------------


def phase_spmv(width=192, rmat_scale=21, L=16):
    """SpMV/SpMM on lap3d-``width`` (AUTO f32 = masked DIA, the general
    CSR route, AUTO f64, SpMM at L) and R-MAT on the general route, each
    against a scipy f64 product."""
    import jax.numpy as jnp

    from sparsela.io import generators
    from sparsela.ops.spmv import plan_kind, plan_matrix, spmm, spmv

    rng = np.random.default_rng(0)
    csr = generators.make_laplacian_grid3d(width).to_csr()
    S = csr.to_scipy()
    x = rng.standard_normal(csr.num_cols)
    ref = S @ x
    for label, strategy, dt, tol in (
            ("AUTO f32", "auto", np.float32, 1e-5),
            ("general CSR f32", "cusparse", np.float32, 1e-5),
            ("AUTO f64", "auto", np.float64, 1e-12)):
        A = plan_matrix(csr, strategy=strategy, dtype=dt)
        y = spmv(A, jnp.asarray(x.astype(dt)))
        _line(f"SpMV lap3d-{width} {label} [{plan_kind(A)}]",
              _rel(y, ref), tol, np.dtype(dt).name,
              f", {csr.num_rows} rows, {csr.nnz} nnz")
        if label == "AUTO f32" and plan_kind(A) != "dia_masked":
            raise AssertionError(f"AUTO f32 planned {plan_kind(A)}, "
                                 "expected dia_masked")
        del A
    X = rng.standard_normal((csr.num_cols, L))
    A = plan_matrix(csr, dtype=np.float32, L=L)
    Y = spmm(A, jnp.asarray(X.astype(np.float32)))
    _line(f"SpMM lap3d-{width} AUTO f32 L={L} [{plan_kind(A)}]",
          _rel(Y, S @ X), 1e-5, "float32")
    del A, Y, S, csr

    g = generators.make_rmat(rmat_scale, edge_factor=16).to_csr()
    Sg = g.to_scipy()
    xg = rng.standard_normal(g.num_cols)
    A = plan_matrix(g, strategy="cusparse", dtype=np.float32)
    y = spmv(A, jnp.asarray(xg.astype(np.float32)))
    _line(f"SpMV rmat-{rmat_scale} general CSR f32 [{plan_kind(A)}]",
          _rel(y, Sg @ xg), 1e-5, "float32",
          f", {g.num_rows} rows, {g.nnz} nnz")


def phase_cg(width=128, tol=1e-5, window=1):
    """f32 CG to ``tol`` on lap3d-``width`` (AUTO plan) against the host
    oracle in f32; prints the compiled solve's memory analysis."""
    import jax
    import jax.numpy as jnp

    from sparsela.io import generators
    from sparsela.ops.spmv import plan_kind, plan_matrix
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_laplacian_grid3d(width, dtype=np.float32).to_csr()
    b = np.random.default_rng(1).standard_normal(csr.num_rows).astype(
        np.float32)
    A = plan_matrix(csr, dtype=np.float32)
    solve = jax.jit(lambda v: cg_solve(A, v, max_iters=20000,
                                       tolerance=tol))
    t0 = time.perf_counter()
    compiled = solve.lower(jnp.asarray(b)).compile()
    print(f"  CG lap3d-{width} compile {time.perf_counter() - t0:.1f} s; "
          f"memory_analysis: {compiled.memory_analysis()}", flush=True)
    res = compiled(jnp.asarray(b))
    _, it_host = host_pcg(csr.to_scipy(), b, tol, 20000)
    _iters_line(f"CG f32 lap3d-{width} tol {tol:g} [{plan_kind(A)}]",
                res.iterations, it_host, window,
                f", device residual {float(res.residual):.2e}")


def phase_cg_multi(width=64, L=16, tol=1e-5, window=1):
    """Blocked CG at L RHS against the blocked host oracle (f32)."""
    import jax.numpy as jnp

    from sparsela.io import generators
    from sparsela.ops.spmv import plan_matrix
    from sparsela.solvers.cg import cg_solve_multi

    csr = generators.make_laplacian_grid3d(width, dtype=np.float32).to_csr()
    B = np.random.default_rng(2).standard_normal(
        (csr.num_rows, L)).astype(np.float32)
    res = cg_solve_multi(plan_matrix(csr, dtype=np.float32, L=L),
                         jnp.asarray(B), max_iters=20000, tolerance=tol)
    _, it_host = host_pcg(csr.to_scipy(), B, tol, 20000)
    _iters_line(f"cg_solve_multi f32 lap3d-{width} L={L}",
                res.iterations, it_host, window)


def phase_precond(width=64, L=16, tol=1e-5, window=1):
    """PCG-IC(0) (Jacobi trisolves, 2 sweeps) and SPAI-CG on
    lap3d-``width`` against host oracles with the same preconditioners."""
    import jax.numpy as jnp

    from sparsela.io import generators
    from sparsela.ops.spmv import plan_matrix
    from sparsela.precond.ic0 import ic0_factorize
    from sparsela.precond.spai import spai_inverse
    from sparsela.solvers.pcg import make_ic0_preconditioner, \
        pcg_solve_multi
    from sparsela.solvers.spai_cg import spai_cg_solve_multi

    csr = generators.make_laplacian_grid3d(width, dtype=np.float32).to_csr()
    S = csr.to_scipy()
    B = np.random.default_rng(3).standard_normal(
        (csr.num_rows, L)).astype(np.float32)
    A = plan_matrix(csr, dtype=np.float32, L=L)
    Lf = ic0_factorize(csr)
    prec = make_ic0_preconditioner(Lf, sweeps=2, num_rhs=L,
                                   dtype=np.float32)
    res = pcg_solve_multi(A, jnp.asarray(B), prec, max_iters=20000,
                          tolerance=tol)
    _, it_host = host_pcg(S, B, tol, 20000,
                          _host_jacobi_ic0(Lf, np.float32, 2))
    _iters_line(f"PCG-IC(0) f32 lap3d-{width} L={L}", res.iterations,
                it_host, window)
    M = spai_inverse(csr).astype(np.float32)
    res = spai_cg_solve_multi(A, plan_matrix(M, dtype=np.float32, L=L),
                              jnp.asarray(B), max_iters=20000,
                              tolerance=tol)
    Ms = M.to_scipy()
    _, it_host = host_pcg(S, B, tol, 20000, lambda R: Ms @ R)
    _iters_line(f"SPAI-CG f32 lap3d-{width} L={L}", res.iterations,
                it_host, window)


def phase_fp64(points=30000, tol=1e-8, rel_window=0.05):
    """IEEE fp64 CG to ``tol`` with reorder='auto' on fem2d-``points``
    against the host f64 oracle.

    The window is relative: this operator is ill-conditioned (tens of
    thousands of CG iterations), and in finite precision CG's delay
    from lost orthogonality depends on rounding, so a trajectory that
    sums in another order (RCM-permuted rows, XLA's reductions) drifts
    by a few percent (CPU backend, 30000 points: 29527 iterations with
    RCM, 30442 without, host oracle 30596). For the same reason the
    true residual stalls above ``tol`` (the residual gap); the device
    solution must be as accurate as the oracle's, within 2x."""
    import jax.numpy as jnp

    from sparsela.io import generators
    from sparsela.ops.spmv import plan_kind, plan_matrix
    from sparsela.solvers.cg import cg_solve

    csr = generators.make_fem2d(points).to_csr()
    S = csr.to_scipy()
    b = np.random.default_rng(4).standard_normal(csr.num_rows)
    A = plan_matrix(csr, dtype=np.float64, reorder="auto")
    res = cg_solve(A, jnp.asarray(b), max_iters=100000, tolerance=tol)
    x_host, it_host = host_pcg(S, b, tol, 100000)

    def true_rel(x):
        return float(np.linalg.norm(b - S @ np.asarray(x))
                     / np.linalg.norm(b))

    if not bool(res.converged):
        raise AssertionError("fp64 CG reports not converged")
    window = max(1, int(np.ceil(rel_window * it_host)))
    _iters_line(f"CG f64 fem2d-{points} tol {tol:g} reorder=auto "
                f"[{plan_kind(A)}]", res.iterations, it_host, window)
    _line(f"CG f64 fem2d-{points} true residual", true_rel(res.x),
          2 * max(true_rel(x_host), tol), "float64",
          f" (oracle's {true_rel(x_host):.2e})")


def phase_bf16(width=96, tol=1e-5):
    """cg_solve_bf16 on varcoef-``width`` (27-point, bf16 planes with
    f32 arithmetic), verified converged against the f32 operator on the
    host; the plain f32 CG iteration count is printed beside it."""
    import jax.numpy as jnp

    from sparsela.io import generators
    from sparsela.ops.spmv import plan_dia_bf16, plan_matrix
    from sparsela.solvers.cg import cg_solve
    from sparsela.solvers.refine import cg_solve_bf16

    csr = generators.make_variable_stencil(
        width, dims=3, full=True, shift=1.0, dtype=np.float32).to_csr()
    b = np.random.default_rng(5).standard_normal(csr.num_rows).astype(
        np.float32)
    A32 = plan_matrix(csr, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        A16 = plan_dia_bf16(csr)
    res = cg_solve_bf16(A16, A32, jnp.asarray(b), tolerance=tol)
    ref32 = cg_solve(A32, jnp.asarray(b), tolerance=tol)
    S = csr.to_scipy().astype(np.float64)
    true_rel = float(np.linalg.norm(b - S @ np.asarray(res.x, np.float64))
                     / np.linalg.norm(b))
    if not bool(res.converged):
        raise AssertionError("cg_solve_bf16 reports not converged")
    # the verification ran in f32 arithmetic; f32 rounding of the
    # residual itself is ~1e-7 relative, far inside the 1% margin
    _line(f"cg_solve_bf16 varcoef-{width} true residual (f32 operator)",
          true_rel, 1.01 * tol, "bf16 planes, f32 arithmetic",
          f", {int(res.iterations)} iterations "
          f"({int(res.replacements)} replacements) vs plain f32 CG "
          f"{int(ref32.iterations)}")


def phase_four(width=128, tol=1e-5, window=1, n_devices=4):
    """Halo-DIA CG and row-sharded CSR CG on a 1-D mesh of
    ``n_devices`` against the one-device solves: iteration parity and
    solution agreement."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sparsela.formats.dia import partition_dia, select_diagonals
    from sparsela.io import generators
    from sparsela.ops.spmv import plan_matrix
    from sparsela.parallel import sharded as sh
    from sparsela.parallel import sharded_dia as sdia
    from sparsela.parallel.solvers import cg_solve_sharded
    from sparsela.solvers.cg import cg_solve

    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise AssertionError(f"need {n_devices} devices, have {len(devs)}")
    mesh = Mesh(np.array(devs), ("rows",))
    csr = generators.make_laplacian_grid3d(width, dtype=np.float32).to_csr()
    S = csr.to_scipy().astype(np.float64)
    b = np.random.default_rng(6).standard_normal(csr.num_rows).astype(
        np.float32)

    def check(label, res_n, x_n, one_plan):
        one = cg_solve(one_plan, jnp.asarray(b), max_iters=20000,
                       tolerance=tol)
        x1 = np.asarray(one.x, np.float64)
        true_rel = float(np.linalg.norm(b - S @ x_n) / np.linalg.norm(b))
        _iters_line(f"{label} {n_devices} devices lap3d-{width}",
                    res_n.iterations, one.iterations, window,
                    " (one-device solve)")
        # both solves stop at residual <= tol; their trajectories
        # differ only by reduction order, so the solutions agree far
        # inside the residual-level bound
        _line(f"{label} solution vs one device",
              float(np.linalg.norm(x_n - x1) / np.linalg.norm(x1)),
              1e-3, "float32", f", true residual {true_rel:.2e}")

    A = sh.shard_csr(csr, n_devices)
    res = cg_solve_sharded(sh.device_put_sharded(A, mesh),
                           sh.to_padded_layout(b, A), mesh,
                           max_iters=20000, tolerance=tol)
    check("row-sharded CSR CG", res,
          sh.from_padded_layout(np.asarray(res.x), A).astype(np.float64),
          plan_matrix(csr, strategy="cusparse", dtype=np.float32))

    dia, _ = partition_dia(csr, select_diagonals(csr))
    sd = sdia.shard_dia(dia, n_devices, masked=True)
    res = sdia.cg_solve_dia_sharded(
        sdia.device_put_sharded_dia(sd, mesh),
        sh.to_padded_layout(b, sd), mesh, max_iters=20000,
        tolerance=tol)
    check("halo-DIA CG", res,
          sh.from_padded_layout(np.asarray(res.x), sd).astype(np.float64),
          plan_matrix(csr, dtype=np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the two sharded solves on 4 GPUs")
    args = ap.parse_args(argv)

    import jax
    from jax.experimental.sparse import CuSparseEfficiencyWarning

    from sparsela.utils.device import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    warnings.simplefilter("error", CuSparseEfficiencyWarning)
    jax.config.update("jax_enable_x64", True)
    cache = enable_compile_cache()
    info = require_gpu()
    gpu = gpu_name_and_power_limit()
    print(f"devices: {jax.devices()}")
    print(f"platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}; nvidia-smi: {gpu}; "
          f"compile cache {cache}", flush=True)
    phases = [phase_four] if args.four else [
        phase_spmv, phase_cg, phase_cg_multi, phase_precond, phase_fp64,
        phase_bf16]
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failed.append(phase.__name__)
        print(f"  {phase.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(gpu)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
