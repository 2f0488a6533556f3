"""Benchmark / verification CLI (the reference's layers L8/L9).

Capability parity with the reference driver executables and sweep
scripts, in one JAX process. Every run first names the device it ran
on (``# device: ...`` on stderr, so stdout stays CSV): a timing taken
on the CPU backend describes that backend, not the card.

  spmv      — ``cpu_spmv`` (``cpu_spmv.cpp:925-991``):
              golden check then timed run per strategy, GFLOP/s +
              effective bandwidth, ``--quiet`` CSV rows.
  spmm      — ``cpu_spmm_v2`` (``cpu_spmm_v2.cpp:1115``): adds
              ``--num_vectors`` (default 32).
  cg        — ``cpu_singlecg`` (``cpu_singlecg.cpp:219``): single-RHS CG
              over L vectors sequentially, CSV (matrix, kernel, L,
              min_ms, gflops, iters).
  multicg   — ``cpu_multicg`` (``cpu_multicg.cpp:293``): CG -> PCG-IC(0)
              -> SPAI-CG comparison, per-iteration error CSVs to
              ``data/error_data/``.
  stats     — ``verification/matrix_stats`` tool.
  sweep     — ``eval_csrmv.sh`` / ``eval_vectors.sh``: matrices x L
              sweep emitting a CSV.

Matrix sources mirror the reference CLI: ``--mtx file.mtx``,
``--grid2d w``, ``--grid3d w``, ``--wheel s``, ``--dense n``, plus
``--lap2d/--lap3d`` (built-in SPD fixtures for solver runs) and
``--spd n`` (random SPD).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np


# Routes a spmv/spmm run benches when --strategy is not given.
DEFAULT_STRATEGIES = ["auto", "cusparse", "reference", "bcoo"]


def _load_matrix(args):
    from sparsela.io import generators
    from sparsela.io.market import read_market

    dtype = np.float32 if args.fp32 else np.float64
    if args.mtx:
        coo = read_market(args.mtx, dtype=dtype)
        # basename without extension (reference CSV naming:
        # eval_simple_gflops.sh:55 `basename "${mtx_file}" .mtx`)
        name = os.path.basename(args.mtx)
        for ext in (".mtx.gz", ".mtx"):
            if name.endswith(ext):
                name = name[: -len(ext)]
                break
    elif getattr(args, "real", None):
        # real SuiteSparse-collection matrices reconstructed offline
        # from their published definitions (io.realmats; the
        # reference's evaluation corpus is the UFL collection,
        # get_uf_datasets.sh:10-24)
        from sparsela.formats.coo import CooMatrix
        from sparsela.io.realmats import build_real

        coo = build_real(args.real)
        if dtype is not None:
            coo = CooMatrix(coo.num_rows, coo.num_cols, coo.rows,
                            coo.cols, coo.vals.astype(dtype))
        name = args.real
    elif args.grid2d:
        coo = generators.make_grid2d(args.grid2d, self_loop=True,
                                     dtype=dtype)
        name = f"grid2d_{args.grid2d}"
    elif args.grid3d:
        coo = generators.make_grid3d(args.grid3d, self_loop=True,
                                     dtype=dtype)
        name = f"grid3d_{args.grid3d}"
    elif args.wheel:
        coo = generators.make_wheel(args.wheel, dtype=dtype)
        name = f"wheel_{args.wheel}"
    elif args.dense:
        coo = generators.make_dense(args.dense, args.dense, dtype=dtype)
        name = f"dense_{args.dense}"
    elif args.lap2d:
        coo = generators.make_laplacian_grid2d(args.lap2d, dtype=dtype)
        name = f"lap2d_{args.lap2d}"
    elif args.lap3d:
        coo = generators.make_laplacian_grid3d(args.lap3d, dtype=dtype)
        name = f"lap3d_{args.lap3d}"
    elif args.spd:
        coo = generators.make_random_spd(args.spd, dtype=dtype)
        name = f"spd_{args.spd}"
    elif args.rmat:
        ef = getattr(args, "rmat_ef", 16)
        coo = generators.make_rmat(args.rmat, edge_factor=ef,
                                   dtype=dtype)
        name = (f"rmat_{args.rmat}" if ef == 16
                else f"rmat_{args.rmat}_ef{ef}")
    elif args.rmat_spd:
        coo = generators.make_rmat_spd(args.rmat_spd, dtype=dtype)
        name = f"rmat_spd_{args.rmat_spd}"
    elif getattr(args, "fem", None):
        coo = generators.make_fem2d(args.fem, dtype=dtype)
        name = f"fem2d_{args.fem}"
    elif getattr(args, "varcoef", None):
        # variable-coefficient SPD diffusion stencil (the SuiteSparse
        # FD/FEM reality vs the constant-coefficient grids; 27-point
        # by default — the plane-stream-bound bf16-refinement regime)
        full = not getattr(args, "varcoef_axis", False)
        coo = generators.make_variable_stencil(
            args.varcoef, dims=3, full=full,
            sigma=getattr(args, "varcoef_sigma", 1.0),
            shift=getattr(args, "varcoef_shift", 1.0), dtype=dtype)
        name = f"varco3_{args.varcoef}" + ("" if full else "_ax")
    else:
        raise SystemExit("no matrix source given (--mtx/--grid2d/...)")
    return coo.to_csr(), name


def _plan(csr, strategy, dtype, L=1, reorder=None, plan_cache=None):
    """Build the device operand for a strategy; returns (operand, kind).
    ``plan_cache``: directory for the content-keyed on-disk plan cache
    (io.plans.cached_plan) — repeated runs skip planning entirely."""
    from sparsela.ops.spmv import plan_kind, plan_matrix

    if plan_cache:
        from sparsela.io.plans import cached_plan

        A = cached_plan(csr, plan_cache, strategy=strategy,
                        dtype=dtype, L=L, reorder=reorder)
    else:
        A = plan_matrix(csr, strategy=strategy, dtype=dtype, L=L,
                        reorder=reorder)
    # plan_kind is the single source of truth for row labels
    return A, plan_kind(A)


def _time_op(args, fn, *operands):
    """Median seconds per jitted ``fn(*operands)``
    (bench.timing.time_fn); --timing_iters (reference --i,
    cpu_spmv.cpp:937) sets the number of timed repetitions. Plans go
    in as operands, not closures: a closed-over array is compiled into
    the executable as a constant."""
    import jax

    from sparsela.bench.timing import time_fn

    reps = getattr(args, "timing_iters", 0) or 20
    return time_fn(jax.jit(fn), *operands, reps=reps).median_s


def _error_row(name, strat, exc, args):
    """One-line ERROR row for a strategy that cannot run this matrix
    (capacity limits raise ValueError with guidance; compile-time
    failures surface as backend errors) — the sweep continues."""
    msg = str(exc).split("\n")[0][:200]
    if args.quiet:
        print(f"{name},{strat},ERROR,{msg}")
    else:
        print(f"{name} [{strat}]: ERROR — {msg}")


def cmd_spmv(args):
    import jax.numpy as jnp

    from sparsela.bench import models
    from sparsela.ops.reference import spmv_numpy
    from sparsela.ops.spmv import spmv

    csr, name = _load_matrix(args)
    dtype = np.float32 if args.fp32 else np.float64
    rng = np.random.default_rng(0)
    x = rng.standard_normal(csr.num_cols).astype(dtype)
    golden = spmv_numpy(csr, x, alpha=args.alpha, beta=args.beta)

    # AUTO + the general CSR routes — the reference benches
    # {Simple, Merge, NonzeroSplit, MKL} per run (cpu_spmv.cpp:750-923)
    strategies = (args.strategy.split(",") if args.strategy
                  else DEFAULT_STRATEGIES)
    rows = []
    seen_kinds = set()
    for strat in strategies:
        try:
            A, kind = _plan(csr, strat, dtype,
                            reorder=getattr(args, "reorder", None),
                            plan_cache=getattr(args, "plan_cache", None))
            if strat == "auto" and not args.strategy:
                # AUTO may resolve to a strategy already in the default
                # list; dedupe so each kind is benched once
                seen_kinds.add(kind)
            elif kind in seen_kinds and not args.strategy:
                continue
            xd = jnp.asarray(x)
            y = np.asarray(spmv(A, xd, alpha=args.alpha,
                                beta=args.beta))
            scale = np.abs(golden).max() + 1.0
            err = np.abs(y - golden).max() / scale
            ok = err < (2e-5 if dtype == np.float32 else 1e-10)
            per = _time_op(args, spmv, A, xd)
        except Exception as e:  # noqa: BLE001 — a strategy that cannot
            # run this matrix (capacity, compile limits) must not kill
            # the rest of the sweep; the reference driver likewise
            # reports per-kernel rows independently
            _error_row(name, strat, e, args)
            continue
        gf = models.gflops(models.spmv_flops(csr.nnz), per)
        bw = models.gbytes_per_s(
            models.spmv_bytes(csr.nnz, csr.num_rows,
                              value_bytes=np.dtype(dtype).itemsize),
            per,
        )
        from sparsela.ops.spmv import plan_semantics

        sem = plan_semantics(A)
        rows.append((name, kind, csr.num_rows, csr.nnz,
                     per * 1e3, gf, bw, "PASS" if ok else "FAIL", sem))
        if not args.quiet:
            print(f"{name} [{kind}] {'fp32' if args.fp32 else 'fp64'}: "
                  f"{per*1e3:.3f} ms, {gf:.2f} GFLOP/s, {bw:.1f} GB/s "
                  f"eff, {'PASS' if ok else 'FAIL'} (err {err:.2e}, "
                  f"{sem})")
    if args.quiet:
        for r in rows:
            print(",".join(str(v) for v in r))
    return rows


def cmd_spmm(args):
    import jax.numpy as jnp

    from sparsela.bench import models
    from sparsela.ops.spmv import spmm

    csr, name = _load_matrix(args)
    dtype = np.float32 if args.fp32 else np.float64
    L = args.num_vectors
    rng = np.random.default_rng(0)
    # RHS layout parity with the reference's g_input_row_major toggle
    # (cpu_spmm_v2.cpp:74-75,289-300): row-major (n, L) is the native
    # layout; --col_major_input generates the transposed (L, n) input
    # and transposes it in, exercising the same relayout cost.
    if getattr(args, "col_major_input", False):
        X = rng.standard_normal((L, csr.num_cols)).astype(dtype).T.copy()
    else:
        X = rng.standard_normal((csr.num_cols, L)).astype(dtype)
    golden = csr.to_scipy() @ X

    strategies = (args.strategy.split(",") if args.strategy
                  else DEFAULT_STRATEGIES)
    rows = []
    seen_kinds = set()
    for strat in strategies:
        try:
            A, kind = _plan(csr, strat, dtype, L=L,
                            reorder=getattr(args, "reorder", None),
                            plan_cache=getattr(args, "plan_cache", None))
            if strat == "auto" and not args.strategy:
                seen_kinds.add(kind)
            elif kind in seen_kinds and not args.strategy:
                continue
            Xd = jnp.asarray(X)
            Y = np.asarray(spmm(A, Xd))
            scale = np.abs(golden).max() + 1.0
            err = np.abs(Y - golden).max() / scale
            ok = err < (5e-5 if dtype == np.float32 else 1e-10)
            per = _time_op(args, spmm, A, Xd)
        except Exception as e:  # noqa: BLE001 — see cmd_spmv
            _error_row(name, strat, e, args)
            continue
        gf = models.gflops(models.spmv_flops(csr.nnz, L), per)
        from sparsela.ops.spmv import plan_semantics

        sem = plan_semantics(A)
        rows.append((name, kind, L, csr.nnz, per * 1e3, gf,
                     "PASS" if ok else "FAIL", sem))
        if not args.quiet:
            print(f"{name} [{kind}] L={L}: {per*1e3:.3f} ms, "
                  f"{gf:.2f} GFLOP/s, {'PASS' if ok else 'FAIL'} "
                  f"(err {err:.2e}, {sem})")
    if args.quiet:
        for r in rows:
            print(",".join(str(v) for v in r))
    return rows


def cmd_cg(args):
    """Single-RHS CG over L vectors sequentially (cpu_singlecg parity:
    FLOP model (2nnz + 10n) per iteration, cpu_singlecg.cpp:94).

    ``--refined``: fp64-accurate solves via mixed-precision iterative
    refinement (fp32 CG inner solves + fp64 residuals) —
    beyond-reference; the reference's fp64 default met by fp32
    inner iterations."""
    import functools

    import jax.numpy as jnp

    from sparsela.bench import models
    from sparsela.ops.spmv import spmv
    from sparsela.solvers.cg import cg_solve

    csr, name = _load_matrix(args)
    if getattr(args, "refined", False):
        from sparsela.solvers.refine import cg_solve_refined

        A32, kind = _plan(csr, args.strategy or "auto", np.float32)
        Acc, _ = _plan(csr, "auto", np.float64)
        solver = functools.partial(
            cg_solve_refined, A32, Acc,
            tolerance=max(args.tolerance, 1e-12),
        )
        rng = np.random.default_rng(0)
        L = args.num_vectors
        b = jnp.asarray(rng.standard_normal(csr.num_rows))
        solver(b)  # warmup/compile
        total_inner = 0
        t0 = time.perf_counter()
        for v in range(L):
            b = jnp.asarray(rng.standard_normal(csr.num_rows))
            res = solver(b)
            total_inner += int(res.inner_iterations)
        t = time.perf_counter() - t0
        gf = models.gflops(
            (2.0 * csr.nnz + 10.0 * csr.num_rows) * total_inner, t
        )
        row = (name, f"{kind}+refine", L, t * 1e3, gf, total_inner)
        if args.quiet:
            print(",".join(str(v) for v in row))
        else:
            print(f"{name} [{kind}+refine]: {L} solves, {total_inner} "
                  f"inner iters, {t*1e3:.1f} ms, {gf:.2f} GFLOP/s, "
                  f"residual {float(np.max(np.asarray(res.residual))):.2e}")
        return row
    if getattr(args, "bf16", False):
        # same-process A/B: plain f32 CG vs the residual-replacement
        # bf16-plane CG at equal VERIFIED tolerance (the
        # plane-stream-bound variable-coefficient class)
        from sparsela.ops.spmv import plan_dia_bf16
        from sparsela.solvers.refine import cg_solve_bf16

        A32, kind = _plan(csr, args.strategy or "dia", np.float32)
        A16 = plan_dia_bf16(csr)
        rng = np.random.default_rng(0)
        bw = jnp.asarray(
            rng.standard_normal(csr.num_rows).astype(np.float32))
        # warm both paths (compile outside the timed region)
        int(cg_solve(A32, bw, max_iters=args.max_iters,
                     tolerance=args.tolerance).iterations)
        int(cg_solve_bf16(A16, A32, bw, max_iters=args.max_iters,
                          tolerance=args.tolerance).iterations)
        rows = []
        for tag, solve in (
            (kind, lambda b: cg_solve(
                A32, b, max_iters=args.max_iters,
                tolerance=args.tolerance)),
            ("dia_bf16+repl", lambda b: cg_solve_bf16(
                A16, A32, b, max_iters=args.max_iters,
                tolerance=args.tolerance)),
        ):
            rng = np.random.default_rng(0)  # same RHS stream both arms
            total = 0
            t0 = time.perf_counter()
            for _ in range(args.num_vectors):
                b = jnp.asarray(rng.standard_normal(
                    csr.num_rows).astype(np.float32))
                res = solve(b)
                total += int(res.iterations)
            t = time.perf_counter() - t0
            from sparsela.bench import models

            gf = models.gflops(
                (2.0 * csr.nnz + 10.0 * csr.num_rows) * total, t)
            rel = float(np.max(np.asarray(res.residual)))
            rows.append((name, tag, args.num_vectors, t * 1e3, gf,
                         total, rel))
            if args.quiet:
                print(",".join(str(v) for v in rows[-1]))
            else:
                print(f"{name} [{tag}]: {args.num_vectors} solves, "
                      f"{total} total iters, {t*1e3:.1f} ms, "
                      f"{gf:.2f} GFLOP/s, rel {rel:.2e}")
        if not args.quiet and rows[1][3] > 0:
            print(f"{name} bf16-repl speedup: "
                  f"{rows[0][3]/rows[1][3]:.2f}x wall, iter ratio "
                  f"{rows[1][5]/max(rows[0][5],1):.2f}")
        return rows
    dtype = np.float32 if args.fp32 else np.float64
    A, kind = _plan(csr, args.strategy or "auto", dtype,
                    reorder=getattr(args, "reorder", None),
                            plan_cache=getattr(args, "plan_cache", None))
    rng = np.random.default_rng(0)
    L = args.num_vectors
    # warmup solve outside the timed region (jit compile; reference
    # methodology warms before timing, cpu_spmv.cpp:330-347)
    bw = jnp.asarray(rng.standard_normal(csr.num_rows).astype(dtype))
    int(cg_solve(A, bw, max_iters=args.max_iters,
                 tolerance=args.tolerance).iterations)
    total_iters = 0
    t0 = time.perf_counter()
    for v in range(L):
        b = jnp.asarray(rng.standard_normal(csr.num_rows).astype(dtype))
        res = cg_solve(A, b, max_iters=args.max_iters,
                       tolerance=args.tolerance)
        total_iters += int(res.iterations)
    t = time.perf_counter() - t0
    gf = models.gflops(
        (2.0 * csr.nnz + 10.0 * csr.num_rows) * total_iters, t
    )
    row = (name, kind, L, t * 1e3, gf, total_iters)
    if args.quiet:
        print(",".join(str(v) for v in row))
    else:
        print(f"{name} [{kind}]: {L} solves, {total_iters} total iters, "
              f"{t*1e3:.1f} ms, {gf:.2f} GFLOP/s")
    if getattr(args, "device_rate", False):
        # per-iteration rate of one solve pinned to a fixed trip count
        # (tolerance=0), so the time per iteration is not diluted by
        # the convergence exit
        per = _solver_iter_time(
            lambda M: (lambda: cg_solve(A, bw, max_iters=M,
                                        tolerance=0.0)))
        dev_gf = models.gflops(
            2.0 * csr.nnz + 10.0 * csr.num_rows, per)
        msg = (f"{name} [{kind}] iteration rate: "
               f"{per*1e6:.1f} us/iter, {dev_gf:.1f} GFLOP/s")
        print(",".join(str(v) for v in (name, kind, per * 1e6, dev_gf))
              if args.quiet else msg)
        return row + (dev_gf,)
    return row


# Trip count of the pinned solves that --device_rate times.
RATE_ITERS = 200


def _solver_iter_time(make_solve, iters: int = RATE_ITERS) -> float:
    """Seconds per iteration: ``make_solve(M)`` returns a no-arg
    callable running M pinned iterations in one dispatch; the median
    of its timed calls over M."""
    from sparsela.bench.timing import time_fn

    return time_fn(make_solve(iters), reps=5).median_s / iters


def cmd_multicg(args):
    """Solver comparison CG / PCG-IC(0) / SPAI-CG with error-history
    CSVs (cpu_multicg parity, cpu_multicg.cpp:109-290)."""
    import jax.numpy as jnp

    from sparsela.bench import models
    from sparsela.precond.ic0 import ic0_factorize
    from sparsela.precond.spai import spai_inverse
    from sparsela.solvers.cg import cg_solve_multi
    from sparsela.solvers.pcg import make_ic0_preconditioner, \
        pcg_solve_multi
    from sparsela.solvers.spai_cg import spai_cg_solve_multi

    csr, name = _load_matrix(args)
    dtype = np.float32 if args.fp32 else np.float64
    L = args.num_vectors
    A, kind = _plan(csr, args.strategy or "auto", dtype, L=L,
                    reorder=getattr(args, "reorder", None),
                            plan_cache=getattr(args, "plan_cache", None))
    rng = np.random.default_rng(0)
    n = csr.num_rows
    B = jnp.asarray(rng.standard_normal((n, L)).astype(dtype))

    from sparsela.ops.reorder import ReorderedPlan

    if isinstance(A, ReorderedPlan):
        # Solve the whole comparison in the permuted space: iteration
        # counts and error histories are permutation-invariant, and
        # preconditioner QUALITY is not — IC(0) factored on the
        # RCM-recovered order beats the scrambled order (measured
        # 40 -> 29 PCG iters on a scrambled lap2d-32), the classic
        # reordering-for-incomplete-factorization effect.
        from sparsela.ops.reorder import permute_symmetric

        perm = np.asarray(A.perm).astype(np.int64)
        csr = permute_symmetric(csr, perm)
        B = B[jnp.asarray(perm)]
        A = A.inner

    outdir = args.output or "data/error_data"
    os.makedirs(outdir, exist_ok=True)
    results = {}

    def record(solver_name, make_fn, prep_s=0.0, flops_per_iter=0.0):
        # reference methodology: warmup run (includes jit compile), then
        # min-of-reps timing (no_pretreatment.hpp:232-255).
        # ``make_fn(max_iters, tolerance)`` returns the no-arg jitted
        # solve — parameterized so --device_rate can pin the trip count.
        fn = make_fn(args.max_iters, args.tolerance)
        res = fn()
        iters = int(res.iterations)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = fn()
            int(res.iterations)  # sync
            times.append(time.perf_counter() - t0)
        t = min(times)
        hist = np.asarray(res.history)[:iters]
        csv = os.path.join(outdir, f"{name}_{solver_name}_errors.csv")
        with open(csv, "w") as f:
            f.write("iteration,max_relative_error\n")
            for i, e in enumerate(hist):
                f.write(f"{i},{e}\n")
        results[solver_name] = dict(
            iters=iters, solve_ms=t * 1e3, prep_ms=prep_s * 1e3,
            converged=bool(np.all(np.asarray(res.converged))),
        )
        if not args.quiet:
            print(f"{name} {solver_name}: {iters} iters, "
                  f"prep {prep_s*1e3:.1f} ms, solve {t*1e3:.1f} ms, "
                  f"converged={results[solver_name]['converged']}")
        if getattr(args, "device_rate", False) and flops_per_iter:
            per = _solver_iter_time(lambda M: make_fn(M, 0.0))
            results[solver_name].update(
                dev_iter_us=per * 1e6,
                dev_gflops=models.gflops(flops_per_iter, per),
            )
            if not args.quiet:
                print(f"{name} {solver_name} iteration rate: "
                      f"{per*1e6:.1f} us/iter, "
                      f"{results[solver_name]['dev_gflops']:.1f} GFLOP/s")

    # jit each solver once per matrix: one dispatch per solve
    import jax

    record("cg",
           lambda M, tol: functools.partial(
               jax.jit(lambda B: cg_solve_multi(
                   A, B, max_iters=M, tolerance=tol)), B),
           flops_per_iter=(2.0 * csr.nnz + 10.0 * csr.num_rows) * L)

    # Preconditioner failures skip the dependent solver, mirroring the
    # reference drivers (cpu_multicg.cpp:226-230, 275-279).
    try:
        t0 = time.perf_counter()
        Lfac = ic0_factorize(csr)
        # dtype: the factor is fp64 (host factorization); cast to the
        # bench dtype so fp32 runs don't plan fp64 sweep SpMMs
        prec = make_ic0_preconditioner(Lfac, sweeps=args.jacobi_sweeps,
                                       num_rhs=L, dtype=dtype)
        prep = time.perf_counter() - t0
        record("pcg_ic0",
               lambda M, tol: functools.partial(
                   jax.jit(lambda B: pcg_solve_multi(
                       A, B, prec, max_iters=M, tolerance=tol)), B),
               prep,
               flops_per_iter=(2.0 * csr.nnz + 4.0 * Lfac.nnz
                               + 12.0 * csr.num_rows) * L)
    except RuntimeError as e:
        results["pcg_ic0"] = dict(skipped=str(e))
        if not args.quiet:
            print(f"{name} pcg_ic0: SKIPPED ({e})")

    try:
        t0 = time.perf_counter()
        # no --spai_cap: the construction-time hub auto-guard decides
        # (precond.spai SPAI_GUARD_CELLS); --spai_uncapped restores
        # the reference's literal uncapped pattern
        cap = getattr(args, "spai_cap", None)
        if cap is None:
            cap = None if getattr(args, "spai_uncapped", False) \
                else "auto"
        M = spai_inverse(csr, cap=cap)
        Md, _ = _plan(M.astype(dtype), args.strategy or "auto", dtype,
                      L=L)
        prep = time.perf_counter() - t0
        record("spai_cg",
               lambda M_, tol: functools.partial(
                   jax.jit(lambda B: spai_cg_solve_multi(
                       A, Md, B, max_iters=M_, tolerance=tol)), B),
               prep,
               flops_per_iter=(4.0 * csr.nnz + 12.0 * csr.num_rows) * L)
    except RuntimeError as e:
        results["spai_cg"] = dict(skipped=str(e))
        if not args.quiet:
            print(f"{name} spai_cg: SKIPPED ({e})")

    if args.quiet:
        print(json.dumps({"matrix": name, "kernel": kind, **results}))
    return results


def _stats_row(csr, name) -> str:
    st = csr.stats()
    return (f"{name},{st.num_rows},{st.num_cols},{st.nnz},"
            f"{st.row_length_mean},{st.row_length_std},"
            f"{st.row_length_cv},{st.row_length_skew},"
            f"{st.row_length_max}")


def cmd_stats(args):
    """matrix_stats tool parity (verification/matrix_stats). With
    --dir, sweeps every .mtx under the directory into a CSV (parity:
    matrix_stats.cpp:18-70 iterates a directory)."""
    if args.dir:
        import glob

        from sparsela.io.market import read_market

        files = sorted(glob.glob(os.path.join(args.dir, "**", "*.mtx"),
                                 recursive=True))
        out = open(args.output, "w") if args.output else None
        hdr = ("matrix,rows,cols,nnz,row_mean,row_std,row_cv,"
               "row_skew,row_max")
        print(hdr)
        if out:
            out.write(hdr + "\n")
        for f in files:
            try:
                csr = read_market(f).to_csr()
            except Exception as e:  # noqa: BLE001 — skip bad files
                print(f"# {os.path.basename(f)}: SKIP ({e})")
                continue
            row = _stats_row(csr, os.path.basename(f))
            print(row)
            if out:
                out.write(row + "\n")
        if out:
            out.close()
        return
    csr, name = _load_matrix(args)
    if args.quiet:
        print(_stats_row(csr, name))
    else:
        st = csr.stats()
        print(f"{name}: {st.display()}")
        bounds, counts = csr.degree_histogram()
        for b, c in zip(bounds, counts):
            if c:
                print(f"  degree <= {b}: {c}")


def cmd_precond(args):
    """Preconditioner comparison harness (parity:
    verification/precondition/preconditioner_benchmark.cpp:398-484):
    runs CG / PCG-IC(0) / SPAI-CG over a matrix set (--dir of .mtx
    files, or one built-in matrix source) and writes the
    preprocess/solve/total/speedup-vs-CG summary CSV via
    analysis.plots.plot_precond_summary."""
    from sparsela.analysis.plots import plot_precond_summary

    runs = []
    if args.dir:
        import glob

        files = sorted(glob.glob(os.path.join(args.dir, "**", "*.mtx"),
                                 recursive=True))
        for f in files:
            sub = argparse.Namespace(**vars(args))
            sub.mtx = f
            sub.quiet = True
            runs.append(sub)
    else:
        sub = argparse.Namespace(**vars(args))
        sub.quiet = True
        runs.append(sub)

    results = {}
    for sub in runs:
        sub.output = None  # error CSVs go to the default dir
        try:
            _, name = _load_matrix(sub)
            results[name] = cmd_multicg(sub)
        except Exception as e:  # noqa: BLE001 — skip bad matrices
            print(f"# {getattr(sub, 'mtx', '?')}: SKIP ({e})")
    outdir = args.output or "data/precond"
    os.makedirs(outdir, exist_ok=True)
    out_csv = os.path.join(outdir, "precond_summary.csv")
    plot_precond_summary(results, out_csv)
    if not args.quiet:
        with open(out_csv) as f:
            print(f.read().rstrip())
    return results


def cmd_axpy(args):
    """STREAM-like axpy microbenchmark (parity: axpy.cpp:37-99 — MKL
    daxpy vs memcpy vs scalar loop over sizes 2^2..2^17 doubles;
    here: fused jnp axpy vs copy, per-size effective GB/s)."""
    import jax.numpy as jnp

    dtype = jnp.float32 if args.fp32 else jnp.float64
    print("size_elems,op,ms,gbs")
    for p2 in range(8, 25, 2):
        n = 2 ** p2
        x = jnp.ones((n,), dtype)
        y = jnp.ones((n,), dtype)
        # byte accounting from the ACTUAL device dtype: requesting f64
        # without x64 silently yields f32 arrays, and assuming 8-byte
        # elements would overstate GB/s 2x (round-1 bug).
        nbytes = int(np.dtype(x.dtype).itemsize)

        per = _time_op(args, lambda v, u: v + 2.5 * u, y, x)
        gbs = 3 * n * nbytes / per / 1e9
        print(f"{n},axpy,{per*1e3:.4f},{gbs:.1f}")
        per = _time_op(args, lambda v: v + 1.0, y)
        gbs = 2 * n * nbytes / per / 1e9
        print(f"{n},copy,{per*1e3:.4f},{gbs:.1f}")


def cmd_efficiency(args):
    """Multi-device scaling study (parity: verification/efficiency/
    parallel_efficiency.cpp:293-395 — thread counts become device
    counts): times the FULL jitted sharded multi-RHS CG solve
    (parallel.solvers.cg_solve_multi_sharded, one device dispatch for
    the whole while_loop) over 1..D devices and emits
    speedup/efficiency CSV + plot. fp32 row-sharded CSR."""
    import jax
    import jax.numpy as jnp

    from sparsela.parallel import sharded as sh
    from sparsela.parallel.solvers import cg_solve_multi_sharded

    csr, name = _load_matrix(args)
    L = args.num_vectors
    rng = np.random.default_rng(0)
    B = rng.standard_normal((csr.num_rows, L)).astype(np.float32)
    # fixed iteration budget: tolerance=0 never converges, so every
    # device count does exactly `iters` iterations of identical work
    iters = max(min(args.max_iters // 10, 200), 20)

    devs = jax.devices()
    counts = [d for d in (1, 2, 4, 8, 16) if d <= len(devs)]
    times = []
    csr = csr.astype(np.float32)
    for nd in counts:
        mesh = sh.make_mesh(nd)
        st = sh.shard_csr(csr, nd)
        std = sh.device_put_sharded(st, mesh)
        Bp = sh.to_padded_layout(B, st)
        solve = lambda: cg_solve_multi_sharded(
            std, Bp, mesh, max_iters=iters, tolerance=0.0,
            record_history=False,
        )
        res = solve()  # compile + warm
        float(jnp.sum(res.residual))
        t0 = time.perf_counter()
        res = solve()
        float(jnp.sum(res.residual))
        t = (time.perf_counter() - t0) / iters
        times.append(t)
        if not args.quiet:
            print(f"{name} devices={nd}: {t*1e3:.3f} ms/step "
                  f"({iters} jitted iters), "
                  f"speedup {times[0]/t:.2f}, "
                  f"efficiency {times[0]/t/nd:.2f}")
    out = args.output or "data/efficiency"
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}_efficiency.csv"), "w") as f:
        f.write("devices,ms_per_step,speedup,efficiency\n")
        for nd, t in zip(counts, times):
            f.write(f"{nd},{t*1e3:.4f},{times[0]/t:.3f},"
                    f"{times[0]/t/nd:.3f}\n")
    try:
        from sparsela.analysis.plots import plot_efficiency

        plot_efficiency(counts, times,
                        os.path.join(out, f"{name}_efficiency.png"))
    except Exception as e:  # noqa: BLE001 — plotting is best-effort
        print(f"plot failed: {e}")
    return list(zip(counts, times))


def cmd_sweep(args):
    """RHS-count sweep (eval_vectors.sh parity: L in 1..1024)."""
    Ls = [int(v) for v in args.vector_counts.split(",")]
    if not args.quiet:
        print("matrix,kernel,L,nnz,ms,gflops,check")
    for L in Ls:
        sub = argparse.Namespace(**vars(args))
        sub.num_vectors = L
        sub.quiet = True
        cmd_spmm(sub)


def build_parser():
    p = argparse.ArgumentParser(prog="sparsela.bench.run")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--mtx")
        sp.add_argument("--real", metavar="NAME",
                        help="SuiteSparse-collection matrix "
                             "reconstructed offline (io.realmats; "
                             "e.g. Trefethen_2000, gr_30_30, karate)")
        sp.add_argument("--grid2d", type=int)
        sp.add_argument("--grid3d", type=int)
        sp.add_argument("--wheel", type=int)
        sp.add_argument("--dense", type=int)
        sp.add_argument("--lap2d", type=int)
        sp.add_argument("--lap3d", type=int)
        sp.add_argument("--spd", type=int)
        sp.add_argument("--rmat", type=int, metavar="SCALE",
                        help="R-MAT power-law graph, 2^SCALE vertices")
        sp.add_argument("--rmat_ef", type=int, default=16,
                        metavar="EDGES",
                        help="R-MAT edge factor (edges per vertex, "
                             "default 16)")
        sp.add_argument("--rmat_spd", type=int, metavar="SCALE",
                        help="SPD R-MAT variant (solver drivers)")
        sp.add_argument("--fem", type=int, metavar="N",
                        help="P1 FEM stiffness on a random Delaunay "
                             "triangulation, N nodes (SPD, irregular "
                             "bandwidth — the SuiteSparse bcsstk class)")
        sp.add_argument("--varcoef", type=int, metavar="W",
                        help="variable-coefficient SPD diffusion "
                             "stencil on a W^3 grid (27-point; "
                             "lognormal edge conductivities — the "
                             "plane-stream-bound class)")
        sp.add_argument("--varcoef_axis", action="store_true",
                        help="7-point (axis-neighbor) variant")
        sp.add_argument("--varcoef_sigma", type=float, default=1.0,
                        help="coefficient contrast exp(sigma*N(0,1))")
        sp.add_argument("--varcoef_shift", type=float, default=1.0,
                        help="diagonal shift (1.0 models an implicit-"
                             "timestep operator I + dt*L; small "
                             "shifts are the ill-conditioned regime)")
        sp.add_argument("--fp32", action="store_true")
        sp.add_argument("--fp64", action="store_true")
        sp.add_argument("--alpha", type=float, default=1.0)
        sp.add_argument("--beta", type=float, default=0.0)
        sp.add_argument("--quiet", action="store_true")
        sp.add_argument("--strategy")
        sp.add_argument("--plan_cache", metavar="DIR",
                        help="content-keyed on-disk plan cache "
                             "(io.plans): the first run per matrix "
                             "builds and saves the plan, later "
                             "runs load it and skip planning")
        sp.add_argument("--reorder", choices=["rcm", "degree", "auto"],
                        help="symmetric pre-order (ops.reorder; the "
                             "reference's InitCsrRelabel capability): "
                             "'rcm' bandwidth recovery, 'degree' "
                             "hot-column clustering, 'auto' applies "
                             "RCM when it cuts the bandwidth to a "
                             "quarter")
        sp.add_argument("--num_vectors", type=int, default=32)
        sp.add_argument("--max_iters", type=int, default=10000)
        sp.add_argument("--tolerance", type=float, default=1e-5)
        sp.add_argument("--jacobi_sweeps", type=int, default=2)
        sp.add_argument("--spai_cap", type=int, metavar="K",
                        help="bound the SPAI pattern to the K largest-"
                             "|v| entries per row (+diagonal); required "
                             "in practice on power-law matrices (hub "
                             "columns otherwise yield degree^2-row "
                             "dense QR problems). Default: the hub "
                             "auto-guard caps at 16 only when a padded "
                             "problem exceeds the guard size")
        sp.add_argument("--spai_uncapped", action="store_true",
                        help="strict reference parity: disable the SPAI "
                             "hub auto-guard (uncapped pattern, "
                             "sparse_approximate_inversion.hpp:41-321) "
                             "— minutes-to-hours on power-law hubs")
        sp.add_argument("--timing_iters", "--i", type=int, default=0,
                        help="timed repetitions per row (default 20)")
        sp.add_argument("--col_major_input", action="store_true",
                        help="RHS arrives (L, n) and is transposed in "
                        "(reference g_input_row_major=false)")
        sp.add_argument("--profile", metavar="DIR",
                        help="capture a jax.profiler device trace of "
                        "the run into DIR")
        sp.add_argument("--refined", action="store_true",
                        help="cg: fp64-accurate solves via mixed-"
                        "precision iterative refinement")
        sp.add_argument("--bf16", action="store_true",
                        help="cg: same-process A/B of plain f32 CG vs "
                        "the residual-replacement bf16-plane CG "
                        "(solvers.refine.cg_solve_bf16) at equal "
                        "verified tolerance; fp32, diagonal-"
                        "structured matrices only")
        sp.add_argument("--device_rate", action="store_true",
                        help="cg/multicg: also report the per-iteration "
                        "rate of a solve pinned to a fixed trip count")
        sp.add_argument("--dir", help="sweep every .mtx in a directory")
        sp.add_argument("--output")

    for name, fn in [("spmv", cmd_spmv), ("spmm", cmd_spmm),
                     ("cg", cmd_cg), ("multicg", cmd_multicg),
                     ("stats", cmd_stats), ("sweep", cmd_sweep),
                     ("axpy", cmd_axpy),
                     ("efficiency", cmd_efficiency),
                     ("precond", cmd_precond)]:
        sp = sub.add_parser(name)
        add_common(sp)
        if name == "sweep":
            sp.add_argument("--vector_counts",
                            default="1,2,4,8,16,32,64,128")
        sp.set_defaults(fn=fn)
    return p


def main(argv=None):
    # The reference drivers are fp64-default (cpu_spmv.cpp:979-986) and
    # golden-check every run; without x64 the default mode silently
    # downcasts to f32 on device and FAILS its own check.
    import jax

    from sparsela.utils.device import device_info, enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    args = build_parser().parse_args(argv)
    info = device_info()
    print(f"# device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", file=sys.stderr)
    if getattr(args, "profile", None):
        # the analogue of the reference's timer instrumentation
        # (utils.h:531-654): a device trace of the whole run
        with jax.profiler.trace(args.profile):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
