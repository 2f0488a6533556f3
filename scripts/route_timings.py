"""Time every SpMV/SpMM route on the card against a copy measured in
the same process — the measurements behind PERF.md's per-route
decision table. Needs a GPU.

    python scripts/route_timings.py                 # real sizes
    python scripts/route_timings.py --small         # quick compile check
    python scripts/route_timings.py --out rows.jsonl  # also append rows

Each row gives two times for the same jitted call (the plan is a jit
operand, never a compiled constant):

* ``host_s`` — host clock around one call ending in
  ``block_until_ready``, median of 20 warm calls (spread: ``iqr_s``).
  It contains the dispatch and synchronisation of one call, which is
  as long as the kernels themselves below ~1 ms.
* ``device_s`` — device busy time per call from a profiler trace of 20
  warm calls (``bench.trace.device_time``).

Shares of the copy rate compare like with like: device time against
the copy's device time, host time against the copy's host time. One
JSON object per row on stdout, and appended to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes: compile and run every route once")
    ap.add_argument("--out", help="also append the JSON rows to this file")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from sparsela.bench import models
    from sparsela.bench.timing import time_fn
    from sparsela.bench.trace import device_time
    from sparsela.formats.dia import partition_dia, select_diagonals, \
        to_device_dia
    from sparsela.io import generators
    from sparsela.ops.hybrid import HybridPlan
    from sparsela.ops.spmv import plan_dia_bf16, plan_kind, plan_matrix, \
        spmm, spmv
    from sparsela.utils.device import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    info = require_gpu()
    gpu = gpu_name_and_power_limit()
    peak = models.peak(info["kind"])["hbm_gbs"]
    small = args.small
    nbytes_copy = 1 << (24 if small else 30)
    big = jnp.ones((nbytes_copy // 4,), jnp.float32)
    f_copy = jax.jit(lambda a: a + 1.0)
    copy_host = 2 * nbytes_copy / time_fn(f_copy, big).median_s / 1e9
    copy_dev = 2 * nbytes_copy / device_time(f_copy, big)["busy_s"] / 1e9
    del big
    out = open(args.out or os.devnull, "a")
    header = {"gpu": gpu, "device": info, "copy_gbs_host": copy_host,
              "copy_gbs_device": copy_dev, "peak_gbs": peak,
              "small": small}
    print(json.dumps(header), flush=True)
    out.write(json.dumps(header) + "\n")
    op_v, op_m = jax.jit(spmv), jax.jit(spmm)
    rng = np.random.default_rng(0)

    def row(matrix, route, A, nnz, nrows, nbytes, L=1,
            dtype=np.float32):
        ncols = A.shape[1] if hasattr(A, "shape") else nrows
        shape = (ncols,) if L == 1 else (ncols, L)
        v = jnp.asarray(rng.standard_normal(shape).astype(dtype))
        op = op_v if L == 1 else op_m
        t = time_fn(op, A, v)
        dev = device_time(op, A, v)["busy_s"]
        r = {"matrix": matrix, "route": route, "L": L,
             "dtype": np.dtype(dtype).name, "rows": nrows, "nnz": nnz,
             "host_s": t.median_s, "iqr_s": t.iqr_s, "device_s": dev,
             "gflops_device": models.gflops(models.spmv_flops(nnz, L),
                                            dev),
             "model_bytes": nbytes,
             "pct_copy_device": models.roofline_pct(nbytes, dev,
                                                    copy_dev),
             "pct_copy_host": models.roofline_pct(nbytes, t.median_s,
                                                  copy_host),
             "pct_peak_device": models.roofline_pct(nbytes, dev, peak)}
        print(json.dumps(r), flush=True)
        out.write(json.dumps(r) + "\n")
        out.flush()

    def csr_bytes(c, L, vb=4):
        return models.spmv_bytes(c.nnz, c.num_rows, L=L, value_bytes=vb)

    def general(name, c, Ls=(1, 16), routes=("cusparse", "reference")):
        for L in Ls:
            for route in routes:
                A = plan_matrix(c, strategy=route, dtype=np.float32, L=L)
                label = (route if route != "auto"
                         else "auto=" + plan_kind(A))
                row(name, label, A, c.nnz, c.num_rows, csr_bytes(c, L),
                    L)
                del A

    # --- stencil: DIA forms against the CSR routes
    w = 24 if small else 192
    lap = generators.make_laplacian_grid3d(w).to_csr()
    n = lap.num_rows
    name = f"lap3d-{w}"
    dia, _ = partition_dia(lap, select_diagonals(lap))
    K = len(dia.offsets)
    for L in (1, 16):
        A = plan_matrix(lap, dtype=np.float32)
        row(name, "dia_masked", A, lap.nnz, n,
            models.dia_masked_bytes(n, L), L)
        A = HybridPlan(to_device_dia(dia, dtype=np.float32, masked=False),
                       None, lap.nnz)
        row(name, "dia_planes", A, lap.nnz, n, models.dia_bytes(K, n, L),
            L)
        del A
    general(name, lap)
    for route in ("auto", "cusparse"):
        A = plan_matrix(lap, strategy=route, dtype=np.float64)
        nbytes = (models.dia_masked_bytes(n, 1, 8) if route == "auto"
                  else csr_bytes(lap, 1, 8))
        row(name, "dia_masked" if route == "auto" else route, A,
            lap.nnz, n, nbytes, 1, np.float64)
        del A

    # --- permutation: x[perm] on the stencil's row count
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    xv = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    f_perm = jax.jit(lambda v, p: v[p])
    t = time_fn(f_perm, xv, perm)
    dev = device_time(f_perm, xv, perm)["busy_s"]
    r = {"matrix": f"perm-{n}", "route": "x[perm]", "L": 1,
         "dtype": "float32", "host_s": t.median_s, "iqr_s": t.iqr_s,
         "device_s": dev, "model_bytes": 12 * n,
         "pct_copy_device": 100 * 12 * n / dev / 1e9 / copy_dev}
    print(json.dumps(r), flush=True)
    out.write(json.dumps(r) + "\n")
    del lap, dia

    # --- variable-coefficient stencil: f32 planes against bf16 planes
    w = 16 if small else 128
    var = generators.make_variable_stencil(w, dims=3, full=True,
                                           shift=1.0).to_csr()
    n = var.num_rows
    A = plan_matrix(var, dtype=np.float32)
    K = len(A.dia.offsets)
    row(f"varcoef-{w}", "dia_planes", A, var.nnz, n,
        models.dia_bytes(K, n), 1)
    A = plan_dia_bf16(var)
    row(f"varcoef-{w}", "dia_bf16", A, var.nnz, n,
        (2 * K + 8) * n, 1)
    del A, var

    # --- general matrices: cuSPARSE against the XLA reference route
    g = generators.make_rmat(10 if small else 21, edge_factor=16).to_csr()
    general(f"rmat-{10 if small else 21}", g)
    A = plan_matrix(g, strategy="bcoo", dtype=np.float32)
    row(f"rmat-{10 if small else 21}", "bcoo", A, g.nnz, g.num_rows,
        csr_bytes(g, 1), 1)
    del A, g
    pts = 3000 if small else 2_000_000
    fem = generators.make_fem2d(pts).to_csr()
    general(f"fem2d-{pts}", fem)
    del fem

    # --- block-structured: the BSR route against the CSR routes
    grid = 40 if small else 6000
    blk = generators.make_block_random(grid, blocks_per_row=4).to_csr()
    general(f"block-random-{grid}", blk, Ls=(1, 4, 8, 16, 32),
            routes=("auto", "bsr", "cusparse"))
    out.close()


if __name__ == "__main__":
    main()
