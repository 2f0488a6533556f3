"""Headline benchmark — prints ONE JSON line. Needs a GPU.

Metric: fp32 SpMV GFLOP/s on a 3-D Laplacian (lap3d-192: 7,077,888
rows, ~49M nnz — about 8x the card's 50 MB L2 as CSR, so the number
reads memory bandwidth, not cache) under the AUTO strategy planner —
the reference's headline metric (``cpu_spmv.cpp:725,733``: GFLOP/s =
2*nnz/t) with the planner free to pick the route, as the reference
driver reports its best benchmarked strategy (``cpu_spmv.cpp:750-923``).
For the stencil AUTO selects the masked DIA path; the general CSR route
(``strategy='cusparse'``) on the same matrix is reported alongside.

Timing: host clock around calls that end in ``block_until_ready``,
median of 20 warm calls (``sparsela.bench.timing``). Roofline shares
are given against the card's published bandwidth
(``bench/models.PEAKS``) and against a large copy measured in the same
process. Every result names the device, its power limit and the device
count; without a GPU the script fails instead of measuring the CPU.

``vs_baseline``: the reference publishes no numbers (BASELINE.md); the
denominator is the throughput its own byte model implies on its
i9-9980XE host (~80 GB/s at 20 B/nnz fp64 -> ~4 Gnnz/s -> 8 GFLOP/s).
"""

import json

import numpy as np

BASELINE_SPMV_GFLOPS = 8.0
WIDTH = 192


def main():
    import jax
    import jax.numpy as jnp

    from sparsela.bench import models
    from sparsela.bench.timing import copy_rate_gbs, time_fn
    from sparsela.io import generators
    from sparsela.ops.spmv import plan_kind, plan_matrix, spmv
    from sparsela.utils.device import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    enable_compile_cache()
    info = require_gpu()
    peak_gbs = models.peak(info["kind"])["hbm_gbs"]
    copy_gbs = copy_rate_gbs()

    csr = generators.make_laplacian_grid3d(WIDTH, dtype=np.float32).to_csr()
    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal(csr.num_cols).astype(np.float32))
    rows = {}
    op = jax.jit(spmv)  # the plan is an operand, not a compiled constant
    for strategy in ("auto", "cusparse"):
        A = plan_matrix(csr, strategy=strategy, dtype=np.float32)
        t = time_fn(op, A, x)
        kind = plan_kind(A)
        if kind == "dia_masked":
            nbytes = models.dia_masked_bytes(csr.num_rows)
        else:
            nbytes = models.spmv_bytes(csr.nnz, csr.num_rows,
                                       value_bytes=4)
        rows[strategy] = {
            "strategy": kind,
            "gflops": models.gflops(models.spmv_flops(csr.nnz),
                                    t.median_s),
            "median_s": t.median_s,
            "iqr_s": t.iqr_s,
            "pct_of_peak_bw": models.roofline_pct(nbytes, t.median_s,
                                                  peak_gbs),
            "pct_of_copy": models.roofline_pct(nbytes, t.median_s,
                                               copy_gbs),
        }
        del A
    auto = rows["auto"]
    print(json.dumps({
        "metric": "spmv_fp32_auto_gflops",
        "value": auto["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": auto["gflops"] / BASELINE_SPMV_GFLOPS,
        "matrix": f"lap3d_{WIDTH}",
        "rows": csr.num_rows,
        "nnz": csr.nnz,
        "auto": auto,
        "general_csr": rows["cusparse"],
        "copy_gbs": copy_gbs,
        "device": info,
        "gpu": gpu_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
