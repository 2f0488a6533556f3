"""FLOP and byte models — metric definitions with reference parity —
and the device peak table.

Every formula cites its reference origin (see BASELINE.md):

  * SpMV GFLOP/s       = 2*nnz / t                  (cpu_spmv.cpp:725,733)
  * SpMM GFLOP/s       = 2*nnz*L / t                (cpu_spmm_v2.cpp:876,884)
  * effective GB/s     = (nnz*(2*sV+sO) + rows*L*(sO+sV)) / t
                                                    (cpu_spmv.cpp:721-727)
  * CG GFLOP/s         = (2*nnz + 10*n)*L*iters / t (cpu_multicg.cpp:176)
  * PCG-IC0 GFLOP/s    = (2*nnz + 4*nnz_L + 12*n)*L*iters / t
                                                    (cpu_multicg.cpp:240)
  * SPAI-CG GFLOP/s    = (4*nnz + 12*n)*L*iters / t (cpu_multicg.cpp:282)
"""

from __future__ import annotations


def spmv_flops(nnz: int, L: int = 1) -> float:
    return 2.0 * nnz * L


def spmv_bytes(nnz: int, rows: int, L: int = 1, value_bytes: int = 8,
               offset_bytes: int = 4) -> float:
    """Effective-bandwidth byte model (cpu_spmv.cpp:721-727): stream the
    values + column indices once, plus per-row offset and output."""
    return (
        nnz * (2 * value_bytes + offset_bytes)
        + rows * L * (offset_bytes + value_bytes)
    )


def dia_bytes(n_diags: int, rows: int, L: int = 1,
              value_bytes: int = 4) -> float:
    """Byte model for the DIA value-plane path: K value planes + x + y,
    each streamed once (no index traffic — offsets are static)."""
    return (n_diags + 2 * L) * rows * value_bytes


def dia_masked_bytes(rows: int, L: int = 1,
                     value_bytes: int = 4) -> float:
    """Byte model for the MASKED DIA path: the K value planes compress
    to one int32 bitmask word per row (constant-coefficient operators),
    so traffic is mask + x + y."""
    return 4 * rows + 2 * L * rows * value_bytes


def cg_flops(nnz: int, n: int, L: int, iters: int) -> float:
    return (2.0 * nnz + 10.0 * n) * L * iters


def pcg_ic0_flops(nnz: int, nnz_L: int, n: int, L: int, iters: int) -> float:
    return (2.0 * nnz + 4.0 * nnz_L + 12.0 * n) * L * iters


def spai_cg_flops(nnz: int, n: int, L: int, iters: int) -> float:
    return (4.0 * nnz + 12.0 * n) * L * iters


def gflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e9 if seconds > 0 else 0.0


def gbytes_per_s(nbytes: float, seconds: float) -> float:
    return nbytes / seconds / 1e9 if seconds > 0 else 0.0


# Published peaks by ``jax.devices()[0].device_kind``. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM part (80 GB HBM3 at 3.35 TB/s;
# rates assume the full 700 W power limit). A device missing here is
# an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "fp32_tflops": 67.0},
}


def peak(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; raises for a device the
    table does not hold."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add "
            "it to sparsela.bench.models.PEAKS with its source") from None


def roofline_pct(nbytes: float, seconds: float, ceiling_gbs: float
                 ) -> float:
    """Effective bandwidth as a percentage of ``ceiling_gbs`` — the
    bandwidth-bound SpMV quality metric (the SC'16 pipeline's claim,
    agent_spmv_orig.cuh:289-406). Pass the published peak or the copy
    rate measured in the same process."""
    if seconds <= 0:
        return 0.0
    return 100.0 * (nbytes / seconds / 1e9) / ceiling_gbs
