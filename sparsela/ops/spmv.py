"""Public SpMV / SpMM ops with strategy dispatch.

The reference exposes three CPU work-decomposition strategies plus an
MKL baseline, selected by the ``SpmmKernel`` enum
(``work_2025/types.hpp:11-16``: SIMPLE / MERGE /
NONZERO_SPLIT) and benchmarked against each other
(``cpu_spmv.cpp:750-923``). On the GPU the work decomposition of a
general CSR product lives inside the library that runs it, so the
strategy set names routes, not decompositions:

  REFERENCE — plain XLA gather + ``segment_sum`` (the golden model).
  CUSPARSE  — ``jax.experimental.sparse.CSR``: ``csr_matvec`` /
              ``csr_matmat`` lower to cuSPARSE on CUDA for f32 and f64
              (the vendor baseline, as MKL is the reference's).
  BCOO      — ``jax.experimental.sparse.BCOO``; lowers to XLA's
              generic gather/scatter unless ``jax_bcoo_cusparse_lowering``
              is set, which this package does not set.
  BSR       — blocked CSR, dense panels contracted by ``einsum``
              (``ops.bsr``; the reference's BCSR format).
  DIA       — diagonal planes as shifted FMAs (``ops.dia``); the
              scattered remainder, if any, rides a CSR plan.
  AUTO      — DIA when the diagonals carry the matrix; BSR for dense
              block structure at wide RHS blocks; else the general CSR
              route :data:`AUTO_CSR`.

fp64 is IEEE f64 on every route.

``plan_kind`` names a plan's family (CLI row labels);
``plan_semantics`` tags its numeric semantics (f32 / ieee-f64 /
bf16-plane).

``plan_matrix`` builds the device operand for a host CsrMatrix under a
strategy; ``spmv``/``spmm`` dispatch on the operand type.
"""

from __future__ import annotations

import enum
import warnings

import numpy as np

from sparsela.formats.csr import CsrMatrix
from sparsela.ops import reference as ref


class SpmvStrategy(enum.Enum):
    REFERENCE = "reference"
    CUSPARSE = "cusparse"
    BCOO = "bcoo"
    BSR = "bsr"
    DIA = "dia"
    AUTO = "auto"

    @classmethod
    def parse(cls, s) -> "SpmvStrategy":
        if isinstance(s, cls):
            return s
        s = str(s).lower()
        if s in _RETIRED:
            raise ValueError(
                f"strategy {s!r} named a decomposition the GPU routes do "
                "not expose; use 'auto', 'cusparse' (general CSR) or "
                "'reference' (plain XLA)")
        aliases = {
            # the reference's vendor baseline is MKL
            # (cpu_spmv.cpp:631-664); on this platform it is cuSPARSE
            "mkl": "cusparse",
            "csr": "cusparse",
            "hybrid": "dia",
        }
        return cls(aliases.get(s, s))


# Reference work decompositions (work_2025/types.hpp) and removed plan
# families: explicit requests raise with guidance instead of silently
# running another route under the old name.
_RETIRED = frozenset({"simple", "merge", "nonzero_split", "row_split",
                      "ell", "nmajor"})

# The general CSR route AUTO takes for matrices without diagonal
# structure (chosen by measurement on the card, PERF.md).
AUTO_CSR = "cusparse"

# AUTO moves to the DIA/hybrid path only when the selected diagonals
# carry at least this fraction of the nonzeros (below it the extra
# partial-product writeback isn't worth the peel).
DIA_MIN_COVERAGE = 0.3

# Block shape of strategy='bsr' plans.
BSR_BLOCK = (8, 128)
# AUTO takes BSR when the BSR_BLOCK blocking wastes little
# (formats.bcsr.fill_estimate >= BSR_MIN_FILL) and the RHS block is at
# least BSR_MIN_L wide: on dense 8x128 blocks the batched einsum beat
# cuSPARSE SpMM 2.6-3.2x at L = 4..32, while at L=1 cuSPARSE's CSR
# SpMV won 1.5x (PERF.md route table; L=2 not measured).
BSR_MIN_FILL = 0.3
BSR_MIN_L = 4


def plan_matrix(csr, strategy="auto", dtype=None, L: int = 1,
                reorder=None, _allow_dia: bool = True):
    """Build the device operand for a host CsrMatrix.

    ``reorder``: None (default) plans in the native order; ``'rcm'``
    plans on the RCM-permuted matrix (ops.reorder — the reference's
    ``InitCsrRelabel`` capability, ``sparse_matrix.h:184-207``);
    ``'degree'`` clusters hot columns first; ``'auto'`` permutes only
    when RCM recovers a banded form.

    AUTO policy (any dtype): DIA/hybrid when the dense diagonals carry
    at least :data:`DIA_MIN_COVERAGE` of the nonzeros; BSR when the
    pattern is block-dense and ``L >= BSR_MIN_L``; otherwise the
    general CSR route :data:`AUTO_CSR`."""
    if reorder:
        from sparsela.ops.reorder import plan_reorder

        return plan_reorder(csr, strategy=strategy, dtype=dtype, L=L,
                            order=reorder)
    strategy = SpmvStrategy.parse(strategy)
    if dtype is None:
        dtype = np.asarray(csr.values).dtype
    if strategy == SpmvStrategy.BCOO:
        return ref.to_bcoo(csr, dtype=dtype)
    if _allow_dia and strategy in (SpmvStrategy.AUTO, SpmvStrategy.DIA):
        plan = _try_plan_dia(csr, strategy, dtype)
        if plan is not None:
            return plan
    if strategy == SpmvStrategy.AUTO and L >= BSR_MIN_L:
        from sparsela.formats.bcsr import fill_estimate

        if fill_estimate(csr, *BSR_BLOCK) >= BSR_MIN_FILL:
            strategy = SpmvStrategy.BSR
    if strategy == SpmvStrategy.BSR:
        from sparsela.formats.bcsr import BcsrMatrix

        return BcsrMatrix.from_csr(csr, *BSR_BLOCK).to_device(dtype=dtype)
    if strategy not in (SpmvStrategy.REFERENCE, SpmvStrategy.CUSPARSE):
        strategy = SpmvStrategy(AUTO_CSR)
    if strategy == SpmvStrategy.REFERENCE:
        return csr.to_device(dtype=dtype)
    return ref.to_cusparse(csr, dtype=dtype)


def _try_plan_dia(csr, strategy, dtype):
    """DIA / hybrid plan, or None when the matrix has no diagonal
    structure worth peeling (explicit strategy='dia' skips the
    coverage gate but still returns None with zero usable diagonals)."""
    from sparsela.formats.dia import (
        diagonal_profile,
        partition_dia,
        select_diagonals,
        to_device_dia,
    )
    from sparsela.ops.hybrid import HybridPlan

    if csr.nnz == 0:
        return None
    offsets = select_diagonals(csr)
    if offsets.size == 0:
        return None
    all_off, counts, _ = diagonal_profile(csr)
    covered = int(counts[np.isin(all_off, offsets)].sum())
    if (strategy != SpmvStrategy.DIA
            and covered < DIA_MIN_COVERAGE * csr.nnz):
        return None
    dia_host, rest = partition_dia(csr, offsets)
    dev = to_device_dia(dia_host, dtype=dtype)
    rest_plan = None
    if rest.nnz > 0:
        rest_plan = plan_matrix(rest, strategy="auto", dtype=dtype,
                                _allow_dia=False)
    return HybridPlan(dev, rest_plan, csr.nnz)


def plan_dia_bf16(csr, L: int = 1):
    """OPT-IN bf16-plane DIA plan — the inner operator of the
    bf16-plane solves (``solvers/refine.py``, ``cg_solve_bf16``). NEVER
    an AUTO choice: the planes are stored bf16, perturbing the operator
    ~4e-3 relative (bf16 eps = 2^-8), so standalone SpMV results are
    approximate — the supported use is CG iterations whose error an
    exact f32 residual corrects. Arithmetic runs in f32.

    Why it pays: variable-coefficient diagonal operators (the
    SuiteSparse FD/FEM reality the constant-coefficient fixtures
    idealize — ``make_variable_stencil`` vs ``InitGrid2d/3d``,
    ``sparse_matrix.h:458-623``) are plane-stream-bound at L=1: a
    27-point stencil reads 108 B/row of f32 planes against ~12 B/row
    of x/y traffic. bf16 planes halve the dominant term.

    Requires diagonal structure and a square matrix. The scattered
    remainder (if any) stays EXACT f32. Raises with guidance otherwise."""
    from sparsela.formats.dia import (
        maskable,
        partition_dia,
        select_diagonals,
        to_device_dia,
    )
    from sparsela.ops.hybrid import HybridPlan

    if csr.num_rows != csr.num_cols:
        raise ValueError("plan_dia_bf16: square matrices only")
    offsets = select_diagonals(csr)
    if offsets.size == 0:
        raise ValueError(
            "plan_dia_bf16: no dense diagonals selected — the bf16-"
            "plane plan needs a diagonal-structured operator")
    dia_host, rest = partition_dia(csr, offsets)
    if maskable(dia_host):
        warnings.warn(
            "plan_dia_bf16: operator is constant-coefficient — the "
            "exact masked plan (strategy='dia') reads 4 B/row and "
            "beats bf16 value planes; proceeding as requested",
            stacklevel=2)
    import jax.numpy as jnp

    dev = to_device_dia(dia_host, dtype=np.float32,
                        plane_dtype=jnp.bfloat16)
    rest_plan = None
    if rest.nnz > 0:
        rest_plan = plan_matrix(rest, strategy="auto",
                                dtype=np.float32, L=L,
                                _allow_dia=False)
    return HybridPlan(dev, rest_plan, csr.nnz)


def plan_kind(A) -> str:
    """Canonical short name of a plan's family (the CLI row label; the
    reference prints its kernel enum name per benchmark row,
    ``cpu_spmv.cpp:750-923``). Single source of truth — the CLI and
    the real-matrix battery both use it."""
    import jax.experimental.sparse as jsparse

    from sparsela.formats.bcsr import BcsrMatrix
    from sparsela.ops.hybrid import HybridPlan
    from sparsela.ops.reorder import ReorderedPlan

    if isinstance(A, ReorderedPlan):
        return A.order + "+" + plan_kind(A.inner)
    if isinstance(A, HybridPlan):
        if A.dia.masked:
            tag = "dia_masked"
        elif _bf16_planes(A.dia):
            tag = "dia_bf16"
        else:
            tag = "dia"
        return tag if A.rest is None else "hybrid_" + tag
    if isinstance(A, CsrMatrix):
        return "reference"
    if isinstance(A, jsparse.CSR):
        return "cusparse"
    if isinstance(A, jsparse.BCOO):
        return "bcoo"
    if isinstance(A, BcsrMatrix):
        return "bsr"
    raise TypeError(f"not a plan: {type(A).__name__}")


def plan_semantics(A) -> str:
    """Numeric semantics a plan delivers: ``'f32'``, ``'ieee-f64'``,
    or ``'bf16-plane(~4e-3)'`` (the opt-in bf16-plane operator). The
    reference's default driver mode is fp64 (``cpu_spmv.cpp:979-986``);
    this tag makes visible which semantics each strategy row ran."""
    from sparsela.ops.hybrid import HybridPlan
    from sparsela.ops.reorder import ReorderedPlan

    if isinstance(A, ReorderedPlan):
        return plan_semantics(A.inner)
    if isinstance(A, HybridPlan):
        parts = {plan_semantics(A.dia)}
        if A.rest is not None:
            parts.add(plan_semantics(A.rest))
        for tag in ("ieee-f64", "bf16-plane(~4e-3)"):
            if tag in parts:
                return tag
        return "f32"
    if _bf16_planes(A):
        return "bf16-plane(~4e-3)"
    return "ieee-f64" if np.dtype(A.dtype).itemsize > 4 else "f32"


def _bf16_planes(A) -> bool:
    """True for a DiaDevice whose value planes are stored bf16."""
    import jax.numpy as jnp

    from sparsela.formats.dia import DiaDevice

    return (isinstance(A, DiaDevice) and not A.masked
            and A.data.dtype == jnp.bfloat16)


def _scale(y_new, alpha, beta, y):
    if beta == 0.0 or y is None:
        return alpha * y_new
    return alpha * y_new + beta * y


def spmv(A, x, alpha=1.0, beta=0.0, y=None, strategy="auto"):
    """y = alpha * A @ x + beta * y.

    ``A`` is any plan ``plan_matrix`` returns; dispatch is on its type
    (``strategy`` is validated and otherwise ignored — the plan already
    fixed the route)."""
    SpmvStrategy.parse(strategy)
    import jax.experimental.sparse as jsparse

    from sparsela.formats.bcsr import BcsrMatrix
    from sparsela.formats.dia import DiaDevice
    from sparsela.ops.hybrid import HybridPlan, spmv_hybrid
    from sparsela.ops.reorder import ReorderedPlan

    if isinstance(A, ReorderedPlan):
        y_new = A.apply_inv(spmv(A.inner, A.apply_perm(x), alpha=alpha))
        return y_new if beta == 0.0 or y is None else y_new + beta * y
    if isinstance(A, HybridPlan):
        return spmv_hybrid(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, DiaDevice):
        from sparsela.ops.dia import spmv_dia

        return spmv_dia(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, CsrMatrix):
        return ref.spmv_reference(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, (jsparse.CSR, jsparse.BCOO)):
        return _scale(A @ x.astype(A.dtype), alpha, beta, y)
    if isinstance(A, BcsrMatrix):
        from sparsela.ops.bsr import bsr_matmat

        return _scale(bsr_matmat(A, x[:, None])[:, 0], alpha, beta, y)
    raise TypeError(f"not a plan: {type(A).__name__}")


def spmm(A, X, alpha=1.0, beta=0.0, Y=None, strategy="auto"):
    """Y = alpha * A @ X + beta * Y, X of shape (num_cols, L)."""
    SpmvStrategy.parse(strategy)
    import jax.experimental.sparse as jsparse

    from sparsela.formats.bcsr import BcsrMatrix
    from sparsela.formats.dia import DiaDevice
    from sparsela.ops.hybrid import HybridPlan, spmm_hybrid
    from sparsela.ops.reorder import ReorderedPlan

    if isinstance(A, ReorderedPlan):
        Y_new = A.apply_inv(spmm(A.inner, A.apply_perm(X), alpha=alpha))
        return Y_new if beta == 0.0 or Y is None else Y_new + beta * Y
    if isinstance(A, HybridPlan):
        return spmm_hybrid(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, DiaDevice):
        from sparsela.ops.dia import spmm_dia

        return spmm_dia(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, CsrMatrix):
        return ref.spmm_reference(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, (jsparse.CSR, jsparse.BCOO)):
        return _scale(A @ X.astype(A.dtype), alpha, beta, Y)
    if isinstance(A, BcsrMatrix):
        from sparsela.ops.bsr import bsr_matmat

        return _scale(bsr_matmat(A, X), alpha, beta, Y)
    raise TypeError(f"not a plan: {type(A).__name__}")
