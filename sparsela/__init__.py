"""sparsela — sparse linear algebra in JAX for one or four GPUs.

A library with the capabilities of the Merrill–Garland merge-based CSR
SpMV benchmark suite (YuyaW-0118/Sparse-Matrix-Linear-Equations):
Matrix Market / SuiteSparse ingestion, COO/CSR/BCSR/DIA formats,
SpMV/SpMM through XLA and cuSPARSE, single- and multi-RHS conjugate
gradient solvers with IC(0) and SPAI preconditioning, and a
benchmark/verification harness.

Layering (mirrors the reference's L4→L9 stack):

    formats/   COO, CSR, BCSR, DIA                (ref: sparse_matrix.h)
    io/        .mtx parser, generators, fetch     (ref: sparse_matrix.h, get_uf_datasets.sh)
    ops/       spmv/spmm routes, BLAS-1 ops       (ref: work_2025/spmm, cg/utils_multiple.hpp;
                                                   cub/agent + cub/device kernels)
    solvers/   CG / PCG / SPAI-CG                 (ref: work_2025/main, work_2025/cg)
    precond/   IC(0), SPAI, triangular solves     (ref: work_2025/cg/*decomp*.hpp)
    parallel/  multi-device sharding (shard_map)  (beyond-reference capability)
    bench/     timing, flop/byte models, sweeps   (ref: cpu_*.cpp drivers, eval_*.sh)
    analysis/  plots and result pivots            (ref: verification/**/*.py)
"""

__version__ = "0.1.0"

from sparsela.formats.coo import CooMatrix
from sparsela.formats.csr import CsrMatrix
from sparsela.formats.bcsr import BcsrMatrix
from sparsela.io.market import read_market, write_market
from sparsela.io.generators import (
    make_dense,
    make_wheel,
    make_grid2d,
    make_grid3d,
    make_random_spd,
)
from sparsela.ops.spmv import spmv, spmm, plan_matrix, SpmvStrategy
from sparsela.solvers.cg import cg_solve, cg_solve_multi
from sparsela.solvers.pcg import pcg_solve_multi, make_ic0_preconditioner
from sparsela.solvers.spai_cg import spai_cg_solve_multi
from sparsela.solvers.refine import cg_solve_refined, cg_solve_multi_refined
from sparsela.solvers.implicit import make_cg_solver, make_cg_solver_multi
from sparsela.precond.ic0 import ic0_factorize
from sparsela.precond.spai import spai_inverse
