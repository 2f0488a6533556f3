from sparsela.solvers.cg import cg_solve, cg_solve_multi, CgResult
from sparsela.solvers.pcg import pcg_solve_multi, make_ic0_preconditioner
from sparsela.solvers.spai_cg import spai_cg_solve_multi
from sparsela.solvers.refine import (
    cg_solve_refined,
    cg_solve_multi_refined,
    RefineResult,
)
from sparsela.solvers.implicit import (
    make_cg_solver,
    make_cg_solver_multi,
)
