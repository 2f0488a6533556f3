from sparsela.precond.ic0 import ic0_factorize
from sparsela.precond.trisolve import (
    forward_solve_host,
    backward_solve_host,
    jacobi_trisolve_lower,
    jacobi_trisolve_upper,
)
from sparsela.precond.spai import spai_inverse
