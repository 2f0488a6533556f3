from sparsela.ops.spmv import spmv, spmm, SpmvStrategy
from sparsela.ops.blas import dot_multiple, axpy_multiple, update_p_multiple
