from sparsela.parallel.sharded import (
    ShardedCsr,
    shard_csr,
    spmv_sharded,
    spmm_sharded,
    cg_step_sharded,
    make_mesh,
)
