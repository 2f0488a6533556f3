#!/bin/bash
# SpMV sweep over a directory of .mtx files (parity: eval_csrmv.sh).
# Usage: eval_spmv.sh <mtx_dir> [out.csv]
set -u
DIR=${1:?usage: eval_spmv.sh <mtx_dir> [out.csv]}
OUT=${2:-data/spmv_sweep.csv}
mkdir -p "$(dirname "$OUT")"
echo "matrix,kernel,rows,nnz,ms,gflops,gbs,check" > "$OUT"
for m in "$DIR"/*.mtx; do
  python -m sparsela.bench.run spmv --mtx "$m" --fp32 --quiet >> "$OUT"
done
echo "wrote $OUT"
