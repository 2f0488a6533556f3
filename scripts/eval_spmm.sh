#!/bin/bash
# SpMM sweep over a directory of .mtx files (parity:
# eval_csrmm.sh — per-matrix CSV rows; the fixed thread count
# becomes the default route set on one device).
# Usage: eval_spmm.sh <mtx_dir> [num_vectors] [out.csv]
set -u
DIR=${1:?usage: eval_spmm.sh <mtx_dir> [num_vectors] [out.csv]}
L=${2:-32}
OUT=${3:-data/spmm_sweep.csv}
mkdir -p "$(dirname "$OUT")"
echo "matrix,kernel,L,nnz,ms,gflops,check" > "$OUT"
for m in "$DIR"/*.mtx; do
  [ -e "$m" ] || { echo "no .mtx files in $DIR"; exit 1; }
  python -m sparsela.bench.run spmm --mtx "$m" --fp32 \
    --num_vectors "$L" --quiet >> "$OUT" \
    || echo "# $m failed" >> "$OUT"
done
echo "wrote $OUT"
