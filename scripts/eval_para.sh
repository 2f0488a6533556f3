#!/bin/bash
# Device-scaling sweep (parity: eval_para.sh:15-23 —
# the reference sweeps OpenMP thread counts {1..18}; the analogue here
# sweeps device counts over the mesh via the jitted sharded CG solve,
# emitting speedup/efficiency CSVs per matrix).
# Usage: eval_para.sh <mtx_dir> [num_vectors] [out_dir]
set -u
DIR=${1:?usage: eval_para.sh <mtx_dir> [num_vectors] [out_dir]}
L=${2:-32}
OUT=${3:-data/efficiency}
mkdir -p "$OUT"
for m in "$DIR"/*.mtx; do
  [ -e "$m" ] || { echo "no .mtx files in $DIR"; exit 1; }
  echo "== $m"
  python -m sparsela.bench.run efficiency --mtx "$m" \
    --num_vectors "$L" --output "$OUT" \
    || echo "# $m failed"
done
echo "wrote $OUT/*_efficiency.csv"
