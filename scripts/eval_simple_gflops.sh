#!/bin/bash
# Single-RHS CG harness (parity: eval_simple_gflops.sh:
# 40-66 — per-matrix GFLOPS CSV into data/simple_gflops/).
# Usage: eval_simple_gflops.sh <mtx_dir> [timing_iters] [out_dir]
set -u
DIR=${1:?usage: eval_simple_gflops.sh <mtx_dir> [timing_iters] [out_dir]}
ITERS=${2:-0}
OUT=${3:-data/simple_gflops}
mkdir -p "$OUT"
for m in "$DIR"/*.mtx; do
  [ -e "$m" ] || { echo "no .mtx files in $DIR"; exit 1; }
  name=$(basename "$m" .mtx)
  csv="$OUT/${name}_gflops.csv"
  echo "matrix,kernel,L,ms,gflops,iters" > "$csv"
  if [ "$ITERS" -gt 0 ]; then
    python -m sparsela.bench.run cg --mtx "$m" \
      --timing_iters "$ITERS" --quiet >> "$csv" \
      || echo "# $m failed" >> "$csv"
  else
    python -m sparsela.bench.run cg --mtx "$m" --quiet >> "$csv" \
      || echo "# $m failed" >> "$csv"
  fi
  echo "wrote $csv"
done
echo "=== all matrices completed ==="
