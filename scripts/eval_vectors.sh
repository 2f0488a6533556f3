#!/bin/bash
# RHS-count sweep L in 1..1024 (parity: eval_vectors.sh).
# Usage: eval_vectors.sh [--lap3d 32] [out.csv]
set -u
SRC=${1:---lap3d}; VAL=${2:-32}; OUT=${3:-data/vectors_sweep.csv}
mkdir -p "$(dirname "$OUT")"
python -m sparsela.bench.run sweep "$SRC" "$VAL" --fp32 \
  --vector_counts 1,2,4,8,16,32,64,128,256,512,1024 > "$OUT"
echo "wrote $OUT"
