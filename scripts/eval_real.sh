#!/bin/bash
# Real-collection battery: every route on reconstructed SuiteSparse
# entries (io/realmats.py), each row golden-checked against the host
# oracle. Runs on any backend; on a GPU the timings are device numbers.
# Reference analogue: eval_csrmv.sh over the downloaded UFL corpus.
# Usage: eval_real.sh [out_dir]
set -e
cd "$(dirname "$0")/.."
OUT=${1:-data/real_results}
mkdir -p "$OUT"
CSV="$OUT/real_spmv_rows.csv"
: > "$CSV"
for m in Trefethen_2000 Trefethen_20000 mycielskian11 mycielskian12 \
         mycielskian13 gr_30_30 bibd_81_3; do
  python -m sparsela.bench.run spmv --real "$m" --fp32 \
    --strategy auto,cusparse,reference --quiet >> "$CSV" || \
    echo "# $m failed" >> "$CSV"
done
echo "wrote $CSV"
