#!/usr/bin/env bash
# CG GFLOPS harness over a matrix directory (parity:
# eval_gflops.sh:50-70 — per-matrix CSV rows into
# data/gflops/). Usage: eval_gflops.sh <mtx-dir> [num_vectors]
set -euo pipefail
DIR="${1:-download/final_mtx}"
L="${2:-16}"
OUT="data/gflops"
mkdir -p "$OUT"
CSV="$OUT/cg_gflops.csv"
echo "matrix,kernel,L,ms,gflops,iters" > "$CSV"
for f in "$DIR"/*.mtx; do
  [ -e "$f" ] || { echo "no .mtx files in $DIR"; exit 1; }
  echo "== $f"
  python -m sparsela.bench.run cg --mtx "$f" --num_vectors "$L" \
    --quiet >> "$CSV" || echo "# $f failed" >> "$CSV"
done
echo "wrote $CSV"
python - "$CSV" "$OUT/cg_gflops_pivot.csv" <<'EOF'
import csv
import sys

from sparsela.analysis.plots import plot_gflops_pivot

rows = []
with open(sys.argv[1]) as f:
    rd = csv.reader(f)
    next(rd, None)
    for r in rd:
        if len(r) >= 6 and not r[0].startswith("#"):
            # cg rows: matrix,kernel,L,ms,gflops,iters -> pivot shape
            rows.append((r[0], r[1], r[2], 0, r[3], float(r[4]), ""))
plot_gflops_pivot(rows, sys.argv[2])
print(f"wrote {sys.argv[2]}")
EOF
