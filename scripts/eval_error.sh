#!/bin/bash
# Solver-comparison error histories + convergence plot (parity: eval_error.sh).
# Usage: eval_error.sh <mtx_file_or_--lap2d> [value]
set -u
SRC=${1:---lap2d}; VAL=${2:-32}
python -m sparsela.bench.run multicg "$SRC" "$VAL" --fp64 --num_vectors 8
python - <<PY
from sparsela.analysis.plots import plot_errors
import glob, os
csvs = {os.path.basename(p).split("_")[-2]: p
        for p in glob.glob("data/error_data/*_errors.csv")}
if csvs:
    plot_errors(csvs, "data/error_data/convergence.png")
    print("wrote data/error_data/convergence.png")
PY
