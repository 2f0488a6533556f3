#!/bin/bash
# SuiteSparse fetch (parity: get_uf_datasets.sh). Usage: get_uf_datasets.sh <list.txt> [dest]
set -u
LIST=${1:?usage: get_uf_datasets.sh <list.txt> [dest]}
DEST=${2:-download}
python -c "from sparsela.io.suitesparse import fetch_list; \
  print(len(fetch_list('$LIST', '$DEST')), 'matrices fetched')"
