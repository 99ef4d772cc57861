#!/usr/bin/env bash
# Sweep driver for the PyTorch + CUDA port (the counterpart of
# scripts/run.sh): run every SpMV schedule over every .mtx in a dataset
# directory through examples/spmv_torch.py, appending the first line it
# prints (kernel,dataset,rows,cols,nnzs,elapsed) to <out_dir>/<schedule>.csv,
# or TIMEOUT,<file> where the run does not end within timeout_s or fails.
# Usage: scripts/run_torch.sh <dataset_dir> <out_dir> [timeout_s] [device]
# (device cuda, the default, or cpu; cuda fails where no card is visible)
set -u
DATASETS=${1:-datasets}
OUT=${2:-sweep_logs}
TIMEOUT=${3:-60}
DEVICE=${4:-cuda}
HERE=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$OUT"
for mtx in "$DATASETS"/*.mtx; do
  [ -e "$mtx" ] || continue
  for sched in row_mapped group_mapped work_oriented merge_path sorted_flat; do
    if line=$(timeout "$TIMEOUT" python "$HERE/examples/spmv_torch.py" \
        -m "$mtx" --schedule "$sched" --device "$DEVICE" 2>/dev/null); then
      echo "$line" | head -1 >> "$OUT/$sched.csv"
    else
      echo "TIMEOUT,$(basename "$mtx")" >> "$OUT/$sched.csv"
    fi
  done
done
