#!/usr/bin/env python
"""In-process schedule sweep on the card: the counterpart of
``scripts/sweep_battery.py`` for ``loops_tpu_torch``.

Each matrix of a population is built once; every schedule (with the
implementation ``schedule="auto"`` runs for it: K1 for ``sorted_flat``,
K2 for ``work_oriented``/``merge_path``, torch ops for ``row_mapped``/
``group_mapped``) and cuSPARSE's csrmv (``vendor``) runs on it, is held to
the Wilkinson bound, and is timed. One row per (matrix, column) goes to
``OUT/<column>.csv``: ``column,dataset,rows,cols,nnz,apply_ms,plan_ms,
device_ms``. A rerun resumes from the logs. ``--op spmm`` sweeps K4 and
the two torch routes at ``--feat`` columns instead. The logic lives in
``loops_tpu_torch/tuning/sweep.py``.

    python scripts/sweep_battery_torch.py OUT [--population synthetic|
        statmatched|statmatched_rep|xl|gnn] [--budget-s S] [--limit K]
        [--op spmm --feat 128 --dtype bf16 --norm mean] [--device cpu]

Exits 1 when the logs hold a ``WRONG`` row; ``--device cuda`` (the
default) fails when no card is visible.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.tuning.sweep import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
