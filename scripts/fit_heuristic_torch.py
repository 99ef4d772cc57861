#!/usr/bin/env python
"""Refit ``choose_schedule``'s thresholds from the sweep's logs: the
counterpart of ``scripts/fit_heuristic.py`` for ``loops_tpu_torch``.
Prints the oracle mix, the capture of ``loops_tpu``'s (TPU v5e) table and
of the fitted one on ``apply_ms`` and ``device_ms``, on LOG_DIR and on
each ``--holdout`` directory, the speedups over cuSPARSE and the card row
to commit (``schedule/plans.py``); writes ``heuristics.csv`` and
completes ``features.csv`` in LOG_DIR. ``--op spmm`` fits the GCN
aggregation route over SpMM log directories. The logic lives in
``loops_tpu_torch/tuning/fit.py``.

    python scripts/fit_heuristic_torch.py plots/data/h100/statmatched \
        --holdout plots/data/h100/statmatched_rep plots/data/h100/synthetic
    python scripts/fit_heuristic_torch.py --op spmm plots/data/h100/spmm/*
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.tuning.fit import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
