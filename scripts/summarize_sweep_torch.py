#!/usr/bin/env python
"""Summarize sweep logs: per-schedule geomean ms and wins, the oracle
(best-of-schedules) geomean and the speedup over the vendor; the
counterpart of ``scripts/summarize_sweep.py``. ``--device-ms`` reads the
card's time (column 8) instead of ``apply_ms``.

    python scripts/summarize_sweep_torch.py LOG_DIR [--device-ms] [--op spmm]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.tuning.sweep import summarize_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(summarize_main())
