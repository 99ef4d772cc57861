#!/usr/bin/env python
"""The vendor column alone: cuSPARSE's CSR SpMV
(``torch.sparse_csr_tensor(...) @ x``) over a population, checked and
timed as the schedules are; the counterpart of ``scripts/sweep_vendor.py``
(which timed ``jax.experimental.sparse`` BCOO). Writes
``OUT/vendor.csv``. ``scripts/sweep_battery_torch.py`` runs this column
beside the schedules already; this script fills it in for logs that lack
it.

    python scripts/sweep_vendor_torch.py OUT [--population P] [--budget-s S]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.tuning.sweep import vendor_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(vendor_main())
