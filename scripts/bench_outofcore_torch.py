#!/usr/bin/env python
"""Out-of-core bench on one device: the counterpart of
``scripts/bench_outofcore.py`` for ``loops_tpu_torch``.

Builds a papers100M-shaped power-law adjacency of ``--nodes`` nodes,
stages it into row shards on disk, plans every shard on its own, then
streams ``A @ X`` shard by shard through the device against a feature
table on disk (``--schedule merge_path``: K4, ``csrc/spmm.cu``). Prints
the graph, ``stage:``, ``plan:``, ``spmm:`` (with the stream's parts) and
``check:`` lines; the logic lives in ``loops_tpu_torch/utils/outofcore.py``.

    python scripts/bench_outofcore_torch.py --nodes 10000000 --avg-deg 15 \\
        --shards 16 --feat 128 --schedule merge_path [--dtype bfloat16] \\
        [--dir DIR] [--device cpu]

Exits 1 when the check fails; ``--device cuda`` (the default) fails when
no card is visible.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.utils.outofcore import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
