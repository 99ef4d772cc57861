#!/usr/bin/env python
"""Layout/iteration demo for the PyTorch + CUDA port (reference:
examples/range.cu demos the range abstraction).

The counterpart of ``examples/range.py``: tile/atom iteration over the
4x4 sample matrix expressed as host arrays, then the flat re-binning into
windows of 3 atoms. It prints the same lines. Nothing here runs on a
device: the layouts are host arrays that every schedule consumes.

    python examples/range_torch.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.layout import CsrLayout, FlatRebinLayout  # noqa: E402
from loops_tpu_torch.utils import sample  # noqa: E402


def main(argv=None):
    csr = sample.csr()
    lay = CsrLayout.from_csr(csr)
    print(f"tiles={lay.num_tiles} atoms={lay.num_atoms}")
    print("tile_offsets:", lay.tile_offsets().tolist())
    print("atom_tile_ids:", lay.atom_tile_ids().tolist())
    for t in range(lay.num_tiles):
        atoms = list(range(lay.tile_begin(t), lay.tile_end(t)))
        print(f"  tile {t}: atoms {atoms}")
    flat = FlatRebinLayout(lay, 3)
    print(f"rebinned to {flat.num_tiles} windows of 3:",
          flat.tile_offsets().tolist())
    print("base rows of atoms:", flat.base_tile_ids().tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
