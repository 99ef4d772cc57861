#!/usr/bin/env python
"""User-extensibility proof for the PyTorch + CUDA port: a custom layout
driving stock schedules.

The counterpart of ``examples/custom_layout.py`` (reference:
examples/spmv/custom_layout.cu:64-244): a user-defined *row-padded*
layout (rows padded to a fixed stride with explicit padding atoms)
plugged into the port's stock planners (row_mapped and merge_path)
without touching framework code. Anything exposing ``num_tiles`` /
``num_atoms`` / ``tile_offsets`` is schedulable. Both reductions are the
port's deterministic sorted segment reduction (``torch.segment_reduce``
over segment lengths), run on ``--device``. It prints the same lines as
the JAX example.

    python examples/custom_layout_torch.py [--device cuda|cpu]

``--device cuda`` (the default) fails when no card is visible; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.layout import (  # noqa: E402
    UniformLayout,
    check_layout_invariants,
)
from loops_tpu_torch.schedule.plans import make_plan  # noqa: E402
from loops_tpu_torch.utils import generate, reference  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402


class RowPaddedLayout(UniformLayout):
    """User-defined: every row stored padded to ``stride`` slots; atom k
    belongs to row k // stride, and slots beyond the row's true size are
    padding. Closed-form: no offsets array materialized."""

    def __init__(self, row_sizes, stride):
        super().__init__(num_tiles=len(row_sizes), pitch=int(stride))
        self.row_sizes = np.asarray(row_sizes)

    def valid_mask(self):
        k = np.arange(self.pitch)
        return k[None, :] < self.row_sizes[:, None]


def sorted_segment_sum(data, seg, num_segments):
    """Sum ``data`` by segment id ``seg`` (host int array) in a fixed
    order: a stable sort by id, then ``torch.segment_reduce`` over the
    segments' lengths (empty segments give 0)."""
    import torch

    order = np.argsort(seg, kind="stable")
    lengths = np.bincount(seg, minlength=num_segments)
    dev = data.device
    return torch.segment_reduce(
        data[torch.from_numpy(order).to(dev)], "sum",
        lengths=torch.from_numpy(lengths).to(dev), unsafe=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = ensure_platform(args.device)
    import torch

    # user data: a random CSR re-stored in row-padded form
    csr = generate.random_csr(64, 48, 0.1, seed=7)
    stride = int(csr.row_sizes().max())
    layout = RowPaddedLayout(csr.row_sizes(), stride)
    check_layout_invariants(layout)  # the stock contract checker

    # pack the user's storage
    vals = np.zeros((64, stride), np.float32)
    cols = np.zeros((64, stride), np.int32)
    mask = layout.valid_mask()
    rid = csr.row_ids()
    rank = np.arange(csr.nnz) - csr.offsets[rid]
    vals[rid, rank] = csr.vals
    cols[rid, rank] = csr.indices

    x = generate.make_input_vector(48)
    y_ref = reference.spmv(csr, x)
    xd = torch.from_numpy(x).to(device)

    # stock row_mapped over the custom layout: segment ids come straight
    # from the layout contract
    seg = layout.atom_tile_ids()
    flat_vals = torch.from_numpy(np.where(mask, vals, 0).ravel()).to(device)
    flat_cols = torch.from_numpy(cols.ravel().astype(np.int64)).to(device)
    y = sorted_segment_sum(flat_vals * xd[flat_cols], seg, layout.num_tiles)
    err_row = np.abs(y.cpu().numpy() - y_ref).max()

    # stock merge_path planner over the same custom layout
    plan = make_plan(layout, "merge_path", block_work=32)
    fv = np.where(mask, vals, 0).ravel()
    fc = cols.ravel()
    pv = torch.from_numpy(np.where(plan.valid, fv[plan.atom_gather], 0)).to(
        device)
    pc = torch.from_numpy(fc[plan.atom_gather].astype(np.int64)).to(device)
    ids = np.where(plan.valid,
                   plan.tile_starts[:-1, None].astype(np.int64)
                   + plan.rel_tile, layout.num_tiles)
    y2 = sorted_segment_sum((pv * xd[pc]).reshape(-1), ids.ravel(),
                            layout.num_tiles + 1)[: layout.num_tiles]
    err_mp = np.abs(y2.cpu().numpy() - y_ref).max()

    print(f"custom row-padded layout: {layout.num_tiles} tiles x "
          f"{stride} stride, {layout.num_atoms} atoms "
          f"({csr.nnz} real)")
    print(f"row_mapped max err:  {err_row:.2e}")
    print(f"merge_path max err:  {err_mp:.2e}")
    ok = err_row < 1e-4 and err_mp < 1e-4
    print("Errors: 0" if ok else "Errors: >0")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
