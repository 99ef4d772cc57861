"""Schedule coverage of the port's planners: every atom visited exactly
once (the port of ``tests/test_schedule_coverage.py``).

The planner-level analog of the reference's device visit-counter test
(reference: unittests/test_schedule_coverage.cu:43-112: a kernel counts
visits per atom and asserts each equals 1, including empty tiles and
over-subscribed grids). The port's planners materialize the visit map on
the host, so the check is exact array arithmetic: the staged
(atom_gather, valid) pairs must cover [0, num_atoms) exactly once;
group_mapped buckets likewise. The ``ell`` case builds
``EllLayout(rows, pitch)`` from ``loops_tpu``'s ``ELL.from_csr(...)``:
the port has no ELL format yet (ROADMAP A6).
"""
import numpy as np
import pytest

from loops_tpu.formats import ELL
from loops_tpu_torch.layout import (
    CooLayout,
    CsrLayout,
    EllLayout,
    FlatRebinLayout,
)
from loops_tpu_torch.schedule.plans import make_plan
from loops_tpu_torch.utils import generate


def _ell():
    ell = ELL.from_csr(generate.random_csr(7, 9, 0.3, seed=2))
    return EllLayout(ell.shape[0], ell.pitch)


LAYOUTS = {
    "csr_random": lambda: CsrLayout.from_csr(
        generate.random_csr(12, 10, 0.25, seed=5)),
    "csr_empty_rows": lambda: CsrLayout.from_csr(
        generate.empty_row_csr(9, 6)),
    "csr_skewed": lambda: CsrLayout.from_csr(
        generate.skewed_csr(8, 16, heavy_rows=2)),
    "csr_all_empty": lambda: CsrLayout.from_csr(
        generate.empty_row_csr(4, 4, every=1)),
    "coo": lambda: CooLayout(13),
    "ell": _ell,
    "flat_rebin": lambda: FlatRebinLayout(
        CsrLayout.from_csr(generate.random_csr(10, 10, 0.3, seed=7)), 4),
}


def _visit_counts_flat(plan, num_atoms):
    counts = np.zeros(num_atoms, dtype=np.int64)
    visited = plan.atom_gather[plan.valid]
    np.add.at(counts, visited, 1)
    return counts


@pytest.mark.parametrize("block", [1, 3, 8, 64])
@pytest.mark.parametrize("sched", ["work_oriented", "merge_path"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_flat_plans_visit_exactly_once(name, sched, block):
    layout = LAYOUTS[name]()
    kw = ({"block_atoms": block} if sched == "work_oriented"
          else {"block_work": block})
    plan = make_plan(layout, sched, **kw)
    counts = _visit_counts_flat(plan, layout.num_atoms)
    assert (counts == 1).all(), f"{name}/{sched}/K={block}"


@pytest.mark.parametrize("name", ["csr_random", "csr_empty_rows",
                                  "csr_skewed"])
def test_group_mapped_visits_exactly_once(name):
    layout = LAYOUTS[name]()
    plan = make_plan(layout, "group_mapped")
    counts = np.zeros(layout.num_atoms, dtype=np.int64)
    seen_tiles = []
    for b in plan.buckets:
        np.add.at(counts, b["atom_slots"][b["valid"]], 1)
        seen_tiles.append(b["tiles"])
    assert (counts == 1).all()
    # every non-empty tile appears in exactly one bucket
    nz_tiles = np.nonzero(layout.tile_sizes() > 0)[0]
    all_tiles = np.sort(np.concatenate(seen_tiles)) if seen_tiles else []
    np.testing.assert_array_equal(all_tiles, nz_tiles)


def test_merge_path_rel_span_bound():
    """The static-shape guarantee the kernels rely on: per-block
    rows-spanned + atoms <= block_work."""
    layout = LAYOUTS["csr_skewed"]()
    for K in [2, 4, 16]:
        plan = make_plan(layout, "merge_path", block_work=K)
        for b in range(plan.num_blocks):
            atoms = int(plan.valid[b].sum())
            span = int(plan.tile_starts[b + 1] - plan.tile_starts[b])
            assert atoms + span <= K + 1


def test_row_mapped_segment_ids_cover():
    layout = LAYOUTS["csr_random"]()
    plan = make_plan(layout, "row_mapped")
    ids = plan.atom_tile_ids
    assert len(ids) == layout.num_atoms
    sizes = np.bincount(ids, minlength=layout.num_tiles)
    np.testing.assert_array_equal(sizes, layout.tile_sizes())
