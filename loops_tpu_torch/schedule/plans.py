"""Schedule planners — host-side work partitioning for the CUDA kernels.

The reference's ``schedule::setup`` templates run *on the device*, mapping
processor ids to (tile, atom) work at kernel time (reference:
include/loops/schedule.hxx:55-63 and schedule/*.hxx). As in ``loops_tpu``,
**planning is a host precompute producing fixed-shape numpy arrays**, and
the device sees dense, regular work:

==============  ====================================================
schedule        realization
==============  ====================================================
row_mapped      per-atom segment ids -> segmented reduction
                (reference thread_mapped, schedule/thread_mapped.hxx)
group_mapped    bucketed-ELL / SELL-style row grouping: rows binned by
                degree class, each bucket a dense [rows_b, pitch_b]
                plane -> dense row reductions, zero scatter
                (reference group_mapped, schedule/group_mapped.hxx:104-143)
work_oriented   even split of atoms into K-sized blocks + per-block
                first-row info (reference schedule/work_oriented.hxx)
merge_path      merge-path diagonal split of (tiles + atoms) into
                blocks of K work items: **each block has <= K atoms
                AND spans <= K rows** (reference merge_path_flat's
                preprocess_t, schedule/merge_path_flat.hxx:99-172)
==============  ====================================================
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.layout.contract import Layout
from loops_tpu_torch.layout.merge_path import merge_path_partition

SCHEDULES = ("row_mapped", "group_mapped", "work_oriented", "merge_path")


# --------------------------------------------------------------------------
@dataclass
class RowMappedPlan:
    """Per-atom segment ids; the direct segmented-reduction schedule."""
    num_tiles: int
    num_atoms: int
    atom_tile_ids: np.ndarray  # [num_atoms]

    @classmethod
    def from_layout(cls, layout: Layout) -> "RowMappedPlan":
        return cls(layout.num_tiles, layout.num_atoms,
                   layout.atom_tile_ids())


# --------------------------------------------------------------------------
@dataclass
class GroupMappedPlan:
    """Bucketed-ELL (SELL-style) grouping.

    Tiles are binned by size class (geometric, ``2**class_step`` growth
    up to ``max_pitch``, with one overflow bucket for heavier tiles).
    Each bucket stores its tile ids plus a dense atom-slot plane: slot
    (i, k) is atom ``tile_begin(tile_i) + k`` if k < tile_size else
    padding (index 0, masked by ``valid``). Padding per bucket stays below
    ``2**class_step`` slots per tile by construction.
    """
    num_tiles: int
    num_atoms: int
    buckets: list = field(default_factory=list)
    # each bucket: dict(tiles=[n_b] tile ids, atom_slots=[n_b, pitch_b]
    #                   atom index or 0, valid=[n_b, pitch_b] bool)

    @classmethod
    def from_layout(cls, layout: Layout, max_pitch: int = 1 << 14,
                    class_step: float = 1.0) -> "GroupMappedPlan":
        sizes = layout.tile_sizes()
        begins = layout.tile_offsets()[:-1]
        plan = cls(layout.num_tiles, layout.num_atoms)
        if layout.num_tiles == 0:
            return plan
        # size class: smallest 2**(k*class_step) >= size (empty tiles
        # dropped — their output is zero by construction)
        classes = np.zeros(len(sizes), dtype=np.float64)
        nz = sizes > 0
        classes[nz] = (np.ceil(np.log2(sizes[nz]) / class_step)
                       * class_step)
        classes[sizes > max_pitch] = -1  # overflow bucket
        for c in np.unique(classes[nz]):
            tiles = np.nonzero(nz & (classes == c))[0]
            pitch = (int(sizes[tiles].max()) if c == -1
                     else int(np.ceil(2.0 ** c)))
            k = np.arange(pitch)
            slots = begins[tiles][:, None] + k[None, :]
            valid = k[None, :] < sizes[tiles][:, None]
            plan.buckets.append(dict(
                tiles=tiles.astype(INDEX_DTYPE),
                atom_slots=np.where(valid, slots, 0).astype(INDEX_DTYPE),
                valid=valid,
            ))
        return plan

    @property
    def padded_atoms(self) -> int:
        return sum(b["atom_slots"].size for b in self.buckets)


# --------------------------------------------------------------------------
@dataclass
class FlatBlockPlan:
    """Shared result type of the two balanced flat schedules.

    Work is cut into ``num_blocks`` blocks. Block b owns atoms
    [atom_starts[b], atom_starts[b+1]) and rows (tiles)
    [tile_starts[b], tile_starts[b+1]] — note the closed upper end: the
    row at ``tile_starts[b+1]`` may be split across the block seam. The
    CUDA kernels hand each block's first and last row to a seam pass
    that adds the partial sums in block order.

    Also carries the dense per-block staging arrays the kernels consume:
    ``atom_gather`` [num_blocks, block_atoms] (source atom per slot,
    0-padded), ``rel_tile`` [num_blocks, block_atoms] (tile of each slot
    relative to the block's first tile), ``valid`` mask.
    """
    schedule: str
    num_tiles: int
    num_atoms: int
    block_atoms: int                  # K: max atoms per block
    tile_starts: np.ndarray           # [num_blocks+1]
    atom_starts: np.ndarray           # [num_blocks+1]
    atom_gather: np.ndarray           # [num_blocks, K]
    rel_tile: np.ndarray              # [num_blocks, K]
    valid: np.ndarray                 # [num_blocks, K] bool

    @property
    def num_blocks(self) -> int:
        return len(self.atom_starts) - 1

    @property
    def max_rel_span(self) -> int:
        """Max rows any block touches — <= block_atoms for merge_path by
        the diagonal guarantee; data-dependent for work_oriented."""
        return int(self.rel_tile.max(initial=0)) + 1 if self.num_atoms else 1

    def block_rows(self):
        """``(row_first, row_last)`` int32 [num_blocks]: the rows of each
        block's first and last atom, -1 for a block without atoms — the
        rows whose partial sums the CUDA kernels hand to the seam pass."""
        n = np.diff(self.atom_starts.astype(np.int64))
        first = np.full(self.num_blocks, -1, np.int64)
        last = np.full(self.num_blocks, -1, np.int64)
        has = np.nonzero(n > 0)[0]
        r0 = self.tile_starts[has].astype(np.int64)
        first[has] = r0 + self.rel_tile[has, 0]
        last[has] = r0 + self.rel_tile[has, n[has] - 1]
        return first.astype(INDEX_DTYPE), last.astype(INDEX_DTYPE)

    def gather(self, arr: np.ndarray) -> np.ndarray:
        """``arr[atom_gather]`` with padding slots set to 0: a per-atom
        array (values, columns) staged as [num_blocks, K]. A matrix with
        no nonzeros has nothing to gather, and every slot is padding, so
        its staged array is all zeros."""
        arr = np.asarray(arr)
        if arr.size == 0:
            return np.zeros(self.atom_gather.shape, arr.dtype)
        return np.where(self.valid, arr[self.atom_gather], 0).astype(
            arr.dtype)

    @classmethod
    def from_arrays(cls, schedule: str, num_tiles: int, num_atoms: int,
                    block_atoms: int, tile_starts, atom_starts, atom_gather,
                    rel_tile, valid) -> "FlatBlockPlan":
        """A plan from plain arrays, such as the fields of another
        package's FlatBlockPlan — one plan fed to both."""
        return cls(str(schedule), int(num_tiles), int(num_atoms),
                   int(block_atoms),
                   np.asarray(tile_starts, dtype=INDEX_DTYPE),
                   np.asarray(atom_starts, dtype=INDEX_DTYPE),
                   np.asarray(atom_gather, dtype=INDEX_DTYPE),
                   np.asarray(rel_tile, dtype=INDEX_DTYPE),
                   np.asarray(valid, dtype=bool))

    @classmethod
    def _stage(cls, schedule, layout, tile_starts, atom_starts, K):
        ids = layout.atom_tile_ids()
        nb = len(atom_starts) - 1
        slots = (atom_starts[:-1, None].astype(np.int64)
                 + np.arange(K)[None, :])
        valid = slots < atom_starts[1:, None]
        gather = np.where(valid, slots, 0)
        rel = np.where(
            valid,
            ids[np.minimum(gather, max(layout.num_atoms - 1, 0))]
            - tile_starts[:-1, None],
            0) if layout.num_atoms else np.zeros((nb, K), dtype=np.int64)
        return cls(schedule, layout.num_tiles, layout.num_atoms, K,
                   tile_starts.astype(INDEX_DTYPE),
                   atom_starts.astype(INDEX_DTYPE),
                   gather.astype(INDEX_DTYPE), rel.astype(INDEX_DTYPE),
                   valid)

    @classmethod
    def work_oriented(cls, layout: Layout, block_atoms: int = 512
                      ) -> "FlatBlockPlan":
        """Even split of *atoms* across blocks (the reference's
        work_oriented even-shares tiles+atoms per thread; the atom-only
        split keeps every block at exactly K atoms but one)."""
        K = int(block_atoms)
        nb = max(-(-layout.num_atoms // K), 1)
        atom_starts = np.minimum(np.arange(nb + 1, dtype=np.int64) * K,
                                 layout.num_atoms)
        ids = layout.atom_tile_ids()
        tile_starts = np.zeros(nb + 1, dtype=np.int64)
        if layout.num_atoms:
            tile_starts[:-1] = ids[np.minimum(atom_starts[:-1],
                                              layout.num_atoms - 1)]
            tile_starts[-1] = layout.num_tiles
        return cls._stage("work_oriented", layout, tile_starts, atom_starts, K)

    @classmethod
    def merge_path(cls, layout: Layout, block_work: int = 512
                   ) -> "FlatBlockPlan":
        """Merge-path diagonal split of (tiles + atoms) into blocks of
        ``block_work`` items. Guarantees per-block atoms <= K and row span
        <= K."""
        K = int(block_work)
        total = layout.num_tiles + layout.num_atoms
        nb = max(-(-total // K), 1)
        t, a = merge_path_partition(layout.tile_offsets(), nb, K)
        return cls._stage("merge_path", layout, t.astype(np.int64),
                          a.astype(np.int64), K)


# choose_schedule decision thresholds: the table ``loops_tpu`` fitted on a
# TPU v5e (scripts/fit_heuristic.py over the stat-matched SuiteSparse
# sweep): the sorted-gather schedule for every matrix, and the
# degree-class planes for extreme degree skew (cv > 4). It is the table
# of the CPU (loops_tpu kept a second one off the TPU only because
# interpret-mode Pallas is slow on the CPU, and the port's plain versions
# are not) and of every card without a row in CARD_THRESHOLDS.
HEURISTIC_THRESHOLDS = {
    "ratio": float("inf"),
    "cv": 4.0,      # coefficient of variation above which skew branch
    "small": 0.0,   # max tile size at or below which -> row_mapped
    "flat": "sorted_flat",    # uniform/mild tiles
    "group": "group_mapped",  # extreme-skew tiles
}


# choose_schedule's rows for the cards the sweep has run on, keyed by a
# substring of torch.cuda.get_device_name() (first match wins): each row
# is tuning/fit.py's fit over that card's sweep logs (provenance names
# them). "impl" maps each schedule the row can choose to the
# implementation the sweep timed it with (tuning/sweep.SCHED_IMPL), which
# is the one ``schedule="auto"`` then runs.
CARD_THRESHOLDS = (
    # K1 (sorted_flat) for every matrix: the first grid point of the
    # highest capture of the stat-matched population's oracle by apply_ms
    # (98.5% with the one-launch K1's column, 86.4% with the one before;
    # loops_tpu's table 89.8%, 81.3% before: its cv > 4 planes run 2-20x
    # slower here)
    ("H100", {
        "ratio": 1.25, "cv": 0.125, "small": 0.0,
        "flat": "sorted_flat", "group": "sorted_flat",
        "impl": {"row_mapped": "xla", "sorted_flat": "pallas3"},
        "provenance": (
            "tuning/fit.py over plots/data/h100/statmatched (250 "
            "stat-matched replicas, scripts/sweep_battery_torch.py, "
            "apply_ms) on NVIDIA H100 80GB HBM3, 700.00 W"),
    }),
)

# the SpMM (GCN aggregation) route of ``schedule="auto"`` on a card, fitted
# the same way over the sweep's SpMM logs (tuning/sweep.SPMM_IMPL): K4 is
# merge_path with impl "pallas"
CARD_SPMM_ROUTES = (
    # K4 for every matrix: it was the fastest on all 300 cases (f32 and
    # bf16, as is and mean-normalized), 13-20x the planes' geomean
    ("H100", {
        "ratio": 1e18, "cv": 1e18, "small": 0.0,
        "flat": "merge_path", "group": "merge_path",
        "impl": {"merge_path": "pallas", "row_mapped": "xla"},
        "provenance": (
            "tuning/fit.py --op spmm over plots/data/h100/spmm/{f32,bf16,"
            "f32_mean,bf16_mean} (the pl_, rmat_, lgn_ recipes and the "
            "ogbn-arxiv stand-in at F = 128, scripts/sweep_battery_torch.py "
            "--op spmm, apply_ms) on NVIDIA H100 80GB HBM3, 700.00 W"),
    }),
)


def _card_row(table, device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    return next((row for key, row in table if key in name), None)


def thresholds_for(device) -> dict:
    """``choose_schedule``'s table on ``device``: the card's row of
    ``CARD_THRESHOLDS``, else ``HEURISTIC_THRESHOLDS`` (the CPU, and a
    card the sweep has not run on)."""
    return _card_row(CARD_THRESHOLDS, device) or HEURISTIC_THRESHOLDS


def spmm_route_for(device) -> dict | None:
    """The SpMM route's row of ``CARD_SPMM_ROUTES`` for ``device``, or
    None (the CPU, and a card the sweep has not run on)."""
    return _card_row(CARD_SPMM_ROUTES, device)


def choose_schedule(layout: Layout, thresholds: dict | None = None) -> str:
    """Heuristic schedule selection — the analog of the reference's
    best-of-3 oracle study (plots/data/heuristics.csv: the right schedule
    per matrix beats any fixed one by ~2.7x geomean).

    Regimes: skewed degree distributions -> the skew branch; tiny/uniform
    tiles -> row_mapped; otherwise the flat branch.
    """
    t = HEURISTIC_THRESHOLDS if thresholds is None else thresholds
    sizes = layout.tile_sizes()
    if layout.num_tiles == 0 or layout.num_atoms == 0:
        return "row_mapped"
    mean = max(float(sizes.mean()), 1e-9)
    mx = float(sizes.max())
    cv = float(sizes.std()) / mean
    if mx / mean > t["ratio"] or cv > t["cv"]:
        return t.get("group", "group_mapped")
    if mx <= t["small"]:
        return "row_mapped"
    return t.get("flat", "merge_path")


def make_plan(layout: Layout, schedule: str, **kw):
    if schedule == "auto":
        schedule = choose_schedule(layout)
    if schedule == "row_mapped":
        return RowMappedPlan.from_layout(layout)
    if schedule in ("group_mapped", "bucketing"):
        # "bucketing" is accepted as an alias: the reference declares the
        # enum value but never implements it (schedule.hxx:26-32); our
        # group_mapped *is* a bucketing schedule (degree-class buckets).
        return GroupMappedPlan.from_layout(layout, **kw)
    if schedule == "work_oriented":
        return FlatBlockPlan.work_oriented(layout, **kw)
    if schedule == "merge_path":
        return FlatBlockPlan.merge_path(layout, **kw)
    raise ValueError(
        f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
