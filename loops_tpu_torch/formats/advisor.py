"""Format advisor — preflight structure probes -> recommended container.

The port of ``loops_tpu/formats/advisor.py``. The reference ships
per-format *guard* probes (``ell_t::max_nnz_per_row``, reference:
container/ell.hxx:91-102; ``dia_t::count_diagonals``,
container/dia.hxx:98-116) that protect against memory blow-up, but
leaves the format choice to the user. The advisor makes it a measured
decision: each format's SpMV cost is its probed size times a per-unit
time measured on the card, and a format that replaces per-nonzero
gathers with dense streamed reads (DIA diagonals, BCSR R x C blocks) wins
where its padding waste stays under the break-even.

``advise(csr)`` runs all probes (each O(nnz), vectorized) and returns
per-format cost estimates plus a gated recommendation;
``choose_format(csr)`` returns just the format name. This is the
format-axis companion of ``schedule.choose_schedule``.

The per-unit times are one :class:`FormatCosts` row, keyed on
``torch.cuda.get_device_name`` as ``tuning/launch_box.py`` keys its rows;
each row names where its numbers come from. ``loops_tpu``'s sorted-kernel
envelope (``_csr_ns_per_nnz``, which fell back to a slower per-nonzero
cost where its TPU kernel refused) is dropped, as K1's envelopes were:
K1 takes every float32 CSR, so the CSR cost is one per-nonzero time.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# The dimensionless gates are carried from the reference, unrefit on the
# H100 (ROADMAP A4 refits them from sweeps on the card).
# BCSR break-even block fill: below it the dense-block stream costs more
# than the gathers it removes.
BCSR_MIN_FILL = 0.015

# ELL runs the same per-cell gathers as CSR *including padding*, so it
# only helps by removing plan overhead; cap the waste (rows * pitch / nnz)
# and the estimate's excess over CSR at the same 25%.
ELL_MAX_WASTE = 1.25

# DIA memory blow-up guard (the purpose of the reference's
# count_diagonals probe, dia.hxx:98-116): require at least 5%
# dense-diagonal occupancy.
DIA_MIN_FILL = 0.05

VALUE_BYTES = 4  # float32 values, the advisor's unit of a streamed cell


@dataclass(frozen=True)
class FormatCosts:
    """Per-unit SpMV times of each format on one card, in ns."""

    csr_ns_per_nnz: float      # CSR SpMV (K1), per stored nonzero
    ell_ns_per_cell: float     # ELL row_mapped, per plane cell (padding too)
    dia_ns_per_cell: float     # DIA sweep, per (diagonal, row) cell
    bcsr_ns_per_block: float   # BCSR (K6), per stored block, less its stream
    stream_gbps: float         # rate a block's R x C values stream at, GB/s
    provenance: str = "fallback"


# substring match on torch.cuda.get_device_name(), first match wins.
# The H100 row: chip_smoke.py phase 22's times (ms per apply, CUDA
# events) on an NVIDIA H100 80GB HBM3 at its 700.00 W limit: K1 on
# big_2097152 (33,554,301 nonzeros), ELL row_mapped on big_2097152
# (2,097,152 rows x pitch 39), DIA on band_2097152_b4 (9 diagonals x
# 2,097,152 rows), K6 on bcsr_spmv_32768 (15,617 blocks of 8 x 128) less
# its values streamed at the read rate K11 measured in the same run.
_TABLE = (
    ("H100", FormatCosts(
        csr_ns_per_nnz=0.3167e6 / 33_554_301,
        ell_ns_per_cell=1.6029e6 / (2_097_152 * 39),
        dia_ns_per_cell=0.3202e6 / (9 * 2_097_152),
        bcsr_ns_per_block=0.0321e6 / 15_617 - 8 * 128 * VALUE_BYTES / 3220.0,
        stream_gbps=3220.0,
        provenance="chip_smoke.py phase 22 on NVIDIA H100 80GB HBM3, "
                   "700.00 W")),
)


def format_costs(device="cuda") -> FormatCosts:
    """The cost row for ``device``. Off the card (a CPU test device) and
    on a card with no row of its own, the first row stands, its
    provenance saying so: the advisor advises for a card."""
    import torch

    from loops_tpu_torch.utils.platform import ensure_platform

    dev = ensure_platform(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        for key, costs in _TABLE:
            if key in name:
                return costs
    key, costs = _TABLE[0]
    return FormatCosts(**{**costs.__dict__, "provenance":
                          f"{costs.provenance} (the {key} row, standing "
                          f"in for {str(dev)!r})"})


@dataclass
class FormatAdvice:
    """Probe results + cost-model estimates for one input matrix."""

    rows: int
    cols: int
    nnz: int
    # probes
    bcsr_fill: float            # nnz / stored block cells at bcsr_block
    bcsr_block: tuple           # (R, C) probed (launch-box default)
    dia_fill: float             # nnz / (num_diagonals * rows)
    num_diagonals: int
    ell_waste: float            # rows * pitch / nnz
    ell_pitch: int
    # estimated single-pass SpMV cost per format, milliseconds
    est_ms: dict = field(default_factory=dict)
    recommended: str = "csr"
    why: str = ""


def _stream_ns_per_cell(gbps: float, itemsize: int = VALUE_BYTES) -> float:
    return itemsize / gbps  # bytes / (GB/s) = ns


def probe_bcsr_fill(csr, block_rows: int = 8, block_cols: int = 128) -> float:
    """Fraction of stored-block cells that hold a nonzero (O(nnz log nnz):
    np.unique sorts)."""
    if csr.nnz == 0:
        return 0.0
    nbc = -(-csr.cols // block_cols)
    keys = (csr.row_ids().astype(np.int64) // block_rows) * nbc + (
        csr.indices.astype(np.int64) // block_cols)
    nblocks = len(np.unique(keys))
    return csr.nnz / float(nblocks * block_rows * block_cols)


def probe_dia_fill(csr) -> tuple:
    """``(num_diagonals, fill)``: the occupied diagonals and the share of
    their ``num_diagonals * rows`` cells that hold a nonzero."""
    from loops_tpu_torch.formats.dia import DIA
    ndiag = DIA.count_diagonals(csr)
    return ndiag, csr.nnz / max(ndiag * max(csr.rows, 1), 1)


def probe_ell_waste(csr) -> tuple:
    """``(pitch, waste)``: the ELL plane's width and its cells per
    nonzero, ``rows * pitch / nnz``."""
    from loops_tpu_torch.formats.ell import ELL
    pitch = ELL.max_nnz_per_row(csr)
    return pitch, max(csr.rows, 1) * pitch / max(csr.nnz, 1)


def advise(csr, costs: FormatCosts | None = None,
           bcsr_block: tuple | None = None, device="cuda") -> FormatAdvice:
    """Probe ``csr`` and estimate per-format SpMV cost.

    Cost model (``costs``, the row of ``device``'s card by default):
      csr  = nnz · csr_ns_per_nnz
      ell  = rows · pitch · ell_ns_per_cell      (pads the gathers)
      dia  = ndiag · rows · dia_ns_per_cell      (stream, no gather)
      bcsr = nblocks · (bcsr_ns_per_block + R·C · 4 B / stream_gbps)
    """
    if costs is None:
        costs = format_costs(device)
    if bcsr_block is None:
        from loops_tpu_torch.tuning.launch_box import launch_params
        bcsr_block = launch_params(device).bcsr_block
    R, C = bcsr_block
    stream = _stream_ns_per_cell(costs.stream_gbps)

    nnz = max(csr.nnz, 1)
    bcsr_fill = probe_bcsr_fill(csr, R, C)
    nblocks = nnz / max(bcsr_fill * R * C, 1e-12) if csr.nnz else 0.0
    ndiag, dia_fill = probe_dia_fill(csr)
    dia_cells = ndiag * max(csr.rows, 1)
    pitch, ell_waste = probe_ell_waste(csr)
    ell_cells = max(csr.rows, 1) * pitch

    est_ms = {
        "csr": nnz * costs.csr_ns_per_nnz * 1e-6,
        "ell": ell_cells * costs.ell_ns_per_cell * 1e-6,
        "dia": dia_cells * costs.dia_ns_per_cell * 1e-6,
        "bcsr": nblocks * (costs.bcsr_ns_per_block + R * C * stream) * 1e-6,
    }

    adv = FormatAdvice(csr.rows, csr.cols, csr.nnz, bcsr_fill,
                       (R, C), dia_fill, ndiag, ell_waste, pitch, est_ms)
    if csr.nnz == 0:
        adv.recommended, adv.why = "csr", "empty matrix"
        return adv

    # Gates first, cost model as tie-break: the model is a lower bound
    # per format, so only trust it where the gate says the regime applies.
    candidates = {"csr": est_ms["csr"]}
    if dia_fill >= DIA_MIN_FILL and est_ms["dia"] < est_ms["csr"]:
        candidates["dia"] = est_ms["dia"]
    if bcsr_fill >= BCSR_MIN_FILL and est_ms["bcsr"] < est_ms["csr"]:
        candidates["bcsr"] = est_ms["bcsr"]
    best = min(candidates, key=candidates.get)
    if (best == "csr" and ell_waste <= ELL_MAX_WASTE
            and est_ms["ell"] <= est_ms["csr"] * 1.25):
        # plan-free static layout, within the 25% overhead budget
        best = "ell"
    adv.recommended = best
    adv.why = {
        "csr": f"gather floor {est_ms['csr']:.3g} ms beats every dense "
               f"candidate (bcsr fill {bcsr_fill:.2%} < {BCSR_MIN_FILL:.1%},"
               f" dia {ndiag} diagonals)",
        "ell": f"near-uniform rows (waste {ell_waste:.2f}x): est_ms is "
               f"{ell_waste:.2f}x CSR's, but the plan-free static layout "
               "saves per-pass schedule build/dispatch overhead the cost "
               "model does not carry (budgeted at <=25% of a pass)",
        "dia": f"{ndiag} diagonals stream at {est_ms['dia']:.3g} ms vs "
               f"{est_ms['csr']:.3g} ms of gathers",
        "bcsr": f"block fill {bcsr_fill:.2%} >= {BCSR_MIN_FILL:.1%}: "
                f"block stream {est_ms['bcsr']:.3g} ms vs "
                f"{est_ms['csr']:.3g} ms of gathers",
    }[best]
    return adv


def choose_format(csr, **kw) -> str:
    """Recommended container name for ``csr`` ('csr'/'ell'/'dia'/'bcsr')."""
    return advise(csr, **kw).recommended
