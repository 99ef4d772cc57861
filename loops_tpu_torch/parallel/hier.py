"""Hierarchical (host x chip) halo exchange: the multi-host tier.

The port of ``loops_tpu/parallel/hier.py``; the plan is the JAX
package's, array for array. A cluster has two classes of link: a fast
one among one host's devices (NVLink on an H100 host, ICI on a TPU host)
and a slower one between hosts (the network, DCN). The flat halo
exchange (``parallel/halo.py``) ships every pairwise halo over whatever
link joins the pair: when several ranks of host A need the same row of
host B, it crosses between the hosts once per requesting rank.

This tier plans a two-stage exchange over a ``("host", "chip")`` mesh
(``parallel/mesh.make_mesh_hier``):

1.  **Host stage** (``all_to_all`` over ``"host"``): each destination
    host's requests are **deduplicated across its ranks**, so a row
    crosses between two hosts once. A row travels on the channel of its
    owner's chip index: the stage exchanges among ranks of one chip
    index.
2.  **Chip stage** (``all_to_all`` over ``"chip"``): one redistribution
    within each host delivers both the locally owned halo rows and the
    rows that landed in stage 1 to the ranks that reference them.

Edge columns are remapped at plan time into each rank's
``[local rows | chip-stage slots]`` column space, so the local reduction
is the one of the flat halo (K4 on a card). Both exchanges send their
gradient back the same way, so DistGCN trains through this exchange
unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.parallel.graph_partition import EdgePartition
from loops_tpu_torch.parallel.halo import (
    as_rows,
    local_operator,
    remote_refs,
    send_gather,
)
from loops_tpu_torch.parallel.mesh import (
    all_to_all,
    axis_group,
    axis_rank,
    mesh_device,
)

__all__ = ["HierHaloPlan", "DistSpMMHier"]


@dataclass
class HierHaloPlan:
    part: EdgePartition
    hosts: int
    chips: int
    Hd: int                    # padded host-stage package per (rank, host)
    Hi: int                    # padded chip-stage package per (rank, chip)
    dcn_idx: np.ndarray        # [P, hosts, Hd] owner-local rows
    dcn_valid: np.ndarray      # [P, hosts, Hd] bool
    ici_idx: np.ndarray        # [P, chips, Hi] into [R | hosts*Hd]
    ici_valid: np.ndarray      # [P, chips, Hi] bool
    indices_local: np.ndarray  # [P, nnz_pd] edge cols in [R | chips*Hi]

    @classmethod
    def build(cls, part: EdgePartition, hosts: int,
              chips: int) -> "HierHaloPlan":
        P = part.num_devices
        if P != hosts * chips:
            raise ValueError(
                f"partition has {P} devices, mesh is {hosts}x{chips}")
        R = part.rows_per_dev
        N = int(part.num_nodes)

        # ---- unique remote references (dev, col), as in HaloPlan ----
        refs = remote_refs(part)
        inv, up, ucol, uq = refs.inv, refs.up, refs.ucol, refs.uq
        uh_dst, uc_dst = up // chips, up % chips
        uh_src = uq // chips

        # ---- host packages: dedup per (dst host, col) across chips ----
        cross = uh_src != uh_dst
        ck = uh_dst[cross] * N + ucol[cross]
        cuk = np.unique(ck)
        chd = cuk // N                       # destination host
        ccol = cuk % N
        cq = part.owner_of(ccol).astype(np.int64)   # owner rank = channel
        # slots within each (owner rank, dst host) group
        gk = cq * hosts + chd
        order_d = np.argsort(gk, kind="stable")
        gk_s = gk[order_d]
        new_g = np.r_[True, np.diff(gk_s) != 0]
        gstart = np.flatnonzero(new_g)
        slot_s = np.arange(len(gk_s)) - gstart[np.cumsum(new_g) - 1]
        slot_d = np.empty(len(gk_s), np.int64)
        slot_d[order_d] = slot_s
        Hd = max(int(np.diff(np.r_[gstart, len(gk_s)]).max(initial=1)), 1)

        dcn_idx = np.zeros((P, hosts, Hd), INDEX_DTYPE)
        dcn_valid = np.zeros((P, hosts, Hd), bool)
        dcn_idx[cq, chd, slot_d] = (ccol - part.row_starts[cq]
                                    ).astype(INDEX_DTYPE)
        dcn_valid[cq, chd, slot_d] = True
        # landed coordinate of (dst host, col) on rank (chd, cq%chips):
        # flattened (src host, slot) in its [hosts, Hd] landed table
        landed_flat = (cq // chips) * Hd + slot_d     # aligned with cuk
        landed_chan = cq % chips

        # ---- chip packages: one entry per unique (dst rank, col) ----
        # sender + source-table index per unique remote ref
        sender = uq.copy()       # same-host: the owner ships its row
        src_idx = ucol - part.row_starts[uq]
        # cross-host refs: the row landed on (dst host, owner-chip
        # channel) in the host stage; that rank redistributes it
        if cross.any():
            look = uh_dst[cross] * N + ucol[cross]
            posn = np.searchsorted(cuk, look)
            sender[cross] = uh_dst[cross] * chips + landed_chan[posn]
            src_idx[cross] = R + landed_flat[posn]
        # slots within each (sender rank, dst chip) group
        gk2 = sender * chips + uc_dst
        order_i = np.argsort(gk2, kind="stable")
        gk2_s = gk2[order_i]
        new_g2 = np.r_[True, np.diff(gk2_s) != 0]
        gstart2 = np.flatnonzero(new_g2)
        slot2_s = np.arange(len(gk2_s)) - gstart2[np.cumsum(new_g2) - 1]
        slot2 = np.empty(len(gk2_s), np.int64)
        slot2[order_i] = slot2_s
        Hi = max(int(np.diff(np.r_[gstart2, len(gk2_s)]).max(initial=1)),
                 1)

        ici_idx = np.zeros((P, chips, Hi), INDEX_DTYPE)
        ici_valid = np.zeros((P, chips, Hi), bool)
        ici_idx[sender, uc_dst, slot2] = src_idx.astype(INDEX_DTYPE)
        ici_valid[sender, uc_dst, slot2] = True

        # ---- edge column remap into [local | chips*Hi] space ----
        # a remote ref (p, col) arrives at p from sender chip
        # (sender % chips) in slot2 -> R + chip*Hi + slot
        arrive = R + (sender % chips) * Hi + slot2
        indices_local = refs.remap(part, arrive[inv])
        return cls(part, hosts, chips, Hd, Hi, dcn_idx, dcn_valid,
                   ici_idx, ici_valid, indices_local)

    # ------------------------------------------------------------ stats
    def volume_stats(self) -> dict:
        """Exchange volumes in rows per layer. ``dcn_flat_rows`` is what
        the flat all-to-all would ship between hosts (once per requesting
        rank), ``dcn_hier_rows`` the host-deduplicated volume: their
        ratio is the hierarchy's saving on the slow link."""
        # the flat plan ships one row per unique (rank, col) reference
        refs = remote_refs(self.part)
        dcn_flat = int(np.count_nonzero(refs.up // self.chips
                                        != refs.uq // self.chips))
        dcn_hier = int(self.dcn_valid.sum())
        ici_hier = int(self.ici_valid.sum())
        return {"dcn_flat_rows": dcn_flat, "dcn_hier_rows": dcn_hier,
                "dcn_dedup_factor": dcn_flat / max(dcn_hier, 1),
                "ici_rows": ici_hier}


class DistSpMMHier:
    """Distributed SpMM over a ``("host", "chip")`` mesh with the
    two-stage exchange, rank p's part (p = host * chips + chip):
    ``op(h) : [rows_per_dev, F] -> [rows_per_dev, F]``, as DistSpMM and
    DistSpMMHalo."""

    def __init__(self, plan: HierHaloPlan, mesh):
        if tuple(mesh.mesh_dim_names) != ("host", "chip"):
            raise ValueError(
                f'mesh axes must be ("host", "chip"), got '
                f"{tuple(mesh.mesh_dim_names)}")
        self.plan = plan
        self.mesh = mesh
        part = plan.part
        R, C = part.rows_per_dev, plan.chips
        self.device = mesh_device(mesh)
        self.host_group = axis_group(mesh, "host")
        self.chip_group = axis_group(mesh, "chip")
        self.p = p = axis_rank(mesh, "host") * C + axis_rank(mesh, "chip")
        self.send_host = send_gather(plan.dcn_idx[p], plan.dcn_valid[p], R,
                                     self.device)
        self.send_chip = send_gather(plan.ici_idx[p], plan.ici_valid[p],
                                     R + plan.hosts * plan.Hd, self.device)
        self.local = local_operator(
            part.local_csr(p, plan.indices_local, R + C * plan.Hi),
            self.device)
        self.operators = [self.local]

    def __call__(self, h) -> torch.Tensor:
        h = as_rows(h, self.device)
        # stage 1: host-deduplicated packages, each on its owner's chip
        # index's channel
        landed = all_to_all(self.send_host(h), self.host_group)
        table1 = torch.cat([h, landed])
        # stage 2: one redistribution within the host of the locally
        # owned halo rows and the rows landed in stage 1
        halo = all_to_all(self.send_chip(table1), self.chip_group)
        return self.local._fn(torch.cat([h, halo]))
