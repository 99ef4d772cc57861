"""Schedule-driven attention aggregation: the fused GAT and GATv2 layer
cores.

The port of ``loops_tpu/ops/attention.py``. The textbook GAT layer
materializes per-edge arrays and reduces them by destination::

    e     = leaky_relu(s_src[src] + s_dst[dst])         [E, H]
    alpha = segment_softmax(e, dst)                     [E, H]
    out   = segment_sum(alpha[..., None] * hw[src], dst) [N, H, D]

Under the group_mapped schedule a destination row is one window of a
degree-class plane, so the softmax's domain is the window and the layer
runs plane by plane: per bucket (rows of one degree class, a plane
[tiles, pitch]) a gather, the leaky ReLU, the masked max, ``exp``, the
masked sums, and one plain store of the bucket's rows.

Nothing here scatters: no ``index_add_``, no
``index_put_(accumulate=True)``, no float atomics, forward or backward,
so results and gradients repeat bit for bit on the card. Each plane
gather is one gather over every bucket's plane at once with the sorted
segment-sum backward of ``ops/segment.Gather``. A gather by the buckets'
rows (unique within and across buckets) has a row store into zeros for
its backward, and the store of those rows a gather.

``GroupedAttentionAggregate(grad=True)`` differentiates by a backward
that runs forward-style over the transposed plan (edges grouped by
source), as ``loops_tpu``'s custom VJP does; ``grad=False`` lets autograd
run through the forward. ``GroupedAttentionV2`` is always differentiated
by autograd: its score is not a sum of node halves.

The leaky ReLU's slope test is ``x >= 0``, as ``jax.nn.leaky_relu`` and
its gradient at 0 give (``torch.nn.functional.leaky_relu``'s backward
tests ``x > 0``).

``dtype="bfloat16"``: the feature rows ``hw`` (and in the backward the
cotangent ``g``) are rounded to bf16 before they are gathered, each
product of a softmax weight and a feature is rounded to bf16, and the
sums are f32. The score halves ``s_src`` and ``s_dst``, the shift ``m``,
the denominator and the correction ``c`` stay f32, as the comment of
``loops_tpu/ops/attention.py:59-61`` says. ``loops_tpu``'s bf16 path
rounds them through bf16 with the feature rows (``:153-162``,
``:239-254``), a lever against the TPU's per-element gathers that buys
nothing on the card: this port departs from it there on purpose, and
``tests/test_torch_attention.py`` shows by how much. GATv2's bf16 rounds
``u`` and ``vals`` only, as ``loops_tpu`` does.

Plans are built on the host with numpy and staged once per adjacency and
device (kept on the CSR container), as int64 index tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats import CSR
from loops_tpu_torch.formats.convert import stable_argsort
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.segment import Gather
from loops_tpu_torch.ops.spmv import op_cache
from loops_tpu_torch.schedule.plans import make_plan
from loops_tpu_torch.utils.platform import ensure_platform, resolve_device

__all__ = ["GroupedAttentionAggregate", "GroupedAttentionV2",
           "reference_attention_aggregate", "leaky_relu"]


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``slope * x``; the gradient at 0 is 1,
    as ``jax.nn.leaky_relu``'s."""
    return torch.where(x >= 0, x, slope * x)


def _half(dtype):
    if dtype is None:
        return None
    if dtype != "bfloat16":
        raise ValueError(f"attention dtype={dtype!r}: expected None or "
                         "'bfloat16'")
    return torch.bfloat16


def _store(x: torch.Tensor, rows: torch.Tensor, n: int,
           fill: float = 0.0) -> torch.Tensor:
    """A [n, ...] tensor of ``fill`` holding ``x``'s rows at ``rows``
    (unique): a plain store."""
    out = x.new_full((n,) + tuple(x.shape[1:]), fill)
    return out.index_copy_(0, rows, x)


class _RowStore(torch.autograd.Function):
    """``_store(x, rows, n)``; the gradient is ``g[rows]``."""

    @staticmethod
    def forward(ctx, x, rows, n):
        ctx.rows = rows
        return _store(x, rows, n)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.rows), None, None


class _RowTake(torch.autograd.Function):
    """``table[rows]`` for unique ``rows``; the gradient is a row store
    into zeros."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.rows, ctx.n = rows, table.shape[0]
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        return _store(g, ctx.rows, ctx.n), None


class _Planes:
    """One adjacency's group_mapped planes staged on a device.

    Per bucket: its rows (``tiles``, concatenated over the buckets into
    ``self.tiles``), the plane's shape [t, p] and ``pad`` [t, p], true on
    padded slots. ``gather`` reads a table [rows, C] over every plane at
    once (one gather over the concatenated flat planes, then split per
    bucket), ``take`` a table's rows of every bucket, ``store`` the
    buckets' rows back into one [n, C] tensor. ``plan`` keeps the host
    plan.
    """

    def __init__(self, csr: CSR, device):
        self.plan = make_plan(CsrLayout.from_csr(csr), "group_mapped")
        buckets = self.plan.buckets
        if not buckets:
            raise ValueError("attention over an adjacency with no nonzeros")
        self.n = csr.shape[0]
        self.shapes = [b["atom_slots"].shape for b in buckets]
        self.slots = [t * p for t, p in self.shapes]
        self.rows = [t for t, _ in self.shapes]
        idx = np.concatenate([csr.indices[b["atom_slots"]].reshape(-1)
                              for b in buckets])
        valid = np.concatenate([b["valid"].reshape(-1) for b in buckets])
        # a padded slot reads a real row and passes back a zero gradient
        self._gather = Gather(idx, csr.shape[1], device, keep=valid)
        self.tiles = torch.from_numpy(np.concatenate(
            [b["tiles"] for b in buckets]).astype(np.int64)).to(device)
        self.pad = [torch.from_numpy(~b["valid"]).to(device)
                    for b in buckets]

    def gather(self, table: torch.Tensor) -> list:
        """``table`` [rows, C] over each bucket's plane: [t, p, C] each."""
        flat = self._gather(table)
        return [x.reshape(t, p, -1)
                for x, (t, p) in zip(flat.split(self.slots), self.shapes)]

    def take(self, table: torch.Tensor) -> list:
        """``table``'s rows of each bucket: [t, C] each."""
        return list(_RowTake.apply(table, self.tiles).split(self.rows))

    def store(self, parts) -> torch.Tensor:
        """Each bucket's [t, C] rows in one [n, C] tensor, zero elsewhere."""
        return _RowStore.apply(torch.cat(parts), self.tiles, self.n)


class _Transposed:
    """The custom backward's plan: the transposed adjacency's planes
    (edges grouped by source; ``loops_tpu/ops/attention.py:95-139``) and
    ``fwd_map``, which gives each forward plane slot its edge's slot in
    the transposed planes' flat order, and a padded slot the zero row
    appended after them."""

    def __init__(self, csr: CSR, fwd: _Planes, device):
        n_rows, n_cols = csr.shape
        src = csr.indices.astype(np.int64)
        perm = stable_argsort(src, n_cols)
        offsets_t = np.zeros(n_cols + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n_cols), out=offsets_t[1:])
        adj_t = CSR((n_cols, n_rows), offsets_t, csr.row_ids()[perm],
                    csr.vals[perm])
        self.planes = _Planes(adj_t, device)
        inv = np.zeros(csr.nnz, np.int64)    # edge id -> transposed slot
        off = 0
        for b in self.planes.plan.buckets:
            slots, valid = b["atom_slots"], b["valid"]
            pos = off + np.arange(slots.size).reshape(slots.shape)
            inv[perm[slots[valid]]] = pos[valid]
            off += slots.size
        fwd_map = np.concatenate([
            np.where(b["valid"], inv[b["atom_slots"]], off).reshape(-1)
            for b in fwd.plan.buckets])
        self.fwd_map = torch.from_numpy(fwd_map).to(device)


def _staged(adj: CSR, device, transposed: bool = False):
    """The planes of ``adj`` on ``device`` (with ``transposed``, the
    backward's), built once and kept on the container."""
    cache = op_cache(adj, "_attention_planes")
    key = (str(resolve_device(device)), transposed)
    if key not in cache:
        cache[key] = (_Transposed(adj, _staged(adj, device), device)
                      if transposed else _Planes(adj, device))
    return cache[key]


def _softmax_sum(e, pad, f):
    """The softmax of the scores ``e`` [t, p, H] over each plane row (the
    padded slots ``pad`` [t, p] left out) and the weighted sum of the
    features ``f`` [t, p, H, D], each product in ``f``'s type, summed in
    f32: ``(out [t, H, D], m [t, H], den [t, H])``. The shift ``m`` is
    taken without a gradient: the softmax does not depend on it."""
    e = e.masked_fill(pad[..., None], -torch.inf)
    m = e.detach().amax(dim=1, keepdim=True)
    z = torch.exp(e - m)                      # 0 on the padded slots
    den = z.sum(dim=1)
    agg = _weighted_sum(z, f)
    return agg / den.clamp(min=1e-30)[..., None], m[:, 0], den


def _weighted_sum(w, f):
    """``sum_p w[t, p, h] * f[t, p, h, :]`` with each product in ``f``'s
    type and the sum in f32: [t, H, D]."""
    wf = w.to(f.dtype)
    if f.dtype != torch.float32 and torch.is_grad_enabled() and (
            w.requires_grad or f.requires_grad):
        # two bf16 values multiply exactly in f32: the product formed there
        # and rounded is the bf16 product, and autograd then carries its
        # gradients in f32 (a bf16 backward loses the softmax's gradient
        # to cancellation)
        prod = (wf.float()[..., None] * f.float()).to(f.dtype)
    else:
        prod = wf[..., None] * f
    return prod.sum(dim=1, dtype=torch.float32)


class _Aggregate(torch.autograd.Function):
    """The fused forward, differentiated by the transposed-plan backward."""

    @staticmethod
    def forward(ctx, s_src, s_dst, hw, op):
        out, m_arr, den_arr = op._forward(s_src, s_dst, hw, stats=True)
        ctx.op = op
        ctx.save_for_backward(s_src, s_dst, hw, out, m_arr, den_arr)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*ctx.op._backward(g, *ctx.saved_tensors), None)


class GroupedAttentionAggregate:
    """Fused masked-softmax attention aggregation over a fixed graph.

    ``op(s_src, s_dst, hw) -> [N, H, D]``: ``s_src`` and ``s_dst`` are
    per-node per-head logit halves [N, H], ``hw`` the transformed
    features [N, H, D], all float32 on the op's device; the result is
    the softmax over each destination's incoming edges followed by the
    weighted sum, as ``segment_softmax`` and ``segment_sum`` give. A row
    with no incoming edge gets 0.

    ``grad=True`` differentiates by one forward-style pass over the
    transposed plan (``_backward``); ``grad=False`` by autograd through
    the forward.
    """

    def __init__(self, adj: CSR, negative_slope: float = 0.2, dtype=None,
                 grad: bool = True, device="cuda"):
        self.device = ensure_platform(device)
        self.negative_slope = float(negative_slope)
        self._half = _half(dtype)
        self.grad = grad
        self.planes = _staged(adj, self.device)
        self.transposed = (_staged(adj, self.device, transposed=True)
                           if grad else None)

    def __call__(self, s_src, s_dst, hw) -> torch.Tensor:
        if self.grad:
            return _Aggregate.apply(s_src, s_dst, hw, self)
        return self._forward(s_src, s_dst, hw)[0]

    def _forward(self, s_src, s_dst, hw, stats: bool = False):
        """``loops_tpu``'s ``_fn`` (``:141-211``): the output and, with
        ``stats``, each row's shift ``m`` (0 on rows with no edge) and
        denominator (1 there), which keep padded backward lanes finite."""
        n, H, D = hw.shape
        P = self.planes
        hw2 = hw.reshape(n, H * D)
        if self._half is not None:
            hw2 = hw2.to(self._half)
        outs, ms, dens = [], [], []
        for pad, sg, f, sd in zip(P.pad, P.gather(s_src), P.gather(hw2),
                                  P.take(s_dst)):
            t, p = pad.shape
            e = leaky_relu(sg + sd[:, None, :], self.negative_slope)
            out, m, den = _softmax_sum(e, pad, f.reshape(t, p, H, D))
            outs.append(out.reshape(t, H * D))
            ms.append(m)
            dens.append(den)
        out = P.store(outs).reshape(n, H, D)
        if not stats:
            return out, None, None
        return (out, _store(torch.cat(ms), P.tiles, n),
                _store(torch.cat(dens), P.tiles, n, fill=1.0))

    def _backward(self, g, s_src, s_dst, hw, out, m_arr, den_arr):
        """``loops_tpu``'s ``_bwd_fn`` (``:213-309``) over the transposed
        plan, where a plane row is one source node:

        * the softmax correction ``c_r = sum_j alpha_j <g_r, f_j>`` is
          ``<g_r, out_r>``: no per-edge work;
        * ``hw[src]`` is a row of the plane's source (one row gather) and
          the only wide gather is ``g[dst]``;
        * ``dhw[src] = sum alpha g[dst]`` and ``ds_src[src] = sum dpre``
          are row sums of the transposed planes; ``ds_dst[dst] = sum
          dpre`` reads ``dpre`` back into the forward planes through
          ``fwd_map``.
        """
        n, H, D = hw.shape
        slope = self.negative_slope
        g = g.contiguous()
        c = (g * out).sum(dim=-1)                          # [N, H]
        # the destination's statistics, gathered together, in f32
        stats = torch.cat([s_dst, m_arr, den_arr, c], dim=1)
        hw2, g2 = hw.reshape(n, H * D), g.reshape(n, H * D)
        if self._half is not None:
            hw2, g2 = hw2.to(self._half), g2.to(self._half)
        T = self.transposed.planes
        dhw, ds_src, dpre = [], [], []
        for pad, G, R, ss, f in zip(T.pad, T.gather(g2), T.gather(stats),
                                    T.take(s_src), T.take(hw2)):
            t, p = pad.shape
            sd, m, den, cc = R.split(H, dim=-1)           # [t, p, H] each
            pre = ss[:, None, :] + sd
            pos = pre >= 0
            e = torch.where(pos, pre, slope * pre)
            alpha = (torch.exp(e - m) / den.clamp(min=1e-30)).masked_fill(
                pad[..., None], 0.0)
            G = G.reshape(t, p, H, D)
            u = (G * f.reshape(t, 1, H, D)).sum(dim=-1, dtype=torch.float32)
            d = alpha * (u - cc)
            d = torch.where(pos, d, slope * d)
            dhw.append(_weighted_sum(alpha, G).reshape(t, H * D))
            ds_src.append(d.sum(dim=1))
            dpre.append(d.reshape(t * p, H))
        dpre.append(dpre[-1].new_zeros(1, H))             # padded slots
        vals = torch.cat(dpre).index_select(0, self.transposed.fwd_map)
        P = self.planes
        ds_dst = [v.reshape(t, p, H).sum(dim=1)
                  for v, (t, p) in zip(vals.split(P.slots), P.shapes)]
        return (_store(torch.cat(ds_src), T.tiles, n),
                _store(torch.cat(ds_dst), P.tiles, n),
                _store(torch.cat(dhw), T.tiles, n).reshape(n, H, D))


class GroupedAttentionV2:
    """Fused GATv2 attention aggregation over a fixed graph.

    ``op(u, v, a, vals) -> [N, H, D]``: ``u`` and ``vals`` are per-source
    transforms [N, H, D] (GATv2 passes ``vals`` = ``u``), ``v`` the
    per-destination transform, ``a`` the attention vectors [H, D]; the
    score ``e_ij = a . leaky_relu(u_j + v_i)`` is a per-edge vector
    computation, run in the same plane windows as
    ``GroupedAttentionAggregate``. Autograd differentiates it.
    """

    def __init__(self, adj: CSR, negative_slope: float = 0.2, dtype=None,
                 device="cuda"):
        self.device = ensure_platform(device)
        self.negative_slope = float(negative_slope)
        self._half = _half(dtype)
        self.planes = _staged(adj, self.device)

    def __call__(self, u, v, a, vals) -> torch.Tensor:
        n, H, D = u.shape
        P = self.planes
        u2, vals2 = u.reshape(n, H * D), vals.reshape(n, H * D)
        if self._half is not None:
            u2, vals2 = u2.to(self._half), vals2.to(self._half)
        us = P.gather(u2)
        fs = us if vals is u else P.gather(vals2)
        outs = []
        for pad, uu, f, vv in zip(P.pad, us, fs,
                                  P.take(v.reshape(n, H * D))):
            t, p = pad.shape
            pre = uu.reshape(t, p, H, D).float() + vv.reshape(t, 1, H, D)
            e = (leaky_relu(pre, self.negative_slope) * a).sum(dim=-1)
            out, _, _ = _softmax_sum(e, pad, f.reshape(t, p, H, D))
            outs.append(out.reshape(t, H * D))
        return P.store(outs).reshape(n, H, D)


def reference_attention_aggregate(adj: CSR, s_src, s_dst, hw,
                                  negative_slope: float = 0.2, rows=None):
    """Per-edge numpy oracle (segment-softmax semantics), in float64 over
    float32 scores; ``rows`` (default all) names the destination rows to
    compute, the others stay 0. Returns float32 [N, H, D]."""
    n = adj.shape[0]
    src = adj.indices
    out = np.zeros((n,) + hw.shape[1:], np.float64)
    for r in (range(n) if rows is None else rows):
        a0, a1 = adj.offsets[r], adj.offsets[r + 1]
        if a0 == a1:
            continue
        e = s_src[src[a0:a1]] + s_dst[r]
        er = np.where(e >= 0, e, negative_slope * e).astype(np.float64)
        z = np.exp(er - er.max(axis=0, keepdims=True))
        alpha = z / z.sum(axis=0, keepdims=True)
        out[r] = np.einsum("ph,phd->hd", alpha,
                           hw[src[a0:a1]].astype(np.float64))
    return out.astype(np.float32)
