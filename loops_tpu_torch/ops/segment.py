"""Segmented primitives over edge arrays.

The port of ``loops_tpu/ops/segment.py``: ``segment_sum``,
``segment_max``, ``segment_mean`` and ``segment_softmax`` over data of
shape [E] or [E, H] and ``segment_ids`` [E] in ``[0, num_segments)``.

Each is a sorted reduction: ``torch.segment_reduce`` over per-segment
lengths from ``bincount``, each segment summed in storage order. Unsorted
ids are first put in order by a stable argsort. Nothing here scatters:
no ``index_add_``, no ``index_put_(accumulate=True)``, no float atomics,
forward or backward, so the results and gradients are bitwise repeatable
on the card. Autograd's own backward of a gather is an atomic
scatter-add there, so the two gathers that carry a gradient have their
own: the permutation into id order and back (the inverse permutation)
and the softmax's ``denom[segment_ids]`` (a sorted segment sum).
``Gather`` gives any gather by fixed ids that sorted backward (the
attention ops and GAT's per-edge path use it).

As ``jax.ops.segment_*`` give, an empty segment gives 0 for sum and
mean and -inf for max (``torch.segment_reduce``'s own mean would give
NaN there). ``segment_max``'s gradient is split equally between the
entries that tie for a segment's max, as JAX splits it. ``sorted_ids=True``
is a promise, as ``indices_are_sorted`` is in JAX: ids that are not
sorted then give wrong sums. Ids past ``num_segments`` or below 0 raise
``ValueError`` (JAX drops them).
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats.convert import stable_argsort

__all__ = ["segment_sum", "segment_max", "segment_mean", "segment_softmax",
           "Gather"]


class _Permute(torch.autograd.Function):
    """``x[perm]`` for a permutation ``perm`` whose inverse is
    ``inverse``; the gradient is ``g[inverse]``, a gather too."""

    @staticmethod
    def forward(ctx, x, perm, inverse):
        ctx.inverse = inverse
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.inverse), None, None


class _SegmentGather(torch.autograd.Function):
    """``table[ids]``; the gradient is the sorted segment sum of ``g`` over
    ``ids``, with ``lengths`` entries of each row of ``table``. ``order``
    (None where ``ids`` are sorted) lists the entries that carry a
    gradient in id order: a stable argsort of ``ids``, or of the entries
    kept. A half-precision ``g`` is summed in float32."""

    @staticmethod
    def forward(ctx, table, ids, lengths, order=None):
        ctx.lengths, ctx.order = lengths, order
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        if ctx.order is not None:
            g = g.index_select(0, ctx.order)
        if g.dtype in (torch.float16, torch.bfloat16):
            g = g.float()
        return _reduce(g.contiguous(), "sum", ctx.lengths), None, None, None


class Gather:
    """``table[ids]`` for ``ids`` fixed when it is built, staged on
    ``device``, with a deterministic backward: the sorted segment sum of
    the gradient over ``ids`` (autograd's own backward of a gather is an
    atomic scatter-add on the card). Only the entries where ``keep`` is
    true (default: all) pass a gradient back: the others must receive a
    zero one."""

    def __init__(self, ids, num_rows: int, device, keep=None):
        ids = np.asarray(ids, np.int64).reshape(-1)
        kept = (np.arange(len(ids)) if keep is None
                else np.flatnonzero(np.asarray(keep).reshape(-1)))
        order = kept[stable_argsort(ids[kept], num_rows)]
        self.ids = torch.from_numpy(ids).to(device)
        self.lengths = torch.from_numpy(
            np.bincount(ids[kept], minlength=num_rows)).to(device)
        self.order = (None if np.array_equal(order, np.arange(len(ids)))
                      else torch.from_numpy(order).to(device))

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        return _SegmentGather.apply(table, self.ids, self.lengths, self.order)


def _reduce(data, how, lengths):
    return torch.segment_reduce(data, how, lengths=lengths, axis=0,
                                unsafe=True)


def _in_order(data, segment_ids, num_segments, sorted_ids):
    """``(data, ids, lengths, order)``: ``data`` and its ids in id order,
    the entries of each segment, and ``(perm, inverse)`` of the stable
    sort (None where ``sorted_ids``)."""
    ids = segment_ids
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.asarray(ids))
    ids = ids.to(data.device).long()
    if ids.dim() != 1 or ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_ids of shape {tuple(ids.shape)} for data "
                         f"of shape {tuple(data.shape)}")
    if ids.numel() and int(ids.min()) < 0:
        raise ValueError("negative segment ids")
    lengths = torch.bincount(ids, minlength=num_segments)
    if lengths.numel() > num_segments:
        raise ValueError(f"segment ids past num_segments={num_segments}")
    if sorted_ids:
        return data.contiguous(), ids, lengths, None
    perm = torch.argsort(ids, stable=True)
    inverse = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.numel(), device=perm.device))
    data = _Permute.apply(data, perm, inverse).contiguous()
    return data, ids.index_select(0, perm), lengths, (perm, inverse)


def segment_sum(data, segment_ids, num_segments, sorted_ids=False):
    data, _, lengths, _ = _in_order(data, segment_ids, num_segments,
                                    sorted_ids)
    return _reduce(data, "sum", lengths)


def segment_max(data, segment_ids, num_segments, sorted_ids=False):
    data, _, lengths, _ = _in_order(data, segment_ids, num_segments,
                                    sorted_ids)
    return _reduce(data, "max", lengths)


def segment_mean(data, segment_ids, num_segments, sorted_ids=False):
    data, _, lengths, _ = _in_order(data, segment_ids, num_segments,
                                    sorted_ids)
    s = _reduce(data, "sum", lengths)
    cnt = torch.clamp(lengths.to(s.dtype), min=1)
    return s / cnt.reshape((-1,) + (1,) * (s.dim() - 1))


def segment_softmax(scores, segment_ids, num_segments, sorted_ids=False):
    """Numerically stable softmax within each segment.

    scores [E] (or [E, H] for multi-head), segment_ids [E] -> normalized
    weights of the same shape. The shift is each segment's max, taken
    without a gradient: the softmax does not depend on it. Empty segments
    contribute nothing.
    """
    s, ids, lengths, order = _in_order(scores, segment_ids, num_segments,
                                       sorted_ids)
    mx = _reduce(s.detach(), "max", lengths)
    # an empty segment's -inf is never read: its id appears in no entry
    e = torch.exp(s - mx.index_select(0, ids))
    denom = _reduce(e, "sum", lengths)
    alpha = e / torch.clamp(_SegmentGather.apply(denom, ids, lengths),
                            min=1e-30)
    if order is None:
        return alpha
    perm, inverse = order
    return _Permute.apply(alpha, inverse, perm)
