"""Message passing: gather -> edge transform -> segment aggregate.

The GNN layer primitive, on the port's sparse ops: every aggregation is a
scheduled, deterministic segmented reduction, never an atomic scatter.

``aggregate_operator(graph, op)`` with sum/mean/gcn semantics is one SpMM
over the (normalized) adjacency. Its gradient is a
``torch.autograd.Function`` whose backward is the same SpMM over Aᵀ —
K4 on a card, in both directions — or over A itself when A is symmetric
(the GCN-normalized adjacency of an undirected graph). Max/min and
explicit edge functions use the gather/segment form of
``edge_aggregate``.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats import CSC, CSR
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.schedule.plans import choose_schedule, spmm_route_for
from loops_tpu_torch.utils.platform import ensure_platform


def _transpose_csr(csr: CSR) -> CSR:
    csc = CSC.from_csr(csr)
    return CSR((csr.shape[1], csr.shape[0]), csc.offsets, csc.indices,
               csc.vals)


def _route_aggregation(adj, dtype, op: str = "gcn",
                       device="cuda") -> tuple[str, str]:
    """Resolve ``schedule="auto"`` to ``(schedule, impl)``.

    On a card with a fitted SpMM route (``schedule/plans.py``
    ``CARD_SPMM_ROUTES``, from the sweep's SpMM logs: K4 against the
    planes and the row segments, f32 and bf16, sum/gcn and mean), a CSR
    aggregation takes the route's pick. On another card a sum or GCN
    aggregation goes to K4 (``merge_path``/``pallas``) and a mean one to
    the ``group_mapped`` planes. Every CPU case takes the planes, as in
    ``loops_tpu``.
    """
    dev = ensure_platform(device)
    if dev.type == "cuda" and isinstance(adj, CSR):
        route = spmm_route_for(dev)
        if route is not None:
            schedule = choose_schedule(CsrLayout.from_csr(adj), route)
            return schedule, route["impl"][schedule]
        if op != "mean":
            return "merge_path", "pallas"
    return "group_mapped", "xla"


def _adjacency(graph: Graph, op: str, who: str) -> CSR:
    if op == "sum":
        return graph.adj
    if op == "mean":
        return graph.mean_normalized().adj
    if op == "gcn":
        return graph.gcn_normalized().adj
    raise ValueError(f"{who}: unsupported op {op!r}")


class _Propagate(torch.autograd.Function):
    """``y = A @ h`` with ``dh = Aᵀ @ dy``, each one SpMM operator call."""

    @staticmethod
    def forward(ctx, h, fwd_op, bwd_op):
        ctx.bwd_op = bwd_op
        return fwd_op(h)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd_op(g), None, None


def _with_gradient(fwd_op: SpMMOperator, bwd_op: SpMMOperator):
    """Give ``fwd_op`` the differentiable ``_fn`` the models call."""
    fwd_op._fn = lambda h: _Propagate.apply(h, fwd_op, bwd_op)
    fwd_op._vjp_op = bwd_op
    return fwd_op


def aggregate_operator(graph: Graph, op: str = "sum",
                       schedule: str = "auto", impl: str = "xla",
                       custom_vjp: bool = True, dtype=None, device="cuda"):
    """Build the SpMM operator ``h -> A @ h`` for sum/mean/gcn
    aggregation.

    ``schedule="auto"`` routes by ``_route_aggregation``. With
    ``custom_vjp=True`` the operator's ``._fn`` is differentiable: its
    backward is the forward-style SpMM over Aᵀ, planned with the same
    schedule — or the forward operator itself when A is symmetric (the
    test of ``loops_tpu``: equal structure and values within
    ``np.allclose``). ``custom_vjp=False`` returns the bare operator.
    """
    device = ensure_platform(device)
    adj = _adjacency(graph, op, "aggregate_operator")
    if schedule == "auto":
        schedule, impl = _route_aggregation(adj, dtype, op, device)
    if not custom_vjp:
        return SpMMOperator(adj, schedule=schedule, impl=impl, dtype=dtype,
                            device=device)
    return propagate_operator(adj, schedule, impl, dtype, device)


def propagate_operator(adj: CSR, schedule: str, impl: str, dtype=None,
                       device="cuda") -> SpMMOperator:
    """The SpMM operator ``h -> adj @ h`` with the differentiable
    ``._fn``: its backward is the same schedule's SpMM over ``adjᵀ``, or
    the forward operator itself where ``adj`` is symmetric."""
    fwd_op = SpMMOperator(adj, schedule=schedule, impl=impl, dtype=dtype,
                          device=device)
    adj_t = _transpose_csr(adj)
    symmetric = (
        adj.nnz == adj_t.nnz
        and np.array_equal(adj.offsets, adj_t.offsets)
        and np.array_equal(adj.indices, adj_t.indices)
        and np.allclose(adj.vals, adj_t.vals))
    bwd_op = fwd_op if symmetric else SpMMOperator(
        adj_t, schedule=schedule, impl=impl, dtype=dtype, device=device)
    return _with_gradient(fwd_op, bwd_op)


def _take_rows_csr(csr: CSR, idx: np.ndarray) -> CSR:
    """CSR row selection: rows ``idx`` of A, compacted to [M, N]."""
    idx = np.asarray(idx, np.int64)
    sizes = np.diff(csr.offsets)[idx]
    offs = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    total = int(offs[-1])
    pos = (np.repeat(csr.offsets[idx], sizes)
           + (np.arange(total, dtype=np.int64)
              - np.repeat(offs[:-1], sizes)))
    return CSR((len(idx), csr.shape[1]), offs, csr.indices[pos],
               csr.vals[pos])


def mask_rows(rows, n: int) -> np.ndarray:
    """The row indices a mask or an index array names.

    A bool or float mask of length ``n`` gives its nonzero rows, and so
    does an integer mask: an integer array of length ``n`` whose values
    are all 0 or 1 (``loops_tpu`` read such a mask as the row indices
    0 and 1). Any other integer array is a list of row indices in
    ``[0, n)``; out-of-range indices or another shape raise
    ``ValueError``.
    """
    rows = np.asarray(rows)
    if rows.ndim != 1:
        raise ValueError(f"rows must be 1-D, got shape {rows.shape}")
    kind = rows.dtype.kind
    if kind in "bf":
        if len(rows) != n:
            raise ValueError(f"a mask of length {len(rows)} for {n} rows")
        return np.nonzero(rows > 0)[0]
    if kind not in "iu":
        raise ValueError(f"rows of dtype {rows.dtype}: expected a mask or "
                         "integer row indices")
    if len(rows) == n and np.isin(rows, (0, 1)).all():
        return np.nonzero(rows)[0]
    if len(rows) and (rows.min() < 0 or rows.max() >= n):
        raise ValueError(f"row indices outside [0, {n})")
    return rows.astype(np.int64)


def masked_aggregate_operator(graph: Graph, rows, op: str = "gcn",
                              schedule: str = "auto", impl: str = "xla",
                              dtype=None, device="cuda"):
    """Aggregation restricted to the output rows the loss reads.

    Full-graph training only consumes logits at the labeled rows, so the
    last layer's propagation, forward and backward, restricts exactly:

        fwd:  y_m = A[rows, :] @ z          [M, F]
        bwd:  dz  = A[rows, :]ᵀ @ dy_m      [N, F]

    Normalization uses the full graph's degrees: the submatrix is taken
    from the already-normalized adjacency. ``rows`` is a mask or row
    indices (``mask_rows``). Returns an operator whose ``._fn`` maps
    [N, F] -> [M, F]; ``.rows`` holds the row indices.
    """
    device = ensure_platform(device)
    adj = _adjacency(graph, op, "masked_aggregate_operator")
    rows = mask_rows(rows, graph.num_nodes)
    sub = _take_rows_csr(adj, rows)
    if schedule == "auto":
        schedule, impl = _route_aggregation(sub, dtype, op, device)
    fwd_op = SpMMOperator(sub, schedule=schedule, impl=impl, dtype=dtype,
                          device=device)
    bwd_op = SpMMOperator(_transpose_csr(sub), schedule=schedule, impl=impl,
                          dtype=dtype, device=device)
    fwd_op.rows = rows
    return _with_gradient(fwd_op, bwd_op)


def edge_aggregate(graph: Graph, h: torch.Tensor, edge_fn=None,
                   op: str = "sum") -> torch.Tensor:
    """General form: messages = edge_fn(h[src], edge_weight) aggregated at
    destinations, ``op`` in {sum, mean, max, min}: sorted segment
    reductions over the CSR rows (``torch.segment_reduce``). A node with
    no incoming edge gets 0 (sum, mean) or -inf / +inf (max / min), as
    ``jax.ops.segment_max`` / ``segment_min`` give."""
    adj = graph.adj
    dev = h.device
    src = torch.from_numpy(adj.indices.astype(np.int64)).to(dev)
    w = torch.from_numpy(adj.vals).to(dev)
    lengths = torch.from_numpy(adj.row_sizes().astype(np.int64)).to(dev)
    msgs = h[src]
    if edge_fn is not None:
        msgs = edge_fn(msgs, w)

    def reduce(data, how, initial=None):
        return torch.segment_reduce(data, how, lengths=lengths, axis=0,
                                    unsafe=True, initial=initial)
    if op == "sum":
        return reduce(msgs, "sum")
    if op == "mean":
        deg = torch.clamp(lengths.to(msgs.dtype), min=1.0)
        return reduce(msgs, "sum") / deg.reshape((-1,) + (1,) * (msgs.dim() - 1))
    if op == "max":
        return reduce(msgs, "max", -float("inf"))
    if op == "min":
        return reduce(msgs, "min", float("inf"))
    raise ValueError(f"edge_aggregate: unsupported op {op!r}")
