"""Plain PageRank as LDBC Graphalytics defines it: the yardstick of the
``pagerank.*`` cells.

    PR_0(v) = 1 / |V|
    PR_t(v) = (1 - d) / |V| + d * sum_{u -> v} PR_{t-1}(u) / out(u)
              + d / |V| * sum_{w : out(w) = 0} PR_{t-1}(w)

for a fixed number of iterations. Plain PyTorch from the raw edge list:
the out-degrees and the transition values are worked out here, and each
iteration is an ``index_add_`` over the edges. No module of the program,
nothing the program made.

The reference runs in float64. With ``store=torch.bfloat16`` it is the
control: the transition values and the ranks are rounded to bfloat16
where they are read, the sums kept in float32, the precision below the
configuration's float32.
"""
from __future__ import annotations

import torch


def pagerank(src, dst, n: int, damping: float, iterations: int,
             store=None) -> tuple[torch.Tensor, float]:
    """``(ranks, the last iteration's L1 change)`` of the graph of the
    edges ``src -> dst`` over ``n`` nodes."""
    out = torch.bincount(src, minlength=n)
    dangling = torch.nonzero(out == 0)[:, 0]
    dtype = torch.float64 if store is None else torch.float32
    w = damping / out[src].to(dtype)
    if store is not None:
        w = w.to(store).to(dtype)
    x = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    prev = x
    for _ in range(iterations):
        xr = x if store is None else x.to(store).to(dtype)
        y = torch.zeros(n, dtype=dtype, device=src.device)
        y.index_add_(0, dst, w * xr[src])
        y += (1.0 - damping) / n + damping / n * xr[dangling].sum()
        prev, x = x, y
    return x, float((x - prev).abs().sum())
