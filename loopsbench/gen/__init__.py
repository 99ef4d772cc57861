"""Inputs made on the device, one module a generator: ``make(spec, seed,
device)``.

A graph's structure is drawn from a seed fixed by its spec, so that every
run seed gives the same graph, degree for degree, and runs with different
seeds do the same work. Where a generator orders the graph by the run
seed, it does so by a cyclic shift of the node ids (``shifted``).
"""
import hashlib
import json

import torch


def structure_generator(spec: dict, device) -> torch.Generator:
    """A generator on ``device`` seeded by a hash of ``spec``."""
    text = json.dumps(spec, sort_keys=True).encode()
    seed = int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
    return torch.Generator(device).manual_seed(seed)


def capped_cdf(n: int, total: int, top: int, exponent: float,
               device) -> torch.Tensor:
    """The CDF over ranks ``k = 1 .. n`` of weights ``(k + k0) **
    -exponent``, with the offset ``k0`` set so that the first rank's
    share of ``total`` draws is ``top``: a power law of rank whose largest
    expected degree is a published maximum (``k0 = 0`` where the plain
    law stays under it)."""
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)

    def first(k0: float) -> float:
        w = (k + k0) ** -exponent
        return total * float(w[0] / w.sum())

    lo, hi = 0.0, float(n)
    if first(lo) > top:
        for _ in range(60):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if first(mid) > top else (lo, mid)
    else:
        hi = 0.0
    cdf = torch.cumsum((k + hi) ** -exponent, 0)
    return cdf / cdf[-1].clone()


def draw(cdf: torch.Tensor, count: int, g: torch.Generator) -> torch.Tensor:
    """``count`` int64 ranks drawn from ``cdf``."""
    u = torch.rand(count, dtype=torch.float64, generator=g,
                   device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def shifted(src, dst, n: int, seed: int):
    """The edges with their node ids shifted cyclically by an amount drawn
    from ``seed``: the same graph, relabelled, its bands and runs of
    neighbouring ids kept."""
    from loopsbench.harness import sub_seed

    shift = sub_seed(seed, "order") % n
    return (src + shift) % n, (dst + shift) % n
