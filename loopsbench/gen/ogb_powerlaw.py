"""A node-classification data set made on the device from a seed: the
recipe of ``loops_tpu_torch/io/ogb.py`` ``synthetic_powerlaw``, drawn
with ``torch.Generator``s on the device in a few large calls.

Edges: ``num_edges`` directed pairs, the source drawn from a Zipf law
over the node ids (node i with weight 1 / (i + 1 + k0)), the destination
uniform; the model's graph makes them undirected. The recipe's plain
law (k0 = 0) gives node 0 about 90,000 neighbours where the real graph's
largest degree is ``max_degree``; the offset k0 caps node 0's expected
degree there. Labels are uniform
over the classes; a node's features are its class centre plus Gaussian
noise of scale 1.5. The split has the published train, validation and
test counts, over a random permutation of the nodes.

The edges come from a seed fixed by the spec; the run's seed shifts their
node ids (``loopsbench.gen``) and draws the features, labels and split.
"""
from __future__ import annotations

import torch

from loopsbench.gen import capped_cdf, draw, shifted, structure_generator
from loopsbench.harness import sub_seed


def make(graph: dict, seed: int, device) -> dict:
    """``{"num_nodes", "src", "dst", "features", "labels", "train_mask",
    "val_mask", "test_mask"}`` on ``device``: int64 edges and labels,
    float32 features and masks."""
    s = structure_generator(graph, device)
    g = torch.Generator(device).manual_seed(sub_seed(seed, "data"))
    n, m = int(graph["num_nodes"]), int(graph["num_edges"])
    f, c = int(graph["num_features"]), int(graph["num_classes"])
    # the uniform destinations give node 0 m / n of its degree
    top = int(graph["max_degree"]) - m / n
    src = draw(capped_cdf(n, m, top, 1.0, device), m, s)
    dst = torch.randint(0, n, (m,), generator=s, device=device)
    src, dst = shifted(src, dst, n, seed)
    labels = torch.randint(0, c, (n,), generator=g, device=device)
    centres = torch.randn(c, f, generator=g, device=device)
    noise = torch.randn(n, f, generator=g, device=device)
    features = centres[labels] + 1.5 * noise
    order = torch.randperm(n, generator=g, device=device)
    masks = torch.zeros(3, n, device=device)
    start = 0
    for i, key in enumerate(("train", "val", "test")):
        count = int(graph["split"][key])
        masks[i, order[start:start + count]] = 1.0
        start += count
    if start > n:
        raise ValueError(f"split of {start} nodes for {n}")
    return dict(num_nodes=n, src=src, dst=dst, features=features,
                labels=labels, train_mask=masks[0], val_mask=masks[1],
                test_mask=masks[2])
