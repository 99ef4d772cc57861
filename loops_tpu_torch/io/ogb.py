"""OGB-style node-classification datasets.

The port of ``loops_tpu/io/ogb.py``. ``load`` reads a local copy of an
OGB dataset's raw layout when one exists under the repository's
``datasets/`` directory (or a ``root`` the caller names); nothing is
downloaded. Otherwise it synthesizes a size-matched power-law graph with
the same numpy draws from the same seed as ``loops_tpu``, so both
packages build the identical graph, features, labels and masks.
"""
from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.models.graph import Graph

DATASETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "datasets")


@dataclass
class NodeDataset:
    name: str
    graph: Graph
    features: np.ndarray      # [N, F]
    labels: np.ndarray        # [N]
    train_mask: np.ndarray    # [N] float {0,1}
    val_mask: np.ndarray
    test_mask: np.ndarray
    synthetic: bool = False

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


def _find_ogb_dir(name: str, roots):
    sub = name.replace("-", "_")
    for root in roots:
        for cand in (os.path.join(root, sub), os.path.join(root, name),
                     os.path.join(root, "ogb", sub)):
            if os.path.isdir(os.path.join(cand, "raw")):
                return cand
    return None


def _load_ogb_raw(path: str, name: str) -> NodeDataset:
    """Minimal reader for OGB's raw CSV layout (edge.csv(.gz),
    node-feat.csv(.gz), node-label.csv(.gz) + split dir)."""

    def read_csv(fname, dtype):
        for p in (os.path.join(path, "raw", fname),
                  os.path.join(path, "raw", fname + ".gz")):
            if os.path.exists(p):
                opener = gzip.open if p.endswith(".gz") else open
                with opener(p, "rt") as f:
                    return np.loadtxt(f, delimiter=",", dtype=dtype)
        raise FileNotFoundError(fname)

    edges = np.atleast_2d(read_csv("edge.csv", np.int64))
    feats = np.atleast_2d(read_csv("node-feat.csv", np.float32))
    labels = read_csv("node-label.csv", np.int64).reshape(-1)
    n = len(feats)
    g = Graph.from_edges(edges[:, 0], edges[:, 1], n, make_undirected=True)

    def read_split(split):
        p = os.path.join(path, "split", "time", f"{split}.csv.gz")
        idx = np.arange(0)
        if os.path.exists(p):
            with gzip.open(p, "rt") as f:
                idx = np.loadtxt(f, dtype=np.int64)
        m = np.zeros(n, np.float32)
        m[idx] = 1.0
        return m

    return NodeDataset(name, g, feats, labels.astype(np.int32),
                       read_split("train"), read_split("valid"),
                       read_split("test"))


def synthetic_powerlaw(name: str, n: int, avg_deg: int, f: int, classes: int,
                       seed: int = 0) -> NodeDataset:
    """Power-law graph with community-correlated features/labels — the
    schedule-stressing stand-in for OGB graphs."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    # preferential-attachment-flavored: degree ~ zipf via inverse sampling
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    src = rng.choice(n, size=m, p=probs)
    dst = rng.integers(0, n, size=m)
    g = Graph.from_edges(src, dst, n, make_undirected=True)

    labels = rng.integers(0, classes, n).astype(np.int32)
    centers = rng.normal(size=(classes, f)).astype(np.float32)
    feats = centers[labels] + rng.normal(scale=1.5, size=(n, f)
                                         ).astype(np.float32)
    order = rng.permutation(n)
    masks = np.zeros((3, n), np.float32)
    masks[0, order[: int(0.6 * n)]] = 1
    masks[1, order[int(0.6 * n): int(0.8 * n)]] = 1
    masks[2, order[int(0.8 * n):]] = 1
    return NodeDataset(name, g, feats, labels, masks[0], masks[1], masks[2],
                       synthetic=True)


_SYNTH_SPECS = {
    # (nodes, avg_deg, feat, classes) — shapes echo the real datasets at
    # reduced node counts for single-chip benchmarking.
    "ogbn-arxiv": (169_343, 7, 128, 40),
    "ogbn-products": (200_000, 25, 100, 47),
    "ogbn-papers100M": (400_000, 15, 128, 172),
    "tiny": (2_000, 8, 32, 8),
}


def load(name: str, allow_synthetic: bool = True, scale: float = 1.0,
         root: str | None = None) -> NodeDataset:
    """A local OGB copy under ``root`` (default: the repository's
    ``datasets/``), else the synthetic stand-in at ``scale`` times the
    node count."""
    roots = (root,) if root is not None else (DATASETS_DIR,)
    path = _find_ogb_dir(name, roots)
    if path is not None:
        return _load_ogb_raw(path, name)
    if not allow_synthetic:
        raise FileNotFoundError(
            f"{name}: no local OGB copy found under {roots} and "
            "synthetic fallback disabled")
    n, d, f, c = _SYNTH_SPECS.get(name, _SYNTH_SPECS["tiny"])
    return synthetic_powerlaw(name, max(int(n * scale), 64), d, f, c)
