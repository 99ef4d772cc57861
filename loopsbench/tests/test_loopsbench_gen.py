"""The generators hold the figures their ``graph`` blocks give, on the CPU
at small sizes: the count of distinct edges, the largest degrees, the
lattice's degrees and symmetry, and one graph for every run seed."""
import torch

from loopsbench.gen import ogb_powerlaw, suitesparse_prior

POWERLAW = {"generator": "suitesparse_prior", "family": "powerlaw",
            "rows": 50000, "nnz": 700000, "exponent": 0.63,
            "max_out": 2000, "max_in": 1400}
LATTICE = {"generator": "suitesparse_prior", "family": "lattice",
           "rows": 40001, "nnz": 96400}


def test_powerlaw_holds_its_figures():
    g = suitesparse_prior.make(POWERLAW, 1, "cpu")
    n, src, dst = g["num_nodes"], g["src"], g["dst"]
    assert src.numel() == POWERLAW["nnz"]
    assert torch.unique(src * n + dst).numel() == POWERLAW["nnz"]
    for side, top in ((src, POWERLAW["max_out"]), (dst, POWERLAW["max_in"])):
        deg = torch.bincount(side, minlength=n)
        assert 0.85 * top <= int(deg.max()) <= 1.1 * top
        # the hubs lie anywhere on the ids, not at the first ones
        assert int(deg.argmax()) != 0


def test_lattice_is_a_symmetric_street_grid():
    g = suitesparse_prior.make(LATTICE, 1, "cpu")
    n, src, dst = g["num_nodes"], g["src"], g["dst"]
    assert src.numel() == LATTICE["nnz"]
    assert torch.equal(torch.sort(src * n + dst)[0],
                       torch.sort(dst * n + src)[0])
    deg = torch.bincount(src, minlength=n)
    assert int(deg.min()) == 1 and int(deg.max()) == 4
    assert bool((src != dst).all())
    width = 201
    assert set((src - dst).abs().unique().tolist()) == {1, width}


def test_one_graph_for_every_run_seed():
    a = suitesparse_prior.make(LATTICE, 1, "cpu")
    b = suitesparse_prior.make(LATTICE, 2**40 + 3, "cpu")
    assert torch.equal(a["src"], b["src"])
    c = suitesparse_prior.make(dict(LATTICE, structure_seed=5), 1, "cpu")
    assert not torch.equal(a["src"], c["src"])


def test_arxiv_hub_is_capped():
    graph = {"num_nodes": 20000, "num_edges": 140000, "max_degree": 1500,
             "num_features": 8, "num_classes": 4,
             "split": {"train": 100, "val": 100, "test": 100}}
    g = ogb_powerlaw.make(graph, 3, "cpu")
    deg = torch.bincount(g["src"], minlength=20000) + torch.bincount(
        g["dst"], minlength=20000)
    assert 0.85 * 1500 <= int(deg.max()) <= 1.1 * 1500
