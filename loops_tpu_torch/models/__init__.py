"""GNN models: graph container, message passing, GCN, GraphSAGE with
neighbour sampling, training, checkpoints.

GAT and GATv2 are not ported yet: their names raise
``NotImplementedError`` naming ROADMAP A9.
"""
from loops_tpu_torch.models import checkpoint, train  # noqa: F401
from loops_tpu_torch.models.gcn import GCN, init_gcn, params_from_jax  # noqa: F401
from loops_tpu_torch.models.graph import Graph  # noqa: F401
from loops_tpu_torch.models.message_passing import (  # noqa: F401
    aggregate_operator,
    edge_aggregate,
    masked_aggregate_operator,
)
from loops_tpu_torch.models.sage import (  # noqa: F401
    GraphSAGE,
    init_sage,
    make_sampled_train_step,
)
from loops_tpu_torch.models.sampling import (  # noqa: F401
    sample_neighbors,
    sampled_block,
)


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to loops_tpu_torch yet (ROADMAP A9: "
            "the GNN models after GCN)")
    stub.__name__ = stub.__qualname__ = name
    return stub


GAT = _not_ported("GAT")
init_gat = _not_ported("init_gat")
GATv2 = _not_ported("GATv2")
init_gatv2 = _not_ported("init_gatv2")
