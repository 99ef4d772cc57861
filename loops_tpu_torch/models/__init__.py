"""GNN models: graph container, message passing, GCN, training,
checkpoints.

GAT, GATv2, GraphSAGE and neighbour sampling are not ported yet: their
names raise ``NotImplementedError`` naming ROADMAP A9.
"""
from loops_tpu_torch.models import checkpoint, train  # noqa: F401
from loops_tpu_torch.models.gcn import GCN, init_gcn, params_from_jax  # noqa: F401
from loops_tpu_torch.models.graph import Graph  # noqa: F401
from loops_tpu_torch.models.message_passing import (  # noqa: F401
    aggregate_operator,
    edge_aggregate,
    masked_aggregate_operator,
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
GraphSAGE = _not_ported("GraphSAGE")
init_sage = _not_ported("init_sage")
make_sampled_train_step = _not_ported("make_sampled_train_step")
sample_neighbors = _not_ported("sample_neighbors")
sampled_block = _not_ported("sampled_block")
