"""GNN models: graph container, message passing, GCN, GraphSAGE with
neighbour sampling, GAT and GATv2, training, checkpoints."""
from loops_tpu_torch.models import checkpoint, train  # noqa: F401
from loops_tpu_torch.models.gat import GAT, init_gat  # noqa: F401
from loops_tpu_torch.models.gatv2 import GATv2, init_gatv2  # noqa: F401
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

