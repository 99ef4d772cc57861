"""Multi-device execution over ``torch.distributed``: meshes,
edge-partitioned graphs, the halo exchanges, distributed ops and GNNs."""
from loops_tpu_torch.parallel.dist_ops import DistGCN, DistGraphSAGE, DistSpMM  # noqa: F401
from loops_tpu_torch.parallel.graph_partition import EdgePartition  # noqa: F401
from loops_tpu_torch.parallel.halo import DistSpMMHalo, HaloPlan  # noqa: F401
from loops_tpu_torch.parallel.hier import DistSpMMHier, HierHaloPlan  # noqa: F401
from loops_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
    make_mesh_hier,
)
