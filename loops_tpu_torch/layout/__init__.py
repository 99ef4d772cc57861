"""Layout views + the partitioners: the tile/atom contract, its views,
the flat re-binning and the merge-path partitioner (reference:
include/loops/container/layout.hxx + partitioning.hxx)."""
from loops_tpu_torch.layout.contract import (  # noqa: F401
    Layout,
    check_layout_invariants,
    check_tile_of_round_trip,
)
from loops_tpu_torch.layout.merge_path import (  # noqa: F401
    merge_path_partition,
    merge_path_reference,
)
from loops_tpu_torch.layout.partition import FlatRebinLayout  # noqa: F401
from loops_tpu_torch.layout.views import (  # noqa: F401
    BcsrLayout,
    CooLayout,
    CsrLayout,
    DiaLayout,
    EllLayout,
    OffsetsLayout,
    UniformLayout,
)
