"""Device operators: SpMV over every format, SpMM over CSR, BCSR, COO
and ELL, SDDMM over CSR, COO and BCSR, the segment ops (sum, max, mean,
softmax) and the fused attention aggregations of GAT and GATv2."""
from loops_tpu_torch.ops.attention import (  # noqa: F401
    GroupedAttentionAggregate,
    GroupedAttentionV2,
)
from loops_tpu_torch.ops.gather import gather1d  # noqa: F401
from loops_tpu_torch.ops.spmv import (  # noqa: F401
    SpMVOperator,
    flat_partitioned_spmv,
    spmv,
)
from loops_tpu_torch.ops.spmm import SpMMOperator, spmm  # noqa: F401
from loops_tpu_torch.ops.sddmm import SDDMMOperator, sddmm  # noqa: F401
from loops_tpu_torch.ops.segment import (  # noqa: F401
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
