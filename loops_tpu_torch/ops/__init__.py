"""Device operators: CSR and BCSR SpMV and SpMM, and SDDMM over CSR, COO
and BCSR (the segment ops follow, ROADMAP A8)."""
from loops_tpu_torch.ops.gather import gather1d  # noqa: F401
from loops_tpu_torch.ops.spmv import SpMVOperator, spmv  # noqa: F401
from loops_tpu_torch.ops.spmm import SpMMOperator, spmm  # noqa: F401
from loops_tpu_torch.ops.sddmm import SDDMMOperator, sddmm  # noqa: F401
