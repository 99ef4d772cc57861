"""Host-side sparse containers (reference parity:
include/loops/container/{coo,csr,csc,bcsr}.hxx plus detail/convert.hxx).
ELL and DIA are not ported yet (ROADMAP A6)."""
from loops_tpu_torch.formats.base import INDEX_DTYPE, VALUE_DTYPE  # noqa: F401
from loops_tpu_torch.formats.coo import COO  # noqa: F401
from loops_tpu_torch.formats.csc import CSC  # noqa: F401
from loops_tpu_torch.formats.csr import CSR  # noqa: F401
from loops_tpu_torch.formats.bcsr import BCSR  # noqa: F401
from loops_tpu_torch.formats.convert import (  # noqa: F401
    csr_from_arrays,
    indices_to_offsets,
    offsets_to_indices,
)
