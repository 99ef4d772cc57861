"""Host-side sparse containers (reference parity:
include/loops/container/{coo,csr,csc,ell,bcsr,dia}.hxx plus
detail/convert.hxx) and the format advisor."""
from loops_tpu_torch.formats.base import INDEX_DTYPE, VALUE_DTYPE  # noqa: F401
from loops_tpu_torch.formats.coo import COO  # noqa: F401
from loops_tpu_torch.formats.csc import CSC  # noqa: F401
from loops_tpu_torch.formats.csr import CSR  # noqa: F401
from loops_tpu_torch.formats.ell import ELL  # noqa: F401
from loops_tpu_torch.formats.bcsr import BCSR  # noqa: F401
from loops_tpu_torch.formats.dia import DIA  # noqa: F401
from loops_tpu_torch.formats.advisor import (  # noqa: F401
    FormatAdvice,
    FormatCosts,
    advise,
    choose_format,
)
from loops_tpu_torch.formats.convert import (  # noqa: F401
    csr_from_arrays,
    indices_to_offsets,
    offsets_to_indices,
)
