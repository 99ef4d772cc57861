"""I/O: the Matrix Market loader and filepath helpers."""
from loops_tpu_torch.io import filepath, market  # noqa: F401
from loops_tpu_torch.io.market import load as load_market  # noqa: F401
from loops_tpu_torch.io.market import load_csr as load_market_csr  # noqa: F401
