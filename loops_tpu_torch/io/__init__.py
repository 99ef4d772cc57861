"""I/O: the Matrix Market loader, the binary CSR cache, edge lists, the
plan cache, out-of-core row shards and the filepath helpers."""
from loops_tpu_torch.io import binary, edges, filepath, market, ogb  # noqa: F401
from loops_tpu_torch.io import plan_cache, shards  # noqa: F401
from loops_tpu_torch.io.edges import load_edges  # noqa: F401
from loops_tpu_torch.io.market import load as load_market  # noqa: F401
from loops_tpu_torch.io.market import load_csr as load_market_csr  # noqa: F401
