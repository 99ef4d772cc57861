"""solve_p95_ms: the 95th percentile (nearest rank) of the time of every
solve of the window, each from its start to the host's read of
its L1 change."""
from loopsbench.readings import p95_ms as read  # noqa: F401
