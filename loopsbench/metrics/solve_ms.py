"""solve_ms: the window's duration over the solves completed in it."""
from loopsbench.readings import unit_ms as read  # noqa: F401
