"""host_wait_pct.pagerank: the share of the traced window in which the
device waited for a launch the host had not made, in %; the rest of
``idle_pct.pagerank`` is queued time."""
from loopsbench.span_readings import host_wait_pct as read  # noqa: F401
