"""host_wait_pct.gcn: the share of the traced window in which the device
waited for a launch the host had not made, in %; the rest of
``idle_pct.gcn`` is queued time."""
from loopsbench.span_readings import host_wait_pct as read  # noqa: F401
