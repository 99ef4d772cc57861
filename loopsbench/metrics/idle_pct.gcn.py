"""idle_pct.gcn: the share of the traced window in which the device ran
no operation, in %."""
from loopsbench.readings import idle_pct as read  # noqa: F401
