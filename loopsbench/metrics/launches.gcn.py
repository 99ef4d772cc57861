"""launches.gcn: the launch calls an epoch under the program's spans,
counted on the host side of the trace."""
from loopsbench.span_readings import launches_per_unit as read  # noqa: F401
