"""op_host_us.pagerank: host microseconds of the program's ``spmv`` and ``saxpy``
spans over the ``spmv`` calls, traced: one iteration's launch path
where it runs, without the driver's dangling term."""
from loopsbench.span_readings import op_host_us as read  # noqa: F401
