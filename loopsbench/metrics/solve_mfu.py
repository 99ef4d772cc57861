"""solve_mfu: a solve's least time on an H100, each kernel's work
(counted from shapes) at 3.35 TB/s or 67 TFLOP/s f32, whichever binds,
over the solve time of the window, in %: the whole solve's share of the
chip's peak."""
from loopsbench.readings import unit_ms


def read(run):
    ms = unit_ms(run)
    if ms is None or not run.unit_bound_s:
        return None
    return 100.0 * run.unit_bound_s / (ms * 1e-3)
