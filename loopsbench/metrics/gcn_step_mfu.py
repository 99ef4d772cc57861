"""gcn_step_mfu: an epoch's flops, counted from shapes (the dense
products forward and backward, 2 nnz F an SpMM, the evaluation's
forward), over the epoch time of the window at the H100's 67 TFLOP/s
f32 peak, in %."""
from loopsbench import counters
from loopsbench.readings import unit_ms


def read(run):
    ms = unit_ms(run)
    if ms is None or not run.unit_flops:
        return None
    return 100.0 * run.unit_flops / (ms * 1e-3 * counters.PEAK_F32_FLOPS)
