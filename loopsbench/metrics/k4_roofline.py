"""k4_roofline: K4's share of its roofline over the traced window."""
from loopsbench.readings import roofline_pct


def read(run):
    return roofline_pct(run, "flat_spmm")
