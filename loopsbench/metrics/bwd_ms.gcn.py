"""bwd_ms.gcn: device ms an epoch under the program's ``train.backward``
span: autograd's backward, K4 over A^T within it."""
from loopsbench.span_readings import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, "train.backward")
