"""adam_ms.gcn: device ms an epoch under the program's
``train.optimizer`` span: Adam's update."""
from loopsbench.span_readings import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, "train.optimizer")
