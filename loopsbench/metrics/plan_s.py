"""plan_s: host seconds of the program's set-up calls, the planner and
staging: ``Graph.from_edges`` and ``GCN(...)``, or ``SpMVOperator(...)``."""


def read(run):
    return run.plan_s
