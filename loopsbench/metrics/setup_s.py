"""setup_s: from the start of the process to the first timed unit:
imports, the build or load of the kernels, making the inputs, the
program's plans and staging, its first units and the warm-up."""


def read(run):
    return run.setup_s
