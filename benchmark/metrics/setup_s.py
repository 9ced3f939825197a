"""setup_s: from the process's start to the window's first synchronize:
imports, kernels built or loaded, weights, files, warm-up and captures."""

UNIT = "s"


def read(run):
    return run.record.t0 - run.process_start
