"""step_host_ms.train: host ms a window_step call takes (one optimizer
step's batch copy and graph replay launch), the benchmark's own span
around each call in the traced window. Moves train_imgs_per_s."""
from benchmark import readers

UNIT = "ms"
SPAN = "bench.train_step"


def read(run):
    return readers.span_ms(run, SPAN)
