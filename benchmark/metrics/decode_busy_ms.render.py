"""decode_busy_ms.render: device-busy ms per view of the operations that
start inside the benchmark's span around the decode (bench.decode).
Moves render_imgs_per_s."""
from benchmark import readers

UNIT = "ms"
SPAN = "bench.decode"


def read(run):
    return readers.busy_in_span_ms(run, SPAN, 1)
