"""denoise_busy_ms.render: device-busy ms per CFG denoising step, of the
operations that start inside the benchmark's span around the denoise
loop (bench.denoise, ended at a synchronize in the traced run). Moves
render_imgs_per_s."""
from benchmark import readers

UNIT = "ms"
SPAN = "bench.denoise"


def read(run):
    return readers.busy_in_span_ms(run, SPAN, run.trace.extra["steps"]
                                   if run.trace else 1)
