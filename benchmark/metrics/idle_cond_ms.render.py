"""idle_cond_ms.render: device-idle ms a view in the traced window's gaps
that begin while the program's prompt.embed span is open (the host
conditioning a view while the card waits). Moves render_imgs_per_s."""
from benchmark import program_spans

UNIT = "ms"


def read(run):
    return program_spans.idle_ms_per_unit(
        run, program_spans.mapped(run, ("prompt.embed",)))
