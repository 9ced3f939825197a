"""render_imgs_per_s: every image of every view that the window completed
and copied to the host as uint8 (conditioning, denoising, decode and the
copy inside), over the window's time (host clock)."""
from benchmark import readers

UNIT = "imgs/s"


def read(run):
    return run.record.images / readers.window_s(run)
