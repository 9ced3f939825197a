"""train_imgs_per_s: every training image of every optimizer step that
the window completed, over the window's time (a synchronize to a
synchronize, host clock)."""
from benchmark import readers

UNIT = "imgs/s"


def read(run):
    return run.record.images / readers.window_s(run)
