"""step_busy_ms.train: device-busy ms per optimizer step: the union of the
device operations' intervals in the traced window over its steps. Moves
train_imgs_per_s."""

UNIT = "ms"


def read(run):
    data = run.trace
    if data is None or not data.units:
        return None
    return 1e3 * data.busy_s() / data.units
