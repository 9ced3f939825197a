"""idle_share: 1 - the union of device operations' intervals over the
traced window's span, in percent."""
from benchmark import readers

UNIT = "%"


def read(run):
    return readers.idle_share(run)
