"""mfu: the model FLOPs of the traced window's units (the reference's
count at the cell's shapes, flops.py: text encoder and mappers included,
no recomputation) over the window's time, over 989 TFLOP/s (H100 SXM
dense bf16 at 700 W), in percent."""
from benchmark import readers

UNIT = "%"


def read(run):
    return readers.mfu(run)
