"""conv_roofline: the fused conv kernel's share of its roofline in the
traced window: Σ bound / Σ device time of the launches named
fused_conv_kernel* (K4), over the VAE's norm + SiLU + 3x3 conv sections
of the reference's shapes (flops.py). None when the trace holds fewer
launches than the sections need."""
from benchmark import readers

UNIT = "%"


def read(run):
    return readers.conv_roofline(run)
