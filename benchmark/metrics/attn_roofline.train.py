"""attn_roofline: the attention kernels' share of their roofline in the
traced window: Σ bound / Σ device time of the launches named
flash_fwd_kernel* (K1), flash_bwd_dq_kernel* (K2) and flash_bwd_dkv* (K3);
the bound of each attention call of the reference's shapes is the larger
of its FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s (flops.py).
None when the trace holds fewer launches than the calls need."""
from benchmark import readers

UNIT = "%"


def read(run):
    return readers.attention_roofline(run)
