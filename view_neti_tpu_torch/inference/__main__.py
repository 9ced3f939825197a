"""python -m view_neti_tpu_torch.inference: offline DTU inference
(inference/offline.py)."""
import sys

from view_neti_tpu_torch.inference.offline import main

main(sys.argv[1:])
