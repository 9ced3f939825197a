"""Read the reference's torch checkpoints into the port's files
(tools/import_torch_mapper.py of the JAX package), so that the published
ViewNeTI mappers serve modes 4/5 and offline inference without
retraining:

    python -m view_neti_tpu_torch.import_torch --out outputs/imported \\
        --view mapper-steps-50000_view.pt \\
        [--object mapper-steps-50000_object.pt] \\
        [--embeds learned_embeds-steps-50000.bin] [--iteration 50000]

writes mapper-steps-N_{view,object}.msgpack and
learned_embeds-steps-N.msgpack (torch_interop.import_torch_artifacts).
Then train modes 4/5 with
model.pretrained_view_mapper=outputs/imported/mapper-steps-N_view.msgpack,
or run python -m view_neti_tpu_torch.inference on the directory. Runs on
the CPU; it needs no card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from view_neti_tpu_torch.torch_interop import import_torch_artifacts


def main(argv: Optional[List[str]] = None) -> List[Path]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--view", type=Path, default=None,
                    help="mapper-steps-N_view.pt")
    ap.add_argument("--object", dest="object_", type=Path, default=None,
                    help="mapper-steps-N_object.pt")
    ap.add_argument("--embeds", type=Path, default=None,
                    help="learned_embeds-steps-N.bin")
    ap.add_argument("--iteration", type=int, default=None,
                    help="step number of the output names (default: the "
                         "first number in each input's name)")
    args = ap.parse_args(argv)
    if not (args.view or args.object_ or args.embeds):
        ap.error("nothing to import: pass --view, --object or --embeds")
    written = import_torch_artifacts(
        args.out, view_path=args.view, object_path=args.object_,
        embeds_path=args.embeds, iteration=args.iteration)
    for p in written:
        print("wrote", p)
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
