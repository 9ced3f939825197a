"""Write the port's checkpoints in the reference's torch formats
(tools/export_torch_mapper.py of the JAX package), for the published
ViewNeTI tooling:

    python -m view_neti_tpu_torch.export_torch --out outputs/exported \\
        --view results/exp/mapper-steps-3000_view.msgpack \\
        [--object results/exp/mapper-steps-3000_object.msgpack] \\
        [--embeds results/exp/learned_embeds-steps-3000.msgpack] \\
        [--iteration 3000]

writes mapper-steps-N_{view,object}.pt and learned_embeds-steps-N.bin
(torch_interop.export_torch_artifacts). Runs on the CPU; it needs no card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from view_neti_tpu_torch.torch_interop import export_torch_artifacts


def main(argv: Optional[List[str]] = None) -> List[Path]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--view", type=Path, default=None,
                    help="mapper-steps-N_view.msgpack")
    ap.add_argument("--object", dest="object_", type=Path, default=None,
                    help="mapper-steps-N_object.msgpack")
    ap.add_argument("--embeds", type=Path, default=None,
                    help="learned_embeds-steps-N.msgpack")
    ap.add_argument("--iteration", type=int, default=None,
                    help="step number of the output names (default: the "
                         "first number in each input's name)")
    args = ap.parse_args(argv)
    if not (args.view or args.object_ or args.embeds):
        ap.error("nothing to export: pass --view, --object or --embeds")
    written = export_torch_artifacts(
        args.out, view_path=args.view, object_path=args.object_,
        embeds_path=args.embeds, iteration=args.iteration)
    for p in written:
        print("wrote", p)
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
