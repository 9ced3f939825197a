"""Pin weight files by sha256 (tools/weights_manifest.py of the JAX
package):

    python -m view_neti_tpu_torch.weights_manifest write --root DIR \\
        [--extra LPIPS.npz vocab.json ...] [--out MANIFEST.sha256]
    python -m view_neti_tpu_torch.weights_manifest check --root DIR \\
        [--manifest MANIFEST.sha256]

write lists every weight file under a diffusers-layout SD directory (and
the extras) as "sha256  bytes  relpath" lines (weight_port.write_manifest);
check names each file that is missing or differs and exits 1.
python -m view_neti_tpu_torch.acceptance checks $WEIGHTS_MANIFEST, else
$SD_WEIGHTS_DIR/MANIFEST.sha256, before it trains. The manifests of the
two packages are the same bytes. Runs on the CPU; it needs no card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from view_neti_tpu_torch.weight_port import check_manifest, write_manifest


def main(argv: Optional[List[str]] = None) -> Path:
    """Returns the manifest written or checked."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write")
    w.add_argument("--root", type=Path, required=True)
    w.add_argument("--extra", nargs="*", default=[])
    w.add_argument("--out", type=Path, default=None)
    c = sub.add_parser("check")
    c.add_argument("--root", type=Path, required=True)
    c.add_argument("--manifest", type=Path, default=None)
    args = ap.parse_args(argv)

    if args.cmd == "write":
        out = args.out or args.root / "MANIFEST.sha256"
        n = write_manifest(args.root, out, tuple(args.extra))
        print(f"wrote {out} ({n} files)")
        return out
    manifest = args.manifest or args.root / "MANIFEST.sha256"
    problems = check_manifest(args.root, manifest)
    if problems:
        print("FAILED:\n  " + "\n  ".join(problems))
        raise SystemExit(1)
    print("OK")
    return manifest


if __name__ == "__main__":
    main(sys.argv[1:])
