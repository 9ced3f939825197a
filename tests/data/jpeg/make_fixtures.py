"""Write the JPEG fixtures of the port's tests with PIL, and their
manifest (the sha256 of PIL's RGB decode of each file).

    python tests/data/jpeg/make_fixtures.py

teapot/view_{0..4}.jpg: five 512x512 views of a smooth synthetic object
(a shaded disk and a box over a gradient), quality 90, 4:2:0: a mode-0
training folder. odd_517x389_rst.jpg: an odd size with a restart marker
every MCU row.
"""
import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def view(i: int, h: int = 512, w: int = 512) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([60 + 120 * x / w, 80 + 100 * y / h,
                    200 - 80 * (x + y) / (w + h)], -1)
    cx, cy, r = w * (0.35 + 0.07 * i), h * 0.55, min(h, w) * 0.22
    d2 = ((x - cx) ** 2 + (y - cy) ** 2) / r ** 2
    shade = np.clip(1.2 - 0.6 * ((x - cx + 0.4 * r) ** 2
                                 + (y - cy + 0.4 * r) ** 2) / r ** 2, 0.2, 1)
    disk = d2 < 1
    img[disk] = (np.array([220.0, 90, 40])[None] * shade[disk, None])
    box = ((abs(x - (w * 0.72 - 9 * i)) < w * 0.08)
           & (abs(y - h * 0.3) < h * 0.12))
    img[box] = [40, 160 + 10 * i, 90]
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    (HERE / "teapot").mkdir(exist_ok=True)
    files = {}
    for i in range(5):
        rel = f"teapot/view_{i}.jpg"
        Image.fromarray(view(i)).save(HERE / rel, quality=90, subsampling=2)
        files[rel] = None
    rel = "odd_517x389_rst.jpg"
    Image.fromarray(view(2, 389, 517)).save(HERE / rel, quality=85,
                                            subsampling=2,
                                            restart_marker_rows=1)
    files[rel] = None
    for rel in files:
        rgb = np.asarray(Image.open(HERE / rel).convert("RGB"))
        files[rel] = {"shape": list(rgb.shape),
                      "sha256_rgb": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "manifest.json").write_text(json.dumps(files, indent=1) + "\n")


if __name__ == "__main__":
    main()
