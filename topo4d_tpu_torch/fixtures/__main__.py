"""Regenerate the JPEG fixtures and ``manifest.json`` with PIL:

    python -m topo4d_tpu_torch.fixtures

Each image is made from a seed: smooth shading, hard-edged ellipses, a
sinusoidal texture and noise, so that every band of the DCT carries data.
"""

from __future__ import annotations

import json

import numpy as np

from topo4d_tpu_torch.fixtures import DENSE, MANIFEST, path, sha256

# file name -> (height, width, gray?, seed, PIL save options)
FIXTURES = {
    DENSE: (3000, 4096, False, 0, {"quality": 85, "subsampling": 2, "restart_marker_rows": 4}),
    "view_517x389_q75_422.jpg": (389, 517, False, 1, {"quality": 75, "subsampling": 1}),
    "view_517x389_q95_444.jpg": (389, 517, False, 2, {"quality": 95, "subsampling": 0}),
    "gray_515x387_q85.jpg": (387, 515, True, 3, {"quality": 85}),
}


def make_image(h: int, w: int, gray: bool, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xx / w, yy / h
    img = np.stack([60 + 120 * u, 80 + 90 * v, 140 - 60 * u * v], -1)
    for _ in range(12):  # hard-edged ellipses of flat color
        cx, cy, rx, ry = rng.uniform(0, 1, 4) * [1, 1, 0.25, 0.25] + [0, 0, 0.03, 0.03]
        inside = ((u - cx) / rx) ** 2 + ((v - cy) / ry) ** 2 < 1.0
        img[inside] = rng.uniform(0, 255, 3)
    freq = rng.uniform(20, 90, 2)
    img += 18 * (np.sin(2 * np.pi * freq[0] * u) * np.cos(2 * np.pi * freq[1] * v))[..., None]
    band = (np.abs(v - 0.5) < 0.025)[..., None]  # a noisy band: the high frequencies
    img += band * rng.normal(0, 16, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 1] if gray else img


def main() -> None:
    from PIL import Image

    out = {}
    for name, (h, w, gray, seed, save) in FIXTURES.items():
        Image.fromarray(make_image(h, w, gray, seed)).save(path(name), format="JPEG", **save)
        with Image.open(path(name)) as im:
            pixels = np.asarray(im)
        out[name] = {"shape": list(pixels.shape), "sha256": sha256(pixels), "save": save}
    with open(MANIFEST, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
