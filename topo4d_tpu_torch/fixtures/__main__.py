"""Regenerate the image fixtures and ``manifest.json`` (PIL writes and
decodes them):

    python -m topo4d_tpu_torch.fixtures

Each image is made from a seed: smooth shading, hard-edged ellipses, a
sinusoidal texture and noise, so that every band of the DCT carries data.
The two files libjpeg wrote (``libjpeg_arith.c``) are kept as committed;
only their manifest entries are rewritten. Each fixture's damaged copies
(``damaged``) are decoded by PIL too: their outcomes are the entry's
``damaged`` record.
"""

from __future__ import annotations

import io
import json

import numpy as np

from topo4d_tpu_torch.fixtures import (DAMAGED, DENSE, DENSE_PROGRESSIVE, MANIFEST, PNG8, damaged,
                                       damaged_outcome, path, sha256)
from topo4d_tpu_torch.fixtures.jpeg_writer import encode_baseline, encode_scans
from topo4d_tpu_torch.fixtures.png_writer import encode_png_any
from topo4d_tpu_torch.utils.png import encode_png

SAMPLING_420 = [[2, 2], [1, 1], [1, 1]]

# file name -> (height, width, gray?, seed, how it is written): PIL's save
# options, with "adobe_transform" for an APP14 marker spliced in place of
# PIL's JFIF marker and "scans_kept" for a progressive file cut after that
# many scans; "writer" for this package's writers, or libjpeg's (kept)
FIXTURES = {
    DENSE: (3000, 4096, False, 0, {"quality": 85, "subsampling": 2, "restart_marker_rows": 4}),
    "view_517x389_q75_422.jpg": (389, 517, False, 1, {"quality": 75, "subsampling": 1}),
    "view_517x389_q95_444.jpg": (389, 517, False, 2, {"quality": 95, "subsampling": 0}),
    "gray_515x387_q85.jpg": (387, 515, True, 3, {"quality": 85}),
    DENSE_PROGRESSIVE: (
        3000, 4096, False, 0, {"quality": 85, "subsampling": 2, "restart_marker_rows": 4, "progressive": True}
    ),
    "view_259x195_q90_444_progressive.jpg": (195, 259, False, 4, {"quality": 90, "subsampling": 0, "progressive": True}),
    "gray_257x193_q85_progressive.jpg": (193, 257, True, 5, {"quality": 85, "progressive": True}),
    "view_261x197_q85_adobe0.jpg": (197, 261, False, 6, {"quality": 85, "subsampling": 0, "adobe_transform": 0}),
    "view_261x197_q85_adobe1.jpg": (197, 261, False, 7, {"quality": 85, "subsampling": 2, "adobe_transform": 1}),
    "view_263x199_q85_440.jpg": (
        199, 263, False, 8, {"writer": "encode_baseline", "quality": 85, "sampling": [[1, 2], [1, 1], [1, 1]]}
    ),
    "view_263x199_q85_411.jpg": (
        199, 263, False, 9, {"writer": "encode_baseline", "quality": 85, "sampling": [[4, 1], [1, 1], [1, 1]],
                             "restart": 3}
    ),
    "view_127x93_rgb16_adam7.png": (
        93, 127, False, 10, {"writer": "encode_png_any", "depth": 16, "color_type": 2, "interlace": True}
    ),
    PNG8: (93, 127, False, 19, {"writer": "encode_png"}),
    "libjpeg_61x43_q85_420_arith.jpg": (43, 61, False, 11, {"writer": "libjpeg_arith.c", "progressive": 0}),
    "libjpeg_61x43_q85_420_arith_progressive.jpg": (43, 61, False, 12, {"writer": "libjpeg_arith.c", "progressive": 1}),
    "view_517x389_q75_422_arith.jpg": (
        389, 517, False, 13, {"writer": "encode_scans", "quality": 75, "sampling": [[2, 1], [1, 1], [1, 1]],
                              "arithmetic": True, "progressive": False}
    ),
    "view_259x195_q90_444_arith_progressive.jpg": (
        195, 259, False, 14, {"writer": "encode_scans", "quality": 90, "sampling": [[1, 1], [1, 1], [1, 1]],
                              "arithmetic": True, "progressive": True, "restart": 7}
    ),
    "gray_257x193_q85_arith_progressive.jpg": (
        193, 257, True, 15, {"writer": "encode_scans", "quality": 85, "arithmetic": True, "progressive": True}
    ),
    "view_261x197_q85_420_arith_dac.jpg": (
        197, 261, False, 16, {"writer": "encode_scans", "quality": 85, "sampling": SAMPLING_420, "arithmetic": True,
                              "progressive": False, "conditioning": [[2, 6, 2], [1, 4, 12]], "restart": 5}
    ),
    "view_259x195_q90_420_progressive_dc_only.jpg": (
        195, 259, False, 17, {"quality": 90, "subsampling": 2, "progressive": True, "scans_kept": 1}
    ),
    "view_259x195_q85_444_arith_progressive_ac1_9_partial.jpg": (
        195, 259, False, 18, {"writer": "encode_scans", "quality": 85, "sampling": [[1, 1], [1, 1], [1, 1]],
                              "arithmetic": True, "progressive": True, "scans": [
                                  [[0, 1, 2], 0, 0, 0, 0], [[0], 1, 9, 0, 2], [[1], 1, 9, 0, 1], [[2], 1, 9, 0, 1],
                                  [[0], 10, 63, 0, 0], [[1], 10, 63, 0, 0], [[2], 10, 63, 0, 0], [[0], 1, 9, 2, 1]]}
    ),
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


def splice_adobe(data: bytes, transform: int) -> bytes:
    """PIL's JPEG with its JFIF APP0 segment replaced by an Adobe APP14
    segment of ``transform`` (as Photoshop writes: version 100, no flags)."""
    if data[2:4] != b"\xff\xe0":
        raise ValueError("expected PIL's JFIF APP0 segment right after SOI")
    app0_end = 4 + int.from_bytes(data[4:6], "big")
    app14 = b"\xff\xee\x00\x0eAdobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    return data[:2] + app14 + data[app0_end:]


def keep_scans(data: bytes, keep: int) -> bytes:
    """``data`` (a progressive JPEG) ending after its first ``keep`` scans:
    the later scans, which refine the coefficients, are left out."""
    pos, scans = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            scans += 1
            end = pos + 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
            if scans == keep:
                return data[:end] + b"\xff\xd9"
            pos = end
        else:
            pos += 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")


def encode(img: np.ndarray, save: dict, seed: int) -> bytes:
    save = dict(save)
    writer = save.pop("writer", None)
    if writer == "encode_scans":
        scans = save.pop("scans", None)
        return encode_scans(img, sampling=[tuple(f) for f in save.pop("sampling", [[1, 1]])],
                            scans=None if scans is None else [(tuple(c), *rest) for c, *rest in scans], **save)
    if writer == "encode_baseline":
        return encode_baseline(img, sampling=[tuple(f) for f in save["sampling"]], quality=save["quality"],
                               restart=save.get("restart", 0))
    if writer == "encode_png":
        return encode_png(img)
    if writer == "encode_png_any":
        # 16-bit samples whose low bytes carry noise: PIL keeps the high bytes
        low = np.random.default_rng(seed).integers(0, 256, img.shape)
        return encode_png_any(img.astype(np.uint16) * 256 + low, save["depth"], save["color_type"],
                              interlace=save["interlace"])
    from PIL import Image

    transform = save.pop("adobe_transform", None)
    kept = save.pop("scans_kept", None)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **save)
    data = buf.getvalue()
    if kept is not None:
        data = keep_scans(data, kept)
    return data if transform is None else splice_adobe(data, transform)


def pil_decode(data: bytes):
    """``np.asarray(PIL.Image.open(...))`` of the bytes, or None where PIL
    raises (any of its errors: OSError, SyntaxError, ValueError, ...)."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im)
    except Exception:
        return None


def main() -> None:
    from PIL import Image

    out = {}
    for name, (h, w, gray, seed, save) in FIXTURES.items():
        if save.get("writer") != "libjpeg_arith.c":
            with open(path(name), "wb") as fh:
                fh.write(encode(make_image(h, w, gray, seed), save, seed))
        with Image.open(path(name)) as im:
            pixels = np.asarray(im)
        out[name] = {"shape": list(pixels.shape), "sha256": sha256(pixels), "save": save}
        if name in DAMAGED:
            out[name]["damaged"] = {case: damaged_outcome(pil_decode(damaged(name, case))) for case in DAMAGED[name]}
    with open(MANIFEST, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
