"""Image fixtures with each one's shape and the SHA-256 of PIL's decode
(``manifest.json``): what ``utils/jpeg.py`` and ``utils/png.py`` are held to
where PIL is absent, as on the card's host (``chip_smoke.py`` phases 9 and
13).

``BASELINE`` are the sequential JPEGs PIL wrote: ``DENSE``, a dense view at
the capture size, 4096x3000 (a landscape sensor), 4:2:0 with a restart
interval; working-size views in 4:2:2 and 4:4:4 and a gray image. ``KINDS``
are the other kinds the loader reads: ``DENSE_PROGRESSIVE``, the same dense
image as PIL's progressive JPEG; progressive 4:4:4 and gray views; an Adobe
APP14 marker of transform 0 (RGB) and of transform 1 (YCbCr) spliced into
PIL's output in place of its JFIF marker; 4:4:0 and 4:1:1 views from
``jpeg_writer.encode_baseline`` (PIL writes neither sampling); an
Adam7-interlaced 16-bit RGB PNG from ``png_writer.encode_png_any``; and
arithmetic-coded files from ``jpeg_writer.encode_scans``: a working-size
4:2:2 sequential (SOF9) view, progressive (SOF10) 4:4:4 and gray views, a
4:2:0 view whose DAC segment sets non-default conditioning values; two
progressive files whose scans leave coefficient bits unsent (which the
decoder smooths as libjpeg-turbo does): PIL's 4:2:0 file cut after its DC
scan, and a SOF10 file whose coefficients 1-9 keep their lowest bit
unsent; and two 61x43 arithmetic files (SOF9, SOF10) libjpeg wrote through
``libjpeg_arith.c``, an encoder independent of the writer's.
Regenerate them by ``python -m topo4d_tpu_torch.fixtures`` (the images are
made from a seed; the hashes are PIL's decode of the files written). Every
arithmetic file stays under PIL's 64 KiB read block: PIL, and so JAX's
loader, fails on a larger one.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict

import numpy as np

FIXTURE_DIR = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(FIXTURE_DIR, "manifest.json")
DENSE = "dense_4096x3000_q85_420.jpg"
DENSE_PROGRESSIVE = "dense_4096x3000_q85_420_progressive.jpg"
BASELINE = (DENSE, "view_517x389_q75_422.jpg", "view_517x389_q95_444.jpg", "gray_515x387_q85.jpg")
KINDS = (
    DENSE_PROGRESSIVE,
    "view_259x195_q90_444_progressive.jpg",
    "gray_257x193_q85_progressive.jpg",
    "view_261x197_q85_adobe0.jpg",
    "view_261x197_q85_adobe1.jpg",
    "view_263x199_q85_440.jpg",
    "view_263x199_q85_411.jpg",
    "view_127x93_rgb16_adam7.png",
    "libjpeg_61x43_q85_420_arith.jpg",
    "libjpeg_61x43_q85_420_arith_progressive.jpg",
    "view_517x389_q75_422_arith.jpg",
    "view_259x195_q90_444_arith_progressive.jpg",
    "gray_257x193_q85_arith_progressive.jpg",
    "view_261x197_q85_420_arith_dac.jpg",
    "view_259x195_q90_420_progressive_dc_only.jpg",
    "view_259x195_q85_444_arith_progressive_ac1_9_partial.jpg",
)


def manifest() -> Dict[str, dict]:
    """file name -> {"shape": [H, W(, 3)], "sha256": hex digest of PIL's
    decoded bytes, "save": how it was written (PIL's save options, or the
    writer's and splice's)}."""
    with open(MANIFEST) as fh:
        return json.load(fh)


def path(name: str) -> str:
    return os.path.join(FIXTURE_DIR, name)


def sha256(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
