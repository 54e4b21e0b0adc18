"""JPEG fixtures that PIL wrote, with each one's shape and the SHA-256 of
PIL's decode (``manifest.json``): what ``utils/jpeg.py`` is held to where
PIL is absent, as on the card's host (``chip_smoke.py`` phase 9).

``DENSE`` is a dense view at the capture size, 4096x3000 (a landscape
sensor), 4:2:0 with a restart interval; the others are working-size views
in 4:2:2 and 4:4:4 and a gray image. Regenerate them with PIL by
``python -m topo4d_tpu_torch.fixtures`` (the images are made from a seed;
the hashes are PIL's decode of the files written).
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


def manifest() -> Dict[str, dict]:
    """file name -> {"shape": [H, W(, 3)], "sha256": hex digest of PIL's
    decoded bytes, "save": PIL's save options}."""
    with open(MANIFEST) as fh:
        return json.load(fh)


def path(name: str) -> str:
    return os.path.join(FIXTURE_DIR, name)


def sha256(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
