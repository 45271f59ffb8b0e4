"""Images for the evaluation harness: image folders and synthetic data.

The port's own copy of three functions of the JAX package's
``utils/data.py``.  ``synthetic_images`` makes band-limited noise with a
natural-image-like 1/f spectrum, the same numpy code and so the same uint8
images for the same arguments, so that rates mean something without a
dataset on disk.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


def list_images(directory: str) -> List[str]:
    """The image files of ``directory`` (PNG, JPEG, BMP, PPM), sorted."""
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".ppm"}
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if os.path.splitext(f)[1].lower() in exts)


def load_image(path: str) -> np.ndarray:
    """-> (height, width, 3) uint8 RGB.  Needs PIL, imported here only:
    without it, evaluate synthetic images (no ``--data``)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading images from --data needs PIL (Pillow); "
                          "without it, leave out --data to evaluate "
                          "synthetic images") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def synthetic_images(n: int, x: int, y: int, seed: int = 0,
                     alpha: float = 1.6) -> np.ndarray:
    """(n, x, y, 3) uint8 band-limited noise with a 1/f^alpha spectrum."""
    rng = np.random.default_rng(seed)
    fx = np.fft.fftfreq(x)[:, None]
    fy = np.fft.rfftfreq(y)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fx, fy), 1.0 / max(x, y)) ** alpha
    out = np.empty((n, x, y, 3), np.uint8)
    for i in range(n):
        for c in range(3):
            phase = rng.uniform(0, 2 * np.pi, size=amp.shape)
            spec = amp * np.exp(1j * phase)
            img = np.fft.irfft2(spec, s=(x, y))
            img = (img - img.min()) / max(float(np.ptp(img)), 1e-9)
            out[i, ..., c] = np.round(255 * img).astype(np.uint8)
    return out
