"""Images for evaluation and training: image folders, synthetic data, the
mixed training bank and its crops.

The port's own copy of the JAX package's ``utils/data.py``: the same numpy
code, so the same uint8 images and crops for the same arguments and seeds.
``synthetic_images`` makes band-limited noise with a natural-image-like 1/f
spectrum, so that rates mean something without a dataset on disk;
``training_bank`` mixes it with photographs and screen content bundled with
installed packages (sklearn, pygame) where those are present, and with
piecewise-smooth edges and textures.  sklearn, pygame and PIL are imported
only to read such sources: without them the bank is the synthetic part
alone, as in the JAX package.  Nothing is downloaded.
"""

from __future__ import annotations

import glob as globlib
import os
import sys
from typing import Iterator, List

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


def bundled_photos() -> List[np.ndarray]:
    """Real photographs bundled with installed packages, excluding every
    source of the RD evaluation set: sklearn's china.jpg only (its
    flower.jpg, pygame's camera and intro images and matplotlib's
    grace_hopper are evaluation sources).  Empty without sklearn."""
    out: List[np.ndarray] = []
    try:
        from sklearn.datasets import load_sample_image
        out.append(np.asarray(load_sample_image("china.jpg"), np.uint8))
    except Exception:       # no sklearn, or no image bundled with it
        pass
    return out


_SCREEN_SOURCES = (
    # pygame-docs tutorial screenshots used by no evaluation frame and
    # sharing no scene with one: real raster screen content for the bank
    "pygame/docs/generated/_images/tom_basic.png",
    "pygame/docs/generated/_images/tom_event-flowchart.png",
    "pygame/docs/generated/_images/tom_formulae.png",
    "pygame/docs/generated/_images/tom_radians.png",
    "pygame/docs/generated/_images/draw_module_example.png",
    "pygame/docs/generated/_images/joystick_calls.png",
    "pygame/docs/generated/_images/Basic-ouput-sourcecode.png",
)


def bundled_screens() -> List[np.ndarray]:
    """Screen-content rasters bundled with installed packages (pygame's
    docs), disjoint from every evaluation scene.  Empty without them (or
    without PIL to read them)."""
    out: List[np.ndarray] = []
    for rel in _SCREEN_SOURCES:
        for base in sys.path:
            hits = globlib.glob(os.path.join(base, rel))
            if hits:
                try:
                    out.append(load_image(hits[0]))
                except Exception:   # unreadable, or no PIL
                    pass
                break
    return out


def _gradient_edges(rng: np.random.Generator, x: int, y: int) -> np.ndarray:
    """Piecewise-smooth content: a smooth color gradient, random half-plane
    fills (sharp edges) and a few soft discs."""
    yy, xx = np.meshgrid(np.linspace(0, 1, y), np.linspace(0, 1, x))
    img = np.zeros((x, y, 3), np.float64)
    for c in range(3):
        a, b, d = rng.uniform(-1, 1, 3)
        img[..., c] = 0.5 + 0.4 * (a * xx + b * yy + d * xx * yy)
    for _ in range(rng.integers(2, 6)):
        nx, ny = rng.normal(size=2)
        cx, cy = rng.uniform(0.2, 0.8, 2)
        mask = nx * (xx - cx) + ny * (yy - cy) > 0
        img[mask] = rng.uniform(0, 1, 3)
    for _ in range(rng.integers(1, 4)):
        cx, cy, r = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), \
            rng.uniform(0.05, 0.3)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        w = np.exp(-d2 / (2 * r * r))[..., None]
        img = img * (1 - 0.7 * w) + rng.uniform(0, 1, 3) * 0.7 * w
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def _texture(rng: np.random.Generator, x: int, y: int) -> np.ndarray:
    """Oriented quasi-periodic texture: a sum of sinusoidal gratings plus
    broadband noise, mapped through a random 2-color ramp."""
    yy, xx = np.meshgrid(np.arange(y), np.arange(x))
    f = np.zeros((x, y), np.float64)
    for _ in range(rng.integers(2, 5)):
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(0.02, 0.25)
        f += rng.uniform(0.3, 1.0) * np.sin(
            2 * np.pi * freq * (np.cos(th) * xx + np.sin(th) * yy)
            + rng.uniform(0, 2 * np.pi))
    f += rng.normal(0, 0.3, f.shape)
    f = (f - f.min()) / max(float(np.ptp(f)), 1e-9)
    c0, c1 = rng.uniform(0, 255, (2, 3))
    return np.clip(c0 + (c1 - c0) * f[..., None], 0, 255).astype(np.uint8)


def training_bank(n: int = 48, x: int = 512, y: int = 512,
                  seed: int = 0) -> np.ndarray:
    """Mixed-content training bank (n, x, y, 3) uint8: ~25% crops of the
    bundled photos and ~15% of the bundled screens (each resized up,
    flipped and transposed at random; none without sources), then 1/f
    noise over a range of spectral slopes for 60% of the rest, then
    piecewise-smooth edges and textures, alternating."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, x, y, 3), np.uint8)
    photos = bundled_photos()
    screens = bundled_screens()

    def crop_of(src):
        from PIL import Image       # only with a photo or a screen to crop
        scale = max(x / src.shape[0], y / src.shape[1]) * \
            rng.uniform(1.0, 1.6)
        im = Image.fromarray(src).resize(
            (int(src.shape[1] * scale + 1), int(src.shape[0] * scale + 1)),
            Image.BICUBIC)
        arr = np.asarray(im, np.uint8)
        ox = rng.integers(0, arr.shape[0] - x + 1)
        oy = rng.integers(0, arr.shape[1] - y + 1)
        crop = arr[ox:ox + x, oy:oy + y]
        if rng.random() < 0.5:
            crop = crop[::-1]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        if rng.random() < 0.5 and x == y:
            crop = np.swapaxes(crop, 0, 1)
        return crop

    i = 0
    for k in range(n // 4 if photos else 0):
        out[i] = crop_of(photos[k % len(photos)])
        i += 1
    for k in range((3 * n) // 20 if screens else 0):
        out[i] = crop_of(screens[k % len(screens)])
        i += 1
    n_noise = (3 * (n - i)) // 5
    alphas = np.linspace(1.0, 2.2, max(n_noise, 1))
    for k in range(n_noise):
        out[i] = synthetic_images(1, x, y, seed=seed + 101 + k,
                                  alpha=float(alphas[k]))[0]
        i += 1
    for k in range(n - i):
        out[i + k] = (_gradient_edges(rng, x, y) if k % 2 == 0
                      else _texture(rng, x, y))
    return out


def random_crops(images: np.ndarray, crop: int, batch: int,
                 rng: np.random.Generator) -> np.ndarray:
    """(B, crop, crop, 3) float32 in [0, 1] sampled from a uint8 image
    stack on the host (the data-parallel path's input)."""
    n, x, y, _ = images.shape
    out = np.empty((batch, crop, crop, 3), np.float32)
    for b in range(batch):
        i = rng.integers(0, n)
        ox = rng.integers(0, x - crop + 1)
        oy = rng.integers(0, y - crop + 1)
        out[b] = images[i, ox:ox + crop, oy:oy + crop] / 255.0
    return out


def crop_batches(images: np.ndarray, crop: int, batch: int, steps: int,
                 seed: int = 0) -> Iterator[np.ndarray]:
    """``steps`` batches of ``random_crops`` from one generator."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield random_crops(images, crop, batch, rng)
