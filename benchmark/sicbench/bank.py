"""Seeded image banks, made on the device in a few large calls.

Band-limited noise with a 1/f^alpha spectrum, a stand-in for photographs
(the generator of the program's ``utils/data.py:synthetic_images``, moved
to the card): each image-channel is the inverse real FFT of amplitudes
1/f^alpha with uniform random phases, scaled to its own [0, 255].  The
bank's exponents are fixed by the traffic file, evenly spaced over
[alpha_lo, alpha_hi]; the seed draws the phases and the order.  So every
seed codes the same mix of smooth and busy images, and the rate and the
bytes stay a property of the codec, not of the draw.
"""

from __future__ import annotations

import math

import torch

CHUNK = 16        # images a call makes


def image_bank(n: int, height: int, width: int, seed: int,
               alpha_lo: float, alpha_hi: float, device) -> torch.Tensor:
    """(n, height, width, 3) uint8 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fx = torch.fft.fftfreq(height, device=device)[:, None]
    fy = torch.fft.rfftfreq(width, device=device)[None, :]
    radius = torch.clamp(torch.hypot(fx, fy), min=1.0 / max(height, width))
    alphas = torch.linspace(alpha_lo, alpha_hi, n, device=device)
    alphas = alphas[torch.randperm(n, generator=gen, device=device)]
    out = torch.empty((n, height, width, 3), dtype=torch.uint8,
                      device=device)
    for i in range(0, n, CHUNK):
        a = alphas[i:i + CHUNK]
        b = a.numel()
        amp = radius[None] ** -a[:, None, None]                # (b, X, Y/2+1)
        phase = torch.rand((b, 3) + radius.shape, generator=gen,
                           device=device) * (2 * math.pi)
        img = torch.fft.irfft2(torch.polar(amp[:, None].expand_as(phase),
                                           phase), s=(height, width))
        lo = img.amin(dim=(2, 3), keepdim=True)
        hi = img.amax(dim=(2, 3), keepdim=True)
        img = (img - lo) / torch.clamp(hi - lo, min=1e-9)
        out[i:i + b] = torch.round(255 * img).to(torch.uint8).permute(
            0, 2, 3, 1)
    return out
