"""Kernel G: the float32 5x5 / stride-2 transposed conv of g_s, and its
plain version.

flax's ``ConvTranspose(k=5, s=2, padding="SAME")``, which PyTorch spells
``conv_transpose2d(x, w, bias, stride=2, padding=1)[..., :-1, :-1]``, as
four output phases: output (2q + py, 2r + px) sums x at rows q - 1 .. q
(py = 0, kernel rows 3, 1) or q - 1 .. q + 1 (py = 1, kernel rows 4, 2,
0), and likewise for columns, so each phase is a dense conv over the input
grid with 2x2, 2x3, 3x2 or 3x3 taps.

* ``deconv5s2_f32`` launches kernel G (``csrc/deconv5s2_f32.cu``) on a
  CUDA tensor, counted in ``deconv5s2_f32.launches``, and runs
  ``deconv5s2_f32_plain``, the four phase convs in PyTorch, on a CPU
  tensor (``.plain_runs``).
* ``pack_deconv5s2`` lays the (C, O, 5, 5) weights out for a variant of
  the kernel's tile, ``pick_variant`` chooses it from the output channels.

Kernel G replaces no Pallas kernel: the JAX package left g_s to XLA.  It
sums each output in one fixed order whatever the variant, the batch or the
tile, so its results are the same bits from run to run and for an image
alone as in a batch; the plain version sums in cuDNN's or oneDNN's order,
within float32 rounding of it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _build
from .cuda_conv import _call_on


class Variant(NamedTuple):
    """A block tile of kernel G, as the kernel's ``launch`` template
    arguments: TQ x TR input-grid positions, R a thread, NG groups of TN
    output channels, KC input channels a stage."""
    tq: int
    tr: int
    r: int
    tn: int
    ng: int
    kc: int

    @property
    def tnp(self) -> int:
        """A group's packed weight columns: TN rounded up to 4."""
        return -(-self.tn // 4) * 4


# In the order of the kernel's ``variant`` switch: 32 output channels a
# block for O > 3, and the RGB layer's tile (O <= 3: one group of 3).
VARIANTS = (Variant(4, 32, 8, 4, 8, 8), Variant(16, 64, 8, 3, 1, 4))
MAIN, RGB = range(2)
# kernel rows (or columns) of output phase p, for input offsets -1, 0 (, 1)
PHASE_TAPS = ((3, 1), (4, 2, 0))


def pick_variant(o: int) -> int:
    """RGB for at most 3 output channels, MAIN otherwise.  The choice moves
    no bit: both variants sum in the same order."""
    return RGB if o <= 3 else MAIN


def pack_deconv5s2(w: torch.Tensor, variant: int) -> torch.Tensor:
    """(C, O, 5, 5) ConvTranspose2d weights -> (n_ob, Cp, 25, NG * TNP),
    the variant's layout: element [ob, c, ky*5 + kx, g*TNP + n] holds w[c,
    ob*NG*TN + g*TN + n, ky, kx]; zeros past C (Cp is C rounded up to KC),
    past O and in a group's TNP - TN padding columns."""
    v = VARIANTS[variant]
    c, o = w.shape[:2]
    n_ob = -(-o // (v.ng * v.tn))
    cp = -(-c // v.kc) * v.kc
    wt = F.pad(w.reshape(c, o, 25),
               (0, 0, 0, n_ob * v.ng * v.tn - o, 0, cp - c))
    wt = wt.reshape(cp, n_ob, v.ng, v.tn, 25)
    if v.tnp > v.tn:
        wt = F.pad(wt, (0, 0, 0, v.tnp - v.tn))
    return (wt.permute(1, 0, 4, 2, 3)
            .reshape(n_ob, cp, 25, v.ng * v.tnp).contiguous())


def deconv5s2_f32_plain(x: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G: each output phase (py, px) as one conv2d
    of x padded by one on each side with its 2 or 3 kernel rows and
    columns (``PHASE_TAPS``), written to out[..., py::2, px::2]."""
    b, _, h, wd = x.shape
    out = x.new_empty((b, w.shape[1], 2 * h, 2 * wd))
    xp = F.pad(x, (1, 1, 1, 1))
    for py, ky in enumerate(PHASE_TAPS):
        for px, kx in enumerate(PHASE_TAPS):
            k = w[:, :, list(ky)][:, :, :, list(kx)].transpose(0, 1)
            out[:, :, py::2, px::2] = F.conv2d(
                xp[:, :, :h + len(ky) - 1, :wd + len(kx) - 1], k, bias)
    return out


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or bias.dim() != 1:
        raise ValueError("expected x (B,C,H,W), w (C,O,5,5), bias (O,)")
    if (w.shape[0] != x.shape[1] or tuple(w.shape[2:]) != (5, 5)
            or bias.shape[0] != w.shape[1]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")
    if not (x.dtype == w.dtype == bias.dtype == torch.float32):
        raise TypeError("deconv5s2_f32 takes float32 x, weights and bias")
    if not (x.device == w.device == bias.device):
        raise ValueError("x, weights and bias must be on one device")


def deconv5s2_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  packs: Optional[Dict[int, tuple]] = None) -> torch.Tensor:
    """x (B, C, H, W) float32 NCHW, w (C, O, 5, 5), bias (O,) -> (B, O, 2H,
    2W) float32: flax's ConvTranspose(5, 2, "SAME") with these weights.

    CUDA tensors launch kernel G (``deconv5s2_f32.launches``); CPU tensors
    run the plain version (``.plain_runs``).  ``packs``, a dict the caller
    keeps, holds the packed weights by variant from call to call; they are
    packed again when ``w`` moves or is written in place."""
    _check(x, w, bias)
    if x.device.type == "cpu":
        deconv5s2_f32.plain_runs += 1
        return deconv5s2_f32_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("deconv5s2_f32 takes contiguous tensors")
    o = w.shape[1]
    variant = pick_variant(o)
    key = (w.data_ptr(), w._version)
    got = packs.get(variant) if packs is not None else None
    if got is None or got[0] != key:
        got = (key, pack_deconv5s2(w, variant))
        if packs is not None:
            packs[variant] = got
    return _launch(x, got[1], bias, o, variant)


def _launch(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor, o: int,
            variant: int) -> torch.Tensor:
    """Kernel G on ``wp``, ``pack_deconv5s2(w, variant)`` made ahead: a
    call that launches the kernel and nothing else."""
    b, c, h, wd = x.shape
    v = VARIANTS[variant]
    n_ob = -(-o // (v.ng * v.tn))
    if (tuple(wp.shape) != (n_ob, -(-c // v.kc) * v.kc, 25, v.ng * v.tnp)
            or wp.dtype != torch.float32 or wp.device != x.device
            or not wp.is_contiguous()):
        raise ValueError(f"packed weights {tuple(wp.shape)} do not fit "
                         f"C={c}, O={o} in variant {variant}")
    if b > 65535 or (variant == RGB and o > 3):
        raise ValueError(f"B={b}, O={o} outside variant {variant}'s range")
    out = torch.empty((b, o, 2 * h, 2 * wd), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    err = _call_on(x, _build.lib().sicn_deconv5s2_f32, x.data_ptr(),
                   wp.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h,
                   wd, o, variant)
    _build.check(err, "deconv5s2_f32")
    deconv5s2_f32.launches += 1
    return out


deconv5s2_f32.launches = 0
deconv5s2_f32.plain_runs = 0
