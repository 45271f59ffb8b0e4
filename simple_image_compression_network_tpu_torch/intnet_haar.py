"""Constructive integer Haar-wavelet weights for the reference topology.

The port's own copy of the JAX package's ``intnet_haar.py`` (numpy only):
the weights of the wavelet integer codec's four profiles
(``codec/wavelet_codec.py``), its golden output, and the host wire and
display maps.

The reference's integer semantics (int4 weights, 8-bit accumulator wrap,
MSB-ReLU, no requantization) admit no averaging and no rescaling, but they
express exactly a multiresolution integer wavelet transform built from
sampling and offset differences:

  * DC path       -- stride-2 sampling (a single w=+1 tap): no growth,
                     values stay in [0, 63] for a ``x >> 2`` wire input.
  * detail path   -- neighbor differences with a +64 offset:
                     ``d' = x[odd] - x[even] + 64 in [1, 127]``; biases of
                     later layers subtract the offset back out.
  * packing       -- space-to-depth through a strided conv (w=+1 taps at
                     the four phase offsets) carries finer-scale details
                     through deeper analysis layers.
  * synthesis     -- the 5x5/s2 deconv's four output phases select
                     kernel-tap parity, so ``x[2a+px, 2b+py]`` routes
                     through taps ``kx = 2 - px (mod 2)``; each phase sums
                     DC + its detail channel with a shared -64 bias.
  * CONST channel -- one always-64 channel (w=0, bias 64) per level makes
                     the shared per-output-channel bias consistent across
                     phases that sum different numbers of offset channels.

Budget: the 48x32x192 latent holds exactly 1/4 of the input samples, so a
lossless code of the half-resolution image fills it with zero slack:
``DC4 (3) + det4 (9) + pack(det3) (36) + pack^2(det2) (143 of 144) +
CONST (1) = 192``.  The finest detail scale (det1) is dropped: the codec
reconstructs the half-res image exactly (one det2 channel loses 1/16 of
its positions to make room for CONST) and upsamples it 2x2.

Every weight is in {-1, 0, +1}, every activation in [0, 127]: the mod-256
wrap never fires, so the construction is bit-exact under the reference's
own semantics by range analysis.

Wire contract: input ``x >> 2`` (values 0..63), display map
``x_disp = 4*y + 1.5`` (``DISP_A``, ``DISP_B``; halved gain with the
bilinear output layer), PSNR ceiling 46.9 dB.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import ModelConfig, REFERENCE_NET

OFFSET = 64          # detail-channel offset: diff + 64 in [1, 127]
INPUT_SHIFT = 2      # wire input is x >> 2 (0..63)
DISP_A = 4.0         # display map: x_disp = DISP_A * y + DISP_B
DISP_B = 1.5

# channel-map constants (analysis levels)
_DET0 = 3            # det(c, t) = _DET0 + 3*c + t   (t: 0=H, 1=V, 2=D)
_PACK0 = 12          # pack(s, ph) = _PACK0 + 4*s + ph  (s = det index - 3)
_CONST_L0 = 12       # L0 has no packed channels; const right after dets
_CONST = 48          # const channel in L1/L2 outputs and synthesis maps
_CONST_LATENT = 191  # const channel in the 192-ch latent
# taps: analysis reads in[2i+kx-2]; kx=2 -> x[2i], kx=3 -> x[2i+1]
_DIFF_TAPS = ((3, 2), (2, 3), (3, 3))     # H, V, D detail offsets
# synthesis phase (px,py) reads in[a,b] through tap (2-px, 2-py)
_PHASE_TAP = {(0, 0): (2, 2), (1, 0): (1, 2),
              (0, 1): (2, 1), (1, 1): (1, 1)}


def _alloc(cfg: ModelConfig, i: int):
    layer = cfg.layers[i]
    w = np.zeros(layer.weight_shape, np.int8)      # (O, kx, ky, I)
    b = np.zeros((layer.out_ch,), np.int8)
    return w, b


def _analysis_level(w, b, n_ch: int, const_in: int, const_out: int,
                    pack_srcs) -> None:
    """DC sample + offset details of channels 0..n_ch-1, pack pack_srcs,
    forward the const channel."""
    for c in range(n_ch):
        w[c, 2, 2, c] = 1                          # DC: sample even-even
        for t, (kx, ky) in enumerate(_DIFF_TAPS):  # details: diff + 64
            o = _DET0 + 3 * c + t
            w[o, kx, ky, c] = 1
            w[o, 2, 2, c] = -1
            b[o] = OFFSET
    for dst, src in pack_srcs:                     # space-to-depth x4
        for ph, (di, dj) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            w[dst + ph, 2 + di, 2 + dj, src] = 1
    if const_out >= 0:
        if const_in >= 0:
            w[const_out, 2, 2, const_in] = 1       # forward the 64
        else:
            b[const_out] = OFFSET                  # create the 64 (w=0)


def _synthesis_level(w, b, n_ch: int, const_in: int, const_out: int,
                     unpack_srcs, det_in0: int = _DET0) -> None:
    """Reconstruct DC at 2x from DC + offset details, unpack packed
    details, forward the const channel.  deconv522 tap algebra: phase
    (px,py) reads in[a,b] through tap (2-px, 2-py)."""
    for c in range(n_ch):
        o = c
        for ph, (px, py) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            kx, ky = _PHASE_TAP[(px, py)]
            w[o, kx, ky, c] = 1                    # DC into every phase
            if (px, py) == (0, 0):
                w[o, kx, ky, const_in] = 1         # + const 64
            else:
                t = {(1, 0): 0, (0, 1): 1, (1, 1): 2}[(px, py)]
                w[o, kx, ky, det_in0 + 3 * c + t] = 1   # + detail (d+64)
        b[o] = -OFFSET                             # shared: cancels the 64
    for dst, src, missing_const in unpack_srcs:    # depth-to-space
        for ph, (px, py) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            kx, ky = _PHASE_TAP[(px, py)]
            s = src + ph
            if s < 0:                              # dropped channel:
                w[dst, kx, ky, missing_const] = 1  # substitute const (=64
                continue                           # = "diff 0")
            w[dst, kx, ky, s] = 1
    if const_out >= 0:
        for kx, ky in _PHASE_TAP.values():
            w[const_out, kx, ky, const_in] = 1


def haar_params(cfg: ModelConfig = REFERENCE_NET, *,
                interp: bool = True,
                chroma420: bool = False,
                det2_keep=None) -> Dict[str, np.ndarray]:
    """The full int8 parameter dict (reference_weights.npz layout) plus the
    disp_a/disp_b display-map header constants.

    interp=True emits the final 2x upsample as integer bilinear (two-tap
    sums at output scale 2, display gain halved); False replicates.

    chroma420=True drops the finest detail scale (det2) for wire channels
    1 and 2 — with the YCoCg wire profile this is chroma subsampling (the
    chroma planes reconstruct from their quarter-res pyramid): latent
    channels 97..191 fall to constant zero (~0 bits), the classic
    rate/quality trade of broadcast codecs.  The latent map becomes
    DC4 (3) + det4 (9) + pack(det3) (36) + pack^2(det2 luma) (48) +
    CONST (96), no slot sacrifice needed."""
    if len(cfg.layers) != 8 or cfg.latent_shape[-1] != 192:
        raise ValueError("the Haar construction needs the reference "
                         "topology: 8 layers, a 192-channel latent")
    keep = ((0, 1, 2) if chroma420
            else tuple(det2_keep) if det2_keep is not None
            else tuple(range(9)))
    return _haar_params_subset(cfg, interp, keep=keep)


def _haar_params_subset(cfg: ModelConfig, interp: bool,
                        keep) -> Dict[str, np.ndarray]:
    """det2-subset variants: L0/L1 identical to the full construction; L2
    packs only the kept det2 channels (``keep`` = kept s indices, e.g.
    (0,1,2) = luma-only "chroma 4:1:0"); the latent const sits right after
    the packed details; the synthesis substitutes CONST (diff 0) for every
    dropped det2 phase."""
    keep = tuple(keep)
    n_keep = len(keep)
    # the full det2 set fills the latent exactly (48 + 144 = 192): CONST
    # then steals the last pack^2 slot (q = 4*n_keep-1, phase 3) — the
    # "sacrifice"; any proper subset leaves room after the packed details
    sacrifice = 48 + 16 * n_keep > 191
    const_latent = 191 if sacrifice else 48 + 16 * n_keep
    params: Dict[str, np.ndarray] = {}

    w, b = _alloc(cfg, 0)
    _analysis_level(w, b, 3, const_in=-1, const_out=_CONST_L0, pack_srcs=())
    params["w0"], params["b0"] = w, b

    w, b = _alloc(cfg, 1)
    _analysis_level(w, b, 3, const_in=_CONST_L0, const_out=_CONST,
                    pack_srcs=[(_PACK0 + 4 * s, _DET0 + s)
                               for s in range(9)])
    params["w1"], params["b1"] = w, b

    w, b = _alloc(cfg, 2)     # pack the kept det2 channels only
    _analysis_level(w, b, 3, const_in=_CONST, const_out=_CONST,
                    pack_srcs=[(_PACK0 + 4 * i, _DET0 + s)
                               for i, s in enumerate(keep)])
    params["w2"], params["b2"] = w, b

    w, b = _alloc(cfg, 3)     # latent: DC4, det4, p(det3), p^2(det2 kept)
    pack = [(_PACK0 + 4 * s, _DET0 + s) for s in range(9)]
    pack += [(48 + 4 * q, _PACK0 + q) for q in range(4 * n_keep)]
    _analysis_level(w, b, 3, const_in=_CONST, const_out=const_latent,
                    pack_srcs=pack)
    if sacrifice:
        w[const_latent] = 0          # overwrite the (q=35, ph=3) pack
        w[const_latent, 2, 2, _CONST] = 1   # slot with the const forward
        b[const_latent] = 0
    params["w3"], params["b3"] = w, b

    w, b = _alloc(cfg, 4)     # level-3 map [DC3, det3, p(det2 kept), const]
    unpack = [(_DET0 + s, _PACK0 + 4 * s, const_latent) for s in range(9)]
    unpack += [(_PACK0 + q, 48 + 4 * q, const_latent)
               for q in range(4 * n_keep)
               if not (sacrifice and q == 4 * n_keep - 1)]
    _synthesis_level(w, b, 3, const_in=const_latent, const_out=_CONST,
                     unpack_srcs=unpack)
    if sacrifice:
        # sacrificed slot: phases 0..2 are real, phase 3 decodes as const
        # (= "diff 0")
        q = 4 * n_keep - 1
        for ph, (px, py) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            kx, ky = _PHASE_TAP[(px, py)]
            src = 48 + 4 * q + ph if ph < 3 else const_latent
            w[_PACK0 + q, kx, ky, src] = 1
    params["w4"], params["b4"] = w, b

    w, b = _alloc(cfg, 5)     # level-2 map: kept det2 real, rest = const
    unpack = [(_DET0 + s, _PACK0 + 4 * i, _CONST)
              for i, s in enumerate(keep)]
    unpack += [(_DET0 + s, -1000, _CONST)
               for s in range(9) if s not in keep]
    _synthesis_level(w, b, 3, const_in=_CONST, const_out=_CONST,
                     unpack_srcs=unpack)
    params["w5"], params["b5"] = w, b

    w, b = _alloc(cfg, 6)
    _synthesis_level(w, b, 3, const_in=_CONST, const_out=_CONST,
                     unpack_srcs=())
    params["w6"], params["b6"] = w, b

    w, b = _alloc(cfg, 7)
    if interp:
        for c in range(3):
            w[c, 2, 2, c] = 2
            w[c, 1, 2, c] = 1
            w[c, 3, 2, c] = 1
            w[c, 2, 1, c] = 1
            w[c, 2, 3, c] = 1
            w[c, 1, 1, c] = 1
            w[c, 3, 3, c] = 1
    else:
        for c in range(3):
            for kx, ky in _PHASE_TAP.values():
                w[c, kx, ky, c] = 1
    params["w7"], params["b7"] = w, b

    params["disp_a"] = np.full((3,), DISP_A / (2.0 if interp else 1.0),
                               np.float32)
    params["disp_b"] = np.full((3,), DISP_B, np.float32)
    return params


def golden_wavelet(x_u8: np.ndarray, *, interp: bool = True,
                   chroma420: bool = False, det2_drop=(),
                   wire: np.ndarray | None = None) -> np.ndarray:
    """Expected int output of the Haar net for uint8 input (N, X, Y, 3)
    (or a precomputed wire tensor via ``wire=``, e.g. the YCoCg profile).

    The decoded half-res image is the x>>2 even-even samples (exact,
    except the det2 channel slot sacrificed for CONST: channel-2 diagonal
    details at level-2 positions (i2 % 4 == 3, j2 % 4 == 3) decode as
    diff 0; with chroma420 the whole det2 scale of channels 1 and 2
    decodes as diff 0 instead).  The final layer upsamples it 2x2 —
    replication (interp=False) or two-tap integer bilinear at output
    scale 2 (interp=True; the deconv's zero pad makes border sums degrade
    to the half-value on the last row/column).
    """
    if wire is None:
        xq = (np.asarray(x_u8).astype(np.int64) >> INPUT_SHIFT)
    else:
        xq = np.asarray(wire).astype(np.int64)
    h1 = xq[:, ::2, ::2, :].copy()                # half-res (exact target)
    n, hx, hy, _ = h1.shape
    if chroma420:
        det2_drop = (3, 4, 5, 6, 7, 8)
    if det2_drop:
        # each dropped det2 channel: its positions decode as the
        # even-even anchor (diff 0)
        for s in det2_drop:
            c, t = s // 3, s % 3
            di, dj = ((1, 0), (0, 1), (1, 1))[t]
            h1[:, di::2, dj::2, c] = h1[:, 0::2, 0::2, c]
    else:
        # the dropped det2 slot: h1[2*i2+1, 2*j2+1, ch2] for i2%4==3,
        # j2%4==3 decodes as its even-even anchor h1[2*i2, 2*j2, ch2]
        i2 = np.arange(3, hx // 2, 4)
        j2 = np.arange(3, hy // 2, 4)
        if len(i2) and len(j2):
            ii, jj = np.meshgrid(i2, j2, indexing="ij")
            h1[:, 2 * ii + 1, 2 * jj + 1, 2] = h1[:, 2 * ii, 2 * jj, 2]
    if not interp:
        return np.repeat(np.repeat(h1, 2, axis=1), 2, axis=2).astype(np.int8)
    hx1 = np.concatenate([h1[:, 1:], np.zeros_like(h1[:, :1])], axis=1)
    hy1 = np.concatenate([h1[:, :, 1:], np.zeros_like(h1[:, :, :1])],
                         axis=2)
    hxy1 = np.concatenate([hx1[:, :, 1:], np.zeros_like(hx1[:, :, :1])],
                          axis=2)
    out = np.zeros((n, 2 * hx, 2 * hy, 3), np.int64)
    out[:, 0::2, 0::2] = 2 * h1
    out[:, 1::2, 0::2] = h1 + hx1
    out[:, 0::2, 1::2] = h1 + hy1
    out[:, 1::2, 1::2] = h1 + hxy1
    return out.astype(np.int8)


def display(y: np.ndarray, disp_a=DISP_A, disp_b=DISP_B, *,
            edge_compensate: bool = True) -> np.ndarray:
    """Decode-side dequantization to uint8: clip(round(a*y + b)).

    y: (..., X, Y, 3).  With the bilinear output layer the deconv's zero
    pad leaves the last row/column holding one-tap (half-value) sums; the
    display doubles them (deterministic decoder rule, shipped with the
    disp constants) so the border degrades to replication instead of
    half-brightness."""
    yv = np.asarray(y, np.float64)
    if edge_compensate and yv.ndim >= 3:
        yv = yv.copy()
        yv[..., -1, :, :] *= 2.0
        yv[..., :, -1, :] *= 2.0
        yv[..., -1, -1, :] /= 2.0          # corner was doubled twice
    return np.clip(np.round(disp_a * yv + disp_b), 0, 255).astype(np.uint8)


def to_wire(x_u8: np.ndarray) -> np.ndarray:
    """Encode-side preprocessing: uint8 image -> x>>2 wire int8."""
    return (np.asarray(x_u8, np.uint8) >> INPUT_SHIFT).astype(np.int8)


# ---------------------------------------------------------------------------
# YCoCg wire profile: host-side color decorrelation
# ---------------------------------------------------------------------------
# The RGB profile codes three correlated channels; their Haar details carry
# the same structure three times (~3.7-4.5 bits/sym measured).  Standard
# codec practice is a luma/chroma transform at the container boundary —
# pure host pre/post-processing, exactly like the >>2 shift: the integer
# net and its window analysis are untouched because every wire channel
# still lives in [0, 63] (luma step 4, chroma step 8).
#   wire0 = (r/4 + g/2 + b/4) >> 2          Y, step 4
#   wire1 = (r - b + 256) >> 3              Co + offset, step 8
#   wire2 = (g - (r+b)/2 + 256) >> 3        Cg + offset, step 8
# Quantization floors: var(Y)=16/12, var(chroma)=64/12 -> RGB-domain MSE
# floor ~3.6, a 42.7 dB ceiling (vs 46.9 for the RGB profile) — far above
# the operating points; the chroma details compress 2-3x better.

def to_wire_ycocg(x_u8: np.ndarray) -> np.ndarray:
    x = np.asarray(x_u8, np.uint8).astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = r - b
    cg = g - 0.5 * (r + b)
    w0 = np.floor(y).astype(np.int64) >> 2
    w1 = (np.floor(co).astype(np.int64) + 256) >> 3
    w2 = (np.floor(cg).astype(np.int64) + 256) >> 3
    return np.clip(np.stack([w0, w1, w2], axis=-1), 0, 63).astype(np.int8)


def display_ycocg(y_out: np.ndarray, *, out_scale: float = 2.0,
                  edge_compensate: bool = True) -> np.ndarray:
    """Decode-side: net output (wire-domain, at output scale ``out_scale``
    from the bilinear layer) -> uint8 RGB via dequantize + inverse YCoCg."""
    yv = np.asarray(y_out, np.float64)
    if edge_compensate and yv.ndim >= 3:
        yv = yv.copy()
        yv[..., -1, :, :] *= 2.0
        yv[..., :, -1, :] *= 2.0
        yv[..., -1, -1, :] /= 2.0
    yv = yv / out_scale
    lum = 4.0 * yv[..., 0] + 1.5
    co = 8.0 * yv[..., 1] - 256.0 + 3.5
    cg = 8.0 * yv[..., 2] - 256.0 + 3.5
    tmp = lum - 0.5 * cg
    g = lum + 0.5 * cg
    r = tmp + 0.5 * co
    b = tmp - 0.5 * co
    return np.clip(np.round(np.stack([r, g, b], axis=-1)),
                   0, 255).astype(np.uint8)
