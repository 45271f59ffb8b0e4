"""Plain reference of the scale-hyperprior codec (Balle et al. 2018,
arXiv:1802.01436): its float32 forward and its device-format containers,
read back.

The forward is written from the paper's architecture as the trained
checkpoint lays it out: g_a, four 5x5/s2 convs with GDN after the first
three; g_s, four 5x5/s2 transposed convs ("SAME": output exactly 2x) with
IGDN after the first three; h_a, a 3x3/s1 conv of |y| then two 5x5/s2,
ReLU between; h_s, two 5x5/s2 transposed convs and a 3x3/s1 conv, ReLU
between, sigma = exp(clip(., -10, 10)).  GDN: x / sqrt(beta + gamma^T x^2),
beta and gamma reparameterized as max(v, sqrt(min + 2^-18))^2 - 2^-18.
Plain ``F.conv2d`` / ``F.conv_transpose2d`` in float32, TF32 off.  The
checkpoint (flax msgpack) is read by this module's own reader.

The containers: z on 128 lanes' rows of the learned factorized tables
(one row a channel, alphabet [-63, 63] plus an escape), y on the 64
scale-binned Gaussian tables ([-127, 127] plus an escape), the row of each
y symbol its scale bin, #{k: table[k] < sigma} in float32.  Escaped values
come from the container's raw sections, in scan order.  Decoding y needs
each symbol's bin, so this reference takes the bins from the program's own
sigma (its h_s on the z decoded here) and holds that sigma against its own
h_s: a sigma one ulp from a bin edge may land on either side in two sums
of one value, and a stream decoded under one other bin is lost from there
on.  Nothing here imports the program.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import rans_plain

CODEC_HYPERPRIOR_DEV = 3
Z_MAX, Y_MAX = 63, 127
SCALE_MIN, SCALE_MAX, SCALE_BINS = 0.11, 256.0, 64
PEDESTAL = 2.0 ** -18
BLOCK = 4          # images a reference call holds at once


# --- the checkpoint ---------------------------------------------------------
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
         0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
         0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
         0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
         0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}


class _Msgpack:
    """What a flax checkpoint holds: maps, strings, integers, arrays and
    ndarray ext records (type 1: [shape, dtype, raw bytes])."""

    def __init__(self, data: bytes):
        self.d, self.p = memoryview(data), 0

    def _take(self, n: int) -> memoryview:
        out = self.d[self.p:self.p + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated")
        self.p += n
        return out

    def _u(self, fmt: str) -> int:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self._u(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return self._map(b & 0x0F)
        if b & 0xF0 == 0x90:
            return [self.obj() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return bytes(self._take(b & 0x1F)).decode()
        if b in _INTS:
            return self._u(_INTS[b])
        if b in _LENS:
            kind, fmt = _LENS[b]
            n = self._u(fmt)
            if kind == "str":
                return bytes(self._take(n)).decode()
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(self._u(">b"), self._take(n))
        if 0xD4 <= b <= 0xD8:                           # fixext 1..16
            code = self._u(">b")
            return self._ext(code, self._take(1 << (b - 0xD4)))
        raise ValueError(f"msgpack: type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    @staticmethod
    def _ext(code: int, payload: memoryview) -> np.ndarray:
        if code != 1:
            raise ValueError(f"msgpack: ext type {code}")
        shape, dtype, raw = _Msgpack(bytes(payload)).obj()
        return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()


def load_params(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint -> {"g_a.Conv_0.kernel": array, ...}."""
    with open(path, "rb") as f:
        tree = _Msgpack(f.read()).obj()["params"]["params"]
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v
    walk(tree, "")
    return out


def _fp32(tf32: bool = False):
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=tf32)


class Reference:
    """The scale hyperprior's reference on ``device``.  ``tf32=True`` is
    the control: the same forward with TF32 on."""

    def __init__(self, cfg: dict, root: str, device):
        self.device = torch.device(device)
        self.p = load_params(os.path.join(root, cfg["weights"]))
        self.t = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                  .to(self.device) for k, v in self.p.items()}
        self.tf32 = False
        table = np.exp(np.linspace(np.log(SCALE_MIN), np.log(SCALE_MAX),
                                   SCALE_BINS))
        self.bounds = torch.tensor(table, dtype=torch.float32,
                                   device=self.device)
        self.y_cdfs = torch.from_numpy(np.stack(
            [self._gaussian(s) for s in table])).to(self.device)
        self.z_cdfs = torch.from_numpy(self._factorized()).to(self.device)

    # --- layers ---------------------------------------------------------
    def _conv(self, name: str, x: torch.Tensor, stride: int, pad: int):
        w = self.t[name + ".kernel"].permute(3, 2, 0, 1)     # (O, I, kh, kw)
        return F.conv2d(x, w, self.t[name + ".bias"], stride, pad)

    def _deconv(self, name: str, x: torch.Tensor):
        # "SAME" 5x5/s2: the 2x-dilated input padded by (3, 2), correlated
        # with the kernel as stored (not flipped)
        w = self.t[name + ".kernel"].permute(2, 3, 0, 1).flip(2, 3)
        return F.conv_transpose2d(x, w, self.t[name + ".bias"], 2,
                                  1)[..., :-1, :-1]

    def _gdn(self, name: str, x: torch.Tensor, inverse: bool):
        def reparam(v, lo):
            return torch.clamp(v, min=(lo + PEDESTAL) ** 0.5) ** 2 - PEDESTAL
        beta = reparam(self.t[name + ".beta"], 1e-6)
        gamma = reparam(self.t[name + ".gamma"], 0.0)
        c = gamma.shape[0]
        norm = torch.sqrt(F.conv2d(x * x, gamma.t().reshape(c, c, 1, 1),
                                   beta))
        return x * norm if inverse else x / norm

    def g_a(self, x):
        for i in range(3):
            x = self._gdn(f"g_a.GDN_{i}",
                          self._conv(f"g_a.Conv_{i}", x, 2, 2), False)
        return self._conv("g_a.Conv_3", x, 2, 2)

    def h_a(self, y):
        h = F.relu(self._conv("h_a.Conv_0", torch.abs(y), 1, 1))
        h = F.relu(self._conv("h_a.Conv_1", h, 2, 2))
        return self._conv("h_a.Conv_2", h, 2, 2)

    def log_sigma(self, z):
        h = F.relu(self._deconv("h_s.ConvTranspose_0", z))
        h = F.relu(self._deconv("h_s.ConvTranspose_1", h))
        return torch.clamp(self._conv("h_s.Conv_0", h, 1, 1), -10.0, 10.0)

    def g_s(self, y):
        for i in range(3):
            y = self._gdn(f"g_s.GDN_{i}",
                          self._deconv(f"g_s.ConvTranspose_{i}", y), True)
        return self._deconv("g_s.ConvTranspose_3", y)

    def _run(self, fn, *args):
        """fn on NHWC tensors, NCHW inside, in float32 (TF32 for the
        control)."""
        with torch.no_grad(), _fp32(self.tf32):
            torch.backends.cuda.matmul.allow_tf32 = self.tf32
            try:
                ins = [a.to(self.device, torch.float32).permute(0, 3, 1, 2)
                       .contiguous() for a in args]
                return fn(*ins).permute(0, 2, 3, 1).contiguous()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False

    # --- tables ---------------------------------------------------------
    @staticmethod
    def _gaussian(scale: float) -> np.ndarray:
        s = max(float(scale), SCALE_MIN)
        v = np.arange(-Y_MAX, Y_MAX + 1, dtype=np.float64)
        up = np.array([0.5 * (1 + math.erf((a + 0.5) / (s * math.sqrt(2))))
                       for a in v])
        lo = np.array([0.5 * (1 + math.erf((a - 0.5) / (s * math.sqrt(2))))
                       for a in v])
        pmf = up - lo
        return rans_plain.quantize_cdf(np.append(pmf, max(1 - pmf.sum(), 0)))

    def _factorized(self) -> np.ndarray:
        """The learned density of z on [-63, 63] per channel, float32 on
        the host, plus the overflow bucket (Balle 2018, appendix 6.1)."""
        p = {k[len("bottleneck."):]: torch.from_numpy(np.asarray(
            v, np.float32)) for k, v in self.p.items()
            if k.startswith("bottleneck.")}
        n_layers = sum(1 for k in p if k.startswith("H"))
        c = p["H0"].shape[0]
        grid = torch.arange(-Z_MAX, Z_MAX + 1, dtype=torch.float32)
        x = grid[:, None].repeat(1, c).t()[:, None, :]        # (C, 1, n)

        def logits(v):
            for k in range(n_layers):
                v = torch.matmul(F.softplus(p[f"H{k}"]), v) + p[f"b{k}"]
                if k < n_layers - 1:
                    v = v + torch.tanh(p[f"a{k}"]) * torch.tanh(v)
            return v
        lo, hi = logits(x - 0.5), logits(x + 0.5)
        sign = -torch.sign(lo + hi)
        pmf = torch.abs(torch.sigmoid(sign * hi) - torch.sigmoid(sign * lo))
        # (n, C), a column a channel, each summed in float32 for its overflow
        pmf = torch.clamp(pmf[:, 0, :].t().reshape(grid.numel(), c),
                          min=1e-9).numpy()
        rows = []
        for ch in range(c):
            col = pmf[:, ch]
            rows.append(rans_plain.quantize_cdf(
                np.append(col, max(1.0 - col.sum(), 0.0))))
        return np.stack(rows)

    def bins(self, sigma: torch.Tensor) -> torch.Tensor:
        idx = torch.searchsorted(self.bounds,
                                 sigma.to(torch.float32).contiguous())
        return idx.clamp(0, SCALE_BINS - 1)

    # --- the containers -------------------------------------------------
    def parse(self, blobs: Sequence[bytes]):
        metas, hdr0 = [], None
        for blob in blobs:
            cid, sec = rans_plain.unpack_container(blob)
            if cid != CODEC_HYPERPRIOR_DEV or len(sec) != 5:
                raise ValueError("not a device-format hyperprior container")
            hdr = struct.unpack("<HHHHHHHH", sec[0])
            if hdr0 not in (None, hdr):
                raise ValueError("mixed geometries")
            hdr0 = hdr
            metas.append((rans_plain.unpack_streams(sec[1]),
                          rans_plain.unpack_streams(sec[2]),
                          rans_plain.unpack_raw(sec[3]),
                          rans_plain.unpack_raw(sec[4])))
        return hdr0, metas

    @staticmethod
    def _values(syms: torch.Tensor, raws, max_abs: int) -> Tuple:
        """(B, n) symbols -> values, escapes from the raw sections; and
        the count of images whose escapes and raws disagree."""
        vals = syms - max_abs
        esc = syms == 2 * max_abs + 1
        bad = 0
        for i, raw in enumerate(raws):
            n = int(esc[i].sum())
            if n != raw.size:
                bad += 1
            elif n:
                vals[i][esc[i]] = torch.from_numpy(raw).to(vals.device)
        return vals, bad

    def read_z(self, blobs: Sequence[bytes]):
        """-> (z (B, zx, zy, N) float32, header, metas, rejected)."""
        hdr, metas = self.parse(blobs)
        _, _, zx, zy, zc, _, _, _ = hdr
        streams = [s for m in metas for s in m[0]]
        n_lanes = rans_plain.stream_shape(streams[0])[1]
        rows = torch.arange(n_lanes, device=self.device) % zc
        syms, ok = rans_plain.decode(streams, rows, self.z_cdfs)
        z, bad = self._values(syms.reshape(len(blobs), -1),
                              [m[2] for m in metas], Z_MAX)
        return (z.reshape(len(blobs), zx, zy, zc).float(), hdr, metas,
                int((~ok).sum()) + bad)

    def read_y(self, hdr, metas, sigma: torch.Tensor):
        """y's streams under the bins of ``sigma`` (B, yx, yy, M) ->
        (y (B, yx, yy, M) float32, rejected)."""
        _, _, _, _, _, yx, yy, yc = hdr
        streams = [s for m in metas for s in m[1]]
        n_syms, n_lanes = rans_plain.stream_shape(streams[0])
        rows = self.bins(sigma).reshape(len(streams), -1, n_lanes)
        syms, ok = rans_plain.decode(streams, rows, self.y_cdfs)
        y, bad = self._values(syms.reshape(len(metas), -1),
                              [m[3] for m in metas], Y_MAX)
        return (y.reshape(len(metas), yx, yy, yc).float(),
                int((~ok).sum()) + bad)

    # --- the comparisons ------------------------------------------------
    @staticmethod
    def _excess(ref: torch.Tensor, got: torch.Tensor) -> float:
        """How far the program's integers lie beyond rounding of the
        reference's floats: max(|ref - got| - 1/2, 0)."""
        return float((torch.abs(ref - got) - 0.5).clamp(min=0).max())

    def judge(self, blobs: Sequence[bytes], sigma_of, x=None,
              x_hat=None, y_hat=None) -> Dict[str, float]:
        """Read the program's containers: z here, y under the bins of
        ``sigma_of(z)``, the program's h_s on this z.  With the source
        images ``x``: z and y against this forward's.  With the program's
        ``x_hat`` and ``y_hat`` from these containers: y_hat against the y
        read here, x_hat against this g_s of it."""
        out = {"streams_rejected": 0, "log_sigma_gap": 0.0}
        if x is not None:
            out.update(z_gap=0.0, y_gap=0.0)
        if x_hat is not None:
            out.update(y_hat_mismatch=0, x_gap=0.0)
        for i in range(0, len(blobs), BLOCK):
            part = blobs[i:i + BLOCK]
            z, hdr, metas, bad = self.read_z(part)
            sigma = sigma_of(z)
            y, bad_y = self.read_y(hdr, metas, sigma)
            out["streams_rejected"] += bad + bad_y
            ls_ref = self._run(self.log_sigma, z)
            out["log_sigma_gap"] = max(out["log_sigma_gap"], float(
                torch.abs(torch.log(sigma.to(self.device)) - ls_ref).max()))
            if x is not None:
                y_ref = self._run(self.g_a, x[i:i + BLOCK])
                z_ref = self._run(self.h_a, y_ref)
                out["z_gap"] = max(out["z_gap"], self._excess(z_ref, z))
                out["y_gap"] = max(out["y_gap"], self._excess(y_ref, y))
            if x_hat is not None:
                got = y_hat[i:i + BLOCK].to(self.device)
                out["y_hat_mismatch"] += int((got != y).sum())
                ref = self._run(self.g_s, y)
                out["x_gap"] = max(out["x_gap"], float(torch.abs(
                    x_hat[i:i + BLOCK].to(self.device) - ref).max()))
        return out

    def control(self, x: torch.Tensor) -> Dict[str, float]:
        """The control: this forward with TF32 on, in the program's place,
        read by the same comparisons against the float32 forward (its z, y
        against float32's; its h_s and g_s on float32's integers)."""
        out = {"z_gap": 0.0, "y_gap": 0.0, "log_sigma_gap": 0.0,
               "x_gap": 0.0}
        for i in range(0, x.shape[0], BLOCK):
            xb = x[i:i + BLOCK]
            y_ref = self._run(self.g_a, xb)
            z_ref = self._run(self.h_a, y_ref)
            z, y = torch.round(z_ref), torch.round(y_ref)
            ls_ref = self._run(self.log_sigma, z)
            x_ref = self._run(self.g_s, y)
            self.tf32 = True
            try:
                y_c = self._run(self.g_a, xb)
                z_c = torch.round(self._run(self.h_a, y_c))
                out["y_gap"] = max(out["y_gap"],
                                   self._excess(y_ref, torch.round(y_c)))
                out["z_gap"] = max(out["z_gap"], self._excess(z_ref, z_c))
                out["log_sigma_gap"] = max(out["log_sigma_gap"], float(
                    torch.abs(self._run(self.log_sigma, z) - ls_ref).max()))
                out["x_gap"] = max(out["x_gap"], float(torch.abs(
                    self._run(self.g_s, y) - x_ref).max()))
            finally:
                self.tf32 = False
        return out
