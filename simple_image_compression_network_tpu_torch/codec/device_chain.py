"""Device-resident serving chain: analysis -> encode -> decode -> synthesis
with the container words staying in device memory.

The counterpart of the JAX package's ``codec/device_chain.py``.  There each
program is one ``jax.jit`` program with no host in the loop; here, on a
CUDA device, each is captured once as a ``torch.cuda.CUDAGraph`` and
replayed, so a call launches one graph and no Python runs between its
kernels.  The same stage bodies can also run eagerly, so that the host's
cost of launching them can be timed against a replay's.

Three programs, built per (batch, geometry) by :class:`DeviceChain`:

  * ``encode``    : images -> rANS words + counts (device), and the int32
                    checksum ``counts.sum()``.  Kernels A (analysis) and B.
  * ``decode``    : words/counts -> reconstruction (device), and the
                    checksum ``x_hat.sum() + all(ok)``.  Kernels C and A.
  * ``roundtrip`` : images -> ... -> reconstruction in ONE program, with
                    the in-loop exactness flag ``all(ok) & all(z_hat == z)``
                    computed on the device (z_hat == z implies x_hat equals
                    the autoencoder run directly: synthesis is
                    deterministic).

Decode reads the words at a bucketed width ``mxb``, sized once from a real
encode with one bucket of margin, as the JAX class does: a batch whose
longest stream outgrows it fails its checks (ok, ``exact`` false), as it
does in the JAX package.  The kernels take contiguous tensors, so each
decode copies the first ``mxb`` columns into a buffer of the chain's
(inside the graph).

Everything a capture may not do is done once, before it: the lane table is
uploaded, kernel B's u16 layout and kernel C's staged layout are made, the
encoder's and decoder's outputs are allocated, and each program runs once
eagerly (the kernels' first launches raise their shared-memory limits, the
conv wrappers fill their caches).  A capture or launch that fails raises;
the chain never runs eagerly in a graph's place.

On the CPU (``net`` built with ``device="cpu"``) the same bodies run
eagerly on the kernels' plain versions; there is nothing to capture.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..models.codec_int import IntCodecNet
from ..ops import cuda_conv
from . import cuda_rans, device_rans, ilrans, int_codec

PROGRAMS = ("encode", "decode", "roundtrip")


def _counters() -> Dict[str, Callable]:
    """The wrappers of the chain's kernels, whose ``launches`` tick once
    per eager launch (a replay does not tick them)."""
    return {"conv3x3_s1_int8": cuda_conv.conv3x3_s1_int8,
            "rans_encode": cuda_rans.encode_batch_compact,
            "rans_decode": cuda_rans.decode}


class DeviceChain:
    """The int8 codec chain for one (batch, geometry), on ``net.device``.

    Static outputs: ``encode``, ``decode`` and ``roundtrip`` return the
    chain's own tensors, not fresh ones.  The next call of the same program
    writes its results into them in place, and ``encode``'s words and
    counts are also what ``roundtrip`` and a ``decode`` of other words
    overwrite.  Clone what must outlive the next call.  This holds on the
    CPU too.

    ``graph_launches[program]`` counts the kernel launches of each program
    (read around its capture on a CUDA device; empty on the CPU): every
    replay makes them, and no counter ticks at replay."""

    def __init__(self, net: IntCodecNet, static_cdfs: np.ndarray,
                 x_example: torch.Tensor):
        self.net = net
        self.device = dev = net.device
        b, ix, iy, _ = x_example.shape
        if ix % 16 or iy % 16:
            raise ValueError("image sides must be multiples of 16")
        self._x = x_example.to(dev, copy=True)
        zx, zy = ix // 16, iy // 16
        z = net.analysis(self._x)
        c = z.shape[3]
        s, lm = int_codec.plan_streams(zx * zy)
        self.s = s
        self.n_lanes = n = lm * c
        self.t_steps = t = (zx * zy) // lm // s
        self.shape = (b, zx, zy, c)
        self.lane_cdf = int_codec._lane_cdf_tensor(static_cdfs, n, dev)
        cuda = dev.type == "cuda"
        n_str = b * s
        if cuda:
            self._enc_tb = cuda_rans.encode_kernel_table(self.lane_cdf, n, t,
                                                         False)
            self._dec_tb = cuda_rans.kernel_table(self.lane_cdf, n, False)
            mode = self._enc_tb[1]
        else:
            self._enc_tb = self._dec_tb = None
            mode = cuda_rans.ENC_U16       # no scratch on the CPU
        self._enc_out = cuda_rans._encode_outputs(n_str, t, n, mode, dev)
        self._words, self._counts = self._enc_out[:2]
        self._dec_out = cuda_rans._decode_outputs(n_str, t, n, torch.int8,
                                                  dev)

        # Size the decode window from one real encode: bucket the longest
        # stream and keep one bucket of margin for content drift.
        _, _, cnt = self._enc(self._x, z)
        width = self._words.shape[1]
        self.mxb = min(device_rans.bucket_words(int(cnt.max()))
                       + device_rans.WORD_BUCKET, width)
        self._window = (torch.empty((n_str, self.mxb), dtype=torch.int16,
                                    device=dev)
                        if self.mxb < width else None)

        self.graph_launches: Dict[str, Dict[str, int]] = {}
        self._graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._outs: Dict[str, Tuple[torch.Tensor, ...]] = {}
        for name in PROGRAMS:
            body = getattr(self, f"_{name}_body")
            outs = body()                           # eager warm-up
            if cuda:
                torch.cuda.synchronize(dev)
                before = {k: f.launches for k, f in _counters().items()}
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    outs = body()
                self.graph_launches[name] = {
                    k: f.launches - before[k]
                    for k, f in _counters().items()}
                self._graphs[name] = graph
            else:
                outs = tuple(o if o is self._words or o is self._counts
                             else o.clone() for o in outs)
            self._outs[name] = outs

    # -- stage bodies (captured on a CUDA device, eager on the CPU) --------
    def _enc(self, x: torch.Tensor, z: torch.Tensor = None):
        """-> (z, words, counts): analysis (kernel A) and encode (kernel B)
        into the chain's word and count buffers."""
        if z is None:
            z = self.net.analysis(x)
        syms = z.reshape(self._words.shape[0], self.t_steps, self.n_lanes)
        w, cnt = cuda_rans._encode(syms, self.lane_cdf, self._enc_tb,
                                   self._enc_out)
        if w is not self._words:   # the plain version returns its own
            self._words.copy_(w)
            self._counts.copy_(cnt)
        return z, self._words, self._counts

    def _dec(self, w: torch.Tensor, cnt: torch.Tensor):
        """-> (z_hat, x_hat, ok): decode (kernel C) of the first ``mxb``
        columns, then synthesis (kernel A); ok per stream, words consumed
        == count and every final state 2^16."""
        if self._window is not None:
            self._window.copy_(w[:, :self.mxb])
            w = self._window
        syms, consumed, x_fin = cuda_rans._decode(
            w, cuda_rans.split_init(w, self.n_lanes), self.lane_cdf,
            self.t_steps, self._dec_tb, self._dec_out)
        z_hat = syms.reshape(self.shape)
        x_hat = self.net.synthesis(z_hat)
        ok = (consumed == cnt) & (x_fin == ilrans.STATE_LB).all(1)
        return z_hat, x_hat, ok

    def _encode_body(self):
        _, w, cnt = self._enc(self._x)
        return w, cnt, cnt.sum(dtype=torch.int32)

    def _decode_body(self):
        _, x_hat, ok = self._dec(self._words, self._counts)
        return x_hat, (x_hat.to(torch.int32).sum(dtype=torch.int32)
                       + ok.all().to(torch.int32))

    def _roundtrip_body(self):
        z, w, cnt = self._enc(self._x)
        z_hat, x_hat, ok = self._dec(w, cnt)
        return (x_hat.to(torch.int32).sum(dtype=torch.int32),
                ok.all() & (z_hat == z).all())

    def _run(self, name: str) -> Tuple[torch.Tensor, ...]:
        outs = self._outs[name]
        graph = self._graphs.get(name)
        if graph is not None:
            graph.replay()
            return outs
        for dst, src in zip(outs, getattr(self, f"_{name}_body")()):
            if dst is not src:
                dst.copy_(src)
        return outs

    def _set_input(self, dst: torch.Tensor, src: torch.Tensor,
                   what: str) -> None:
        if src is dst:
            return
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{what} must be {tuple(dst.shape)} "
                             f"{dst.dtype}, as the chain was built for; got "
                             f"{tuple(src.shape)} {src.dtype}")
        dst.copy_(src)

    # -- the three programs ------------------------------------------------
    def encode(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, X, Y, 3) of the example's shape and dtype -> (words
        (B*S, 2N + t*N) int16, counts (B*S,) int32, int32 checksum
        ``counts.sum()``), all on the device (static outputs)."""
        self._set_input(self._x, x, "x")
        return self._run("encode")

    def decode(self, w: torch.Tensor, cnt: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """words and counts as ``encode`` returns them -> (x_hat (B, X, Y,
        3) int8, int32 checksum ``x_hat.sum() + all(ok)``) (static
        outputs).  Words other than the chain's own are copied into its
        buffers first."""
        self._set_input(self._words, w, "words")
        self._set_input(self._counts, cnt, "counts")
        return self._run("decode")

    def roundtrip(self, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x -> (int32 checksum ``x_hat.sum()``, bool ``exact``): encode and
        decode in one program, ``exact`` = all(ok) & all(z_hat == z)
        (static outputs)."""
        self._set_input(self._x, x, "x")
        return self._run("roundtrip")

    # -- convenience -------------------------------------------------------
    def check(self, x: torch.Tensor) -> Tuple[bool, bool]:
        """One verified pass: (entropy stage bit-exact in-loop, x_hat of
        ``encode`` then ``decode`` equal to the autoencoder run
        directly)."""
        _, exact = self.roundtrip(x)
        exact = bool(exact)
        w, cnt, _ = self.encode(x)
        x_hat, _ = self.decode(w, cnt)
        direct = self.net(self._x)
        return exact, bool(torch.equal(x_hat, direct))
