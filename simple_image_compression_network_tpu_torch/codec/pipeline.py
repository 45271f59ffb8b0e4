"""Pipelined batch codecs: overlap the card's work with the host's.

The counterpart of the JAX package's ``codec/pipeline.py``.  ``submit``
enqueues a batch's device work (transform and entropy kernels) and the
asynchronous copy of what the host needs, then returns without waiting on
the device; the wait and the byte assembly happen up to ``depth`` batches
later, in ``collect`` or ``drain``.  So batch k's packing runs on the host
while batch k+1's kernels run on the card: steady-state throughput is about
max(device stage, host stage) instead of their sum.

Everything is enqueued on the current CUDA stream, as every kernel wrapper
launches there; each batch's copies go through pinned host buffers of its
own, held until that batch is drained, and each drain waits on its batch's
event alone.  Results are byte-identical to ``int_codec.compress_batch`` /
``decompress_batch`` and to ``HyperCodec``'s batch calls.
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.codec_int import IntCodecNet
from ..utils import profiling
from . import int_codec


class _Pipeline:
    """Depth-bounded queue of scheduled batches: ``submit`` schedules one
    and drains the oldest beyond ``depth``; ``collect`` returns the oldest
    finished batch, draining one if none is finished; ``drain`` finishes
    all.  Subclasses give ``_schedule`` and ``_finish``.  A batch's
    schedule and finish are the spans ``pipeline.schedule`` and
    ``pipeline.finish`` (``utils/profiling.py``); the queue is first in,
    first out, so the n-th finish is the n-th schedule's batch."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("depth must be at least 1")
        self.depth = depth
        self._q: Deque[Tuple] = collections.deque()
        self._out: Deque = collections.deque()

    def submit(self, batch) -> None:
        """Enqueue one batch; waits only on batches beyond ``depth``."""
        with profiling.span("pipeline.schedule"):
            self._q.append(self._schedule(batch))
        while len(self._q) > self.depth:
            self._drain_one()

    def _drain_one(self) -> None:
        with profiling.span("pipeline.finish"):
            self._out.append(self._finish(self._q.popleft()))

    def collect(self):
        """The oldest finished batch's result (None if nothing is queued)."""
        if not self._out and self._q:
            self._drain_one()
        return self._out.popleft() if self._out else None

    def drain(self) -> list:
        """Every queued batch's result, oldest first."""
        while self._q:
            self._drain_one()
        out = list(self._out)
        self._out.clear()
        return out


class PipelinedEncoder(_Pipeline):
    """Depth-bounded image -> container pipeline of the int8 codec (static
    CDFs, device coder) over ``int_codec``'s schedule and drain phases.

    ``submit`` enqueues the analysis (kernel A) and the encode (kernel B),
    then ONE copy to pinned host memory of the counts and the words, cut
    at the width the previous batch needed (``_mxb``; the whole width at
    first), with an event after it.  The drain waits on that event, fetches
    the words again, blocking, when a count outgrew the prediction, and
    packs."""

    def __init__(self, net: IntCodecNet, static_cdfs: np.ndarray, *,
                 depth: int = 2):
        super().__init__(depth)
        self.net = net
        self.static_cdfs = static_cdfs
        self._mxb: Optional[int] = None   # learned bucketed payload width

    def _schedule(self, x: torch.Tensor) -> Tuple:
        return int_codec._compress_schedule(self.net, x, self.static_cdfs,
                                            self._mxb)

    def _finish(self, state: Tuple) -> List[bytes]:
        out, self._mxb = int_codec._compress_drain(state)
        return out


class PipelinedDecoder(_Pipeline):
    """Depth-bounded container -> reconstruction pipeline of the int8 codec
    over ``int_codec``'s schedule and drain phases.

    ``submit`` parses the containers on the host, uploads words and counts
    in one pinned copy without waiting, and enqueues the decode (kernel C),
    the synthesis (kernel A) and the validity flags' copy back, with an
    event after it.  The drain checks the flags and raises ValueError for a
    corrupt stream.  Results are the reconstructions (B, X, Y, 3) int8 on
    the device, as ``decompress_batch``'s first output."""

    def __init__(self, net: IntCodecNet, static_cdfs: np.ndarray, *,
                 depth: int = 2):
        super().__init__(depth)
        self.net = net
        self.static_cdfs = static_cdfs

    def _schedule(self, streams: Sequence[bytes]) -> Tuple:
        return int_codec._decompress_schedule(
            self.net, int_codec._parse(streams), self.static_cdfs)

    def _finish(self, state: Tuple) -> torch.Tensor:
        return int_codec._decompress_drain(state)[0]


class HyperPipelinedEncoder(_Pipeline):
    """Depth-bounded pipeline over ``HyperCodec``'s schedule and drain
    phases: image batches -> device-format hyper containers."""

    def __init__(self, codec, *, depth: int = 2):
        super().__init__(depth)
        self.codec = codec

    def _schedule(self, x: torch.Tensor) -> Tuple:
        return self.codec._compress_schedule(x)

    def _finish(self, state: Tuple) -> List[bytes]:
        return self.codec._compress_drain(state)


class HyperPipelinedDecoder(_Pipeline):
    """Depth-bounded pipeline: hyper containers -> (x_hat, y_hat)."""

    def __init__(self, codec, *, depth: int = 2):
        super().__init__(depth)
        self.codec = codec

    def _schedule(self, blobs: Sequence[bytes]) -> Tuple:
        return self.codec._decompress_schedule(blobs)

    def _finish(self, state: Tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.codec._decompress_drain(state)[:2]
