"""Capability-parity NN ops beyond the 8-layer model's conv/deconv.

The PyTorch counterpart of the JAX package's ``ops/nn.py``: the reference
library (FINN hlslib) ships more kernels than the codec uses, and each has
an equivalent here with the same contract:

* pooling family            (``maxpool.h:66-577``, ``pool.hpp:59-226``)
* depthwise conv / VVAU     (``vvau.hpp:85-154``)
* fully-connected layer     (``fclayer.h:94-111``)
* threshold activations     (``activations.hpp:143-190``)
* channel-wise affine ops   (``activations.hpp:208-224``)
* top-K label select        (``maxpool.h:449-501``)
* stream utils: residual add, duplicate, cast
                            (``streamtools.h:617-762``)

Integer ops keep the library's exact semantics: the accumulator wraps to the
8-bit activation type via ``wrap_to_int8`` where the reference accumulates in
the output type.  Each op gives the same integers on a CUDA tensor as on a
CPU tensor, around the card's gaps: CUDA has no integer matmul, so the
products run in float64 (exact: every partial sum is an integer far below
2^53); ``max_pool2d`` takes no int8 there, so windows are unfolded and
reduced with ``amax``; and ``torch.topk`` promises no order among equal
scores, so ``label_select`` sorts stably.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .conv_int import bias_relu_epilogue, conv_acc_hwio, wrap_to_int8


def _windows(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """(N, X, Y, C) -> (N, X', Y', C, k, k): the k x k windows at stride s,
    VALID (a partial window at the edge is dropped)."""
    return x.unfold(1, k, s).unfold(2, k, s)


# ---------------------------------------------------------------------------
# Pooling (maxpool.h, pool.hpp)
# ---------------------------------------------------------------------------

def maxpool2d(x: torch.Tensor, k: int, stride: Optional[int] = None
              ) -> torch.Tensor:
    """Precision maxpool (StreamingMaxPool_Precision_Batch, maxpool.h:140-219).

    x: (N, X, Y, C); window k x k, stride defaults to k (the reference pools
    non-overlapping windows)."""
    return _windows(x, k, stride or k).amax(dim=(-2, -1))


def maxpool1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """1-D precision maxpool (StreamingMaxPool_Precision_Batch_1d,
    maxpool.h:242-314).  x: (N, L, C)."""
    return x.unfold(1, k, k).amax(dim=-1)


def binary_maxpool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Binary OR-maxpool (StreamingMaxPool_Batch, maxpool.h:66-118): the
    window reduction is a logical OR over 1-bit activations."""
    return maxpool2d((x != 0).to(torch.uint8), k).to(x.dtype)


def avgpool2d_quant(x: torch.Tensor, k: int, *, shift: int = 0
                    ) -> torch.Tensor:
    """Quantized average pool (QuantAvgPoolFunction, pool.hpp:190-226):
    int32 sum over the window, then an arithmetic right shift."""
    s = _windows(x.to(torch.int32), k, k).sum(dim=(-2, -1),
                                              dtype=torch.int32)
    return s >> shift


def accpool(x: torch.Tensor) -> torch.Tensor:
    """Accumulate-pool (AccPool_Batch, maxpool.h:388-423): per-channel sum
    over all spatial positions.  x: (N, X, Y, C) -> (N, C) int32."""
    return x.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)


def relu_batch(x: torch.Tensor) -> torch.Tensor:
    """Standalone ReLU layer (ReLU_Batch, maxpool.h:337-366)."""
    return torch.clamp_min(x, 0)


def label_select(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-K label select (LabelSelect_Batch, maxpool.h:449-501): x (N, C)
    scores -> (N, K) int32 indices of the K largest, descending; among
    equal scores the lower index first, as ``lax.top_k``."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices
    return idx[..., :k].to(torch.int32)


# ---------------------------------------------------------------------------
# Depthwise conv / VVAU (vvau.hpp)
# ---------------------------------------------------------------------------

def depthwise_conv2d_int8(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, *, stride: int = 1,
                          padding: int = 0) -> torch.Tensor:
    """Vector_Vector_Activate_Batch (vvau.hpp:85-154): each channel
    convolved with its own k x k filter, exact accumulator, wrap/bias/ReLU
    epilogue (the MVAU path's integer contract).

    x: (N, X, Y, C) int8; w: (C, k, k) int8; bias: (C,) int8."""
    c, k, _ = w.shape
    wk = w.to(device=x.device, dtype=torch.int8).permute(1, 2, 0)
    p = padding
    return bias_relu_epilogue(
        conv_acc_hwio(x, wk.reshape(k, k, 1, c), stride=stride,
                      pads=(p, p, p, p), groups=c), bias)


# ---------------------------------------------------------------------------
# Fully-connected layer (fclayer.h)
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, K) @ b (O, K).T as int64, exact: float64 products of integers
    whose every partial sum stays far below 2^53."""
    return (a.to(torch.float64) @ b.to(device=a.device, dtype=torch.float64).T
            ).round().to(torch.int64)


def fc_int8(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            relu: bool = True) -> torch.Tensor:
    """StreamingFCLayer_Batch (fclayer.h:94-111): W @ x with the MVAU's
    integer semantics.  x: (N, K) int8; w: (O, K) int8."""
    acc = _dot(x.to(torch.int8), w.to(torch.int8))
    if bias is None:
        return wrap_to_int8(acc)
    out = wrap_to_int8(acc + bias.to(device=acc.device, dtype=torch.int64))
    return torch.clamp_min(out, 0) if relu else out


# ---------------------------------------------------------------------------
# Threshold activations (activations.hpp)
# ---------------------------------------------------------------------------

def threshold_activation(x: torch.Tensor, thresholds: torch.Tensor
                         ) -> torch.Tensor:
    """Multi-threshold quantized activation (ThresholdsActivation,
    activations.hpp:168-190 / Thresholding_Batch :246-284): the number of
    thresholds the accumulator meets or exceeds.

    x: (..., C) int; thresholds: (C, T) int (per channel, ascending).
    Returns uint8 counts in [0, T]."""
    th = thresholds.to(x.device)
    return (x[..., None] >= th).sum(dim=-1).to(torch.uint8)


def channelwise_op(x: torch.Tensor, params: torch.Tensor, op: str = "add"
                   ) -> torch.Tensor:
    """Per-channel affine op (ChannelWiseOperation,
    activations.hpp:208-224)."""
    a = x.to(torch.int32)
    p = params.to(device=x.device, dtype=torch.int32)
    if op == "add":
        return wrap_to_int8(a + p)
    if op == "mul":
        return wrap_to_int8(a * p)
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Binary / XNOR algebra (interpret.hpp:57-108): BNN capability parity
# ---------------------------------------------------------------------------

def xnor_popcount_fc(x_bits: torch.Tensor, w_bits: torch.Tensor
                     ) -> torch.Tensor:
    """Binary GEMV via XNOR-popcount (XnorMul, interpret.hpp:57-79).

    Bits encode {-1,+1} as {0,1}; the MAC counts agreements:
    out = sum XNOR(x, w) = K - popcount(x ^ w).  x: (N, K) {0,1};
    w: (O, K) {0,1} -> (N, O) int32 agreement counts."""
    k = x_bits.shape[-1]
    return ((binary_fc(x_bits, w_bits) + k) // 2).to(torch.int32)


def binary_fc(x_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """±1 binary matmul (Binary recast, interpret.hpp:81-108): the signed
    dot product in int32."""
    xs = x_bits.to(torch.int32) * 2 - 1
    ws = w_bits.to(torch.int32) * 2 - 1
    return _dot(xs, ws).to(torch.int32)


# ---------------------------------------------------------------------------
# Stream utilities (streamtools.h)
# ---------------------------------------------------------------------------

def add_streams(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """AddStreams_Batch (streamtools.h:675-724): elementwise add of two
    activations with the output type's wrap, the residual primitive."""
    return wrap_to_int8(a.to(torch.int32) + b.to(torch.int32))


def duplicate_streams(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DuplicateStreams_Batch (streamtools.h:617-651): fan-out for bypass
    paths; both outputs are the same tensor."""
    return x, x


def streaming_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """StreamingCast (streamtools.h:232-237)."""
    return x.to(dtype)
