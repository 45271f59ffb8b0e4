"""Batched interleaved-rANS encode (kernels B, D) and decode (C, E).

The counterpart of the JAX package's ``codec/pallas_rans.py``:

* ``encode_batch_compact`` -> ``_encode_compact_kernel`` (kernel B; with
  ``ctx`` it hands over to ``encode_batch_compact_ctx``, kernel D, which
  replaces ``_encode_compact_ctx_kernel``);
* ``encode_batch`` -> ``_encode_kernel`` (kernel H, launched by
  ``encode_dense``: the dense per-step words and need flags, which
  ``device_rans.assemble_stream`` compacts after the kernel, as the JAX
  package does; blocks of lanes by streams, each step's division by a
  magic number, ``dense_step``);
* ``decode`` -> ``_decode_kernel`` (kernel C);
* ``decode_ctx`` -> ``_decode_ctx_kernel`` (kernel E);
* ``split_init``.

B and C code with one fixed CDF row per lane; D and E take each symbol's
row from a shared (R, L+1) table by an int32 context per symbol.  On CUDA
tensors the wrappers launch the hand-written kernels of
``csrc/rans_encode.cu`` and ``csrc/rans_decode.cu``; on CPU tensors they
run the plain versions built on ``codec/device_rans.py``.  Each wrapper
counts its kernel launches (``.launches``) and its plain runs
(``.plain_runs``).  The kernels keep their table in shared memory where it
fits (``encode_staged_fits``, ``decode_staged_fits``), in a layout made
once per table tensor (``encode_kernel_table``, ``kernel_table``), and
read it in global memory otherwise.  The private launchers ``_encode``,
``_encode_ctx``, ``_encode_dense``, ``_decode`` and ``_decode_ctx`` take
what they can be given ahead (the table layout, the outputs), so that a
call launches the kernel and nothing else.

u16 stream words travel as int16 tensors holding the bit patterns; u32
states as int32 tensors.  CDF precision is 16 (the codec's only setting).
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .. import _build
from . import device_rans


def _check_lane_cdf(lane_cdf: torch.Tensor, n_lanes: int, device) -> None:
    if (lane_cdf.dim() != 2 or lane_cdf.shape[0] != n_lanes
            or lane_cdf.dtype != torch.int32):
        raise ValueError(f"lane_cdf must be ({n_lanes}, L+1) int32, got "
                         f"{tuple(lane_cdf.shape)} {lane_cdf.dtype}")
    if lane_cdf.device != device:
        raise ValueError("lane_cdf must be on the symbols' device")


def _cuda_ready(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the rANS kernels take contiguous tensors")


def _check_ctx_table(table: torch.Tensor, ctx: torch.Tensor,
                     shape, device) -> None:
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError(f"table must be (R, L+1) int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ctx.dtype != torch.int32 or tuple(ctx.shape) != tuple(shape):
        raise ValueError(f"ctx must be {tuple(shape)} int32, got "
                         f"{tuple(ctx.shape)} {ctx.dtype}")
    if table.device != device or ctx.device != device:
        raise ValueError("table and ctx must be on the symbols' device")


# --- table layouts, shared by the encoders and the decoders ----------------
# A kernel that stages its table copies it into shared memory as it lies in
# the layout below, made once per table tensor (``_layout``).

SMEM_LIMIT = 232448    # bytes of shared memory one block may use on sm_90


def _npad(n_lanes: int) -> int:
    return -(-n_lanes // 32) * 32


def _staged_ints(n_lanes: int, l1: int, n_rows: Optional[int]) -> int:
    """int32 entries of the staged table: kernel C's (L+1, npad), or kernel
    E's ``n_rows`` rows of pitch (L+1) | 1, rounded up to 4 entries."""
    if n_rows is None:
        return l1 * _npad(n_lanes)
    return -(-n_rows * (l1 | 1) // 4) * 4


def stage_lane_table(lane_cdf: torch.Tensor) -> torch.Tensor:
    """(N, L+1) lane table -> kernel C's staged layout, flat: entry j of
    lane k at j * npad + k, lanes past N zero."""
    n, l1 = lane_cdf.shape
    out = lane_cdf.new_zeros((l1, _npad(n)))
    out[:, :n] = lane_cdf.t()
    return out.reshape(-1)


def stage_ctx_table(table: torch.Tensor) -> torch.Tensor:
    """(R, L+1) shared table -> kernel E's staged layout, flat: row r at
    r * pitch, pitch = (L+1) | 1, zero-padded to a multiple of 4."""
    r, l1 = table.shape
    out = table.new_zeros(_staged_ints(0, l1, r))
    out[: r * (l1 | 1)].view(r, l1 | 1)[:, :l1] = table
    return out


def _has_u16_layout(lane_cdf: torch.Tensor) -> bool:
    """Every entry in [0, 2^16] and every last entry 2^16: start and freq
    of every symbol of freq >= 1 are exact as u16 (2^16 stored as 0)."""
    return bool(((lane_cdf >= 0) & (lane_cdf <= 65536)).all()
                & (lane_cdf[:, -1] == 65536).all())


def stage_lane_table_u16(lane_cdf: torch.Tensor) -> Optional[torch.Tensor]:
    """(N, L+1) lane table -> kernel B's u16 layout, flat int16 (the u16
    bit patterns): entry j of lane k at j * npad + k, lanes past N zero,
    2^16 stored as 0.  For a symbol of freq >= 1 its start lies below 2^16
    and is exact, and the kernel's freq, ((end - start - 1) & 0xFFFF) + 1,
    is exact too, wherever else 2^16 appears in the row; a symbol of freq
    0 cannot be coded at all.  None where an entry lies outside [0, 2^16]
    or a last entry is not 2^16."""
    n, l1 = lane_cdf.shape
    if not _has_u16_layout(lane_cdf):
        return None
    out = lane_cdf.new_zeros((l1, _npad(n)))
    out[:, :n] = lane_cdf.t() & 0xFFFF
    return (out - (out >= 32768).to(out.dtype) * 65536).to(
        torch.int16).reshape(-1)


_layouts: Dict[Tuple[int, str], tuple] = {}


def _layout(table: torch.Tensor, kind: str, make) -> Optional[torch.Tensor]:
    """``make(table)``, kept per (table tensor, ``kind``) while that tensor
    lives and is not written to (its version counter); made anew for an
    inference tensor, which has no version counter."""
    key = (id(table), kind)
    try:
        version = table._version
    except RuntimeError:          # an inference tensor: no version counter
        version = None
    hit = _layouts.get(key)
    if (hit is not None and version is not None and hit[0]() is table
            and hit[1] == version):
        return hit[2]
    out = make(table)
    if version is not None:
        _layouts[key] = (weakref.ref(table, lambda _, k=key: _layouts.pop(
            k, None)), version, out)
    return out


# --- encode (kernels B and D) ----------------------------------------------
# Kernel B or D keeps its table (B's as u16, D's in kernel E's row layout), a
# u16 slot for every step's candidate word and a (mask, offset) pair of
# int32 for every (step, warp) in shared memory where they fit one block's
# share; else its global instance reads the table in global memory and
# keeps slots and pairs in a scratch buffer.  The byte counts below are
# those of ``launch`` in csrc/rans_encode.cu.

# the encode kernels' table modes: global (B, D), u16 (B), staged (D)
ENC_GLOBAL, ENC_U16, ENC_STAGED = 0, 1, 2
_SCAN_BYTES = 128                           # one word count per warp
_STAGED_THREADS = 512                       # lanes a staged instance takes


def encode_slot_bytes(n_lanes: int, t_steps: int) -> int:
    """Bytes of one stream's word slots (2 a step and lane) and (mask,
    offset) pairs (8 a step and warp)."""
    npad = _npad(n_lanes)
    return 2 * t_steps * npad + 8 * t_steps * (npad // 32)


def encode_table_bytes(n_lanes: int, l1: int,
                       n_rows: Optional[int] = None) -> int:
    """Bytes of the staged table: kernel B's (L+1, npad) u16 layout, or
    kernel D's ``n_rows`` rows of pitch (L+1) | 1 (kernel E's layout)."""
    if n_rows is None:
        return 2 * l1 * _npad(n_lanes)
    return 4 * _staged_ints(n_lanes, l1, n_rows)


def encode_staged_fits(n_lanes: int, t_steps: int, l1: int,
                       n_rows: Optional[int] = None) -> bool:
    """Whether kernel B (``n_rows`` None) or D (a table of ``n_rows``
    rows) can run its staged instance at this shape: at most 512 lanes,
    and the table, the slots, the pairs and 128 bytes of warp counts must
    fit ``SMEM_LIMIT``.  B at the int8 latent (N = 384, t = 96, L+1 = 130)
    takes 182,912 bytes, B at z (256, 48, 129) 93,824, D at hyper y (384,
    96, R = 64, 257) 148,864; the latent of a 3840x2160 frame (t = 2,025
    at N = 384) has 1.75 MB of slots and pairs and runs the global
    instance."""
    return _npad(n_lanes) <= _STAGED_THREADS and (
        _SCAN_BYTES + encode_table_bytes(n_lanes, l1, n_rows)
        + encode_slot_bytes(n_lanes, t_steps)) <= SMEM_LIMIT


def encode_kernel_table(table: torch.Tensor, n_lanes: int, t_steps: int,
                        ctx_rows: bool) -> Tuple[torch.Tensor, int]:
    """(the table as kernel B or D reads it, its mode) for ``n_lanes``
    lanes of ``t_steps`` steps.  B (``ctx_rows`` False, the (N, L+1) lane
    table): the u16 layout (``ENC_U16``) where it fits and the table allows
    it (``stage_lane_table_u16``); D (the (R, L+1) shared table): kernel
    E's row layout (``ENC_STAGED``) where it fits.  Else the table itself
    (``ENC_GLOBAL``).  Layouts are made once per table tensor."""
    rows, l1 = table.shape
    if ctx_rows:
        if encode_staged_fits(n_lanes, t_steps, l1, rows):
            return _layout(table, "ctx", stage_ctx_table), ENC_STAGED
        return table, ENC_GLOBAL
    if encode_staged_fits(n_lanes, t_steps, l1):
        tb = _layout(table, "lane_u16", stage_lane_table_u16)
        if tb is not None:
            return tb, ENC_U16
    return table, ENC_GLOBAL


def _check_encode_table(tb: Tuple[torch.Tensor, int], table: torch.Tensor,
                        n_lanes: int, t_steps: int, ctx_rows: bool) -> None:
    """``tb`` made ahead must be a layout of a mode that this shape may run,
    of that layout's shape and type, 16-byte aligned on the table's
    device."""
    layout, mode = tb
    rows, l1 = table.shape
    if mode == ENC_GLOBAL:
        ok = layout.shape == table.shape and layout.dtype == torch.int32
    elif mode == ENC_U16 and not ctx_rows:
        ok = (encode_staged_fits(n_lanes, t_steps, l1)
              and tuple(layout.shape) == (l1 * _npad(n_lanes),)
              and layout.dtype == torch.int16)
    elif mode == ENC_STAGED and ctx_rows:
        ok = (encode_staged_fits(n_lanes, t_steps, l1, rows)
              and tuple(layout.shape) == (_staged_ints(n_lanes, l1, rows),)
              and layout.dtype == torch.int32)
    else:
        ok = False
    if (not ok or layout.device != table.device
            or not layout.is_contiguous() or layout.data_ptr() % 16):
        raise ValueError(f"encode table {tuple(layout.shape)} "
                         f"{layout.dtype} in mode {mode} does not fit this "
                         f"table")


def _encode_outputs(s: int, t_steps: int, n: int, mode: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """(words (S, 2N + t*N) int16, counts (S,) int32, and for the global
    instance its scratch of slots and pairs) for ``_encode``/``_encode_ctx``:
    the kernel writes every word, the zero tail too."""
    scratch = (torch.empty((s * encode_slot_bytes(n, t_steps),),
                           dtype=torch.uint8, device=device)
               if mode == ENC_GLOBAL else None)
    return (torch.empty((s, 2 * n + t_steps * n), dtype=torch.int16,
                        device=device),
            torch.empty((s,), dtype=torch.int32, device=device), scratch)


def _check_encode_outputs(out, s: int, t_steps: int, n: int, mode: int,
                          device) -> None:
    words, counts, scratch = out
    if (words.shape != (s, 2 * n + t_steps * n) or words.dtype != torch.int16
            or counts.shape != (s,) or counts.dtype != torch.int32
            or words.device != device or counts.device != device
            or not words.is_contiguous() or words.data_ptr() % 16
            or (mode == ENC_GLOBAL and (
                scratch is None or scratch.device != device
                or scratch.numel() * scratch.element_size()
                < s * encode_slot_bytes(n, t_steps)))):
        raise ValueError("encode outputs do not fit this call")


def encode_batch_compact_plain(syms: torch.Tensor, lane_cdf: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B (``device_rans.encode``)."""
    words, counts = device_rans.encode(syms, lane_cdf)
    return words.to(torch.int16), counts.to(torch.int32)


def encode_batch_compact(syms: torch.Tensor, lane_cdf: torch.Tensor,
                         ctx: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams, state loop and stream compaction on the card.

    syms: (S, t, N) int8 symbols in [0, L) (the int8 latent reshaped);
    lane_cdf: (N, L+1) int32 CDF row per lane.  With ``ctx`` this is
    ``encode_batch_compact_ctx(syms, lane_cdf, ctx)`` (kernel D).
    Returns (words (S, 2N + t*N) int16, counts (S,) int32):
    words[s, :counts[s]] is stream s past its header (flush words, then
    payload), zeros after.  The buffer holds the 1-word-per-symbol worst
    case, so no stream can overflow it."""
    if ctx is not None:
        return encode_batch_compact_ctx(syms, lane_cdf, ctx)
    return _encode(syms, lane_cdf)


def _encode(syms: torch.Tensor, lane_cdf: torch.Tensor,
            tb: Optional[Tuple[torch.Tensor, int]] = None, out=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encode_batch_compact`` without ctx, with ``tb``,
    ``encode_kernel_table(lane_cdf, N, t, False)``, and ``out``,
    ``_encode_outputs(...)``, made ahead (or None to make them here)."""
    if syms.dim() != 3 or syms.dtype != torch.int8:
        raise ValueError("syms must be (S, t, N) int8")
    s, t_steps, n = syms.shape
    _check_lane_cdf(lane_cdf, n, syms.device)
    if syms.device.type == "cpu":
        encode_batch_compact.plain_runs += 1
        return encode_batch_compact_plain(syms, lane_cdf)
    _cuda_ready(syms, lane_cdf)
    if tb is None:
        tb = encode_kernel_table(lane_cdf, n, t_steps, False)
    else:
        _check_encode_table(tb, lane_cdf, n, t_steps, False)
    layout, mode = tb
    if out is None:
        out = _encode_outputs(s, t_steps, n, mode, syms.device)
    else:
        _check_encode_outputs(out, s, t_steps, n, mode, syms.device)
    words, counts, scratch = out
    lib = _build.lib()
    with torch.cuda.device(syms.device):
        err = lib.sicn_rans_encode(
            syms.data_ptr(), layout.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            words.data_ptr(), counts.data_ptr(), s, t_steps, n,
            lane_cdf.shape[1], words.shape[1], mode,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rans encode")
    encode_batch_compact.launches += 1
    return words, counts


encode_batch_compact.launches = 0
encode_batch_compact.plain_runs = 0


def encode_batch_compact_ctx_plain(syms: torch.Tensor, table: torch.Tensor,
                                   ctx: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel D (``device_rans.encode`` with ctx)."""
    words, counts = device_rans.encode(syms, table, ctx)
    return words.to(torch.int16), counts.to(torch.int32)


def encode_batch_compact_ctx(syms: torch.Tensor, table: torch.Tensor,
                             ctx: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: encode S streams whose symbols pick their CDF rows.

    syms: (S, t, N) int32 symbols in [0, L); ctx: (S, t, N) int32 row
    indices in [0, R); table: (R, L+1) int32 shared CDF table.  Returns
    the words/counts layout of ``encode_batch_compact``."""
    return _encode_ctx(syms, table, ctx)


def _encode_ctx(syms: torch.Tensor, table: torch.Tensor, ctx: torch.Tensor,
                tb: Optional[Tuple[torch.Tensor, int]] = None, out=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encode_batch_compact_ctx`` with ``tb``, ``encode_kernel_table(
    table, N, t, True)``, and ``out`` made ahead (or None to make them
    here)."""
    if syms.dim() != 3 or syms.dtype != torch.int32:
        raise ValueError("syms must be (S, t, N) int32")
    s, t_steps, n = syms.shape
    _check_ctx_table(table, ctx, syms.shape, syms.device)
    if syms.device.type == "cpu":
        encode_batch_compact_ctx.plain_runs += 1
        return encode_batch_compact_ctx_plain(syms, table, ctx)
    _cuda_ready(syms, ctx, table)
    r, l1 = table.shape
    if tb is None:
        tb = encode_kernel_table(table, n, t_steps, True)
    else:
        _check_encode_table(tb, table, n, t_steps, True)
    layout, mode = tb
    if out is None:
        out = _encode_outputs(s, t_steps, n, mode, syms.device)
    else:
        _check_encode_outputs(out, s, t_steps, n, mode, syms.device)
    words, counts, scratch = out
    lib = _build.lib()
    with torch.cuda.device(syms.device):
        err = lib.sicn_rans_encode_ctx(
            syms.data_ptr(), ctx.data_ptr(), layout.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            words.data_ptr(), counts.data_ptr(), s, t_steps, n, r, l1,
            l1 if mode == ENC_GLOBAL else (l1 | 1), words.shape[1], mode,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rans encode ctx")
    encode_batch_compact_ctx.launches += 1
    return words, counts


encode_batch_compact_ctx.launches = 0
encode_batch_compact_ctx.plain_runs = 0


# --- dense-flag encode (kernel H) ------------------------------------------
# Kernel H runs blocks of DENSE_LANES lanes by ``streams`` streams
# (``dense_plan``).  Where the table has a u16 layout (start and freq exact
# as u16, ``stage_lane_table_u16``) and a block's slab fits, it copies its
# lane block's slab of the packed layout (``stage_lane_packed``: start,
# 2^16 - freq and freq's magic number in 8 bytes) into shared memory with
# one bulk copy; else it reads the int32 table and the magic layout
# (``stage_lane_magic``) in global memory.  Each step divides by the magic
# number: the functions below are the kernel's integer steps in int64
# PyTorch ops.

DENSE_LANES = 32            # csrc/rans_encode.cu:kDenseLanes, a block's lanes
_DENSE_STATIC_SMEM = 16     # kDenseStaticSmem: the bulk copy's mbarrier
_U32 = 0xFFFFFFFF


def dense_shift(freq: torch.Tensor) -> torch.Tensor:
    """l = ceil(log2 freq) of each int64 divisor in [1, 2^32) (the bit
    length of freq - 1, as the kernel's 32 - clz(freq - 1)); 32 for freq
    = 0, which no symbol that can be coded has."""
    d = freq.to(torch.int64)
    bits = torch.frexp((d - 1).clamp(min=0).to(torch.float64)).exponent
    return torch.where(d == 0, 32, bits.to(torch.int64))


def dense_magic(freq: torch.Tensor) -> torch.Tensor:
    """The magic number of each divisor freq in [1, 2^32) (int64 values
    below 2^32): m = floor(2^32 (2^l - freq) / freq) + 1 with l =
    ``dense_shift(freq)``, Granlund and Montgomery's round-up method, so
    that floor(y / freq) = (hi32(y * m) + y) >> l for every y < 2^32
    (``dense_quotient``).  0 for freq = 0."""
    d = freq.to(torch.int64)
    l = dense_shift(d)
    one = torch.ones_like(d)
    num = ((one << l.clamp(max=32)) - d) << 32
    return torch.where(d == 0, 0, num // torch.where(d == 0, one, d) + 1)


def dense_quotient(y: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> torch.Tensor:
    """floor(y / freq) as kernel H computes it from freq's (m, l): t =
    hi32(y * m), taken in 16-bit halves of y so that every int64 product
    stays below 2^49, then the 33-bit (t + y) >> l.  y, m < 2^32."""
    t = ((y >> 16) * m + (((y & 0xFFFF) * m) >> 16)) >> 16
    return (t + y) >> l


def dense_step(x: torch.Tensor, start: torch.Tensor, freq: torch.Tensor,
               m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """One step of kernel H on int64 u32 values: (word x & 0xFFFF, need,
    the new state).  need = x > thr, thr = freq * 2^16 - 1 (2^32 - 1
    where freq >= 2^16); y = need ? x >> 16 : x; the state y + q * (2^16
    - freq) + start mod 2^32 with q = ``dense_quotient``, which is
    (q << 16) + y % freq + start."""
    thr = torch.where(freq >= 65536, _U32, ((freq << 16) - 1) & _U32)
    need = x > thr
    y = torch.where(need, x >> 16, x)
    q = dense_quotient(y, m, dense_shift(freq))
    return x & 0xFFFF, need, (y + q * (65536 - freq) + start) & _U32


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return (v - (v >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)


def stage_lane_magic(lane_cdf: torch.Tensor) -> torch.Tensor:
    """(N, L+1) lane table -> the global instance's magic layout, flat
    int32 (u32 bit patterns): ``dense_magic`` of symbol j's freq (the
    row's difference mod 2^32) of lane k at j * npad + k, lanes past N
    zero."""
    n, l1 = lane_cdf.shape
    c = lane_cdf.to(torch.int64)
    out = torch.zeros((l1 - 1, _npad(n)), dtype=torch.int64,
                      device=lane_cdf.device)
    out[:, :n] = dense_magic((c[:, 1:] - c[:, :-1]) & _U32).t()
    return _to_int32_bits(out).reshape(-1)


def stage_lane_packed(lane_cdf: torch.Tensor) -> Optional[torch.Tensor]:
    """(N, L+1) lane table -> the staged instance's packed layout, (ceil(N
    / 32), L, 32) int64: lane block c's entries are one contiguous slab (a
    block copies it with one bulk copy), symbol j of lane 32 c + x at [c,
    j, x], lanes past N zero.  An entry holds start in bits 0-15, c = 2^16
    - freq in bits 16-31 and ``dense_magic(freq)`` in bits 32-63, with
    start and freq as the u16 layout gives them (2^16 stored as 0; freq =
    ((end - start - 1) & 0xFFFF) + 1, exact for every symbol of freq >=
    1).  None where the table has no u16 layout
    (``stage_lane_table_u16``)."""
    n, l1 = lane_cdf.shape
    if not _has_u16_layout(lane_cdf):
        return None
    u = lane_cdf.to(torch.int64) & 0xFFFF
    start = u[:, :-1]
    freq = ((u[:, 1:] - start - 1) & 0xFFFF) + 1
    low = start | ((65536 - freq) << 16)
    word = (_to_int32_bits(dense_magic(freq)).to(torch.int64) << 32) | low
    nblk = -(-n // DENSE_LANES)
    out = torch.zeros((nblk * DENSE_LANES, l1 - 1), dtype=torch.int64,
                      device=lane_cdf.device)
    out[:n] = word
    return out.reshape(nblk, DENSE_LANES, l1 - 1).transpose(1, 2).contiguous()


def dense_table_bytes(l1: int) -> int:
    """Shared memory of kernel H's staged instance: a block's slab of the
    packed layout, (L, 32) entries of 8 bytes.  At L+1 = 130: 33,024
    bytes."""
    return 8 * (l1 - 1) * DENSE_LANES


def dense_slab_fits(l1: int) -> bool:
    """Whether a block's slab of rows of L+1 entries fits ``SMEM_LIMIT``
    beside the kernel's 16 bytes of static shared memory."""
    return dense_table_bytes(l1) + _DENSE_STATIC_SMEM <= SMEM_LIMIT


def dense_streams(n_streams: int, n_lanes: int, n_sms: int) -> int:
    """Streams a block of kernel H: the most of 1, 2, 4 and 8 (at most S)
    that still leave a block for every 4 of the card's ``n_sms`` SMs.  A
    block's rows share its staged slab, so fewer blocks copy the table
    fewer times; too few leave the SMs idle.  On one H100 at the int8
    latent (N = 384 in 12 blocks of 32 lanes) 4 streams a block were
    fastest at S = 16 and 8 at S = 256 (``scripts/torch_rans_ab.py``)."""
    nblk = -(-n_lanes // DENSE_LANES)
    best = 1
    for g in (2, 4, 8):
        if g <= n_streams and -(-n_streams // g) * nblk * 4 >= n_sms:
            best = g
    return best


class DensePlan(NamedTuple):
    """Kernel H's launch: ``blocks`` of 32 lanes x ``streams`` threads,
    block g * nblk + c running lanes [32 c, 32 (c + 1)) of streams [g *
    streams, (g + 1) * streams), masked past N and S; ``smem`` bytes of
    shared memory; ``mode`` ENC_STAGED or ENC_GLOBAL."""
    blocks: int
    streams: int
    smem: int
    mode: int


def dense_plan(n_streams: int, n_lanes: int, l1: int, packed: bool,
               n_sms: int) -> DensePlan:
    """Kernel H's grid and instance for S streams of N lanes and rows of
    L+1 entries on a card of ``n_sms`` SMs: the staged instance where the
    table has a packed layout (``packed``) and a block's slab fits
    (``dense_slab_fits``), else the global one; any N and S (a stream's T
    * N below 2^31), the last lane block and stream row masked."""
    streams = dense_streams(n_streams, n_lanes, n_sms)
    staged = packed and dense_slab_fits(l1)
    return DensePlan(-(-n_streams // streams) * -(-n_lanes // DENSE_LANES),
                     streams, dense_table_bytes(l1) if staged else 0,
                     ENC_STAGED if staged else ENC_GLOBAL)


def encode_dense_table(lane_cdf: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """(the table as kernel H reads it, the magic layout or None, the
    mode): the packed layout (``ENC_STAGED``) where the table allows it
    and its slab fits, else the table itself and the magic layout
    (``ENC_GLOBAL``).  Layouts are made once per table tensor."""
    if dense_slab_fits(lane_cdf.shape[1]):
        tb = _layout(lane_cdf, "lane_packed", stage_lane_packed)
        if tb is not None:
            return tb, None, ENC_STAGED
    return lane_cdf, _layout(lane_cdf, "lane_magic", stage_lane_magic), \
        ENC_GLOBAL


def _check_dense_table(tb, lane_cdf: torch.Tensor) -> None:
    """``tb`` made ahead must be layouts of ``lane_cdf``'s shape for its
    mode, 16-byte aligned on the table's device."""
    layout, magic, mode = tb
    n, l1 = lane_cdf.shape
    if mode == ENC_STAGED:
        ok = (dense_slab_fits(l1) and magic is None
              and tuple(layout.shape) == (-(-n // DENSE_LANES), l1 - 1,
                                          DENSE_LANES)
              and layout.dtype == torch.int64)
        arrays = (layout,)
    else:
        ok = (mode == ENC_GLOBAL and layout.shape == lane_cdf.shape
              and layout.dtype == torch.int32 and magic is not None
              and tuple(magic.shape) == ((l1 - 1) * _npad(n),)
              and magic.dtype == torch.int32)
        arrays = (layout, magic) if magic is not None else (layout,)
    if not ok or any(t.device != lane_cdf.device or not t.is_contiguous()
                     or t.data_ptr() % 16 for t in arrays):
        raise ValueError(f"kernel H tables {tuple(layout.shape)} "
                         f"{layout.dtype} in mode {mode} do not fit this "
                         f"table")


def encode_dense_plain(syms: torch.Tensor, lane_cdf: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel H (``device_rans.encode_dense``)."""
    emits, needs, x_fin = device_rans.encode_dense(syms, lane_cdf)
    return emits.to(torch.int32), needs, x_fin.to(torch.int32)


def encode_dense(syms: torch.Tensor, lane_cdf: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel H: the reverse state loop of S streams with dense outputs.

    syms: (S, t, N) int8 or int32 symbols in [0, L), read as they are;
    lane_cdf: (N, L+1) int32 CDF row per lane; any N.  Returns (emits (S,
    t, N) int32, the candidate word x & 0xFFFF of every step; needs (S, t,
    N) bool, whether it is emitted; x_fin (S, N) int32 final states, u32
    bits)."""
    return _encode_dense(syms, lane_cdf)


def _encode_dense(syms: torch.Tensor, lane_cdf: torch.Tensor,
                  tb=None, out=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``encode_dense`` with ``tb``, ``encode_dense_table(lane_cdf)``, and
    ``out``, (emits, needs, x_fin), made ahead (or None to make them
    here)."""
    if syms.dim() != 3 or syms.dtype not in (torch.int8, torch.int32):
        raise ValueError("syms must be (S, t, N) int8 or int32")
    s, t_steps, n = syms.shape
    _check_lane_cdf(lane_cdf, n, syms.device)
    if syms.device.type == "cpu":
        encode_dense.plain_runs += 1
        return encode_dense_plain(syms, lane_cdf)
    _cuda_ready(syms, lane_cdf)
    if t_steps * n >= 2 ** 31:
        raise ValueError(f"kernel H takes t * N below 2^31 a stream, not "
                         f"{t_steps} x {n}")
    if tb is None:
        tb = encode_dense_table(lane_cdf)
    else:
        _check_dense_table(tb, lane_cdf)
    layout, magic, mode = tb
    plan = dense_plan(s, n, lane_cdf.shape[1], mode == ENC_STAGED,
                      _build.sm_count(syms.device.index))
    if out is None:
        out = (torch.empty((s, t_steps, n), dtype=torch.int32,
                           device=syms.device),
               torch.empty((s, t_steps, n), dtype=torch.bool,
                           device=syms.device),
               torch.empty((s, n), dtype=torch.int32, device=syms.device))
    elif (out[0].shape != syms.shape or out[0].dtype != torch.int32
          or out[1].shape != syms.shape or out[1].dtype != torch.bool
          or out[2].shape != (s, n) or out[2].dtype != torch.int32
          or not all(o.is_contiguous() and o.device == syms.device
                     for o in out)):
        raise ValueError("encode_dense outputs do not fit this call")
    emits, needs, x_fin = out
    lib = _build.lib()
    with torch.cuda.device(syms.device):
        err = lib.sicn_rans_encode_dense(
            syms.data_ptr(), layout.data_ptr(),
            None if magic is None else magic.data_ptr(), emits.data_ptr(),
            needs.data_ptr(), x_fin.data_ptr(), s, t_steps, n,
            lane_cdf.shape[1], plan.streams, syms.element_size(), mode,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rans encode dense")
    encode_dense.launches += 1
    return out


encode_dense.launches = 0
encode_dense.plain_runs = 0


def encode_batch(syms: torch.Tensor, lane_cdf: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams through kernel H, then compact its dense outputs
    with ``device_rans.assemble_stream`` (PyTorch ops on the same device).

    Returns (words (S, 2N + t*N) int64 holding u16 values, counts (S,)
    int64), bit-identical with ``device_rans.encode`` and, over each
    stream's count, with ``encode_batch_compact``."""
    emits, needs, x_fin = encode_dense(syms, lane_cdf)
    return device_rans.assemble_stream(
        emits.to(torch.int64), needs,
        x_fin.to(torch.int64) & 0xFFFFFFFF)


def split_init(words: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """(S, cap) words -> (S, N) int32 initial states (u32 bits) from the
    (hi, lo) flush prefix."""
    init = words[:, : 2 * n_lanes].to(torch.int64) & 0xFFFF
    return ((init[:, 0::2] << 16) | init[:, 1::2]).to(torch.int32)


# --- decode (kernels C and E) ---------------------------------------------
# Kernel C or E copies its table into shared memory when the table, in the
# staged layout, and the stream ring fit one block's share; else its second
# instance searches the table in global memory.  The byte counts below are
# those of ``launch`` in csrc/rans_decode.cu.

_TOTALS_BYTES = 256    # two buffers of 32 warp counts


def _ring_words(npad: int) -> int:
    """Words of the stream ring: a power of two >= 3 chunks of npad."""
    r = 32
    while r < 3 * npad:
        r <<= 1
    return r


def decode_staged_fits(n_lanes: int, l1: int,
                       n_rows: Optional[int] = None) -> bool:
    """Whether kernel C (``n_rows`` None) or E (a table of ``n_rows`` rows)
    stages its table in shared memory at this shape: 4 bytes per staged
    entry, 2 per word of the ring, and 256 for the warp counts must fit
    ``SMEM_LIMIT``.  C's int8 latent (N = 384, L+1 = 130) takes 204,032
    bytes, z (256, 129) 134,400, E's hyper y (384, R = 64, 257) 70,144;
    N = 1024 lanes of 130 entries would take 540,928 and run in global
    memory."""
    return (4 * _staged_ints(n_lanes, l1, n_rows)
            + 2 * _ring_words(_npad(n_lanes)) + _TOTALS_BYTES) <= SMEM_LIMIT


def kernel_table(table: torch.Tensor, n_lanes: int,
                 ctx_rows: bool) -> torch.Tensor:
    """The table as kernel C (``ctx_rows`` False: the (N, L+1) lane table)
    or E (the (R, L+1) shared table) reads it for ``n_lanes`` lanes: where
    the staged instance runs, its staged layout, made once per table
    tensor and kept while that tensor lives and is not written to; else
    the table itself."""
    rows, l1 = table.shape
    if not decode_staged_fits(n_lanes, l1, rows if ctx_rows else None):
        return table
    if ctx_rows:
        return _layout(table, "ctx", stage_ctx_table)
    return _layout(table, "lane", stage_lane_table)


def decode_plain(words: torch.Tensor, x0: torch.Tensor,
                 lane_cdf: torch.Tensor, t_steps: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel C (``device_rans.decode``)."""
    syms, consumed, x_fin = device_rans.decode(words, x0, lane_cdf, t_steps)
    return (syms.to(torch.int8), consumed.to(torch.int32),
            x_fin.to(torch.int32))


def _check_decode_io(words: torch.Tensor, x0: torch.Tensor) -> None:
    if words.dim() != 2 or words.dtype != torch.int16:
        raise ValueError("words must be (S, cap) int16")
    if x0.dim() != 2 or x0.dtype != torch.int32 or x0.shape[0] != \
            words.shape[0]:
        raise ValueError("x0 must be (S, N) int32")
    if x0.device != words.device:
        raise ValueError("words and x0 must be on one device")


def _decode_outputs(s: int, t_steps: int, n: int, sym_dtype, device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.empty((s, t_steps, n), dtype=sym_dtype, device=device),
            torch.empty((s,), dtype=torch.int32, device=device),
            torch.empty((s, n), dtype=torch.int32, device=device))


def _check_kernel_table(tb: torch.Tensor, table: torch.Tensor,
                        n_lanes: int, ctx_rows: bool) -> None:
    """``tb`` made ahead must have the shape of ``kernel_table(table,
    n_lanes, ctx_rows)`` and lie 16-byte aligned on the table's device."""
    rows, l1 = table.shape
    n_rows = rows if ctx_rows else None
    want = ((_staged_ints(n_lanes, l1, n_rows),)
            if decode_staged_fits(n_lanes, l1, n_rows) else table.shape)
    if (tuple(tb.shape) != tuple(want) or tb.dtype != torch.int32
            or tb.device != table.device or not tb.is_contiguous()
            or tb.data_ptr() % 16):
        raise ValueError(f"kernel table {tuple(tb.shape)} {tb.dtype} does "
                         f"not fit this table")


def decode(words: torch.Tensor, x0: torch.Tensor, lane_cdf: torch.Tensor,
           t_steps: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode S streams.

    words: (S, cap) int16 u16 stream words past the header (the 2N flush
    words first; zero padding after the stream is ignored);
    x0: (S, N) int32 initial states (``split_init``);
    lane_cdf: (N, L+1) int32, rows non-decreasing.
    Returns (syms (S, t, N) int8, consumed (S,) int32, x_fin (S, N) int32).
    The caller checks validity: consumed == word count, x_fin == 2^16."""
    return _decode(words, x0, lane_cdf, t_steps)


def _decode(words: torch.Tensor, x0: torch.Tensor, lane_cdf: torch.Tensor,
            t_steps: int, tb: Optional[torch.Tensor] = None, out=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode`` with ``tb``, ``kernel_table(lane_cdf, N, False)``, and
    ``out``, the outputs, made ahead (or None to make them here)."""
    _check_decode_io(words, x0)
    s, cap = words.shape
    n = x0.shape[1]
    _check_lane_cdf(lane_cdf, n, words.device)
    if words.device.type == "cpu":
        decode.plain_runs += 1
        return decode_plain(words, x0, lane_cdf, t_steps)
    _cuda_ready(words, x0, lane_cdf)
    l1 = lane_cdf.shape[1]
    if tb is None:
        tb = kernel_table(lane_cdf, n, False)
    else:
        _check_kernel_table(tb, lane_cdf, n, False)
    if out is None:
        out = _decode_outputs(s, t_steps, n, torch.int8, words.device)
    syms, consumed, x_fin = out
    lib = _build.lib()
    with torch.cuda.device(words.device):
        err = lib.sicn_rans_decode(
            words.data_ptr(), x0.data_ptr(), tb.data_ptr(), syms.data_ptr(),
            consumed.data_ptr(), x_fin.data_ptr(), s, cap, t_steps, n, l1,
            int(decode_staged_fits(n, l1)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rans decode")
    decode.launches += 1
    return out


decode.launches = 0
decode.plain_runs = 0


def decode_ctx_plain(words: torch.Tensor, x0: torch.Tensor,
                     table: torch.Tensor, ctx: torch.Tensor, t_steps: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel E (``device_rans.decode`` with ctx)."""
    syms, consumed, x_fin = device_rans.decode(words, x0, table, t_steps,
                                               ctx)
    return (syms.to(torch.int32), consumed.to(torch.int32),
            x_fin.to(torch.int32))


def decode_ctx(words: torch.Tensor, x0: torch.Tensor, table: torch.Tensor,
               ctx: torch.Tensor, t_steps: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel E: decode S streams whose symbols pick their CDF rows.

    words, x0 as in ``decode``; table: (R, L+1) int32 shared CDF table,
    rows non-decreasing; ctx: (S, t, N) int32 row indices.
    Returns (syms (S, t, N) int32, consumed (S,) int32, x_fin (S, N)
    int32); the caller checks consumed and x_fin as for ``decode``."""
    return _decode_ctx(words, x0, table, ctx, t_steps)


def _decode_ctx(words: torch.Tensor, x0: torch.Tensor, table: torch.Tensor,
                ctx: torch.Tensor, t_steps: int,
                tb: Optional[torch.Tensor] = None, out=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_ctx`` with ``tb``, ``kernel_table(table, N, True)``, and
    ``out`` made ahead (or None to make them here)."""
    _check_decode_io(words, x0)
    s, cap = words.shape
    n = x0.shape[1]
    _check_ctx_table(table, ctx, (s, t_steps, n), words.device)
    if words.device.type == "cpu":
        decode_ctx.plain_runs += 1
        return decode_ctx_plain(words, x0, table, ctx, t_steps)
    _cuda_ready(words, x0, ctx, table)
    r, l1 = table.shape
    staged = decode_staged_fits(n, l1, r)
    if tb is None:
        tb = kernel_table(table, n, True)
    else:
        _check_kernel_table(tb, table, n, True)
    if out is None:
        out = _decode_outputs(s, t_steps, n, torch.int32, words.device)
    syms, consumed, x_fin = out
    lib = _build.lib()
    with torch.cuda.device(words.device):
        err = lib.sicn_rans_decode_ctx(
            words.data_ptr(), x0.data_ptr(), ctx.data_ptr(), tb.data_ptr(),
            syms.data_ptr(), consumed.data_ptr(), x_fin.data_ptr(), s, cap,
            t_steps, n, r, l1, (l1 | 1) if staged else l1, int(staged),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rans decode ctx")
    decode_ctx.launches += 1
    return out


decode_ctx.launches = 0
decode_ctx.plain_runs = 0
