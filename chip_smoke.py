#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--batch B]

Builds the port's CUDA kernels from ``simple_image_compression_network_tpu_torch/
csrc`` (one nvcc call), prints each conv kernel's registers, shared memory
and spills (ptxas) and its tensor-core and __dp4a instruction counts (SASS,
cuobjdump), holds each kernel bit-exactly against its plain PyTorch version
(kernel F and kernel A's forms at the eight layers' shapes, the halo modes,
and edge shapes off the tiles and the MMA granules; the rANS kernels at the
paths' shapes and at their edges, the decoders whole and truncated, each
encoder and decoder on each of its instances; kernel H on int8 and int32
symbols at the latent's shape, a ragged N, N = 1,100, blocks of several
stream rows and its global instance, each on outputs filled with a
pattern), then drives the port's paths at full width on B random-seeded
768x512 images:

* the int8 codec's ``compress_batch`` then ``decompress_batch`` with the
  reference weights and the static latent CDFs, checked against the direct
  golden transform (plain float64 convolutions, independent of kernel A);
* the int8 transform ``eight_layers_net`` under the JAX package's Pallas
  plans (``pallas3`` on kernel F, ``pallas`` and ``pallas2`` on kernel A),
  its other mappings (``s4d_phased``: s4d on A, a launch of F a phase;
  ``gemm_tapn``: one-tap products on F; ``laxf32``: one float32 cuDNN conv
  at L0, the goldens after it), with ``phased=False``, and tiled under
  ``pallas3``, each equal to the golden;
* the native C++ golden (g++) at the L0 and L7 shapes, equal to the
  float64 golden and to the layers on kernels A and F; the TMR conv at the
  L1 shape (no fault, one replica flipped, three replicas distinct: flags
  0, 1, 2, the vote equal to the plain layer); every ``ops/nn`` function on
  CUDA tensors equal to the CPU's; ``utils/dump`` raising inside a CUDA
  graph capture;
* the dense-flag encoder ``encode_batch`` (kernel H) on the int8 latent,
  equal to the compact encoder's words;
* the scale-hyperprior codec's ``compress_batch`` then ``decompress_batch``
  with the trained ``checkpoints/hp_scale_l0.01.params.msgpack`` (N = 128,
  M = 192), checked for y_hat and z_hat equal to the encoder's integers;
* ``DeviceChain``: the int8 chain's encode, decode and roundtrip captured
  as CUDA graphs and replayed, checked for ``exact``, ``check()`` and
  x_hat against the golden, with the launches made at capture, and each
  program timed eagerly and replayed;
* the four pipelines over 4 batches of B images at depth 2, equal to the
  sync calls, timed against them, each ``submit`` shown to wait on no
  queued device work;
* the wavelet codec ``WaveletCodec`` under its four profiles (Haar
  weights, shipped tables ``checkpoints/haar*_cdfs.npz``): compress_batch
  then decompress_batch, checked against the golden transform of the numpy
  wire map, the device maps against the numpy maps, kernels B and C
  against their plain versions on each profile's real latent, the
  containers against the native host coder's, with no lane table
  uploaded again once the four have run;
* the host coders: containers with per-image tables on the native coder
  (decoded to the golden), the native coder with the static CDFs (the
  main path's containers byte for byte), and the serial hyperprior format
  on one image (y_hat equal to the device format's);
* the mean-scale codec ``MeanScaleCodec`` with the trained
  ``checkpoints/hp_meanscale_l0.01.params.msgpack``: compress_batch then
  decompress_batch (y_hat equal to round(y - mu) + mu, kernels B to E on
  its real latents against their plain versions, the serial format's
  symbols against the device format's off the ties of y - mu) and both
  hyper pipelines over it;
* the bf16 serving path of both hyperpriors from the same checkpoints,
  each round exact, timed and rated beside float32;
* ``eval_codec.main`` with the argument lists of ``docs/RESULTS.md``'s
  synthetic rows: the int8 and the four wavelet codecs' bpp and PSNR equal
  to the JAX package's digits (``JAX_EVAL``), the float codecs' reported
  beside their rows;
* float RD training (``train.py``, ``train_loop.py``) at TrainConfig's
  defaults (N = 128, M = 192, crop 256, B = 8): one clip+Adam step on the
  card from the trained scale checkpoint against the same step on the
  CPU (loss, every gradient leaf, every parameter's change, within
  stated tolerances); ``train_loop.main`` for the three models from
  init (the scale model 40 steps in blocks of 20 with checkpoints, then
  resumed to 60; the others 10), every loss finite, ``restore`` equal to
  the saved parameters; each model's block of 20 steps with no host sync
  inside it (sync debug mode "error"), its steps/s, ms a step and peak
  memory, and the scale model's step by stage; ``eval_codec --ckpt`` on
  the training checkpoint, whose parameters then drive ``hyper_path``
  (kernels B, D, C, E); ``train_loop --dp 2`` over two gloo ranks on the
  card, their parameters bitwise equal;
* wrap-STE training of the integer net (``intnet.py``,
  ``train_intnet.py``) at crop 256: per layer at B = 8 the float
  accumulator exact and equal to the float64 golden accumulator, and
  kernel A equal to relu(wrap(round(acc_f))); one wrap and one clip step
  on the card against the CPU (x_hat bitwise; the loss, the net's
  gradients and the step within the float trainer's tolerances, the
  entropy model's gradients against float64); a block of each mode timed
  with kernel A's launches gated (8 a wrap step); ``train_intnet.main``
  from init and from haar422 with its structure frozen, launches gated;
  the exported weights and CDFs through ``int_codec`` (kernels A, B, C)
  equal to the float64 golden; ``train_loop --sp 2`` (two ranks, halos
  carrying gradients back) against one process; the reference header
  packed from ``reference_weights.npz`` and read back by
  ``weights_io.load_reference_params``;
* the spatially sharded int8 codec (``parallel/``) on 1, 2 and 4 ranks,
  processes started by ``spawn_ranks`` that share the card over gloo:
  ``ShardedIntCodec`` with the main path's images, weights and tables,
  each rank's launches gated (kernel A a layer, B once an encode, C once a
  decode, no plain run) with the sharded route, the main path's containers
  byte for byte, x_hat and z gathered from the tiles equal to the golden,
  a corrupt container raised on every rank; on 4 ranks
  ``eight_layers_net_sharded`` on a (2, 2) mesh under the default plan (A)
  and pallas3 (F), equal to the golden.  The halo bytes staged through the
  host and each rank count's encode and decode ms are printed, labelled as
  ranks time-sliced on one card;
* in the same ranks, the spatially sharded hyperprior codecs
  (``ShardedHyperCodec``), both trained models on B 1024x1024 images
  (both stream plans tile there; at 768x512 the z plan has one stream):
  on every rank the sharded route, B and D once an encode, C and E once a
  decode, no conv kernel and no plain run, a corrupt container raised,
  at 2 ranks 768x512 refused; against the single-device codecs, the
  containers decoding under each other exactly both ways, the z and y
  symbols equal off their rounding ties (counted), the containers
  byte-identical or each difference shown to be a tie that flipped, and
  x_hat within 1e-4.  Reported: the halo bytes staged, on 4 ranks each
  tile conv's bitwise differences from the whole image's conv, encode,
  decode and h_s ms beside the single-device codec's.  At 1 and 2 ranks
  the scale model in bf16 against the single-device bf16 codec: its
  launches, cross-decoding exact both ways, x_hat within 2^-7, and the
  containers compared byte for byte.

Each path runs with the launch counts set to 0 just before it and read just
after, which shows it ran on its kernels; then each kernel is timed at its
paths' shapes beside its plain version and its bound (the conv kernels with
their weights packed ahead, also F and A at the new plans' shapes: one
output block of 3 columns, the one-tap products at K = 108 and N = 4,608,
A at C = 2,048; the rANS kernels with their table layout and
outputs made ahead, so that a call launches the kernel alone, by CUDA events
around calls queued behind a spin kernel, since their wrappers' host time
can exceed the kernel's; each wrapper's time a call beside it; kernel H
also at a serving batch, S = 256, on int8 and int32 symbols, with
``encode_batch``'s whole call beside ``encode_batch_compact``'s) and, for
the convs, two yardsticks the port never calls: one cuDNN call of the same
layer (float32 without TF32, the same function; bf16, not the same
function) and ``torch._int_mm`` on the layer's implicit-GEMM shape.  The
rANS encoders' bound is the larger of their bytes and their serial chain
(``CHAIN_CYCLES`` a step).  The hyper path's time is broken down by stage
(host clock) and by device kernel (torch.profiler).

Output: one line per phase with its seconds; then the card's name and
power limit (nvidia-smi), a ``{"kernels": [...]}`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero, as does a machine without CUDA.  Imports torch, numpy and the
standard library only.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 900          # a hang ends as a traceback and a non-zero exit
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth (data sheet)
BOOST_HZ = 1.98e9         # H100 SXM boost clock (data sheet)
PEAK_F32_OPS = 67e12      # H100 SXM float32 rate, CUDA cores (data sheet)
F32_U = 2.0 ** -24        # float32 unit roundoff
G_BATCH = 8               # kernel G's gate at the hyper cell's batch
FP32_FLOPS = 67e12        # H100 SXM float32, no tensor cores (data sheet)
# The least dependent chain of one rANS encode step, the bound of kernels
# B, D and H (the same function).  freq is known a group ahead, so all
# that is made from it alone is off the chain: the renorm threshold (freq
# << 16) - 1, c = 2^16 - freq, and the magic number m and shift l of an
# exact 32-bit y / freq (the round-up method, kernel H's dense_step).  What
# is left, as H's SASS runs it: ISETP (need = x > threshold; x >> 16
# beside it), SEL (y), IMAD.HI (hi(y * m) + y, adding y as a 64-bit
# addend, with its carry out), IMAD.X (the carry, bit 32), SHF.R.U64 (>>
# l) = q, and one IMAD, x = q * c + (y + start), the add y + start beside
# the division: 6 instructions, each at least the 4 cycles a fixed-latency
# integer result takes to reach the next.  (Where ptxas adds y by an IADD3
# of its own H's chain is 7; B's and D's SASS chain is 15: SHF, ISETP,
# SEL, then ptxas's division IMAD.HI, IMAD.MOV, IMAD, ISETP, IADD, ISETP,
# IADD, LOP3, IMAD.MOV, IMAD, and the IMAD.IADD and IMAD of the update.)
CHAIN_CYCLES = 6 * 4
H, W = 768, 512           # the reference geometry
HYPER_CKPT = os.path.join(ROOT, "checkpoints",
                          "hp_scale_l0.01.params.msgpack")
MEANSCALE_CKPT = os.path.join(ROOT, "checkpoints",
                              "hp_meanscale_l0.01.params.msgpack")
CKPTS = {"scale": HYPER_CKPT, "meanscale": MEANSCALE_CKPT}
# kernel launches of one hyper compress_batch + decompress_batch round
HYPER_ROUND = {"rans_encode": 1, "rans_decode": 1, "rans_encode_ctx": 1,
               "rans_decode_ctx": 1}
TIE = 1e-4    # y - mu this close to a half-integer rounds on an ulp of mu
# eval_codec's argument lists of docs/RESULTS.md's synthetic rows (4 x
# 768x512; scripts/make_results.py), the launches of one image's round, and
# the row's (bpp, PSNR dB): the JAX package's quality figures.
_PER_IMAGE = {"conv3x3_s1_int8": 8, "rans_encode": 1, "rans_decode": 1}
_SERIAL = {k: 0 for k in HYPER_ROUND}      # the serial format codes on host
EVAL_RUNS = [
    ("int8", ["--codec", "int8"], _PER_IMAGE, (3.610, 7.18)),
    *((f"wavelet {p}", ["--codec", "wavelet", "--profile", p], _PER_IMAGE,
       row) for p, row in (("haar-rgb", (2.650, 41.74)),
                           ("haar", (2.107, 40.53)),
                           ("haar422", (1.808, 38.04)),
                           ("haar420", (1.262, 35.75)))),
    ("hyperprior l0.01", ["--codec", "hyperprior", "--ckpt", HYPER_CKPT],
     _SERIAL, (0.208, 35.05)),
    ("meanscale l0.01", ["--codec", "meanscale", "--ckpt", MEANSCALE_CKPT],
     _SERIAL, (0.170, 35.16)),
]
# (bpp, PSNR) that the JAX package's eval_codec prints for the bit-exact
# codecs' argument lists, on a CPU: JAX_PLATFORMS=cpu python -m
# simple_image_compression_network_tpu.eval_codec --n-synthetic 4 --codec
# int8 (or --codec wavelet --profile P).  Its containers are the port's
# bytes and its reconstructions the port's uint8 values, so the port must
# print these digits.
JAX_EVAL = {
    "int8": (3.6101888020833335, 7.183925086621476),
    "wavelet haar-rgb": (2.650319417317708, 41.74342114202091),
    "wavelet haar": (2.106536865234375, 40.52986760253516),
    "wavelet haar422": (1.8081156412760417, 38.044027110734746),
    "wavelet haar420": (1.262481689453125, 35.74838916710105),
}
# The same command's digits for the float codecs (--codec hyperprior or
# meanscale --ckpt the l0.01 checkpoint), reported beside the port's, not
# gated: two frameworks' float transforms.
JAX_EVAL_FLOAT = {
    "hyperprior l0.01": (0.20795694986979166, 34.98339287235723),
    "meanscale l0.01": (0.16977945963541666, 35.01376524154953),
}
# (C, N) of kernel A's eight layer forms: s2d L0-L3, d2s L4-L6, s2dtail L7
LAYER_FORMS = [("L0 s2d", 12, 128), ("L1 s2d", 512, 128),
               ("L2 s2d", 512, 128), ("L3 s2d", 512, 192),
               ("L4 d2s", 192, 512), ("L5 d2s", 128, 512),
               ("L6 d2s", 128, 512), ("L7 s2dtail", 512, 48)]
# input grid of each form per 768x512 image (the coarse grid it runs on)
FORM_GRID = [(384, 256), (192, 128), (96, 64), (48, 32),
             (48, 32), (96, 64), (192, 128), (192, 128)]
# The eight layers at 768x512: (name, kind, input grid per image, ci, o).
LAYERS = [("L0", "conv", (768, 512), 3, 128),
          ("L1", "conv", (384, 256), 128, 128),
          ("L2", "conv", (192, 128), 128, 128),
          ("L3", "conv", (96, 64), 128, 192),
          ("L4", "deconv", (48, 32), 192, 128),
          ("L5", "deconv", (96, 64), 128, 128),
          ("L6", "deconv", (192, 128), 128, 128),
          ("L7", "deconv", (384, 256), 128, 3)]
# The JAX package's Pallas plans and its other mappings, and the launches
# each makes per pass: s4d on kernel A, phased on F (a launch a phase),
# gemm and tapn on F (one-tap products), laxf32 (one float32 cuDNN conv at
# L0, the golden forms after it) on neither.
PLANS = {"pallas3": (("pallas3",) * 4 + ("pd2s3",) * 4,
                     {"conv_sparse_int8": 8, "conv3x3_s1_int8": 0}),
         "pallas": (("pallas",) * 4 + ("pd2s",) * 4,
                    {"conv3x3_s1_int8": 8, "conv_sparse_int8": 0}),
         "pallas2": (("pallas2",) * 4 + ("pd2s2",) * 4,
                     {"conv3x3_s1_int8": 8, "conv_sparse_int8": 0}),
         "s4d_phased": (("s4d",) * 4 + ("phased",) * 4,
                        {"conv3x3_s1_int8": 4, "conv_sparse_int8": 16}),
         "gemm_tapn": (("gemm",) * 4 + ("tapn",) * 4,
                       {"conv_sparse_int8": 8, "conv3x3_s1_int8": 0}),
         "laxf32": (("laxf32", "lax", "lax", "lax") + ("dilated",) * 4,
                    {"conv3x3_s1_int8": 0, "conv_sparse_int8": 0})}
NO_CONV = {"conv3x3_s1_int8": 0, "conv_sparse_int8": 0}
TILE_X = 256


def log(*args) -> None:
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: {time.perf_counter() - t0:.3f} s")


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fn, iters: int) -> tuple:
    """(the host's time in fn(), and its time to a synchronize after it):
    medians over iters calls, each started on an idle card after one
    warm-up call (host clock)."""
    fn()
    host, wall = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return float(np.median(host)), float(np.median(wall))


def kernel_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn(), a call that launches one kernel, over
    iters calls, after one warm-up call: CUDA events around calls queued
    behind a spin kernel (``torch.cuda._sleep``), so the host's time to
    queue them stays out of the window.  The spin must outlast the
    queueing (the start event not yet reached when the last call is
    queued); else it is taken again 4 times longer."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("the spin kernel never outlasted the host's "
                         "queueing of the timed calls")


def int_mm_ms(m: int, k: int, n: int, dev) -> float:
    """``torch._int_mm`` (int8 in, int32 out) on an (m, k) x (k, n) GEMM,
    k and n rounded up to its granules: a yardstick of the tensor cores'
    reach at a conv's implicit-GEMM shape, timed only."""
    k, n = -(-k // 32) * 32, -(-n // 8) * 8
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev)
    return cuda_ms(lambda: torch._int_mm(a, b), 20)


CONV_KERNEL = "conv_taps_mma_kernel"    # the tile of kernels A and F


def decode_name(mangled: str) -> str:
    """'rans_decode_kernel<C|E, staged|global>' for an instance of the
    decode kernels' template, else ''."""
    m = re.search(r"rans_decode_kernelI([ai])Lb([01])ELb([01])E", mangled)
    if not m:
        return ""
    return (f"rans_decode_kernel<{'E' if m.group(2) == '1' else 'C'}, "
            f"{'staged' if m.group(3) == '1' else 'global'}>")


def encode_name(mangled: str) -> str:
    """'rans_encode_kernel<B|D, global|u16|staged>' for an instance of the
    compact encoders' template, else ''."""
    m = re.search(r"rans_encode_kernelI([ai])Lb([01])ELi([012])E", mangled)
    if not m:
        return ""
    return (f"rans_encode_kernel<{'D' if m.group(2) == '1' else 'B'}, "
            f"{('global', 'u16', 'staged')[int(m.group(3))]}>")


def dense_name(mangled: str) -> str:
    """'rans_encode_dense_kernel<int8|int32, global|staged>' for an
    instance of kernel H's template, else ''."""
    m = re.search(r"rans_encode_dense_kernelI([ai])Li([02])E", mangled)
    if not m:
        return ""
    sym = "int8" if m.group(1) == "a" else "int32"
    tab = "global" if m.group(2) == "0" else "staged"
    return f"rans_encode_dense_kernel<{sym}, {tab}>"


def check_dense_sass(fn: str, chunk: str) -> None:
    """A kernel H instance: its step loop (the backward branch with the
    most STG, two a step: the word and the flag) holds no MUFU (its
    division is a magic number's multiply, not ptxas's reciprocal-based
    division, which the block's own index still uses once); one barrier
    (after the table copy) in a staged instance and none in a global one;
    a staged one reads its table in shared memory and makes no generic
    load."""
    name = dense_name(fn)
    ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", chunk)
    counts = {op: ops.count(op) for op in ("BAR", "LDS", "LD", "LDG", "STG",
                                           "MUFU")}
    insts = [(int(a, 16), txt) for a, txt in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
    loops = [(0, [])]
    for at, txt in insts:
        tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", txt)
        if tgt and int(tgt.group(1), 16) < at:
            body = [x for a, x in insts if int(tgt.group(1), 16) <= a <= at]
            stores = sum(bool(re.search(r"(?:^|\s)STG", x)) for x in body)
            loops.append((stores // 2, body))
    steps, body = max(loops, key=lambda lp: (lp[0], len(lp[1])))
    mufu = sum(bool(re.search(r"(?:^|\s)MUFU", x)) for x in body)
    log(f"  SASS {name}: {counts}; step loop: {steps} steps, "
        f"{len(body) / max(steps, 1):.1f} instructions a step, MUFU {mufu}")
    staged = name.endswith("staged>")
    if not steps or mufu or counts["BAR"] != int(staged) or (staged and (
            counts["LD"] or not counts["LDS"])):
        raise AssertionError(f"{fn}: no step loop, a MUFU in it (a "
                             f"division), not {int(staged)} barriers, or "
                             f"generic loads in a staged instance")


def check_encode_sass(fn: str, chunk: str) -> None:
    """An encode instance: no barrier between its first and last ballot
    (VOTE, only in the step loop); one barrier after the table copy
    (staged), one after the steps and two in the scan; the staged ones read
    table and slots in shared memory and make no generic load."""
    name = encode_name(fn)
    ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", chunk)
    votes = [i for i, op in enumerate(ops) if op == "VOTE"]
    bars = [i for i, op in enumerate(ops) if op == "BAR"]
    counts = {op: ops.count(op) for op in ("BAR", "VOTE", "LDS", "STS", "LD",
                                           "LDG", "STG", "MUFU")}
    in_loop = sum(votes[0] < b < votes[-1] for b in bars) if votes else -1
    # the step loop: the backward branch whose body holds the most ballots,
    # one a step
    insts = [(int(a, 16), txt) for a, txt in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
    loops = [(0, 0)]
    for at, txt in insts:
        tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", txt)
        if tgt and int(tgt.group(1), 16) < at:
            body = [x for a, x in insts if int(tgt.group(1), 16) <= a <= at]
            loops.append((sum("VOTE" in x for x in body), len(body)))
    steps, n_ins = max(loops)
    log(f"  SASS {name}: {counts}, barriers between the ballots: {in_loop}; "
        f"step loop: {steps} steps, {n_ins / max(steps, 1):.1f} "
        f"instructions a step")
    staged = not name.endswith("global>")
    if (in_loop != 0 or len(bars) != 3 + staged or (staged and (
            counts["LD"] or not counts["LDS"]))):
        raise AssertionError(f"{fn}: a barrier in the step loop, or not "
                             f"{3 + staged} barriers, or generic loads in a "
                             f"staged instance")


def g_name(mangled: str) -> str:
    """'deconv5s2_f32_kernel<TQ, TR, R, TN, NG, KC, STAGES, MINB>' of a
    kernel G instance's mangled name, or ''."""
    found = re.search(r"deconv5s2_f32_kernelI((?:Li\d+E)+)E", mangled)
    if not found:
        return ""
    args = ", ".join(re.findall(r"Li(\d+)E", found.group(1)))
    return f"deconv5s2_f32_kernel<{args}>"


def check_g_sass(fn: str, chunk: str) -> None:
    """Kernel G multiplies on the CUDA cores alone: FFMA, and no tensor-core
    instruction (no TF32 or bf16 rounding of its operands)."""
    counts = {op: len(re.findall(r"\b" + op + r"\b", chunk))
              for op in ("FFMA", "FMUL", "FADD", "HMMA", "HGMMA", "IMMA",
                         "DMMA", "LDS", "LDGSTS", "BAR")}
    log(f"  SASS {g_name(fn)}: {counts}")
    if not counts["FFMA"] or (counts["HMMA"] + counts["HGMMA"]
                              + counts["IMMA"] + counts["DMMA"]):
        raise AssertionError(f"{fn}: no FFMA, or a tensor-core instruction")


def report_conv_build(lib_path: str, build_log: str) -> None:
    """Each kernel's ptxas lines (registers, static shared memory, spills)
    and the SASS: each conv kernel must hold int8 tensor-core instructions
    (IMMA or IGMMA) and no IDP4A; each decode instance one barrier a step;
    each compact encode instance none in its step loop."""
    name = None
    for line in build_log.splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        if found:
            name = found.group(1)
        elif name and ("registers" in line or "spill" in line):
            tile = re.search(CONV_KERNEL + r"ILi(\d+)ELi(\d+)ELi(\d+)E",
                             name)
            src = "conv3x3_int8" if "conv3x3" in name else \
                "conv_sparse_int8"
            short = (f"{CONV_KERNEL}<WM={tile.group(1)}, MF={tile.group(2)}, "
                     f"NF={tile.group(3)}> in {src}.cu"
                     if tile else decode_name(name) or encode_name(name) or
                     dense_name(name) or g_name(name) or
                     re.search(r"[a-z][a-z_]*kernel", name)[0])
            log(f"  ptxas {short}: {line.split(':', 1)[-1].strip()}")
    from simple_image_compression_network_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        log("SASS: cuobjdump not in the toolkit, instruction counts not "
            "measured")
        return
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120, check=True)
    n_conv = n_dec = n_enc = n_dense = n_g = 0
    for chunk in res.stdout.split("Function : ")[1:]:
        fn = chunk.split("\n", 1)[0].strip()
        if g_name(fn):
            n_g += 1
            check_g_sass(fn, chunk)
            continue
        if dense_name(fn):
            n_dense += 1
            check_dense_sass(fn, chunk)
            continue
        if encode_name(fn):
            n_enc += 1
            check_encode_sass(fn, chunk)
            continue
        if decode_name(fn):
            # one barrier before the steps and one a step; the staged
            # instances read the table and the ring in shared memory only
            n_dec += 1
            counts = {op: len(re.findall(r"\b" + op + r"\b", chunk))
                      for op in ("BAR", "LDS", "LD", "LDG", "REDUX")}
            log(f"  SASS {decode_name(fn)}: {counts}")
            if counts["BAR"] != 2 or ("staged" in decode_name(fn) and (
                    counts["LD"] or not counts["LDS"])):
                raise AssertionError(f"{fn}: not one barrier a step, or "
                                     f"generic loads in a staged instance")
            continue
        if CONV_KERNEL not in fn:
            continue
        n_conv += 1
        counts = {op: len(re.findall(r"\b" + op + r"\b", chunk))
                  for op in ("IMMA", "IGMMA", "IDP4A")}
        log(f"  SASS {fn[:72]}...: {counts}")
        if counts["IMMA"] + counts["IGMMA"] == 0 or counts["IDP4A"]:
            raise AssertionError(f"{fn}: no int8 tensor-core instruction, "
                                 f"or IDP4A left")
    if not n_conv or n_dec != 4 or n_enc != 4 or n_dense != 4 or n_g != 2:
        raise AssertionError(f"{n_conv} conv, {n_dec} decode, {n_enc} "
                             f"compact encode, {n_dense} dense encode and "
                             f"{n_g} kernel G instances in the library's "
                             f"SASS")
    log(f"SASS: {n_conv} conv kernel instances, each with int8 tensor-core "
        f"instructions and no IDP4A; {n_dec} decode kernel instances, each "
        f"with one barrier a step; {n_enc} compact encode instances, none "
        f"with a barrier in its step loop; {n_dense} dense encode "
        f"instances, none with a MUFU; {n_g} kernel G instances, FFMA and "
        f"no tensor-core instruction")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64))
               .abs().max()) if a.numel() else 0


def require_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shape {tuple(a.shape)} != "
                             f"{tuple(b.shape)}")
    err = max_abs_err(a, b)
    if err:
        raise AssertionError(f"{what}: max |diff| = {err}")
    return err


def make_images(seed: int, b: int, h: int = H, w: int = W) -> np.ndarray:
    """Smooth colour gradients plus noise, uint8 (B, h, w, 3)."""
    rng = np.random.default_rng(seed)
    i = np.arange(h, dtype=np.float64)[:, None, None]
    j = np.arange(w, dtype=np.float64)[None, :, None]
    out = []
    for _ in range(b):
        f = rng.uniform(0.005, 0.03, size=(2, 3))
        ph = rng.uniform(0, 2 * np.pi, size=(2, 3))
        img = (128 + 70 * np.sin(f[0] * i + ph[0]) * np.cos(f[1] * j + ph[1])
               + rng.normal(0, 6, size=(h, w, 3)))
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def lane_symbols(rng, lane_cdf: np.ndarray, s: int, t: int) -> np.ndarray:
    """(S, t, N) int8 symbols drawn from each lane's own CDF row, over the
    latent's alphabet 0..127 (the table's last symbol is the escape)."""
    n = lane_cdf.shape[0]
    syms = np.empty((s, t, n), np.int8)
    for k in range(n):
        u = rng.integers(0, lane_cdf[k, -2], size=(s, t))
        syms[:, :, k] = np.searchsorted(lane_cdf[k, 1:], u, side="right")
    return syms


def conv_inputs(rng, b: int, x: int, y: int, c: int, n: int, dev):
    xs = torch.from_numpy(rng.integers(-128, 128, size=(b, x, y, c),
                                       dtype=np.int8)).to(dev)
    w3 = torch.from_numpy(rng.integers(-8, 8, size=(3, 3, c, n),
                                       dtype=np.int8)).to(dev)
    bias = torch.from_numpy(rng.integers(-128, 128, size=(n,),
                                         dtype=np.int8)).to(dev)
    return xs, w3, bias


def ctx_symbols(rng, table: np.ndarray, s: int, t: int, n: int,
                n_escapes: int = 0):
    """(S, t, N) int32 contexts (uniform over the table's rows) and int32
    symbols drawn from each context's row; then ``n_escapes`` positions
    forced to the escape symbol (the table's last)."""
    ctx = rng.integers(0, table.shape[0], size=(s, t, n)).astype(np.int32)
    u = rng.integers(0, table[0, -1], size=(s, t, n))
    syms = np.empty((s, t, n), np.int32)
    for r in range(table.shape[0]):
        m = ctx == r
        syms[m] = np.searchsorted(table[r, 1:], u[m], side="right")
    flat = syms.reshape(-1)
    flat[rng.choice(flat.size, n_escapes, replace=False)] = table.shape[1] - 2
    return syms, ctx


def decode_instance(n: int, l1: int, n_rows=None) -> str:
    """The instance of kernel C (``n_rows`` None) or E at this shape."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    return ("staged" if cuda_rans.decode_staged_fits(n, l1, n_rows)
            else "global")


def encode_instance(table: torch.Tensor, n: int, t: int,
                    ctx_rows: bool) -> str:
    """The instance of kernel B (``ctx_rows`` False) or D for this table at
    this shape: 'u16' or 'staged' (the table in shared memory as u16 or
    int32), or 'global'."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    mode = cuda_rans.encode_kernel_table(table, n, t, ctx_rows)[1]
    return ("global", "u16", "staged")[mode]


def decode_cuts(n: int, width: int) -> list:
    """Buffer lengths the decoders are held at beside the whole buffer:
    cut inside the ring's first fill (2N + 5 words), inside its first
    refill, and at a length that is no multiple of the ring."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    npad = -(-n // 32) * 32
    ring = cuda_rans._ring_words(npad)
    return [None] + [c for c in (2 * n + 5, 2 * n + 2 * npad + 7,
                                 3 * ring + 5) if c < width]


def check_rans(tag: str, enc, dec, enc_plain, dec_plain, syms, tables,
               t: int, n: int, errs: dict, keys) -> torch.Tensor:
    """Encode with a kernel and its plain version, decode the kernel's words
    with the other kernel and its plain version (whole and truncated at
    ``decode_cuts``), all bit-exact; the round trip must give back the
    symbols.  ``tables`` are the table arguments after syms (encode) or x0
    (decode).  Returns the word counts."""
    k_enc, k_dec = keys
    words, counts = enc(syms, *tables)
    ref_w, ref_c = enc_plain(syms.cpu(), *[a.cpu() for a in tables])
    errs[k_enc] = max(
        errs[k_enc],
        require_equal(f"{tag} encode counts", counts, ref_c),
        require_equal(f"{tag} encode words", words.to(torch.int32) & 0xFFFF,
                      ref_w.to(torch.int32) & 0xFFFF))
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    x0 = cuda_rans.split_init(words, n)
    for cut in decode_cuts(n, words.shape[1]):
        w = words if cut is None else words[:, :cut].contiguous()
        got = dec(w, x0, *tables, t)
        ref = dec_plain(w.cpu(), x0.cpu(), *[a.cpu() for a in tables], t)
        for what, g, r in zip(("syms", "consumed", "x_fin"), got, ref):
            errs[k_dec] = max(errs[k_dec], require_equal(
                f"{tag} decode {what} cap={w.shape[1]}", g, r))
        if cut is None:
            out, cons, xfin = got
            require_equal(f"{tag} round trip", out.to(torch.int32),
                          syms.to(torch.int32))
            require_equal(f"{tag} consumed == count", cons, counts)
            if not bool((xfin == 1 << 16).all()):
                raise AssertionError(f"{tag}: final decoder states != 2^16")
    return counts


def check_encode_dirty(tag: str, syms, tables, t: int, n: int, errs: dict,
                       key: str) -> None:
    """Kernel B (``tables`` the lane table) or D (table, ctx) launched alone
    on outputs filled with a nonzero pattern, the global instance's scratch
    too: the words over the whole width, so the zero tail the kernel
    writes itself, and the counts must equal the plain version's."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    ctx_rows = len(tables) == 2
    tb = cuda_rans.encode_kernel_table(tables[0], n, t, ctx_rows)
    words, counts, scratch = out = cuda_rans._encode_outputs(
        syms.shape[0], t, n, tb[1], syms.device)
    words.fill_(0x5A5A)
    counts.fill_(-1)
    if scratch is not None:
        scratch.fill_(0xA5)
    launch = cuda_rans._encode_ctx if ctx_rows else cuda_rans._encode
    plain = (cuda_rans.encode_batch_compact_ctx_plain if ctx_rows
             else cuda_rans.encode_batch_compact_plain)
    got_w, got_c = launch(syms, *tables, tb, out)
    if got_w.data_ptr() != words.data_ptr():
        raise AssertionError(f"{tag}: the words were not written in place")
    ref_w, ref_c = plain(syms.cpu(), *[a.cpu() for a in tables])
    errs[key] = max(errs[key],
                    require_equal(f"{tag} on filled outputs counts", got_c,
                                  ref_c),
                    require_equal(f"{tag} on filled outputs words",
                                  got_w.to(torch.int32) & 0xFFFF,
                                  ref_w.to(torch.int32) & 0xFFFF))


def flat_rows(n: int) -> np.ndarray:
    """Rows of 256 symbols of frequency 256: every lane renorms at every
    other step, all lanes at once."""
    return np.tile(np.arange(257, dtype=np.int32) * 256, (n, 1))


def skewed_rows(n: int) -> np.ndarray:
    """Rows where the coded symbol has frequency 65535 (symbol 0, or
    symbol 1 after a zero-frequency symbol 0), the others 1 or 0: no lane
    renorms for many steps."""
    a = np.concatenate([[0, 65535], np.full(127, 65536)])
    b = np.concatenate([[0, 0, 65535], np.full(126, 65536)])
    return np.stack([a if k % 2 == 0 else b for k in range(n)]).astype(
        np.int32)


def check_lane_edges(rng, cdfs: np.ndarray, dev, errs: dict) -> None:
    """Kernels B and C at their edges, each through ``check_rans`` (whole
    and truncated buffers): a lane count below one warp (N = 20), steps
    where every lane or no lane renorms, a table too large for shared
    memory (N = 1024), and the steps of a 3840x2160 frame's stream (t =
    2,025), whose slots do not fit either: between them both instances of
    B (u16, global) and of C.  The no-renorm table has zero-frequency
    symbols and 2^16 before its last entry: its u16 layout is exact for
    every symbol it codes."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf)
    cases = [  # tag, S, t, lane table, symbols (None: drawn from the rows),
        #        the instances of B and C
        ("N=20", 3, 30, _lane_cdf(cdfs, 20), None, "u16", "staged"),
        ("all lanes renorm every other step", 2, 40, flat_rows(64),
         rng.integers(0, 128, size=(2, 40, 64)), "u16", "staged"),
        ("no lane renorms", 2, 48, skewed_rows(40),
         np.broadcast_to(np.arange(40) % 2, (2, 48, 40)), "u16", "staged"),
        ("oversize N=1024", 2, 20, _lane_cdf(cdfs, 1024), None, "global",
         "global"),
        ("3840x2160 stream t=2025", 1, 2025, _lane_cdf(cdfs, 384), None,
         "global", "staged")]
    for tag, s, t, table, syms, enc_inst, dec_inst in cases:
        table = np.ascontiguousarray(table, np.int32)
        n, l1 = table.shape
        if syms is None:
            syms = lane_symbols(rng, table, s, t)
        syms = torch.from_numpy(np.ascontiguousarray(syms, np.int8)).to(dev)
        lc = torch.from_numpy(table).to(dev)
        insts = (encode_instance(lc, n, t, False), decode_instance(n, l1))
        if insts != (enc_inst, dec_inst):
            raise AssertionError(f"kernels B, C {tag}: instances {insts}")
        counts = check_rans(
            f"kernels B, C {tag}", cuda_rans.encode_batch_compact,
            cuda_rans.decode, cuda_rans.encode_batch_compact_plain,
            cuda_rans.decode_plain, syms, (lc,), t, n, errs,
            ("rans_encode", "rans_decode"))
        check_encode_dirty(f"kernel B {tag}", syms, (lc,), t, n, errs,
                           "rans_encode")
        if tag.startswith("all") and not bool(
                (counts == 2 * n + n * t // 2).all()):
            raise AssertionError(f"{tag}: {counts.tolist()} words")
        if tag.startswith("no") and not bool((counts == 2 * n).all()):
            raise AssertionError(f"{tag}: {counts.tolist()} words")
        log(f"kernels B, C edge {tag}: S={s} t={t} N={n} L+1={l1}, B {enc_inst}"
            f" instance, C {dec_inst} instance, bit-exact whole and cut and "
            f"on filled outputs, {int(counts.sum())} words")


def check_kernels(rng, cdfs: np.ndarray, dev) -> dict:
    """Each kernel against its plain version on CPU copies, bit-exact.
    Returns the max |diff| per kernel (0 when it passes)."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf)
    from simple_image_compression_network_tpu_torch.ops import cuda_conv

    errs = {"conv3x3_s1_int8": 0, "conv3x3_s1_int8 (pallas plan)": 0,
            "conv_sparse_int8": 0, "rans_encode": 0, "rans_decode": 0,
            "rans_encode_ctx": 0, "rans_decode_ctx": 0,
            "rans_encode_dense": 0}
    for name, c, n in LAYER_FORMS:  # ragged 20x28: partial tiles both ways
        xs, w3, bias = conv_inputs(rng, 2, 20, 28, c, n, dev)
        got = cuda_conv.conv3x3_s1_int8(xs, w3, bias)
        ref = cuda_conv.conv3x3_s1_int8_plain(xs.cpu(), w3.cpu(), bias.cpu())
        errs["conv3x3_s1_int8"] = max(errs["conv3x3_s1_int8"], require_equal(
            f"kernel A {name} (2x20x28x{c} -> {n})", got, ref))
    # channel counts off the 4-byte packing and the 64-channel tile
    xs, w3, bias = conv_inputs(rng, 3, 9, 13, 5, 20, dev)
    errs["conv3x3_s1_int8"] = max(errs["conv3x3_s1_int8"], require_equal(
        "kernel A 3x9x13x5 -> 20", cuda_conv.conv3x3_s1_int8(xs, w3, bias),
        cuda_conv.conv3x3_s1_int8_plain(xs.cpu(), w3.cpu(), bias.cpu())))
    log("kernel A: 8 layer forms at 2x20x28 and 3x9x13x5->20 bit-exact")
    # the halo modes at L1's s2d form: the input carries the halo
    for xv, yv in ((True, False), (False, True), (True, True)):
        xs, w3, bias = conv_inputs(rng, 2, 192 + 2 * xv, 128 + 2 * yv, 512,
                                   128, dev)
        errs["conv3x3_s1_int8"] = max(errs["conv3x3_s1_int8"], require_equal(
            f"kernel A halo x_valid={xv} y_valid={yv}",
            cuda_conv.conv3x3_s1_int8(xs, w3, bias, x_valid=xv, y_valid=yv),
            cuda_conv.conv3x3_s1_int8_plain(xs, w3, bias, x_valid=xv,
                                            y_valid=yv)))
    log("kernel A: halo modes x_valid, y_valid, both at "
        "2x(192|194)x(128|130)x512->128 bit-exact")

    # the flagship geometry (S = 16 streams for B = 2, t = 96, N = 384),
    # then a ragged lane count that leaves part of a warp idle
    for s, t, n in ((16, 96, 384), (3, 40, 200)):
        lane_cdf = np.ascontiguousarray(_lane_cdf(cdfs, n), np.int32)
        syms = torch.from_numpy(lane_symbols(rng, lane_cdf, s, t)).to(dev)
        lc = torch.from_numpy(lane_cdf).to(dev)
        counts = check_rans(
            f"kernels B, C S={s} t={t} N={n}",
            cuda_rans.encode_batch_compact, cuda_rans.decode,
            cuda_rans.encode_batch_compact_plain, cuda_rans.decode_plain,
            syms, (lc,), t, n, errs, ("rans_encode", "rans_decode"))
        log(f"kernels B, C: S={s} t={t} N={n} bit-exact, "
            f"{int(counts.sum())} words")
    return errs


# Kernel H's cases: (tag, S, t, N, rows): the int8 latent's shape, a ragged
# lane count (its last block of lanes part empty), more lanes than one
# block may hold threads (the first kernel H refused N > 1024), enough
# streams for blocks of 8 stream rows (the last one part empty), and the
# latent's rows with the last entry 65,535, which have no packed layout
# and take the global instance.
DENSE_CASES = [("int8 latent", 16, 96, 384, "latent"),
               ("ragged", 3, 40, 200, "latent"),
               ("N=1100", 2, 24, 1100, "latent"),
               ("stream rows", 102, 24, 384, "latent"),
               ("global instance", 4, 40, 384, "last 65535")]


def check_dense(rng, cdfs: np.ndarray, dev, errs: dict) -> None:
    """Kernel H against its plain version, bit for bit, on int8 and int32
    symbols at each of ``DENSE_CASES``, launched alone on outputs filled
    with a pattern (every emit, flag and final state is written) and
    through the wrapper, its instance checked; at the first two shapes
    ``encode_batch``'s words and counts == kernel B's."""
    from simple_image_compression_network_tpu_torch import _build
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf)
    for tag, s, t, n, rows in DENSE_CASES:
        table = np.ascontiguousarray(_lane_cdf(cdfs, n), np.int32)
        syms8 = torch.from_numpy(lane_symbols(rng, table, s, t)).to(dev)
        if rows != "latent":
            table[:, -1] = 65535   # the escape symbol (128) is never coded
        lc = torch.from_numpy(table).to(dev)
        tb = cuda_rans.encode_dense_table(lc)
        plan = cuda_rans.dense_plan(s, n, table.shape[1],
                                    tb[2] == cuda_rans.ENC_STAGED,
                                    _build.sm_count(lc.device.index))
        want = "global" if rows != "latent" else "staged"
        inst = "staged" if tb[2] == cuda_rans.ENC_STAGED else "global"
        if inst != want or (tag == "stream rows" and not s % plan.streams):
            raise AssertionError(f"kernel H {tag}: {inst} instance, "
                                 f"{plan.streams} streams a block")
        ref = cuda_rans.encode_dense_plain(syms8.cpu(), lc.cpu())
        for syms in (syms8, syms8.to(torch.int32)):
            what = f"kernel H {tag} S={s} t={t} N={n} {syms.dtype}"
            out = (torch.full((s, t, n), 0x5A5A5A5A, dtype=torch.int32,
                              device=dev),
                   torch.ones((s, t, n), dtype=torch.bool, device=dev),
                   torch.full((s, n), -7, dtype=torch.int32, device=dev))
            out[1].view(torch.uint8).fill_(0xA5)
            got = cuda_rans._encode_dense(syms, lc, tb, out)
            wrapped = cuda_rans.encode_dense(syms, lc)
            torch.cuda.synchronize()
            for name, g, w, r in zip(("words", "flags", "final states"),
                                     got, wrapped, ref):
                if name == "flags":   # a written flag is 0 or 1
                    g, w = g.view(torch.uint8), w.view(torch.uint8)
                errs["rans_encode_dense"] = max(
                    errs["rans_encode_dense"],
                    require_equal(f"{what} {name} on filled outputs", g, r),
                    require_equal(f"{what} {name}", w, r))
        if rows == "latent" and n <= 384:
            words_h, counts_h = cuda_rans.encode_batch(syms8, lc)
            words_b, counts_b = cuda_rans.encode_batch_compact(syms8, lc)
            require_equal("kernel H counts == kernel B's", counts_h, counts_b)
            for j in range(s):
                require_equal(f"kernel H words == kernel B's, stream {j}",
                              words_h[j, :counts_h[j]] & 0xFFFF,
                              words_b[j, :counts_b[j]].to(torch.int64)
                              & 0xFFFF)
        log(f"kernel H {tag}: S={s} t={t} N={n} L+1={table.shape[1]}, "
            f"{plan.blocks} blocks of {cuda_rans.DENSE_LANES} lanes x "
            f"{plan.streams} "
            f"stream(s), {inst} instance "
            f"({plan.smem} bytes of shared memory), int8 and int32 symbols "
            f"bit-exact alone on filled outputs and through the wrapper"
            + (", words and counts == kernel B's"
               if rows == "latent" and n <= 384 else ""))


def layer_case(rng, batch: int, layer, dev, halo=(False, False)) -> dict:
    """Random int8 input, int4 [O, 5, 5, I] weights and int8 bias of one
    layer at its 768x512 shape, with the operands of kernel F (s2d input
    or phase blocks, tap table) and of kernel A (the s2d / d2s form of the
    Pallas plans).  ``halo``: the input carries the halo of the valid
    modes (2 pixels a side for the conv, 1 for the deconv)."""
    from simple_image_compression_network_tpu_torch.ops import (conv_fast,
                                                                cuda_conv)
    _, kind, (gx, gy), ci, o = layer
    pad = 4 if kind == "conv" else 2
    gx, gy = gx + pad * halo[0], gy + pad * halo[1]

    def rand(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.integers(lo, hi, size=shape,
                                             dtype=np.int8)).to(dev)
    x, w, b = rand((batch, gx, gy, ci)), rand((o, 5, 5, ci), -8, 8), rand((o,))
    if kind == "conv":
        xf = conv_fast.space_to_depth(x).contiguous()
        taps, wt = cuda_conv.conv_taps_s2d(w)
        bf, nb, w3 = b, 1, conv_fast.conv_weights_s2d(w)
    else:
        xf = x
        taps, wt = cuda_conv.deconv_taps_d2s(w)
        bf, nb = conv_fast.tile_bias(b, 4), 4
        w3 = conv_fast.deconv_weights_d2s(w)
    return {"x": x, "w": w, "b": b, "xf": xf, "taps": taps,
            "wt": wt.contiguous(), "bf": bf.contiguous(), "nb": nb,
            "w3": w3.contiguous(), "kind": kind,
            "valid": {"x_valid": halo[0], "y_valid": halo[1]}}


def run_f(c: dict, plain: bool = False) -> torch.Tensor:
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
    fn = cuda_conv.conv_sparse_int8_plain if plain else \
        cuda_conv.conv_sparse_int8
    return fn(c["xf"], c["wt"], c["bf"], c["taps"], c["nb"], **c["valid"])


def run_a(c: dict, plain: bool = False) -> torch.Tensor:
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
    fn = cuda_conv.conv3x3_s1_int8_plain if plain else \
        cuda_conv.conv3x3_s1_int8
    return fn(c["xf"], c["w3"], c["bf"], **c["valid"])


def prepacked(c: dict) -> tuple:
    """Calls of kernels F and A on the case with their weights packed
    ahead: each launches its kernel and nothing else, for ``kernel_ms``."""
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
    pk = cuda_conv.pack_taps(c["wt"], c["taps"], c["nb"], c["xf"].shape[3])
    wp = cuda_conv.pack_conv3x3(c["w3"])
    xv, yv = c["valid"]["x_valid"], c["valid"]["y_valid"]
    return (lambda: cuda_conv._conv_sparse(c["xf"], c["wt"], c["bf"],
                                           c["taps"], c["nb"], True, xv, yv,
                                           pk),
            lambda: cuda_conv._conv3x3(c["xf"], c["w3"], c["bf"], True, xv,
                                       yv, wp))


def check_layers(rng, batch: int, dev, errs: dict) -> None:
    """Kernel F (conv and deconv forms) and kernel A's Pallas-plan forms at
    the eight layers' shapes, each against its plain version on the card,
    and F against A; then F's halo modes at L2 (conv) and L5 (deconv)."""
    for layer in LAYERS:
        c = layer_case(rng, batch, layer, dev)
        got = run_f(c)
        tag = f"{layer[0]} {layer[1]} {tuple(c['xf'].shape)}"
        errs["conv_sparse_int8"] = max(errs["conv_sparse_int8"], require_equal(
            f"kernel F {tag}", got, run_f(c, plain=True)))
        a = run_a(c)
        errs["conv3x3_s1_int8 (pallas plan)"] = max(
            errs["conv3x3_s1_int8 (pallas plan)"],
            require_equal(f"kernel A {tag}", a, run_a(c, plain=True)))
        require_equal(f"kernel F == kernel A {tag}", got, a)
    log(f"kernels F and A: the 8 layers at B={batch} 768x512 bit-exact, "
        f"F == A")
    for layer in (LAYERS[2], LAYERS[5]):
        for halo in ((True, False), (False, True), (True, True)):
            c = layer_case(rng, batch, layer, dev, halo)
            errs["conv_sparse_int8"] = max(
                errs["conv_sparse_int8"], require_equal(
                    f"kernel F {layer[0]} halo {halo}", run_f(c),
                    run_f(c, plain=True)))
    log("kernel F: halo modes x_valid, y_valid, both at L2 (conv) and L5 "
        "(deconv) bit-exact")


# Edge shapes of kernel A: (B, X, Y, C, N, x_valid, y_valid), off the
# 16-column and 8 to 16-row pixel tiles, off the 32-byte K granule (C = 5,
# 31, 40, 48, 96: the im2col, byte-staged and padded paths) and the 8-channel
# N granule, on every block tile.
A_EDGES = [(1, 7, 35, 40, 70, False, False), (3, 90, 51, 48, 56, False, True),
           (3, 11, 17, 12, 200, False, False), (1, 5, 3, 31, 9, True, False),
           (3, 33, 47, 64, 16, False, False), (3, 72, 50, 96, 130, True, True),
           (1, 10, 20, 128, 48, True, False), (3, 9, 13, 5, 20, False, False),
           (1, 48, 96, 64, 192, False, False)]
# Edge layers of kernel F: (B, kind, input grid, ci, o, halo), on the s2d
# conv (input blocks of ci channels, im2col below 32) and the d2s deconv
# (4 output blocks of o channels, merged below 8).
F_EDGES = [(3, "conv", (18, 26), 3, 20, (False, False)),
           (1, "conv", (14, 30), 40, 70, (True, False)),
           (1, "deconv", (9, 13), 40, 3, (False, False)),
           (3, "deconv", (7, 9), 5, 3, (True, True)),
           (3, "deconv", (5, 17), 48, 10, (False, True))]


def check_edges(rng, batch: int, dev, errs: dict) -> None:
    """Kernels A and F against their plain versions at the edge shapes,
    and A's halo modes at two more layer forms (L0's im2col form, L7's
    48 outputs) at their 768x512 grids."""
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
    for b, x, y, c, n, xv, yv in A_EDGES:
        xs, w3, bias = conv_inputs(rng, b, x, y, c, n, dev)
        errs["conv3x3_s1_int8"] = max(errs["conv3x3_s1_int8"], require_equal(
            f"kernel A edge {b}x{x}x{y}x{c}->{n} valid=({xv}, {yv})",
            cuda_conv.conv3x3_s1_int8(xs, w3, bias, x_valid=xv, y_valid=yv),
            cuda_conv.conv3x3_s1_int8_plain(xs, w3, bias, x_valid=xv,
                                            y_valid=yv)))
    log(f"kernel A: {len(A_EDGES)} edge shapes (B = 1 and 3, extents off "
        f"the tiles, C and N off the MMA granules) bit-exact")
    for form in (0, 7):
        (name, c, n), (gx, gy) = LAYER_FORMS[form], FORM_GRID[form]
        for xv, yv in ((True, False), (False, True), (True, True)):
            xs, w3, bias = conv_inputs(rng, batch, gx + 2 * xv, gy + 2 * yv,
                                       c, n, dev)
            errs["conv3x3_s1_int8"] = max(
                errs["conv3x3_s1_int8"], require_equal(
                    f"kernel A {name} halo x_valid={xv} y_valid={yv}",
                    cuda_conv.conv3x3_s1_int8(xs, w3, bias, x_valid=xv,
                                              y_valid=yv),
                    cuda_conv.conv3x3_s1_int8_plain(
                        xs, w3, bias, x_valid=xv, y_valid=yv)))
        log(f"kernel A: halo modes at the {name} form "
            f"{batch}x{gx}x{gy}x{c}->{n} bit-exact")
    for b, kind, grid, ci, o, halo in F_EDGES:
        c = layer_case(rng, b, ("edge", kind, grid, ci, o), dev, halo)
        errs["conv_sparse_int8"] = max(errs["conv_sparse_int8"], require_equal(
            f"kernel F edge {kind} B={b} {tuple(c['xf'].shape)} o={o} "
            f"halo {halo}", run_f(c), run_f(c, plain=True)))
    log(f"kernel F: {len(F_EDGES)} edge layers (im2col and merged blocks, "
        f"B = 1 and 3, halo modes) bit-exact")


def check_hyper_kernels(rng, codec, batch: int, dev, errs: dict) -> None:
    """Kernels D and E at the hyper y shapes (S = 8B, t = 96, N = 384,
    table 64 x 257, with forced escapes), then a ragged shape; kernels B
    and C at the hyper z shapes (S = B, t = 48, N = 256, rows of 129):
    each against its plain version, bit-exact."""
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, hyper_codec)
    y_table = np.ascontiguousarray(codec.y_cdfs_dev, np.int32)
    yt = torch.from_numpy(y_table).to(dev)
    s_img, n, t = hyper_codec._plan_lanes((H // 16) * (W // 16), 192)
    for s, t, n, n_esc in ((batch * s_img, t, n, 1000), (3, 40, 200, 7)):
        syms, ctx = ctx_symbols(rng, y_table, s, t, n, n_esc)
        ctx_d = torch.from_numpy(ctx).to(dev)
        # ctx rides after the table: encode(syms, table, ctx) and
        # decode(words, x0, table, ctx, t)
        counts = check_rans(
            f"kernels D, E S={s} t={t} N={n}",
            cuda_rans.encode_batch_compact_ctx, cuda_rans.decode_ctx,
            cuda_rans.encode_batch_compact_ctx_plain,
            cuda_rans.decode_ctx_plain, torch.from_numpy(syms).to(dev),
            (yt, ctx_d), t, n, errs, ("rans_encode_ctx", "rans_decode_ctx"))
        log(f"kernels D, E: S={s} t={t} N={n} R=64 L+1=257 bit-exact, "
            f"{n_esc} forced escapes, {int(counts.sum())} words")
    s_img, n, t = hyper_codec._plan_lanes((H // 64) * (W // 64), 128)
    s = batch * s_img
    lane_cdf = np.ascontiguousarray(codec.z_cdfs[np.arange(n) % 128],
                                    np.int32)
    syms = torch.from_numpy(lane_symbols(rng, lane_cdf, s, t)).to(dev)
    counts = check_rans(
        f"kernels B, C z shapes S={s} t={t} N={n}",
        cuda_rans.encode_batch_compact, cuda_rans.decode,
        cuda_rans.encode_batch_compact_plain, cuda_rans.decode_plain,
        syms, (torch.from_numpy(lane_cdf).to(dev),), t, n, errs,
        ("rans_encode", "rans_decode"))
    log(f"kernels B, C: z shapes S={s} t={t} N={n} L+1={lane_cdf.shape[1]} "
        f"bit-exact, {int(counts.sum())} words")
    # kernels D and E at their edges: one row, contexts at both ends of the
    # table, every lane or no lane renorming, 256 rows (too many for shared
    # memory: both global instances), and 600 steps (D's slots do not fit)
    flat, skew = flat_rows(4), skewed_rows(2)
    for tag, s, t, n, table, insts in (
            ("R=1", 2, 20, 37, y_table[:1], ("staged", "staged")),
            ("contexts 0 and R-1", 2, 20, 64, y_table, ("staged", "staged")),
            ("all lanes renorm every other step", 2, 40, 64, flat,
             ("staged", "staged")),
            ("no lane renorms", 2, 48, 40, skew, ("staged", "staged")),
            ("oversize R=256", 2, 20, 384, np.tile(y_table, (4, 1)),
             ("global", "global")),
            ("t=600", 1, 600, 384, y_table, ("global", "staged"))):
        table = np.ascontiguousarray(table, np.int32)
        r = table.shape[0]
        ctx = rng.integers(0, r, size=(s, t, n)).astype(np.int32)
        if tag.startswith("contexts"):
            ctx = np.where(ctx < r // 2, 0, r - 1).astype(np.int32)
        if tag.startswith("no"):   # lane k codes symbol k % 2 in row k % 2
            ctx = np.ascontiguousarray(np.broadcast_to(
                np.arange(n, dtype=np.int32) % 2, (s, t, n)))
            syms = ctx.copy()
        else:
            u = rng.integers(0, 65536, size=(s, t, n))
            syms = (table[ctx][..., 1:-1] <= u[..., None]).sum(-1).astype(
                np.int32)
        tt = torch.from_numpy(table).to(dev)
        got = (encode_instance(tt, n, t, True),
               decode_instance(n, table.shape[1], r))
        if got != insts:
            raise AssertionError(f"kernels D, E {tag}: instances {got}")
        syms_d = torch.from_numpy(syms).to(dev)
        tables = (tt, torch.from_numpy(ctx).to(dev))
        counts = check_rans(
            f"kernels D, E {tag}", cuda_rans.encode_batch_compact_ctx,
            cuda_rans.decode_ctx, cuda_rans.encode_batch_compact_ctx_plain,
            cuda_rans.decode_ctx_plain, syms_d, tables, t, n, errs,
            ("rans_encode_ctx", "rans_decode_ctx"))
        check_encode_dirty(f"kernel D {tag}", syms_d, tables, t, n, errs,
                           "rans_encode_ctx")
        if tag.startswith("all") and not bool(
                (counts == 2 * n + n * t // 2).all()):
            raise AssertionError(f"{tag}: {counts.tolist()} words")
        if tag.startswith("no") and not bool((counts == 2 * n).all()):
            raise AssertionError(f"{tag}: {counts.tolist()} words")
        log(f"kernels D, E edge {tag}: S={s} t={t} N={n} R={r} L+1="
            f"{table.shape[1]}, D {insts[0]} instance, E {insts[1]} "
            f"instance, bit-exact whole and cut and on filled outputs, "
            f"{int(counts.sum())} words")


def chain_bound_ms(t: int) -> float:
    """The least time of t dependent encode steps: t * CHAIN_CYCLES at the
    boost clock."""
    return t * CHAIN_CYCLES / BOOST_HZ * 1e3


def bound_by(byte_bound: float, chain_bound: float) -> str:
    """Which of an encoder's two bounds is its bound: "bytes", or
    "operations", the chain of its t dependent steps."""
    return "operations" if chain_bound >= byte_bound else "bytes"


def time_rans(enc, dec, enc_plain, dec_plain, syms, tables, t: int,
              n: int, sym_bytes: int, ctx_bytes: int) -> dict:
    """Time one encode kernel and one decode kernel at one shape beside
    their plain versions (on the card), and their bounds: the byte bound
    (each input read once, each output written once, the words as written)
    and, for the encoder, the chain bound of its t steps.  Each kernel by
    ``kernel_ms`` of a call that launches it alone (its table layout and
    outputs made ahead, held equal to the wrapper first), beside its
    wrapper's time a call (CUDA events, host included)."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    s = syms.shape[0]
    words, counts = enc(syms, *tables)
    x0 = cuda_rans.split_init(words, n)
    n_words = int(counts.sum())
    ctx_rows = len(tables) == 2
    table = tables[0]
    etb = cuda_rans.encode_kernel_table(table, n, t, ctx_rows)
    eouts = cuda_rans._encode_outputs(s, t, n, etb[1], syms.device)
    eouts[0].fill_(0x5A5A)     # the kernel writes every word, the tail too
    enc_alone = cuda_rans._encode_ctx if ctx_rows else cuda_rans._encode
    for what, g, r in zip(("words", "counts"),
                          enc_alone(syms, *tables, etb, eouts),
                          (words, counts)):
        require_equal(f"encode launched alone {what}", g, r)
    tb = cuda_rans.kernel_table(table, n, ctx_rows)
    launch = cuda_rans._decode_ctx if ctx_rows else cuda_rans._decode
    outs = tuple(torch.empty_like(o) for o in dec(words, x0, *tables, t))
    for what, g, r in zip(("syms", "consumed", "x_fin"),
                          launch(words, x0, *tables, t, tb, outs),
                          dec(words, x0, *tables, t)):
        require_equal(f"decode launched alone {what}", g, r)
    out = {
        "enc_ms": kernel_ms(lambda: enc_alone(syms, *tables, etb, eouts)),
        "enc_wrapper_ms": cuda_ms(lambda: enc(syms, *tables), 20),
        "enc_plain": cuda_ms(lambda: enc_plain(syms, *tables), 3),
        "enc_instance": encode_instance(table, n, t, ctx_rows),
        "dec_ms": kernel_ms(lambda: launch(words, x0, *tables, t, tb, outs)),
        "dec_wrapper_ms": cuda_ms(lambda: dec(words, x0, *tables, t), 20),
        "dec_plain": cuda_ms(lambda: dec_plain(words, x0, *tables, t), 3),
        "instance": decode_instance(
            n, table.shape[1], table.shape[0] if ctx_rows else None),
    }
    out["per_step_us"] = out["dec_ms"] * 1e3 / t
    out["enc_per_step_us"] = out["enc_ms"] * 1e3 / t
    table_bytes = table.numel() * 4
    states = 4 * x0.numel()
    n_sym = syms.numel()
    enc_bytes = (n_sym * (sym_bytes + ctx_bytes) + table_bytes  # syms, ctx
                 + 2 * n_words + 4 * s)                    # words, counts
    dec_bytes = (2 * n_words + states + table_bytes + n_sym * ctx_bytes
                 + n_sym * sym_bytes + 4 * s + states)  # syms, consumed, x_fin
    out["enc_byte_bound"] = enc_bytes / PEAK_BYTES * 1e3
    out["enc_chain_bound"] = chain_bound_ms(t)
    out["enc_bound"] = max(out["enc_byte_bound"], out["enc_chain_bound"])
    out["enc_bound_by"] = bound_by(out["enc_byte_bound"],
                                   out["enc_chain_bound"])
    out["dec_bound"] = dec_bytes / PEAK_BYTES * 1e3
    out["shape"] = f"S={s} t={t} N={n} L+1={table.shape[1]}"
    out["n_words"] = n_words
    return out


def time_dense(syms, lc, plain: bool) -> dict:
    """Kernel H at one shape: device time of a call that launches it alone
    (table layouts and outputs made ahead, held equal to the wrapper
    first) on the int8 symbols and on an int32 copy, the wrapper's time a
    call, ``encode_batch``'s whole call and ``encode_batch_compact``'s
    beside it, the plain version (if ``plain``), and the bounds: the bytes
    it must move (1-byte symbols and the int32 table read once; the int32
    words, the flag bytes and the final states written once) and its chain
    of t steps."""
    from simple_image_compression_network_tpu_torch import _build
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    s, t, n = syms.shape
    tb = cuda_rans.encode_dense_table(lc)
    plan = cuda_rans.dense_plan(s, n, lc.shape[1],
                                tb[2] == cuda_rans.ENC_STAGED,
                                _build.sm_count(lc.device.index))
    syms32 = syms.to(torch.int32)
    out = {"shape": f"S={s} t={t} N={n} L+1={lc.shape[1]}",
           "instance": "staged" if tb[2] == cuda_rans.ENC_STAGED
           else "global",
           "blocks": plan.blocks, "lanes": cuda_rans.DENSE_LANES,
           "streams": plan.streams}
    for key, sy in (("ms", syms), ("ms_int32", syms32)):
        hout = tuple(torch.empty_like(o)
                     for o in cuda_rans.encode_dense(sy, lc))
        for what, g, r in zip(("words", "flags", "final states"),
                              cuda_rans._encode_dense(sy, lc, tb, hout),
                              cuda_rans.encode_dense(sy, lc)):
            require_equal(f"kernel H launched alone {sy.dtype} {what}", g, r)
        out[key] = kernel_ms(lambda: cuda_rans._encode_dense(sy, lc, tb, hout))
    out["wrapper_ms"] = cuda_ms(lambda: cuda_rans.encode_dense(syms, lc), 20)
    out["batch_ms"] = cuda_ms(lambda: cuda_rans.encode_batch(syms, lc), 20)
    out["compact_ms"] = cuda_ms(
        lambda: cuda_rans.encode_batch_compact(syms, lc), 20)
    out["plain"] = (cuda_ms(lambda: cuda_rans.encode_dense_plain(syms, lc), 3)
                    if plain else None)
    out["per_step_us"] = out["ms"] * 1e3 / t
    out["byte_bound"] = ((syms.numel() + 4 * lc.numel()     # syms, table
                          + 5 * syms.numel() + 4 * s * n)   # words, flags,
                         / PEAK_BYTES * 1e3)                # x_fin
    out["chain_bound"] = chain_bound_ms(t)
    out["bound"] = max(out["byte_bound"], out["chain_bound"])
    out["bound_by"] = bound_by(out["byte_bound"], out["chain_bound"])
    log(f"kernel H {out['shape']}: {out['ms']:.4f} ms on the card on int8 "
        f"symbols, {out['ms_int32']:.4f} on int32 ({out['per_step_us']:.3f} "
        f"us a step, {out['per_step_us'] * BOOST_HZ / 1e6:.0f} cycles at the "
        f"boost clock; {plan.blocks} blocks of {cuda_rans.DENSE_LANES} "
        f"lanes x "
        f"{plan.streams} stream(s), "
        f"{out['instance']} instance; {out['bound'] / out['ms']:.1%} of its "
        f"bound {out['bound']:.5f} ({out['bound_by']}; bytes "
        f"{out['byte_bound']:.5f}, chain {out['chain_bound']:.5f})); wrapper "
        f"{out['wrapper_ms']:.4f} ms a call"
        + (f", plain {out['plain']:.3f}" if plain else ""))
    return out


def time_kernels(rng, cdfs, codec, batch: int, dev, errs: dict,
                 launches: dict, layers: dict) -> list:
    """Each kernel at its paths' shapes: kernel, plain version (on the
    card) and bound.  Kernel A's plain version repeats its function, so its
    outputs are compared too.  ``launches`` are the paths' counts;
    ``layers`` the per-layer sums of ``time_layers``."""
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, hyper_codec)
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf, plan_streams)
    from simple_image_compression_network_tpu_torch.ops import cuda_conv

    ms = plain_ms = bound_ms = wrap_ms = packed_ms = mm_ms = 0.0
    for (name, c, n), (gx, gy) in zip(LAYER_FORMS, FORM_GRID):
        xs, w3, bias = conv_inputs(rng, batch, gx, gy, c, n, dev)
        got = cuda_conv.conv3x3_s1_int8(xs, w3, bias)
        ref = cuda_conv.conv3x3_s1_int8_plain(xs, w3, bias)
        errs["conv3x3_s1_int8"] = max(errs["conv3x3_s1_int8"], require_equal(
            f"kernel A {name} full shape", got, ref))
        wp = cuda_conv.pack_conv3x3(w3)
        k = kernel_ms(lambda: cuda_conv._conv3x3(xs, w3, bias, True, False,
                                                 False, wp))
        wrap = cuda_ms(lambda: cuda_conv.conv3x3_s1_int8(xs, w3, bias), 20)
        packed = cuda_ms(lambda: cuda_conv._conv3x3(
            xs, w3, bias, True, False, False, wp), 20)
        p = cuda_ms(lambda: cuda_conv.conv3x3_s1_int8_plain(xs, w3, bias), 3)
        mm = int_mm_ms(batch * gx * gy, 9 * c, n, dev)
        ops = 2 * batch * gx * gy * n * 9 * c
        nbytes = xs.numel() + w3.numel() + n + got.numel()
        bnd = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        log(f"kernel A {name} {batch}x{gx}x{gy}x{c}->{n}: {k:.4f} ms on the "
            f"card ({bnd / k:.1%} of its bound {bnd:.4f} ms, "
            f"{ops / k / 1e9:.1f} TOP/s); the wrapper {wrap:.4f} ms a call "
            f"packing the weights, {packed:.4f} ms prepacked (CUDA events, "
            f"host included); plain {p:.3f} ms; torch._int_mm "
            f"({batch * gx * gy}, {-(-9 * c // 32) * 32}, {n}) {mm:.4f} ms")
        ms, plain_ms, bound_ms = ms + k, plain_ms + p, bound_ms + bnd
        wrap_ms, packed_ms, mm_ms = wrap_ms + wrap, packed_ms + packed, \
            mm_ms + mm
    log(f"kernel A, the default plan's 8 forms: {ms:.4f} ms on the card "
        f"({bound_ms / ms:.1%} of the bound {bound_ms:.4f} ms); wrappers "
        f"{wrap_ms:.4f} ms packing per call, {packed_ms:.4f} ms prepacked; "
        f"torch._int_mm at the same GEMM shapes {mm_ms:.4f} ms")

    # B, C at the int8 latent's shapes (S = 8B, t = 96, N = 384)
    zx, zy = H // 16, W // 16
    s_img, lm = plan_streams(zx * zy)
    s, n = batch * s_img, lm * 192
    t = zx * zy // lm // s_img
    s8, t8, n8 = s, t, n
    lane_cdf = lane_cdf_int8 = np.ascontiguousarray(_lane_cdf(cdfs, n),
                                                    np.int32)
    syms = torch.from_numpy(lane_symbols(rng, lane_cdf, s, t)).to(dev)
    bc = time_rans(cuda_rans.encode_batch_compact, cuda_rans.decode,
                   cuda_rans.encode_batch_compact_plain,
                   cuda_rans.decode_plain, syms,
                   (torch.from_numpy(lane_cdf).to(dev),), t, n, 1, 0)
    # B, C at the hyper-latent's shapes (S = B, t = 48, N = 256)
    s_img, n, t = hyper_codec._plan_lanes((H // 64) * (W // 64), 128)
    lane_cdf = np.ascontiguousarray(codec.z_cdfs[np.arange(n) % 128],
                                    np.int32)
    syms = torch.from_numpy(
        lane_symbols(rng, lane_cdf, batch * s_img, t)).to(dev)
    bc_z = time_rans(cuda_rans.encode_batch_compact, cuda_rans.decode,
                     cuda_rans.encode_batch_compact_plain,
                     cuda_rans.decode_plain, syms,
                     (torch.from_numpy(lane_cdf).to(dev),), t, n, 1, 0)
    # D, E at the hyper y shapes (S = 8B, t = 96, N = 384, table 64 x 257)
    s_img, n, t = hyper_codec._plan_lanes((H // 16) * (W // 16), 192)
    y_table = np.ascontiguousarray(codec.y_cdfs_dev, np.int32)
    syms, ctx = ctx_symbols(rng, y_table, batch * s_img, t, n, 100)
    de = time_rans(cuda_rans.encode_batch_compact_ctx, cuda_rans.decode_ctx,
                   cuda_rans.encode_batch_compact_ctx_plain,
                   cuda_rans.decode_ctx_plain, torch.from_numpy(syms).to(dev),
                   (torch.from_numpy(y_table).to(dev),
                    torch.from_numpy(ctx).to(dev)), t, n, 4, 4)
    # H at the int8 latent's shapes, B = 2 (S = 16) and a serving batch of
    # B = 32 (S = 256), on int8 symbols as the main path gives them
    lc = torch.from_numpy(lane_cdf_int8).to(dev)
    h, h256 = (time_dense(torch.from_numpy(lane_symbols(
        rng, lane_cdf_int8, s, t8)).to(dev), lc, plain=s == s8)
        for s in (s8, 256))
    log(f"kernel H: encode_batch (H, then device_rans.assemble_stream) "
        f"{h['batch_ms']:.4f} ms a call at S={s8}, {h256['batch_ms']:.4f} "
        f"at S=256; encode_batch_compact (kernel B) {h['compact_ms']:.4f} "
        f"and {h256['compact_ms']:.4f} (CUDA events, host included)")
    # the global-memory instance of C, once, at an oversize lane table
    lane_big = np.ascontiguousarray(_lane_cdf(cdfs, 1024), np.int32)
    syms = torch.from_numpy(lane_symbols(rng, lane_big, 2, 96)).to(dev)
    big = time_rans(cuda_rans.encode_batch_compact, cuda_rans.decode,
                    cuda_rans.encode_batch_compact_plain,
                    cuda_rans.decode_plain, syms,
                    (torch.from_numpy(lane_big).to(dev),), 96, 1024, 1, 0)
    for tag, r in (("B, C int8", bc), ("B, C z", bc_z), ("D, E y", de),
                   ("B, C oversize", big)):
        log(f"kernels {tag} {r['shape']}: encode {r['enc_ms']:.4f} ms on the "
            f"card ({r['enc_per_step_us']:.3f} us, "
            f"{r['enc_per_step_us'] * BOOST_HZ / 1e6:.0f} cycles at the boost "
            f"clock, a step; {r['enc_instance']} instance; wrapper "
            f"{r['enc_wrapper_ms']:.4f} ms a call, plain {r['enc_plain']:.3f}, "
            f"bound {r['enc_bound']:.5f} ({r['enc_bound_by']}; bytes "
            f"{r['enc_byte_bound']:.5f}, chain {r['enc_chain_bound']:.5f})), "
            f"decode {r['dec_ms']:.4f} ms on the "
            f"card ({r['per_step_us']:.3f} us a step, {r['instance']} "
            f"instance; wrapper {r['dec_wrapper_ms']:.4f} ms a call, plain "
            f"{r['dec_plain']:.3f}, bound {r['dec_bound']:.5f}); "
            f"{r['n_words']} words")
    for tag, r in (("int8 latent", bc), ("hyper z", bc_z), ("hyper y", de)):
        if r["instance"] != "staged" or r["enc_instance"] == "global":
            raise AssertionError(f"at the {tag} shape the decoder runs its "
                                 f"{r['instance']} instance, the encoder "
                                 f"its {r['enc_instance']}")

    pkg = "simple_image_compression_network_tpu_torch/csrc/"
    ref = "simple_image_compression_network_tpu/"

    def entry(name, source, replaces, err, k, p, bnd, unit, by="bytes",
              counter=None, **extra):
        by_path = launches[counter or name]
        return {"name": name, "route": "cuda", "source": pkg + source,
                "replaces": ref + replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": k, "plain_ms": p, "bound_ms": bnd, "bound_by": by,
                "library_ms": None, "unit": unit, **extra}

    # the cuDNN yardstick of the eight layers: float32 without TF32 is the
    # same function; bf16 is not (a speed aim only)
    lib = {"library_ms": layers["fp32"],
           "library_max_abs_err": layers["lib_err"]["fp32"],
           "library": "torch.nn.functional.conv2d / conv_transpose2d, cuDNN, "
                      "float32 without TF32, channels_last, sum of the 8 "
                      "layers",
           "library_bf16_ms": layers["bf16"],
           "library_bf16_max_abs_err": layers["lib_err"]["bf16"],
           "library_bf16": "the same call in bf16: not the same function, "
                           "a speed aim only"}

    def z_shapes(r, kind):
        return {"shape": r["shape"], "ms": r[f"{kind}_ms"],
                "plain_ms": r[f"{kind}_plain"], "bound_ms": r[f"{kind}_bound"],
                "bound_by": "bytes" if kind == "dec" else r["enc_bound_by"],
                **(decode_keys(r) if kind == "dec" else encode_keys(r))}

    def decode_keys(r):
        return {"per_step_us": r["per_step_us"], "instance": r["instance"],
                "wrapper_ms": r["dec_wrapper_ms"]}

    def encode_keys(r):
        return {"per_step_us": r["enc_per_step_us"],
                "instance": r["enc_instance"],
                "wrapper_ms": r["enc_wrapper_ms"],
                "byte_bound_ms": r["enc_byte_bound"],
                "chain_bound_ms": r["enc_chain_bound"]}
    dec_unit = ("ms on the card (CUDA events behind a spin kernel, a call "
                "that launches the kernel alone); wrapper_ms: CUDA events "
                "around the wrapper, host included")
    enc_unit = (dec_unit + f"; bound_ms: the larger of the byte bound and "
                f"the chain bound, t dependent steps of {CHAIN_CYCLES} "
                f"cycles at {BOOST_HZ / 1e9} GHz (bound_by 'operations')")
    a_path = {k: v for k, v in launches["conv3x3_s1_int8"].items()
              if k != "pallas"}
    return [
        entry("conv3x3_s1_int8 (pallas plan)", "conv3x3_int8.cu",
              "ops/pallas_conv.py:42", errs["conv3x3_s1_int8 (pallas plan)"],
              layers["a"], layers["a_plain"], layers["a_bound"],
              f"kernel A at the pallas plan's 8 layer forms (s2d, d2s; L7 "
              f"d2s with 12 outputs), one launch each, B={batch} 768x512; "
              f"ms on the card (CUDA events behind a spin kernel)",
              by="operations",
              counter="conv3x3_s1_int8 (pallas plan)",
              wrapper_ms=layers["a_wrapper"], int_mm_ms=layers["a_mm"], **lib),
        dict(entry("conv3x3_s1_int8", "conv3x3_int8.cu",
                   "ops/pallas_conv.py:177", errs["conv3x3_s1_int8"],
                   ms, plain_ms, bound_ms,
                   f"sum of the default plan's 8 layer forms, one launch "
                   f"each, B={batch} 768x512; ms on the card "
                   f"(CUDA events behind a spin kernel)", by="operations",
                   wrapper_ms=wrap_ms,
                   prepacked_wrapper_ms=packed_ms, int_mm_ms=mm_ms,
                   new_shapes=layers["new_shapes"]["a"], **lib),
             launches=sum(a_path.values()), launches_by_path=a_path),
        entry("conv_sparse_int8", "conv_sparse_int8.cu",
              "ops/pallas_conv.py:290", errs["conv_sparse_int8"],
              layers["f"], layers["f_plain"], layers["f_bound"],
              f"sum of the 8 layers of the pallas3 plan, one launch each, "
              f"B={batch} 768x512; ms on the card (CUDA events behind "
              f"a spin kernel)",
              by="operations", wrapper_ms=layers["f_wrapper"],
              new_shapes=layers["new_shapes"]["f"], **lib),
        entry("rans_encode_dense", "rans_encode.cu",
              "codec/pallas_rans.py:413", errs["rans_encode_dense"],
              h["ms"], h["plain"], h["bound"],
              f"one launch, {h['shape']} (int8 latent, int8 symbols); "
              f"{enc_unit}", by=h["bound_by"],
              per_step_us=h["per_step_us"], wrapper_ms=h["wrapper_ms"],
              byte_bound_ms=h["byte_bound"],
              chain_bound_ms=h["chain_bound"], int32_ms=h["ms_int32"],
              instance=h["instance"], blocks=h["blocks"], lanes=h["lanes"],
              streams=h["streams"],
              encode_batch_ms=h["batch_ms"],
              encode_batch_compact_ms=h["compact_ms"],
              serving_batch={k: h256[k] for k in (
                  "shape", "ms", "ms_int32", "per_step_us", "wrapper_ms",
                  "batch_ms", "compact_ms", "bound", "bound_by",
                  "byte_bound", "chain_bound", "blocks", "streams")}),
        entry("rans_encode", "rans_encode.cu", "codec/pallas_rans.py:514",
              errs["rans_encode"], bc["enc_ms"], bc["enc_plain"],
              bc["enc_bound"],
              f"one launch, {bc['shape']} (int8 latent); {enc_unit}",
              by=bc["enc_bound_by"], z_shapes=z_shapes(bc_z, "enc"),
              global_instance=z_shapes(big, "enc"), **encode_keys(bc)),
        entry("rans_decode", "rans_decode.cu", "codec/pallas_rans.py:121",
              errs["rans_decode"], bc["dec_ms"], bc["dec_plain"],
              bc["dec_bound"],
              f"one launch, {bc['shape']} (int8 latent); {dec_unit}",
              z_shapes=z_shapes(bc_z, "dec"),
              global_instance=z_shapes(big, "dec"), **decode_keys(bc)),
        entry("rans_encode_ctx", "rans_encode.cu",
              "codec/pallas_rans.py:549", errs["rans_encode_ctx"],
              de["enc_ms"], de["enc_plain"], de["enc_bound"],
              f"one launch, {de['shape']} R=64 (hyper y); {enc_unit}",
              by=de["enc_bound_by"], **encode_keys(de)),
        entry("rans_decode_ctx", "rans_decode.cu",
              "codec/pallas_rans.py:275", errs["rans_decode_ctx"],
              de["dec_ms"], de["dec_plain"], de["dec_bound"],
              f"one launch, {de['shape']} R=64 (hyper y); {dec_unit}",
              **decode_keys(de)),
    ]


CUDNN_FLAGS = {"enabled": True, "benchmark": False, "deterministic": False,
               "allow_tf32": False}


def library_layer(c: dict, ref: torch.Tensor, dtype) -> tuple:
    """One cuDNN call of the layer (``conv2d`` k5/s2/p2, or
    ``conv_transpose2d`` with the flipped kernel for the deconv) on
    ``dtype`` inputs in channels_last, then the wrap epilogue: (ms,
    max |diff| against ``ref``, the layer's exact output).  A yardstick
    of speed only: the port never calls it."""
    import torch.nn.functional as F
    from simple_image_compression_network_tpu_torch.ops import conv_int
    cl = torch.channels_last
    x = c["x"].permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=cl)
    if c["kind"] == "conv":
        w = c["w"].permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=cl)

        def fn():
            return F.conv2d(x, w, stride=2, padding=2)
    else:
        w = (c["w"].flip(1, 2).permute(3, 0, 1, 2).to(dtype)
             .contiguous(memory_format=cl))

        def fn():
            return F.conv_transpose2d(x, w, stride=2, padding=2,
                                      output_padding=1)
    with torch.no_grad(), torch.backends.cudnn.flags(**CUDNN_FLAGS):
        ms = cuda_ms(fn, 20)
        acc = fn().permute(0, 2, 3, 1).to(torch.float64).round()
    out = conv_int.bias_relu_epilogue(acc.to(torch.int64), c["b"])
    return ms, max_abs_err(out, ref)


def time_layers(rng, batch: int, dev) -> dict:
    """Each of the eight layers at 768x512: kernel F (the pallas3 plan)
    beside kernel A's form of the pallas / pallas2 plans, their plain
    versions (on the card), their bounds, and the cuDNN yardstick in bf16
    and in float32 (no TF32).  Returns the sums per kernel."""
    from simple_image_compression_network_tpu_torch.ops import conv_fast
    log(f"cuDNN yardstick: cuDNN {torch.backends.cudnn.version()}, "
        f"{CUDNN_FLAGS}, channels_last; bf16 in and out (cuDNN accumulates "
        f"in float32, the output is rounded to bf16), and float32 in and "
        f"out")
    tot = {k: 0.0 for k in ("f", "f_plain", "f_bound", "f_wrapper", "a",
                            "a_plain", "a_bound", "a_wrapper", "a_mm",
                            "bf16", "fp32")}
    lib_err = {"bf16": 0, "fp32": 0}
    for layer in LAYERS:
        name, kind, (gx, gy), ci, o = layer
        c = layer_case(rng, batch, layer, dev)
        out = run_f(c)
        ref = out if kind == "conv" else conv_fast.depth_to_space(out)
        f_kernel, a_kernel = prepacked(c)
        require_equal(f"kernel F prepacked {name}", f_kernel(), out)
        require_equal(f"kernel A prepacked {name}", a_kernel(), run_a(c))
        k = {"f": kernel_ms(f_kernel),
             "f_wrapper": cuda_ms(lambda: run_f(c), 20),
             "f_plain": cuda_ms(lambda: run_f(c, plain=True), 3),
             "a": kernel_ms(a_kernel),
             "a_wrapper": cuda_ms(lambda: run_a(c), 20),
             "a_plain": cuda_ms(lambda: run_a(c, plain=True), 3)}
        xo, yo = c["xf"].shape[1:3]
        k["a_mm"] = int_mm_ms(batch * xo * yo, 9 * c["w3"].shape[2],
                              c["w3"].shape[3], dev)
        n_out = out.numel()
        f_ops = 2 * batch * xo * yo * o * ci * 25        # the 25 real taps
        f_bytes = (c["xf"].numel() + c["wt"].numel() + c["bf"].numel()
                   + n_out)
        a_ops = 2 * batch * xo * yo * c["w3"].shape[3] * 9 * c["w3"].shape[2]
        a_bytes = (c["xf"].numel() + c["w3"].numel() + c["bf"].numel()
                   + n_out)
        k["f_bound"] = max(f_ops / PEAK_INT8_OPS, f_bytes / PEAK_BYTES) * 1e3
        k["a_bound"] = max(a_ops / PEAK_INT8_OPS, a_bytes / PEAK_BYTES) * 1e3
        for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            k[key], err = library_layer(c, ref, dtype)
            lib_err[key] = max(lib_err[key], err)
            k[key + "_err"] = err
        for key in tot:
            tot[key] += k[key]
        log(f"layer {name} {kind} B={batch} {tuple(c['x'].shape[1:])}->{o}: "
            f"kernel F {k['f']:.4f} ms ({k['f_bound'] / k['f']:.1%} of its "
            f"bound {k['f_bound']:.4f}, {f_ops / k['f'] / 1e9:.1f} TOP/s of "
            f"real taps; wrapper {k['f_wrapper']:.4f}, plain "
            f"{k['f_plain']:.3f}); kernel A {k['a']:.4f} ms "
            f"({k['a_bound'] / k['a']:.1%} of its bound {k['a_bound']:.4f}; "
            f"wrapper {k['a_wrapper']:.4f}, plain {k['a_plain']:.3f}); "
            f"cuDNN float32 {k['fp32']:.4f} ms (max_abs_err "
            f"{k['fp32_err']}), bf16 {k['bf16']:.4f} ms (max_abs_err "
            f"{k['bf16_err']}, not the same function); torch._int_mm at A's "
            f"GEMM shape {k['a_mm']:.4f} ms")
    log(f"layers, sum of 8: kernel F {tot['f']:.4f} ms (wrappers "
        f"{tot['f_wrapper']:.4f}), kernel A (pallas forms) {tot['a']:.4f} ms "
        f"(wrappers {tot['a_wrapper']:.4f}), cuDNN float32 "
        f"{tot['fp32']:.4f} ms, bf16 {tot['bf16']:.4f} ms, torch._int_mm "
        f"{tot['a_mm']:.4f} ms")
    tot["lib_err"] = lib_err
    return tot


def counted():
    """name -> the wrapper that counts that kernel's launches."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.ops import (
        cuda_conv, cuda_deconv)
    return {"conv3x3_s1_int8": cuda_conv.conv3x3_s1_int8,
            "deconv5s2_f32": cuda_deconv.deconv5s2_f32,
            "conv_sparse_int8": cuda_conv.conv_sparse_int8,
            "rans_encode_dense": cuda_rans.encode_dense,
            "rans_encode": cuda_rans.encode_batch_compact,
            "rans_decode": cuda_rans.decode,
            "rans_encode_ctx": cuda_rans.encode_batch_compact_ctx,
            "rans_decode_ctx": cuda_rans.decode_ctx}


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0
        fn.plain_runs = 0


def read_counts(path: str, kernels) -> dict:
    """The launch counts of ``kernels`` right after a path; fails unless
    each launched and no plain version ran."""
    fns = counted()
    counts = {k: fns[k].launches for k in kernels}
    plain = sum(fn.plain_runs for fn in fns.values())
    log(f"launches on the {path} path: {counts}, plain runs: {plain}")
    if min(counts.values()) < 1 or plain:
        raise AssertionError(f"the {path} path did not run on every kernel")
    return counts


def read_exact(path: str, expected: dict) -> dict:
    """As ``read_counts``, but each count must equal ``expected``."""
    fns = counted()
    counts = {k: fns[k].launches for k in expected}
    plain = sum(fn.plain_runs for fn in fns.values())
    log(f"launches on the {path} path: {counts}, plain runs: {plain}")
    if counts != expected or plain:
        raise AssertionError(f"the {path} path launched {counts} with "
                             f"{plain} plain runs, expected {expected}")
    return {k: v for k, v in counts.items() if v}


def main_path(seed: int, batch: int, dev, card: str) -> tuple:
    """compress_batch then decompress_batch at 768x512, checked against the
    golden transform.  Returns the launch counts, read right after, and
    the inputs, weights, net and golden results for the later paths."""
    from simple_image_compression_network_tpu_torch.codec import int_codec
    from simple_image_compression_network_tpu_torch.models import codec_int
    from simple_image_compression_network_tpu_torch.utils import weights_io

    ckpt = os.path.join(ROOT, "checkpoints")
    net = codec_int.IntCodecNet.from_checkpoint(
        os.path.join(ckpt, "reference_weights.npz"), device=dev)
    cdfs = weights_io.load_static_cdfs(os.path.join(ckpt, "latent_cdfs.npz"))
    x = torch.from_numpy(make_images(seed, batch)).to(dev)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    blobs = int_codec.compress_batch(net, x, static_cdfs=cdfs)   # warm-up
    int_codec.decompress_batch(net, blobs, static_cdfs=cdfs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blobs = int_codec.compress_batch(net, x, static_cdfs=cdfs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_hat, z_hat = int_codec.decompress_batch(net, blobs, static_cdfs=cdfs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts("int8", ("conv3x3_s1_int8", "rans_encode",
                                  "rans_decode"))
    mem = torch.cuda.max_memory_allocated()

    # golden: direct 5x5 convs and lhs-dilated deconvs in float64, no kernel
    params = {k: v.to(dev) for k, v in weights_io.params_from_jax(
        weights_io.load_checkpoint(
            os.path.join(ckpt, "reference_weights.npz"))).items()}
    z_ref = codec_int.analysis_int8(params, x, impl=codec_int.GOLDEN_PLAN)
    require_equal("z_hat == analysis_int8(x)", z_hat, z_ref)
    x_ref = codec_int.synthesis_int8(params, z_ref,
                                     impl=codec_int.GOLDEN_PLAN)
    require_equal("x_hat == eight_layers_net(x)", x_hat, x_ref)
    if x_hat.shape != (batch, H, W, 3):
        raise AssertionError(f"x_hat shape {tuple(x_hat.shape)}")
    bad = bytearray(blobs[-1])
    bad[-3] ^= 0xFF
    try:
        int_codec.decompress_batch(net, blobs[:-1] + [bytes(bad)],
                                   static_cdfs=cdfs)
    except ValueError as e:
        log(f"corrupt container rejected: {e}")
    else:
        raise AssertionError("a corrupt container decoded without error")

    n_bytes = sum(len(b) for b in blobs)
    mp = batch * H * W / 1e6
    enc_ms, dec_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    log(f"main path [{card}]: B={batch} 768x512, {n_bytes} container "
        f"bytes, {8 * n_bytes / (batch * H * W)} bpp")
    log(f"main path [{card}]: encode {enc_ms} ms ({mp / (t1 - t0)} MP/s), "
        f"decode {dec_ms} ms ({mp / (t2 - t1)} MP/s), peak device memory "
        f"{mem} bytes; z_hat == golden, x_hat == golden")
    return counts, {"x": x, "params": params, "net": net, "cdfs": cdfs,
                    "z_ref": z_ref, "x_ref": x_ref, "blobs": blobs}


def plans_path(batch: int, golden: dict, card: str) -> dict:
    """``eight_layers_net`` under each plan of ``PLANS``, with
    ``phased=False`` (the golden plan) and tiled under ``pallas3`` at
    768x512: each equal to the golden, with its launch counts read right
    after; then each plan's transform timed beside the default plan's
    ``IntCodecNet`` forward.  Returns the counts by path."""
    from simple_image_compression_network_tpu_torch.models import (
        codec_int, tiled)
    params, x, x_ref = golden["params"], golden["x"], golden["x_ref"]
    counts = {}
    for name, (impl, expected) in PLANS.items():
        reset_counts()
        y = codec_int.eight_layers_net(params, x, impl=impl)
        torch.cuda.synchronize()
        counts[name] = read_exact(name, expected)
        require_equal(f"plan {name}: eight_layers_net == golden", y, x_ref)
    reset_counts()
    y = codec_int.eight_layers_net(params, x, phased=False)
    torch.cuda.synchronize()
    read_exact("phased=False", NO_CONV)
    require_equal("eight_layers_net(phased=False) == golden", y, x_ref)
    reset_counts()
    y = tiled.eight_layers_net_tiled(params, x, TILE_X,
                                     impl=PLANS["pallas3"][0])
    torch.cuda.synchronize()
    n_tiles = -(-H // TILE_X)
    counts["tiled pallas3"] = read_exact(
        "tiled pallas3", {"conv_sparse_int8": 8 * n_tiles,
                          "conv3x3_s1_int8": 0})
    require_equal(f"tiled (tile_x={TILE_X}) == untiled", y, x_ref)
    log(f"plans {', '.join(PLANS)}, phased=False and tiled pallas3 == "
        f"golden at B={batch} 768x512")
    mp = batch * H * W / 1e3        # megapixels per ms -> MP/s
    net = golden["net"]
    for name, (impl, _) in PLANS.items():
        ms = cuda_ms(lambda: codec_int.eight_layers_net(params, x,
                                                        impl=impl), 10)
        log(f"transform [{card}]: plan {name} {ms:.4f} ms ({mp / ms:.1f} "
            f"MP/s; weights rewritten per call, as in the JAX package)")
    ms = cuda_ms(lambda: net(x), 10)
    log(f"transform [{card}]: default plan, IntCodecNet forward {ms:.4f} ms "
        f"({mp / ms:.1f} MP/s)")
    return counts


def dense_encode_path(batch: int, golden: dict) -> dict:
    """``encode_batch`` (kernel H) over the int8 latent of the golden
    analysis, in the int8 codec's stream plan: words and counts equal to
    the compact encoder's (kernel B).  Returns the counts, read right
    after."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf_tensor, plan_streams)
    z = golden["z_ref"]
    b, zx, zy, c = z.shape
    s_img, lm = plan_streams(zx * zy)
    n = lm * c
    syms = z.reshape(b * s_img, zx * zy // lm // s_img, n)
    lane_cdf = _lane_cdf_tensor(golden["cdfs"], n, z.device)
    reset_counts()
    words, counts = cuda_rans.encode_batch(syms, lane_cdf)
    torch.cuda.synchronize()
    launched = read_exact("dense-flag encode", {"rans_encode_dense": 1})
    words_b, counts_b = cuda_rans.encode_batch_compact(syms, lane_cdf)
    require_equal("encode_batch counts == encode_batch_compact's", counts,
                  counts_b)
    for j in range(b * s_img):
        require_equal(f"encode_batch words == encode_batch_compact's, "
                      f"stream {j}", words[j, :counts[j]] & 0xFFFF,
                      words_b[j, :counts_b[j]].to(torch.int64) & 0xFFFF)
    log(f"dense-flag encode of the int8 latent: {b * s_img} streams, "
        f"{int(counts.sum())} words == kernel B's")
    return launched


def native_golden_path(golden: dict, dev) -> None:
    """The port's native C++ golden (g++ build) at B = 1: the L0 conv
    (768x512x3 -> 128) on the first image and the L7 deconv (384x256x128
    -> 3) on its golden L6 activations, each equal to the float64 golden
    and to the layer on kernels A (s2d / d2s) and F (pallas3 / phased)."""
    from simple_image_compression_network_tpu_torch.ops import (
        conv_fast, conv_int, cuda_conv)
    from simple_image_compression_network_tpu_torch.utils import (
        native_golden)
    params = golden["params"]
    t0 = time.perf_counter()
    native_golden.load()
    log(f"native golden g++ build and load: {time.perf_counter() - t0:.1f} s")
    h = golden["z_ref"][:1]
    for i in (4, 5, 6):
        h = conv_int.deconv2d_int8(h, params[f"w{i}"], params[f"b{i}"])
    x0 = conv_int.to_wire_int8(golden["x"][:1])
    for name, layer, x, i, forms in (
            ("L0 conv2d", "conv2d", x0, 0,
             (("float64 golden", conv_int.conv2d_int8),
              ("kernel A s2d", conv_fast.conv2d_int8_s2d),
              ("kernel F pallas3", cuda_conv.conv2d_int8_pallas3))),
            ("L7 deconv2d", "deconv2d", h, 7,
             (("float64 golden", conv_int.deconv2d_int8),
              ("kernel A d2s", conv_fast.deconv2d_int8_d2s),
              ("kernel F phased", conv_int.deconv2d_int8_phased)))):
        w, b = params[f"w{i}"], params[f"b{i}"]
        t0 = time.perf_counter()
        nat = torch.from_numpy(getattr(native_golden, layer)(
            x.cpu().numpy(), w.cpu().numpy(), b.cpu().numpy())).to(dev)
        secs = time.perf_counter() - t0
        for what, fn in forms:
            require_equal(f"native golden {name} == {what}", nat,
                          fn(x, w, b))
        if i == 7:
            require_equal("native golden L7 == x_ref[0]", nat,
                          golden["x_ref"][:1])
        log(f"native golden {name} {tuple(x.shape)} -> {tuple(nat.shape)} "
            f"in {secs:.2f} s on the host == "
            f"{', '.join(f for f, _ in forms)}")


def tmr_path(golden: dict, dev) -> None:
    """``conv2d_int8_tmr`` at the L1 shape (B = 2, 384x256x128 on the L0
    output of the golden, triplicated to 384 outputs) on the card: flag 0
    with no fault; 1 with one replica flipped at one element; 2 with the
    other two replicas made distinct at one element (the vote then takes
    replica a); each vote equal to ``conv2d_int8``.  No kernel runs."""
    from simple_image_compression_network_tpu_torch.ops import conv_int, tmr
    params = golden["params"]
    h = conv_int.conv2d_int8(conv_int.to_wire_int8(golden["x"]),
                             params["w0"], params["b0"])
    w1, b1 = params["w1"], params["b1"]
    clean = conv_int.conv2d_int8(h, w1, b1)
    b, xo, yo, o = clean.shape
    one = torch.zeros((b, xo, yo, 3 * o), dtype=torch.int32, device=dev)
    one[0, xo // 3, yo // 5, 3 * 9 + 1] = 0x40      # replica b, channel 9
    distinct = torch.zeros_like(one)
    distinct[1, xo // 2, yo // 2, 3 * 17 + 1] = 0x11    # replicas b and c,
    distinct[1, xo // 2, yo // 2, 3 * 17 + 2] = 0x22    # channel 17
    reset_counts()
    for what, mask, flag in (("no fault", None, 0), ("one replica", one, 1),
                             ("three distinct", distinct, 2)):
        voted, err = tmr.conv2d_int8_tmr(w1, b1, h, fault_mask=mask)
        if err.device != clean.device or err.dtype != torch.int32 or \
                err.dim() != 0 or int(err) != flag:
            raise AssertionError(f"TMR {what}: flag {err} on {err.device}, "
                                 f"expected {flag}")
        require_equal(f"TMR {what}: vote == conv2d_int8", voted, clean)
        log(f"TMR {what}: flag {int(err)}, vote == conv2d_int8 "
            f"{tuple(voted.shape)}")
    read_exact("TMR", NO_CONV)


def nn_path(rng, dev) -> None:
    """Every function of ``ops/nn.py`` on CUDA tensors of a few hundred kB
    equal, dtype and all, to the same function on the CPU: the integer
    products without CUDA's integer matmul, the pools on int8, the stable
    top-K among ties."""
    from simple_image_compression_network_tpu_torch.ops import nn

    def ints(lo, hi, shape, dtype=np.int8):
        return torch.from_numpy(rng.integers(lo, hi, size=shape)
                                .astype(dtype))
    x8 = ints(-128, 128, (4, 63, 64, 16))
    bits = ints(0, 2, (256, 1024))
    wbits = ints(0, 2, (128, 1024))
    scores = ints(-4, 4, (256, 1000), np.int32)
    cases = [
        ("maxpool2d k3 s2", lambda x: nn.maxpool2d(x, 3, 2), (x8,)),
        ("maxpool2d k2", lambda x: nn.maxpool2d(x, 2), (x8,)),
        ("maxpool1d", lambda x: nn.maxpool1d(x, 4), (x8[:, 0],)),
        ("binary_maxpool2d", lambda x: nn.binary_maxpool2d(x, 2),
         (ints(0, 2, (4, 64, 64, 16), np.uint8),)),
        ("avgpool2d_quant", lambda x: nn.avgpool2d_quant(x, 3, shift=2),
         (x8,)),
        ("accpool", nn.accpool, (x8,)),
        ("relu_batch", nn.relu_batch, (x8,)),
        ("label_select (ties)", lambda x: nn.label_select(x, 37), (scores,)),
        ("depthwise_conv2d_int8", lambda x, w, b: nn.depthwise_conv2d_int8(
            x, w, b, stride=1, padding=1),
         (x8, ints(-8, 8, (16, 3, 3)), ints(-128, 128, (16,)))),
        ("fc_int8", nn.fc_int8, (ints(-128, 128, (256, 1024)),
                                 ints(-8, 8, (128, 1024)),
                                 ints(-128, 128, (128,)))),
        ("fc_int8 no bias", nn.fc_int8, (ints(-128, 128, (256, 1024)),
                                         ints(-8, 8, (128, 1024)))),
        ("threshold_activation", nn.threshold_activation,
         (ints(-300, 300, (4, 64, 64, 16), np.int32),
          torch.sort(ints(-300, 300, (16, 7), np.int32), -1).values)),
        ("channelwise_op add", lambda x, p: nn.channelwise_op(x, p, "add"),
         (x8, ints(-128, 128, (16,)))),
        ("channelwise_op mul", lambda x, p: nn.channelwise_op(x, p, "mul"),
         (x8, ints(-128, 128, (16,)))),
        ("xnor_popcount_fc", nn.xnor_popcount_fc, (bits, wbits)),
        ("binary_fc", nn.binary_fc, (bits, wbits)),
        ("add_streams", nn.add_streams, (x8, ints(-128, 128, x8.shape))),
        ("duplicate_streams", lambda x: nn.duplicate_streams(x)[1], (x8,)),
        ("streaming_cast", lambda x: nn.streaming_cast(x, torch.int16),
         (x8,)),
    ]
    reset_counts()
    for name, fn, args in cases:
        cpu = fn(*args)
        gpu = fn(*(a.to(dev) for a in args))
        if gpu.device.type != dev.type or gpu.dtype != cpu.dtype or \
                not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"ops/nn {name}: the card's result differs "
                                 f"from the CPU's")
    read_exact("ops/nn", NO_CONV)
    log(f"ops/nn: {len(cases)} calls on CUDA tensors == the CPU's, "
        f"dtype and all ({x8.numel()} bytes of int8 activations a call)")


def dump_path(dev) -> None:
    """``utils/dump`` on the card: a dump outside a CUDA graph capture
    writes the tensor (under ``build/``, which .gitignore lists); inside a
    capture it raises before any copy to the host."""
    from simple_image_compression_network_tpu_torch.utils import dump
    x = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    out = os.path.join(ROOT, "build", "chip_smoke_dump")
    dump.enable(out)
    try:
        dump.dump("x", x)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                dump.dump("x", x * 2)
        except RuntimeError as e:
            if "capture" not in str(e):
                raise
        else:
            raise AssertionError("dump inside a CUDA graph capture did not "
                                 "raise")
    finally:
        dump.disable()
    require_equal("dump.load == the dumped tensor",
                  torch.from_numpy(dump.load(out, "x")), x.cpu())
    log(f"dump: {x.numel()} int32 from the card == dump.load; inside a CUDA "
        f"graph capture it raises")


# Kernels F and A alone at the shapes the new plans give them at 768x512
# (per image; the 8 layers' shapes are time_layers'): (name, kernel, input
# grid, input channels, output columns).
NEW_SHAPES = [("F L7 phased, phase (0, 0)", "f", (384, 256), 128, 3),
              ("F L0 gemm, one tap", "f", (384, 256), 108, 128),
              ("F L6 tapn, one tap", "f", (192, 128), 128, 4608),
              ("A L1 s4d", "a", (96, 64), 2048, 512)]


def new_shape_case(rng, batch: int, spec, dev) -> dict:
    """Operands of one ``NEW_SHAPES`` entry, made by the plans' own code:
    the kernel's call with its weights packed ahead (it launches the kernel
    alone), its wrapper's call, its plain version, the operations and bytes
    of the call, and its GEMM shape (M, K, N) for ``torch._int_mm``."""
    from simple_image_compression_network_tpu_torch.ops import (
        conv_fast, cuda_conv)
    name, kernel, (gx, gy), c, n = spec

    def rand(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.integers(lo, hi, size=shape,
                                             dtype=np.int8)).to(dev)
    m, relu = batch * gx * gy, True
    if "phased" in name:        # phase (0, 0) of L7: 9 taps, 3 columns
        x = rand((batch, gx, gy, c), 0)
        taps, wt = cuda_conv.deconv_taps_phases(rand((n, 5, 5, c), -8, 8))[0]
        mm = (m, len(taps) * c, n)
    elif "gemm" in name:        # the s2d patches, K = 108 padded to 112
        x, wt = conv_fast.gemm_operands(rand((batch, 2 * gx, 2 * gy, 3)),
                                        rand((n, 5, 5, 3), -8, 8))
        taps, mm = conv_fast.ONE_TAP, (m, c, n)
    elif "tapn" in name:        # N = 9 taps x 4 phases x 128
        x = rand((batch, gx, gy, c), 0)
        wt = conv_fast.deconv_weights_tapn(rand((n // 36, 5, 5, c), -8,
                                                8))[None]
        taps, mm, relu = conv_fast.ONE_TAP, (m, c, n), False
    else:                       # kernel A over the 4x4 s2d input
        x = rand((batch, gx, gy, c))
        wt = conv_fast.conv_weights_s4d(rand((n // 4, 5, 5, c // 16), -8,
                                             8))
        taps, mm = cuda_conv.DENSE_TAPS, (m, 9 * c, n)
    bias = rand((n,)) if relu else torch.zeros(n, dtype=torch.int8,
                                                device=dev)
    wt = wt.to(dev).contiguous()
    if kernel == "f":
        pk = cuda_conv.pack_taps(wt, taps, 1, x.shape[3])
        calls = (lambda: cuda_conv._conv_sparse(x, wt, bias, taps, 1, relu,
                                                False, False, pk),
                 lambda: cuda_conv.conv_sparse_int8(x, wt, bias, taps, 1,
                                                    relu),
                 lambda: cuda_conv.conv_sparse_int8_plain(x, wt, bias, taps,
                                                          1, relu))
    else:
        wp = cuda_conv.pack_conv3x3(wt)
        calls = (lambda: cuda_conv._conv3x3(x, wt, bias, True, False, False,
                                            wp),
                 lambda: cuda_conv.conv3x3_s1_int8(x, wt, bias),
                 lambda: cuda_conv.conv3x3_s1_int8_plain(x, wt, bias))
    return {"name": name, "kernel": kernel, "calls": calls,
            "ops": 2 * mm[0] * mm[1] * mm[2],
            "bytes": x.numel() + wt.numel() + n + m * n, "mm": mm,
            "shape": f"{tuple(x.shape)} -> {n}, {len(taps)} taps"}


def time_new_shapes(rng, batch: int, dev, errs: dict) -> dict:
    """Each ``NEW_SHAPES`` entry: the kernel against its plain version,
    then timed alone (CUDA events behind a spin kernel, weights packed
    ahead) beside its wrapper, its plain version, its bound and
    ``torch._int_mm`` at its GEMM shape.  Returns the entries by kernel."""
    out = {"f": {}, "a": {}}
    for spec in NEW_SHAPES:
        c = new_shape_case(rng, batch, spec, dev)
        alone, wrapper, plain = c["calls"]
        counter = "conv_sparse_int8" if c["kernel"] == "f" else \
            "conv3x3_s1_int8"
        got = wrapper()
        err = require_equal(f"kernel {c['name']}", got, plain())
        errs[counter] = max(errs[counter], err)
        require_equal(f"kernel {c['name']} prepacked", alone(), got)
        del got
        r = {"shape": c["shape"], "max_abs_err": err, "ms": kernel_ms(alone),
             "wrapper_ms": cuda_ms(wrapper, 20),
             "plain_ms": cuda_ms(plain, 3),
             "int_mm_ms": int_mm_ms(*c["mm"], dev)}
        op_b, byte_b = c["ops"] / PEAK_INT8_OPS, c["bytes"] / PEAK_BYTES
        r["bound_ms"] = max(op_b, byte_b) * 1e3
        r["bound_by"] = "operations" if op_b >= byte_b else "bytes"
        out[c["kernel"]][c["name"]] = r
        log(f"kernel {c['name']} B={batch} {c['shape']}: {r['ms']:.4f} ms "
            f"on the card ({r['bound_ms'] / r['ms']:.1%} of its bound "
            f"{r['bound_ms']:.4f}, by {r['bound_by']}; "
            f"{c['ops'] / r['ms'] / 1e9:.1f} TOP/s); wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.3f}; "
            f"torch._int_mm {c['mm']} {r['int_mm_ms']:.4f} ms")
    return out


def hyper_path(seed: int, batch: int, dev, card: str, codec,
               tag: str = "hyper") -> dict:
    """The scale-hyperprior codec's compress_batch then decompress_batch at
    768x512 (with the trained checkpoint, or ``tag``'s parameters): y_hat
    and z_hat must equal the encoder's integers.  Returns the launch
    counts, read right after."""
    x = torch.from_numpy(make_images(seed + 1, batch)).to(dev)
    x = x.to(torch.float32) / 255.0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    blobs = codec.compress_batch(x)                               # warm-up
    codec.decompress_batch(blobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blobs = codec.compress_batch(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_hat, y_hat, z_hat = codec.decompress_batch(blobs, return_z=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts(tag, ("rans_encode", "rans_decode",
                               "rans_encode_ctx", "rans_decode_ctx"))
    mem = torch.cuda.max_memory_allocated()
    g = counted()["deconv5s2_f32"].launches
    log(f"{tag}: kernel G launches over 2 decoded batches: {g}")
    if g != 2 * 4:
        raise AssertionError(f"{tag}: kernel G launched {g} times over 2 "
                             f"decoded batches, not 4 a batch")

    y, z, _ = codec.encode_parts(x)
    require_equal(f"{tag} y_hat == round(y)", y_hat, y)
    require_equal(f"{tag} z_hat == round(h_a(y))", z_hat, z)
    if x_hat.shape != (batch, H, W, 3) or not bool(
            torch.isfinite(x_hat).all()):
        raise AssertionError(f"{tag} x_hat: shape {tuple(x_hat.shape)} "
                             f"or non-finite values")
    try:
        codec.decompress_batch(blobs[:-1] + [corrupt_y(blobs[-1])])
    except ValueError as e:
        log(f"corrupt {tag} container rejected: {e}")
    else:
        raise AssertionError("a corrupt hyper container decoded without "
                             "error")

    # cuDNN may choose other algorithms for h_s at B = 1: a sigma that moves
    # across a scale-bin edge desyncs the y streams.  Counted, not failed.
    same = 0
    for i, blob in enumerate(blobs):
        try:
            _, y1 = codec.decompress_batch([blob])
            same += int(torch.equal(y1[0], y_hat[i]))
        except ValueError as e:
            log(f"{tag} image {i} decoded alone: {e}")
    log(f"{tag}: {same} of {batch} containers decoded alone give the batch "
        f"decode's y_hat")

    n_bytes = sum(len(b) for b in blobs)
    mse = torch.mean((x_hat.clamp(0, 1) - x) ** 2).item()
    mp = batch * H * W / 1e6
    log(f"{tag} path [{card}]: B={batch} 768x512, {n_bytes} container "
        f"bytes, {8 * n_bytes / (batch * H * W)} bpp, PSNR "
        f"{10 * np.log10(1.0 / mse)} dB")
    log(f"{tag} path [{card}]: encode {(t1 - t0) * 1e3} ms "
        f"({mp / (t1 - t0)} MP/s), decode {(t2 - t1) * 1e3} ms "
        f"({mp / (t2 - t1)} MP/s), peak device memory {mem} bytes; "
        f"y_hat == round(y), z_hat == round(z)")
    return counts


def g_s_inputs(codec, seed: int, batch: int, dev) -> list:
    """(layer, its input) for each of the trained g_s's four transposed
    convs at 768x512: seeded images through g_a, rounded, then through
    g_s, each layer's input taken as the layer is called."""
    model = codec.model
    x = torch.from_numpy(make_images(seed + 3, batch)).to(dev)
    y, _ = model.analysis_arrays(x.to(torch.float32) / 255.0)
    layers = [getattr(model.g_s, f"ConvTranspose_{i}") for i in range(4)]
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].clone())) for m in layers]
    try:
        model.decode_arrays(torch.round(y))
    finally:
        for h in hooks:
            h.remove()
    return list(zip(layers, seen))


def kernel_g_path(codec, seed: int, dev) -> list:
    """Kernel G at g_s's four layers of the trained scale model, B = 8 at
    768x512 (the hyper cell's shapes), each against a float64 golden
    (``conv_transpose2d`` in float64, an independent form) and against its
    plain version on the card; run twice, bitwise equal; each image alone
    bitwise equal to it in the batch.  Tolerance: a float32 sum of n = 9 C
    terms (the most an output phase takes) in any order is within gamma_n
    = n u / (1 - n u) of the sum of the terms' magnitudes (u = 2^-24,
    Higham's bound for recursive summation), and the bias add within u of
    the result; any fixed order passes, a wrong tap or weight does not
    (one term is ~1/n of that sum).  Then its device time per layer
    beside its bound, the plain version's, and cuDNN float32 without TF32,
    deterministic (the dgrad g_s ran on) and not, by CUDA events around 20
    calls (cuDNN's may wait on the host).  Returns one dict a layer."""
    import torch.nn.functional as F
    from simple_image_compression_network_tpu_torch.ops import cuda_deconv

    def flags(det: bool):
        return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                          deterministic=det, allow_tf32=False)

    rows = []
    for i, (layer, x) in enumerate(g_s_inputs(codec, seed, G_BATCH, dev)):
        name = f"ConvTranspose_{i}"
        w, bias = layer.weight, layer.bias
        b, c, h, wd = x.shape
        o = w.shape[1]
        with torch.no_grad():
            before = cuda_deconv.deconv5s2_f32.launches
            got = layer(x)
            if cuda_deconv.deconv5s2_f32.launches != before + 1:
                raise AssertionError(f"g_s.{name} did not launch kernel G")
            require_identical(f"kernel G {name}: two runs", layer(x), got)
            for k in range(b):
                require_identical(f"kernel G {name}: image {k} alone",
                                  layer(x[k:k + 1]), got[k:k + 1])
            pick = cuda_deconv.pick_variant(o)
            packed = cuda_deconv.pack_deconv5s2(w, pick)
            x64, w64 = x.double(), w.double()
            gold = F.conv_transpose2d(x64, w64, bias.double(), stride=2,
                                      padding=1)[..., :-1, :-1]
            mag = F.conv_transpose2d(x64.abs(), w64.abs(), None, stride=2,
                                     padding=1)[..., :-1, :-1]
            n = 9 * c
            tol = n * F32_U / (1 - n * F32_U) * mag + F32_U * gold.abs()
            del mag
            with flags(True):
                plain = cuda_deconv.deconv5s2_f32_plain(x, w, bias)
            g_err = (got.double() - gold).abs()
            p_err = (plain.double() - gold).abs()
            gp = (got.double() - plain.double()).abs()
            row = {"layer": name, "shape": [b, c, h, wd, o],
                   "g_max_abs_err": g_err.max().item(),
                   "g_err_over_tol": (g_err / tol).max().item(),
                   "plain_max_abs_err": p_err.max().item(),
                   "plain_err_over_tol": (p_err / tol).max().item(),
                   "g_minus_plain_over_2tol": (gp / (2 * tol)).max().item()}
            del gold, tol, g_err, p_err, gp, plain
            if max(row["g_err_over_tol"], row["g_minus_plain_over_2tol"]) > 1:
                raise AssertionError(f"kernel G {name}: {row}")
            row["ms"] = kernel_ms(lambda: cuda_deconv._launch(
                x, packed, bias, o, pick))
            row["variant"] = pick
            row["wrapper_ms"] = cuda_ms(lambda: layer(x), 20)
            with flags(True):
                row["plain_ms"] = cuda_ms(
                    lambda: cuda_deconv.deconv5s2_f32_plain(x, w, bias), 3)
                row["cudnn_det_ms"] = cuda_ms(lambda: F.conv_transpose2d(
                    x, w, bias, stride=2, padding=1), 20)
            with flags(False):
                row["cudnn_ms"] = cuda_ms(lambda: F.conv_transpose2d(
                    x, w, bias, stride=2, padding=1), 20)
        flops = 2 * b * h * wd * 25 * c * o
        n_bytes = 4 * (x.numel() + w.numel() + o + got.numel())
        row["bound_ms"] = max(flops / PEAK_F32_OPS,
                              n_bytes / PEAK_BYTES) * 1e3
        row["bound_by"] = ("operations" if flops / PEAK_F32_OPS
                           >= n_bytes / PEAK_BYTES else "bytes")
        log(f"kernel G {name} B={b} {c}->{o} at {h}x{wd}: {row['ms']:.4f} ms "
            f"(variant {pick}; {row['bound_ms'] / row['ms']:.1%} of its "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{flops / row['ms'] / 1e9:.1f} TFLOP/s; wrapper "
            f"{row['wrapper_ms']:.4f}, plain "
            f"{row['plain_ms']:.3f}); cuDNN float32 no TF32 deterministic "
            f"{row['cudnn_det_ms']:.4f} ms, not deterministic "
            f"{row['cudnn_ms']:.4f} ms; max |G - float64| "
            f"{row['g_max_abs_err']:.3g} ({row['g_err_over_tol']:.3g} of the "
            f"bound), plain {row['plain_max_abs_err']:.3g} "
            f"({row['plain_err_over_tol']:.3g}), |G - plain| "
            f"{row['g_minus_plain_over_2tol']:.3g} of twice the bound; two "
            f"runs and each image alone bitwise equal")
        rows.append(row)
    tot = {k: sum(r[k] for r in rows) for k in
           ("ms", "bound_ms", "plain_ms", "cudnn_det_ms", "cudnn_ms")}
    log(f"kernel G, g_s's 4 layers at B={G_BATCH}: {tot['ms']:.4f} ms, "
        f"{tot['bound_ms'] / tot['ms']:.1%} of the bound "
        f"{tot['bound_ms']:.4f}; cuDNN deterministic {tot['cudnn_det_ms']:.4f}"
        f", not deterministic {tot['cudnn_ms']:.4f}; plain "
        f"{tot['plain_ms']:.3f}")
    log(json.dumps({"kernel_g": rows}))
    return rows


def require_identical(what: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Float tensors equal value for value (``require_equal`` compares
    integers)."""
    if a.shape != b.shape or not torch.equal(a, b):
        n = (a != b).sum().item() if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: {n} values differ")


def ties(d: torch.Tensor) -> torch.Tensor:
    """Where d lies within ``TIE`` of a half-integer: round(d) there may
    turn on one ulp of d."""
    return ((d - torch.round(d)).abs() - 0.5).abs() < TIE


def psnr_db(x_hat: torch.Tensor, x: torch.Tensor) -> float:
    mse = torch.mean((x_hat.clamp(0, 1) - x) ** 2).item()
    return float(10 * np.log10(1.0 / mse))


def meanscale_path(seed: int, batch: int, dev, card: str, codec,
                   scale_codec, errs: dict) -> dict:
    """The mean-scale codec's compress_batch then decompress_batch at
    768x512 with the trained checkpoint, on the images of ``hyper_path``.
    Gates: y_hat == symbols + mu value for value and z_hat == round(h_a(y));
    the launches {B 1, C 1, D 1, E 1}; kernels D and E on this model's real
    y symbols and scale-bin rows, and B and C on its z, equal to their plain
    versions; a corrupt container rejected; the serial format on one image
    giving the device format's symbols off the ties of y - mu (counted and
    printed: an ulp of y or mu between the B = 1 and B = 2 programs may
    decide them).  Reported: bytes, bpp and PSNR beside the scale model's, encode
    and decode ms, peak memory.  Returns the launch counts."""
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, escape, hyper_codec)
    x = torch.from_numpy(make_images(seed + 1, batch)).to(dev)
    x = x.to(torch.float32) / 255.0

    torch.cuda.reset_peak_memory_stats()
    codec.decompress_batch(codec.compress_batch(x))              # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    blobs = codec.compress_batch(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_hat, y_hat, z_hat = codec.decompress_batch(blobs, return_z=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_exact("meanscale", HYPER_ROUND)
    mem = torch.cuda.max_memory_allocated()

    sym, z, mu, sigma = codec.encode_arrays(x)
    require_identical("meanscale y_hat == round(y - mu) + mu", y_hat,
                      sym.to(torch.float32) + mu)
    require_equal("meanscale z_hat == round(h_a(y))", z_hat, z)
    if x_hat.shape != (batch, H, W, 3) or not bool(
            torch.isfinite(x_hat).all()):
        raise AssertionError("meanscale x_hat: shape or non-finite values")

    b, yx, yy, yc = sym.shape
    s_y, nl_y, t_y = hyper_codec._plan_lanes(yx * yy, yc)
    ys = escape.to_symbols(sym, hyper_codec._Y_MAX_DEV).reshape(
        b * s_y, t_y, nl_y).contiguous()
    ctx = codec._scale_ctx(sigma).reshape(b * s_y, t_y, nl_y).contiguous()
    n_words = check_rans(
        "kernels D, E on the mean-scale y", cuda_rans.encode_batch_compact_ctx,
        cuda_rans.decode_ctx, cuda_rans.encode_batch_compact_ctx_plain,
        cuda_rans.decode_ctx_plain, ys, (codec._y_table(), ctx), t_y, nl_y,
        errs, ("rans_encode_ctx", "rans_decode_ctx"))
    _, zx, zy, zc = z.shape
    s_z, nl_z, t_z = hyper_codec._plan_lanes(zx * zy, zc)
    zs = escape.to_symbols(z, hyper_codec._Z_MAX).to(torch.int8).reshape(
        b * s_z, t_z, nl_z).contiguous()
    z_words = check_rans(
        "kernels B, C on the mean-scale z", cuda_rans.encode_batch_compact,
        cuda_rans.decode, cuda_rans.encode_batch_compact_plain,
        cuda_rans.decode_plain, zs, (codec._z_lane_cdf(nl_z),), t_z, nl_z,
        errs, ("rans_encode", "rans_decode"))
    rows = int(ctx.unique().numel())
    log(f"meanscale: y_hat == symbols + mu, z_hat == round(h_a(y)); kernels "
        f"D, E == plain on the real y (S={b * s_y} t={t_y} N={nl_y}, "
        f"{rows} of 64 scale-bin rows, {int(n_words.sum())} words; symbols "
        f"in [{int(sym.min())}, {int(sym.max())}]), kernels B, C == plain "
        f"on its z ({int(z_words.sum())} words)")

    try:
        codec.decompress_batch(blobs[:-1] + [corrupt_y(blobs[-1])])
    except ValueError as e:
        log(f"corrupt meanscale container rejected: {e}")
    else:
        raise AssertionError("a corrupt meanscale container decoded")

    x1 = x[:1]
    data = codec.compress(x1)
    _, y_serial = codec.decompress(data)
    sym1, _, mu1, _ = codec.encode_arrays(x1)
    require_identical("meanscale serial y_hat == round(y - mu) + mu",
                      y_serial, sym1.to(torch.float32) + mu1)
    y1, _ = codec.model.analysis_arrays(x1)
    y2, _ = codec.model.analysis_arrays(x)
    tie = ties(y1 - mu1) | ties(y1 - mu[:1]) | ties(y2[:1] - mu[:1])
    off = (sym1 != sym[:1]) & ~tie
    if bool(off.any()):
        raise AssertionError(f"meanscale serial (B=1) symbols differ from "
                             f"the device format's (B=2) at "
                             f"{int(off.sum())} positions off the ties")
    log(f"meanscale serial format (B=1) == the device format's (B=2) "
        f"symbols off the ties: {int(tie.sum())} positions within {TIE} of "
        f"a half, {int((sym1 != sym[:1]).sum())} of them differ; |mu(B=1) - "
        f"mu(B=2)| max {(mu1 - mu[:1]).abs().max().item()}")

    s_blobs = scale_codec.compress_batch(x)
    s_hat, _ = scale_codec.decompress_batch(s_blobs)
    n_bytes, s_bytes = (sum(len(bl) for bl in bs) for bs in (blobs, s_blobs))
    px = batch * H * W
    mp = px / 1e6
    log(f"meanscale path [{card}]: B={batch} 768x512, {n_bytes} container "
        f"bytes, {8 * n_bytes / px} bpp, PSNR {psnr_db(x_hat, x)} dB; the "
        f"scale model on the same images: {s_bytes} bytes, "
        f"{8 * s_bytes / px} bpp, PSNR {psnr_db(s_hat, x)} dB")
    log(f"meanscale path [{card}]: encode {(t1 - t0) * 1e3} ms "
        f"({mp / (t1 - t0)} MP/s), decode {(t2 - t1) * 1e3} ms "
        f"({mp / (t2 - t1)} MP/s), host clock; median of {MEDIAN_CALLS} "
        f"more: encode {median_ms(lambda: codec.compress_batch(x))} ms, "
        f"decode {median_ms(lambda: codec.decompress_batch(blobs))} ms; "
        f"peak device memory {mem} bytes")
    return counts


def bf16_path(seed: int, batch: int, dev, card: str, codecs: dict) -> dict:
    """The bf16 serving path of both hyperpriors, built from the same
    checkpoints as their float32 codecs (``codecs``, by family): one
    counted round each on the images of ``hyper_path``, gated exact (y_hat
    == symbols (+ mu), z_hat == round(h_a(y))) with the launches {B 1, C 1,
    D 1, E 1}.  Reported beside float32: encode, decode and g_s ms, bpp and
    PSNR.  Returns the launch counts by path."""
    x = torch.from_numpy(make_images(seed + 1, batch)).to(dev)
    x = x.to(torch.float32) / 255.0
    px = batch * H * W
    counts = {}
    for family, c32 in codecs.items():
        path = f"bf16 {family}"
        c16 = type(c32).from_checkpoint(CKPTS[family], device=dev,
                                        dtype=torch.bfloat16)
        c16.decompress_batch(c16.compress_batch(x))              # warm-up
        torch.cuda.synchronize()
        reset_counts()
        blobs = c16.compress_batch(x)
        x_hat, y_hat, z_hat = c16.decompress_batch(blobs, return_z=True)
        torch.cuda.synchronize()
        counts[path] = read_exact(path, HYPER_ROUND)
        sym, z, mu, _ = c16.encode_arrays(x)
        require_identical(f"{path} y_hat == symbols (+ mu)", y_hat,
                          sym.to(torch.float32) + (0 if mu is None else mu))
        require_equal(f"{path} z_hat == round(h_a(y))", z_hat, z)
        if x_hat.dtype != torch.float32 or not bool(
                torch.isfinite(x_hat).all()):
            raise AssertionError(f"{path}: x_hat {x_hat.dtype} or "
                                 f"non-finite values")
        b32 = c32.compress_batch(x)
        x32, y32 = c32.decompress_batch(b32)
        p16, p32 = psnr_db(x_hat, x), psnr_db(x32, x)
        n16, n32 = (sum(len(bl) for bl in bs) for bs in (blobs, b32))
        ms = {}
        for name, c, bl, yh in (("bf16", c16, blobs, y_hat),
                                ("float32", c32, b32, y32)):
            ms[name] = (median_ms(lambda: c.compress_batch(x)),
                        median_ms(lambda: c.decompress_batch(bl)),
                        median_ms(lambda: c.model.decode_arrays(yh)),
                        median_ms(lambda: c.model.analysis_arrays(x)),
                        median_ms(lambda: c._prior_from_z(z_hat)))
        log(f"{path}: exact (y_hat == symbols{' + mu' if mu is not None else ''}"
            f", z_hat == round(h_a(y)))")
        log(f"{path} [{card}]: B={batch} 768x512, {n16} container bytes, "
            f"{8 * n16 / px} bpp, PSNR {p16} dB; float32: {n32} bytes, "
            f"{8 * n32 / px} bpp, PSNR {p32} dB; PSNR bf16 - float32 "
            f"{p16 - p32} dB")
        for name, (enc, dec, g_s, g_a, h_s) in ms.items():
            log(f"{path} [{card}]: {name}, median of {MEDIAN_CALLS} (host "
                f"clock): encode {enc} ms, decode {dec} ms; g_s {g_s} ms, "
                f"g_a + h_a {g_a} ms, h_s (image by image) {h_s} ms")
    return counts


def eval_path(card: str) -> dict:
    """``eval_codec.main`` with the argument lists that made
    ``docs/RESULTS.md``'s synthetic rows (4 x 768x512), each with its
    launch counts read right after (the hyper codecs' serial format codes
    on the host: no rANS kernel).  The bit-exact codecs' bpp and PSNR must
    equal the JAX package's ``eval_codec`` on the same argument list to the
    last digit (``JAX_EVAL``); the float codecs' are reported beside their
    rows and the JAX package's digits (``JAX_EVAL_FLOAT``).  Returns the
    counts by path."""
    from simple_image_compression_network_tpu_torch import eval_codec
    counts = {}
    for name, argv, per_image, row in EVAL_RUNS:
        path = f"eval {name}"
        reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = eval_codec.main(["--n-synthetic", "4"] + argv)
        torch.cuda.synchronize()
        counts[path] = read_exact(path, {k: 4 * v
                                         for k, v in per_image.items()})
        got = (res["bpp"], res["psnr"])
        log(f"{path} [{card}]: {out.getvalue().strip()}; docs/RESULTS.md "
            f"(the JAX package's figure): bpp {row[0]}, PSNR {row[1]} dB; "
            f"difference bpp {got[0] - row[0]:+.4f}, PSNR "
            f"{got[1] - row[1]:+.3f} dB")
        if name in JAX_EVAL:
            if got != JAX_EVAL[name]:
                raise AssertionError(f"{path}: bpp, PSNR {got} != the JAX "
                                     f"package's {JAX_EVAL[name]}")
            log(f"{path}: bpp and PSNR == the JAX package's eval_codec "
                f"{JAX_EVAL[name]}")
        else:
            bpp, psnr = JAX_EVAL_FLOAT[name]
            log(f"{path}: the JAX package's eval_codec on a CPU printed bpp "
                f"{bpp}, PSNR {psnr} dB; difference bpp {got[0] - bpp}, "
                f"PSNR {got[1] - psnr} dB")
    return counts


# The training phase: the float RD trainer (train.py, train_loop.py) at
# TrainConfig's defaults, N = 128, M = 192, crop 256, B = 8.
TRAIN_STEPS = {"hyperprior": 40, "meanscale": 10, "factorized": 10}
TRAIN_BLOCK = 20        # steps a block (--log-every) and a checkpoint
TRAIN_DIR = os.path.join(ROOT, "build", "train_smoke")
# one step on the card against the port's CPU step (tests/test_torch_train.py
# holds the CPU step against the JAX package at the same tolerances)
STEP_LOSS_RTOL = 1e-5   # loss, relative
STEP_GRAD_TOL = 1e-3    # each leaf's max |diff| over its max |g|
STEP_TOL, STEP_MAX = 1e-2, 2.0   # the step's change, times lr, where
#                                  |g| >= 1e-3 * (leaf max) / everywhere


def _train_step(cfg, state: dict, batch, noise: dict, dev,
                halves: bool = False) -> tuple:
    """One clip+Adam step from ``state`` on ``dev``: (loss, gradients,
    each parameter's change), on the CPU.  ``make_train_step``, or with
    ``halves`` the same step with its gradient summed over the batch's
    images one at a time (the same function, another summation order)."""
    from simple_image_compression_network_tpu_torch import train
    model = train.build_model(cfg, dev)
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    opt = train.build_optimizer(cfg).init(params)
    grads: list = []
    if halves:
        losses = []
        with train.full_float32():
            for i in range(len(batch)):
                loss = train.rd_loss(model, batch[i:i + 1].to(dev), {
                    k: v[i:i + 1].to(dev) for k, v in noise.items()},
                    cfg.rd_lambda)[0]
                g = torch.autograd.grad(loss, list(params.values()))
                grads = list(g) if not grads else [
                    a + b for a, b in zip(grads, g)]
                losses.append(float(loss.detach()))
        grads = [g / len(batch) for g in grads]
        train.build_optimizer(cfg).update(params, grads, opt)
        loss = float(np.mean(losses))
    else:
        def keep(g, m):
            grads.extend(g)
            return g, m
        loss = float(train.make_train_step(cfg, model, grad_mean=keep)(
            opt, batch.to(dev), {k: v.to(dev) for k, v in noise.items()}
        )["loss"])
    return (loss, {k: g.detach().cpu() for k, g in zip(params, grads)},
            {k: v.detach().cpu() - state[k]
             for k, v in model.state_dict().items()})


def _step_ratios(a: tuple, b: tuple, lr: float) -> tuple:
    """a against b, each as a ratio to its tolerance: (loss, worst
    gradient leaf, the step where b's |g| is large, the step anywhere,
    the worst leaf's name)."""
    loss_r = abs(a[0] - b[0]) / abs(b[0]) / STEP_LOSS_RTOL
    grad = {k: float((a[1][k] - g).abs().max() / g.abs().max())
            / STEP_GRAD_TOL for k, g in b[1].items()}
    step_r = all_r = 0.0
    for k, d in b[2].items():
        g = b[1][k].abs()
        diff = (a[2][k] - d).abs() / lr
        big = g >= 1e-3 * g.max()
        if big.any():
            step_r = max(step_r, float(diff[big].max()) / STEP_TOL)
        all_r = max(all_r, float(diff.max()) / STEP_MAX)
    worst = max(grad, key=grad.get)
    return loss_r, grad[worst], step_r, all_r, worst


def train_step_check(seed: int, dev) -> None:
    """One clip+Adam step at full width (B = 2, crop 256) on the card
    against the same step on the CPU, with one batch of
    ``training_bank(seed)`` and one draw of noise, from two starts:

    * the seeded flax init (``train.init_state``): the loss, every
      gradient leaf and every parameter's change within the tolerances
      above, the CPU tests' (tests/test_torch_train.py, at n = 16, m = 24,
      against the JAX package);
    * the trained scale checkpoint (what users fine-tune): the loss and
      the step anywhere within their tolerances.  Near a trained point
      the rate's gradient in h_a and h_s is float32 residue (tail
      probabilities at their 1e-9 floor, sums that cancel): no two
      implementations need agree there to 1e-3 of a leaf's max.  So the
      gradients and the step where |g| is large are reported, not gated,
      beside the CPU's own spread: the same step with its gradient
      summed image by image."""
    from simple_image_compression_network_tpu_torch import train
    from simple_image_compression_network_tpu_torch.utils import data
    from simple_image_compression_network_tpu_torch.utils import weights_io
    cfg = train.TrainConfig(batch=2)
    batch = torch.from_numpy(data.training_bank(
        cfg.batch, cfg.crop, cfg.crop, seed=seed)).to(torch.float32) / 255.0
    model, _ = train.init_state(cfg, seed, "cpu")
    noise = model.noise_like(batch.shape, torch.Generator().manual_seed(seed))
    starts = {"seeded init": {k: v.detach().clone() for k, v in
                              model.state_dict().items()},
              os.path.basename(HYPER_CKPT): weights_io.hyper_params_from_jax(
                  weights_io.load_hyper_checkpoint(HYPER_CKPT))}
    cpu = torch.device("cpu")
    for name, state in starts.items():
        t0 = time.perf_counter()
        on_card = _train_step(cfg, state, batch, noise, dev)
        t1 = time.perf_counter()
        on_cpu = _train_step(cfg, state, batch, noise, cpu)
        t2 = time.perf_counter()
        r = _step_ratios(on_card, on_cpu, cfg.lr)
        line = (f"train step from {name}, card against CPU (B=2 crop 256, "
                f"N=128 M=192): loss {on_card[0]} / {on_cpu[0]}; ratios to "
                f"the tolerances: loss {r[0]:.4f}, worst gradient leaf "
                f"{r[1]:.4f} ({r[4]}), step where |g| is large {r[2]:.4f}, "
                f"step anywhere {r[3]:.4f}; {t1 - t0:.3f} s on the card "
                f"(cuDNN's choices included), {t2 - t1:.3f} s on the CPU")
        limit = (1.0, 1.0, 1.0, 1.0)
        if name != "seeded init":
            own = _step_ratios(_train_step(cfg, state, batch, noise, cpu,
                                           halves=True), on_cpu, cfg.lr)
            line += (f"; the CPU's own spread (image by image against the "
                     f"batch): loss {own[0]:.4f}, gradient leaf "
                     f"{own[1]:.4f} ({own[4]}), step where |g| is large "
                     f"{own[2]:.4f}, step anywhere {own[3]:.4f}")
            limit = (1.0, float("inf"), float("inf"), 1.0)
        log(line)
        if any(x > lim for x, lim in zip(r[:4], limit)):
            raise AssertionError(f"the card's train step from {name} differs"
                                 f" from the CPU's beyond {limit}")


def _losses(text: str) -> list:
    return [float(v) for v in re.findall(r"  loss (\S+)  ", text)]


def train_loop_path(seed: int, card: str) -> str:
    """``train_loop.main`` for each model from init at TrainConfig's
    defaults (blocks of 20, a checkpoint every 20), the scale model for 40
    steps and resumed to 60, the others for 10.  Returns the scale model's
    ckpt_40."""
    from simple_image_compression_network_tpu_torch import train, train_loop
    from simple_image_compression_network_tpu_torch.utils import train_ckpt
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    for kind, steps in TRAIN_STEPS.items():
        d = os.path.join(TRAIN_DIR, kind)
        argv = ["--model", kind, "--steps", str(steps), "--seed", str(seed),
                "--log-every", str(min(TRAIN_BLOCK, steps)), "--ckpt-every",
                str(TRAIN_BLOCK), "--ckpt-dir", d]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            params = train_loop.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        text = out.getvalue()
        log(text.rstrip())
        losses = _losses(text)
        if (len(losses) != -(-steps // TRAIN_BLOCK)
                or not np.isfinite(losses).all()):
            raise AssertionError(f"train_loop {kind}: losses {losses}")
        files = sorted(os.listdir(d))
        want = sorted({f"ckpt_{s}.msgpack" for s in
                       range(TRAIN_BLOCK, steps + 1, TRAIN_BLOCK)}
                      | {f"ckpt_{steps}.msgpack"})
        if files != want:
            raise AssertionError(f"train_loop {kind}: wrote {files}")
        log(f"train_loop {kind} [{card}]: {steps} steps from init in "
            f"{dt:.3f} s (bank, build and cuDNN's first choices included), "
            f"losses finite, wrote {files}")
        if kind != "hyperprior":
            continue
        last = os.path.join(d, f"ckpt_{steps}.msgpack")
        model, opt = train.init_state(train.TrainConfig(), 0, "cpu")
        step, saved, _ = train_ckpt.restore(last, model.state_dict(), opt)
        if step != steps or any(not torch.equal(saved[k], v.cpu())
                                for k, v in params.items()):
            raise AssertionError("restore of the saved checkpoint differs "
                                 "from the parameters saved")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_loop.main(argv[:2] + ["--steps", str(steps + TRAIN_BLOCK)]
                            + argv[4:])
        text = out.getvalue()
        log(text.rstrip())
        if (f"resumed from {last} at step {steps}" not in text
                or f"step {steps + TRAIN_BLOCK:6d}  loss" not in text
                or not np.isfinite(_losses(text)).all()):
            raise AssertionError("train_loop did not resume from "
                                 f"{last} to step {steps + TRAIN_BLOCK}")
        log(f"train_loop {kind}: restore == the saved parameters (bitwise);"
            f" resumed from ckpt_{steps} at step {steps}, ended at "
            f"{steps + TRAIN_BLOCK}")
    return os.path.join(TRAIN_DIR, "hyperprior",
                        f"ckpt_{TRAIN_STEPS['hyperprior']}.msgpack")


def _timed(fn) -> float:
    """Median host ms of 5 synchronized calls of ``fn``."""
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def train_block_path(seed: int, dev, card: str) -> None:
    """Each model's block of 20 steps at TrainConfig's defaults after a
    first block: no host sync inside it (``set_sync_debug_mode("error")``),
    its steps/s, ms a step and peak device memory; and the scale model's
    step by stage (forward, backward, clip+Adam)."""
    from torch.utils.flop_counter import FlopCounterMode

    from simple_image_compression_network_tpu_torch import train
    from simple_image_compression_network_tpu_torch.utils import data
    bank = torch.from_numpy(data.training_bank(48, 512, 512, seed=seed)).to(
        dev)
    for kind in TRAIN_STEPS:
        cfg = train.TrainConfig(model=kind)
        model, opt = train.init_state(cfg, seed, dev)
        block = train.make_train_block(cfg, model)
        block(opt, bank, seed, 0, TRAIN_BLOCK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = block(opt, bank, seed, TRAIN_BLOCK, TRAIN_BLOCK)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        m = {k: float(v) for k, v in m.items()}
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"train block {kind}: metrics {m}")
        log(f"train block {kind} [{card}]: B={cfg.batch} crop {cfg.crop} "
            f"N={cfg.n} M={cfg.m}, {TRAIN_BLOCK} steps after a first block:"
            f" {TRAIN_BLOCK / dt} steps/s, {dt * 1e3 / TRAIN_BLOCK} ms a "
            f"step (host clock to the synchronize; {(t1 - t0) * 1e3} ms to "
            f"queue the block), peak device memory {peak} bytes; no host "
            f"sync inside the block (sync debug mode error); mean loss "
            f"{m['loss']}, bpp {m['bpp']}, PSNR {m['psnr']} dB")
        if kind != "hyperprior":
            continue
        gen = train.step_generator(torch.Generator(device=dev), seed, 0)
        batch = train.device_random_crops(bank, cfg.crop, cfg.batch, gen)
        noise = model.noise_like(batch.shape, gen)
        params = dict(model.named_parameters())
        leaves = list(params.values())
        tx = train.build_optimizer(cfg)
        held = {}

        def fwd():
            with train.full_float32():
                held["loss"] = train.rd_loss(model, batch, noise,
                                             cfg.rd_lambda)[0]

        def bwd():
            fwd()
            with train.full_float32():
                held["grads"] = list(torch.autograd.grad(held["loss"],
                                                         leaves))

        def upd():
            tx.update(params, held["grads"], opt)
        f_ms = _timed(fwd)
        fb_ms = _timed(bwd)
        u_ms = _timed(upd)
        with FlopCounterMode(display=False) as flops:
            bwd()
        bound_ms = flops.get_total_flops() / FP32_FLOPS * 1e3
        log(f"train step by stage, {kind} [{card}] (median of 5, each "
            f"synchronized): forward and loss {f_ms} ms, backward "
            f"{fb_ms - f_ms} ms (forward + backward {fb_ms}), clip + Adam "
            f"{u_ms} ms over {len(leaves)} tensors; the step's convolutions"
            f" and products {flops.get_total_flops() / 1e9} GFLOP "
            f"(FlopCounterMode), bound {bound_ms} ms at 67 TFLOP/s float32"
            f" (data sheet): the block's step at "
            f"{100 * bound_ms / (dt * 1e3 / TRAIN_BLOCK):.1f}% of it")


def train_eval_path(ckpt: str, seed: int, batch: int, dev, card: str) -> dict:
    """``eval_codec.main`` on the training checkpoint (serial format, on
    the host), then its parameters served in the device format through
    ``hyper_path`` (kernels B, D to encode, C, E to decode).  Returns that
    path's launch counts."""
    from simple_image_compression_network_tpu_torch import eval_codec
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = eval_codec.main(["--codec", "hyperprior", "--ckpt", ckpt,
                               "--n-synthetic", "2"])
    log(f"eval hyperprior --ckpt {os.path.basename(ckpt)} [{card}]: "
        f"{out.getvalue().strip()}; every container decoded; bpp "
        f"{res['bpp']}, PSNR {res['psnr']} dB")
    read_exact("eval of the training checkpoint", _SERIAL)
    codec = eval_codec._hyper_codec("hyperprior", ckpt, dev)
    return hyper_path(seed, batch, dev, card, codec,
                      tag="trained hyper")


def train_dp_path(seed: int, card: str) -> None:
    """``train_loop --dp 2``: two gloo ranks sharing the card, 2 steps at
    B = 2 (one image a rank); ``main`` raises unless both ranks end with
    bitwise-equal parameters."""
    from simple_image_compression_network_tpu_torch import train_loop
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        params = train_loop.main(["--dp", "2", "--batch", "2", "--steps",
                                  "2", "--log-every", "1", "--seed",
                                  str(seed)])
    dt = time.perf_counter() - t0
    text = out.getvalue()
    log(text.rstrip())
    if not all(f"rank {r} of 2 (gloo)" in text for r in range(2)) or not all(
            bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError("train_loop --dp 2 did not report both ranks")
    log(f"train_loop --dp 2 [{card}]: two gloo ranks time-sliced on one "
        f"card, 2 steps at B=2 crop 256: the ranks' parameters bitwise "
        f"equal; {dt:.3f} s from spawn to results")


# The integer wrap-STE training phase (intnet.py, train_intnet.py) at the
# JAX package's defaults: the reference net's widths, crop 256, B = 8.
INTNET_DIR = os.path.join(ROOT, "build", "intnet_smoke")
INTNET_CROP, INTNET_B = 256, 8      # IntNetTrainConfig's defaults
INTNET_BLOCK = 10       # timed steps a block, after a first block of 2
INTNET_STEPS = {"float": 4, "clip": 4, "wrap": 4}   # steps a phase
INTNET_A = {"float": 0, "clip": 0, "wrap": 8}       # kernel A a step
INTNET_CDF_A = 8 * 4    # the static CDFs: 8 images through 4 layers
SP_STEPS = 2
SP_CROP = 256


def _intnet_net():
    from simple_image_compression_network_tpu_torch.config import (
        reference_net_for_input)
    return reference_net_for_input(INTNET_CROP, INTNET_CROP)


def _intnet_cfg(**kw):
    from simple_image_compression_network_tpu_torch import intnet
    return intnet.IntNetTrainConfig(crop=INTNET_CROP, batch=INTNET_B, **kw)


def _intnet_batch(seed: int, b: int) -> torch.Tensor:
    """(B, crop, crop, 3) float32 ints in [0, 255]: the bank's images."""
    from simple_image_compression_network_tpu_torch.utils import data
    return torch.from_numpy(data.training_bank(
        b, INTNET_CROP, INTNET_CROP, seed=seed)).to(torch.float32)


def intnet_layers_check(seed: int, dev) -> None:
    """Per layer at B = 8, crop 256, the seeded init in wrap mode: the
    float accumulator ``acc_f`` (cuDNN float32 without TF32, training's
    flags) holds exact integers, equal to the float64 golden accumulator
    plus the bias, and ``relu(wrap(round(acc_f)))`` equals kernel A's
    output bitwise (the gradient mask and the value of ``intnet._layer``
    come from these two)."""
    from simple_image_compression_network_tpu_torch import intnet, train
    from simple_image_compression_network_tpu_torch.ops import (
        conv_fast, conv_int)
    net = _intnet_net()
    cfg = _intnet_cfg()
    params = intnet.init_params(cfg, torch.Generator().manual_seed(seed),
                                net, dev)
    h = torch.floor(_intnet_batch(seed, cfg.batch).to(dev) / 2.0)
    for i, layer in enumerate(net.layers):
        wq = intnet.ste_round_clip(params[f"w{i}"], -8.0, 7.0)
        bq = intnet.ste_round_clip(params[f"b{i}"], -128.0, 127.0)
        with train.full_float32():
            acc_f = intnet._acc_f(h, wq, layer.transposed) + bq
        acc_b = torch.round(acc_f).to(torch.int64)
        if not torch.equal(acc_b.to(torch.float32), acc_f):
            raise AssertionError(f"intnet L{i}: acc_f holds non-integers")
        xi = conv_int.to_wire_int8(h.to(torch.uint8))
        wi, bi = wq.to(torch.int8), bq.to(torch.int8)
        acc = (conv_int.deconv2d_int8_acc(xi, wi) if layer.transposed
               else conv_int.conv2d_int8_acc(xi, wi))
        require_equal(f"intnet L{i}: round(acc_f) == golden acc + b", acc_b,
                      acc + bi.to(torch.int64))
        form = (conv_fast.deconv2d_int8_d2s if layer.transposed
                else conv_fast.conv2d_int8_s2d)
        y = form(xi, wi, bi)
        want = torch.clamp_min(conv_int.wrap_to_int8(acc_b), 0)
        require_equal(f"intnet L{i}: kernel A == relu(wrap(round(acc_f)))",
                      y, want)
        wraps = int(((acc_b < -128) | (acc_b > 127)).sum())
        log(f"intnet L{i} ({tuple(h.shape)} -> {tuple(y.shape)}): acc_f "
            f"exact integers == the float64 golden accumulator + b; kernel "
            f"A == relu(wrap(round(acc_f))) bitwise; {wraps} of "
            f"{acc_b.numel()} accumulators outside the 8-bit window")
        h = y.to(torch.float32)


def _intnet_step(cfg, net, start: dict, batch: torch.Tensor, dev) -> tuple:
    """One step of ``cfg``'s mode from ``start`` on ``dev``: (loss,
    gradients, each parameter's change, x_hat), on the CPU."""
    from simple_image_compression_network_tpu_torch import intnet, train
    params = {k: v.to(dev).clone().requires_grad_(True)
              for k, v in start.items()}
    tx = intnet.build_optimizer(cfg)
    with train.full_float32():
        loss, _ = intnet.loss_fn(params, batch.to(dev), cfg, net)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        x_hat = intnet.forward(params, torch.floor(batch.to(dev) / 2.0),
                               net, mode=cfg.mode)[0].detach().cpu()
    tx.update(params, grads, tx.init(params))
    return (float(loss.detach()),
            {k: g.detach().cpu() for k, g in zip(params, grads)},
            {k: params[k].detach().cpu() - v for k, v in start.items()},
            x_hat)


def _ent_grads(ent: dict, z: torch.Tensor, n_pix: int, dtype, dev,
               per_sample: bool = False) -> dict:
    """The gradient of bits(z) / n_pix with respect to the entropy model's
    leaves ``ent`` (names without ``intnet.ENT``), in ``dtype`` on
    ``dev``, returned on the CPU.  With ``per_sample``, each latent
    position's term of that sum instead, on a leading axis."""
    from torch.func import functional_call, grad, vmap
    from simple_image_compression_network_tpu_torch import intnet
    mod = intnet._entropy(z.shape[-1], intnet.IntNetTrainConfig
                          .ent_init_scale)
    leaves = {k: v.to(dev, dtype) for k, v in ent.items()}
    zz = z.to(dev, dtype)

    def bpp(q, y):
        return functional_call(mod, q, (y,)) / n_pix
    if per_sample:
        got = vmap(grad(bpp), in_dims=(None, 0))(
            leaves, zz.reshape(-1, z.shape[-1]))
    else:
        got = grad(bpp)(leaves, zz)
    return {k: v.cpu() for k, v in got.items()}


def _ent_likelihood(ent: dict, z: torch.Tensor, dtype, dev
                    ) -> torch.Tensor:
    """The entropy model's likelihood of each latent symbol, in ``dtype``
    on ``dev``, returned on the CPU."""
    from simple_image_compression_network_tpu_torch import intnet
    from simple_image_compression_network_tpu_torch.codec.entropy import (
        FactorizedEntropy)
    mod = FactorizedEntropy(z.shape[-1], init_scale=intnet.IntNetTrainConfig
                            .ent_init_scale).to(dev, dtype)
    mod.load_state_dict(ent)
    with torch.no_grad():
        return mod.likelihood(z.to(dev, dtype)).cpu()


def _ent_grads64(cfg, net, start: dict, batch: torch.Tensor) -> dict:
    """The entropy model's gradient of the loss in float64 on the CPU (the
    loss reaches those leaves through the rate of z alone; z is the same
    integers on both devices)."""
    from simple_image_compression_network_tpu_torch import intnet
    with torch.no_grad():
        z = intnet.forward(start, torch.floor(batch / 2.0), net,
                           mode=cfg.mode)[1]
    ent = {k[len(intnet.ENT):]: v for k, v in start.items()
           if k.startswith(intnet.ENT)}
    n_pix = batch.shape[0] * batch.shape[1] * batch.shape[2]
    return {intnet.ENT + k: g.float() for k, g in _ent_grads(
        ent, z, n_pix, torch.float64, torch.device("cpu")).items()}


def _leaf_ratios(a: dict, b: dict, tol: float) -> dict:
    """Each leaf of ``b`` present: max |a - b| over b's max |g|, over
    ``tol``."""
    return {k: float((a[k] - g).abs().max() / g.abs().max()) / tol
            for k, g in b.items() if g.abs().max() > 0}


ENT_GRAD_TOL = 1e-2     # the entropy model's leaves against float64
ENT_SEEDS = 8           # draws of init and batch in ent_grad_spread


def matmul_grad_error(dev, same_sign: bool = False) -> tuple:
    """The gradient of ``torch.matmul(h, x)`` with respect to h at the
    entropy model's shapes (C = 192, h 3 x 3, x 3 x 512: the product its
    H1 and H2 take their gradient through, a sum over 512 samples) in
    float32 on ``dev`` and on the CPU: each one's max |error| against
    float64 over the float64 result's max.  With ``same_sign``, x and the
    output's gradient are |N(0, 1)|, so every term of the sums is
    positive, as in the entropy model's sums over positions."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn((192, 3, 3), generator=g)
    x = torch.randn((192, 3, 512), generator=g)
    gy = torch.randn((192, 3, 512), generator=g)
    if same_sign:
        x, gy = x.abs(), gy.abs()
    ref = torch.einsum("cin,cjn->cij", gy.double(), x.double())
    out = []
    for d in (dev, torch.device("cpu")):
        hd = h.to(d).requires_grad_(True)
        got = torch.autograd.grad(torch.sum(torch.matmul(hd, x.to(d))
                                            * gy.to(d)), hd)[0]
        out.append(float((got.cpu().double() - ref).abs().max()
                         / ref.abs().max()))
    return tuple(out)


def intnet_step_check(seed: int, dev) -> None:
    """One wrap step and one clip step at B = 2, crop 256 on the card
    against the same step on the CPU (kernel A's plain version there),
    from the seeded init: x_hat bitwise; the loss, the step where |g| is
    large, the step anywhere (``STEP_*``) and every gradient leaf of the
    net and its display (``STEP_GRAD_TOL`` of the leaf's max) within the
    float trainer's tolerances (tests/test_torch_intnet.py holds the CPU
    against the JAX package).  The entropy model's gradient sums over the
    latent's samples with heavy cancellation in its H1 and H2: both
    devices' float32 gradients are held against float64 instead, within
    ``ENT_GRAD_TOL`` of the leaf's max (the CPU's own error printed
    beside the card's)."""
    from simple_image_compression_network_tpu_torch import intnet
    net = _intnet_net()
    start = intnet.init_params(_intnet_cfg(),
                               torch.Generator().manual_seed(seed), net,
                               "cpu")
    batch = _intnet_batch(seed + 1, 2)
    err = matmul_grad_error(dev)
    pos = matmul_grad_error(dev, same_sign=True)
    log(f"float32 gradient of matmul(h, x) with respect to h (192 x 3 x 3 "
        f"by 3 x 512) against float64: card {err[0]:.3g}, CPU "
        f"{err[1]:.3g} of the result's max; with terms of one sign card "
        f"{pos[0]:.3g}, CPU {pos[1]:.3g} (TF32 for matmul: "
        f"{torch.backends.cuda.matmul.allow_tf32}, precision "
        f"{torch.get_float32_matmul_precision()})")
    for mode in ("wrap", "clip"):
        cfg = intnet.IntNetTrainConfig(mode=mode, crop=INTNET_CROP,
                                       batch=2)
        t0 = time.perf_counter()
        card = _intnet_step(cfg, net, start, batch, dev)
        t1 = time.perf_counter()
        cpu = _intnet_step(cfg, net, start, batch, torch.device("cpu"))
        t2 = time.perf_counter()
        require_identical(f"intnet {mode} x_hat, card == CPU", card[3],
                          cpu[3])
        r = _step_ratios(card[:3], cpu[:3], cfg.lr)
        net_leaves = _leaf_ratios(card[1], {
            k: g for k, g in cpu[1].items()
            if not k.startswith(intnet.ENT)}, STEP_GRAD_TOL)
        worst = max(net_leaves, key=net_leaves.get)
        g64 = _ent_grads64(cfg, net, start, batch)
        c64 = _leaf_ratios(card[1], g64, ENT_GRAD_TOL)
        p64 = _leaf_ratios(cpu[1], g64, ENT_GRAD_TOL)
        vs_cpu = _leaf_ratios(card[1], {k: cpu[1][k] for k in g64},
                              STEP_GRAD_TOL)
        log(f"intnet {mode} step from the seeded init, card against CPU "
            f"(B=2 crop {INTNET_CROP}): x_hat bitwise equal; loss {card[0]} "
            f"/ {cpu[0]}; ratios to the tolerances: loss {r[0]:.4f}, worst "
            f"gradient leaf of the net {net_leaves[worst]:.4f} ({worst}), "
            f"step where |g| is large {r[2]:.4f}, step anywhere "
            f"{r[3]:.4f}; the entropy model's leaves against float64, card "
            f"/ CPU: " + ", ".join(f"{k[len(intnet.ENT):]} {c64[k]:.4f} / "
                                   f"{p64[k]:.4f}" for k in g64)
            + "; the card's against the CPU's, to the net's tolerance: "
            + ", ".join(f"{k[len(intnet.ENT):]} {v:.4f}"
                        for k, v in vs_cpu.items())
            + f"; {t1 - t0:.3f} s on the card, {t2 - t1:.3f} s on the CPU")
        if max([r[0], r[2], r[3], net_leaves[worst]]
               + list(c64.values()) + list(p64.values())) > 1.0:
            raise AssertionError(f"the card's intnet {mode} step differs "
                                 f"from the CPU's beyond the tolerances")


def _ent_branch_grads(ent: dict, z: torch.Tensor, n_pix: int, dtype,
                      dev) -> dict:
    """The gradient of bits(z) / n_pix with respect to the entropy model's
    leaves through each of its two CDF evaluations apart ("lo" at z - 1/2,
    "hi" at z + 1/2; the gradient is their sum), in ``dtype`` on ``dev``,
    returned on the CPU."""
    from simple_image_compression_network_tpu_torch import intnet
    from simple_image_compression_network_tpu_torch.codec.entropy import (
        FactorizedEntropy)
    mod = FactorizedEntropy(z.shape[-1], init_scale=intnet.IntNetTrainConfig
                            .ent_init_scale).to(dev, dtype)
    mod.load_state_dict(ent)
    outs = []

    def logits(x, f=mod._logits_cdf):
        outs.append(f(x))
        return outs[-1]
    mod._logits_cdf = logits            # likelihood calls it at lo, then hi
    bits = mod(z.to(dev, dtype)) / n_pix
    names, leaves = zip(*mod.named_parameters())
    res = {}
    for tag, out, g in zip(("lo", "hi"), outs, torch.autograd.grad(
            bits, outs, retain_graph=True)):
        res[tag] = {k: v.cpu() for k, v in zip(names, torch.autograd.grad(
            out, leaves, grad_outputs=g, retain_graph=True))}
    return res


def ent_grad_spread(seed: int, dev) -> None:
    """The entropy model's float32 gradient against float64 over
    ``ENT_SEEDS`` draws (seeded init, a B = 2 crop-256 batch, z from the
    wrap and the clip forward on the card), on the card and on the CPU,
    with its sources apart.  Per leaf, each relative to the float64
    gradient's max: ``err``, the float32 gradient's max |error|;
    ``terms``, the error of the float32 per-position terms summed in
    float64 (the elementwise forward and backward without the sum over
    positions); ``cancel``, the float64 terms' max sum of |term| (how far
    the sum over positions cancels); ``sum``, the float32 gradient against
    the same float32 terms summed in float64 (the error of the sums over
    positions alone); ``p``, the float32 likelihood's max relative error
    (a difference of two sigmoids).  The likelihood evaluates the CDF
    twice (at z -/+ 1/2), and each evaluation's gradient is a sum over
    positions of its own: ``kappa``, the float64 gradient through one
    evaluation ("hi", ``_ent_branch_grads``) over the whole gradient, max
    to max, says how far adding the two cancels, so how far it magnifies
    the error of each evaluation's sum.  Every ``err`` must lie within
    ``ENT_GRAD_TOL``."""
    from simple_image_compression_network_tpu_torch import intnet
    net = _intnet_net()
    cpu = torch.device("cpu")
    worst = {}
    for s in range(seed, seed + ENT_SEEDS):
        start = intnet.init_params(_intnet_cfg(),
                                   torch.Generator().manual_seed(s), net,
                                   "cpu")
        batch = _intnet_batch(s + 1, 2)
        ent = {k[len(intnet.ENT):]: v for k, v in start.items()
               if k.startswith(intnet.ENT)}
        n_pix = batch.shape[0] * batch.shape[1] * batch.shape[2]
        for mode in ("wrap", "clip"):
            with torch.no_grad():
                z = intnet.forward({k: v.to(dev) for k, v in start.items()},
                                   torch.floor(batch.to(dev) / 2.0), net,
                                   mode=mode)[1].cpu()
            g64 = _ent_grads(ent, z, n_pix, torch.float64, cpu)
            t64 = _ent_grads(ent, z, n_pix, torch.float64, cpu,
                             per_sample=True)
            b64 = _ent_branch_grads(ent, z, n_pix, torch.float64, cpu)
            cancel = {k: float(t64[k].abs().sum(0).max() / g.abs().max())
                      for k, g in g64.items()}
            kappa = {k: float(b64["hi"][k].abs().max() / g.abs().max())
                     for k, g in g64.items()}
            p64 = _ent_likelihood(ent, z, torch.float64, cpu)
            parts = []
            for name, d in (("card", dev), ("CPU", cpu)):
                g32 = _ent_grads(ent, z, n_pix, torch.float32, d)
                t32 = _ent_grads(ent, z, n_pix, torch.float32, d,
                                 per_sample=True)
                err = {k: float((g32[k].double() - g).abs().max()
                                / g.abs().max()) for k, g in g64.items()}
                terms = {k: float((t32[k].double().sum(0) - g).abs().max()
                                  / g.abs().max()) for k, g in g64.items()}
                sums = {k: float((g32[k].double() - t32[k].double().sum(0))
                                 .abs().max() / g.abs().max())
                        for k, g in g64.items()}
                lik = _ent_likelihood(ent, z, torch.float32, d).double()
                p_err = float(((lik - p64) / p64).abs().max())
                k = max(err, key=err.get)
                worst[name, mode] = max(worst.get((name, mode), 0.0), err[k])
                parts.append(
                    f"{name} err {err[k]:.3g} ({k}), terms {terms[k]:.3g}, "
                    f"sum {sums[k]:.3g}; H1 {err['H1']:.3g} / "
                    f"{terms['H1']:.3g} / {sums['H1']:.3g}, H2 "
                    f"{err['H2']:.3g} / {terms['H2']:.3g} / "
                    f"{sums['H2']:.3g}; p {p_err:.3g}")
                if max(err.values()) > ENT_GRAD_TOL:
                    raise AssertionError(
                        f"entropy model's float32 gradient on the {name}, "
                        f"seed {s}, {mode}: {err} of the leaf max, limit "
                        f"{ENT_GRAD_TOL}")
            log(f"entropy gradient seed {s} {mode}: " + "; ".join(parts)
                + f"; cancel H1 {cancel['H1']:.3g}, H2 {cancel['H2']:.3g}, "
                f"largest {max(cancel.values()):.3g} "
                f"({max(cancel, key=cancel.get)}); kappa H1 "
                f"{kappa['H1']:.3g}, H2 {kappa['H2']:.3g}, largest "
                f"{max(kappa.values()):.3g} ({max(kappa, key=kappa.get)})")
    log(f"entropy gradient over {ENT_SEEDS} seeds, largest error of the "
        f"leaf max (limit {ENT_GRAD_TOL}): " + ", ".join(
            f"{name} {mode} {v:.3g}" for (name, mode), v in worst.items()))


def intnet_block_path(seed: int, dev, card: str) -> dict:
    """A block of ``INTNET_BLOCK`` steps in each mode at B = 8, crop 256
    after a first block: ms a step, kernel A's launches a step (8 in wrap
    mode, 0 otherwise: the value path), peak device memory.  Returns the
    wrap block's launch counts."""
    from simple_image_compression_network_tpu_torch import intnet
    from simple_image_compression_network_tpu_torch.utils import data
    net = _intnet_net()
    bank = torch.from_numpy(data.training_bank(48, 512, 512, seed=seed)
                            ).to(dev)
    counts = {}
    for mode in ("float", "clip", "wrap"):
        cfg = _intnet_cfg(mode=mode)
        params = intnet.init_params(cfg, torch.Generator().manual_seed(seed),
                                    net, dev)
        block = intnet.make_train_block(cfg, net)
        opt = block.tx.init(params)
        block(params, opt, bank, seed, 0, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m = block(params, opt, bank, seed, 2, INTNET_BLOCK)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = read_exact(f"intnet {mode} block", {
            "conv3x3_s1_int8": INTNET_A[mode] * INTNET_BLOCK,
            "conv_sparse_int8": 0})
        if mode == "wrap":
            counts = got
        m = {k: float(v) for k, v in m.items()}
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"intnet block {mode}: metrics {m}")
        log(f"intnet block {mode} [{card}]: B={cfg.batch} crop {cfg.crop}, "
            f"{INTNET_BLOCK} steps after a first block: "
            f"{dt * 1e3 / INTNET_BLOCK} ms a step ({INTNET_BLOCK / dt} "
            f"steps/s, host clock to the synchronize), kernel A "
            f"{INTNET_A[mode]} launches a step, peak device memory {peak} "
            f"bytes; mean loss {m['loss']}, bpp {m['bpp']}, PSNR "
            f"{m['psnr']} dB, oob {m['oob']}")
    return counts


def train_intnet_path(seed: int, card: str) -> tuple:
    """``train_intnet.main`` at its defaults (crop 256, B = 8) for a few
    steps a phase into a temporary directory, from init (float, clip,
    wrap) and from the haar422 construction with its structure frozen
    (an entropy warm-up, then wrap); each run's kernel A launches gated
    (8 a wrap or warm-up step, 32 for the static CDFs; the float and clip
    steps launch none).  Returns the first run's outputs and the launch
    counts of both."""
    from simple_image_compression_network_tpu_torch import (
        intnet_haar, train_intnet)
    shutil.rmtree(INTNET_DIR, ignore_errors=True)
    steps = [f"--float-steps={INTNET_STEPS['float']}",
             f"--pretrain={INTNET_STEPS['clip']}",
             f"--steps={INTNET_STEPS['wrap']}"]
    runs = {"train_intnet": (steps + ["--log-every", "2"],
                             INTNET_STEPS["wrap"]),
            "train_intnet haar422": (
                ["--init-haar", "haar422", "--freeze-structure",
                 "--ent-warmup", "2", "--steps", "4", "--log-every", "2"],
                2 + 4)}
    counts, outs = {}, {}
    size = [f"--crop={INTNET_CROP}", f"--batch={INTNET_B}"]
    for name, (argv, a_steps) in runs.items():
        d = os.path.join(INTNET_DIR, name.replace(" ", "_"))
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            params = train_intnet.main(argv + size + [
                "--seed", str(seed), "--out-dir", d])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        text = out.getvalue()
        log(text.rstrip())
        counts[name] = read_exact(name, {
            "conv3x3_s1_int8": 8 * a_steps + INTNET_CDF_A,
            "conv_sparse_int8": 0})
        losses = _losses(text)
        if not losses or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: losses {losses}")
        files = sorted(os.listdir(d))
        if files != ["intnet_cdfs.npz", "intnet_trained.msgpack",
                     "intnet_trained.npz"]:
            raise AssertionError(f"{name}: wrote {files}")
        ints = dict(np.load(os.path.join(d, "intnet_trained.npz")))
        if name.endswith("haar422"):
            from simple_image_compression_network_tpu_torch.config import (
                reference_net_for_input)
            hp = intnet_haar.haar_params(
                reference_net_for_input(INTNET_CROP, INTNET_CROP),
                det2_keep=(0, 1, 2, 3, 4, 6, 7))
            for k, v in hp.items():
                if not k.startswith("disp") and not np.array_equal(
                        ints[k][v != 0], v[v != 0]):
                    raise AssertionError(f"{name}: {k}'s structure moved")
        log(f"{name} [{card}]: {dt:.3f} s (bank, phases and the CDFs' "
            f"fit), losses finite, wrote {files}"
            + ("; the construction's nonzero taps unchanged"
               if name.endswith("haar422") else ""))
        outs[name] = (d, params)
    return outs["train_intnet"], counts


def intnet_codec_path(run: tuple, seed: int, batch: int, dev,
                      card: str) -> dict:
    """The exported weights and their static CDFs served by ``int_codec``
    (kernels A, B, C) on B 768x512 images of the >> 1 wire the net was
    trained on: x_hat and z equal to the float64 golden transform; the
    shadow file read back equal to the returned shadows."""
    from simple_image_compression_network_tpu_torch import intnet
    from simple_image_compression_network_tpu_torch.codec import int_codec
    from simple_image_compression_network_tpu_torch.models import codec_int
    from simple_image_compression_network_tpu_torch.utils import (
        train_ckpt, weights_io)
    d, shadows = run
    back = train_ckpt.restore_params(
        os.path.join(d, "intnet_trained.msgpack"),
        {k: v.cpu() for k, v in shadows.items()},
        to_jax=intnet.intnet_params_to_jax,
        from_jax=intnet.intnet_params_from_jax)
    if any(not torch.equal(v, shadows[k].cpu()) for k, v in back.items()):
        raise AssertionError("the shadow file differs from the shadows")
    ints = dict(np.load(os.path.join(d, "intnet_trained.npz")))
    cdfs = weights_io.load_static_cdfs(os.path.join(d, "intnet_cdfs.npz"))
    params = weights_io.params_from_jax(
        {k: v for k, v in ints.items() if not k.startswith("disp")})
    net = codec_int.IntCodecNet(params, device=dev)
    imgs = make_images(seed + 3, batch)
    x = torch.from_numpy(imgs // 2).to(dev)
    reset_counts()
    t0 = time.perf_counter()
    blobs = int_codec.compress_batch(net, x, static_cdfs=cdfs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_hat, z_hat = int_codec.decompress_batch(net, blobs, static_cdfs=cdfs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_exact("trained int8", {"conv3x3_s1_int8": 8,
                                         "rans_encode": 1, "rans_decode": 1})
    gold = {k: v.to(dev) for k, v in params.items()}
    z_ref = codec_int.analysis_int8(gold, x, impl=codec_int.GOLDEN_PLAN)
    require_equal("trained int8 z_hat == golden", z_hat, z_ref)
    require_equal("trained int8 x_hat == golden eight_layers_net", x_hat,
                  codec_int.synthesis_int8(gold, z_ref,
                                           impl=codec_int.GOLDEN_PLAN))
    n_bytes = sum(len(b) for b in blobs)
    disp = (ints["disp_a"] * x_hat.cpu().numpy().astype(np.float64)
            + ints["disp_b"])
    mse = np.mean((np.clip(np.round(disp), 0, 255) - imgs) ** 2)
    log(f"trained int8 [{card}]: B={batch} 768x512 (>> 1 wire), "
        f"{n_bytes} container bytes, {8 * n_bytes / (batch * H * W)} bpp, "
        f"PSNR {10 * np.log10(255.0 ** 2 / mse)} dB after a few steps; "
        f"encode {(t1 - t0) * 1e3} ms, decode {(t2 - t1) * 1e3} ms; x_hat "
        f"and z == the float64 golden; shadows read back bitwise")
    return counts


def train_sp_path(seed: int, dev, card: str) -> None:
    """``train_loop --sp 2`` (the scale hyperprior, crop 256, B = 2): two
    ranks, gloo on one card (NCCL with a card each), each on its 128 rows
    with halos that carry gradients back; ``main`` raises unless both end
    bitwise equal.  Against one process on the same crops and noise: each
    parameter within the ``--dp`` tolerance of the CPU tests (2e-2 * lr
    where both steps' |g| >= 1e-2 * leaf max, 4 * lr everywhere)."""
    from simple_image_compression_network_tpu_torch import train, train_loop
    from simple_image_compression_network_tpu_torch.utils import data
    crop, batch = SP_CROP, 2
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        got = train_loop.main(["--sp", "2", "--batch", str(batch), "--steps",
                               str(SP_STEPS), "--log-every", "1", "--seed",
                               str(seed), "--bank", "1f", "--crop",
                               str(crop)])
    dt = time.perf_counter() - t0
    text = out.getvalue()
    log(text.rstrip())
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    if not all(f"rank {r} of 2 ({backend})" in text for r in range(2)):
        raise AssertionError("train_loop --sp 2 did not report both ranks")
    cfg = train.TrainConfig(batch=batch, crop=crop)
    model, opt = train.init_state(cfg, seed, dev)
    seen = []

    def keep(grads, metrics):
        seen.append([g.abs() for g in grads])
        return grads, metrics
    step_fn = train.make_train_step(cfg, model, grad_mean=keep)
    images = data.synthetic_images(16, 512, 512, seed=seed)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    for step in range(SP_STEPS):
        crops = torch.from_numpy(data.random_crops(images, crop, batch, rng))
        noise = model.noise_like(crops.shape,
                                 train.step_generator(gen, seed, step))
        step_fn(opt, crops.to(dev), noise)
    worst_big = worst_all = 0.0
    for i, (k, want) in enumerate(model.state_dict().items()):
        big = torch.ones_like(want, dtype=torch.bool)
        for g in seen:
            big &= g[i] >= 1e-2 * g[i].max()
        diff = (got[k].to(dev) - want).abs() / (SP_STEPS * cfg.lr)
        worst_all = max(worst_all, float(diff.max()) / 2.0)
        if big.any():
            worst_big = max(worst_big, float(diff[big].max()) / 1e-2)
    log(f"train_loop --sp 2 [{card}]: two {backend} ranks, crop {crop} "
        f"cut into two tiles of {crop // 2} rows, {SP_STEPS} steps at "
        f"B={batch}: the "
        f"ranks' parameters bitwise equal; against one process on the same "
        f"crops and noise, ratios to the --dp tolerance: where |g| is large "
        f"{worst_big:.4f}, anywhere {worst_all:.4f}; {dt:.3f} s from spawn "
        f"to results")
    if max(worst_big, worst_all) > 1.0:
        raise AssertionError("train_loop --sp 2 differs from one process")


def _pack_fields(fields: np.ndarray, wbit: int) -> list:
    """(..., SIMD) signed fields -> ap_uint<SIMD*WBIT> words, field i in
    bits [i*WBIT, (i+1)*WBIT)."""
    flat = fields.reshape(-1, fields.shape[-1]).astype(np.int64) & (
        (1 << wbit) - 1)
    shifts = np.arange(flat.shape[1], dtype=np.int64) * wbit
    return [int(w) for w in (flat << shifts).sum(axis=1)]


def header_round_trip(card: str) -> None:
    """``reference_weights.npz`` packed into a ``memdata_nonsquare.h`` in
    the fold layout of ``config.py``'s PE / SIMD / TILES, read back by
    ``weights_io.load_reference_params``: equal to the npz."""
    from simple_image_compression_network_tpu_torch.config import (
        REFERENCE_NET)
    from simple_image_compression_network_tpu_torch.utils import weights_io
    params = weights_io.load_checkpoint(
        os.path.join(ROOT, "checkpoints", "reference_weights.npz"))
    parts = []
    for i, layer in enumerate(REFERENCE_NET.layers):
        w = params[f"w{i}"]
        fold = np.stack([w[pe::layer.pe].transpose(0, 2, 1, 3)
                         for pe in range(layer.pe)]).reshape(
                             layer.pe, -1, layer.simd)
        for name, simd, wbit, pe, tiles, words in (
                (f"weights_layer{i}", layer.simd, layer.w_bits, layer.pe,
                 fold.shape[1], _pack_fields(fold, layer.w_bits)),
                (f"bias_layer{i}", 1, 8, 1, layer.out_ch,
                 _pack_fields(params[f"b{i}"][:, None], 8))):
            body = ",\n".join("{" + ",".join(hex(v) for v in words[
                p * tiles:(p + 1) * tiles]) + "}" for p in range(pe))
            parts.append(f"static FixedPointWeights<{simd}, ap_int<{wbit}>, "
                         f"{pe}, {tiles}> {name} = {{{{\n{body}\n}}}};\n")
    os.makedirs(INTNET_DIR, exist_ok=True)
    path = os.path.join(INTNET_DIR, "memdata_nonsquare.h")
    with open(path, "w") as f:
        f.write("".join(parts))
    t0 = time.perf_counter()
    got = weights_io.load_reference_params(path)
    dt = time.perf_counter() - t0
    for k, v in params.items():
        if got[k].dtype != np.int8 or not np.array_equal(got[k], v):
            raise AssertionError(f"header round trip: {k} differs")
    log(f"header round trip [{card}]: reference_weights.npz packed into a "
        f"{os.path.getsize(path)}-byte memdata_nonsquare.h (16 "
        f"declarations) and parsed back equal in {dt:.3f} s")


# The sharded phase: ranks are processes sharing the one card over gloo
# (NCCL refuses two ranks on one card), so their times are time-sliced,
# not multi-chip scaling.
SHARDED_RANKS = (1, 2, 4)
SHARDED_TIMEOUT_S = 300
SHARDED_CALLS = 5       # timed calls of each direction, each after a barrier
# launches of one direction on each rank: kernel A a layer, B or C once
SHARDED_ENC = {"conv3x3_s1_int8": 4, "conv_sparse_int8": 0,
               "rans_encode": 1, "rans_decode": 0}
SHARDED_DEC = {"conv3x3_s1_int8": 4, "conv_sparse_int8": 0,
               "rans_encode": 0, "rans_decode": 1}
# eight_layers_net_sharded on a (2, 2) mesh: launches on each rank
MESH_2D = {"s2d": (None, {"conv3x3_s1_int8": 8, "conv_sparse_int8": 0}),
           "pallas3": (PLANS["pallas3"][0],
                       {"conv3x3_s1_int8": 0, "conv_sparse_int8": 8})}


def rank_counts(expected: dict) -> dict:
    """This rank's launch counts of ``expected``'s kernels and its plain
    runs of every kernel."""
    fns = counted()
    return {"launches": {k: fns[k].launches for k in expected},
            "plain": sum(fn.plain_runs for fn in fns.values())}


def rank_ms(fn) -> float:
    """Median host ms of ``fn`` over ``SHARDED_CALLS`` calls, each started
    after a barrier of every rank on an idle card, ending in a
    synchronize."""
    from simple_image_compression_network_tpu_torch.parallel import (
        distributed)
    times = []
    for _ in range(SHARDED_CALLS):
        torch.cuda.synchronize()
        distributed.barrier("timing", timeout_s=60)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def gloo_cuda_probe() -> dict:
    """Which gloo collectives take CUDA tensors in this build (a report:
    the port moves every message of a gloo mesh through host memory)."""
    import torch.distributed as dist
    t = torch.ones(4, device="cuda")
    calls = {"all_reduce": lambda: dist.all_reduce(t),
             "all_gather": lambda: dist.all_gather(
                 [torch.empty_like(t) for _ in range(dist.get_world_size())],
                 t)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except RuntimeError as e:
            out[name] = f"raises {str(e).splitlines()[0][:80]}"
    return out


def sharded_rank(seed: int, batch: int, hyper_blobs: dict) -> dict:
    """One rank of the sharded phase (``spawn_ranks``): ShardedIntCodec on
    a 1-D mesh of every rank at 768x512 (a warm-up round, then a counted
    round, each direction's launches, routes and staged halo bytes read
    right after it; the timed calls; a corrupt container), and on 4 ranks
    ``eight_layers_net_sharded`` on a (2, 2) mesh under the default plan
    and pallas3; then ``sharded_hyper_rank`` with the single-device hyper
    containers ``hyper_blobs``, in the same process.  Returns host objects
    only; rank 0 also the gathered tiles."""
    import torch.distributed as dist
    from simple_image_compression_network_tpu_torch.models import codec_int
    from simple_image_compression_network_tpu_torch.parallel import (
        entropy_sharded, mesh as meshlib, spatial)
    from simple_image_compression_network_tpu_torch.utils import weights_io
    n, rank = dist.get_world_size(), dist.get_rank()
    ckpt = os.path.join(ROOT, "checkpoints")
    mesh = meshlib.spatial_mesh(n)
    net = codec_int.IntCodecNet.from_checkpoint(
        os.path.join(ckpt, "reference_weights.npz"), device=mesh.device)
    codec = entropy_sharded.ShardedIntCodec(
        net, weights_io.load_static_cdfs(os.path.join(ckpt,
                                                      "latent_cdfs.npz")),
        mesh)
    x = torch.from_numpy(make_images(seed, batch)).to(mesh.device)
    codec.decompress_batch(codec.compress_batch(x))           # warm-up
    torch.cuda.synchronize()
    codec.routes.update(sharded=0, fallback=0)
    out = {"rank": rank, "device": str(mesh.device)}
    for direction, expected in (("encode", SHARDED_ENC),
                                ("decode", SHARDED_DEC)):
        reset_counts()
        spatial.halo_exchange.staged_bytes = 0
        if direction == "encode":
            blobs = codec.compress_batch(x)
        else:
            x_hat, z = codec.decompress_batch(blobs)
        torch.cuda.synchronize()
        out[direction] = {**rank_counts(expected),
                          "staged": spatial.halo_exchange.staged_bytes}
    out["routes"] = dict(codec.routes)
    out["blobs"] = blobs
    out["tile"] = tuple(x_hat.shape)
    x_full = spatial.gather_image(x_hat, mesh).cpu().numpy()
    z_full = spatial.gather_image(z, mesh).cpu().numpy()
    if rank == 0:
        out["x_hat"], out["z"] = x_full, z_full
    out["encode_ms"] = rank_ms(lambda: codec.compress_batch(x))
    out["decode_ms"] = rank_ms(lambda: codec.decompress_batch(blobs))
    bad = bytearray(blobs[-1])
    bad[-3] ^= 0xFF
    try:
        codec.decompress_batch(blobs[:-1] + [bytes(bad)])
        out["corrupt"] = None
    except ValueError as e:
        out["corrupt"] = str(e)
    if n == 4:
        mesh2 = meshlib.make_mesh((2, 2), ("x", "y"))
        params = {k: v.to(mesh2.device) for k, v in
                  weights_io.params_from_jax(weights_io.load_checkpoint(
                      os.path.join(ckpt, "reference_weights.npz"))).items()}
        tile = spatial.shard_image(x, mesh2, ("x", "y"))
        for name, (impl, expected) in MESH_2D.items():
            reset_counts()
            y = spatial.eight_layers_net_sharded(params, tile, mesh2,
                                                 axis_names=("x", "y"),
                                                 impl=impl)
            torch.cuda.synchronize()
            out[f"2x2 {name}"] = rank_counts(expected)
            y = spatial.gather_image(y, mesh2, ("x", "y")).cpu().numpy()
            if rank == 0:
                out[f"2x2 {name}"]["x_hat"] = y
    if n == 2 and mesh.backend == "gloo":
        out["gloo"] = gloo_cuda_probe()
    out["hyper"] = sharded_hyper_rank(seed, batch, hyper_blobs)
    return out


def check_rank(n: int, res: dict, golden_blobs: list, backend: str) -> None:
    """One rank's gates: both directions on the sharded route with the
    expected launches and no plain run, the main path's containers, the
    corrupt container raised, and under NCCL no byte staged through the
    host."""
    tag = f"sharded ({backend}), {n} rank(s), rank {res['rank']}"
    if backend == "nccl" and (res["encode"]["staged"]
                              or res["decode"]["staged"]):
        raise AssertionError(f"{tag}: NCCL messages staged through the "
                             f"host")
    if res["routes"] != {"sharded": 2, "fallback": 0}:
        raise AssertionError(f"{tag}: routes {res['routes']}")
    for direction, expected in (("encode", SHARDED_ENC),
                                ("decode", SHARDED_DEC)):
        got = res[direction]
        if got["launches"] != expected or got["plain"]:
            raise AssertionError(f"{tag} {direction}: launches "
                                 f"{got['launches']}, plain runs "
                                 f"{got['plain']}; expected {expected}")
    if res["blobs"] != golden_blobs:
        raise AssertionError(f"{tag}: containers differ from the main "
                             f"path's (single-device compress_batch)")
    if res["corrupt"] != "corrupt stream in sharded decode":
        raise AssertionError(f"{tag}: corrupt container gave "
                             f"{res['corrupt']!r}")


def sharded_path(seed: int, batch: int, golden: dict, hyper_codecs: dict,
                 card: str, backend: str = "gloo",
                 sizes=SHARDED_RANKS) -> dict:
    """The spatially sharded int8 codec at 768x512 on ``sizes`` ranks
    (``spawn_ranks``; under gloo every rank on this card, under NCCL rank
    r on card r; the kernels already built): on every rank the sharded
    route in both directions, kernel A a layer, B once an encode, C once a
    decode, no plain run, the main path's containers byte for byte, a
    corrupt container raised; the gathered x_hat and z equal to the golden
    and to ``IntCodecNet``; on 4 ranks the (2, 2) mesh under the default
    plan (A) and pallas3 (F) equal to the golden.  The same ranks then run
    the sharded hyper cases against ``hyper_codecs``, the single-device
    codecs by model (``sharded_hyper_rank``, ``check_hyper_group``).
    Returns the launches by path, summed over ranks."""
    from simple_image_compression_network_tpu_torch.parallel import (
        distributed)
    x_ref = golden["x_ref"].cpu()
    z_ref = golden["z_ref"].cpu()
    net_ref = golden["net"](golden["x"]).cpu()
    require_equal("IntCodecNet forward == golden", net_ref, x_ref)
    hyper = hyper_golden(seed, batch, hyper_codecs)
    from simple_image_compression_network_tpu_torch.codec import hyper_codec
    c16 = hyper_codec.HyperCodec.from_checkpoint(
        HYPER_CKPT, device=hyper_codecs["scale"].device, dtype=torch.bfloat16)
    x16 = torch.from_numpy(hyper_images(seed, batch)).to(c16.device)
    blobs16 = c16.compress_batch(x16)
    x16_hat, y16_hat = c16.decompress_batch(blobs16)
    gold16 = {"blobs": blobs16, "x_hat": x16_hat, "y_hat": y16_hat}
    counts, ms, hyper_ms = {}, {}, {}
    for n in sizes:
        t0 = time.perf_counter()
        ranks = distributed.spawn_ranks(
            sharded_rank, n, backend=backend, timeout_s=SHARDED_TIMEOUT_S,
            args=(seed, batch, {**{f: g["blobs"] for f, g in hyper.items()},
                                "bf16 scale": blobs16}))
        wall = time.perf_counter() - t0
        for res in ranks:
            check_rank(n, res, golden["blobs"], backend)
        require_equal(f"sharded {n}: gathered x_hat == golden",
                      torch.from_numpy(ranks[0]["x_hat"]), x_ref)
        require_equal(f"sharded {n}: gathered z == golden",
                      torch.from_numpy(ranks[0]["z"]), z_ref)
        counts[f"sharded {backend} {n}"] = {
            k: sum(r[d]["launches"][k] for r in ranks
                   for d in ("encode", "decode"))
            for k in ("conv3x3_s1_int8", "rans_encode", "rans_decode")}
        ms[n] = (ranks[0]["encode_ms"], ranks[0]["decode_ms"])
        staged = [(r["encode"]["staged"], r["decode"]["staged"])
                  for r in ranks]
        log(f"sharded ({backend}) {n} rank(s): routes {ranks[0]['routes']} "
            f"on every rank, launches a rank encode "
            f"{ranks[0]['encode']['launches']}"
            f", decode {ranks[0]['decode']['launches']}, plain runs 0; "
            f"containers == the main path's; x_hat, z gathered from tiles "
            f"{ranks[0]['tile']} == golden, == IntCodecNet; corrupt "
            f"container raised on every rank; spawn to results {wall:.1f} s")
        log(f"sharded ({backend}) {n} rank(s): halo bytes staged through "
            f"the host a pass (encode, decode) by rank: {staged}")
        if "gloo" in ranks[0]:
            log(f"gloo collectives on CUDA tensors: {ranks[0]['gloo']}")
        if n == 4:
            for name, (_, expected) in MESH_2D.items():
                for res in ranks:
                    got = res[f"2x2 {name}"]
                    if got["launches"] != expected or got["plain"]:
                        raise AssertionError(
                            f"(2, 2) mesh {name}, rank {res['rank']}: "
                            f"launches {got['launches']}, plain runs "
                            f"{got['plain']}; expected {expected}")
                require_equal(f"(2, 2) mesh {name}: gathered x_hat == golden",
                              torch.from_numpy(ranks[0][f"2x2 {name}"]
                                               ["x_hat"]), x_ref)
                counts[f"sharded {backend} 2x2 {name}"] = {
                    k: v * 4 for k, v in expected.items()}
                log(f"eight_layers_net_sharded on a (2, 2) mesh, {name}: "
                    f"launches a rank {expected}, plain runs 0; x_hat == "
                    f"golden")
        got, hyper_ms[n] = check_hyper_group(
            n, [r["hyper"] for r in ranks], hyper, hyper_codecs, backend)
        counts.update(got)
        if n <= 2:
            counts[f"sharded bf16 scale {backend} {n}"] = check_bf16_group(
                n, [r["hyper"] for r in ranks], c16, gold16, backend)
    where = ("ranks time-sliced on one card (gloo)" if backend == "gloo"
             else f"a card a rank ({backend})")
    for n, (enc, dec) in ms.items():
        log(f"sharded [{card}] {n} rank(s), {where}: encode {enc:.4f} ms, "
            f"decode {dec:.4f} ms at B={batch} "
            f"{H}x{W} (rank 0's host clock, median of {SHARDED_CALLS} "
            f"calls, each after a barrier)")
    for n, by_fam in hyper_ms.items():
        for fam, (enc, dec, hs) in by_fam.items():
            g = hyper[fam]
            log(f"sharded {fam} [{card}] {n} rank(s), {where}: encode "
                f"{enc:.4f} ms, decode {dec:.4f} ms, of them h_s on the "
                f"whole z_hat {hs:.4f} ms on every rank, at B={batch} "
                f"{HYPER_SIDE}x{HYPER_SIDE} (rank 0's host clock, median of "
                f"{SHARDED_CALLS} calls, each after a barrier); single-"
                f"device encode {g['encode_ms']:.4f} ms, decode "
                f"{g['decode_ms']:.4f} ms, h_s {g['h_s_ms']:.4f} ms (median "
                f"of {MEDIAN_CALLS})")
    return counts


# The sharded hyperprior phase: both trained models at 1024x1024, where the
# z plan (S_z = 4) and the y plan (S_y = 8) tile over 1, 2 and 4 ranks (at
# 768x512 S_z = 1 tiles over none but 1).  Launches of one direction on
# each rank: B and D an encode, C and E a decode, no conv kernel.
HYPER_SIDE = 1024
SHARDED_HYPER_ENC = {"rans_encode": 1, "rans_encode_ctx": 1,
                     "rans_decode": 0, "rans_decode_ctx": 0,
                     "conv3x3_s1_int8": 0, "conv_sparse_int8": 0}
SHARDED_HYPER_DEC = {"rans_encode": 0, "rans_encode_ctx": 0,
                     "rans_decode": 1, "rans_decode_ctx": 1,
                     "conv3x3_s1_int8": 0, "conv_sparse_int8": 0}
HYPER_X_TOL = 1e-4      # max |x_hat| difference, tiled g_s against whole


def hyper_images(seed: int, batch: int, h: int = HYPER_SIDE,
                 w: int = HYPER_SIDE) -> np.ndarray:
    """``make_images``' smooth gradients (the hyper paths' seed), float32
    in [0, 1]."""
    return make_images(seed + 1, batch, h, w).astype(np.float32) / 255


def corrupt_y(blob: bytes) -> bytes:
    """A byte flipped in the middle of the words of the middle y stream of
    a hyper container (the stream of a middle rank)."""
    from simple_image_compression_network_tpu_torch.codec import container
    _, sections = container.unpack(blob)
    y_pay = sections[2]
    off = len(blob) - len(sections[4]) - len(sections[3]) - len(y_pay) + 2
    for _ in range(struct.unpack_from("<H", y_pay)[0] // 2):
        off += 4 + struct.unpack_from("<I", blob, off)[0]
    bad = bytearray(blob)
    bad[off + 4 + struct.unpack_from("<I", blob, off)[0] // 2] ^= 0xFF
    return bytes(bad)


def tile_layer_diffs(model, x: torch.Tensor, y_hat: torch.Tensor,
                     mesh) -> dict:
    """Per conv layer of g_a, h_a and g_s, run on the whole image's own
    activations: how many output elements of this rank's tile conv differ
    bitwise from the same rows of the whole-image conv (the exposure to
    cuDNN choosing its algorithm by shape)."""
    from simple_image_compression_network_tpu_torch.models.hyperprior import (
        _Deconv)
    from simple_image_compression_network_tpu_torch.parallel import (
        hyper_sharded)
    names = {id(m): name for name, m in model.named_modules()}
    k, n = mesh.coord("x"), mesh.size("x")
    diffs = {}

    def conv(layer, h):
        whole = layer(h)
        rows, out_rows = h.shape[2] // n, whole.shape[2] // n
        tile = (hyper_sharded.deconv_tile if isinstance(layer, _Deconv)
                else hyper_sharded.conv_tile)(
            layer, h.narrow(2, k * rows, rows).contiguous(), mesh)
        diffs[names[id(layer)]] = int(
            (tile != whole.narrow(2, k * out_rows, out_rows)).sum())
        return whole

    model.analysis_arrays(x, conv=conv)
    model.decode_arrays(y_hat, conv=conv)
    return diffs


def sharded_hyper_rank(seed: int, batch: int, golden_blobs: dict) -> dict:
    """One rank of the sharded hyper phase (``spawn_ranks``): for each
    trained model, ``ShardedHyperCodec`` on a 1-D mesh of every rank at
    1024x1024 (a warm-up round, then a counted round with each direction's
    launches, routes and staged halo bytes read right after it), the
    single-device containers decoded, the timed calls, the h_s every rank
    runs, and a corrupt container; on 2 ranks 768x512 refused; on 4 ranks
    the tile convs against the whole image's.  Returns host objects only;
    rank 0 also the gathered tiles."""
    import torch.distributed as dist
    from simple_image_compression_network_tpu_torch.codec import hyper_codec
    from simple_image_compression_network_tpu_torch.parallel import (
        hyper_sharded, mesh as meshlib, spatial)
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = meshlib.spatial_mesh(n)
    x = torch.from_numpy(hyper_images(seed, batch)).to(mesh.device)
    out = {"rank": rank}
    for fam, cls in (("scale", hyper_codec.HyperCodec),
                     ("meanscale", hyper_codec.MeanScaleCodec)):
        t0 = time.perf_counter()
        codec = cls.from_checkpoint(CKPTS[fam], device=mesh.device)
        sh = hyper_sharded.ShardedHyperCodec(codec, mesh)
        t1 = time.perf_counter()
        sh.decompress_batch(sh.compress_batch(x))               # warm-up
        torch.cuda.synchronize()
        sh.routes.update(sharded=0, fallback=0)
        res = {"stages": {"load": t1 - t0,
                          "warm-up round": time.perf_counter() - t1}}
        t1 = time.perf_counter()
        for direction, expected in (("encode", SHARDED_HYPER_ENC),
                                    ("decode", SHARDED_HYPER_DEC)):
            reset_counts()
            spatial.halo_exchange.staged_bytes = 0
            if direction == "encode":
                blobs = sh.compress_batch(x)
            else:
                x_hat, y_hat = sh.decompress_batch(blobs)
            torch.cuda.synchronize()
            res[direction] = {**rank_counts(expected),
                              "staged": spatial.halo_exchange.staged_bytes}
        res["routes"] = dict(sh.routes)
        res["blobs"] = blobs
        res["tile"] = tuple(x_hat.shape)
        x1, y1 = sh.decompress_batch(golden_blobs[fam])
        whole = {k: spatial.gather_image(t, mesh).cpu().numpy()
                 for k, t in (("x_hat", x_hat), ("y_hat", y_hat),
                              ("x_single", x1), ("y_single", y1))}
        if rank == 0:
            res.update(whole)
        res["stages"]["counted round, gathers"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        res["encode_ms"] = rank_ms(lambda: sh.compress_batch(x))
        res["decode_ms"] = rank_ms(lambda: sh.decompress_batch(blobs))
        z = spatial.gather_image(hyper_sharded.analysis_local(
            codec.model, spatial.shard_image(x, mesh), mesh)[1], mesh)
        res["h_s_ms"] = rank_ms(lambda: codec._prior_from_z(z))
        res["stages"]["timed calls"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        try:
            sh.decompress_batch(blobs[:-1] + [corrupt_y(blobs[-1])])
            res["corrupt"] = None
        except ValueError as e:
            res["corrupt"] = str(e)
        if n == 2:
            x768 = torch.from_numpy(hyper_images(seed, batch, H, W))
            try:
                sh.compress_batch(x768.to(mesh.device))
                res["refused"] = None
            except ValueError as e:
                res["refused"] = str(e)
        if n == 4:
            res["layers"] = tile_layer_diffs(
                codec.model, x, torch.from_numpy(whole["y_hat"]).to(
                    mesh.device), mesh)
        res["stages"]["checks"] = time.perf_counter() - t1
        out[fam] = res
    if n <= 2 and "bf16 scale" in golden_blobs:
        out["bf16 scale"] = sharded_bf16_rank(x, mesh,
                                              golden_blobs["bf16 scale"])
    return out


def sharded_bf16_rank(x, mesh, golden_blobs: list) -> dict:
    """The scale model in bf16 through ``ShardedHyperCodec`` on this
    rank's mesh: one counted round (launches a direction, routes) and the
    single-device bf16 codec's containers decoded; rank 0 keeps the
    gathered tiles."""
    import torch.distributed as dist
    from simple_image_compression_network_tpu_torch.codec import hyper_codec
    from simple_image_compression_network_tpu_torch.parallel import (
        hyper_sharded, spatial)
    codec = hyper_codec.HyperCodec.from_checkpoint(
        HYPER_CKPT, device=mesh.device, dtype=torch.bfloat16)
    sh = hyper_sharded.ShardedHyperCodec(codec, mesh)
    sh.decompress_batch(sh.compress_batch(x))                   # warm-up
    torch.cuda.synchronize()
    sh.routes.update(sharded=0, fallback=0)
    res = {"rank": dist.get_rank()}
    for direction, expected in (("encode", SHARDED_HYPER_ENC),
                                ("decode", SHARDED_HYPER_DEC)):
        reset_counts()
        if direction == "encode":
            blobs = sh.compress_batch(x)
        else:
            x_hat, y_hat = sh.decompress_batch(blobs)
        torch.cuda.synchronize()
        res[direction] = rank_counts(expected)
    res["routes"], res["blobs"] = dict(sh.routes), blobs
    x1, y1 = sh.decompress_batch(golden_blobs)
    whole = {k: spatial.gather_image(t, mesh).cpu().numpy()
             for k, t in (("x_hat", x_hat), ("y_hat", y_hat),
                          ("x_single", x1), ("y_single", y1))}
    if res["rank"] == 0:
        res.update(whole)
    return res


def check_hyper_rank(n: int, fam: str, res: dict, backend: str) -> None:
    """One rank's gates for one model: the sharded route both ways, the
    expected launches with no plain run, the corrupt container raised, at
    2 ranks the 768x512 plan refused, and under NCCL no byte staged."""
    tag = f"sharded {fam} ({backend}), {n} rank(s), rank {res['rank']}"
    got = res[fam]
    if backend == "nccl" and (got["encode"]["staged"]
                              or got["decode"]["staged"]):
        raise AssertionError(f"{tag}: NCCL messages staged through the "
                             f"host")
    if got["routes"] != {"sharded": 2, "fallback": 0}:
        raise AssertionError(f"{tag}: routes {got['routes']}")
    for direction, expected in (("encode", SHARDED_HYPER_ENC),
                                ("decode", SHARDED_HYPER_DEC)):
        if got[direction]["launches"] != expected or got[direction]["plain"]:
            raise AssertionError(f"{tag} {direction}: launches "
                                 f"{got[direction]['launches']}, plain runs "
                                 f"{got[direction]['plain']}; expected "
                                 f"{expected}")
    if got["corrupt"] != "corrupt latent stream":
        raise AssertionError(f"{tag}: corrupt container gave "
                             f"{got['corrupt']!r}")
    if n == 2 and got["refused"] != ("z stream plan S=1, rows=12 does not "
                                     "tile over 2 ranks"):
        raise AssertionError(f"{tag}: 768x512 gave {got['refused']!r}")


def hyper_golden(seed: int, batch: int, codecs: dict) -> dict:
    """The single-device codecs at 1024x1024: per model the containers,
    y_hat, z_hat and x_hat of their decode, the symbols, the values whose
    rounding gives y's symbols (y, or y - mu) and z's (h_a's output), and
    encode, decode and h_s ms (host clock, median of 5)."""
    from simple_image_compression_network_tpu_torch.models.hyperprior import (
        _exact_float, _nchw, _nhwc)
    out = {}
    for fam, codec in codecs.items():
        x = torch.from_numpy(hyper_images(seed, batch)).to(codec.device)
        blobs = codec.compress_batch(x)
        x_hat, y_hat, z_hat = codec.decompress_batch(blobs, return_z=True)
        sym, z, mu, _ = codec.encode_arrays(x)
        y, _ = codec.model.analysis_arrays(x)
        with torch.no_grad(), _exact_float():
            z_pre = _nhwc(codec.model.h_a(_nchw(y)))
        out[fam] = {"blobs": blobs, "x_hat": x_hat, "y_hat": y_hat,
                    "z": z, "sym": sym, "mu": mu, "y": y, "z_pre": z_pre,
                    "encode_ms": median_ms(lambda: codec.compress_batch(x)),
                    "decode_ms": median_ms(
                        lambda: codec.decompress_batch(blobs)),
                    "h_s_ms": median_ms(lambda: codec._prior_from_z(z_hat))}
    return out


def check_hyper_outputs(n: int, fam: str, codec, gold: dict, ranks: list,
                        backend: str) -> None:
    """The gathered outputs of one model against the single-device codec:
    cross-decoding exact both ways; z and y symbols equal off rounding ties
    (counted); containers byte-identical, or every difference a tie that
    flipped (printed); y_hat equal to the golden off those ties, exactly
    where the containers are identical; x_hat within ``HYPER_X_TOL``."""
    tag = f"sharded {fam} ({backend}) {n} rank(s)"
    r0 = ranks[0][fam]
    if any(res[fam]["blobs"] != r0["blobs"] for res in ranks):
        raise AssertionError(f"{tag}: ranks returned different containers")
    dev = gold["y_hat"].device
    y_hat = torch.from_numpy(r0["y_hat"]).to(dev)
    # the single-device containers under the sharded codec
    require_identical(f"{tag}: single-device containers decoded sharded, "
                      f"y_hat == golden", torch.from_numpy(
                          r0["y_single"]).to(dev), gold["y_hat"])
    x_single = (torch.from_numpy(r0["x_single"]).to(dev)
                - gold["x_hat"]).abs().max().item()
    # the sharded containers under the single-device codec
    x_s1, y_s1, z_s1 = codec.decompress_batch(r0["blobs"], return_z=True)
    require_identical(f"{tag}: sharded containers decoded by the single-"
                      f"device codec, y_hat == the sharded decode's",
                      y_s1, y_hat)
    mu_s = codec._prior_from_z(z_s1)[0]
    z_ties = ties(gold["z_pre"])
    z_off = (z_s1.to(torch.int32) != gold["z"]) & ~z_ties
    if bool(z_off.any()):
        raise AssertionError(f"{tag}: z symbols differ from the single-"
                             f"device encode's at {int(z_off.sum())} "
                             f"positions off the ties")
    if mu_s is None:
        sym_s = y_s1.to(torch.int32)
        y_ties = ties(gold["y"])
    else:
        sym_s = torch.round(y_s1 - mu_s).to(torch.int32)
        y_ties = ties(gold["y"] - gold["mu"]) | ties(gold["y"] - mu_s)
    y_diff = sym_s != gold["sym"]
    if bool((y_diff & ~y_ties).any()):
        raise AssertionError(f"{tag}: y symbols differ from the single-"
                             f"device encode's at "
                             f"{int((y_diff & ~y_ties).sum())} positions "
                             f"off the ties")
    same = r0["blobs"] == gold["blobs"]
    if same:
        require_identical(f"{tag}: gathered y_hat == golden", y_hat,
                          gold["y_hat"])
    else:
        off = (y_hat != gold["y_hat"]) & ~y_ties
        if bool(off.any()):
            raise AssertionError(f"{tag}: y_hat differs from the golden at "
                                 f"{int(off.sum())} positions off the ties")
    x_err = (torch.from_numpy(r0["x_hat"]).to(dev)
             - gold["x_hat"]).abs().max().item()
    if max(x_err, x_single) > HYPER_X_TOL:
        raise AssertionError(f"{tag}: x_hat max |diff| {x_err} (sharded "
                             f"containers), {x_single} (single-device "
                             f"containers) > {HYPER_X_TOL}")
    n_diff = sum(a != b for a, b in zip(r0["blobs"], gold["blobs"]))
    log(f"{tag}: routes {r0['routes']} on every rank, launches a rank "
        f"encode {r0['encode']['launches']}, decode "
        f"{r0['decode']['launches']}, plain runs 0; tiles {r0['tile']}; "
        f"containers "
        + ("byte-identical to the single-device codec's" if same else
           f"differ from the single-device codec's in {n_diff} of "
           f"{len(r0['blobs'])}: z symbols differing "
           f"{int((z_s1.to(torch.int32) != gold['z']).sum())}, y symbols "
           f"differing {int(y_diff.sum())}, each at a tie")
        + f"; cross-decoding exact both ways; symbols off the ties equal "
        f"(z: {int(z_ties.sum())} ties, y: {int(y_ties.sum())} ties within "
        f"{TIE} of a half; differing at ties: z "
        f"{int((z_s1.to(torch.int32) != gold['z']).sum())}, y "
        f"{int(y_diff.sum())}); gathered y_hat "
        + ("== golden" if same else "== golden off the ties")
        + f"; x_hat max |diff| {x_err} (sharded containers), {x_single} "
        f"(single-device containers) <= {HYPER_X_TOL}; corrupt container "
        f"raised on every rank")


BF16_X_TOL = 2.0 ** -7    # x_hat in [0, 1]: bf16's spacing just below 1


def check_bf16_group(n: int, ranks: list, c16, gold: dict,
                     backend: str) -> dict:
    """The bf16 scale model's sharded round against the single-device bf16
    codec ``c16`` (``gold``: its containers, y_hat and x_hat): on every
    rank the sharded route and the launches of SHARDED_HYPER_ENC / DEC
    with no plain run; the sharded containers decoded by ``c16`` and
    ``c16``'s decoded by the sharded codec, y_hat exactly and x_hat within
    ``BF16_X_TOL``; the containers byte-identical, or the symbols that
    differ counted (printed).  Returns the launches summed over ranks."""
    tag = f"sharded bf16 scale ({backend}) {n} rank(s)"
    for res in ranks:
        got = res["bf16 scale"]
        if got["routes"] != {"sharded": 2, "fallback": 0}:
            raise AssertionError(f"{tag}, rank {got['rank']}: routes "
                                 f"{got['routes']}")
        for direction, expected in (("encode", SHARDED_HYPER_ENC),
                                    ("decode", SHARDED_HYPER_DEC)):
            if got[direction]["launches"] != expected or \
                    got[direction]["plain"]:
                raise AssertionError(f"{tag} {direction}: launches "
                                     f"{got[direction]}")
    r0 = ranks[0]["bf16 scale"]
    if any(res["bf16 scale"]["blobs"] != r0["blobs"] for res in ranks):
        raise AssertionError(f"{tag}: ranks returned different containers")
    dev = gold["y_hat"].device
    x_s1, y_s1 = c16.decompress_batch(r0["blobs"])
    require_identical(f"{tag}: sharded containers decoded by the single-"
                      f"device bf16 codec, y_hat == the sharded decode's",
                      y_s1, torch.from_numpy(r0["y_hat"]).to(dev))
    require_identical(f"{tag}: single-device bf16 containers decoded "
                      f"sharded, y_hat == the single-device decode's",
                      torch.from_numpy(r0["y_single"]).to(dev),
                      gold["y_hat"])
    errs = {k: (torch.from_numpy(r0[k]).to(dev) - ref).abs().max().item()
            for k, ref in (("x_hat", x_s1), ("x_single", gold["x_hat"]))}
    errs["x_hat vs single"] = (torch.from_numpy(r0["x_hat"]).to(dev)
                               - gold["x_hat"]).abs().max().item()
    if max(errs.values()) > BF16_X_TOL:
        raise AssertionError(f"{tag}: x_hat max |diff| {errs} > "
                             f"{BF16_X_TOL}")
    same = r0["blobs"] == gold["blobs"]
    n_sym = int((y_s1 != gold["y_hat"]).sum())
    log(f"{tag}: routes {r0['routes']} on every rank, launches a rank "
        f"encode {r0['encode']['launches']}, decode "
        f"{r0['decode']['launches']}, plain runs 0; cross-decoding with the "
        f"single-device bf16 codec exact both ways; x_hat max |diff| "
        f"{errs} <= {BF16_X_TOL}; containers "
        + ("byte-identical" if same else
           f"differ: {n_sym} y symbols differ from the single-device "
           f"codec's")
        + f" ({sum(len(b) for b in r0['blobs'])} bytes)")
    return {k: sum(r["bf16 scale"][d]["launches"][k] for r in ranks
                   for d in ("encode", "decode")) for k in HYPER_ROUND}


def check_hyper_group(n: int, ranks: list, gold: dict, codecs: dict,
                      backend: str) -> tuple:
    """The sharded hyper results of one group of ``n`` ranks, gated by
    ``check_hyper_rank`` on every rank and ``check_hyper_outputs`` against
    the single-device codecs' run (``hyper_golden``); logs the halo bytes
    staged and, on 4 ranks, each tile conv's bitwise differences from the
    whole image's.  Returns (launches by path summed over ranks, rank 0's
    (encode, decode, h_s) ms by model)."""
    counts, ms = {}, {}
    for fam, codec in codecs.items():
        for res in ranks:
            check_hyper_rank(n, fam, res, backend)
        check_hyper_outputs(n, fam, codec, gold[fam], ranks, backend)
        counts[f"sharded hyper {backend} {n} {fam}"] = {
            k: sum(r[fam][d]["launches"][k] for r in ranks
                   for d in ("encode", "decode"))
            for k in HYPER_ROUND}
        ms[fam] = tuple(ranks[0][fam][k]
                        for k in ("encode_ms", "decode_ms", "h_s_ms"))
        staged = [(r[fam]["encode"]["staged"], r[fam]["decode"]["staged"])
                  for r in ranks]
        log(f"sharded {fam} ({backend}) {n} rank(s): halo bytes staged "
            f"through the host a pass (encode, decode) by rank: {staged}; "
            f"rank 0's s by stage: "
            f"{ {k: round(v, 3) for k, v in ranks[0][fam]['stages'].items()} }")
        if n == 4:
            layers = {k: sum(r[fam]["layers"][k] for r in ranks)
                      for k in ranks[0][fam]["layers"]}
            log(f"sharded {fam} 4 ranks: output elements of the tile convs "
                f"that differ bitwise from the whole image's, by layer "
                f"(summed over ranks): {layers}")
    return counts, ms


def chain_path(batch: int, golden: dict, card: str) -> dict:
    """``DeviceChain`` at 768x512: built (one eager run of each program,
    then its capture as a CUDA graph) with the launch counts read around
    the build and around each capture; replayed with no counter ticking;
    ``exact`` and ``check()`` true, x_hat equal to the float64 golden, the
    words and counts equal to kernel B's over the golden latent, both
    checksums as the golden gives them.  Then each program's device time
    run eagerly and replayed (CUDA events, mean of 10 calls back to back:
    their difference is the device's idle time under eager launch), and
    the host's time to launch each, one synchronized call at a time.
    Returns the build's counts."""
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, device_chain)
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf_tensor)
    from torch.profiler import ProfilerActivity, profile
    net, cdfs, x = golden["net"], golden["cdfs"], golden["x"]
    reset_counts()
    chain = device_chain.DeviceChain(net, cdfs, x)
    torch.cuda.synchronize()
    # one sizing encode (A 4, B 1), then each program eagerly and captured
    built = read_exact("device chain build", {
        "conv3x3_s1_int8": 4 + 2 * (4 + 4 + 8), "rans_encode": 1 + 2 * 2,
        "rans_decode": 2 * 2})
    per_graph = {"encode": {"conv3x3_s1_int8": 4, "rans_encode": 1,
                            "rans_decode": 0},
                 "decode": {"conv3x3_s1_int8": 4, "rans_encode": 0,
                            "rans_decode": 1},
                 "roundtrip": {"conv3x3_s1_int8": 8, "rans_encode": 1,
                               "rans_decode": 1}}
    log(f"device chain: captured {sorted(chain._graphs)}, launches at "
        f"capture {chain.graph_launches}, mxb {chain.mxb} of "
        f"{chain._words.shape[1]} words")
    if chain.graph_launches != per_graph or sorted(chain._graphs) != sorted(
            per_graph):
        raise AssertionError(f"the chain's graphs captured "
                             f"{chain.graph_launches}, expected {per_graph}")

    reset_counts()
    csum, exact = chain.roundtrip(x)
    w, cnt, esum = chain.encode(x)
    x_hat, dsum = chain.decode(w, cnt)
    torch.cuda.synchronize()
    read_exact("device chain replay", {"conv3x3_s1_int8": 0,
                                       "rans_encode": 0, "rans_decode": 0})
    if not bool(exact):
        raise AssertionError("device chain: exact is false (z_hat != z or "
                             "a stream failed its check)")
    require_equal("device chain x_hat == golden", x_hat, golden["x_ref"])
    z = golden["z_ref"]
    wb, cb = cuda_rans.encode_batch_compact(
        z.reshape(z.shape[0] * chain.s, chain.t_steps, chain.n_lanes),
        _lane_cdf_tensor(cdfs, chain.n_lanes, z.device))
    require_equal("device chain counts == kernel B's on the golden latent",
                  cnt, cb)
    require_equal("device chain words == kernel B's on the golden latent",
                  w, wb)
    x_sum = int(golden["x_ref"].to(torch.int64).sum())
    got = (int(esum), int(dsum), int(csum))
    want = (int(cb.sum()), x_sum + 1, x_sum)
    if got != want:
        raise AssertionError(f"device chain checksums {got}, expected {want}")
    checked = chain.check(x)
    if checked != (True, True):
        raise AssertionError(f"device chain check() gave {checked}")
    log(f"device chain: exact True, check() {checked}, x_hat == golden, "
        f"words and counts == kernel B's, checksums {got} as expected; "
        f"replays ran no eager launch")

    mp = batch * H * W / 1e3          # megapixels per ms -> MP/s
    for name in device_chain.PROGRAMS:
        body, graph = getattr(chain, f"_{name}_body"), chain._graphs[name]
        eager = cuda_ms(body, 10)
        replay = cuda_ms(graph.replay, 10)
        e_host, e_wall = launch_ms(body, 10)
        r_host, r_wall = launch_ms(graph.replay, 10)
        log(f"device chain [{card}]: {name} eager {eager:.4f} ms, replay "
            f"{replay:.4f} ms (CUDA events, 10 calls back to back), device "
            f"idle under eager launch {eager - replay:.4f} ms; replay "
            f"{mp / replay:.1f} MP/s")
        log(f"device chain [{card}]: {name} one call at a time (host clock, "
            f"median of 10): the host's launch cost eager {e_host:.4f} ms, "
            f"replay {r_host:.4f} ms; to the synchronize eager {e_wall:.4f} "
            f"ms, replay {r_wall:.4f} ms")
    public = host_ms(lambda: chain.roundtrip(x)[1].item(), 10)
    log(f"device chain [{card}]: roundtrip(x) and its flag read on the host "
        f"{public:.4f} ms (host clock, mean of 10)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain._graphs["roundtrip"].replay()
        torch.cuda.synchronize()
    log("device chain: kernels of one roundtrip replay (torch.profiler, a "
        "report, not a gate):")
    log(prof.key_averages().table(sort_by="device_time_total", row_limit=12,
                                  max_name_column_width=60))
    return built


N_PIPE = 4          # batches through each pipeline
PIPE_DEPTH = 2
PIPE_TURNS = 7      # alternating sync and pipelined runs of each pipeline
SPIN_CYCLES = 1 << 27   # ~70 ms of queued device work at the boost clock


def wall_ms(fn) -> tuple:
    """(host-clock ms of fn() up to a synchronize after it, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def pipelines_path(seed: int, batch: int, golden: dict, codec,
                   card: str) -> dict:
    """``N_PIPE`` batches of B 768x512 images through each pipeline at depth
    ``PIPE_DEPTH``, with the launch counts read right after the int8 and the
    hyper pipelines; every result equal to the sync calls'; wall time of
    each against the sync calls over the same batches (in turns sync,
    pipelined, ``PIPE_TURNS`` times; every turn printed, and the medians
    compared), and the host's time a
    batch in each pipeline's phases; each ``submit`` must return with a
    spin kernel queued before it still running.  Then the hyper
    containers of all batches decoded one by one and as one batch, against
    the B-image decodes: reported, not gated.  Returns the counts."""
    from simple_image_compression_network_tpu_torch.codec import (
        device_rans, int_codec, pipeline)
    net, cdfs = golden["net"], golden["cdfs"]
    dev = golden["x"].device
    xs = [torch.from_numpy(make_images(seed + 10 + k, batch)).to(dev)
          for k in range(N_PIPE)]
    xf = [x.to(torch.float32) / 255.0 for x in xs]
    enc = pipeline.PipelinedEncoder(net, cdfs, depth=PIPE_DEPTH)
    dec = pipeline.PipelinedDecoder(net, cdfs, depth=PIPE_DEPTH)
    h_enc = pipeline.HyperPipelinedEncoder(codec, depth=PIPE_DEPTH)
    h_dec = pipeline.HyperPipelinedDecoder(codec, depth=PIPE_DEPTH)
    paths = {
        "int8 encode": (lambda: run_pipe(enc, xs), lambda: [
            int_codec.compress_batch(net, x, static_cdfs=cdfs) for x in xs]),
        "int8 decode": (lambda: run_pipe(dec, blobs), lambda: [
            int_codec.decompress_batch(net, bl, static_cdfs=cdfs)[0]
            for bl in blobs]),
        "hyper encode": (lambda: run_pipe(h_enc, xf),
                         lambda: [codec.compress_batch(x) for x in xf]),
        "hyper decode": (lambda: run_pipe(h_dec, h_blobs), lambda: [
            codec.decompress_batch(bl) for bl in h_blobs]),
    }
    counts = {}
    reset_counts()
    blobs = run_pipe(enc, xs)
    run_pipe(dec, blobs)
    torch.cuda.synchronize()
    counts["pipelined int8"] = read_exact("pipelined int8", {
        "conv3x3_s1_int8": 8 * N_PIPE, "rans_encode": N_PIPE,
        "rans_decode": N_PIPE})
    reset_counts()
    h_blobs = run_pipe(h_enc, xf)
    run_pipe(h_dec, h_blobs)
    torch.cuda.synchronize()
    counts["pipelined hyper"] = read_exact("pipelined hyper", {
        "rans_encode": N_PIPE, "rans_decode": N_PIPE,
        "rans_encode_ctx": N_PIPE, "rans_decode_ctx": N_PIPE})

    def breakdown(pipe, items) -> dict:
        """Host ms a batch of one run in ``_schedule``, in waiting for the
        batch's copy (``host_array``), and in the rest of ``_finish``."""
        spent = {"schedule": 0.0, "finish": 0.0, "wait": 0.0}
        wait = device_rans.host_array

        def timed(key, fn):
            def call(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    spent[key] += time.perf_counter() - t0
            return call
        pipe._schedule = timed("schedule", pipe._schedule)
        pipe._finish = timed("finish", pipe._finish)
        device_rans.host_array = timed("wait", wait)
        try:
            wall_ms(lambda: run_pipe(pipe, items))
        finally:
            del pipe._schedule, pipe._finish
            device_rans.host_array = wait
        ms = {k: v * 1e3 / len(items) for k, v in spent.items()}
        ms["finish"] -= ms["wait"]
        return ms

    pipes = {"int8 encode": (enc, xs), "int8 decode": (dec, blobs),
             "hyper encode": (h_enc, xf), "hyper decode": (h_dec, h_blobs)}
    for name, (pipe, items) in pipes.items():
        never_waits(name, pipe, items[0])
    for name, (piped, sync) in paths.items():
        s = time_turns(name, piped, sync, batch, card)
        ms = breakdown(*pipes[name])
        log(f"pipelined [{card}]: {name}, host ms a batch (host clock, one "
            f"run): schedule {ms['schedule']:.4f}, wait for its copy "
            f"{ms['wait']:.4f}, rest of the drain {ms['finish']:.4f}; the "
            f"sync call {s / N_PIPE:.4f}")

    alone_and_together("hyper", codec, h_blobs, batch)
    return counts


def run_pipe(pipe, items) -> list:
    for item in items:
        pipe.submit(item)
    return pipe.drain()


def never_waits(name: str, pipe, item) -> None:
    """``submit`` on an empty pipeline behind a queued spin kernel must
    return while the spin still runs: it waits on no device work."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    t0 = time.perf_counter()
    pipe.submit(item)
    host = (time.perf_counter() - t0) * 1e3
    waited = spun.query()
    pipe.drain()
    log(f"pipelined {name}: submit returned after {host:.3f} ms with "
        f"the queued spin {'done' if waited else 'still running'}")
    if waited:
        raise AssertionError(f"pipelined {name}: submit waited for "
                             f"queued device work")


def same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(u, v) for u, v in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def time_turns(name: str, piped, sync, batch: int, card: str) -> float:
    """Wall time of ``N_PIPE`` batches through a pipeline against the sync
    calls, in turns sync, pipelined, ``PIPE_TURNS`` times, every result
    equal to the first sync run's; every turn printed and the medians
    compared.  Returns the sync calls' median ms."""
    mp = N_PIPE * batch * H * W / 1e3          # megapixels per ms -> MP/s
    times, ref = {"sync": [], "pipelined": []}, None
    for kind in ("sync", "pipelined") * PIPE_TURNS:
        ms, out = wall_ms(sync if kind == "sync" else piped)
        times[kind].append(ms)
        if ref is None:
            ref = out
        elif not same(out, ref):
            raise AssertionError(f"{kind} {name} differs from the first "
                                 f"sync run")
    s, p = (float(np.median(times[k])) for k in ("sync", "pipelined"))
    log(f"pipelined [{card}]: {name}, {N_PIPE} batches of B={batch} "
        f"at depth {PIPE_DEPTH} == the sync calls; ms of each turn "
        f"(host clock): sync {times['sync']}, pipelined "
        f"{times['pipelined']}; median {s:.3f} against {p:.3f} ms "
        f"({mp / s:.1f} against {mp / p:.1f} MP/s, {s / p:.3f}x)")
    return s


def alone_and_together(tag: str, codec, h_blobs: list, batch: int) -> None:
    """The hyper containers of all batches decoded one by one (B = 1) and
    as one batch, against the B-image decodes: reported, not gated.  The
    codecs run h_s image by image, so that no algorithm cuDNN picks for
    another batch size can move a sigma across a bin edge (which desyncs
    the y streams: a corrupt-stream error) or the mean-scale model's mu,
    which y_hat adds to the symbols (the largest move is printed)."""
    y_ref = [codec.decompress_batch(bl)[1] for bl in h_blobs]
    flat = [bl for group in h_blobs for bl in group]
    alone, decoded, moved = 0, 0, 0.0
    for i, blob in enumerate(flat):
        ref = y_ref[i // batch][i % batch]
        try:
            y1 = codec.decompress_batch([blob])[1][0]
        except ValueError as e:
            log(f"{tag} image {i} decoded alone: {e}")
            continue
        decoded += 1
        alone += int(torch.equal(y1, ref))
        moved = max(moved, (y1 - ref).abs().max().item())
    try:
        y_all = codec.decompress_batch(flat)[1]
        together = sum(int(torch.equal(y_all[i], y_ref[i // batch][i % batch]))
                       for i in range(len(flat)))
    except ValueError as e:
        log(f"{tag}: the {len(flat)} containers as one batch: {e}")
        together = 0
    log(f"{tag}: of {len(flat)} containers of the pipelines' B={batch} "
        f"batches, {alone} decoded alone (B=1) and {together} decoded as one "
        f"batch of {len(flat)} give the B={batch} decode's y_hat; "
        f"{decoded} decoded alone without a stream error, their y_hat at "
        f"most {moved} from it")


def meanscale_pipelines(seed: int, batch: int, codec, card: str) -> dict:
    """The two hyper pipelines over ``MeanScaleCodec``'s schedule and drain
    phases, on the images of ``pipelines_path``: the launches counted right
    after, every result equal to the sync calls', each ``submit`` waiting on
    no queued device work, the wall times against the sync calls, and the
    containers decoded alone and as one batch (reported).  Returns the
    counts."""
    from simple_image_compression_network_tpu_torch.codec import pipeline
    dev = codec.device
    xf = [torch.from_numpy(make_images(seed + 10 + k, batch)).to(dev)
          .to(torch.float32) / 255.0 for k in range(N_PIPE)]
    enc = pipeline.HyperPipelinedEncoder(codec, depth=PIPE_DEPTH)
    dec = pipeline.HyperPipelinedDecoder(codec, depth=PIPE_DEPTH)
    reset_counts()
    blobs = run_pipe(enc, xf)
    outs = run_pipe(dec, blobs)
    torch.cuda.synchronize()
    counts = read_exact("pipelined meanscale",
                        {k: N_PIPE * v for k, v in HYPER_ROUND.items()})
    sync = [codec.compress_batch(x) for x in xf]
    if blobs != sync:
        raise AssertionError("pipelined meanscale encode differs from the "
                             "sync calls")
    if not same(outs, [codec.decompress_batch(bl) for bl in sync]):
        raise AssertionError("pipelined meanscale decode differs from the "
                             "sync calls")
    never_waits("meanscale encode", enc, xf[0])
    never_waits("meanscale decode", dec, blobs[0])
    time_turns("meanscale encode", lambda: run_pipe(enc, xf),
               lambda: [codec.compress_batch(x) for x in xf], batch, card)
    time_turns("meanscale decode", lambda: run_pipe(dec, blobs),
               lambda: [codec.decompress_batch(bl) for bl in blobs], batch,
               card)
    alone_and_together("meanscale", codec, blobs, batch)
    return {"pipelined meanscale": counts}


MEDIAN_CALLS = 5


def median_ms(fn) -> float:
    """Median host-clock time of ``MEDIAN_CALLS`` calls of fn(), each
    ending in a synchronize."""
    times = []
    for _ in range(MEDIAN_CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# kernel launches of one wavelet compress_batch + decompress_batch round
WAVELET_ROUND = {"conv3x3_s1_int8": 8, "rans_encode": 1, "rans_decode": 1}
# of the host coders' compress_batch + decompress_batch: the transform only
HOST_ROUND = {"conv3x3_s1_int8": 8, "rans_encode": 0, "rans_decode": 0}
# of decode_bytes on one stream, on its lane table and on a context table
DECODE_BYTES = {"rans_decode": 1, "rans_decode_ctx": 1}


def per_image_round(batch: int) -> dict:
    """The device coder's round with per-image tables: kernels B and C
    once an image."""
    return {"conv3x3_s1_int8": 8, "rans_encode": batch,
            "rans_decode": batch}


def wavelet_path(seed: int, batch: int, dev, card: str, errs: dict) -> dict:
    """``WaveletCodec`` at 768x512 under each of its four profiles: every
    codec built and warmed up once, then one counted compress_batch +
    decompress_batch round each (host clock), with its gates: x_hat and
    z_hat equal to the golden transform of the numpy wire map, the device
    wire and display maps equal to the numpy ones, kernels B and C on the
    profile's table and real latent equal to their plain versions, the
    containers equal to the native coder's, ``roundtrip_metrics`` exact,
    and no lane table uploaded again after the warm-up.  Then
    ``device_rans.decode_bytes`` on one stream of the default profile's
    container, on kernel C with its lane table and on kernel E with the
    profile's tables as a context table, each equal to the native
    decoder.  Returns the launch counts by profile and of decode_bytes."""
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, device_rans, ilrans, int_codec, rans, wavelet_codec)
    from simple_image_compression_network_tpu_torch.models import codec_int
    t0 = time.perf_counter()
    rans.load_native()                 # the gates below use the host coder
    log(f"host coder g++ build and load: {time.perf_counter() - t0:.2f} s")
    imgs = make_images(seed + 20, batch)
    x = torch.from_numpy(imgs).to(dev)
    codecs = {}
    for profile in wavelet_codec.PROFILES:
        c = codecs[profile] = wavelet_codec.WaveletCodec(profile, device=dev)
        c.decompress_batch(c.compress_batch(x))                  # warm-up
    torch.cuda.synchronize()
    misses = int_codec._lane_cdf_tensor.misses
    counts = {}
    mp = batch * H * W / 1e6
    for profile, c in codecs.items():
        path = f"wavelet {profile}"
        reset_counts()
        t0 = time.perf_counter()
        blobs = c.compress_batch(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec, x_hat = c.decompress_batch(blobs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts[path] = read_exact(path, WAVELET_ROUND)

        wire_np = c.to_wire(imgs)
        wire = torch.from_numpy(wire_np).to(dev)
        require_equal(f"{path}: device wire map == numpy", c._wire_dev(x),
                      wire)
        z_ref = codec_int.analysis_int8(c.params, wire,
                                        impl=codec_int.GOLDEN_PLAN)
        x_ref = codec_int.synthesis_int8(c.params, z_ref,
                                         impl=codec_int.GOLDEN_PLAN)
        require_equal(f"{path}: x_hat == eight_layers_net(golden)", x_hat,
                      x_ref)
        _, z_hat = int_codec.decompress_batch(c.net, blobs,
                                              static_cdfs=c.cdfs)
        require_equal(f"{path}: z_hat == analysis (golden)", z_hat, z_ref)
        require_equal(f"{path}: device display map == numpy",
                      torch.from_numpy(rec),
                      torch.from_numpy(c.display(x_hat.cpu().numpy())))

        b, zx, zy, ch = z_ref.shape
        s, lm = int_codec.plan_streams(zx * zy)
        n, t = lm * ch, zx * zy // lm // s
        lane_cdf = int_codec._lane_cdf_tensor(c.cdfs, n, dev)
        n_words = check_rans(
            f"kernels B, C on {profile}'s table and latent",
            cuda_rans.encode_batch_compact, cuda_rans.decode,
            cuda_rans.encode_batch_compact_plain, cuda_rans.decode_plain,
            z_ref.reshape(b * s, t, n).contiguous(), (lane_cdf,), t, n,
            errs, ("rans_encode", "rans_decode"))
        native = int_codec.compress_batch(c.net, wire, static_cdfs=c.cdfs,
                                          coder="native")
        if native != blobs:
            raise AssertionError(f"{path}: the containers differ from the "
                                 f"native coder's")
        m = c.roundtrip_metrics(imgs)
        if not m["decode_bit_exact"]:
            raise AssertionError(f"{path}: roundtrip_metrics {m}")
        full_rows = int((np.diff(c.cdfs, axis=1) == 65408).any(1).sum())
        enc_med = median_ms(lambda: c.compress_batch(x))
        dec_med = median_ms(lambda: c.decompress_batch(blobs))
        n_bytes = sum(len(bl) for bl in blobs)
        log(f"{path}: x_hat, z_hat == golden, wire and display maps == "
            f"numpy, kernels B, C == plain on the latent ({int(n_words.sum())}"
            f" words; {full_rows} table rows with a symbol at 65,408), "
            f"containers == the native coder's")
        log(f"{path} [{card}]: B={batch} 768x512, {n_bytes} container bytes, "
            f"{8 * n_bytes / (batch * H * W)} bpp, PSNR {m['psnr_db']} dB; "
            f"encode {(t1 - t0) * 1e3} ms ({mp / (t1 - t0)} MP/s), decode "
            f"{(t2 - t1) * 1e3} ms ({mp / (t2 - t1)} MP/s), host clock; "
            f"median of {MEDIAN_CALLS} more: encode {enc_med} ms "
            f"({mp * 1e3 / enc_med} MP/s), decode {dec_med} ms "
            f"({mp * 1e3 / dec_med} MP/s)")
    again = int_codec._lane_cdf_tensor.misses - misses
    log(f"wavelet: lane tables uploaded after the warm-up: {again}")
    if again:
        raise AssertionError(f"the four profiles uploaded {again} lane "
                             f"tables again after the warm-up")

    profile = wavelet_codec.DEFAULT_PROFILE
    c = codecs[profile]
    chunk = int_codec._parse(c.compress_batch(x)[:1])[0][2][0]
    n, n_lanes, _, _ = ilrans.unpack_header(chunk)
    rows = c.cdfs.shape[0]
    ctx = np.arange(n, dtype=np.int32) % rows      # lane k: channel k % C
    want = rans.decode_interleaved(chunk, ctx, c.cdfs)
    torch.cuda.synchronize()
    reset_counts()
    by_lane = device_rans.decode_bytes(
        chunk, int_codec._lane_cdf(c.cdfs, n_lanes), None, device=dev)
    by_ctx = device_rans.decode_bytes(chunk, c.cdfs, ctx, device=dev)
    counts["decode_bytes"] = read_exact("decode_bytes", DECODE_BYTES)
    for what, got in (("kernel C, lane table", by_lane),
                      ("kernel E, context table", by_ctx)):
        if not np.array_equal(got, want):
            raise AssertionError(f"decode_bytes ({what}) differs from the "
                                 f"native decoder")
    log(f"decode_bytes on {profile}'s stream 0 ({n} symbols, {n_lanes} "
        f"lanes): kernel C on its lane table and kernel E on its {rows}-row "
        f"context table == the native decoder")
    return counts


def host_coders_path(seed: int, batch: int, golden: dict, codec,
                     card: str) -> dict:
    """Per-image tables at 768x512 with the reference weights, on the
    device coder (kernels B and C once an image) and on the native coder,
    each a counted round whose x_hat must equal the golden transform, the
    two coders' containers equal byte for byte; the native coder with the
    static CDFs, equal to the main path's containers byte for byte; and
    the serial hyperprior format on one image, whose y_hat must equal the
    device format's.  Returns the counted rounds' launches."""
    from simple_image_compression_network_tpu_torch.codec import (
        container, int_codec)
    net, x, cdfs = golden["net"], golden["x"], golden["cdfs"]
    table_bytes = 2 * 192 * 129
    counts, made = {}, {}
    for coder, path, expect in (
            ("device", "per-image tables", per_image_round(batch)),
            ("native", "per-image tables, native", HOST_ROUND)):
        int_codec.decompress_batch(net, int_codec.compress_batch(
            net, x, coder=coder), coder=coder)                   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        blobs = made[coder] = int_codec.compress_batch(net, x, coder=coder)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x_hat, _ = int_codec.decompress_batch(net, blobs, coder=coder)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts[path] = read_exact(path, expect)
        require_equal(f"{path}: x_hat == golden", x_hat, golden["x_ref"])
        for bl in blobs:
            if len(container.unpack(bl)[1][1]) != table_bytes:
                raise AssertionError("a container without its 49,536 bytes "
                                     "of tables")
        n_bytes = sum(len(bl) for bl in blobs)
        enc_med = median_ms(lambda: int_codec.compress_batch(net, x,
                                                             coder=coder))
        dec_med = median_ms(lambda: int_codec.decompress_batch(
            net, blobs, coder=coder))
        log(f"per-image tables, {coder} coder [{card}]: B={batch} 768x512, "
            f"{n_bytes} container bytes ({table_bytes} of tables each), "
            f"{8 * n_bytes / (batch * H * W)} bpp; encode "
            f"{(t1 - t0) * 1e3} ms, decode {(t2 - t1) * 1e3} ms, host clock;"
            f" median of {MEDIAN_CALLS} more: encode {enc_med} ms, decode "
            f"{dec_med} ms")
    if made["device"] != made["native"]:
        raise AssertionError("per-image tables: the device coder's "
                             "containers differ from the native coder's")
    log("per-image tables: the device coder's containers (kernels B and C "
        "once an image) == the native coder's")

    t0 = time.perf_counter()
    static = int_codec.compress_batch(net, x, static_cdfs=cdfs,
                                      coder="native")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_s, _ = int_codec.decompress_batch(net, static, static_cdfs=cdfs,
                                        coder="native")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if static != golden["blobs"]:
        raise AssertionError("native coder, static CDFs: containers differ "
                             "from the main path's")
    require_equal("native coder, static CDFs: x_hat == golden", x_s,
                  golden["x_ref"])
    enc_med = median_ms(lambda: int_codec.compress_batch(
        net, x, static_cdfs=cdfs, coder="native"))
    dec_med = median_ms(lambda: int_codec.decompress_batch(
        net, static, static_cdfs=cdfs, coder="native"))
    log(f"static CDFs on the native coder [{card}]: containers == the main "
        f"path's; encode {(t1 - t0) * 1e3} ms, decode {(t2 - t1) * 1e3} ms, "
        f"host clock; median of {MEDIAN_CALLS} more: encode {enc_med} ms, "
        f"decode {dec_med} ms")

    x1 = torch.from_numpy(make_images(seed + 1, 1)).to(net.device)
    x1 = x1.to(torch.float32) / 255.0
    codec.decompress(codec.compress(x1))                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = codec.compress(x1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, y_serial = codec.decompress(data)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dev_blob = codec.compress_batch(x1)[0]
    _, y_dev = codec.decompress_batch([dev_blob])
    require_equal("hyper serial y_hat == the device format's", y_serial,
                  y_dev)
    enc_med = median_ms(lambda: codec.compress(x1))
    dec_med = median_ms(lambda: codec.decompress(data))
    log(f"hyper serial format [{card}]: B=1 768x512, {len(data)} container "
        f"bytes, {8 * len(data) / (H * W)} bpp (the device format on the "
        f"same image: {len(dev_blob)} bytes, "
        f"{8 * len(dev_blob) / (H * W)} bpp); encode {(t1 - t0) * 1e3} ms,"
        f" decode {(t2 - t1) * 1e3} ms, host clock; median of {MEDIAN_CALLS}"
        f" more: encode {enc_med} ms, decode {dec_med} ms; y_hat == the "
        f"device format's")
    return counts


def host_ms(fn, iters: int = 5) -> float:
    """Mean host-clock time of fn() ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def hyper_breakdown(seed: int, batch: int, dev, codec) -> None:
    """Where the hyper path's time goes: each stage alone (host clock,
    synchronized), g_s under other cuDNN settings, and the device kernels
    of one compress + decompress by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    model = codec.model
    x = torch.from_numpy(make_images(seed + 1, batch)).to(dev)
    x = x.to(torch.float32) / 255.0
    y, z = model.analysis_arrays(x)
    sigma = model.scales_from_z(z)
    ctx = codec._scale_ctx(sigma)
    yi, zi = torch.round(y).to(torch.int32), z.to(torch.int32)
    y_hat = yi.to(torch.float32)
    blobs = codec.compress_batch(x)
    stages = [
        ("compress_batch", lambda: codec.compress_batch(x)),
        ("  g_a + h_a (analysis_arrays)", lambda: model.analysis_arrays(x)),
        ("  h_s, image by image (_prior_from_z)",
         lambda: codec._prior_from_z(z)),
        ("  scale bins", lambda: codec._scale_ctx(sigma)),
        ("  entropy_encode (B, D, fetches, packing)",
         lambda: codec.entropy_encode(yi, zi, ctx, H, W)),
        ("decompress_batch", lambda: codec.decompress_batch(blobs)),
        ("  g_s (decode_arrays)", lambda: model.decode_arrays(y_hat)),
    ]
    for name, fn in stages:
        log(f"hyper breakdown B={batch}: {name}: {host_ms(fn)} ms")
    y_nchw = y_hat.permute(0, 3, 1, 2).contiguous()
    for det, tf32 in ((True, False), (False, False), (False, True)):
        def g_s():
            with torch.no_grad(), torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=det,
                    allow_tf32=tf32):
                model.g_s(y_nchw)
        log(f"hyper breakdown B={batch}: g_s alone, cuDNN deterministic={det} "
            f"tf32={tf32}: {host_ms(g_s)} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        codec.decompress_batch(codec.compress_batch(x))
        torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="device_time_total",
                                  row_limit=25, max_name_column_width=70))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        log("CUDA is not available: chip_smoke needs a GPU")
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    with phase("device"):
        smi = smi_line()
        log(f"nvidia-smi: {smi}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s)")

    with phase("build"):
        from simple_image_compression_network_tpu_torch import _build
        t0 = time.perf_counter()
        path, build_log = _build.build()
        _build.lib()
        log(f"nvcc build: {time.perf_counter() - t0:.1f} s -> {path}")
        report_conv_build(path, build_log)

    from simple_image_compression_network_tpu_torch.utils import weights_io
    cdfs = weights_io.load_static_cdfs(
        os.path.join(ROOT, "checkpoints", "latent_cdfs.npz"))

    with phase("hyperprior checkpoint and tables"):
        from simple_image_compression_network_tpu_torch.codec import (
            hyper_codec)
        for path in CKPTS.values():
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} is missing: the hyper paths need it "
                    f"(.chiprunignore must let it through)")
        codec = hyper_codec.HyperCodec.from_checkpoint(HYPER_CKPT,
                                                       device=dev)
        ms_codec = hyper_codec.MeanScaleCodec.from_checkpoint(
            MEANSCALE_CKPT, device=dev)

    with phase("kernels against their plain versions"):
        errs = check_kernels(rng, cdfs, dev)
        check_dense(rng, cdfs, dev, errs)
        check_lane_edges(rng, cdfs, dev, errs)
        check_hyper_kernels(rng, codec, args.batch, dev, errs)
        check_layers(rng, args.batch, dev, errs)
        check_edges(rng, args.batch, dev, errs)

    with phase("int8 main path at 768x512"):
        int8, golden = main_path(args.seed, args.batch, dev, smi)
    with phase("int8 transform under the Pallas plans at 768x512"):
        plans = plans_path(args.batch, golden, smi)
    with phase("native golden at the L0 and L7 shapes"):
        native_golden_path(golden, dev)
    with phase("TMR at the L1 shape"):
        tmr_path(golden, dev)
    with phase("ops/nn on the card"):
        nn_path(rng, dev)
    with phase("utils/dump on the card"):
        dump_path(dev)
    with phase("dense-flag encode of the int8 latent"):
        dense = dense_encode_path(args.batch, golden)
    with phase("hyper path at 768x512"):
        hyper = hyper_path(args.seed, args.batch, dev, smi, codec)
    with phase(f"kernel G at g_s's four layers, B = {G_BATCH}, 768x512"):
        kernel_g_path(codec, args.seed, dev)
    with phase("mean-scale hyper path at 768x512"):
        meanscale = meanscale_path(args.seed, args.batch, dev, smi, ms_codec,
                                   codec, errs)
    with phase("bf16 serving path of both hyperpriors at 768x512"):
        bf16 = bf16_path(args.seed, args.batch, dev, smi,
                         {"scale": codec, "meanscale": ms_codec})
    with phase("device chain at 768x512"):
        chain = chain_path(args.batch, golden, smi)
    with phase("pipelined codecs at 768x512"):
        piped = pipelines_path(args.seed, args.batch, golden, codec, smi)
        piped.update(meanscale_pipelines(args.seed, args.batch, ms_codec,
                                         smi))
    with phase("wavelet codec at 768x512"):
        wavelet = wavelet_path(args.seed, args.batch, dev, smi, errs)
    with phase("host coders and per-image tables at 768x512"):
        host = host_coders_path(args.seed, args.batch, golden, codec, smi)
    with phase("eval_codec entry point, 4 synthetic 768x512 images"):
        evals = eval_path(smi)
    with phase("float RD training at crop 256"):
        train_step_check(args.seed, dev)
        trained_ckpt = train_loop_path(args.seed, smi)
        train_block_path(args.seed, dev, smi)
        trained = train_eval_path(trained_ckpt, args.seed, args.batch, dev,
                                  smi)
        train_dp_path(args.seed, smi)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    with phase("integer wrap-STE training at crop 256"):
        intnet_layers_check(args.seed, dev)
        intnet_step_check(args.seed, dev)
        ent_grad_spread(args.seed, dev)
        intnet_block = intnet_block_path(args.seed, dev, smi)
        intnet_run, intnet_runs = train_intnet_path(args.seed, smi)
        intnet_codec = intnet_codec_path(intnet_run, args.seed, args.batch,
                                         dev, smi)
        train_sp_path(args.seed, dev, smi)
        header_round_trip(smi)
        shutil.rmtree(INTNET_DIR, ignore_errors=True)
    with phase("sharded int8 codec at 768x512 and hyperprior codecs at "
               "1024x1024 on 1, 2 and 4 ranks"):
        sharded = sharded_path(args.seed, args.batch, golden,
                               {"scale": codec, "meanscale": ms_codec}, smi)
    del golden
    paths = {"int8": int8, **plans, "dense encode": dense, "hyper": hyper,
             "meanscale": meanscale, **bf16, "device chain": chain, **piped,
             **wavelet, **host, **evals, "trained hyper": trained,
             "intnet wrap block": intnet_block, **intnet_runs,
             "trained int8": intnet_codec, **sharded}
    launches = {name: {path: c[name] for path, c in paths.items()
                       if name in c} for name in counted()}
    launches["conv3x3_s1_int8 (pallas plan)"] = {
        "pallas": plans["pallas"]["conv3x3_s1_int8"]}

    with phase("kernel timing at the paths' shapes"):
        layers = time_layers(rng, args.batch, dev)
        layers["new_shapes"] = time_new_shapes(rng, args.batch, dev, errs)
        kernels = time_kernels(rng, cdfs, codec, args.batch, dev, errs,
                               launches, layers)

    with phase("hyper path breakdown"):
        hyper_breakdown(args.seed, args.batch, dev, codec)

    faulthandler.cancel_dump_traceback_later()
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
