#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--batch B]

Builds the port's CUDA kernels from ``simple_image_compression_network_tpu_torch/
csrc`` (one nvcc call), holds each kernel bit-exactly against its plain
PyTorch version, then drives the port's main path at full width: the int8
codec's ``compress_batch`` then ``decompress_batch`` on B random-seeded
768x512 images with the reference weights and the static latent CDFs.  The
round trip is checked against the direct golden transform (plain float64
convolutions, independent of kernel A), the launch counts show that the
main path ran on the kernels, and each kernel is timed at the main path's
shapes beside its plain version and its bound.

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
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 600          # a hang ends as a traceback and a non-zero exit
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth (data sheet)
H, W = 768, 512           # the reference geometry
# (C, N) of kernel A's eight layer forms: s2d L0-L3, d2s L4-L6, s2dtail L7
LAYER_FORMS = [("L0 s2d", 12, 128), ("L1 s2d", 512, 128),
               ("L2 s2d", 512, 128), ("L3 s2d", 512, 192),
               ("L4 d2s", 192, 512), ("L5 d2s", 128, 512),
               ("L6 d2s", 128, 512), ("L7 s2dtail", 512, 48)]
# input grid of each form per 768x512 image (the coarse grid it runs on)
FORM_GRID = [(384, 256), (192, 128), (96, 64), (48, 32),
             (48, 32), (96, 64), (192, 128), (192, 128)]


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


def make_images(seed: int, b: int) -> np.ndarray:
    """Smooth colour gradients plus noise, uint8 (B, 768, 512, 3)."""
    rng = np.random.default_rng(seed)
    i = np.arange(H, dtype=np.float64)[:, None, None]
    j = np.arange(W, dtype=np.float64)[None, :, None]
    out = []
    for _ in range(b):
        f = rng.uniform(0.005, 0.03, size=(2, 3))
        ph = rng.uniform(0, 2 * np.pi, size=(2, 3))
        img = (128 + 70 * np.sin(f[0] * i + ph[0]) * np.cos(f[1] * j + ph[1])
               + rng.normal(0, 6, size=(H, W, 3)))
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


def check_kernels(rng, cdfs: np.ndarray, dev) -> dict:
    """Each kernel against its plain version on CPU copies, bit-exact.
    Returns the max |diff| per kernel (0 when it passes)."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf)
    from simple_image_compression_network_tpu_torch.ops import cuda_conv

    errs = {"conv3x3_s1_int8": 0, "rans_encode": 0, "rans_decode": 0}
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

    # the flagship geometry (S = 16 streams for B = 2, t = 96, N = 384),
    # then a ragged lane count that leaves part of a warp idle
    for s, t, n in ((16, 96, 384), (3, 40, 200)):
        lane_cdf = np.ascontiguousarray(_lane_cdf(cdfs, n), np.int32)
        syms = torch.from_numpy(lane_symbols(rng, lane_cdf, s, t)).to(dev)
        lc = torch.from_numpy(lane_cdf).to(dev)
        words, counts = cuda_rans.encode_batch_compact(syms, lc)
        ref_w, ref_c = cuda_rans.encode_batch_compact_plain(syms.cpu(),
                                                            lc.cpu())
        errs["rans_encode"] = max(
            errs["rans_encode"],
            require_equal(f"kernel B counts S={s} t={t} N={n}", counts,
                          ref_c),
            require_equal(f"kernel B words S={s} t={t} N={n}",
                          words.to(torch.int32) & 0xFFFF,
                          ref_w.to(torch.int32) & 0xFFFF))
        x0 = cuda_rans.split_init(words, n)
        out, cons, xfin = cuda_rans.decode(words, x0, lc, t)
        r_out, r_cons, r_xfin = cuda_rans.decode_plain(
            words.cpu(), x0.cpu(), lc.cpu(), t)
        errs["rans_decode"] = max(
            errs["rans_decode"],
            require_equal(f"kernel C syms S={s}", out, r_out),
            require_equal(f"kernel C consumed S={s}", cons, r_cons),
            require_equal(f"kernel C x_fin S={s}", xfin, r_xfin))
        require_equal(f"round trip S={s}", out, syms)
        require_equal(f"consumed == count S={s}", cons, counts)
        if not bool((xfin == 1 << 16).all()):
            raise AssertionError("final decoder states != 2^16")
        # a truncated buffer: reads past it give 0 in both versions
        cut = words[:, : 2 * n + 5].contiguous()
        got = cuda_rans.decode(cut, x0, lc, t)
        ref = cuda_rans.decode_plain(cut.cpu(), x0.cpu(), lc.cpu(), t)
        for what, g, r in zip(("syms", "consumed", "x_fin"), got, ref):
            errs["rans_decode"] = max(errs["rans_decode"], require_equal(
                f"kernel C truncated {what} S={s}", g, r))
        log(f"kernels B, C: S={s} t={t} N={n} bit-exact, "
            f"{int(counts.sum())} words")
    return errs


def time_kernels(rng, cdfs, batch: int, dev, errs: dict,
                 launches: dict) -> list:
    """Each kernel at the main path's shapes: kernel, plain version (on
    the card) and bound.  The plain versions repeat the kernel's function,
    so their outputs are compared too.  ``launches`` are the main path's
    counts."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf, plan_streams)
    from simple_image_compression_network_tpu_torch.ops import cuda_conv

    ms = plain_ms = bound_ms = 0.0
    for (name, c, n), (gx, gy) in zip(LAYER_FORMS, FORM_GRID):
        xs, w3, bias = conv_inputs(rng, batch, gx, gy, c, n, dev)
        got = cuda_conv.conv3x3_s1_int8(xs, w3, bias)
        ref = cuda_conv.conv3x3_s1_int8_plain(xs, w3, bias)
        errs["conv3x3_s1_int8"] = max(errs["conv3x3_s1_int8"], require_equal(
            f"kernel A {name} full shape", got, ref))
        k = cuda_ms(lambda: cuda_conv.conv3x3_s1_int8(xs, w3, bias), 20)
        p = cuda_ms(lambda: cuda_conv.conv3x3_s1_int8_plain(xs, w3, bias), 3)
        ops = 2 * batch * gx * gy * n * 9 * c
        nbytes = xs.numel() + w3.numel() + n + got.numel()
        bnd = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        log(f"kernel A {name} {batch}x{gx}x{gy}x{c}->{n}: {k:.4f} ms, "
            f"plain {p:.3f} ms, bound {bnd:.4f} ms "
            f"({ops / k / 1e9:.1f} Gop/s)")
        ms, plain_ms, bound_ms = ms + k, plain_ms + p, bound_ms + bnd

    zx, zy = H // 16, W // 16
    s_img, lm = plan_streams(zx * zy)
    s, n = batch * s_img, lm * 192
    t = zx * zy // lm // s_img
    lane_cdf = np.ascontiguousarray(_lane_cdf(cdfs, n), np.int32)
    syms = torch.from_numpy(lane_symbols(rng, lane_cdf, s, t)).to(dev)
    lc = torch.from_numpy(lane_cdf).to(dev)
    words, counts = cuda_rans.encode_batch_compact(syms, lc)
    x0 = cuda_rans.split_init(words, n)
    n_words = int(counts.sum())
    enc_ms = cuda_ms(lambda: cuda_rans.encode_batch_compact(syms, lc), 20)
    enc_plain = cuda_ms(
        lambda: cuda_rans.encode_batch_compact_plain(syms, lc), 3)
    dec_ms = cuda_ms(lambda: cuda_rans.decode(words, x0, lc, t), 20)
    dec_plain = cuda_ms(lambda: cuda_rans.decode_plain(words, x0, lc, t), 3)
    # each input read once, each output written once (words as written)
    table = lane_cdf.size * 4
    states = 4 * x0.numel()
    enc_bytes = syms.numel() + table + 2 * n_words + 4 * s
    dec_bytes = (2 * n_words + states + table         # words, x0, table in
                 + syms.numel() + 4 * s + states)    # syms, consumed, x_fin
    log(f"kernel B S={s} t={t} N={n}: {enc_ms:.4f} ms, plain "
        f"{enc_plain:.3f} ms; kernel C: {dec_ms:.4f} ms, plain "
        f"{dec_plain:.3f} ms; {n_words} words")

    def entry(name, source, replaces, launches, err, k, p, bnd, unit):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": k, "plain_ms": p,
                "bound_ms": bnd, "bound_by": "operations" if name ==
                "conv3x3_s1_int8" else "bytes",
                "library_ms": None, "unit": unit}
    pkg = "simple_image_compression_network_tpu_torch/csrc/"
    return [
        entry("conv3x3_s1_int8", pkg + "conv3x3_int8.cu",
              "simple_image_compression_network_tpu/ops/pallas_conv.py:177",
              launches["conv3x3_s1_int8"], errs["conv3x3_s1_int8"],
              ms, plain_ms, bound_ms,
              f"sum of the 8 layer forms, one launch each, B={batch} "
              f"768x512"),
        entry("rans_encode", pkg + "rans_encode.cu",
              "simple_image_compression_network_tpu/codec/pallas_rans.py:514",
              launches["rans_encode"], errs["rans_encode"],
              enc_ms, enc_plain, enc_bytes / PEAK_BYTES * 1e3,
              f"one launch, S={s} t={t} N={n}"),
        entry("rans_decode", pkg + "rans_decode.cu",
              "simple_image_compression_network_tpu/codec/pallas_rans.py:121",
              launches["rans_decode"], errs["rans_decode"],
              dec_ms, dec_plain, dec_bytes / PEAK_BYTES * 1e3,
              f"one launch, S={s} t={t} N={n}"),
    ]


def reset_counts() -> None:
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
    for fn in (cuda_conv.conv3x3_s1_int8, cuda_rans.encode_batch_compact,
               cuda_rans.decode):
        fn.launches = 0
        fn.plain_runs = 0


def main_path(seed: int, batch: int, dev, card: str) -> dict:
    """compress_batch then decompress_batch at 768x512, checked against the
    golden transform.  Returns the launch counts, read right after."""
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, int_codec)
    from simple_image_compression_network_tpu_torch.models import codec_int
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
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
    counts = {"conv3x3_s1_int8": cuda_conv.conv3x3_s1_int8.launches,
              "rans_encode": cuda_rans.encode_batch_compact.launches,
              "rans_decode": cuda_rans.decode.launches}
    plain = (cuda_conv.conv3x3_s1_int8.plain_runs
             + cuda_rans.encode_batch_compact.plain_runs
             + cuda_rans.decode.plain_runs)
    log(f"launches on the main path: {counts}, plain runs: {plain}")
    if min(counts.values()) < 1 or plain:
        raise AssertionError("the main path did not run on every kernel")
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
    return counts


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
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    from simple_image_compression_network_tpu_torch.utils import weights_io
    cdfs = weights_io.load_static_cdfs(
        os.path.join(ROOT, "checkpoints", "latent_cdfs.npz"))

    with phase("kernels against their plain versions"):
        errs = check_kernels(rng, cdfs, dev)

    with phase("main path at 768x512"):
        launches = main_path(args.seed, args.batch, dev, smi)

    with phase("kernel timing at the main path's shapes"):
        kernels = time_kernels(rng, cdfs, args.batch, dev, errs, launches)

    faulthandler.cancel_dump_traceback_later()
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
