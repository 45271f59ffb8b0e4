#!/usr/bin/env python3
"""Time the port's rANS kernels from one checkout, for A/B comparisons:
the decoders C and E and the encoders B, D and H.

    python3 scripts/torch_rans_ab.py [ROOT]

ROOT (default: this checkout) holds the package
``simple_image_compression_network_tpu_torch``; its kernels are built there.
Prints the card's name and power limit, then for kernels C and B at the int8
latent's shape (S = 16, t = 96, N = 384, rows of 130, the static latent
CDFs) and at the hyper-latent z's (S = 2, t = 48, N = 256, rows of 129, the
trained hyperprior's factorized CDFs), kernels E and D at the hyper y shape
(S = 16, t = 96, N = 384, 64 scale-bin rows of 257, uniform contexts), and
kernel H at the int8 latent's shape for B = 2 (S = 16) and B = 32 (S = 256),
on int8 symbols where ROOT's kernel reads them and on int32, with its
wrapper and ``encode_batch`` on int8, where ROOT picks its streams a block
at 1, 2, 4 and 8 of them, and at S = 16 for t = 24, 96 and 192 with the
time a step and the intercept of a line through them: the kernel's device
time and per step
(CUDA events around 20 calls queued behind a spin kernel, after one
warm-up, of a call that launches the kernel alone with its outputs and
table layout made ahead: the private launcher ``cuda_rans._decode``,
``_decode_ctx``, ``_encode``, ``_encode_ctx`` or ``_encode_dense`` where
ROOT has one, else ROOT's C entry point through ctypes) and the wrapper's
time a call (CUDA events, mean of 50, host included).  The symbols and
contexts are made from a fixed seed; each kernel launched alone is checked
against its wrapper, each decode against the symbols.  To compare two
checkouts, unpack the other one (``git archive``) into a directory that
.gitignore lists and run both on one card, one after the other, in turns:
other, this, this, other.  Needs a CUDA card and checkpoints/ under this
checkout; imports torch and numpy.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CKPT = os.path.join(HERE, "checkpoints")


def cuda_ms(fn, iters: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 20) -> float:
    """Device time a call of fn(), which launches one kernel: the calls
    wait behind a spin kernel (``torch.cuda._sleep``) until all are
    queued, so the host's time stays out of the window."""
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
        covered = not start.query()     # the spin outlasted the queueing
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the spin kernel never outlasted the queueing")


def lane_syms(rng, lane_cdf: np.ndarray, s: int, t: int) -> np.ndarray:
    """(S, t, N) int8 symbols from each lane's row, below its last one."""
    n = lane_cdf.shape[0]
    syms = np.empty((s, t, n), np.int8)
    for k in range(n):
        u = rng.integers(0, lane_cdf[k, -2], size=(s, t))
        syms[:, :, k] = np.searchsorted(lane_cdf[k, 1:], u, side="right")
    return syms


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("CUDA is not available: this script times kernels on a card")
        return 2
    sys.path.insert(0, root)
    from simple_image_compression_network_tpu_torch import _build
    from simple_image_compression_network_tpu_torch.codec import (
        cuda_rans, hyper_codec)
    from simple_image_compression_network_tpu_torch.codec.int_codec import (
        _lane_cdf)
    from simple_image_compression_network_tpu_torch.utils import weights_io
    _, log = _build.build()
    lib = _build.lib()
    for line in log.splitlines():
        if "registers" in line:
            print("  ptxas:", line.strip())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    codec = hyper_codec.HyperCodec.from_checkpoint(
        os.path.join(CKPT, "hp_scale_l0.01.params.msgpack"), device=dev)
    cdfs = weights_io.load_static_cdfs(os.path.join(CKPT, "latent_cdfs.npz"))
    alone = hasattr(cuda_rans, "_decode")
    stream = torch.cuda.current_stream().cuda_stream
    ok = True

    def run(tag, words, x0, table, ctx, syms, t):
        nonlocal ok
        s, cap = words.shape
        n = x0.shape[1]
        dec = cuda_rans.decode if ctx is None else cuda_rans.decode_ctx
        args = (table,) if ctx is None else (table, ctx)
        out = dec(words, x0, *args, t)
        torch.cuda.synchronize()
        if not torch.equal(out[0].to(torch.int64).cpu(),
                           syms.to(torch.int64).cpu()):
            print(f"{tag}: the decode lost the symbols")
            ok = False
        outs = tuple(torch.empty_like(o) for o in out)
        if alone and ctx is None:
            tb = cuda_rans.kernel_table(table, n, False)

            def kernel():
                cuda_rans._decode(words, x0, table, t, tb, outs)
        elif alone:
            tb = cuda_rans.kernel_table(table, n, True)

            def kernel():
                cuda_rans._decode_ctx(words, x0, table, ctx, t, tb, outs)
        elif ctx is None:
            def kernel():
                _build.check(lib.sicn_rans_decode(
                    words.data_ptr(), x0.data_ptr(), table.data_ptr(),
                    *[o.data_ptr() for o in outs], s, cap, t, n,
                    table.shape[1], stream), "rans decode")
        else:
            def kernel():
                _build.check(lib.sicn_rans_decode_ctx(
                    words.data_ptr(), x0.data_ptr(), ctx.data_ptr(),
                    table.data_ptr(), *[o.data_ptr() for o in outs], s, cap,
                    t, n, table.shape[0], table.shape[1], stream),
                    "rans decode ctx")
        kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, out)):
            print(f"{tag}: the kernel launched alone differs from the "
                  f"wrapper")
            ok = False
        k = kernel_ms(kernel)
        w = cuda_ms(lambda: dec(words, x0, *args, t))
        print(f"{tag} S={s} t={t} N={n} L+1={table.shape[1]} [{root}, "
              f"{card}]: kernel {k:.4f} ms ({k * 1e3 / t:.3f} us a step), "
              f"wrapper {w:.4f} ms a call", flush=True)

    def encode_alone(tag, enc, args, outs, kernel, t):
        """Time a call of an encode kernel alone (``kernel``, writing into
        ``outs``) and its wrapper ``enc(*args)``; the two must agree."""
        nonlocal ok
        ref = enc(*args)
        kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
            print(f"{tag}: the kernel launched alone differs from the "
                  f"wrapper")
            ok = False
        k = kernel_ms(kernel)
        w = cuda_ms(lambda: enc(*args))
        print(f"{tag} {tuple(args[0].shape)} [{root}, {card}]: kernel "
              f"{k:.4f} ms ({k * 1e3 / t:.3f} us a step), wrapper {w:.4f} "
              f"ms a call", flush=True)

    def encode_b(tag, syms, lc):
        s, t, n = syms.shape
        if hasattr(cuda_rans, "_encode"):
            tb = cuda_rans.encode_kernel_table(lc, n, t, False)
            outs = cuda_rans._encode_outputs(s, t, n, tb[1], dev)

            def kernel():
                cuda_rans._encode(syms, lc, tb, outs)
        else:
            outs = (torch.zeros((s, 2 * n + t * n), dtype=torch.int16,
                                device=dev),
                    torch.empty((s,), dtype=torch.int32, device=dev),
                    torch.empty((s, t, n), dtype=torch.int32, device=dev))

            def kernel():
                _build.check(lib.sicn_rans_encode(
                    syms.data_ptr(), lc.data_ptr(), outs[2].data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), s, t, n,
                    lc.shape[1], outs[0].shape[1], stream), "rans encode")
        encode_alone(tag, cuda_rans.encode_batch_compact, (syms, lc),
                     outs[:2], kernel, t)

    def encode_d(tag, syms, yt, ctx):
        s, t, n = syms.shape
        if hasattr(cuda_rans, "_encode_ctx"):
            tb = cuda_rans.encode_kernel_table(yt, n, t, True)
            outs = cuda_rans._encode_outputs(s, t, n, tb[1], dev)

            def kernel():
                cuda_rans._encode_ctx(syms, yt, ctx, tb, outs)
        else:
            outs = (torch.zeros((s, 2 * n + t * n), dtype=torch.int16,
                                device=dev),
                    torch.empty((s,), dtype=torch.int32, device=dev),
                    torch.empty((s, t, n), dtype=torch.int32, device=dev))

            def kernel():
                _build.check(lib.sicn_rans_encode_ctx(
                    syms.data_ptr(), ctx.data_ptr(), yt.data_ptr(),
                    outs[2].data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), s, t, n, yt.shape[0], yt.shape[1],
                    outs[0].shape[1], stream), "rans encode ctx")
        encode_alone(tag, cuda_rans.encode_batch_compact_ctx,
                     (syms, yt, ctx), outs[:2], kernel, t)

    def h_kernel(sy, lc, outs):
        """A call that launches kernel H alone on ``sy`` into ``outs``:
        ROOT's private launcher with its table layouts made ahead, else its
        C entry point."""
        s, t, n = sy.shape
        if hasattr(cuda_rans, "encode_dense_table"):
            tb = cuda_rans.encode_dense_table(lc)
            return lambda: cuda_rans._encode_dense(sy, lc, tb, outs)
        if hasattr(cuda_rans, "_encode_dense"):
            return lambda: cuda_rans._encode_dense(sy, lc, out=outs)
        return lambda: _build.check(lib.sicn_rans_encode_dense(
            sy.data_ptr(), lc.data_ptr(), *[o.data_ptr() for o in outs], s,
            t, n, lc.shape[1], stream), "rans encode dense")

    def encode_h(tag, syms, lc):
        """Kernel H alone on the int8 symbols where ROOT's kernel reads
        int8 (it has ``encode_dense_table``), and on an int32 copy made
        ahead (the first kernel H read int32 only, its wrapper cast int8
        first); then its wrapper and ``encode_batch`` on the int8 symbols
        as the main path gives them; where ROOT picks kernel H's streams
        a block (``dense_streams``), the kernel on int8 at 1, 2, 4 and 8
        streams a block through ROOT's C entry point."""
        s, t, n = syms.shape
        new = hasattr(cuda_rans, "encode_dense_table")
        for sy in (syms, syms.to(torch.int32)) if new else (
                syms.to(torch.int32),):
            outs = tuple(torch.empty_like(o)
                         for o in cuda_rans.encode_dense(sy, lc))
            encode_alone(f"{tag} {str(sy.dtype)[6:]} symbols",
                         cuda_rans.encode_dense, (sy, lc), outs,
                         h_kernel(sy, lc, outs), t)
        w = cuda_ms(lambda: cuda_rans.encode_dense(syms, lc))
        eb = cuda_ms(lambda: cuda_rans.encode_batch(syms, lc))
        print(f"{tag} {tuple(syms.shape)} [{root}, {card}]: wrapper on int8 "
              f"symbols {w:.4f} ms a call, encode_batch {eb:.4f} ms a call",
              flush=True)
        if not hasattr(cuda_rans, "dense_streams"):
            return
        ref = cuda_rans.encode_dense(syms, lc)
        outs = tuple(torch.empty_like(o) for o in ref)
        packed = cuda_rans.stage_lane_packed(lc)
        for rows in (1, 2, 4, 8):
            def kernel():
                _build.check(lib.sicn_rans_encode_dense(
                    syms.data_ptr(), packed.data_ptr(), None,
                    *[o.data_ptr() for o in outs], s, t, n, lc.shape[1],
                    rows, 1, cuda_rans.ENC_STAGED, stream),
                    "rans encode dense")
            kernel()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, ref))
            ok_and(same, f"{tag} at {rows} streams a block differs")
            k = kernel_ms(kernel)
            print(f"{tag} {tuple(syms.shape)} int8, blocks of 32 lanes x "
                  f"{rows} stream(s) [{root}, {card}]: kernel {k:.4f} ms "
                  f"({k * 1e3 / t:.3f} us a step)"
                  f"{'' if same else ', DIFFERS'}", flush=True)

    def h_per_step(tag, lc, s):
        """Kernel H alone at S = ``s`` for t = 24, 96 and 192 (int8 symbols
        where ROOT reads them, else int32): the slope of a line through
        the three times is its time a step, the intercept what a call
        costs besides."""
        dt = torch.int8 if hasattr(cuda_rans, "encode_dense_table") \
            else torch.int32
        steps = (24, 96, 192)
        times = []
        for t in steps:
            sy = torch.from_numpy(lane_syms(rng, lc.cpu().numpy(), s,
                                            t)).to(dev).to(dt)
            ref = cuda_rans.encode_dense(sy, lc)
            outs = tuple(torch.empty_like(o) for o in ref)
            kernel = h_kernel(sy, lc, outs)
            kernel()
            torch.cuda.synchronize()
            ok_and(all(torch.equal(a, b) for a, b in zip(outs, ref)),
                   f"{tag} t={t}: the kernel launched alone differs")
            times.append(kernel_ms(kernel))
        slope, icept = np.polyfit(np.array(steps, np.float64),
                                  np.array(times), 1)
        print(f"{tag} S={s} t={steps} {str(dt)[6:]} symbols [{root}, "
              f"{card}]: kernel {', '.join(f'{m:.4f}' for m in times)} ms; "
              f"{slope * 1e3:.4f} us a step ({slope * 1.98e6:.0f} cycles at "
              f"the 1.98 GHz boost clock), intercept {icept * 1e3:.2f} us",
              flush=True)

    def ok_and(cond, msg):
        nonlocal ok
        if not cond:
            print(msg)
            ok = False
        return ok

    lane_cases = []
    for tag, table, s, t in (
            ("int8 latent", _lane_cdf(cdfs, 384), 16, 96),
            ("hyper z",
             codec.z_cdfs[np.arange(256) % codec.z_cdfs.shape[0]], 2, 48)):
        table = np.ascontiguousarray(table, np.int32)
        syms = torch.from_numpy(lane_syms(rng, table, s, t)).to(dev)
        lc = torch.from_numpy(table).to(dev)
        lane_cases.append((tag, syms, lc))
        words, _ = cuda_rans.encode_batch_compact(syms, lc)
        run(f"kernel C, {tag}", words,
            cuda_rans.split_init(words, table.shape[0]), lc, None, syms, t)
    y_table = np.ascontiguousarray(codec.y_cdfs_dev, np.int32)
    s, t, n = 16, 96, 384
    ctx = rng.integers(0, y_table.shape[0], size=(s, t, n)).astype(np.int32)
    u = rng.integers(0, 65536, size=(s, t, n))
    syms = (y_table[ctx][..., 1:-1] <= u[..., None]).sum(-1).astype(np.int32)
    yt = torch.from_numpy(y_table).to(dev)
    syms_d = torch.from_numpy(syms).to(dev)
    ctx_d = torch.from_numpy(ctx).to(dev)
    words, _ = cuda_rans.encode_batch_compact_ctx(syms_d, yt, ctx_d)
    run("kernel E, hyper y", words, cuda_rans.split_init(words, n), yt,
        ctx_d, syms_d, t)
    for tag, syms_b, lc in lane_cases:
        encode_b(f"kernel B, {tag}", syms_b, lc)
    encode_d("kernel D, hyper y", syms_d, yt, ctx_d)
    tag, syms_b, lc = lane_cases[0]
    encode_h(f"kernel H, {tag}", syms_b, lc)
    h_per_step(f"kernel H, {tag}", lc, syms_b.shape[0])
    # a serving batch: B = 32 images, S = 256 streams of the int8 latent
    syms_256 = torch.from_numpy(lane_syms(rng, lc.cpu().numpy(), 256,
                                          syms_b.shape[1])).to(dev)
    encode_h(f"kernel H, {tag} B=32", syms_256, lc)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
