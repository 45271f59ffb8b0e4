#!/usr/bin/env python3
"""Count the shared-memory bank conflicts of kernel E's CDF search, per
table layout, at the hyper y shape (N = 384 lanes, R = 64 rows of 257).

    python3 scripts/rans_bank_conflicts.py [--seed N] [--no-model]

Replays kernel E's symbol search (csrc/rans_decode.cu: three probes a
level over entries 1..L-1 of the row picked by each symbol's context, then
entries sym and sym + 1) on the CPU in numpy, and for every warp request
counts the wavefronts an H100's shared memory needs: the most distinct
32-bit words that the request's lanes touch in any one of the 32 banks.
Two sets of data:

* uniform contexts over the 64 rows with symbols drawn from each row, at
  S = 16, t = 96 (what ``chip_smoke.py`` times kernel E on);
* the trained scale hyperprior's own contexts and symbols on seeded
  256x256 images (S = 4, t = 32 per image), unless ``--no-model``.

Layouts: ``[j][r]`` (entry j of row r at j*R + r) and ``[r][j]`` with an
odd row pitch (r*P + j).  Prints wavefronts per load and per warp step.
Imports numpy, torch and the port's package only; a count, not a time.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CKPT = os.path.join(ROOT, "checkpoints", "hp_scale_l0.01.params.msgpack")


def encode_decode_trace(table, syms, ctx):
    """Encode the (S, t, N) symbols with their rows, decode them again and
    return the slot (x & 0xFFFF) of every decode step, (S, t, N)."""
    import torch
    from simple_image_compression_network_tpu_torch.codec import device_rans
    tt = torch.from_numpy(table)
    words, _ = device_rans.encode(torch.from_numpy(syms), tt,
                                  torch.from_numpy(ctx))
    w = words.numpy().astype(np.int64)
    s, t_steps, n = syms.shape
    x = (w[:, 0:2 * n:2] << 16) | w[:, 1:2 * n:2]
    pos = np.full(s, 2 * n)
    slots = np.empty((s, t_steps, n), np.int64)
    tab = table.astype(np.int64)
    for t in range(t_steps):
        slot = x & 0xFFFF
        slots[:, t] = slot
        rows = tab[ctx[:, t]]                         # (S, N, L1)
        sym = (rows[..., 1:-1] <= slot[..., None]).sum(-1)
        start = np.take_along_axis(rows, sym[..., None], -1)[..., 0]
        freq = np.take_along_axis(rows, sym[..., None] + 1, -1)[..., 0] \
            - start
        x = (freq * (x >> 16) + slot - start) & 0xFFFFFFFF
        need = x < (1 << 16)
        rank = np.cumsum(need, 1) - need
        idx = np.minimum(pos[:, None] + rank, w.shape[1] - 1)
        x = np.where(need, (x << 16) | np.take_along_axis(w, idx, 1), x)
        pos = pos + need.sum(1)
        if not (sym == syms[:, t]).all():
            raise AssertionError("the replayed decode lost the symbols")
    return slots


def probes(table, ctx, slots):
    """Entry j of every load of kernel E's search, in issue order: the
    first level's three probes (loaded a step ahead), three probes a level
    while more than 3 candidates are left, one or two probes for the last
    2 or 3, then entries sym and sym + 1 (csrc/rans_decode.cu)."""
    n = table.shape[1] - 2
    tab = table.astype(np.int64)
    rows = tab[ctx]                                   # (S, t, N, L1)
    sym = np.zeros_like(slots)
    out = []
    length = n + 1

    def at(j):
        return np.take_along_axis(rows, j[..., None], -1)[..., 0]
    while length >= 4:
        q = length >> 2
        js = [sym + q, sym + 2 * q, sym + 3 * q]
        out += js
        acc = sum((at(j) <= slots).astype(np.int64) for j in js)
        sym = sym + acc * q
        length -= 3 * q
    if length > 1:
        js = [sym + 1] + ([sym + 2] if length > 2 else [])
        out += js
        sym = sym + sum((at(j) <= slots).astype(np.int64) for j in js)
    return out + [sym, sym + 1]


def wavefronts(addr: np.ndarray) -> np.ndarray:
    """(..., N) word addresses of one request per warp -> wavefronts per
    warp: the most distinct words in any bank among its 32 lanes."""
    n = addr.shape[-1]
    pad = -(-n // 32) * 32
    a = addr.reshape(-1, n)
    if pad != n:     # idle lanes repeat lane 0's word: no extra wavefront
        a = np.concatenate([a, np.repeat(a[:, :1], pad - n, 1)], 1)
    a = np.sort(a.reshape(-1, 32), axis=1)
    new = np.ones_like(a, dtype=bool)
    new[:, 1:] = a[:, 1:] != a[:, :-1]
    per_bank = np.zeros((a.shape[0], 32), np.int64)
    rows = np.repeat(np.arange(a.shape[0]), 32)
    np.add.at(per_bank, (rows, (a % 32).ravel()), new.ravel())
    return per_bank.max(1)


def count(name: str, table, ctx, slots) -> None:
    r_rows, l1 = table.shape
    pitch = l1 | 1
    loads = probes(table, ctx, slots)
    layouts = {"[j][r]": lambda j: j * r_rows + ctx,
               f"[r][j] pitch {pitch}": lambda j: ctx * pitch + j}
    s, t_steps, n = slots.shape
    warp_steps = s * t_steps * (-(-n // 32))
    print(f"{name}: S={s} t={t_steps} N={n} R={r_rows} L+1={l1}, "
          f"{len(loads)} loads a lane step")
    for lay, fn in layouts.items():
        per_req = [int(wavefronts(fn(j)).sum()) for j in loads]
        print(f"  {lay:>16}: {sum(per_req) / warp_steps:.3f} wavefronts a "
              f"warp step (ideal {len(loads)}); per load "
              f"{[round(v / warp_steps, 3) for v in per_req]}")


def uniform_case(rng, table, s=16, t_steps=96, n=384):
    ctx = rng.integers(0, table.shape[0], size=(s, t_steps, n))
    u = rng.integers(0, table[0, -1], size=(s, t_steps, n))
    syms = np.empty((s, t_steps, n), np.int64)
    for r in range(table.shape[0]):
        m = ctx == r
        syms[m] = np.searchsorted(table[r, 1:], u[m], side="right")
    return syms.astype(np.int32), ctx.astype(np.int32)


def model_case(seed: int, size: int = 256, b: int = 2):
    import torch
    from simple_image_compression_network_tpu_torch.codec import (
        escape, hyper_codec)
    codec = hyper_codec.HyperCodec.from_checkpoint(CKPT, device="cpu")
    rng = np.random.default_rng(seed)
    i = np.arange(size, dtype=np.float64)[:, None, None]
    j = np.arange(size, dtype=np.float64)[None, :, None]
    imgs = []
    for _ in range(b):       # the smooth gradients plus noise of chip_smoke
        f = rng.uniform(0.005, 0.03, size=(2, 3))
        ph = rng.uniform(0, 2 * np.pi, size=(2, 3))
        img = (128 + 70 * np.sin(f[0] * i + ph[0]) * np.cos(f[1] * j + ph[1])
               + rng.normal(0, 6, size=(size, size, 3)))
        imgs.append(np.clip(np.rint(img), 0, 255) / 255.0)
    x = torch.from_numpy(np.stack(imgs).astype(np.float32))
    with torch.no_grad():
        y, _, sigma = codec.encode_parts(x)
        ctx = codec._scale_ctx(sigma)
    s, n, t_steps = hyper_codec._plan_lanes(y.shape[1] * y.shape[2],
                                            y.shape[3])
    syms = escape.to_symbols(y, hyper_codec._Y_MAX_DEV)
    table = np.ascontiguousarray(codec.y_cdfs_dev, np.int32)
    return (table, syms.reshape(b * s, t_steps, n).numpy(),
            ctx.reshape(b * s, t_steps, n).numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-model", action="store_true")
    args = ap.parse_args()
    from simple_image_compression_network_tpu_torch.codec import (
        entropy, hyper_codec)
    table = np.ascontiguousarray(hyper_codec.build_gaussian_cdfs(
        entropy.default_scale_table(), hyper_codec._Y_MAX_DEV), np.int32)
    rng = np.random.default_rng(args.seed)
    syms, ctx = uniform_case(rng, table)
    count("uniform contexts", table, ctx, encode_decode_trace(table, syms,
                                                             ctx))
    if not args.no_model:
        table, syms, ctx = model_case(args.seed)
        hist = np.bincount(ctx.ravel(), minlength=table.shape[0])
        print(f"model contexts: rows used {int((hist > 0).sum())} of "
              f"{table.shape[0]}, the 4 most used hold "
              f"{np.sort(hist)[-4:].sum() / hist.sum():.1%} of the symbols")
        count("model contexts", table, ctx.astype(np.int64),
              encode_decode_trace(table, syms, ctx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
