"""Closed-loop bulk coding: a bank of seeded images on the device; set-up
encodes every batch of it once through the encode pipeline (the decode
half's containers) and decodes them once, so that every shape is built;
the window is an encode half, batches of the bank submitted in a seeded
order through the pipeline, dispatched ahead up to its depth, then a
decode half over the set-up's containers in the same way.  Each half ends
with the pipeline drained and the device synchronized; its rate is all of
its pixels over all of its time.

The mix's keys: ``bank``, ``batch``, ``depth``, ``height``, ``width``,
``alpha`` (the bank's spectral exponents, lowest and highest) and
``sample_batches`` (batches of each half kept for the judge).
"""

from __future__ import annotations

import numpy as np

from sicbench.drive import Reservoir, Run, bank, encode_all, half, sync


def run(cell, seconds: float, seed: int, rec: Run, device):
    mix = cell.mix
    codec = cell.work.Codec(cell.cfg, cell.root, device)
    rec.mark("codec")
    b, depth = mix["batch"], mix["depth"]
    inputs = bank(codec, mix, seed, device)
    batches = [inputs[j * b:(j + 1) * b] for j in range(mix["bank"] // b)]
    rec.batch = batches[0]
    sync(device)
    rec.mark("bank")
    blobs = encode_all(codec, batches, depth)
    rec.mark("encode the bank")
    dec = codec.decoder(depth)
    for bl in blobs:
        dec.submit(bl)
    dec.drain()
    sync(device)
    rec.mark("decode the bank")

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(batches))
    px = mix["height"] * mix["width"]
    enc_sample = Reservoir(mix["sample_batches"], rng)
    dec_sample = Reservoir(mix["sample_batches"], rng)
    n_bytes = [0]

    def encoded(j, res):
        n_bytes[0] += sum(len(c) for c in res)
        enc_sample.offer(lambda: {"x": batches[j], "blobs": res})

    def decoded(j, res):
        x_hat, y_hat = codec.decoded(res)
        dec_sample.offer(lambda: {"blobs": blobs[j], "x_hat": x_hat,
                                  "y_hat": y_hat, "x": batches[j]})

    k_enc = half("encode", codec.encoder(depth), batches, order,
                 seconds / 2, encoded, device, rec)
    k_dec = half("decode", codec.decoder(depth), blobs, order,
                 seconds / 2, decoded, device, rec)
    n_enc, n_dec = k_enc * b, k_dec * b
    rec.images = {"encode": n_enc, "decode": n_dec}
    rec.attempted = n_enc + n_dec
    rec.metrics = {
        "encode_mp_s": n_enc * px / rec.walls["encode"] / 1e6,
        "decode_mp_s": n_dec * px / rec.walls["decode"] / 1e6,
        "bpp": 8.0 * n_bytes[0] / (n_enc * px),
    }
    rec.samples = enc_sample.items + dec_sample.items
    rec.notes.append(
        f"encode half: {k_enc} batches of {b}, {rec.walls['encode']} s, "
        f"{rec.metrics['encode_mp_s']} MP/s; decode half: {k_dec} batches, "
        f"{rec.walls['decode']} s, {rec.metrics['decode_mp_s']} MP/s; "
        f"{n_bytes[0]} container bytes")
    return codec
