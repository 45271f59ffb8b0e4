#!/usr/bin/env python3
"""The port's spatially sharded codecs over NCCL, one card a rank.

    python3 scripts/torch_sharded_nccl.py [--seed N] [--batch B]

Needs four cards.  Builds the kernels, runs ``chip_smoke.py``'s int8 main
path on card 0 (the golden transform and the single-device containers),
then ``chip_smoke.py``'s sharded phase with
``backend="nccl"`` (rank r on card r): on every rank the sharded route,
kernel A a layer, B once an encode, C once a decode, no plain run, the
main path's containers byte for byte, the gathered x_hat and z equal to the
golden, a corrupt container raised on every rank, no byte staged through
the host; on 4 ranks the (2, 2) mesh under the default plan and pallas3.
In the same ranks, ``chip_smoke.py``'s sharded hyperprior cases: both
trained models at 1024x1024 through ``ShardedHyperCodec`` (B and D once an
encode, C and E once a decode on every rank, no plain run, no conv kernel,
cross-decoding with the single-device codec exact both ways, the symbols
equal off rounding ties, x_hat within 1e-4, the corrupt container raised,
no byte staged).  Prints every card's name and power limit and each rank
count's encode and decode ms (rank 0's host clock, median of 5).  Exits
non-zero on any failure, or with too few cards.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RANKS = (2, 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from simple_image_compression_network_tpu_torch import _build
    if torch.cuda.device_count() < max(RANKS):
        print(f"needs {max(RANKS)} cards, found "
              f"{torch.cuda.device_count()}", flush=True)
        return 2
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True).stdout
    cs.log(f"nvidia-smi: {cards.strip()}")
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} device(s)")
    with cs.phase("build"):
        _build.build()
        _build.lib()
    smi = cs.smi_line()
    with cs.phase("int8 main path at 768x512 on card 0"):
        _, golden = cs.main_path(args.seed, args.batch,
                                 torch.device("cuda", 0), smi)
    from simple_image_compression_network_tpu_torch.codec import hyper_codec
    dev = torch.device("cuda", 0)
    codecs = {"scale": hyper_codec.HyperCodec.from_checkpoint(
                  cs.HYPER_CKPT, device=dev),
              "meanscale": hyper_codec.MeanScaleCodec.from_checkpoint(
                  cs.MEANSCALE_CKPT, device=dev)}
    with cs.phase(f"sharded int8 and hyperprior codecs over NCCL on "
                  f"{RANKS} ranks"):
        cs.sharded_path(args.seed, args.batch, golden, codecs, smi,
                        backend="nccl", sizes=RANKS)
    cs.log("sharded over NCCL: every gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
