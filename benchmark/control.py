"""The control of a cell's ``correct``: the plain reference put in the
program's place, one precision below the configuration's (int8 with int4
activations; float32 with TF32 on), read by the same numbers as a run, on
the cell's own bank and batch, for each seed given.  Every control reading
must fail a limit of the configuration; the benchmark's runs never run
this.

    python3 benchmark/control.py --workload hyper_scale.bulk_b8 \
        --seeds 11,12,13
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "reference"), os.path.dirname(HERE)]

from sicbench import drive, harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """The control's numbers on the first ``sample`` images of the cell's
    bank for ``seed``, merged as a run merges its samples."""
    mix = cell.mix
    images = mix["batch"] * mix["sample_batches"]
    u8 = drive.image_bank(mix["bank"], mix["height"], mix["width"], seed,
                          mix["alpha"][0], mix["alpha"][1], device)
    x = cell.work.Codec.inputs(u8[:images])
    ref = cell.reference(device)
    got: dict = {}
    harness.merge(got, ref.control(x))
    return got


def failed(cell: harness.Cell, got: dict) -> list:
    limits = cell.cfg["limits"]
    return [k for k, v in got.items() if k in limits and v > limits[k]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.Cell(args.workload)
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell, seed, args.device)
        fails = failed(cell, got)
        bad += not fails
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": got, "limits": cell.cfg["limits"],
                          "fails": fails}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
