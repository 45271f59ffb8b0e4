"""Run one benchmark cell once on this machine's cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the numbers compared for ``correct`` beside their limits on
standard error, and one JSON line (correct, attempted, failed, metrics,
device, and with --trace 1 breakdown; checks last) as the last line of
standard output.  Exits non-zero without a result where there is no card,
fewer cards than the cell asks for, or a module of JAX loaded.  The
program's kernel build and every cache stay under ``build/`` in this
checkout, at fixed paths.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path[:0] = [HERE, os.path.join(HERE, "reference"), ROOT]

from sicbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
