#!/usr/bin/env python3
"""Benchmark of ``outfit_tpu_torch`` on CUDA cards: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number of the output check beside its limit), and the
same numbers as the last lines of standard error.  Exits non-zero, and
prints no result, without the CUDA cards the cell asks for.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from portbench import harness

    try:
        result, numbers = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                           process_start=PROCESS_START,
                                           log=lambda msg: print(msg, file=sys.stderr, flush=True))
    except harness.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for n in numbers:
        print(f"check {n['name']}: {n['value']!r} (limit {n['limit']!r}){'' if n['ok'] else ' FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
