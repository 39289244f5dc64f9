#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``.  The last line on standard output is the result object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last: each number the check
compared, beside its limit); the numbers compared are also the last lines
on standard error.  Exits non-zero, printing no result, without a CUDA
card (or fewer than the cell asks for), where the port cannot be
imported, or where a run has loaded JAX or the JAX package.

Build outputs and caches stay inside the checkout at fixed paths: the
port's kernels in ``build/`` and its disk cache in ``build/cache``;
Triton's in ``build/triton``.  Results go under ``TMPDIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench.lib import harness
    from portbench.lib.spec import Benchmark

    harness.program_env(ROOT)
    import torch

    chips = Benchmark(ROOT).cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
