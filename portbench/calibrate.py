#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, at the cell's
own size, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12 \\
        [--control-seeds 1-3]

One process: the cell's warm-up, then for each seed the first request its
mix sends, through the program; each answer is held against the float64
reference as a run holds it (the lower reading is the largest of these),
and on the control seeds the reference put in the program's place in the
precision below the configuration's is held against it too (the upper
reading is the smallest of those).  One JSON line a seed on standard
output, and a summary line last.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def calibrate(root: str, name: str, program_seeds, control_seeds,
              device: str = "cuda"):
    from portbench.lib import traffic
    from portbench.lib.spec import Benchmark

    bench = Benchmark(root)
    cell = bench.cell(name)
    driver = bench.driver(cell.config["driver"]).Driver(cell.config, device)
    data_dir = tempfile.mkdtemp(prefix="portbench-cal-",
                                dir=os.environ.get("TMPDIR") or None)
    rows = []
    try:
        for req in traffic.warmup(cell.traffic):
            driver.discard(driver.call(req, data_dir))
        for s in sorted(set(program_seeds) | set(control_seeds)):
            req = next(traffic.requests(cell.traffic, s))
            rec = driver.call(req, data_dir)
            row = {"seed": s, "ok": rec["ok"], "wall_s": rec["wall_s"]}
            t = time.perf_counter()
            if s in program_seeds:
                row["program"] = driver.compare([rec])
            row["reference_s"] = time.perf_counter() - t
            if s in control_seeds:
                t = time.perf_counter()
                row["control"] = driver.control([rec])
                row["control_s"] = time.perf_counter() - t
            driver.discard(rec)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    keys = sorted({k for r in rows for k in r.get("program", {})})
    summary = {"workload": name}
    for k in keys:
        prog = [r["program"][k] for r in rows if "program" in r]
        ctl = [r["control"][k] for r in rows if "control" in r]
        summary[k] = {"lower": max(prog) if prog else None,
                      "upper": min(ctl) if ctl else None,
                      "program": prog, "control": ctl}
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.lib.harness import program_env

    program_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    _, summary = calibrate(ROOT, args.workload, seeds(args.seeds),
                           seeds(args.control_seeds))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
