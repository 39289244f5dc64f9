"""One run of one cell: set-up, the measured window, the check.

The loop is closed, with one client: each request is sent when the answer
to the one before has come back.  Requests go out until ``seconds`` have
passed since the window opened, and each one sent is let finish, so the
window is a whole number of requests.  A traced run (``trace``) measures
the same window untraced for its per-layer numbers from the tools' own
timers, then sends ``trace_requests`` more under ``torch.profiler`` for
the device's numbers.

Results go to a directory under ``TMPDIR`` and are removed when the run
has read them.  After the window: the memory peak, then the check of the
answers against the plain reference (:mod:`portbench.reference`), then
the result line.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench.lib import trace as tracing
from portbench.lib import traffic
from portbench.lib.spec import Benchmark, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "pde_solver_tpu")


def program_env(root: str) -> None:
    """Before torch is imported: the program's settings come from the
    configuration alone (no inherited ``PDE_TPU_*``), and its disk cache
    and Triton's stay inside the checkout, at fixed paths."""
    for key in [k for k in os.environ if k.startswith("PDE_TPU_")]:
        del os.environ[key]
    os.environ["PDE_TPU_CACHE_DIR"] = os.path.join(root, "build", "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may never load."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_seconds() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def tree_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


@dataclass
class Run:
    """What a run saw; the metric readers read it."""
    cell: Cell
    seed: int
    seconds: float
    setup_s: float = 0.0
    window_s: float = 0.0
    records: List[Dict] = field(default_factory=list)
    trace_records: List[Dict] = field(default_factory=list)
    trace: Optional[object] = None
    peak_bytes: int = 0
    window_peak_bytes: int = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def card_line() -> Dict:
    """The card's name, power limit and clocks, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    parts = [p.strip() for p in out[0].split(",")]
    return {"nvidia_smi": parts}


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Dict:
    """Run cell ``name`` once; returns the result object.  Set-up counts
    from the process's start."""
    import torch

    bench = Benchmark(root)
    cell = bench.cell(name)
    driver = bench.driver(cell.config["driver"]).Driver(cell.config, device)
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds))
    data_dir = tempfile.mkdtemp(prefix="portbench-",
                                dir=os.environ.get("TMPDIR") or None)
    cache_dir = os.environ.get("PDE_TPU_CACHE_DIR", "")
    cache0 = tree_bytes(cache_dir) if cache_dir else 0
    written = 0
    t0 = time.perf_counter()
    base = process_seconds()
    try:
        # --- set-up: the program's first use and the warm-up requests
        for req in traffic.warmup(cell.traffic):
            rec = driver.call(req, data_dir)
            written += rec.get("bytes", 0)
            driver.discard(rec)
            if not rec["ok"]:
                raise RuntimeError(f"warm-up request failed: {rec}")
        _sync(device)
        run.setup_s = base + time.perf_counter() - t0
        setup_peak = _peak(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        # --- the window: closed loop, one client, whole requests
        gen = traffic.requests(cell.traffic, seed)
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < run.seconds:
            rec = driver.call(next(gen), data_dir)
            written += rec.get("bytes", 0)
            run.records.append(rec)
        _sync(device)
        run.window_s = time.perf_counter() - w0
        log("window requests (s): "
            + " ".join(f"{r['wall_s']:.3f}" for r in run.records))
        for key in sorted({k for r in run.records
                           for k in r.get("stats", {})
                           if k.endswith("_seconds")}):
            log(f"  {key}: " + " ".join(
                f"{float(r['stats'].get(key, math.nan)):.3f}"
                for r in run.records if "stats" in r))
        run.window_peak_bytes = _peak(device)
        run.peak_bytes = max(setup_peak, run.window_peak_bytes)

        # --- traced requests after the window (traced runs only)
        if trace:
            run.trace, run.trace_records = _traced(
                driver, gen, int(cell.workload.get("trace_requests", 1)),
                data_dir, device)
            written += sum(r.get("bytes", 0) for r in run.trace_records)
            log(f"trace: {tracing.dumps(run.trace)}")
            for rec in run.trace_records:
                driver.discard(rec)

        bad = forbidden_modules()
        if bad:
            log("forbidden modules loaded: " + ", ".join(bad))
            raise SystemExit(3)

        if cache_dir:
            written += max(0, tree_bytes(cache_dir) - cache0)
        log(f"bytes written: {written} (results and cache stores)")

        # --- the check, with the program's state out of the way
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        checks, failed = judge(driver, run, seed)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    metrics = {}
    readers = cell.per_layer if trace else cell.end_to_end
    for m in readers:
        value = bench.metric_reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": run.peak_bytes}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
    if dev["platform"] == "gpu":
        dev.update(card_line())
        log(f"card: {dev.get('nvidia_smi')}")
    correct = all(c["ok"] for c in checks.values()) and failed == 0
    out = {"correct": correct, "attempted": len(run.records),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_by_host()}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    return out


def _traced(driver, gen, n: int, data_dir: str, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    launches: Dict = {}
    undo = tracing.install_spans(launches)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    recs = []
    try:
        prof = profile(activities=acts)
        prof.start()
        try:
            with torch.profiler.record_function(tracing.WINDOW):
                for _ in range(n):
                    with torch.profiler.record_function(tracing.TOOL):
                        recs.append(driver.call(next(gen), data_dir))
                _sync(device)
        finally:
            prof.stop()
        return tracing.read(prof, launches), recs
    finally:
        tracing.remove_spans(undo)


def judge(driver, run: Run, seed: int):
    """Count the failed requests of the window, and hold a sample of its
    answers, drawn from the seed, against the reference.  Returns
    ({name: {"value", "limit", "ok"}}, failed)."""
    limits = run.cell.workload["limits"]
    failed = 0
    for rec in run.records:
        if not rec["ok"] or not driver.finite(rec):
            failed += 1
            log(f"failed request: {rec.get('error') or rec.get('request')}")
    done = [r for r in run.records if r["ok"]]
    k = min(len(done), int(run.cell.workload.get("check_requests", 1)))
    rng = np.random.Generator(np.random.PCG64([int(seed), 7]))
    picks = sorted(rng.choice(len(done), size=k, replace=False)) if k else []
    sample = [done[i] for i in picks]
    for rec in run.records:
        if all(rec is not s for s in sample):
            driver.discard(rec)
    t = time.perf_counter()
    values = driver.compare(sample) if sample else {}
    for rec in sample:
        driver.discard(rec)
    log(f"reference: {len(picks)} request(s) checked in "
        f"{time.perf_counter() - t:.1f} s")
    checks = {}
    for key, limit in limits.items():
        v = values.get(key, math.inf)
        checks[key] = {"value": v, "limit": limit,
                       "ok": bool(v <= limit)}
    checks["failed_requests"] = {"value": failed, "limit": 0,
                                 "ok": failed == 0}
    if not picks:
        checks["checked_requests"] = {"value": 0, "limit": 1, "ok": False}
    return checks, failed
