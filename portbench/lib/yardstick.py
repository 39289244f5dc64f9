"""The yardstick: one H100's published peaks and the arithmetic of a
kernel's least time, kept with the benchmark so that a change to the
program cannot move it.

``bound``, ``flat_cost`` and ``device_ms`` are copies of ``chip_smoke.py``'s
(as of the port's PR 16), ``flat_cost`` taking the operator's sizes
rather than the operator; ``k1_args`` reads a K1 launch's instantiation
from its name in a device trace.
"""

from __future__ import annotations

import re
import time
from typing import Optional, Tuple

# NVIDIA's data sheet, H100 SXM: HBM3 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the float32
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flat_cost(n_off: int, vdim: int, N: int, w_bytes_each: int):
    """Bytes and float32 operations of one dense apply: W's n_off·v² planes
    of N weights, x and y once each; one multiply-add per weight."""
    nw = n_off * vdim * vdim
    w_bytes = nw * N * w_bytes_each
    return w_bytes + 2 * vdim * N * 4, 2.0 * nw * N, w_bytes


def device_ms(fn, kernel: str, reps: int = 50, tries: int = 8) -> float:
    """Mean device time per launch of the kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of fn, the calls
    run first as the profiler's warm-up step and not kept; a trace that
    holds none is taken again, with more calls, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, tries + 1):
        n = reps * min(attempt, 4)
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.extend(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [ev for ev in kept if kernel in ev.key]
        count = sum(ev.count for ev in events)
        total = sum(getattr(ev, "device_time_total", 0.0) for ev in events)
        if count and total > 0:
            return total / 1e3 / count
        time.sleep(0.5)
    raise RuntimeError(f"{tries} profiler traces hold no {kernel} launch")


# The dense flat-stencil SpMV (K1/K2): its instantiations are named
# flat_stencil_spmv_kernel<VDIM, WT, NOFF, K>, K nodes a thread.
K1_NAME = "flat_stencil_spmv_kernel"
_K1_ARGS = re.compile(r"flat_stencil_spmv_kernel<\s*(\d+)\s*,\s*([\w:]+)\s*,"
                      r"\s*(\d+)\s*,\s*(\d+)\s*>")


def k1_args(name: str) -> Optional[Tuple[int, int, int, int]]:
    """(vdim, weight bytes, n_off, nodes a thread) from a launch's name."""
    m = _K1_ARGS.search(name)
    if not m:
        return None
    wt = m.group(2)
    w_bytes = 2 if "bfloat16" in wt or "half" in wt else 4
    return int(m.group(1)), w_bytes, int(m.group(3)), int(m.group(4))
