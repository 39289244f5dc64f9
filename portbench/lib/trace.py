"""A traced stretch of the window, read from ``torch.profiler``.

The harness marks the stretch with ``record_function(WINDOW)``, and in
traced runs wraps calls into the program's layers in spans of their own
(:data:`SPANS`, installed from here, never in an untraced run).  In traced runs
the dense SpMV's launch counter is wrapped too, to tally K1's launches by
the level shape of the operator that made them: the trace names a
launch's instantiation, not its grid.  After the stretch the events are
copied out of the profiler once: device activity (kernels, copies, sets)
and the marks.
"""

from __future__ import annotations

import functools
import importlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
SHORT_GAP_NS = 100_000
SHORT_GAP = "between launches (gaps under 0.1 ms)"
TOOL = "portbench.tool"

# (module, attribute, span): calls into the program's layers, wrapped in
# traced runs where the program looks them up at call time.  Each must be
# there: a target that the program renamed or took away stops the traced
# run (MissingTarget), so that no span falls silently out of the breakdown.
SPANS = (
    ("pde_solver_tpu_torch.api", "save_field", "tool.pickle"),
    ("pde_solver_tpu_torch.ops.assembly", "assemble_scalar_stencil",
     "assembly"),
    ("pde_solver_tpu_torch.ops.assembly", "assemble_elasticity_stencil",
     "assembly"),
    ("pde_solver_tpu_torch.ops.assembly", "assemble_vector_load",
     "assembly"),
    ("pde_solver_tpu_torch.ops.linsolve", "prepare_system", "setup.prep"),
    ("pde_solver_tpu_torch.ops.timestepping", "prepare_system",
     "setup.prep"),
    ("pde_solver_tpu_torch.ops.multigrid", "build_hierarchy",
     "setup.hierarchy"),
    ("pde_solver_tpu_torch.ops.timestepping", "_transient_scan", "scan"),
    ("pde_solver_tpu_torch.models.elasticity", "solve_stencil_system",
     "static_solve"),
    ("pde_solver_tpu_torch.models.elasticity", "von_mises_fields",
     "postprocess.von_mises"),
    ("pde_solver_tpu_torch.models.elasticity", "project_cellwise",
     "postprocess.projection"),
)


# The dense SpMV's launch counter: each launch, a graph's replays
# included, names its operator, whose level shape fixes the launch's bytes;
# CAPTURING is the flag that is set while a graph is being captured (its
# launches are counted when the graph replays).
COUNTER = ("pde_solver_tpu_torch.ops.stencil_kernels", "count_launch")
CAPTURING = "_CAPTURED"


class MissingTarget(RuntimeError):
    """A span's or the counter's target is not in the program."""


def _target(mod_name: str, attr: str):
    mod = importlib.import_module(mod_name)
    if not hasattr(mod, attr):
        raise MissingTarget(
            f"{mod_name}.{attr} is gone: the traced run cannot place its "
            "span or count; update portbench/lib/trace.py")
    return mod, getattr(mod, attr)


def install_spans(launches: Dict) -> List[Tuple]:
    """Wrap each of :data:`SPANS` in ``record_function``, and the launch
    counter so that it also tallies K1 launches into ``launches`` by
    (vdim, weight bytes, n_off, N); returns what :func:`remove_spans`
    puts back."""
    import torch

    sk, count = _target(*COUNTER)
    _target(COUNTER[0], CAPTURING)
    targets = [_target(m, a) + (a, label) for m, a, label in SPANS]

    def counted(variant, op=None, n=1, __count=count):
        if getattr(sk, CAPTURING) is None and op is not None \
                and hasattr(op, "N") and hasattr(op, "n_off"):
            key = (int(op.vdim), int(op.W.element_size()), int(op.n_off),
                   int(op.N))
            launches[key] = launches.get(key, 0) + int(n)
        return __count(variant, op, n)

    functools.update_wrapper(counted, count)
    setattr(sk, COUNTER[1], counted)
    undo = [(sk, COUNTER[1], count)]
    for mod, fn, attr, label in targets:
        def wrapped(*a, __fn=fn, __label=label, **k):
            with torch.profiler.record_function("portbench." + __label):
                return __fn(*a, **k)

        functools.update_wrapper(wrapped, fn)
        setattr(mod, attr, wrapped)
        undo.append((mod, attr, fn))
    return undo


def remove_spans(undo) -> None:
    for mod, attr, fn in undo:
        setattr(mod, attr, fn)


@dataclass
class DeviceOp:
    name: str
    start: int      # ns, the profiler's clock
    end: int


@dataclass
class Trace:
    window: Tuple[int, int]                     # ns
    ops: List[DeviceOp] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    launches: Dict = field(default_factory=dict)   # K1, by level shape

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity, clipped to the window."""
        lo, hi = self.window
        iv = sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops
                    if o.end > lo and o.start < hi)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_label(self, t: int) -> str:
        """The innermost span open at t: what the host was doing."""
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "outside the program"

    def idle_by_host(self, top: int = 10) -> List[List]:
        """Idle seconds of the window by what the host was doing, largest
        first: [[span, seconds], ...].  Gaps shorter than ``SHORT_GAP_NS``
        are the host's time between launches and go under one name."""
        by: Dict[str, float] = {}
        for s, e in self.gaps():
            if e - s < SHORT_GAP_NS:
                by[SHORT_GAP] = by.get(SHORT_GAP, 0.0) + (e - s) / 1e9
                continue
            # a long gap can hold several host phases: cut it at the spans'
            # edges and name each piece by the innermost span open there
            cuts = sorted({s, e} | {t for _, a, b in self.spans
                                    for t in (a, b) if s < t < e})
            for a, b in zip(cuts, cuts[1:]):
                label = self.host_label((a + b) // 2)
                by[label] = by.get(label, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]

    def device_ops(self, top: int = 10) -> List[List]:
        """Device seconds by operation name, largest first."""
        by: Dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + (o.end - o.start) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]


def read(prof, launches: Dict) -> Trace:
    """The trace of a stopped profiler; the stretch is its WINDOW mark;
    ``launches`` the counter's tally over it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ops, spans, window = [], [], None
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith("portbench."):
                continue
            ops.append(DeviceOp(name, start, end))
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith("portbench."):
            spans.append((name[len("portbench."):], start, end))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window mark")
    return Trace(window=window, ops=ops, spans=spans, launches=launches)


def summary(trace: Trace) -> Dict:
    return {"window_s": trace.window_s, "busy_s": trace.busy_s(),
            "device_ops": len(trace.ops),
            "spans": len(trace.spans),
            "k1_counted": sum(trace.launches.values()),
            "k1_traced": sum(1 for o in trace.ops if "flat_stencil" in o.name)}


def dumps(trace: Trace) -> str:
    return json.dumps(summary(trace))
