"""Logging, and the spans and counters of a request (counterpart of
``pde_solver_tpu.utils.observability``: ``get_logger``; the JAX package's
``phase_timer`` is :class:`span` here).

The logger writes to stderr (level via PDE_TPU_LOG_LEVEL) so stdout stays
clean for JSON-line consumers.

A request is one tool call: the model's solve opens it
(:func:`request`, with the stats dict the tool returns as
``solver_stats``), and every :class:`span` and :func:`count` inside it
belongs to it.  A span records its name, start, end
(``time.perf_counter_ns``), its parent span and the request's id; when
the request closes, each span's seconds are added into the stats as
``<key>_seconds`` (:data:`SPAN_KEYS`), and its counters as integers
(:data:`COUNTERS`, each present, 0 where nothing counted).  The process
totals registered with :func:`track` (the kernel launches, the solve
loops' host reads) land as the request's deltas.  A span opened with no
request open opens one for itself; a request is never opened inside
another.  The records of the latest request stay in memory
(:func:`last_request`); nothing is written out.

Spans never synchronise the device: a span over asynchronous work times
the host's side of it.  Device time comes from :func:`device_clock`
(two CUDA events around each piece of device work, read when the request
closes, after its answer has reached the host).  While ``torch.profiler``
records, each span also marks the trace as ``pde.<name>`` (a host-side
record function), so the program's spans sit on the trace's timeline
beside the kernels they launch.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("pde_solver_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            logger.addHandler(handler)
        logger.setLevel(os.environ.get("PDE_TPU_LOG_LEVEL", "WARNING").upper())
        logger.propagate = False
        _LOGGER = logger
    return _LOGGER


# Span name → stats key: a span adds its seconds to ``<key>_seconds``.  A
# span inside an open span of the same key adds nothing (it is counted in
# the outer one).
SPAN_KEYS: Dict[str, str] = {
    "assembly": "assembly",
    "assembly.stencil": "assembly_stencil",   # the operator's stencil
    "assembly.load": "assembly_load",         # loads and BC masks
    "solve": "solve",
    "setup.prep": "prep",                     # prepare_system
    "setup.prep.load": "prep_load",           # its disk-cache read
    "setup.prep.store": "prep_store",         # and write
    "setup.hash": "hash",                     # a content key's blake2b
    "setup.hierarchy": "hierarchy",           # MG hierarchy lookup or build
    "setup.hierarchy.load": "hierarchy_load",
    "setup.hierarchy.store": "hierarchy_store",
    "setup.ladder": "ladder",                 # the df2 weight ladder
    "solve.df2": "df2",                       # the df2 F-cycle rounds
    "solve.fetch": "fetch",                   # answers, trajectories to host
    "capture": "capture",                     # CUDA graph warm-up, capture
    "scan.setup": "setup",                    # a scan's operands, programs
    "scan": "scan",                           # its stepping
    "scan.checkpoint": "checkpoint",          # its checkpoint file's I/O
    "postprocess": "postprocess",
    "postprocess.von_mises": "von_mises",
    "postprocess.projection": "projection",
}

# The counters every request reports (a request's stats hold each)
COUNTERS = (
    "kernel_launches",      # request delta of stencil_kernels'
    "host_reads",           # and device_loop's process totals
    "hashed_bytes",         # bytes fed to the content keys' blake2b
    "stencil_digest_reuses",  # prep keys whose stencil hash was kept
    "stencils_by_class",    # stencils assembled on the class grid
    "stencils_by_slices",   # and by full-grid slice-adds
    "prep_memory_hits", "prep_disk_hits", "prep_builds",
    "hierarchy_hits", "hierarchy_disk_hits", "hierarchy_builds",
    "df2_rounds",
    "graphs_captured", "graph_replays",
)

# Process totals whose request deltas become counters: name → reader
_TOTALS: Dict[str, Callable[[], int]] = {}


def track(name: str, read: Callable[[], int]) -> None:
    """Report the change of the process total ``read()`` over each request
    as the counter ``name`` (one of :data:`COUNTERS`)."""
    _TOTALS[name] = read


@dataclass
class Span:
    """One span: ``parent`` is the index of the span it opened in (in its
    request's ``spans``), -1 at the top."""
    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1
    request: int = 0

    @property
    def seconds(self) -> float:
        """Its duration; while it is open, the time so far."""
        return ((self.end_ns or time.perf_counter_ns())
                - self.start_ns) / 1e9


@dataclass
class Request:
    """A request's records: its id, its spans in the order they opened,
    its counters, and its device clocks (stats key, start and end
    events)."""
    id: int
    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(COUNTERS, 0))
    clocks: List[Tuple] = field(default_factory=list)
    _open: List[int] = field(default_factory=list, repr=False)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "pde_solver_tpu_torch_request", default=None)
_IDS = itertools.count(1)
_LAST: Optional[Request] = None


def last_request() -> Optional[Request]:
    """The records of the latest request that closed."""
    return _LAST


@contextlib.contextmanager
def request(stats: Optional[Dict] = None) -> Iterator[Dict]:
    """The scope of one request; yields ``stats`` (a new dict if None),
    into which its spans' seconds and its counters are added when it
    closes.  One tool call is one request: a request inside an open one
    is refused."""
    if _CURRENT.get() is not None:
        raise RuntimeError("a request is open already")
    stats = {} if stats is None else stats
    req = Request(next(_IDS))
    totals = {k: read() for k, read in _TOTALS.items()}
    token = _CURRENT.set(req)
    try:
        yield stats
    finally:
        _CURRENT.reset(token)
        for name, read in _TOTALS.items():
            req.counters[name] += read() - totals[name]
        global _LAST
        _LAST = req
        _close(req, stats)


def _close(req: Request, stats: Dict) -> None:
    spans = req.spans
    add: Dict[str, float] = {}
    for sp in spans:
        key = SPAN_KEYS[sp.name]
        # a span inside one of the same key is counted in that one
        p = sp.parent
        while p >= 0 and SPAN_KEYS[spans[p].name] != key:
            p = spans[p].parent
        if p < 0:
            add[key + "_seconds"] = add.get(key + "_seconds", 0.0) \
                + sp.seconds
    for key, start, end in req.clocks:
        # the answer is on the host by now: the wait is empty
        end.synchronize()
        add[key] = add.get(key, 0.0) + start.elapsed_time(end) / 1e3
    stats.update(add)
    stats.update(req.counters)


class span:
    """``with span(name) as sp:`` — one span of the open request (see the
    module's docstring); ``sp`` is its :class:`Span`.  ``name`` is a key
    of :data:`SPAN_KEYS`."""

    __slots__ = ("name", "_req", "_own", "_rf", "_span")

    def __init__(self, name: str):
        if name not in SPAN_KEYS:
            raise KeyError(f"unknown span {name!r}")
        self.name = name

    def __enter__(self) -> Span:
        req = _CURRENT.get()
        self._own = None
        if req is None:
            self._own = request()
            self._own.__enter__()
            req = _CURRENT.get()
        self._req = req
        sp = Span(self.name, 0, parent=req._open[-1] if req._open else -1,
                  request=req.id)
        req._open.append(len(req.spans))
        req.spans.append(sp)
        self._rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            # a mark on the host's timeline; record_function's user scope
            # would also lay the span on the device's, as a GPU user
            # annotation that a trace's reader takes for device work
            self._rf = torch._C._profiler._RecordFunctionFast(
                "pde." + self.name)
            self._rf.__enter__()
        self._span = sp
        sp.start_ns = time.perf_counter_ns()
        return sp

    def __exit__(self, *exc) -> None:
        self._span.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._req._open.pop()
        if self._own is not None:
            self._own.__exit__(*exc)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :data:`COUNTERS`) of the
    open request; nothing outside one."""
    req = _CURRENT.get()
    if req is not None:
        req.counters[name] += n


@contextlib.contextmanager
def device_clock(name: str, device) -> Iterator[None]:
    """Time on ``device`` the work enqueued within, by two CUDA events on
    its current stream; the request's clocks of one span ``name`` add up
    to its ``<key>_device_seconds`` (``key`` the span's stats key).  Put it
    around device work alone: a host wait inside it would be counted.
    Read when the request closes; nothing on another device or outside a
    request."""
    req = _CURRENT.get()
    if req is None or torch.device(device).type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        req.clocks.append((SPAN_KEYS[name] + "_device_seconds", start,
                            end))
