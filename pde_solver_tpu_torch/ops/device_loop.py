"""Solve loops on the device: captured CUDA graphs with on-device convergence.

Counterpart of what the JAX package gets from ``jax.jit`` over
``lax.while_loop`` / ``fori_loop``: a solve runs as one device program and
the host does not read inside it.  Here a loop body is written once as a
*masked iteration*: it computes the next state and keeps it only while an
``active`` flag on the device holds (``torch.where``, so a NaN or an inf of
an iteration past convergence cannot leak in), and it counts only active
iterations.  A state that converged, or reached ``maxiter``, therefore
passes through any number of further iterations unchanged, bit for bit.

The host runs *blocks* of ``block`` masked iterations and reads one status
tensor per block (``[active, iterations, relres]``, float64), so a solve
that takes n iterations reads ceil(n / block) times, not n times.

On a CUDA device each block is a :class:`Program`: a ``torch.cuda.CUDAGraph``
captured over static buffers (the solve's inputs and its state), replayed
by the host.  Elsewhere (the CPU) the same programs run eagerly over the
same buffers; that is how the tests reach this code.  There is no fallback:
a capture or a replay that fails raises.  ``capture_error_mode`` is torch's
default, "global": any synchronising or otherwise capture-unsafe call made
while a graph is captured raises at once instead of being recorded wrongly,
and no other thread of the process uses the card during a capture.

A captured graph reads the tensors of its owner (a multigrid hierarchy, a
flat operator, a scan's operands) at the addresses they had at capture, so
its programs live in the owner's :class:`GraphStore` and go with it: a
store is freed with its owner, or by :meth:`GraphStore.clear` when the
owner leaves a cache (``linsolve._MG_CACHE``, ``linsolve._FLAT_OP_CACHE``).
Every graph of a store shares one memory pool, and every program writes
its results into buffers allocated outside the pool, so replaying the
programs of one store in any order, one at a time, is safe.

Kernel launches count at replay: while a graph is captured the kernel
wrappers record their launches instead of counting them
(``stencil_kernels.count_launch``), and each replay adds what one replay
launches, by variant and to each operator's ``launches``.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from pde_solver_tpu_torch.ops import stencil_kernels

# Host reads of the solve loops in this process, by loop ("mg_pcg", "cg",
# "df2"): each is one device → host copy that waits for the device.
HOST_READS: Dict[str, int] = {}


def count_read(kind: str) -> None:
    HOST_READS[kind] = HOST_READS.get(kind, 0) + 1


# Internal: True inside :func:`_uncaptured`, which runs the programs of a
# CUDA device eagerly.  Only ``chip_smoke.py`` and the tests enter it, to
# hold a captured run against the same run uncaptured; no entry point of
# the package does.
_EAGER = False


@contextlib.contextmanager
def _uncaptured():
    """Run the programs created inside this block eagerly even on a CUDA
    device (the check of captured against uncaptured runs)."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def captures(device) -> bool:
    """Whether programs on ``device`` are captured as CUDA graphs."""
    return torch.device(device).type == "cuda" and not _EAGER


class GraphStore:
    """The programs of one owner by key, and the memory pool they share."""

    def __init__(self):
        self._entries: Dict = {}
        self._pool = None

    def get(self, key):
        return self._entries.get(key)

    def put(self, key, value) -> None:
        self._entries[key] = value

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def forget_pool(self) -> None:
        """After a failed capture: torch leaves that capture's pool set up
        for recording, and a second capture into it is refused, so the
        next capture of this store takes a pool of its own."""
        self._pool = None

    def clear(self) -> None:
        """Drop every program; their graphs and the pool go with them."""
        self._entries.clear()
        self._pool = None

    def __len__(self) -> int:
        return len(self._entries)


def store_of(owner) -> GraphStore:
    """The :class:`GraphStore` held by ``owner`` (an operator object),
    created on first use."""
    store = owner.__dict__.get("_graphs")
    if store is None:
        store = owner._graphs = GraphStore()
    return store


def release(owner) -> None:
    """Free the graphs an owner holds (it leaves a cache): a hierarchy's
    ``graphs`` field, or an operator's store of :func:`store_of`."""
    for name in ("graphs", "_graphs"):
        store = getattr(owner, name, None)
        if isinstance(store, GraphStore):
            store.clear()


@contextlib.contextmanager
def _recording():
    """Collect the launches the kernel wrappers record during a capture;
    yields the list they are aggregated into, [(variant, operator ref or
    None, count)]."""
    if stencil_kernels._CAPTURED is not None:
        raise RuntimeError("a CUDA graph capture is already under way")
    stencil_kernels._CAPTURED = raw = []
    out = []
    try:
        yield out
    finally:
        stencil_kernels._CAPTURED = None
    counts: Dict = {}
    for variant, op in raw:
        key = (variant, id(op))
        if key not in counts:
            counts[key] = [variant, None if op is None else weakref.ref(op), 0]
        counts[key][2] += 1
    out.extend(tuple(c) for c in counts.values())


def _side_stream(fn: Callable) -> None:
    """Run ``fn`` eagerly on a side stream, as a warm-up before a capture
    (the first launch of each kernel, the libraries' lazy set-up)."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)


class Program:
    """``fn(g0, *buffers)`` over static buffers: it returns one entry per
    buffer, a tensor to write into that buffer or None.  With ``capture``
    the writes are captured once as a CUDA graph (``g0`` = 0) and
    :meth:`run` replays it; without, :meth:`run` calls ``fn`` with the
    ``g0`` it is given.  ``g0`` is the global index of a block's first
    iteration: a captured block is valid for every ``g0`` at which ``fn``
    does the same work as at 0."""

    def __init__(self, fn: Callable, buffers: Sequence[torch.Tensor],
                 capture: bool, store: Optional[GraphStore] = None):
        self.buffers = tuple(buffers)
        self.fn: Optional[Callable] = fn
        self.graph = None
        self.launches: Tuple = ()
        if capture:
            self._capture(store or GraphStore())

    def _body(self, g0: int) -> None:
        outs = self.fn(g0, *self.buffers)
        if len(outs) != len(self.buffers):
            raise ValueError(f"{len(outs)} results for {len(self.buffers)} "
                             f"buffers")
        for buf, out in zip(self.buffers, outs):
            if out is not None:
                buf.copy_(out)

    def _capture(self, store: GraphStore) -> None:
        graph = torch.cuda.CUDAGraph()
        try:
            with _recording() as launches:
                with torch.cuda.graph(graph, pool=store.pool()):
                    self._body(0)
        except BaseException:
            store.forget_pool()
            raise
        # the closure is not needed to replay; dropping it keeps the
        # owner → store → program → closure → owner cycle from forming
        self.graph, self.launches, self.fn = graph, tuple(launches), None

    def run(self, g0: int = 0) -> None:
        if self.graph is None:
            self._body(g0)
            return
        self.graph.replay()
        for variant, ref, n in self.launches:
            stencil_kernels.count_launch(variant,
                                         None if ref is None else ref(), n)


class MaskedLoop:
    """A masked iteration loop over static buffers, run in blocks.

    ``prologue(*inputs)`` → state (a tuple of tensors), ``step(state, g)``
    → state (one masked iteration, ``g`` its global index as a host
    integer), ``status(state)`` → float64 ``[active, iterations, relres]``.
    Two programs share the buffers (the inputs, the state, the status):
    ``first`` is the prologue and one block, ``next`` one block from the
    state the last one left (made at its first use).  A captured block
    starts at ``g`` = 0, so ``step`` must do the same work at ``g`` and
    ``g + block`` (the caller makes ``block`` a multiple of any period
    ``step`` has in ``g``)."""

    def __init__(self, kind: str, inputs, prologue, step, status,
                 block: int, capture: bool, store: Optional[GraphStore] = None):
        self.kind, self.block = kind, int(block)
        n_in = len(inputs)
        self.inputs = tuple(t.clone() for t in inputs)

        def probe():
            state = step(prologue(*self.inputs), 0)
            return state, status(state)

        # the probe gives the state's shapes; on the card it is the warm-up
        if capture:
            box = []
            _side_stream(lambda: box.append(probe()))
            (state, st), = box
        else:
            state, st = probe()
        self.state = tuple(torch.empty_like(t) for t in state)
        self.status = torch.empty_like(st)
        del state, st
        n_state = len(self.state)

        def run_block(s, g0):
            for j in range(self.block):
                s = step(s, g0 + j)
            return s

        def first(g0, *bufs):
            s = run_block(prologue(*bufs[:n_in]), g0)
            return (None,) * n_in + tuple(s) + (status(s),)

        def nxt(g0, *bufs):
            s = run_block(bufs[n_in:n_in + n_state], g0)
            return (None,) * n_in + tuple(s) + (status(s),)

        bufs = self.inputs + self.state + (self.status,)
        self.first = Program(first, bufs, capture, store)
        # ``next`` is made when a solve first needs a second block: a warm
        # started step solve that ends within one never pays its capture
        self.next: Optional[Program] = None
        self._next = lambda: Program(nxt, bufs, capture, store)

    def run(self, inputs) -> list:
        """Load ``inputs`` and run blocks until the status reads inactive;
        returns the last status as host floats (one read per block)."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.first.run(0)
        g0 = self.block
        while True:
            count_read(self.kind)
            st = self.status.tolist()
            if not st[0]:
                return st
            if self.next is None:
                self.next, self._next = self._next(), None
            self.next.run(g0)
            g0 += self.block


def solve(store: GraphStore, key, program, b: torch.Tensor,
          x0: torch.Tensor, tol: float, maxiter: int, block: int,
          period: int = 0):
    """Run the masked loop ``program`` = (prologue, step, status,
    from_flat) on (b, x0, tol, maxiter), in blocks of ``block``, with the
    :class:`MaskedLoop` of ``key`` in ``store`` (made at first use; its
    capture mode joins the key).  Returns (x, iterations, relres).
    ``key[0]`` names the loop in ``HOST_READS``; ``period`` is the period
    of ``step`` in ``g`` (0: none), of which a captured block must be a
    multiple."""
    prologue, step, status, from_flat = program
    capture = captures(b.device)
    if capture and period and block % period:
        raise ValueError(f"a captured block of {block} iterations must be a "
                         f"multiple of the resync period {period}")
    inputs = (b, x0,
              torch.full((), float(tol), dtype=torch.float64,
                         device=b.device),
              torch.full((), int(maxiter), dtype=torch.int64,
                         device=b.device))
    key = key + (capture,)
    loop = store.get(key)
    if loop is None:
        loop = MaskedLoop(key[0], inputs, prologue, step, status, block,
                          capture, store)
        store.put(key, loop)
    st = loop.run(inputs)
    return from_flat(loop.state[0].clone()), int(st[1]), st[2]


def status_of(active: torch.Tensor, k: torch.Tensor,
              relres: torch.Tensor) -> torch.Tensor:
    """The status a block ends with: float64 [active, iterations, relres]."""
    return torch.stack([active.to(torch.float64), k.to(torch.float64),
                        relres.to(torch.float64)])
