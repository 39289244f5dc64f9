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
owner leaves a cache (:func:`release`, the ``release`` of every
``utils.kept.Kept`` that holds device state).
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
import gc
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from pde_solver_tpu_torch.ops import stencil_kernels
from pde_solver_tpu_torch.utils import observability as obs

# Host reads of the solve loops in this process, by loop ("mg_pcg", "cg",
# "df2"): each is one device → host copy that waits for the device.
HOST_READS: Dict[str, int] = {}
obs.track("host_reads", lambda: sum(HOST_READS.values()))


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


# Internal: True inside :func:`_per_step`, which runs every scan step by
# step, each step solve with a read a block (the path a rerun takes).  Only
# ``chip_smoke.py`` and the tests enter it, to hold the step programs
# against it; no entry point of the package does.
_PER_STEP = False


@contextlib.contextmanager
def _per_step():
    """Run the scans started inside this block step by step."""
    global _PER_STEP
    prev, _PER_STEP = _PER_STEP, True
    try:
        yield
    finally:
        _PER_STEP = prev


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
    with obs.span("capture"):
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
        # Python's cyclic collector stays off while the graph is captured:
        # a graph it freed meanwhile (one held in a dead reference cycle)
        # would release its pool, a call that is not permitted during a
        # capture and invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with obs.span("capture"), _recording() as launches:
                with torch.cuda.graph(graph, pool=store.pool()):
                    self._body(0)
        except BaseException:
            store.forget_pool()
            raise
        finally:
            if collecting:
                gc.enable()
        obs.count("graphs_captured")
        # the closure is not needed to replay; dropping it keeps the
        # owner → store → program → closure → owner cycle from forming
        self.graph, self.launches, self.fn = graph, tuple(launches), None

    def run(self, g0: int = 0) -> None:
        if self.graph is None:
            self._body(g0)
            return
        self.graph.replay()
        obs.count("graph_replays")
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


def run_masked(store: GraphStore, key, prologue, step, status, inputs,
               block: int, capture: bool):
    """Run the masked loop (``prologue``, ``step``, ``status``) on
    ``inputs`` (a tuple of tensors) in blocks of ``block``, with the
    :class:`MaskedLoop` of ``key`` in ``store`` (made at first use; the
    capture mode joins the key).  Returns (the loop's state buffers, its
    last status as host floats).  ``key[0]`` names the loop in
    ``HOST_READS``."""
    key = key + (capture,)
    loop = store.get(key)
    if loop is None:
        loop = MaskedLoop(key[0], inputs, prologue, step, status, block,
                          capture, store)
        store.put(key, loop)
    return loop.state, loop.run(inputs)


def solve(store: GraphStore, key, program, b: torch.Tensor,
          x0: torch.Tensor, tol: float, maxiter: int, block: int,
          period: int = 0):
    """Run the masked loop ``program`` = (prologue, step, status,
    from_flat) on (b, x0, tol, maxiter), in blocks of ``block``, through
    :func:`run_masked`.  Returns (x, iterations, relres).  ``period`` is
    the period of ``step`` in ``g`` (0: none), of which a captured block
    must be a multiple."""
    prologue, step, status, from_flat = program
    capture = captures(b.device)
    if capture and period and block % period:
        raise ValueError(f"a captured block of {block} iterations must be a "
                         f"multiple of the resync period {period}")
    state, st = run_masked(store, key, prologue, step, status,
                           loop_inputs(b, x0, tol, maxiter), block, capture)
    return from_flat(state[0].clone()), int(st[1]), st[2]


def loop_inputs(*tensors_then_tol_maxiter):
    """A masked loop's inputs: the given tensors, then ``tol`` (float64)
    and ``maxiter`` (int64) as 0-d tensors on the first tensor's device."""
    *ts, tol, maxiter = tensors_then_tol_maxiter
    device = ts[0].device
    return tuple(ts) + (
        torch.full((), float(tol), dtype=torch.float64, device=device),
        torch.full((), int(maxiter), dtype=torch.int64, device=device))


def status_of(active: torch.Tensor, k: torch.Tensor,
              relres: torch.Tensor) -> torch.Tensor:
    """The status a block ends with: float64 [active, iterations, relres]."""
    return torch.stack([active.to(torch.float64), k.to(torch.float64),
                        relres.to(torch.float64)])


# ----------------------------------------------------------------------
# Scans: one step a program, one read a chunk of steps
# ----------------------------------------------------------------------
#
# The counterpart of the JAX package's ``lax.scan`` over time steps.  A step
# (its eager body, its step solve, the carry update) is one
# :class:`StepLoop`, replayed once a step with no read; the host reads the
# scan's accumulators once every ``SCAN_CHUNK`` steps.  The step solve runs
# its prologue and a fixed ``budget`` of masked iterations: a step that
# converges within it gives the per-step solve's answer bit for bit, since
# a finished state passes masked iterations unchanged.  The budget is the
# smallest of ``STEP_BUDGETS`` above the worst step of the chunk before
# (one iteration to spare; :func:`step_budget`), at most the cap.  A
# chunk with no budget runs step by step through the per-step solves (one
# read a block, the same kernels on the same device, the same answer):
# a scan's first step when its programs have not learned where a
# trajectory starts, and every chunk after one whose worst step passed
# ``STEP_BUDGET_MAX``.  A read that shows a step still active after the
# budget reruns its chunk step by step from the carry it started with and
# counts the rerun in ``HOST_READS[key[0] + "_redo"]``.  A scan's programs
# (:class:`ScanPrograms`) live in its store: one :class:`StepLoop` a
# budget, kept with the store, and the budget a trajectory's first chunk
# starts from, learned from the first step that was solved on its own with
# one block to spare where the cap leaves room (a later trajectory's data
# may make its first steps harder) and run by the chunk after that step.
# The trajectory that learns them captures each budget it wants; once a
# trajectory has run (``settled``) a chunk runs on the smallest program at
# or above its budget and captures only past the widest.  An owner kept
# across calls (a scan's operands in ``timestepping``'s cache) therefore
# runs a later trajectory on the programs the first one captured.

SCAN_CHUNK = 16
STEP_BLOCK = 8
# The budgets a step program may have: a short ladder, so that a chunk
# runs close to what its steps take (a warm-started heat step takes 1–2
# iterations) and a scan captures at most ten programs.
STEP_BUDGETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
# The most masked iterations a step program gives its step solve.  Steps
# that need more (the first steps of a rod heated from one end take ~250,
# a 1D thermal wave's 51, a step capped at maxiter thousands) are solved
# step by step: a program's capture grows with its budget, and a program
# whose steps outrun it runs every chunk twice.
STEP_BUDGET_MAX = STEP_BUDGETS[-1]


class ScanTally(NamedTuple):
    """What a scan did: its iterations and max relres, the chunks run again
    step by step after an overflow, the chunks run step by step with no
    budget (an unlearned first step, and after a worst step past the
    cap), the masked iterations its step programs ran past their step's
    convergence, the step programs it built, and the seconds spent
    warming up and capturing them."""
    iterations: int = 0
    relres: float = 0.0
    reruns: int = 0
    stepwise: int = 0
    past: int = 0
    built: int = 0
    capture_seconds: float = 0.0

    def plus(self, other: "ScanTally") -> "ScanTally":
        return ScanTally(*(max(a, b) if name == "relres" else a + b
                           for name, a, b in zip(self._fields, self, other)))


def inline_solve(program, budget: int, tol: torch.Tensor,
                 maxiter: torch.Tensor, box: list) -> Callable:
    """The masked loop ``program`` as a step solve with no read: its
    prologue and ``budget`` masked iterations.  ``solve(b, x0)`` returns
    (x, iterations, relres) as device tensors and appends the status to
    ``box``."""
    prologue, step, status, from_flat = program

    def solve(b, x0):
        state = prologue(b, x0, tol, maxiter)
        for g in range(budget):
            state = step(state, g)
        st = status(state)
        box.append(st)
        return from_flat(state[0]), st[1], st[2]
    return solve


class StepLoop:
    """One step of a scan as a :class:`Program` over static buffers: the
    carry, the device step counter ``n`` and the accumulators ``acc``
    (float64 [iterations, max relres, steps still active after the
    budget, most iterations of one step]).

    ``step(carry, n, solve)`` → (new carry, iterations, relres) is the
    step's body around its step solve, ``n`` the counter as a 0-d int64
    tensor; the loop passes :func:`inline_solve` of ``program`` at
    ``budget``.  Captured once on the card (after a warm-up step on a side
    stream; ``capture_seconds`` is what both took) and replayed once a
    step; elsewhere run eagerly over the same buffers."""

    def __init__(self, step: Callable, program, carry, tol: float,
                 maxiter: int, budget: int, capture: bool,
                 store: Optional[GraphStore] = None):
        self.budget = int(budget)
        device = carry[0].device
        self.carry = tuple(t.clone() for t in carry)
        self.n = torch.zeros((), dtype=torch.int64, device=device)
        self.acc = torch.zeros(4, dtype=torch.float64, device=device)
        consts = (torch.full((), float(tol), dtype=torch.float64,
                             device=device),
                  torch.full((), int(maxiter), dtype=torch.int64,
                             device=device))
        nc = len(self.carry)

        def body(bufs, budget):
            carry, (n, acc, tol_t, maxiter_t) = bufs[:nc], bufs[nc:]
            box = []
            new, k, relres = step(carry, n, inline_solve(
                program, budget, tol_t, maxiter_t, box))
            # a carry entry passed on unchanged is a buffer the writes
            # below may already have overwritten
            new = tuple(t.clone() if any(t is c for c in carry) else t
                        for t in new)
            k = k.to(torch.float64)
            acc_n = torch.stack([acc[0] + k,
                                 torch.maximum(acc[1],
                                               relres.to(torch.float64)),
                                 acc[2] + box[0][0],
                                 torch.maximum(acc[3], k)])
            return new + (n + 1, acc_n, None, None)

        bufs = self.carry + (self.n, self.acc) + consts
        with (obs.span("capture") if capture
              else contextlib.nullcontext()) as sp:
            if capture:
                # the warm-up: a step whose solve runs one masked iteration
                # launches every kernel the program holds
                _side_stream(lambda: body(bufs, 1))
            self.program = Program(lambda g0, *b: body(b, self.budget),
                                   bufs, capture, store)
        self.capture_seconds = sp.seconds if capture else 0.0

    def run(self, carry, n: int, m: int, keep: Callable, j0: int):
        """``m`` steps from ``carry`` at global step ``n``, accumulators
        zero; ``keep(j, carry)`` after the scan's step j (from ``j0``)."""
        for buf, t in zip(self.carry, carry):
            buf.copy_(t)
        self.n.fill_(int(n))
        self.acc.zero_()
        for j in range(j0, j0 + m):
            self.program.run()
            keep(j, self.carry)


def run_steps(step: Callable, per_step, carry, step0: int, num_steps: int,
              keep: Callable, j0: int = 0):
    """Steps ``j0`` … ``j0 + num_steps − 1`` of a scan one at a time, each
    solved by ``per_step``.  Returns (carry, iterations, max relres, the
    most iterations of one step)."""
    iters, res, kmax = 0, 0.0, 0
    for j in range(j0, j0 + num_steps):
        carry, k, r = step(carry, step0 + j, per_step)
        keep(j, carry)
        iters, res, kmax = iters + int(k), max(res, float(r)), max(kmax,
                                                                   int(k))
    return carry, iters, res, kmax


def _on_ladder(k: int, spare: int) -> Optional[int]:
    """The smallest of ``STEP_BUDGETS`` at or above ``k + spare``, at most
    ``STEP_BUDGET_MAX``; None past it."""
    if k > STEP_BUDGET_MAX:
        return None
    return min(b for b in STEP_BUDGETS
               if b >= min(k + spare, STEP_BUDGET_MAX))


def step_budget(k) -> Optional[int]:
    """The budget after a chunk whose worst step took ``k`` iterations: the
    smallest of ``STEP_BUDGETS`` above ``k`` (one iteration to spare), at
    most ``STEP_BUDGET_MAX``; None (the next chunk step by step) past
    it."""
    return _on_ladder(int(k), 1)


def first_budget(k) -> Optional[int]:
    """The budget a trajectory's first chunk starts from after a first step
    of ``k`` iterations: the smallest of ``STEP_BUDGETS`` at or above ``k +
    STEP_BLOCK`` (a later trajectory's data may make its first steps
    harder), at most ``STEP_BUDGET_MAX``; None past it."""
    return _on_ladder(int(k), STEP_BLOCK)


def scan_chunks(num_steps: int, first: bool = False) -> list:
    """The chunks (steps between reads) of ``num_steps`` steps: with
    ``first`` (no budget to start from) its first step alone, then
    ``SCAN_CHUNK`` steps each, the last what is left."""
    out = [min(1, num_steps)] if first else []
    rest = num_steps - sum(out)
    out += [SCAN_CHUNK] * (rest // SCAN_CHUNK)
    return out + ([rest % SCAN_CHUNK] if rest % SCAN_CHUNK else [])


class ScanPrograms:
    """The step programs of one scan in its store: a :class:`StepLoop` a
    budget (at most one a rung of ``STEP_BUDGETS``), the budget a
    trajectory's first chunk starts from (None until a first step solved
    on its own has set it), the budget the last chunk left for the next
    (None: step by step), and whether a trajectory has run to its end on
    them (``settled``)."""

    def __init__(self):
        self.loops: Dict[int, StepLoop] = {}
        self.first: Optional[int] = None
        self.next: Optional[int] = None
        self.settled = False

    def loop_for(self, budget: int) -> Optional[StepLoop]:
        """The program a chunk that wants ``budget`` runs: its own; else,
        once the programs are settled, the smallest wider one kept (any
        budget at or above a step's count gives its answer); else None
        (capture it).  So the trajectory that learns the programs captures
        each budget its steps want (a capture costs less than a chunk run
        a rung or more wide), and a later one captures only a budget wider
        than every program kept."""
        if budget in self.loops:
            return self.loops[budget]
        wider = [b for b in self.loops if b > budget]
        return self.loops[min(wider)] if wider and self.settled else None


def run_scan(store: GraphStore, key, step: Callable, program, per_step,
             carry, tol: float, maxiter: int, step0: int, num_steps: int,
             keep: Callable, start: bool = True, *,
             capture: Optional[bool] = None):
    """``num_steps`` steps of a scan from ``carry`` at global step
    ``step0`` through the :class:`ScanPrograms` of ``key`` in ``store``.

    ``step`` and ``program`` as :class:`StepLoop` takes them; ``per_step``
    solves a step on its own (``solve(b, x0)`` → (x, iterations, relres)
    with a read a block), for a chunk with no budget and for a rerun;
    ``keep(j, carry)`` is called after the scan's step j (0-based) with
    the carry it left, to copy frames.  ``start``: these steps begin a
    trajectory (its first chunk runs at the learned first budget), else
    they go on from an earlier call's (at the budget that call left).
    ``capture`` defaults to :func:`captures` of the carry's device.
    ``key[0]`` names the scan in ``HOST_READS``.  Returns (the final
    carry, a :class:`ScanTally`)."""
    if _PER_STEP:
        carry, k, r, _ = run_steps(step, per_step, carry, step0, num_steps,
                                   keep)
        return carry, ScanTally(k, r)
    if capture is None:
        capture = captures(carry[0].device)
    progs = store.get(key + (capture,))
    if progs is None:
        progs = ScanPrograms()
        store.put(key + (capture,), progs)
    tally, done = ScanTally(), 0
    budget = progs.first if start else progs.next
    for m in scan_chunks(num_steps, first=budget is None):
        if budget is None:
            carry, k, r, kmax = run_steps(step, per_step, carry, step0, m,
                                          keep, done)
            tally = tally.plus(ScanTally(k, r, stepwise=1))
            nxt = step_budget(kmax)
            if start and done == 0 and m == 1:
                # a later trajectory's first steps take more or fewer
                # iterations than this one's as its data differ: it starts
                # one block above, within the cap, on the program the next
                # chunk captures; past the cap, step by step
                nxt = progs.first = first_budget(kmax)
        else:
            loop = progs.loop_for(budget)
            if loop is None:
                loop = progs.loops[budget] = StepLoop(
                    step, program, carry, tol, maxiter, budget, capture,
                    store)
                tally = tally.plus(ScanTally(
                    built=1, capture_seconds=loop.capture_seconds))
            loop.run(carry, step0 + done, m, keep, done)
            count_read(key[0])
            k, r, over, kmax = loop.acc.tolist()
            past = m * loop.budget - int(k)
            if over:
                # a step outran the budget: the chunk again, step by step
                count_read(key[0] + "_redo")
                carry, k, r, kmax = run_steps(step, per_step, carry, step0,
                                              m, keep, done)
            else:
                carry = tuple(t.clone() for t in loop.carry)
            tally = tally.plus(ScanTally(int(k), r, int(over > 0),
                                         past=past))
            nxt = step_budget(kmax)
        done += m
        # past the cap the next chunk runs step by step, with no program
        budget = progs.next = nxt
    progs.settled = progs.settled or start
    return carry, tally
