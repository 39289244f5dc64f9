"""The floor probes of the port against the JAX package's Pallas bodies.

``benchmarks/kernel_floor.py`` wraps each of its four kernels in a function
that returns only milliseconds, so these tests import the kernel bodies and
make the ``pl.pallas_call`` themselves, in interpret mode on the CPU, with
the block specs of the benchmark's own calls.  The port's wrappers run
their plain PyTorch versions on CPU tensors; the CUDA kernels are held
against those on the card by ``test_torch_cuda_kernels.py`` and
``chip_smoke.py``.

The reference works on its padded layout: x, y and the masks span all
``n_pad`` nodes (N rounded up to the block) and x is zero beyond them, so
the port is given N = n_pad here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks.kernel_floor import (_csz_kernel, _residentw_kernel,
                                     _shifts_kernel, _wonly_kernel)
import chip_smoke
from pde_solver_tpu.mesh import box_mesh as ref_box
from pde_solver_tpu.mesh import interval_mesh as ref_interval
from pde_solver_tpu.mesh import rectangle_mesh as ref_rectangle
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops.pallas_kernels import (LANE,
                                               FlatStencilOperator as RefFlat,
                                               _zero_i)
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.ops import floor_probes as fp
from pde_solver_tpu_torch.ops import stencil_kernels as sk

NODES = (17, 9, 9)
BLOCK = 1024          # two blocks of 8 rows: n_pad = 2048 ≥ N = 1377
TOL = 1e-6            # float32 sums of ≤ 135 terms taken in the same order
CASES = [(3, "f32"), (3, "bf16"), (1, "f32"), (1, "bf16")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _operator(vdim, wdt):
    """The reference's operator over random weights on the sorted P1
    stencil of a 3D mesh (15 offsets), and the same packed planes, x and
    masks as torch tensors."""
    tiny = ref_box(2, 2, 2, (0, 0, 0), (1.0, 1.0, 1.0))
    offsets = tuple(sorted(ref_asm.assemble_scalar_stencil(tiny, "mass")))
    rng = np.random.default_rng(7)
    wshape = NODES + ((vdim, vdim) if vdim > 1 else ())
    weights = [rng.standard_normal(wshape) for _ in offsets]
    ref = RefFlat(offsets, weights, NODES, vdim=vdim, block=BLOCK,
                  interpret=True,
                  weight_dtype=jnp.bfloat16 if wdt == "bf16" else jnp.float32)
    x = rng.standard_normal((vdim, ref.n_pad)).astype(np.float32)
    W = torch.from_numpy(np.array(ref.Wf.astype(jnp.float32)).reshape(
        -1, ref.n_pad))
    if wdt == "bf16":
        W = W.to(torch.bfloat16)      # exact: the values are bf16 already
    return ref, W, x


def _specs(op, nw):
    blocked = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    by_block = lambda i: (_zero_i(i), i, _zero_i(i))      # noqa: E731
    whole = lambda i: (_zero_i(i), _zero_i(i), _zero_i(i))  # noqa: E731
    return dict(
        w_stream=blocked((nw, op.rb, LANE), by_block),
        w_tile=blocked((nw, op.rb, LANE), whole),
        masks=blocked((2, op.rb, LANE), by_block),
        x=blocked((op.vdim, op.n_rows + 2 * op.halo_r, LANE), whole),
        y=blocked((op.vdim, op.rb, LANE), by_block),
        y1=blocked((1, op.rb, LANE), by_block))


def _call(kernel, op, in_specs, out_spec, out_rows, *operands):
    return np.asarray(pl.pallas_call(
        kernel, grid=(op.n_rows // op.rb,), in_specs=in_specs,
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct((out_rows, op.n_rows, LANE),
                                       jnp.float32),
        interpret=True)(*operands)).reshape(out_rows, -1)


def _x_pad(op, x):
    return jnp.pad(jnp.asarray(x).reshape(op.vdim, op.n_rows, LANE),
                   ((0, 0), (op.halo_r, op.halo_r), (0, 0)))


def _terms(op):
    return fp.probe_constants(op.n_off * op.vdim * op.vdim)


@pytest.mark.parametrize("vdim,wdt", CASES)
def test_wonly_plain_matches_pallas_interpret(vdim, wdt):
    op, W, _ = _operator(vdim, wdt)
    nw = op.n_off * vdim * vdim
    s = _specs(op, nw)
    y_ref = _call(functools.partial(_wonly_kernel, nw, op.rb), op,
                  [s["w_stream"]], s["y1"], 1, op.Wf)[0]
    y = fp.wonly(W).numpy()
    assert y.shape == (op.n_pad,)
    assert _rel(y, y_ref) <= TOL


@pytest.mark.parametrize("vdim", [3, 1])
def test_shifts_plain_matches_pallas_interpret(vdim):
    op, _, x = _operator(vdim, "f32")
    wc, _, _ = _terms(op)
    s = _specs(op, 0)
    kernel = functools.partial(_shifts_kernel, op.n_off, vdim, op.rb,
                               op.halo_r, op.deltas,
                               tuple(float(w) for w in wc), True)
    y_ref = _call(kernel, op, [s["x"]], s["y"], vdim, _x_pad(op, x))
    y = fp.shifts(torch.from_numpy(x), op.deltas, vdim, wc).numpy()
    assert _rel(y, y_ref) <= TOL


@pytest.mark.parametrize("vdim,wdt", CASES)
def test_residentw_plain_matches_pallas_interpret(vdim, wdt):
    """The tile is the reference's ``Wf[:, :rb, :]``: the first block, B =
    1024 nodes here, so the second block of outputs wraps onto it."""
    op, W, x = _operator(vdim, wdt)
    nw = op.n_off * vdim * vdim
    s = _specs(op, nw)
    kernel = functools.partial(_residentw_kernel, op.n_off, vdim, op.rb,
                               op.halo_r, op.deltas, True)
    y_ref = _call(kernel, op, [s["w_tile"], s["x"]], s["y"], vdim,
                  op.Wf[:, :op.rb, :], _x_pad(op, x))
    tile = fp.weight_tile(W, BLOCK)
    assert tuple(tile.shape) == (nw, BLOCK)
    y = fp.residentw(tile, torch.from_numpy(x), op.deltas, vdim).numpy()
    assert _rel(y, y_ref) <= TOL
    # and it is not the operator: the second block read the first's weights
    y_op = sk.spmv_plain(W, torch.from_numpy(x), op.deltas, vdim).numpy()
    assert _rel(y[:, :BLOCK - 200], y_op[:, :BLOCK - 200]) <= TOL
    assert _rel(y[:, BLOCK:], y_op[:, BLOCK:]) > 0.1


@pytest.mark.parametrize("vdim", [3, 1])
def test_csz_plain_matches_pallas_interpret(vdim):
    op, _, x = _operator(vdim, "f32")
    wc, dz0, dz1 = _terms(op)
    s = _specs(op, 0)
    as_floats = lambda t: tuple(float(v) for v in t)      # noqa: E731
    kernel = functools.partial(_csz_kernel, op.n_off, vdim, op.rb, op.halo_r,
                               op.deltas, as_floats(wc), as_floats(dz0),
                               as_floats(dz1), True)
    nz = NODES[-1]
    flat = np.arange(op.n_pad, dtype=np.int64) % nz
    m_np = np.stack([flat == 0, flat == nz - 1]).astype(np.float32)
    y_ref = _call(kernel, op, [s["masks"], s["x"]], s["y"], vdim,
                  jnp.asarray(m_np.reshape(2, op.n_rows, LANE)),
                  _x_pad(op, x))
    m = fp.face_masks(op.n_pad, nz, "cpu")
    assert np.array_equal(m.numpy(), m_np)
    y = fp.csz(m, torch.from_numpy(x), op.deltas, vdim, wc, dz0, dz1).numpy()
    assert _rel(y, y_ref) <= TOL


def test_probe_constants_are_the_reference_draws():
    rng = np.random.default_rng(0)
    want = [rng.standard_normal(135) * 0.05 for _ in range(3)]
    got = fp.probe_constants(135)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert np.array_equal(g, w.astype(np.float32))
    # shifts_ms draws its wc first from the same seed: the same constants
    assert np.array_equal(
        fp.probe_constants(15)[0],
        (np.random.default_rng(0).standard_normal(15) * 0.05
         ).astype(np.float32))


@pytest.mark.parametrize("vdim,wdt", CASES)
def test_residentw_with_whole_tile_is_the_dense_operator(vdim, wdt):
    """B ≥ N: n mod B = n, so the probe equals ``spmv_plain`` bit for bit
    (same terms, same order)."""
    op, W, x = _operator(vdim, wdt)
    xt = torch.from_numpy(x[:, :op.N].copy())
    y = fp.residentw_plain(W, xt, op.deltas, vdim)
    y_op = sk.spmv_plain(W, xt, op.deltas, vdim)
    assert _rel(y.numpy(), y_op.numpy()) <= TOL


@pytest.mark.parametrize("vdim", [3, 1])
def test_csz_without_face_terms_is_shifts(vdim):
    op, _, x = _operator(vdim, "f32")
    wc, _, _ = _terms(op)
    zero = np.zeros_like(wc)
    xt = torch.from_numpy(x[:, :op.N].copy())      # a ragged N = 1377
    m = fp.face_masks(sk.padded_length(op.N), NODES[-1], "cpu")
    y = fp.csz(m, xt, op.deltas, vdim, wc, zero, zero)
    assert torch.equal(y, fp.shifts(xt, op.deltas, vdim, wc))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    op, W, x = _operator(1, "f32")
    xt = torch.from_numpy(x)
    wc, dz0, dz1 = _terms(op)
    m = fp.face_masks(op.n_pad, NODES[-1], "cpu")
    with pytest.raises(ValueError, match="float32"):
        fp.shifts(xt.double(), op.deltas, 1, wc)
    with pytest.raises(ValueError, match="constants"):
        fp.shifts(xt, op.deltas, 1, wc[:-1])
    with pytest.raises(ValueError, match="planes"):
        fp.residentw(W[:3].contiguous(), xt, op.deltas, 1)
    with pytest.raises(ValueError, match="masks"):
        fp.csz(m[:, :-128].contiguous(), xt, op.deltas, 1, wc, dz0, dz1)
    with pytest.raises(ValueError, match="f32/bf16"):
        fp.wonly(W.double())


def test_entry_point_runs_every_probe_on_the_cpu_and_counts_no_launch():
    sk.reset_launch_counts()
    with config.config_overrides(device="cpu"):
        out = fp.kernel_floor(cells=(8, 4, 4), reps=1)
    assert out["clock"] == "host" and out["device"] == "cpu"
    assert out["nodes"] == (9, 5, 5) and out["n_off"] == 15
    assert set(out["ms"]) == {"full_f32", "full_bf16", "wonly_f32",
                              "wonly_bf16", "residentw_f32", "residentw_bf16",
                              "shifts", "csz"}
    assert all(t > 0 for t in out["ms"].values())
    assert not sk.KERNEL_LAUNCHES      # plain versions launch nothing


@pytest.mark.parametrize("vdim", [3, 1])
def test_shifts_library_conv1d_is_shifts_plain(vdim):
    """The library yardstick chip_smoke.py times beside shifts: one conv1d
    with the constants at the taps P + δ and zero padding P = max|δ|
    computes the shifted sum with zero fill outside [0, N)."""
    op, _, x = _operator(vdim, "f32")
    wc, _, _ = _terms(op)
    xt = torch.from_numpy(x[:, :op.N].copy())      # a ragged N = 1377
    y = chip_smoke.shifts_library(xt, op.deltas, vdim, wc)()
    assert y.shape == xt.shape
    assert _rel(y.numpy(), fp.shifts_plain(xt, op.deltas, vdim,
                                           wc).numpy()) <= 1e-5


# ---- the launch plans of residentw and csz ---------------------------------

# the main paths' probe shapes (flagship v3, heat slice v1) and the two
# ragged tails chip_smoke.py holds the kernels at (N mod 4 = 3 and 1)
PLAN_SHAPES = [((161, 65, 65), 3), ((129, 129, 129), 1),
               ((71, 65, 61), 3), ((73, 65, 61), 1)]
# blocks of residentw an H100 holds at once at v3: 132 SMs × 2 (214
# registers a thread)
RESIDENT = 132 * 2


def _deltas(shape):
    tiny = ref_box(2, 2, 2, (0, 0, 0), (1.0, 1.0, 1.0))
    offsets = sorted(ref_asm.assemble_scalar_stencil(tiny, "mass"))
    strides = (shape[1] * shape[2], shape[2], 1)
    return tuple(int(sum(o * s for o, s in zip(off, strides)))
                 for off in offsets)


def _resident_nodes(plan):
    """Every node residentw computes under the plan, by the kernel's index
    arithmetic: thread slot s of block (slot block, range) visits s + jB
    for the repeats j of its range while s < B and s + jB < N."""
    slot = np.arange(plan.slot_blocks * plan.threads)
    slot = slot[slot < plan.B]
    j = np.arange(plan.ranges * plan.per_range)
    j = j[j < plan.repeats]
    n = slot[:, None] + j[None, :] * plan.B
    return n[n < plan.N]


@pytest.mark.parametrize("shape", [shape for shape, _ in PLAN_SHAPES])
@pytest.mark.parametrize("B", [64, fp.TILE_NODES, None])
def test_residentw_plan_covers_every_node_once(shape, B):
    """Every node of [0, N) is computed exactly once, by a thread whose
    slot is n mod B; B None is the whole-W tile (N_pad slots)."""
    N = int(np.prod(shape))
    B = B or sk.padded_length(N)
    plan = fp.residentw_plan(N, B, RESIDENT)
    assert plan.slot_blocks * plan.threads >= B
    assert plan.ranges * plan.per_range >= plan.repeats
    assert (plan.ranges - 1) * plan.per_range < plan.repeats
    assert plan.slot_blocks * plan.ranges <= max(RESIDENT, plan.slot_blocks)
    nodes = _resident_nodes(plan)
    assert np.array_equal(np.bincount(nodes, minlength=N), np.ones(N, int))
    assert len(plan.c_array) == 5 and plan.c_array.dtype == np.int32


@pytest.mark.parametrize("N,B", [(1000, 4096), (4099, 4096), (10 ** 5, 64),
                                 (10 ** 5, 100_000)])
def test_residentw_plan_ragged_repeats_and_small_grids(N, B):
    """N < B (one partial repeat), N mod B ≠ 0, and ranges that do not
    divide the repeats: still every node once."""
    for resident in (1, 7, RESIDENT, 132 * 3):
        plan = fp.residentw_plan(N, B, resident)
        assert np.array_equal(np.bincount(_resident_nodes(plan), minlength=N),
                              np.ones(N, int))


def _staged(plan, x, b, B0, sh, s):
    """What the kernel stages of segment s of component b for the run at
    B0: 16-byte chunks from the boundary at or below x[b, B0 + seg_lo[s]]
    (x's pointer sh values past a boundary), zero outside [0, N).  The
    chunks [j_lo, j_hi) the kernel copies whole (by TMA) must lie inside
    [0, N), and every other chunk must not."""
    N = plan.N
    chunks = plan.seg_chunks[s]
    i0 = sh + b * N + B0 + plan.seg_lo[s]
    pos0 = (i0 - i0 % 4) - sh - b * N
    j_lo = min(chunks, max(0, (3 - pos0) >> 2))
    j_hi = max(j_lo, min(chunks, (N - pos0) >> 2))
    first = pos0 + 4 * np.arange(chunks)
    whole = (first >= 0) & (first + 4 <= N)
    assert np.array_equal(whole, (np.arange(chunks) >= j_lo)
                          & (np.arange(chunks) < j_hi))
    pos = pos0 + np.arange(4 * chunks)
    inside = (pos >= 0) & (pos < N)
    return np.where(inside, x[b, np.clip(pos, 0, N - 1)], 0.0), i0 % 4


@pytest.mark.parametrize("shape,vdim", PLAN_SHAPES)
@pytest.mark.parametrize("sh", [0, 3])
def test_csz_plan_stages_every_read(shape, vdim, sh):
    """Block r takes run r, the runs cover [0, N) and every node of a run
    is taken by one thread; every x[b, n + δ_o] a node reads lies in its
    group's staged segment and is x there, or zero exactly where n + δ_o
    falls outside [0, N).  x's values are distinct, so a read of the wrong
    value shows."""
    N = int(np.prod(shape))
    deltas = _deltas(shape)
    plan = fp.csz_plan(N, deltas, vdim)
    run = plan.run
    assert plan.smem_bytes <= fp.MAX_SMEM
    assert (plan.runs - 1) * run < N <= plan.runs * run
    ln = (np.arange(fp.CSZ_THREADS)[:, None]
          + np.arange(fp.csz_nodes(vdim))[None, :] * fp.CSZ_THREADS).ravel()
    assert np.array_equal(np.sort(ln), np.arange(run))
    x = (np.arange(vdim * N, dtype=np.float64).reshape(vdim, N) + 1.0)
    n_all = np.arange(N)
    for first, size in sk.row_groups(15):
        g = [f for f, _ in sk.row_groups(15)].index(first)
        s = plan.group_seg[g]
        assert plan.group_off[g] == deltas[first] - plan.seg_lo[s] >= 0
        for b in range(vdim):
            got = np.empty((size, N))
            for r in range(plan.runs):
                B0 = r * run
                seg, shift = _staged(plan, x, b, B0, sh, s)
                n = n_all[B0:B0 + run]
                for p in range(size):
                    q = shift + plan.group_off[g] + (n - B0) + p
                    assert q.max() < len(seg)
                    got[p, B0:B0 + len(n)] = seg[q]
            for p in range(size):
                src = n_all + deltas[first + p]
                want = np.where((src >= 0) & (src < N),
                                x[b, np.clip(src, 0, N - 1)], 0.0)
                assert np.array_equal(got[p], want), (g, p, b)


def test_csz_plan_merges_overlapping_windows():
    """At 15 offsets on a 3D grid the seven row groups' windows fall into
    three segments (the planes below, at and above the node), and the
    flagship's staged x fits an SM's shared memory five times."""
    plan = fp.csz_plan(161 * 65 * 65, _deltas((161, 65, 65)), 3)
    assert plan.seg_lo == (-4291, -66, 4225)
    assert plan.group_seg == (0, 0, 1, 1, 1, 2, 2)
    assert 5 * plan.smem_bytes <= 228 * 1024
    assert plan.runs == -(-161 * 65 * 65 // plan.run) and plan.run == 512
    assert len(plan.c_array) == 7 + 5 * fp.MAX_GROUPS
    assert fp.csz_plan(129 ** 3, _deltas((129, 129, 129)), 1).run == 1024
    # a grid smaller than one run: one run, one segment
    small = fp.csz_plan(5 * 5 * 5, _deltas((5, 5, 5)), 1)
    assert (small.runs, len(small.seg_lo)) == (1, 1)


# ---- shifts: blocks walking columns of runs a plane apart ------------------

def _stencil_deltas(shape):
    """The flat deltas of the sorted P1 stencil of the shape's dimension
    (3, 7 or 15 offsets)."""
    dim = len(shape)
    tiny = (ref_box(2, 2, 2, (0, 0, 0), (1.0, 1.0, 1.0)) if dim == 3
            else ref_rectangle(2, 2, (0, 0), (1.0, 1.0)) if dim == 2
            else ref_interval(2, 0.0, 1.0))
    offsets = sorted(ref_asm.assemble_scalar_stencil(tiny, "mass"))
    strides = [int(np.prod(shape[i + 1:])) for i in range(dim)]
    return tuple(int(sum(o * s for o, s in zip(np.atleast_1d(off), strides)))
                 for off in offsets)


def _shifts_runs(plan):
    """(block, column start c0, plane j, first node B0, nodes) of every
    run of the plan, by the kernel's index arithmetic: thread t takes the
    nodes B0 + t + k·SHIFTS_THREADS of a run, those below the column's end
    (c0 + stride) and N."""
    ln = (np.arange(fp.SHIFTS_THREADS)[:, None] + np.arange(
        fp.SHIFTS_NODES)[None, :] * fp.SHIFTS_THREADS).ravel()
    for b in range(plan.blocks):
        c, j0, j1 = plan.block_planes(b)
        c0 = c * plan.run
        for j in range(j0, j1):
            B0 = c0 + j * plan.stride
            n = B0 + ln[ln < min(plan.run, plan.stride - c0)]
            yield b, c0, j, B0, n[n < plan.N]


# 1D (3 offsets), 2D (7) and 3D (15) grids: the main paths' shapes, ragged
# N (N mod 4 ≠ 0), rows or planes shorter and longer than a run, and
# grids smaller than one run
SHIFTS_SHAPES = [(5000,), (4003,), (37,), (65, 34), (67, 41), (3, 5),
                 (7, 1100), (161, 65, 65), (129, 129, 129), (71, 65, 61),
                 (73, 65, 61), (2, 2, 2), (9, 9, 9)]
# (SMs, blocks an SM holds): one block, a few, and an H100 at the
# flagship's ring (7 an SM) and at a small one
CARDS = [(1, 1), (3, 2), (132, 7), (132, 12)]


@pytest.mark.parametrize("shape", SHIFTS_SHAPES)
@pytest.mark.parametrize("vdim", [2, 3])
@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_shifts_plan_covers_every_node_once(shape, vdim, sms, per_sm):
    """Every node of [0, N) is computed exactly once, and the grid is one
    wave (but where the columns alone outnumber what the card holds); the
    ranges of a column tile its planes, the longer ones first."""
    N = int(np.prod(shape))
    plan = fp.shifts_plan(N, _stencil_deltas(shape), vdim, sms, per_sm)
    assert plan.stride >= plan.run
    assert (plan.planes - 1) * plan.stride < N <= plan.planes * plan.stride
    assert plan.blocks <= max(sms * per_sm, plan.columns)
    nodes = np.concatenate([n for *_, n in _shifts_runs(plan)])
    assert np.array_equal(np.bincount(nodes, minlength=N), np.ones(N, int))
    ranges = [plan.block_planes(b)[1:] for b in range(0, plan.blocks,
                                                       plan.columns)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.planes
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    lengths = [e - s for s, e in ranges]
    assert lengths == sorted(lengths, reverse=True)
    assert lengths[0] - lengths[-1] <= 1


@pytest.mark.parametrize("shape", SHIFTS_SHAPES)
@pytest.mark.parametrize("vdim", [2, 3])
def test_shifts_plan_ring_holds_every_window_a_run_reads(shape, vdim):
    """The kernel's ring, step by step: a block stages the planes q0 = j0
    + m_lo, ... up to the ring's size, window g = q − q0 into slot g mod
    stages at fill g div stages, and after the run of plane j the plane j
    + m_lo + stages into the slot plane j + m_lo leaves.  Every run finds
    the planes j + m_lo ... j + m_hi in their slots, at the fill whose
    parity it waits for, and no staged plane goes unread."""
    N = int(np.prod(shape))
    plan = fp.shifts_plan(N, _stencil_deltas(shape), vdim, 3, 2)
    assert plan.m_hi - plan.m_lo + 1 <= plan.stages <= fp.MAX_STAGES
    for b in range(plan.blocks):
        g = 0
        slots = {}                    # slot: (column, plane, fill)
        c, j0, j1 = plan.block_planes(b)
        for c0, j0, j1 in [(c * plan.run, j0, j1)]:
            q0, q_end = j0 + plan.m_lo, j1 + plan.m_hi
            staged, read = set(), set()

            def stage(q):
                w = g + q - q0
                slots[w % plan.stages] = (c0, q, w // plan.stages)
                staged.add(q)
            for i in range(min(plan.stages, q_end - q0)):
                stage(q0 + i)
            lo, wraps = g % plan.stages, g // plan.stages
            for j in range(j0, j1):
                for d in range(plan.m_hi - plan.m_lo + 1):
                    i = lo + d
                    slot = i if i < plan.stages else i - plan.stages
                    parity = (wraps + (i >= plan.stages)) & 1
                    assert slots[slot][:2] == (c0, j + plan.m_lo + d)
                    assert slots[slot][2] % 2 == parity
                    read.add(j + plan.m_lo + d)
                if j + plan.m_lo + plan.stages < q_end:
                    stage(j + plan.m_lo + plan.stages)
                lo += 1
                if lo == plan.stages:
                    lo, wraps = 0, wraps + 1
            assert staged == read
            g += q_end - q0


def _check_windows(plan, deltas, sh):
    """Every x[b, n + δ_o] a node of a run reads lies in its group's staged
    window (the window of plane j + group_plane[g] of the run's column,
    its chunks from the 16-byte boundary at or below its start, zero
    outside [0, N)) and is x there, or zero exactly where n + δ_o falls
    outside [0, N).  x's values are distinct, so a read of the wrong value
    shows."""
    N, vdim = plan.N, plan.vdim
    x = np.arange(vdim * N, dtype=np.float64).reshape(vdim, N) + 1.0
    groups = sk.row_groups(len(deltas))
    pos = np.arange(plan.row_floats)
    for _, c0, j, B0, n in _shifts_runs(plan):
        if not len(n):                 # a run past N in the last plane
            continue
        for b in range(vdim):
            windows = {}
            for m in range(plan.m_lo, plan.m_hi + 1):
                i0 = sh + b * N + c0 + (j + m) * plan.stride + plan.win_lo
                p0 = (i0 - i0 % 4) - sh - b * N + pos
                inside = (p0 >= 0) & (p0 < N)
                windows[m] = (np.where(inside, x[b, np.clip(p0, 0, N - 1)],
                                       0.0), i0 % 4)
            for g, (first, size) in enumerate(groups):
                win, shift = windows[plan.group_plane[g]]
                for p in range(size):
                    q = shift + plan.group_off[g] + (n - B0) + p
                    assert q.max() < plan.row_floats
                    src = n + deltas[first + p]
                    want = np.where((src >= 0) & (src < N),
                                    x[b, np.clip(src, 0, N - 1)], 0.0)
                    assert np.array_equal(win[q], want), (g, p, b, j)


@pytest.mark.parametrize("shape", [(5000,), (4003,), (65, 34), (7, 1100),
                                   (161, 65, 65), (71, 65, 61), (73, 65, 61),
                                   (2, 2, 2), (9, 9, 9)])
@pytest.mark.parametrize("vdim", [3, 2])
@pytest.mark.parametrize("sh", [0, 3])
def test_shifts_plan_stages_every_read(shape, vdim, sh):
    """The windows of shifts hold every x value their runs' nodes read,
    zero outside [0, N), at both ends and across them, whatever x's
    16-byte shift."""
    deltas = _stencil_deltas(shape)
    plan = fp.shifts_plan(int(np.prod(shape)), deltas, vdim, 132, 7)
    _check_windows(plan, deltas, sh)


@pytest.mark.parametrize("shape", [(161, 65, 65), (129, 129, 129), (67, 41),
                                   (7, 1100), (4003,)])
@pytest.mark.parametrize("vdim", [2, 3])
def test_shifts_plan_array_and_limits(shape, vdim):
    """The array the C function checks: {threads, nodes a thread, run,
    stride, columns, planes, ranges, blocks, m_lo, m_hi, stages, win_lo,
    row_floats, shared bytes}, then two rows of MAX_GROUPS slots (each
    group's plane, its offset in the window); the ring's shared bytes
    within a block's limit, and what the wrapper sizes the grid by."""
    N = int(np.prod(shape))
    deltas = _stencil_deltas(shape)
    plan = fp.shifts_plan(N, deltas, vdim, 132, 7)
    a = plan.c_array
    assert a.dtype == np.int32 and len(a) == 14 + 2 * fp.MAX_GROUPS
    assert list(a[:14]) == [
        fp.SHIFTS_THREADS, fp.SHIFTS_NODES, plan.run, plan.stride,
        -(-plan.stride // plan.run), -(-N // plan.stride), plan.ranges,
        plan.blocks, plan.m_lo, plan.m_hi, plan.stages, plan.win_lo,
        plan.row_floats, plan.smem_bytes]
    rows = a[14:].reshape(2, fp.MAX_GROUPS)
    for row, want in zip(rows, (plan.group_plane, plan.group_off)):
        assert list(row[:len(want)]) == list(want)
        assert not row[len(want):].any()
    assert plan.row_floats % 4 == 0
    assert plan.stages == plan.m_hi - plan.m_lo + 1 + fp.SHIFTS_AHEAD
    assert plan.smem_bytes == fp.shifts_smem_bytes(deltas, vdim) \
        == 4 * plan.stages * vdim * plan.row_floats <= fp.MAX_SMEM
    for (first, _), m, off in zip(sk.row_groups(len(deltas)),
                                  plan.group_plane, plan.group_off):
        assert off == deltas[first] - m * plan.stride - plan.win_lo >= 0


def test_shifts_plan_at_the_main_paths_shapes(monkeypatch):
    """The flagship's v3 level: runs of 512 nodes in 9 columns a stride of
    4,291 (the distance of the middle plane's x from the upper one's), 159
    planes; each plane's window the middle segment csz stages, 648 floats
    a component, in a ring of 4; each column cut into 58 ranges, 522
    blocks on an H100 (four an SM), the first 43 ranges of 3 planes, the
    rest of 2: 11 runs on the busiest SM where the card gives block b to
    SM b mod 132, as few as 1,431 runs allow.  A 1D grid walks consecutive
    runs, its one window a plane.  The heat slice's v1 takes no plan.  A
    ring beyond MAX_STAGES is refused."""
    flagship = _deltas((161, 65, 65))
    plan = fp.shifts_plan(161 * 65 * 65, flagship, 3, 132, 7)
    assert (plan.run, plan.stride, plan.columns, plan.planes) == \
        (512, 4291, 9, 159)
    assert (plan.m_lo, plan.m_hi, plan.stages) == (-1, 1, 4)
    assert plan.group_plane == (-1, -1, 0, 0, 0, 1, 1)
    csz = fp.csz_plan(161 * 65 * 65, flagship, 3)
    assert plan.win_lo == csz.seg_lo[1]
    assert plan.row_floats == 4 * csz.seg_chunks[1] == 648
    assert plan.smem_bytes == 4 * 4 * 3 * 648
    assert (plan.ranges, plan.blocks) == (58, 522)
    assert [plan.block_planes(b) for b in (0, 1, 386, 387, 521)] == \
        [(0, 0, 3), (1, 0, 3), (8, 126, 129), (0, 129, 131), (8, 157, 159)]
    lengths = [e - s for _, s, e in map(plan.block_planes,
                                        range(plan.blocks))]
    assert max(sum(lengths[m::132]) for m in range(132)) == 11 == \
        -(-plan.columns * plan.planes // 132)
    line = fp.shifts_plan(5000, _stencil_deltas((5000,)), 3, 3, 1)
    assert (line.stride, line.columns, line.m_lo, line.m_hi) == \
        (512, 1, 0, 0)
    assert (line.blocks, line.stages) == (3, 2)
    assert [line.block_planes(b) for b in range(3)] == \
        [(0, 0, 4), (0, 4, 7), (0, 7, 10)]
    assert 1 not in fp.SHIFTS_STAGED_VDIMS
    monkeypatch.setattr(fp, "SHIFTS_AHEAD", fp.MAX_STAGES)
    fp.shifts_plan.cache_clear()
    with pytest.raises(ValueError, match="windows"):
        fp.shifts_plan(161 * 65 * 65, flagship, 3, 132, 7)
    fp.shifts_plan.cache_clear()


@pytest.mark.parametrize("planes,columns,sms,per_sm,want", [
    (159, 9, 132, 7, 58),      # the flagship: four blocks an SM
    (129, 17, 132, 2, 15),     # an SM that holds two
    (129, 17, 132, 3, 23),     # three
    (5, 1, 3, 1, 3),
    (2, 1, 132, 7, 2),         # fewer planes than blocks: one a block
    (10, 500, 132, 1, 1)])     # more columns than the card holds
def test_shifts_ranges_fill_the_card_in_one_wave(planes, columns, sms,
                                                 per_sm, want):
    assert fp.shifts_ranges(planes, columns, sms, per_sm) == want
