"""CUDA kernels of the port against their plain PyTorch versions, on the
card: the dense flat-stencil SpMV (every variant ``chip_smoke.py`` launches,
v1_bf16 included), the fused constant-interior kernel (K3 and K4) and the
four floor probes.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py
"""

import copy

import numpy as np
import pytest
import torch

from pde_solver_tpu_torch.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu_torch.ops.linsolve import (_cg_unit_diag, np_stencil_apply,
                                               prepare_system)
from pde_solver_tpu_torch.ops import cs_kernels as ck
from pde_solver_tpu_torch.ops import floor_probes as fp
from pde_solver_tpu_torch.ops import stencil_kernels as sk
from pde_solver_tpu_torch.ops.timestepping import _combine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _system(vdim, cells=(10, 6, 6)):
    """vdim 1: scalar stiffness (1D 3 offsets, 2D 7, 3D 15); vdim = mesh
    dimension: elasticity (2D plane elasticity has 7 offsets, 3D 15)."""
    mesh = (box_mesh(*cells, (0, 0, 0), (1.0, 0.5, 0.5)) if len(cells) == 3
            else rectangle_mesh(*cells, (0, 0), (1.0, 1.0)) if len(cells) == 2
            else interval_mesh(cells[0], 0.0, 1.0))
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(all_boundary(mesh), 2.0)],
                                    mesh.node_shape)
        rhs = assembly.assemble_load(mesh)
    else:
        K = assembly.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=vdim)
        rhs = assembly.assemble_vector_load(
            mesh, np.array([0.0, 1.0, -2.0][:vdim]))
    return mesh, prepare_system(K, mesh, bc, rhs, vdim)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vdim,cells", [
    (1, (10, 6, 6)), (1, (12, 9)), (1, (33, 7, 5)),
    (2, (12, 9)), (2, (64, 33)),          # 2D plane elasticity, 7 offsets
    (3, (10, 6, 6)), (3, (33, 7, 5)),
    (1, (12,)), (1, (5000,)),             # 1D, 3 offsets
    # ragged tails, N mod 8 = 1, 3, 7, each with blocks clear of both ends
    # of x (a bf16 block spans 1024 nodes)
    (1, (4002,)), (1, (4006,)), (1, (40, 12, 12)),
    (2, (68, 44)), (2, (66, 40)), (2, (70, 40)),
    (3, (40, 12, 12)), (3, (18, 8, 8)), (3, (22, 8, 8)),
    # every node's shifts cross both ends of x
    (1, (1, 1, 1)), (2, (1, 1)), (3, (1, 1, 1))])
def test_kernel_matches_plain(card, vdim, bf16, cells):
    mesh, sysm = _system(vdim, cells)
    dt = torch.bfloat16 if bf16 else torch.float32
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=vdim, device=card).as_weight_dtype(dt)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (vdim, op.N)).astype(np.float32)).to(card)
    before = sk.KERNEL_LAUNCHES.get(op.variant, 0)
    y = op.apply_flat(x)
    torch.cuda.synchronize()
    assert op.launches == 1
    assert sk.KERNEL_LAUNCHES[op.variant] == before + 1
    y_plain = sk.spmv_plain(op.W, x, op.deltas, vdim)
    assert _rel(y.cpu(), y_plain.cpu()) <= 1e-5  # FMA vs separate roundings
    if not bf16:  # f32 weights: also against the f64 host apply
        y64 = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                               op.from_flat(x).cpu().numpy().astype(np.float64),
                               mesh.dim, vdim)
        assert _rel(op.from_flat(y).cpu(), y64) <= 1e-5


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vdim,shape", [
    (1, (300003,)), (1, (515, 517)), (1, (69, 65, 61)),
    (2, (513, 513)), (2, (521, 515)), (2, (515, 517)),
    (3, (69, 65, 61)), (3, (71, 65, 61)), (3, (65, 65, 63))])
def test_wide_path_ragged_tail_matches_plain(card, vdim, bf16, shape):
    """Grids of ≥ 2^18 nodes take 4 (f32) or 8 (bf16) nodes a thread; here
    N mod 8 is 1, 3 or 7, so the last thread's group is partial.  Random
    weights on the sorted P1 stencil; then the last node's weights zeroed
    in every plane must zero y there and change nothing else."""
    dim = len(shape)
    tiny = (box_mesh(2, 2, 2, (0, 0, 0), (1, 1, 1)) if dim == 3
            else rectangle_mesh(2, 2, (0, 0), (1, 1)) if dim == 2
            else interval_mesh(2, 0.0, 1.0))
    offsets = tuple(sorted(assembly.assemble_scalar_stencil(tiny, "mass")))
    N = int(np.prod(shape))
    rng = np.random.default_rng(6)
    W = np.zeros((len(offsets) * vdim * vdim, sk.padded_length(N)),
                 np.float32)
    W[:, :N] = rng.standard_normal((W.shape[0], N))
    op = sk.FlatStencilOperator.from_packed(torch.from_numpy(W).to(card),
                                            offsets, shape, vdim)
    op = op.as_weight_dtype(torch.bfloat16 if bf16 else torch.float32)
    x = torch.from_numpy(rng.standard_normal((vdim, N)).astype(
        np.float32)).to(card)
    y = op.apply_flat(x)
    torch.cuda.synchronize()
    assert _rel(y.cpu(), sk.spmv_plain(op.W, x, op.deltas, vdim).cpu()) \
        <= 1e-5
    op.W[:, N - 1] = 0
    y_cut = op.apply_flat(x)
    torch.cuda.synchronize()
    assert torch.equal(y_cut[:, :-1], y[:, :-1])
    assert not y_cut[:, -1].any() and y[:, -1].abs().min() > 0


def test_kernel_rejects_what_it_does_not_take(card):
    mesh, sysm = _system(3)
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=3, device=card)
    with pytest.raises(ValueError):
        op.apply_flat(torch.zeros((3, op.N), dtype=torch.float64, device=card))
    with pytest.raises(ValueError):
        op.apply_flat(torch.zeros((op.N, 3), device=card).t())
    assert op.launches == 0
    # a vdim the kernel is not built for is refused at construction
    with pytest.raises(ValueError, match="vdim"):
        sk.FlatStencilOperator.from_packed(
            torch.zeros((15 * 16, op.N_pad), device=card), sysm.offsets,
            mesh.node_shape, 4)


def test_flat_cg_through_kernel_matches_cpu(card):
    mesh, sysm = _system(1, (12, 12, 12))
    b = np.asarray(sysm.b_hat, np.float32)
    out = {}
    for dev in ("cpu", card):
        op = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                    mesh.node_shape, vdim=1, device=dev)
        bt = torch.from_numpy(b).to(dev)
        x, k, relres = _cg_unit_diag(sysm.offsets, op, bt,
                                     torch.zeros_like(bt), 1e-6, 500, 3, 1)
        out[str(dev)] = (x.cpu().numpy(), k, relres, op.launches)
    x_cpu, k_cpu, rr_cpu, n_cpu = out["cpu"]
    x_gpu, k_gpu, rr_gpu, n_gpu = out["cuda"]
    assert n_cpu == 0 and n_gpu >= k_gpu > 0
    assert rr_cpu <= 1e-6 and rr_gpu <= 1e-6
    assert abs(k_gpu - k_cpu) <= 2
    assert _rel(x_gpu, x_cpu) <= 1e-5


# ---- constant-interior operator (K3 and K4 in one fused kernel) -------------

def _cs_system(vdim, cells):
    """v=1: the scaled backward-Euler heat operator with all-boundary
    Dirichlet (the heat slice's operator); v=3: a clamped elastic bar."""
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.25, 0.25))
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        M = assembly.assemble_scalar_stencil(mesh, "mass")
        bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)],
                                    mesh.node_shape)
        sysm = prepare_system(_combine(K, M, 0.01, 1.0), mesh, bc,
                              np.zeros(mesh.node_shape), 1)
    else:
        K = assembly.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=3)
        sysm = prepare_system(K, mesh, bc, np.zeros(mesh.node_shape + (3,)),
                              3)
    return mesh, sysm


def _cs_op(vdim, cells, device):
    mesh, sysm = _cs_system(vdim, cells)
    op = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim, device=device)
    assert op is not None, f"{cells} must be CS-representable"
    return mesh, sysm, op


# the main-path-like grids, then ragged tails: N mod 4 = 3 and 1 on small
# grids, 3, 1 and 3 at ≥ 2^18 nodes; in every case N is not a multiple of
# the 128-node block or of 1024, and the last, partial window is listed
CS_CASES = [(1, (40, 6, 6)), (1, (48, 20, 24)), (1, (64, 64, 64)),
            (3, (100, 6, 6)), (3, (60, 8, 8)),
            (1, (40, 12, 14)), (3, (44, 10, 12)),
            (1, (64, 64, 66)), (3, (80, 56, 56)), (3, (82, 56, 56))]


def _x(op, seed, card):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (op.vdim, op.N)).astype(np.float32)).to(card)


@pytest.mark.parametrize("vdim,cells", CS_CASES)
def test_cs_kernels_match_plain(card, vdim, cells):
    """The fused kernel equals cs_apply_plain, and without its slot map
    cs_main_plain, bit for bit (up to the sign of zero): one launch each."""
    _, _, op = _cs_op(vdim, cells, card)
    assert op.windows[-1] == (op.N - 1) // ck.WINDOW and op.N % ck.WINDOW
    x = _x(op, 7, card)
    before = sk.KERNEL_LAUNCHES.get(f"cs_apply_v{vdim}", 0)
    y_main = op.launch(x, windows=False)
    y = op.launch(x)
    y_apply = op.apply_flat(x)
    torch.cuda.synchronize()
    assert torch.equal(y_main, ck.cs_main_plain(op, x))
    y_plain = ck.cs_apply_plain(op, x)
    assert torch.equal(y, y_plain) and torch.equal(y_apply, y_plain)
    assert op.launches == 3
    assert sk.KERNEL_LAUNCHES[f"cs_apply_v{vdim}"] == before + 3


@pytest.mark.parametrize("vdim,cells", [(1, (48, 20, 24)), (3, (60, 8, 8)),
                                        (3, (80, 56, 56))])
def test_cs_kernel_planted_faults_show(card, vdim, cells):
    """One residual weight, one class scalar, one interior scalar changed
    in the kernel's tables: each moves the kernel > 1e-4 (relative) off
    the plain version of the unchanged operator."""
    _, _, op = _cs_op(vdim, cells, card)
    x = _x(op, 10, card)
    y_plain = ck.cs_apply_plain(op, x)
    scale = float(np.abs(op.terms[0]).max())
    center = op.deltas.index(0) * vdim * vdim      # term (o, b=0, a=0)
    # the window node where |x| is largest, on the centre offset's plane
    nodes = (op.win_idx.long()[:, None] * ck.WINDOW
             + torch.arange(ck.WINDOW, device=card)[None, :]).reshape(-1)
    t = int(torch.where(nodes < op.N, x[0, nodes.clamp(max=op.N - 1)].abs(),
                        torch.zeros((), device=card)).argmax())
    faults = {}
    bad = copy.copy(op)
    bad.Wwin = op.Wwin.clone()
    bad.Wwin[center, t] += scale
    faults["residual weight"] = bad
    bad = copy.copy(op)
    bad.cls_terms = op.cls_terms.clone()
    bad.cls_terms[0, center] += scale
    faults["class scalar"] = bad
    bad = copy.copy(op)
    bad.terms = op.terms.copy()
    bad.terms[0, center] *= 1.01
    bad._params = None
    faults["interior scalar"] = bad
    for what, bad in faults.items():
        y = bad.launch(x)
        torch.cuda.synchronize()
        assert _rel(y.cpu(), y_plain.cpu()) > 1e-4, what
    assert torch.equal(op.launch(x), y_plain)


@pytest.mark.parametrize("vdim,cells", [(1, (48, 20, 24)), (3, (60, 8, 8))])
def test_cs_kernels_match_dense_kernel(card, vdim, cells):
    mesh, sysm, op = _cs_op(vdim, cells, card)
    dense = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                   mesh.node_shape, vdim=vdim, device=card)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (vdim, op.N)).astype(np.float32)).to(card)
    y_cs, y_dense = op.apply_flat(x), dense.apply_flat(x)
    torch.cuda.synchronize()
    assert (y_cs - y_dense).abs().max() <= 2e-6 * y_dense.abs().max()
    y64 = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                           op.from_flat(x).cpu().numpy().astype(np.float64),
                           mesh.dim, vdim)
    assert _rel(op.from_flat(y_cs).cpu(), y64) <= 1e-5


def test_cs_kernels_reject_what_they_do_not_take(card):
    mesh, sysm, op = _cs_op(3, (60, 8, 8), card)
    with pytest.raises(ValueError):
        op.apply_flat(torch.zeros((3, op.N), dtype=torch.float64, device=card))
    with pytest.raises(ValueError):
        op.apply_flat(torch.zeros((op.N, 3), device=card).t())
    with pytest.raises(ValueError):
        op.launch(torch.zeros((3, op.N)))
    with pytest.raises(ValueError):
        op.launch(torch.zeros((3, op.N + 1), device=card), windows=False)
    assert op.launches == 0
    # a vdim the kernel is not built for is refused at construction
    nw = len(sysm.offsets) * 4
    with pytest.raises(ValueError, match="vdim"):
        ck.CSFlatStencilOperator(sysm.offsets, mesh.node_shape, 2,
                                 [np.ones(nw)], [], np.zeros(1, np.int64),
                                 np.zeros((nw, ck.WINDOW)), device=card)


def test_flat_cg_through_cs_kernels_matches_cpu(card):
    mesh, sysm = _cs_system(1, (40, 12, 12))
    b = np.asarray(np.random.default_rng(9).standard_normal(
        mesh.node_shape), np.float32)
    out = {}
    for dev in ("cpu", card):
        op = ck.CSFlatStencilOperator.try_build(
            sysm.offsets, sysm.weights, mesh.node_shape, vdim=1, device=dev)
        bt = torch.from_numpy(b).to(dev)
        x, k, relres = _cg_unit_diag(sysm.offsets, op, bt,
                                     torch.zeros_like(bt), 1e-6, 500, 3, 1)
        out[str(dev)] = (x.cpu().numpy(), k, relres, op.launches)
    x_cpu, k_cpu, rr_cpu, n_cpu = out["cpu"]
    x_gpu, k_gpu, rr_gpu, n_gpu = out["cuda"]
    assert n_cpu == 0 and n_gpu >= k_gpu > 0
    assert rr_cpu <= 1e-6 and rr_gpu <= 1e-6
    assert abs(k_gpu - k_cpu) <= 2
    assert _rel(x_gpu, x_cpu) <= 1e-5


# ---- the floor probes (csrc/floor_probes.cu) --------------------------------

# vdim and node shape: 3, 7 and 15 offsets; N mod 4 = 0, 1, 2, 3; blocks
# clear of both ends of x (a block spans 512 nodes) and grids where every
# shift crosses an end
PROBE_CASES = [(1, (5000,)), (1, (4003,)), (1, (13, 10)), (2, (65, 34)),
               (2, (67, 41)), (1, (41, 13, 13)), (3, (41, 13, 13)),
               (3, (19, 9, 9)), (3, (23, 9, 9)), (3, (69, 65, 61)),
               (1, (2, 2, 2)), (3, (2, 2, 2))]


def _probe_inputs(vdim, shape, bf16, card):
    """Random weight planes on the sorted P1 stencil of the shape's
    dimension, an input, the three constant sets and the face masks."""
    dim = len(shape)
    tiny = (box_mesh(2, 2, 2, (0, 0, 0), (1, 1, 1)) if dim == 3
            else rectangle_mesh(2, 2, (0, 0), (1, 1)) if dim == 2
            else interval_mesh(2, 0.0, 1.0))
    offsets = tuple(sorted(assembly.assemble_scalar_stencil(tiny, "mass")))
    N = int(np.prod(shape))
    rng = np.random.default_rng(11)
    W = np.zeros((len(offsets) * vdim * vdim, sk.padded_length(N)),
                 np.float32)
    W[:, :N] = rng.standard_normal((W.shape[0], N))
    op = sk.FlatStencilOperator.from_packed(torch.from_numpy(W).to(card),
                                            offsets, shape, vdim)
    op = op.as_weight_dtype(torch.bfloat16 if bf16 else torch.float32)
    x = torch.from_numpy(rng.standard_normal((vdim, N)).astype(
        np.float32)).to(card)
    terms = fp.probe_constants(op.n_off * vdim * vdim)
    masks = fp.face_masks(op.N_pad, shape[-1], card)
    return op, x, terms, masks


def _counted(name):
    return sk.KERNEL_LAUNCHES.get(f"floor_{name}", 0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vdim,shape", PROBE_CASES)
def test_probes_reading_weights_match_plain(card, vdim, shape, bf16):
    """wonly, and residentw with a tile that wraps (64 nodes), with the
    reference's tile of 4,096 and with one that holds every node."""
    op, x, _, _ = _probe_inputs(vdim, shape, bf16, card)
    before = _counted("wonly"), _counted("residentw")
    y = fp.wonly(op.W)
    torch.cuda.synchronize()
    # float32 sums in the same order, but fused multiply-adds in the kernel
    assert _rel(y.cpu(), fp.wonly_plain(op.W).cpu()) <= 1e-5
    tiles = [fp.weight_tile(op.W, B) for B in (64, fp.TILE_NODES, op.N_pad)]
    for tile in tiles:
        y = fp.residentw(tile, x, op.deltas, vdim)
        torch.cuda.synchronize()
        y_plain = fp.residentw_plain(tile, x, op.deltas, vdim)
        assert _rel(y.cpu(), y_plain.cpu()) <= 1e-5, tile.shape
    # with every node in the tile the probe is the dense operator
    assert _rel(y.cpu(), op.apply_flat(x).cpu()) <= 1e-5
    assert (_counted("wonly"), _counted("residentw")) == \
        (before[0] + 1, before[1] + 3)


@pytest.mark.parametrize("vdim,shape", PROBE_CASES)
def test_constant_weight_probes_match_plain(card, vdim, shape):
    op, x, (wc, dz0, dz1), masks = _probe_inputs(vdim, shape, False, card)
    before = _counted("shifts"), _counted("csz")
    y_s = fp.shifts(x, op.deltas, vdim, wc)
    y_c = fp.csz(masks, x, op.deltas, vdim, wc, dz0, dz1)
    torch.cuda.synchronize()
    assert _rel(y_s.cpu(), fp.shifts_plain(x, op.deltas, vdim, wc).cpu()) \
        <= 1e-5
    assert _rel(y_c.cpu(), fp.csz_plain(masks, x, op.deltas, vdim, wc, dz0,
                                        dz1).cpu()) <= 1e-5
    # without face terms csz is shifts, bit for bit
    zero = np.zeros_like(wc)
    assert torch.equal(fp.csz(masks, x, op.deltas, vdim, wc, zero, zero), y_s)
    # and against float64 on the host
    xs = x.cpu().numpy().astype(np.float64)
    y64 = np.zeros_like(xs)
    for o, d in enumerate(op.deltas):
        lo, hi = max(0, -d), min(op.N, op.N - d)
        for a in range(vdim):
            for b in range(vdim):
                y64[a, lo:hi] += float(wc[(o * vdim + a) * vdim + b]) \
                    * xs[b, lo + d:hi + d]
    assert _rel(y_s.cpu(), y64) <= 1e-5
    assert (_counted("shifts"), _counted("csz")) == \
        (before[0] + 1, before[1] + 2)


def test_probe_planted_faults_show(card):
    """One changed input of each probe moves it > 1e-4 (relative) off the
    plain version of the unchanged inputs."""
    op, x, (wc, dz0, dz1), masks = _probe_inputs(3, (41, 13, 13), False, card)
    n = op.N - 2                                   # in the last, partial group
    W_bad = op.W.clone()
    W_bad[7, n] += 10.0
    assert _rel(fp.wonly(W_bad).cpu(), fp.wonly_plain(op.W).cpu()) > 1e-4
    tile = fp.weight_tile(op.W, 64)
    tile_bad = tile.clone()
    tile_bad[:, n % 64] = 0
    assert _rel(fp.residentw(tile_bad, x, op.deltas, 3).cpu(),
                fp.residentw_plain(tile, x, op.deltas, 3).cpu()) > 1e-4
    wc_bad = wc.copy()
    wc_bad[op.deltas.index(0) * 9] *= 1.01
    assert _rel(fp.shifts(x, op.deltas, 3, wc_bad).cpu(),
                fp.shifts_plain(x, op.deltas, 3, wc).cpu()) > 1e-4
    m_bad = masks.clone()
    m_bad[1] = 0
    assert _rel(fp.csz(m_bad, x, op.deltas, 3, wc, dz0, dz1).cpu(),
                fp.csz_plain(masks, x, op.deltas, 3, wc, dz0, dz1).cpu()) \
        > 1e-4


def test_probes_reject_what_they_do_not_take(card):
    op, x, (wc, dz0, dz1), masks = _probe_inputs(1, (41, 13, 13), False, card)
    before = dict(sk.KERNEL_LAUNCHES)
    with pytest.raises(ValueError):
        fp.shifts(x.double(), op.deltas, 1, wc)
    with pytest.raises(ValueError):
        fp.shifts(x, op.deltas[:-1], 1, wc[:-1])     # 14 offsets
    with pytest.raises(ValueError):
        fp.residentw(fp.weight_tile(op.W, 66), x, op.deltas, 1)
    with pytest.raises(ValueError):
        fp.residentw(fp.weight_tile(op.W).cpu(), x, op.deltas, 1)
    with pytest.raises(ValueError):
        fp.csz(masks[:, :-128].contiguous(), x, op.deltas, 1, wc, dz0, dz1)
    with pytest.raises(ValueError):
        fp.wonly(op.W[:, :100].contiguous())
    assert dict(sk.KERNEL_LAUNCHES) == before


# residentw where the tile's repeats do not divide N (N mod B ≠ 0), where N
# is smaller than the tile, and where the repeat ranges split unevenly;
# csz where N is smaller than one staged run (512 nodes at v2, v3; 1,024 at
# v1) or no multiple of it
RAGGED_TILES = [(3, (9, 9, 9), 4096), (1, (5, 5, 5), 64), (1, (41, 13, 13), 4096),
                (3, (41, 13, 13), 1000), (2, (67, 41), 68), (1, (5000,), 4996)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vdim,shape,B", RAGGED_TILES)
def test_residentw_ragged_repeats_match_plain(card, vdim, shape, B, bf16):
    op, x, _, _ = _probe_inputs(vdim, shape, bf16, card)
    B = min(B, op.N_pad)
    N = op.N
    assert N < B or N % B != 0
    tile = fp.weight_tile(op.W, B)
    y = fp.residentw(tile, x, op.deltas, vdim)
    torch.cuda.synchronize()
    assert _rel(y.cpu(), fp.residentw_plain(tile, x, op.deltas, vdim).cpu()) \
        <= 1e-5


@pytest.mark.parametrize("vdim,shape", [(1, (5, 5, 5)), (3, (9, 9, 9)),
                                        (3, (41, 13, 13)), (1, (65, 65, 63)),
                                        (2, (67, 41)), (1, (1023,))])
def test_csz_ragged_runs_match_plain(card, vdim, shape):
    op, x, (wc, dz0, dz1), masks = _probe_inputs(vdim, shape, False, card)
    assert op.N < fp.csz_run(vdim) or op.N % fp.csz_run(vdim) != 0
    y = fp.csz(masks, x, op.deltas, vdim, wc, dz0, dz1)
    torch.cuda.synchronize()
    assert _rel(y.cpu(), fp.csz_plain(masks, x, op.deltas, vdim, wc, dz0,
                                      dz1).cpu()) <= 1e-5
    zero = np.zeros_like(wc)
    assert torch.equal(fp.csz(masks, x, op.deltas, vdim, wc, zero, zero),
                       fp.shifts(x, op.deltas, vdim, wc))


# shifts at v2 and v3 given a plan directly: one block walking every plane
# of its column (the ring's phases flip many times), three blocks, and a
# card that holds more blocks than there are runs; ragged N, runs across
# both ends of x, planes (3D) and rows (2D) shorter and longer than a run
SHIFTS_RINGS = [(3, (5000,)), (2, (4003,)), (2, (67, 41)), (2, (7, 1100)),
                (2, (41, 13, 13)), (3, (41, 13, 13)), (3, (23, 9, 9)),
                (3, (69, 65, 61)), (2, (73, 65, 61)), (2, (2, 2, 2)),
                (3, (2, 2, 2))]


def _shifts_direct(x, deltas, vdim, wc, plan):
    """floor_shifts with the plan array given: (return code, y), y NaN
    where the kernel wrote nothing."""
    y = torch.full_like(x, float("nan"))
    d = np.ascontiguousarray(deltas, np.int32)
    w = np.ascontiguousarray(wc, np.float32)
    a = np.ascontiguousarray(plan, np.int32)
    rc = fp.build_library().floor_shifts(
        vdim, x.data_ptr(), y.data_ptr(), x.shape[1], d.ctypes.data, len(d),
        w.ctypes.data, a.ctypes.data, len(a),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return rc, y


@pytest.mark.parametrize("sms,per_sm", [(1, 1), (3, 1), (1000, 1000)])
@pytest.mark.parametrize("vdim,shape", SHIFTS_RINGS)
def test_shifts_rings_and_small_grids_match_plain(card, vdim, shape, sms,
                                                  per_sm):
    op, x, (wc, _, _), masks = _probe_inputs(vdim, shape, False, card)
    plan = fp.shifts_plan(op.N, tuple(op.deltas), vdim, sms, per_sm)
    assert plan.blocks <= max(sms * per_sm, plan.columns)
    rc, y = _shifts_direct(x, op.deltas, vdim, wc, plan.c_array)
    assert rc == 0
    assert _rel(y.cpu(), fp.shifts_plain(x, op.deltas, vdim, wc).cpu()) \
        <= 1e-5
    zero = np.zeros_like(wc)
    assert torch.equal(fp.csz(masks, x, op.deltas, vdim, wc, zero, zero), y)


def test_shifts_refuses_a_plan_it_was_not_given_for(card):
    """A plan the C function's own arithmetic contradicts returns
    cudaErrorInvalidValue and launches nothing; the plan itself, and the
    deepest ring the kernel keeps, run."""
    vdim = 3
    op, x, (wc, _, _), _ = _probe_inputs(vdim, (69, 65, 61), False, card)
    plan = fp.shifts_plan(op.N, tuple(op.deltas), vdim, 132, 2)
    good = plan.c_array
    y_plain = fp.shifts_plain(x, op.deltas, vdim, wc).cpu()
    rc, y = _shifts_direct(x, op.deltas, vdim, wc, good)
    assert rc == 0 and _rel(y.cpu(), y_plain) <= 1e-5
    window = 4 * vdim * plan.row_floats
    g0 = 14 + fp.MAX_GROUPS                         # group 0's offset
    bad = {"threads": (0, 64), "nodes a thread": (1, 8), "run": (2, 1024),
           "a stride below the run": (3, plan.run - 1),
           "columns": (4, plan.columns + 1), "planes": (5, plan.planes - 1),
           "no ranges": (6, 0), "more ranges than planes": (6, plan.planes + 1),
           "blocks": (7, plan.blocks + 1), "m_lo": (8, -2), "m_hi": (9, 2),
           "fewer windows than a run reads": (10, 2),
           "too many windows": (10, fp.MAX_STAGES + 1),
           "win_lo": (11, plan.win_lo + 1),
           "row floats not whole chunks": (12, plan.row_floats + 2),
           "shared bytes": (13, plan.smem_bytes + 16),
           "a group's plane": (14, 1),
           "a group's offset": (g0, plan.group_off[0] + 1)}
    for what, (i, v) in bad.items():
        a = good.copy()
        a[i] = v
        rc, y = _shifts_direct(x, op.deltas, vdim, wc, a)
        assert rc == 1, what                     # cudaErrorInvalidValue
        assert torch.isnan(y).all(), what
    # a window one chunk short of its groups' reads, the shared bytes made
    # to match it
    a = good.copy()
    a[12] -= 4
    a[13] -= 4 * plan.stages * vdim
    assert _shifts_direct(x, op.deltas, vdim, wc, a)[0] == 1
    # the deepest ring runs; a wrong plan length does not
    a = good.copy()
    a[10] = fp.MAX_STAGES
    a[13] = fp.MAX_STAGES * window
    rc, y = _shifts_direct(x, op.deltas, vdim, wc, a)
    assert rc == 0 and _rel(y.cpu(), y_plain) <= 1e-5
    assert _shifts_direct(x, op.deltas, vdim, wc, good[:-1])[0] == 1
    # v1 reads x through L1 and takes no plan: with one it is refused
    op1, x1, (wc1, _, _), _ = _probe_inputs(1, (41, 13, 13), False, card)
    rc, y = _shifts_direct(x1, op1.deltas, 1, wc1, np.zeros(0, np.int32))
    assert rc == 0 and _rel(y.cpu(), fp.shifts_plain(
        x1, op1.deltas, 1, wc1).cpu()) <= 1e-5
    assert _shifts_direct(x1, op1.deltas, 1, wc1, good)[0] == 1
    assert _shifts_direct(x, op.deltas, vdim, wc,
                          np.zeros(0, np.int32))[0] == 1
