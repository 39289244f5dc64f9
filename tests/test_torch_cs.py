"""Constant-interior (CS) operator of the port against the JAX package.

The host analysis is numpy float64 on both sides, so the build artifacts
(scalar sets, classes, window list, residual weights) must agree bit for
bit.  On the CPU the port applies through its plain torch version
(``cs_apply_plain``); the JAX operator runs its Pallas kernels K3/K4 in
interpret mode.  The fused CUDA kernel's host tables are decoded here with
numpy and must reproduce the plain version bit for bit; the kernel itself
is checked against ``cs_apply_plain`` on the card by
``test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu.ops import assembly
from pde_solver_tpu.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu.ops.linsolve import np_stencil_apply, prepare_system
from pde_solver_tpu.ops.pallas_kernels import CSFlatStencilOperator as RefCS
from pde_solver_tpu.ops.timestepping import _combine
from pde_solver_tpu_torch import convert
from pde_solver_tpu_torch.mesh import box_mesh as port_box
from pde_solver_tpu_torch.ops import cs_kernels as ck
from pde_solver_tpu_torch.ops import linsolve as port_ls
from pde_solver_tpu_torch.ops import multigrid as port_mg
from pde_solver_tpu_torch.ops import stencil_kernels as sk


def _system(vdim, cells=(100, 6, 6)):
    """The reference's ``_build_cs_case`` system: a long bar whose x-slab
    windows leave a clean constant interior."""
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.5, 0.5))
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 1.0)],
                                    mesh.node_shape)
        rhs = assembly.assemble_load(mesh)
    else:
        K = assembly.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=3)
        rhs = assembly.assemble_vector_load(mesh, np.array([0.0, 1.0, -2.0]))
    return mesh, prepare_system(K, mesh, bc, rhs, vdim)


def _heat_be_system(mesh, dt=0.01):
    """Scaled backward-Euler heat operator M + Δt·K, all-boundary Dirichlet."""
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    return prepare_system(_combine(K, M, dt, 1.0), mesh, bc,
                          np.zeros(mesh.node_shape), 1)


def _both(sysm, mesh, vdim, block=4096, **kw):
    ref = RefCS.try_build(sysm.offsets, sysm.weights, mesh.node_shape,
                          vdim=vdim, block=block, interpret=True, **kw)
    port = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim, block=block,
        device="cpu", **kw)
    return ref, port


def _x(sysm, seed=0):
    return np.random.default_rng(seed).standard_normal(
        sysm.b_hat.shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("vdim", [1, 3])
def test_build_artifacts_match_reference(vdim, block):
    mesh, sysm = _system(vdim)
    ref, port = _both(sysm, mesh, vdim, block)
    assert ref is not None and port is not None
    assert port.sets == ref.sets
    assert list(port.windows) == [int(o) for o in np.asarray(ref.win_octs)]
    nw = port.n_off * vdim * vdim
    # the reference's octet rows are this port's 1024-node windows
    assert np.array_equal(port.Wwin.numpy(),
                          np.asarray(ref.Wwin).reshape(nw, -1))
    N = port.N
    ref_planes = np.asarray(ref.masks).reshape(len(ref.sets), -1)
    assert np.array_equal(port.masks().numpy(), ref_planes[:-1, :N])
    assert 0 < port.n_win * ck.WINDOW < port.N   # a strict subset


def test_apply_matches_reference_interpret():
    mesh, sysm = _system(1)
    ref, port = _both(sysm, mesh, 1, block=512)
    x = _x(sysm)
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    y = port.apply(torch.from_numpy(x)).numpy()
    assert np.abs(y - y_ref).max() <= 2e-6 * np.abs(y_ref).max()
    assert port.launches == 0   # the CPU path launches no kernel


@pytest.mark.parametrize("vdim", [1, 3])
def test_apply_matches_dense_and_f64(vdim):
    mesh, sysm = _system(vdim)
    port = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim, device="cpu")
    dense = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                   mesh.node_shape, vdim=vdim, device="cpu")
    xt = torch.from_numpy(_x(sysm, 1))
    xf = port.to_flat(xt)
    y = ck.cs_apply_plain(port, xf)
    y_dense = sk.spmv_plain(dense.W, xf, dense.deltas, vdim)
    assert (y - y_dense).abs().max() <= 2e-6 * y_dense.abs().max()
    y64 = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                           xt.numpy().astype(np.float64), mesh.dim, vdim)
    assert _rel(port.from_flat(y), y64) <= 1e-5


@pytest.mark.parametrize("vdim", [1, 3])
def test_operator_from_reference_artifacts_is_bit_equal(vdim):
    mesh, sysm = _system(vdim)
    ref, port = _both(sysm, mesh, vdim)
    conv = convert.cs_operator_from_reference(
        ref.sets, np.asarray(ref.win_octs), np.asarray(ref.Wwin),
        np.asarray(ref.masks), sysm.offsets, mesh.node_shape, vdim,
        device="cpu")
    assert conv.descs == port.descs
    x = torch.from_numpy(_x(sysm, 2))
    assert torch.equal(conv.apply(x), port.apply(x))


def test_kernel_class_test_selects_exactly_the_mask_planes():
    """What the kernel computes per node (the minor-axis codes, taken with
    its magic divisors, looked up in the code-pair mask table) selects
    exactly the nodes of the plain version's mask planes, and only nodes
    the near-boundary threads write."""
    mesh = box_mesh(12, 7, 9, (0, 0, 0), (1, 1, 1))
    sysm = _heat_be_system(mesh)
    op = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=1, device="cpu")
    assert op is not None and len(op.descs) > 0
    i1, i2 = _minor_coords(op, np.arange(op.N))
    n1, n2 = op.node_shape[-2:]
    codes = ck.minor_code(i1, n1) * ck.CODES + ck.minor_code(i2, n2)
    bits = op.set_masks[codes]
    near = np.zeros(op.N, bool)
    near[_near_nodes(op.node_shape)] = True
    for s, plane in enumerate(op.masks().numpy()):
        member = (bits >> s) & 1 == 1
        assert np.array_equal(member, plane.astype(bool))
        assert not np.any(member & ~near)


def _near_nodes(node_shape) -> np.ndarray:
    """The nodes with a boundary code on either minor axis, in the order of
    the kernel's near-boundary threads: per slice of the major axes, the
    four boundary rows of the first minor axis whole, then the two first and
    two last nodes of every other row."""
    n1, n2 = int(node_shape[-2]), int(node_shape[-1])
    slices = int(np.prod(node_shape[:-2], dtype=np.int64))
    rows = np.array([0, 1, n1 - 2, n1 - 1])
    ends = np.array([0, 1, n2 - 2, n2 - 1])
    per_slice = np.concatenate([
        (rows[:, None] * n2 + np.arange(n2)[None, :]).reshape(-1),
        (np.arange(2, n1 - 2)[:, None] * n2 + ends[None, :]).reshape(-1)])
    return (np.arange(slices)[:, None] * (n1 * n2)
            + per_slice[None, :]).reshape(-1)


def _fdiv(n, d):
    """floor(n / d) as the kernel takes it: umulhi(n, m) >> s."""
    m, s = ck.fast_divisor(d)
    return ((np.asarray(n, np.uint64) * np.uint64(m)) >> np.uint64(32 + s)
            ).astype(np.int64)


def _minor_coords(op, n):
    n1, n2 = op.node_shape[-2:]
    q = _fdiv(n, n2)
    return q - _fdiv(q, n1) * n1, n - q * n2


def _near_thread_nodes(op):
    """The node of every near-boundary thread, as the kernel maps it."""
    n1, n2 = op.node_shape[-2:]
    per_slice = 4 * n2 + 4 * (n1 - 4)
    t = np.arange(op.N // (n1 * n2) * per_slice)
    i0 = _fdiv(t, per_slice)
    r = t - i0 * per_slice
    j = _fdiv(np.minimum(r, 4 * n2 - 1), n2)
    r2 = r - 4 * n2
    e = r2 & 3
    rows = r < 4 * n2
    i1 = np.where(rows, np.where(j < 2, j, n1 - 4 + j), 2 + (r2 >> 2))
    i2 = np.where(rows, r - j * n2, np.where(e < 2, e, n2 - 4 + e))
    return (i0 * n1 + i1) * n2 + i2


def _decode_apply(op, x, windows=True):
    """The kernel's function read from its host tables alone (the term
    lists, the code-pair mask table, the slot map, the magic divisors) in
    numpy float32, in the kernel's order: set 0's terms, the class sets of
    each node's mask, then its window's residual terms per output component
    over (o, b)."""
    v, N = op.vdim, op.N
    xn = x.numpy()
    n = np.arange(N)
    xs = []
    for d in op.deltas:
        m = n + d
        inside = (m >= 0) & (m < N)
        xs.append(np.where(inside, xn[:, np.clip(m, 0, N - 1)],
                           np.float32(0)))

    def set_sum(terms):
        acc = np.zeros((v, N), np.float32)
        for o in range(op.n_off):
            for b in range(v):
                for a in range(v):
                    acc[a] = acc[a] + terms[(o * v + b) * v + a] * xs[o][b]
        return acc

    i1, i2 = _minor_coords(op, n)
    n1, n2 = op.node_shape[-2:]
    bits = op.set_masks[ck.minor_code(i1, n1) * ck.CODES
                        + ck.minor_code(i2, n2)]
    y = set_sum(op.terms[0])
    for s in range(len(op.descs)):
        member = (bits >> s) & 1 == 1
        y[:, member] = y[:, member] + set_sum(op.terms[1 + s])[:, member]
    if windows:
        slot = op.slots.numpy()[n >> 10]
        win = slot >= 0
        t = slot[win].astype(np.int64) * ck.WINDOW + (n[win] & (ck.WINDOW - 1))
        R = op.Wwin.numpy()
        for o in range(op.n_off):
            for b in range(v):
                for a in range(v):
                    y[a, win] = (y[a, win]
                                 + R[(o * v + a) * v + b, t] * xs[o][b][win])
    return y


@pytest.mark.parametrize("vdim,cells", [(1, (40, 6, 6)), (3, (60, 8, 8))])
def test_kernel_tables_reproduce_the_plain_apply_bit_for_bit(vdim, cells):
    """The fused kernel's host tables, decoded with numpy, give
    ``cs_apply_plain`` (with the slot map) and ``cs_main_plain`` (without)
    exactly; every node is written once, by the node mapping (inner nodes)
    or by a near-boundary thread.  N is not a multiple of 1024 and the
    grid's last, partial window is listed."""
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.25, 0.25))
    sysm = (_heat_be_system(mesh) if vdim == 1 else _system(3, cells)[1])
    op = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim, device="cpu")
    assert op is not None and op.N % ck.WINDOW != 0
    assert op.windows[-1] == (op.N - 1) // ck.WINDOW
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (vdim, op.N)).astype(np.float32))
    assert np.array_equal(_decode_apply(op, x), ck.cs_apply_plain(op, x))
    assert np.array_equal(_decode_apply(op, x, windows=False),
                          ck.cs_main_plain(op, x))
    near = _near_thread_nodes(op)
    assert np.array_equal(near, _near_nodes(op.node_shape))
    i1, i2 = _minor_coords(op, np.arange(op.N))
    n1, n2 = op.node_shape[-2:]
    inner = (i1 >= 2) & (i1 < n1 - 2) & (i2 >= 2) & (i2 < n2 - 2)
    written = np.bincount(near, minlength=op.N) + inner
    assert np.array_equal(written, np.ones(op.N))
    assert op.set_masks[ck.INNER * ck.CODES + ck.INNER] == 0
    assert np.array_equal(
        op.terms, np.asarray(op.sets, np.float32).reshape(
            -1, op.n_off, vdim, vdim).transpose(0, 1, 3, 2).reshape(
                len(op.sets), -1))


def test_fast_divisor_gives_the_exact_quotient():
    rng = np.random.default_rng(12)
    n = np.concatenate([np.arange(1 << 16), rng.integers(0, 1 << 31, 1 << 16),
                        [(1 << 31) - 1]])
    for d in (2, 3, 5, 7, 9, 41, 65, 129, 504, 1016, 1 << 10, 4097, 65537,
              (1 << 30) + 3):
        m, s = ck.fast_divisor(d)
        assert 0 < m < 1 << 32 and 0 <= s < 32
        assert np.array_equal(_fdiv(n, d), n // d)


def test_heat_operator_sets_and_windows_match_reference():
    """The slice's operator (scaled M + Δt·K, all-boundary Dirichlet) at a
    small cube: same sets, windows and effective sweep count."""
    mesh = box_mesh(16, 16, 16, (0, 0, 0), (1, 1, 1))
    sysm = _heat_be_system(mesh)
    ref, port = _both(sysm, mesh, 1)
    assert ref is not None and port is not None
    assert port.sets == ref.sets and len(port.sets) == 23
    assert list(port.windows) == [int(o) for o in np.asarray(ref.win_octs)]
    assert port.eff_sweeps <= ck.CSFlatStencilOperator.MAX_EFF_SWEEPS


# accepted: the first three; refused: a minor axis under 5 nodes, a 2-D
# grid whose windows cover most of it, windows over half of a 3-D grid
@pytest.mark.parametrize("cells", [(4, 4, 4), (12, 6, 6), (40, 6, 6),
                                   (10, 3, 6), (30, 20), (8, 16, 16)])
def test_refusals_match_reference(cells):
    mesh = (box_mesh(*cells, (0, 0, 0), (1, 1, 1)) if len(cells) == 3
            else rectangle_mesh(*cells, (0, 0), (1, 1)))
    sysm = _heat_be_system(mesh)
    ref, port = _both(sysm, mesh, 1)
    assert (ref is None) == (port is None)
    if port is not None:
        assert list(port.windows) == [int(o)
                                      for o in np.asarray(ref.win_octs)]


def test_refuses_varying_coefficients():
    mesh = box_mesh(12, 6, 6, (0, 0, 0), (1.0, 0.5, 0.5))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    sysm = prepare_system(K, mesh, bc, np.zeros(mesh.node_shape), 1)
    rng = np.random.default_rng(3)
    weights = [np.asarray(W) * (1.0 + 0.01 * rng.standard_normal(W.shape))
               for W in sysm.weights]
    assert ck.CSFlatStencilOperator.try_build(
        sysm.offsets, weights, mesh.node_shape, vdim=1, device="cpu") is None
    assert RefCS.try_build(sysm.offsets, weights, mesh.node_shape, vdim=1,
                           interpret=True) is None


def test_disk_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("PDE_TPU_CACHE_DIR", str(tmp_path))
    mesh, sysm = _system(1)
    key = ("cs-test", 1)
    cs1 = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=1, device="cpu",
        cache_key=key)
    assert cs1 is not None
    # the second build hits the disk entry: garbage weights prove the host
    # scan is skipped
    garbage = [np.zeros_like(np.asarray(W)) for W in sysm.weights]
    cs2 = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, garbage, mesh.node_shape, vdim=1, device="cpu",
        cache_key=key)
    assert cs2 is not None and cs2.descs == cs1.descs
    x = torch.from_numpy(_x(sysm))
    assert torch.equal(cs1.apply(x), cs2.apply(x))
    # a recorded refusal (windows over half the grid) short-circuits, even
    # for representable weights
    small = box_mesh(8, 16, 16, (0, 0, 0), (1, 1, 1))
    s_small = _heat_be_system(small)
    rkey = ("cs-test-refused", 1)
    args = (s_small.offsets, s_small.weights, small.node_shape)
    assert ck.CSFlatStencilOperator.try_build(
        *args, vdim=1, device="cpu", cache_key=rkey) is None
    assert ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, small.node_shape, vdim=1, device="cpu",
        cache_key=rkey) is None
    assert len(list(tmp_path.glob("csop-*.npz"))) == 2


@pytest.mark.parametrize("mode", ["0", "1", "hybrid"])
def test_routing_follows_pde_tpu_cs(monkeypatch, mode):
    monkeypatch.setenv("PDE_TPU_CS", mode)
    # the 41×7×7 system lies under the CS route's size gate and the bf16
    # smoother copy's
    monkeypatch.setattr(ck, "CS_MIN_DOF", 100)
    monkeypatch.setattr(port_mg, "BF16_MIN_DOF", 100)
    mesh = port_box(40, 6, 6, (0, 0, 0), (1.0, 0.2, 0.2))
    sysm = _heat_be_system(box_mesh(40, 6, 6, (0, 0, 0), (1.0, 0.2, 0.2)))
    flat = port_ls._static_flat_op(sysm, mesh, 1, "cpu")
    lv = port_mg._to_level(sysm, mesh, 1, "cpu")
    if mode == "0":
        assert isinstance(flat, sk.FlatStencilOperator)
        assert isinstance(lv.weights, sk.FlatStencilOperator)
        assert lv.w_lo.W.dtype == torch.bfloat16
    else:
        assert isinstance(flat, ck.CSFlatStencilOperator)
        assert isinstance(lv.weights, ck.CSFlatStencilOperator)
        if mode == "1":
            assert lv.w_lo is lv.weights
        else:
            assert isinstance(lv.w_lo, sk.FlatStencilOperator)
            assert lv.w_lo.W.dtype == torch.bfloat16


def test_wrapper_rejects_a_mismatched_device_and_launches_nothing_on_cpu():
    mesh, sysm = _system(1)
    op = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=1, device="cpu")
    sk.reset_launch_counts()
    op.apply_flat(torch.zeros((1, op.N)))
    assert op.launches == 0 and not sk.KERNEL_LAUNCHES
    with pytest.raises(ValueError):
        op.launch(torch.zeros((1, op.N), dtype=torch.float64))
    with pytest.raises(ValueError):
        op.launch(torch.zeros((1, op.N + 1)), windows=False)
    assert op.launches == 0 and not sk.KERNEL_LAUNCHES
