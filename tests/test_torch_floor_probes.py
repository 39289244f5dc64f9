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
from pde_solver_tpu.mesh import box_mesh as ref_box
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
