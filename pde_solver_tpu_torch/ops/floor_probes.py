"""Floor probes of the flat-stencil SpMV: what each part of it costs alone.

Counterpart of ``benchmarks/kernel_floor.py`` of the JAX package.  The
dense kernel (``ops.stencil_kernels``) streams ``n_off·v²`` weight planes
and reads x shifted by every offset.  Four probes each do one part of that
work and leave the rest out:

* :func:`wonly` — ``y[n] = Σ_k W[k, n]``: the weight stream alone, no x.
  Its time is the rate at which the card really streams the planes.
* :func:`shifts` — the shifted reads and FMAs with one constant weight per
  (offset, a, b), no weight stream: what a constant-coefficient stencil
  pass costs.
* :func:`residentw` — the dense kernel's sum with node n reading the
  weights of node ``n mod B`` of one tile of ``B = TILE_NODES`` nodes, so
  per-node weights that never leave the cache.  Wrong as an operator by
  design: only its time means anything.
* :func:`csz` — ``shifts`` with two more constant sets switched on by two
  streamed mask planes (the faces ``n mod nz = 0`` and ``n mod nz = nz−1``
  of the last grid axis): the inner loop of a constant-interior operator
  with face corrections and no window pass.

Each wrapper launches its kernel of ``csrc/floor_probes.cu`` on a CUDA
tensor (or raises) and counts the launch in
``stencil_kernels.KERNEL_LAUNCHES`` under ``floor_<name>``; for a CPU
tensor it takes the plain PyTorch version beside it (``*_plain``), which is
what the CPU tests hold against the JAX package's kernels.
:func:`kernel_floor` is the entry point that runs them all on the
flagship's operator and reports their times beside the dense kernel's.

Layouts are the dense kernel's: W ``[n_off·v², N_pad]`` (f32 or bf16,
``N_pad`` = N rounded up to 128), x and y ``[v, N]`` f32, offsets as flat
deltas in the sorted P1 stencil's order.
"""

from __future__ import annotations

import ctypes
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.ops import cuda_build
from pde_solver_tpu_torch.ops.stencil_kernels import (check_row_groups,
                                                      count_launch,
                                                      padded_length)

# Nodes of residentw's weight tile: the block of the reference's probe.
TILE_NODES = 4096

# What csrc/floor_probes.cu is built for, read from its #define lines.
PROBE_VDIMS = cuda_build.defined_list("floor_probes", "FLOOR_PROBE_VDIMS")
PROBE_NOFFS = cuda_build.defined_list("floor_probes", "FLOOR_PROBE_NOFFS")

_LIB: Optional[ctypes.CDLL] = None


def build_library() -> ctypes.CDLL:
    """Compile (if the source hash is new) and load the probes' library."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("floor_probes")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.floor_wonly.argtypes = [p, i, i, ll, p, p]
        lib.floor_shifts.argtypes = [i, p, p, ll, p, i, p, p]
        lib.floor_residentw.argtypes = [p, i, ll, i, p, p, ll, p, i, p]
        lib.floor_csz.argtypes = [p, ll, i, p, p, ll, p, i, p, p, p, p]
        for fn in (lib.floor_wonly, lib.floor_shifts, lib.floor_residentw,
                   lib.floor_csz):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def probe_constants(n_terms: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(wc, dz0, dz1), each ``[n_terms]`` float32: the interior weights and
    the two face corrections, three draws of
    ``default_rng(0).standard_normal(n_terms) * 0.05`` in this order, as
    the reference draws them."""
    rng = np.random.default_rng(0)
    return tuple((rng.standard_normal(n_terms) * 0.05).astype(np.float32)
                 for _ in range(3))


def face_masks(N_pad: int, nz: int, device) -> torch.Tensor:
    """``[2, N_pad]`` f32: 1 where ``n mod nz`` is 0, and where it is
    ``nz − 1`` (the two faces of the last grid axis, tail included, as the
    reference builds them)."""
    flat = torch.arange(N_pad, device=device) % nz
    return torch.stack([flat == 0, flat == nz - 1]).to(torch.float32)


def weight_tile(W: torch.Tensor, B: int = TILE_NODES) -> torch.Tensor:
    """The first ``B`` nodes of every plane of W, contiguous: residentw's
    tile (all of W where it holds fewer nodes)."""
    return W[:, :B].contiguous()


# ----------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------

def wonly_plain(W: torch.Tensor) -> torch.Tensor:
    """y[n] = Σ_k W[k, n] in float32, planes added in order."""
    acc = W[0].float()
    for k in range(1, W.shape[0]):
        acc = acc + W[k].float()
    return acc


def _shifted(x: torch.Tensor, deltas: Sequence[int]):
    """x [v, N] read at n + δ for every δ, zero outside [0, N)."""
    N = x.shape[1]
    P = max(abs(int(d)) for d in deltas)
    xp = torch.nn.functional.pad(x, (P, P))
    return [xp[:, P + d:P + d + N] for d in deltas]


def _constant_pass(x, deltas, vdim: int, terms) -> torch.Tensor:
    """Σ_o Σ_b terms[(o·v + a)·v + b] · x[b, n + δ_o], in (o, b, a) order."""
    y = [None] * vdim
    for o, xs in enumerate(_shifted(x, deltas)):
        for b in range(vdim):
            for a in range(vdim):
                t = float(terms[(o * vdim + a) * vdim + b]) * xs[b]
                y[a] = t if y[a] is None else y[a] + t
    return torch.stack(y)


def shifts_plain(x: torch.Tensor, deltas: Sequence[int], vdim: int,
                 wc) -> torch.Tensor:
    return _constant_pass(x, deltas, vdim, np.asarray(wc, np.float32))


def residentw_plain(Wt: torch.Tensor, x: torch.Tensor,
                    deltas: Sequence[int], vdim: int) -> torch.Tensor:
    """The dense sum with node n taking the weights of node n mod B of the
    tile ``Wt`` [n_off·v², B]."""
    N = x.shape[1]
    idx = torch.arange(N, device=x.device) % Wt.shape[1]
    y = [None] * vdim
    for o, xs in enumerate(_shifted(x, deltas)):
        for b in range(vdim):
            for a in range(vdim):
                t = Wt[(o * vdim + a) * vdim + b].float()[idx] * xs[b]
                y[a] = t if y[a] is None else y[a] + t
    return torch.stack(y)


def csz_plain(m: torch.Tensor, x: torch.Tensor, deltas: Sequence[int],
              vdim: int, wc, dz0, dz1) -> torch.Tensor:
    """Three constant passes joined by the masks: acc + m0·az0 + m1·az1."""
    N = x.shape[1]
    acc, az0, az1 = (_constant_pass(x, deltas, vdim,
                                    np.asarray(t, np.float32))
                     for t in (wc, dz0, dz1))
    return acc + m[0, :N] * az0 + m[1, :N] * az1


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _check_x(x: torch.Tensor, deltas: Sequence[int], vdim: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != vdim \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 [{vdim}, N], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.is_cuda:
        if vdim not in PROBE_VDIMS or len(deltas) not in PROBE_NOFFS:
            raise ValueError(f"floor_probes is built for vdim in "
                             f"{PROBE_VDIMS} and offset counts in "
                             f"{PROBE_NOFFS}, not {vdim} and {len(deltas)}")
        check_row_groups(deltas)


def _check_terms(n_off: int, vdim: int, *terms) -> None:
    for t in terms:
        if len(t) != n_off * vdim * vdim:
            raise ValueError(f"{len(t)} constants for {n_off} offsets × "
                             f"v²={vdim * vdim}")


def _check_weights(W: torch.Tensor, what: str) -> None:
    if W.dtype not in (torch.float32, torch.bfloat16) or W.dim() != 2 \
            or not W.is_contiguous() or (W.is_cuda and W.data_ptr() % 16):
        raise ValueError(f"{what} must be contiguous, 16-byte aligned "
                         f"f32/bf16 [planes, nodes], got {W.dtype} "
                         f"{tuple(W.shape)}")


def _same_device(x: torch.Tensor, other: torch.Tensor) -> None:
    if other.device != x.device:
        raise ValueError(f"x on {x.device}, operand on {other.device}")


def _c_array(values, dtype) -> np.ndarray:
    """A contiguous host array the C function reads during the call; its
    ``.ctypes.data`` is the pointer, and the caller keeps the array alive
    until the call returns (the launch copies what it needs)."""
    return np.ascontiguousarray(values, dtype=dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(rc: int, name: str, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"floor_{name} launch failed: CUDA error {rc} "
                           f"({what})")
    count_launch(f"floor_{name}")


def wonly(W: torch.Tensor) -> torch.Tensor:
    """W [planes, N_pad] f32 or bf16 → y [N_pad] f32."""
    _check_weights(W, "W")
    if not W.is_cuda:
        return wonly_plain(W)
    if W.shape[1] % 128:
        raise ValueError(f"W's plane length {W.shape[1]} is not a multiple "
                         f"of 128")
    y = torch.empty(W.shape[1], dtype=torch.float32, device=W.device)
    rc = build_library().floor_wonly(
        W.data_ptr(), int(W.dtype == torch.bfloat16), W.shape[0], W.shape[1],
        y.data_ptr(), _stream(W))
    _launched(rc, "wonly", f"{W.dtype} {tuple(W.shape)}")
    return y


def shifts(x: torch.Tensor, deltas: Sequence[int], vdim: int,
           wc) -> torch.Tensor:
    """x [v, N] f32 → y [v, N] f32 with the constants ``wc`` [n_off·v²]."""
    _check_x(x, deltas, vdim)
    _check_terms(len(deltas), vdim, wc)
    if not x.is_cuda:
        return shifts_plain(x, deltas, vdim, wc)
    y = torch.empty_like(x)
    d, w = _c_array(deltas, np.int32), _c_array(wc, np.float32)
    rc = build_library().floor_shifts(
        vdim, x.data_ptr(), y.data_ptr(), x.shape[1], d.ctypes.data,
        len(deltas), w.ctypes.data, _stream(x))
    _launched(rc, "shifts", f"vdim={vdim}, N={x.shape[1]}")
    return y


def residentw(Wt: torch.Tensor, x: torch.Tensor, deltas: Sequence[int],
              vdim: int) -> torch.Tensor:
    """Tile Wt [n_off·v², B] f32 or bf16, x [v, N] f32 → y [v, N] f32."""
    _check_x(x, deltas, vdim)
    _check_weights(Wt, "the weight tile")
    _same_device(x, Wt)
    if Wt.shape[0] != len(deltas) * vdim * vdim:
        raise ValueError(f"the tile has {Wt.shape[0]} planes for "
                         f"{len(deltas)} offsets × v²={vdim * vdim}")
    if not x.is_cuda:
        return residentw_plain(Wt, x, deltas, vdim)
    if Wt.shape[1] % 4:
        raise ValueError(f"the tile's {Wt.shape[1]} nodes are not a "
                         f"multiple of 4")
    y = torch.empty_like(x)
    d = _c_array(deltas, np.int32)
    rc = build_library().floor_residentw(
        Wt.data_ptr(), int(Wt.dtype == torch.bfloat16), Wt.shape[1], vdim,
        x.data_ptr(), y.data_ptr(), x.shape[1], d.ctypes.data, len(deltas),
        _stream(x))
    _launched(rc, "residentw", f"vdim={vdim}, N={x.shape[1]}, {Wt.dtype} "
              f"tile of {Wt.shape[1]}")
    return y


def csz(m: torch.Tensor, x: torch.Tensor, deltas: Sequence[int], vdim: int,
        wc, dz0, dz1) -> torch.Tensor:
    """Masks m [2, N_pad] f32, x [v, N] f32 → y [v, N] f32."""
    _check_x(x, deltas, vdim)
    _check_terms(len(deltas), vdim, wc, dz0, dz1)
    _same_device(x, m)
    N = x.shape[1]
    if m.dtype != torch.float32 or m.dim() != 2 or m.shape[0] != 2 \
            or m.shape[1] != padded_length(N) or not m.is_contiguous():
        raise ValueError(f"masks must be contiguous float32 "
                         f"[2, {padded_length(N)}], got {m.dtype} "
                         f"{tuple(m.shape)}")
    if not x.is_cuda:
        return csz_plain(m, x, deltas, vdim, wc, dz0, dz1)
    y = torch.empty_like(x)
    d = _c_array(deltas, np.int32)
    t = [_c_array(c, np.float32) for c in (wc, dz0, dz1)]
    rc = build_library().floor_csz(
        m.data_ptr(), m.shape[1], vdim, x.data_ptr(), y.data_ptr(), N,
        d.ctypes.data, len(deltas), t[0].ctypes.data, t[1].ctypes.data,
        t[2].ctypes.data, _stream(x))
    _launched(rc, "csz", f"vdim={vdim}, N={N}")
    return y


# ----------------------------------------------------------------------
# The entry point
# ----------------------------------------------------------------------

def _ms_per_call(fn, reps: int, device: torch.device) -> float:
    """Milliseconds a call: CUDA events on the card, the host's clock on
    the CPU (two warm-up calls first)."""
    fn()
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def kernel_floor(cells: Tuple[int, int, int] = (160, 64, 64),
                 reps: int = 50) -> Dict[str, object]:
    """The floor decomposition of the dense kernel on the scaled 3D
    elasticity operator of a 1 m × 0.2 m × 0.2 m cantilever clamped at
    x = 0 (the flagship's at the default cells), on the configured device:
    ms a call of the dense kernel and of every probe, f32 and bf16 weights
    where a probe reads weights.

    Returns ``{"device", "clock", "nodes", "n_off", "w_bytes", "ms": {...}}``
    with ``clock`` "cuda events" on a card and "host" on the CPU, where the
    plain versions run and the times say nothing about a card."""
    from pde_solver_tpu_torch.config import get_config
    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.models.elasticity import lame_parameters
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC
    from pde_solver_tpu_torch.ops.linsolve import prepare_system
    from pde_solver_tpu_torch.ops.stencil_kernels import FlatStencilOperator
    from pde_solver_tpu_torch.utils.observability import get_logger

    device = torch.device(get_config().device)
    log = get_logger().info
    mesh = box_mesh(*cells, (0.0, 0.0, 0.0), (1.0, 0.2, 0.2))
    lam, mu = lame_parameters(210e9, 0.3, "3d")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    sysm = prepare_system(K, mesh, bc, b, 3)
    op = FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                             vdim=3, device=device)
    op16 = op.as_weight_dtype(torch.bfloat16)
    log("[floor] %d nodes, %d offsets", op.N, op.n_off)

    x = op.to_flat(torch.as_tensor(sysm.b_hat, dtype=torch.float32,
                                   device=device))
    x = x / x.abs().max().clamp(min=1e-30)
    wc, dz0, dz1 = probe_constants(op.n_off * 9)
    masks = face_masks(op.N_pad, mesh.node_shape[-1], device)
    ms = {}
    for name, o in (("f32", op), ("bf16", op16)):
        tile = weight_tile(o.W)
        ms[f"full_{name}"] = _ms_per_call(lambda: o.apply_flat(x), reps,
                                          device)
        ms[f"wonly_{name}"] = _ms_per_call(lambda: wonly(o.W), reps, device)
        ms[f"residentw_{name}"] = _ms_per_call(
            lambda: residentw(tile, x, o.deltas, 3), reps, device)
    ms["shifts"] = _ms_per_call(lambda: shifts(x, op.deltas, 3, wc), reps,
                                device)
    ms["csz"] = _ms_per_call(
        lambda: csz(masks, x, op.deltas, 3, wc, dz0, dz1), reps, device)
    w_bytes = op.W.numel() * 4
    clock = "cuda events" if device.type == "cuda" else "host"
    for name, t in ms.items():
        log("[floor] %s: %.4f ms (%s)", name, t, clock)
    return {"device": str(device), "clock": clock, "nodes": mesh.node_shape,
            "n_off": op.n_off, "w_bytes": w_bytes, "ms": ms}


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:5]]
    out = kernel_floor(tuple(args[:3]) if len(args) >= 3 else (160, 64, 64),
                       args[3] if len(args) > 3 else 50)
    print(out)
