"""Flat-layout stencil SpMV: the hand-written CUDA kernel and its wrapper.

Counterpart of ``pde_solver_tpu.ops.pallas_kernels.FlatStencilOperator``.
The stencil operator is applied thousands of times per solve (CG iterations
× V-cycle levels), so its memory traffic sets the solve time.

Layout: operands live in *flat* node order — assembled weights carry exact
zeros wherever a flat shift would wrap across a grid row, so a stencil
offset is one flat-index delta.  Weights are plane-major
``[n_off·v·v, N_pad]`` (float32, or bfloat16 for the MG smoother), with
``N_pad`` = N rounded up to ``PLANE_ALIGN`` and zero weights in the tail:
the reference's ``[n_off·v·v, n_rows, 128]`` packing, which keeps every
plane 16-byte aligned for the kernel's vector loads.  Vectors are
component-major ``[v, N]`` float32.

:func:`spmv_plain` is the same function in plain torch.  ``apply_flat``
takes it only for CPU tensors; a CUDA tensor launches the kernel in
``csrc/flat_stencil_spmv.cu`` or raises.  The kernel is compiled with
``nvcc`` for ``sm_90a`` at first use into ``build/`` (rebuilt when the
source changes, see ``ops.cuda_build``) and bound with ``ctypes``.
"""

from __future__ import annotations

import copy
import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.ops import cuda_build
from pde_solver_tpu_torch.utils import observability

# Below this DOF count a level would apply through plain torch shifted
# slices instead of the kernel.  0 routes every level through the kernel:
# on an H100 the kernel beat its plain version both at the 2M-DOF flagship
# level and at a 1,701-node level (PERF.md); a per-level H100 measurement
# is what may raise it.
KERNEL_MIN_DOF = 0


# A FlatStencilOperator on a CUDA device with a vdim or an offset count
# outside these is refused when it is constructed.  Read from the
# ``#define FLAT_STENCIL_*`` lines of ``flat_stencil_spmv.cu``, the one
# place they are listed.
KERNEL_VDIMS = cuda_build.defined_list("flat_stencil_spmv",
                                       "FLAT_STENCIL_VDIMS")
KERNEL_NOFFS = cuda_build.defined_list("flat_stencil_spmv",
                                       "FLAT_STENCIL_NOFFS")

# The weight planes' stride N_pad is N rounded up to this.
PLANE_ALIGN = 128

# Launches of the port's CUDA kernels in this process, by variant: this
# module's "v3_f32", "v3_bf16", "v2_f32", "v2_bf16", "v1_f32", "v1_bf16",
# and the constant-interior kernel of ``ops.cs_kernels`` ("cs_apply_v1",
# "cs_apply_v3").  Only a kernel launch counts: the CPU plain path
# never does.  A launch recorded into a CUDA graph counts each time the
# graph is replayed (``ops.device_loop``), not when it is captured.
KERNEL_LAUNCHES: Dict[str, int] = {}
observability.track("kernel_launches",
                    lambda: sum(KERNEL_LAUNCHES.values()))

# While ``ops.device_loop`` captures a graph: the list the wrappers record
# their launches into, (variant, operator), instead of counting them.
_CAPTURED: Optional[list] = None

_LIB: Optional[ctypes.CDLL] = None


def kernel_wins(n_dof: int) -> bool:
    """Whether a level of ``n_dof`` unknowns applies through the kernel."""
    return n_dof >= KERNEL_MIN_DOF


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()


def count_launch(variant: str, op=None, n: int = 1) -> None:
    """Count ``n`` launches of ``variant`` (and in ``op.launches``); during
    a graph capture record one instead, for the replays to count."""
    if _CAPTURED is not None:
        _CAPTURED.append((variant, op))
        return
    KERNEL_LAUNCHES[variant] = KERNEL_LAUNCHES.get(variant, 0) + n
    if op is not None:
        op.launches += n


def build_library() -> ctypes.CDLL:
    """Compile (if the source hash is new) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("flat_stencil_spmv")
        fn = lib.flat_stencil_spmv
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def padded_length(N: int) -> int:
    return -(-N // PLANE_ALIGN) * PLANE_ALIGN


def spmv_plain(W: torch.Tensor, x: torch.Tensor, deltas: Sequence[int],
               vdim: int) -> torch.Tensor:
    """Plain torch flat SpMV: y[a] = Σ_{o,b} W[o,a,b] ⊙ x[b] shifted by δ_o,
    zero outside [0, N).  W [n_off·v·v, N_pad] (f32 or bf16; the tail past
    N is never read), x [v, N] f32."""
    N = x.shape[1]
    n_off = len(deltas)
    P = max(abs(int(d)) for d in deltas)
    xp = torch.nn.functional.pad(x, (P, P))
    Wv = W.view(n_off, vdim, vdim, W.shape[1])[..., :N]
    y = torch.zeros((vdim, N), dtype=torch.float32, device=x.device)
    for o, d in enumerate(deltas):
        xs = xp[:, P + d:P + d + N]                   # [v(b), N]
        y += (Wv[o].float() * xs.unsqueeze(0)).sum(1)  # Σ_b over [a, b, N]
    return y


def row_groups(n_off: int) -> Tuple[Tuple[int, int], ...]:
    """(first offset, size) of each row group the kernel reads x by: the
    sorted P1 stencil of n_off = 4P + 3 offsets is P pairs, the
    (−1, 0, +1) triple along the last grid axis, then P pairs; a group's
    deltas are consecutive."""
    P = (n_off - 3) // 4
    return tuple((2 * g + (g > P), 3 if g == P else 2)
                 for g in range(2 * P + 1))


def _check_kernel_shape(vdim: int, deltas: Sequence[int], device) -> None:
    """A CUDA operator must have a vdim and an offset count the kernel is
    built for, and the row groups it reads x by: refuse any other here,
    not at the first launch."""
    if torch.device(device).type != "cuda":
        return
    if vdim not in KERNEL_VDIMS:
        raise ValueError(f"flat_stencil_spmv is built for vdim in "
                         f"{KERNEL_VDIMS}, not {vdim}")
    if len(deltas) not in KERNEL_NOFFS:
        raise ValueError(f"flat_stencil_spmv is built for offset counts in "
                         f"{KERNEL_NOFFS}, not {len(deltas)}")
    check_row_groups(deltas)


def check_row_groups(deltas: Sequence[int]) -> None:
    """Raise unless the deltas form the row groups the kernels read x by."""
    for first, size in row_groups(len(deltas)):
        if any(deltas[first + s] != deltas[first] + s for s in range(size)):
            raise ValueError(f"offsets {first}..{first + size - 1} (deltas "
                             f"{deltas[first:first + size]}) are not the "
                             f"consecutive row group of a sorted P1 stencil")


class FlatStencilOperator:
    """Stencil operator in flat layout backed by the CUDA kernel.

    Build once per (stencil, shape); apply many times.  ``apply`` takes and
    returns grid-shaped tensors; ``apply_flat`` works on the ``[v, N]``
    layout.  ``as_weight_dtype(torch.bfloat16)`` halves weight traffic
    (preconditioner-grade accuracy; products and accumulation stay f32).
    ``launches`` counts this operator's kernel launches.
    """

    def __init__(self, offsets, weights_np: Sequence[np.ndarray],
                 node_shape: Tuple[int, ...], vdim: int = 1,
                 device="cuda", weight_dtype=torch.float32):
        self._init_meta(offsets, node_shape, vdim)
        _check_kernel_shape(vdim, self.deltas, device)
        Wmat = np.zeros((self.n_off, vdim, vdim, self.N_pad), np.float32)
        for o, W in enumerate(weights_np):
            Wmat[o, ..., :self.N] = np.asarray(W, np.float32).reshape(
                self.N, vdim, vdim).transpose(1, 2, 0)
        self.W = torch.from_numpy(Wmat.reshape(-1, self.N_pad)).to(
            device=device, dtype=weight_dtype)

    @classmethod
    def from_packed(cls, W: torch.Tensor, offsets, node_shape,
                    vdim: int) -> "FlatStencilOperator":
        """Operator over already packed ``[n_off·v·v, N_pad]`` weights."""
        op = cls.__new__(cls)
        op._init_meta(offsets, node_shape, vdim)
        _check_kernel_shape(vdim, op.deltas, W.device)
        if tuple(W.shape) != (op.n_off * vdim * vdim, op.N_pad):
            raise ValueError(f"packed weights {tuple(W.shape)} do not match "
                             f"{op.n_off} offsets × v²={vdim * vdim} × "
                             f"N_pad={op.N_pad} (N={op.N})")
        op.W = W
        return op

    def _init_meta(self, offsets, node_shape, vdim):
        self.node_shape = tuple(int(s) for s in node_shape)
        self.vdim = vdim
        strides = []
        acc = 1
        for s in reversed(self.node_shape):
            strides.append(acc)
            acc *= s
        strides = list(reversed(strides))
        self.N = int(np.prod(self.node_shape))
        self.N_pad = padded_length(self.N)
        self.deltas = tuple(int(sum(o * st for o, st in zip(off, strides)))
                            for off in offsets)
        self.n_off = len(self.deltas)
        self.launches = 0
        self._deltas_c = None

    def as_weight_dtype(self, weight_dtype) -> "FlatStencilOperator":
        """Same operator with weights cast on the device (round to nearest
        even) — the bf16 smoother variant without a second host pack."""
        op = copy.copy(self)
        op.W = self.W.to(weight_dtype)
        op.launches = 0
        op._graphs = None     # graphs captured on self read self.W
        return op

    @property
    def variant(self) -> str:
        wt = "bf16" if self.W.dtype == torch.bfloat16 else "f32"
        return f"v{self.vdim}_{wt}"

    # ------------------------------------------------------------------
    def to_flat(self, x_grid: torch.Tensor) -> torch.Tensor:
        """[*node_shape(,v)] → [v, N] f32, contiguous."""
        if self.vdim > 1:
            xf = x_grid.reshape(self.N, self.vdim).t()
        else:
            xf = x_grid.reshape(1, self.N)
        return xf.to(torch.float32).contiguous()

    def from_flat(self, y_flat: torch.Tensor) -> torch.Tensor:
        if self.vdim > 1:
            return y_flat.t().reshape(self.node_shape + (self.vdim,))
        return y_flat.reshape(self.node_shape)

    def apply_flat(self, x_flat: torch.Tensor) -> torch.Tensor:
        """x_flat: [v, N] f32 → y [v, N] f32."""
        if x_flat.is_cuda:
            return self._launch(x_flat)
        if x_flat.device.type == "cpu" and self.W.device.type == "cpu":
            return spmv_plain(self.W, x_flat, self.deltas, self.vdim)
        raise ValueError(f"x on {x_flat.device}, weights on {self.W.device}")

    def apply(self, x_grid: torch.Tensor) -> torch.Tensor:
        return self.from_flat(self.apply_flat(self.to_flat(x_grid)))

    def _launch(self, x: torch.Tensor) -> torch.Tensor:
        W = self.W
        if W.device != x.device:
            raise ValueError(f"x on {x.device}, weights on {W.device}")
        if x.dtype != torch.float32 or tuple(x.shape) != (self.vdim, self.N) \
                or not x.is_contiguous():
            raise ValueError(f"x must be contiguous float32 [{self.vdim}, "
                             f"{self.N}], got {x.dtype} {tuple(x.shape)}")
        if W.dtype not in (torch.float32, torch.bfloat16) \
                or not W.is_contiguous() or W.data_ptr() % 16 \
                or W.shape[1] != self.N_pad:
            raise ValueError(f"weights must be contiguous, 16-byte aligned "
                             f"f32/bf16 [*, {self.N_pad}], got {W.dtype} "
                             f"{tuple(W.shape)}")
        lib = build_library()
        if self._deltas_c is None:
            self._deltas_c = (ctypes.c_int * self.n_off)(*self.deltas)
        y = torch.empty_like(x)
        rc = lib.flat_stencil_spmv(
            W.data_ptr(), int(W.dtype == torch.bfloat16), self.vdim,
            x.data_ptr(), y.data_ptr(), self.N, self.N_pad, self._deltas_c,
            self.n_off, torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flat_stencil_spmv launch failed: CUDA error "
                               f"{rc} (vdim={self.vdim}, N={self.N}, "
                               f"{W.dtype})")
        count_launch(self.variant, self)
        return y
