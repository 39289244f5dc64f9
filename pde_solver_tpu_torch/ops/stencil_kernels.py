"""Flat-layout stencil SpMV: the hand-written CUDA kernel and its wrapper.

Counterpart of ``pde_solver_tpu.ops.pallas_kernels.FlatStencilOperator``.
The stencil operator is applied thousands of times per solve (CG iterations
× V-cycle levels), so its memory traffic sets the solve time.

Layout: operands live in *flat* node order — assembled weights carry exact
zeros wherever a flat shift would wrap across a grid row, so a stencil
offset is one flat-index delta.  Weights are plane-major
``[n_off·v·v, N]`` (float32, or bfloat16 for the MG smoother) and vectors
are component-major ``[v, N]`` float32.

:func:`spmv_plain` is the same function in plain torch.  ``apply_flat``
takes it only for CPU tensors; a CUDA tensor launches the kernel in
``csrc/flat_stencil_spmv.cu`` or raises.  The kernel is compiled with
``nvcc`` for ``sm_90a`` at first use into ``build/`` (rebuilt when the
source changes) and bound with ``ctypes``.
"""

from __future__ import annotations

import copy
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flat_stencil_spmv.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Below this DOF count a level would apply through plain torch shifted
# slices instead of the kernel.  0 routes every level through the kernel:
# on an H100 the kernel beat its plain version both at the 2M-DOF flagship
# level and at a 1,701-node level (PERF.md); a per-level H100 measurement
# is what may raise it.
KERNEL_MIN_DOF = 0

# Launches of the CUDA kernel in this process, by variant
# ("v3_f32", "v3_bf16", "v1_f32").  Only a kernel launch counts: the CPU
# plain path never does.
KERNEL_LAUNCHES: Dict[str, int] = {}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def kernel_wins(n_dof: int) -> bool:
    """Whether a level of ``n_dof`` unknowns applies through the kernel."""
    return n_dof >= KERNEL_MIN_DOF


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_library() -> ctypes.CDLL:
    """Compile (if the source hash is new) and load the kernel library.

    The ``.so`` name carries a hash of the source and flags, so an edited
    source builds anew; the build goes to a temporary name and is renamed
    into place, so concurrent builders never load a half-written file."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so_path = _BUILD_DIR / f"flat_stencil_spmv-{digest[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    fn = lib.flat_stencil_spmv
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    BUILD_INFO.update(path=str(so_path), seconds=time.perf_counter() - t0,
                      log=log)
    _LIB = lib
    return lib


def spmv_plain(W: torch.Tensor, x: torch.Tensor, deltas: Sequence[int],
               vdim: int) -> torch.Tensor:
    """Plain torch flat SpMV: y[a] = Σ_{o,b} W[o,a,b] ⊙ x[b] shifted by δ_o,
    zero outside [0, N).  W [n_off·v·v, N] (f32 or bf16), x [v, N] f32."""
    N = x.shape[1]
    n_off = len(deltas)
    P = max(abs(int(d)) for d in deltas)
    xp = torch.nn.functional.pad(x, (P, P))
    Wv = W.view(n_off, vdim, vdim, N)
    y = torch.zeros((vdim, N), dtype=torch.float32, device=x.device)
    for o, d in enumerate(deltas):
        xs = xp[:, P + d:P + d + N]                   # [v(b), N]
        y += (Wv[o].float() * xs.unsqueeze(0)).sum(1)  # Σ_b over [a, b, N]
    return y


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
        Wmat = np.empty((self.n_off, vdim, vdim, self.N), np.float32)
        for o, W in enumerate(weights_np):
            Wmat[o] = np.asarray(W, np.float32).reshape(
                self.N, vdim, vdim).transpose(1, 2, 0)
        self.W = torch.from_numpy(Wmat.reshape(-1, self.N)).to(
            device=device, dtype=weight_dtype)

    @classmethod
    def from_packed(cls, W: torch.Tensor, offsets, node_shape,
                    vdim: int) -> "FlatStencilOperator":
        """Operator over already packed ``[n_off·v·v, N]`` weights."""
        op = cls.__new__(cls)
        op._init_meta(offsets, node_shape, vdim)
        if tuple(W.shape) != (op.n_off * vdim * vdim, op.N):
            raise ValueError(f"packed weights {tuple(W.shape)} do not match "
                             f"{op.n_off} offsets × v²={vdim * vdim} × N={op.N}")
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
                or not W.is_contiguous():
            raise ValueError(f"weights must be contiguous f32/bf16, "
                             f"got {W.dtype}")
        lib = build_library()
        if self._deltas_c is None:
            self._deltas_c = (ctypes.c_int * self.n_off)(*self.deltas)
        y = torch.empty_like(x)
        rc = lib.flat_stencil_spmv(
            W.data_ptr(), int(W.dtype == torch.bfloat16), self.vdim,
            x.data_ptr(), y.data_ptr(), self.N, self._deltas_c, self.n_off,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flat_stencil_spmv launch failed: CUDA error "
                               f"{rc} (vdim={self.vdim}, N={self.N}, "
                               f"{W.dtype})")
        self.launches += 1
        KERNEL_LAUNCHES[self.variant] = KERNEL_LAUNCHES.get(self.variant, 0) + 1
        return y
