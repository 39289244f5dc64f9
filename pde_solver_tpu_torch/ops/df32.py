"""Double-float32 (double-word) arithmetic for f64-grade defects in float32.

Counterpart of ``pde_solver_tpu.ops.df32``.  The mixed-precision solvers
need f64-grade accuracy in one place only: the defect r = b − A x, where ~7
significant digits cancel.  Each quantity is an unevaluated pair (hi, lo) of
float32, and error-free transformations (TwoSum, Dekker-split TwoProd)
compute the cancellation exactly with float32 operations; the f64 operator
is stored as an (hi, lo) f32 pair.  Effective precision of the pair ≈ 2^-48.

FMA contraction would break :func:`two_prod` (``ah*bh - p`` fused into one
rounding is no longer Dekker's product).  Eager torch runs every operator
below as its own kernel, so nothing contracts.  Never wrap this module in
``torch.compile``, whose fusion may emit FMAs.

References: Dekker (1971), Knuth TAOCP §4.2.2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Offset = Tuple[int, ...]

# Dekker splitting constant for float32 (24-bit mantissa): 2^12 + 1.
_SPLIT = 4097.0


def two_sum(a, b):
    """Error-free a + b = s + e with |e| ≤ ulp(s)/2 (Knuth)."""
    s = a + b
    bv = s - a
    e = (a - (s - bv)) + (b - bv)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| ≥ |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a·b = p + e via Dekker splitting (no FMA required)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_f64(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host: split float64 into an (hi, lo) float32 pair."""
    hi = np.asarray(x64, dtype=np.float32)
    lo = np.asarray(x64 - hi.astype(np.float64), dtype=np.float32)
    return hi, lo


def df_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def df_scale_add(x_hi, x_lo, alpha, d):
    """x + alpha·d with d, alpha in f32; keeps the pair normalized."""
    p, pe = two_prod(alpha, d)
    s, e = two_sum(x_hi, p)
    e = e + x_lo + pe
    return fast_two_sum(s, e)


def df_stencil_residual(offsets: Tuple[Offset, ...], W_hi, W_lo,
                        b_hi, b_lo, x_hi, x_lo,
                        grid_dim: int, vdim: int):
    """r = b − A x with A, b, x in double-f32 pairs (grid layout).

    Accumulates Σ W·x exactly (TwoProd + TwoSum chains); the lo-parts enter
    as first-order corrections (W_hi·x_lo + W_lo·x_hi), bounding the total
    error around 2^-45 relative.  Returns the residual as a single f32
    tensor plus ‖r‖² (f32 0-dim tensor)."""
    from pde_solver_tpu_torch.ops.linsolve import _pad1

    xh = _pad1(x_hi, grid_dim)
    xl = _pad1(x_lo, grid_dim)
    shape = x_hi.shape[:grid_dim]
    slices = [tuple(slice(1 + o, 1 + o + n) for o, n in zip(off, shape))
              for off in offsets]

    def zeros():
        return torch.zeros(shape, dtype=torch.float32, device=x_hi.device)

    if vdim == 1:
        s, e = zeros(), zeros()
        for sl, Wh, Wl in zip(slices, W_hi, W_lo):
            xsh = xh[sl]
            xsl = xl[sl]
            p, pe = two_prod(Wh, xsh)
            pe = pe + Wh * xsl + Wl * xsh
            s, e2 = two_sum(s, p)
            # error channel accumulated error-free too — a plain f32 sum of
            # ~n_off·v² correction terms floors the defect near 1e-6·κ·ε32²
            e, e3 = two_sum(e, e2 + pe)
            s, e4 = fast_two_sum(s, e3)
            e = e + e4
        rs, re = two_sum(b_hi, -s)
        r = rs + (re + b_lo - e)
    else:
        comps = []
        for i in range(vdim):
            s, e = zeros(), zeros()
            for sl, Wh, Wl in zip(slices, W_hi, W_lo):
                xsh = xh[sl + (Ellipsis,)]
                xsl = xl[sl + (Ellipsis,)]
                for j in range(vdim):
                    p, pe = two_prod(Wh[..., i, j], xsh[..., j])
                    pe = pe + Wh[..., i, j] * xsl[..., j] \
                        + Wl[..., i, j] * xsh[..., j]
                    s, e2 = two_sum(s, p)
                    e, e3 = two_sum(e, e2 + pe)
                    s, e4 = fast_two_sum(s, e3)
                    e = e + e4
            rs, re = two_sum(b_hi[..., i], -s)
            comps.append(rs + (re + b_lo[..., i] - e))
        r = torch.stack(comps, dim=-1)
    rnorm2 = torch.dot(r.reshape(-1), r.reshape(-1))
    return r, rnorm2


def jit_df_residual(offsets, W_hi, W_lo, b_hi, b_lo, x_hi, x_lo,
                    grid_dim, vdim):
    """Same as :func:`df_stencil_residual` (the JAX package jits it; eager
    torch has nothing to compile)."""
    return df_stencil_residual(offsets, W_hi, W_lo, b_hi, b_lo, x_hi, x_lo,
                               grid_dim, vdim)


def pack_df_weights(host_weights64, device) -> Tuple[Tuple[torch.Tensor, ...],
                                                     Tuple[torch.Tensor, ...]]:
    """Split f64 host stencil weights into device (hi, lo) f32 pairs."""
    his, los = [], []
    for W in host_weights64:
        hi, lo = df_from_f64(np.asarray(W, dtype=np.float64))
        his.append(torch.from_numpy(hi).to(device))
        los.append(torch.from_numpy(lo).to(device))
    return tuple(his), tuple(los)
