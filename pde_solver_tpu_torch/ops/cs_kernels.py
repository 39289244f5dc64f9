"""Constant-interior ("CS") stencil operator: host analysis, CUDA kernels,
plain torch version.

Counterpart of ``pde_solver_tpu.ops.pallas_kernels.CSFlatStencilOperator``.
On a translation-invariant mesh the per-node weights carry about one
scalar of information per (offset, a, b) plane, yet the dense kernel
(``ops.stencil_kernels``) streams every plane at every node.  This operator
streams no weights for the bulk of the grid:

    y = Σ_o wc[o]·shift(x)                      (whole grid, scalar sets)
      + Σ_s m_s ⊙ Σ_o Δ_s[o]·shift(x)           (boundary classes of the
                                                  two minor axes)
      + window pass                              (everything else)

The boundary layers of the two minor axes (coordinate 0, 1, n−2 or n−1:
the outermost layer deviates from assembly, the next from the baked-in
diagonal scaling of its boundary neighbours) and their edge lines get one
scalar set each.  All remaining deviation (the major-axis slabs, contiguous
in flat order) is confined to the 1024-node windows holding a violating
node; those windows add exact residual weights R = W − model.  Every node
outside the windows satisfies the class model exactly, because the window
list is built from the violation scan.  Stencils that are not
representable (varying coefficients, more than ``MAX_EFF_SWEEPS`` scalar
sweeps, windows over ``MAX_WINDOW_FRAC`` of the grid, tiny grids) make
:meth:`CSFlatStencilOperator.try_build` return ``None``: the caller then
builds the dense operator, as the reference does.

Layout as ``FlatStencilOperator``: vectors ``[v, N]`` float32 in flat node
order.  A window is 1024 consecutive flat nodes, the TPU kernel's 8-row ×
128-lane octet, so the reference's octet list and its residual weights
(``[n_off·v², n_win·1024]`` here) carry over one to one
(``convert.cs_operator_from_reference``), and the disk-cache entry keeps the
reference's format.

``apply_flat`` launches the one kernel of ``csrc/cs_stencil.cu``, which
computes K3's pass and K4's window residual together, for a CUDA tensor,
or raises.  The kernel reads host-built tables: the scalar sets as term
lists in (o, b, a) order (:func:`term_lists`; set 0 goes into the kernel's
parameter block), the 5 × 5 code-pair → class-set mask table
(:func:`set_mask_table`), the window slot map (:func:`slot_map`) and magic
numbers for its divisions (:func:`fast_divisor`).  Only a CPU tensor takes
the plain torch version (:func:`cs_apply_plain`), which keeps explicit 0/1
class mask planes, as the reference's ``_masks_np`` builds them, so it
checks the kernel's coordinate tests independently.

Routing: ``PDE_TPU_CS`` selects this operator wherever the reference does
(``cs_mode``): "0" (default) dense, "1" CS for every flat operator,
"hybrid" CS for true residuals and the dense bf16 operator for smoothing.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.ops import cuda_build
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      check_row_groups,
                                                      count_launch)

LANE, SUB = 128, 8
WINDOW = LANE * SUB          # flat nodes per window (one TPU octet)
MAX_OFFSETS = 15             # the 3-D P1 stencil
MAX_SETS = 25                # interior + 8 layers + 16 edge lines
# minor-axis coordinate codes: 0, 1, 2 (inner), 3 (n − 2), 4 (n − 1)
CODES = 5
INNER = 2
# a CUDA operator with a vdim or an offset count outside these is refused
# when it is constructed (the ``#define CS_STENCIL_*`` lines of the source)
KERNEL_VDIMS = cuda_build.defined_list("cs_stencil", "CS_STENCIL_VDIMS")
KERNEL_NOFFS = cuda_build.defined_list("cs_stencil", "CS_STENCIL_NOFFS")

# Below this DOF count a level stays on the dense kernel even with
# ``PDE_TPU_CS`` on: the reference's ``PALLAS_MIN_DOF``, the size under
# which it never tries the constant-interior route.  On an H100 the CS
# kernel is 2.6-3.2x slower than dense bf16 on levels of a few thousand
# nodes, where nearly every node is a near-boundary one (PERF.md).
CS_MIN_DOF = 65536

_LIB: Optional[ctypes.CDLL] = None


def cs_wins(n_dof: int) -> bool:
    """Whether a level of ``n_dof`` unknowns may take the CS route."""
    return n_dof >= CS_MIN_DOF


def cs_mode() -> str:
    """``PDE_TPU_CS`` as the reference reads it: "0"/"off"/"false" is off,
    "hybrid" is the split route, anything else is on."""
    return os.environ.get("PDE_TPU_CS", "0").lower()


def cs_enabled(mode: Optional[str] = None) -> bool:
    return (cs_mode() if mode is None else mode) not in ("0", "off", "false")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("cs_stencil")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cs_stencil_params_size.argtypes = []
        lib.cs_stencil_params_size.restype = i
        lib.cs_stencil_prepare.argtypes = [p, i, ll, p, i, i, i, p, p, i, p, i]
        lib.cs_stencil_prepare.restype = i
        lib.cs_stencil_apply.argtypes = [p, p, p, p, p, p, p]
        lib.cs_stencil_apply.restype = i
        _LIB = lib
    return _LIB


def _masks_np(descs, node_shape, N: int) -> np.ndarray:
    """0/1 class planes ``[len(descs), N]`` (the reference's ``_masks_np``
    without its validity plane: the port has no padded tail)."""
    coords = np.unravel_index(np.arange(N, dtype=np.int64), node_shape)
    m_np = np.zeros((len(descs), N), np.float32)
    for i, desc in enumerate(descs):
        if desc[0] == "ax":
            _, ax, c = desc
            m_np[i] = coords[ax] == c
        else:
            _, ay, az, cy, cz = desc
            m_np[i] = (coords[ay] == cy) & (coords[az] == cz)
    return m_np


def _class_table(descs, node_shape) -> np.ndarray:
    """Per class, the required coordinate on each of the two minor axes
    (-1: any), each checked to lie within two nodes of a boundary."""
    d = len(node_shape)
    lead = d - 2                       # first of the two minor axes
    n_minor = [int(node_shape[lead]), int(node_shape[lead + 1])]
    table = np.full((max(len(descs), 1), 2), -1, np.int32)
    for i, desc in enumerate(descs):
        if desc[0] == "ax":
            pairs = [(desc[1], desc[2])]
        else:
            pairs = [(desc[1], desc[3]), (desc[2], desc[4])]
        for ax, c in pairs:
            k = ax - lead
            if k not in (0, 1) or not (c < 2 or c >= n_minor[k] - 2):
                raise ValueError(f"class {desc} is not a layer within two "
                                 f"nodes of a minor-axis boundary of "
                                 f"{tuple(node_shape)}")
            table[i, k] = c
    return table


def term_lists(sets, n_off: int, vdim: int) -> np.ndarray:
    """Every scalar set in the kernel's term order, float32 ``[n_sets,
    n_off·v²]``: term (o·v + b)·v + a is the set's plane (o·v + a)·v + b."""
    S = np.asarray(sets, np.float64).astype(np.float32)
    S = S.reshape(len(S), n_off, vdim, vdim)                  # [s, o, a, b]
    return np.ascontiguousarray(S.transpose(0, 1, 3, 2).reshape(len(S), -1))


def minor_code(i, n: int):
    """Code of minor-axis coordinate(s) ``i`` on an axis of ``n`` ≥ 5 nodes:
    0, 1, INNER (2 ≤ i < n − 2), 3 (n − 2), 4 (n − 1)."""
    i = np.asarray(i)
    return np.where(i < 2, i, np.where(i >= n - 2, i - n + CODES, INNER))


def set_mask_table(classes: np.ndarray, minor: Tuple[int, int]) -> np.ndarray:
    """uint32 ``[CODES·CODES]``: for the pair of minor-axis codes (c1, c2)
    at index c1·CODES + c2, bit s − 1 is set when a node with those codes
    lies in class set s (``classes`` row s − 1, from :func:`_class_table`).
    The inner pair's entry is 0: every class lies near a boundary."""
    table = np.zeros(CODES * CODES, np.uint32)
    for s, req in enumerate(classes):
        ok = [np.ones(CODES, bool) if c < 0
              else np.arange(CODES) == minor_code(c, n)
              for c, n in zip(req, minor)]
        table |= (np.outer(ok[0], ok[1]).reshape(-1)
                  * np.uint32(1 << s)).astype(np.uint32)
    return table


def slot_map(windows, N: int) -> np.ndarray:
    """int32 ``[ceil(N / WINDOW)]``: each window's slot in the residual
    weights (its place in ``windows``), −1 where it is not listed."""
    slots = np.full(-(-N // WINDOW), -1, np.int32)
    slots[np.asarray(windows, np.int64)] = np.arange(len(windows))
    return slots


def fast_divisor(d: int) -> Tuple[int, int]:
    """(m, s) with floor(n / d) = (n·m >> 32) >> s for 0 ≤ n < 2^31, d ≥ 2:
    m = ceil(2^p / d), p = 31 + ceil(log2 d), s = p − 32.  With e = m·d −
    2^p < d ≤ 2^ceil(log2 d), n·e < 2^p, so the quotient is exact."""
    if d < 2:
        raise ValueError(f"divisor {d} < 2")
    p = 31 + (d - 1).bit_length()
    return -(-(1 << p) // d), p - 32


class CSFlatStencilOperator:
    """Constant-interior stencil operator in flat layout.

    Build via :meth:`try_build` (``None`` when the stencil is not
    CS-representable).  Interface mirrors :class:`FlatStencilOperator`:
    ``to_flat`` / ``from_flat`` / ``apply_flat`` / ``apply``.  ``launches``
    counts this operator's kernel launches: one per apply on the card.
    """

    # give up when the window pass would cover most of the grid anyway
    MAX_WINDOW_FRAC = 0.5
    # cap on the effective scalar sweep count (sets weighted by their
    # nonzero fraction, as the reference reckons it)
    MAX_EFF_SWEEPS = 13.0

    def __init__(self, offsets, node_shape, vdim: int, sets, descs,
                 windows: np.ndarray, Wwin: np.ndarray, device="cuda"):
        # weight-free base: the layout metadata only (the CS apply never
        # touches dense weights)
        base = FlatStencilOperator.__new__(FlatStencilOperator)
        base._init_meta(offsets, node_shape, vdim)
        self.base = base
        self.node_shape, self.vdim, self.N = base.node_shape, vdim, base.N
        self.deltas, self.n_off = base.deltas, base.n_off
        self.sets = tuple(tuple(float(v) for v in sv) for sv in sets)
        self.descs = tuple(tuple(dd) for dd in descs)
        self.windows = np.asarray(windows, np.int64)
        self.n_win = int(self.windows.size)
        nw = self.n_off * vdim * vdim
        self.eff_sweeps = float(sum(np.count_nonzero(sv) / nw
                                    for sv in self.sets))
        if len(self.sets) > MAX_SETS or self.n_off > MAX_OFFSETS:
            raise ValueError(f"{len(self.sets)} sets × {self.n_off} offsets "
                             f"exceed the kernel's {MAX_SETS} × {MAX_OFFSETS}")
        dev = torch.device(device)
        if dev.type == "cuda":
            if vdim not in KERNEL_VDIMS or self.n_off not in KERNEL_NOFFS:
                raise ValueError(f"cs_stencil is built for vdim in "
                                 f"{KERNEL_VDIMS} and offset counts in "
                                 f"{KERNEL_NOFFS}, not {vdim} and "
                                 f"{self.n_off}")
            check_row_groups(self.deltas)
        # the plain version's tables: scalars in plane order, window list
        self.scalars = torch.as_tensor(
            np.asarray(self.sets, np.float64).astype(np.float32)).to(dev)
        self.win_idx = torch.as_tensor(self.windows.astype(np.int32)).to(dev)
        self.Wwin = torch.tensor(
            np.asarray(Wwin, np.float32).reshape(nw, self.n_win * WINDOW),
            device=dev)
        # the kernel's: term lists (set 0 goes into its parameter block),
        # the code-pair mask table, the slot map
        classes = _class_table(self.descs, self.node_shape)
        self.terms = term_lists(self.sets, self.n_off, vdim)
        self.cls_terms = torch.as_tensor(self.terms[1:]).to(dev)
        self.set_masks = set_mask_table(classes[:len(self.descs)],
                                        self.node_shape[-2:])
        self.slots = torch.as_tensor(slot_map(self.windows, self.N)).to(dev)
        self.launches = 0
        self._masks = None
        self._params = None

    # ------------------------------------------------------------------
    @classmethod
    def _from_disk(cls, ent, offsets, node_shape, vdim, device):
        raw = ent["meta"].get("descs", "")
        descs = []
        for row in (raw.split("|") if raw else []):
            parts = row.split(":")
            descs.append((parts[0],) + tuple(int(x) for x in parts[1:]))
        return cls(offsets, node_shape, vdim, ent["sets"], descs,
                   np.asarray(ent["octs"]), ent["Wwin"], device=device)

    @classmethod
    def try_build(cls, offsets, weights_np: Sequence[np.ndarray],
                  node_shape: Tuple[int, ...], vdim: int = 1,
                  block: int = 4096, device="cuda", cache_key=None):
        """Host analysis in numpy float64, copied from the reference.

        ``block`` only sets the padded length the reference reckons its
        ``MAX_WINDOW_FRAC`` decision against (its default, 4096), so both
        packages accept and refuse the same stencils.  The reference also
        refuses an x too large for TPU VMEM; that refusal is dropped here
        (the card reads x through its L2).  ``cache_key`` persists the
        artifacts (``utils.diskcache``, the reference's entry format)."""
        d = len(node_shape)
        nz = int(node_shape[-1])
        if d < 2 or nz < 5 or min(int(s) for s in node_shape) < 5:
            return None
        n_off = len(offsets)
        nw = n_off * vdim * vdim
        N = int(np.prod(node_shape))
        n_pad = _round_up(N, _round_up(block, WINDOW))
        n_rows = n_pad // LANE

        dkey = None
        if cache_key is not None:
            from pde_solver_tpu_torch.utils import diskcache
            dkey = ("csop", cache_key, tuple(int(x) for x in node_shape),
                    vdim, block)
            ent = diskcache.load("csop", dkey)
            if ent is not None:
                if ent["meta"].get("refused") == "1":
                    return None
                return cls._from_disk(ent, offsets, node_shape, vdim, device)

        # flat per-plane weights [nw, N] (f64 for exact comparisons)
        planes = np.empty((nw, N), np.float64)
        for o, W in enumerate(weights_np):
            Wf = np.asarray(W, np.float64).reshape(N, vdim, vdim)
            for a in range(vdim):
                for b in range(vdim):
                    planes[(o * vdim + a) * vdim + b] = Wf[:, a, b]

        center = tuple(int(s) // 2 for s in node_shape)
        cflat = int(np.ravel_multi_index(center, node_shape))
        wc = planes[:, cflat].copy()
        # significance floor: composing wc + Δ_class (+ Δ_pair) reproduces
        # the true weights only to f64 rounding; 1e-12·scale is ~4 decades
        # below f32 roundoff, so sub-threshold residues are dropped
        tol = 1e-12 * float(np.abs(planes).max())

        # deviating boundary classes of the minor axes (all axes for d == 2,
        # the last two for d >= 3 — major-axis deviations are contiguous in
        # flat order and go to the window pass instead)
        fold_axes = list(range(max(0, d - 2), d))
        axis_deltas = {}          # axis -> [(class, delta[nw])]
        for ax in fold_axes:
            sz = int(node_shape[ax])
            found = []
            for c in sorted({0, 1, sz - 2, sz - 1}):
                rep = list(center)
                rep[ax] = c
                delta = planes[:, int(np.ravel_multi_index(
                    rep, node_shape))] - wc
                if np.any(np.abs(delta) > tol):
                    found.append((c, delta))
            axis_deltas[ax] = found

        # one scalar set per deviating class, plus one per deviating class
        # pair (edge lines where both minor axes are boundary)
        sets = [wc]
        descs = []            # ("ax", axis, class) | ("pair", ay, az, cy, cz)
        for ax, found in axis_deltas.items():
            for c, delta in found:
                sets.append(delta)
                descs.append(("ax", ax, c))
        if len(fold_axes) == 2:
            ay, az = fold_axes
            for cy, dy in axis_deltas[ay]:
                for cz, dz in axis_deltas[az]:
                    rep = list(center)
                    rep[ay], rep[az] = cy, cz
                    de = planes[:, int(np.ravel_multi_index(
                        rep, node_shape))] - wc - dy - dz
                    if np.any(np.abs(de) > tol):
                        sets.append(de)
                        descs.append(("pair", ay, az, cy, cz))
        eff = sum(np.count_nonzero(sv) / nw for sv in sets)
        if eff > cls.MAX_EFF_SWEEPS:
            return None

        # residual over the padded flat domain, in place:
        # resid = planes − (wc + Σ m_i·Δ_i); the tail needs no work
        m_np = _masks_np(descs, node_shape, N)
        resid = np.zeros((nw, n_pad), np.float64)
        resid[:, :N] = planes
        resid[:, :N] -= wc[:, None]
        for i in range(len(descs)):
            cols = np.nonzero(m_np[i])[0]
            resid[:, cols] -= sets[1 + i][:, None]
        bad_rows = np.any(np.abs(resid).reshape(nw, n_rows, LANE) > tol,
                          axis=(0, 2))
        bad_win = np.any(bad_rows.reshape(-1, SUB), axis=1)
        wins = np.nonzero(bad_win)[0]
        n_win = int(wins.size)
        if n_win == 0 or n_win * SUB > cls.MAX_WINDOW_FRAC * n_rows:
            # all-interior is implausible (boundaries always deviate);
            # near-dense windows defeat the purpose
            if dkey is not None:
                from pde_solver_tpu_torch.utils import diskcache
                diskcache.store("csop", dkey, {}, meta={"refused": "1"})
            return None

        # compact residual weights of the windows, [nw, n_win·1024]
        Rrows = resid.astype(np.float32).reshape(nw, -1, WINDOW)
        Wwin = np.ascontiguousarray(Rrows[:, wins, :]).reshape(nw, -1)

        if dkey is not None:
            from pde_solver_tpu_torch.utils import diskcache
            diskcache.store(
                "csop", dkey,
                {"sets": np.asarray(sets, np.float64),
                 "octs": wins.astype(np.int64),
                 "Wwin": Wwin.reshape(nw, n_win * SUB, LANE)},
                meta={"descs": "|".join(":".join(str(x) for x in pr)
                                        for pr in descs)})
        return cls(offsets, node_shape, vdim, sets, descs, wins, Wwin,
                   device=device)

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.scalars.device

    def to_flat(self, x_grid: torch.Tensor) -> torch.Tensor:
        return self.base.to_flat(x_grid)

    def from_flat(self, y_flat: torch.Tensor) -> torch.Tensor:
        return self.base.from_flat(y_flat)

    def apply(self, x_grid: torch.Tensor) -> torch.Tensor:
        return self.from_flat(self.apply_flat(self.to_flat(x_grid)))

    def apply_flat(self, x_flat: torch.Tensor) -> torch.Tensor:
        """x_flat: [v, N] f32 → y [v, N] f32."""
        if x_flat.is_cuda:
            return self.launch(x_flat)
        if x_flat.device.type == "cpu" and self.device.type == "cpu":
            return cs_apply_plain(self, x_flat)
        raise ValueError(f"x on {x_flat.device}, operator on {self.device}")

    # -- kernel launch -------------------------------------------------------
    def _check(self, t: torch.Tensor, what: str) -> None:
        if t.device != self.device:
            raise ValueError(f"{what} on {t.device}, operator on {self.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (self.vdim, self.N) \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous float32 [{self.vdim}, "
                             f"{self.N}], got {t.dtype} {tuple(t.shape)}")

    def kernel_params(self) -> ctypes.Array:
        """The kernel's parameter block (set 0's term list, the mask table,
        the geometry and its magic divisors), built once per operator."""
        if self._params is None:
            lib = build_library()
            n1, n2 = self.node_shape[-2:]
            per_slice = 4 * n2 + 4 * (n1 - 4)
            divs = [v for d in (n2, n1, per_slice) for v in fast_divisor(d)]
            params = ctypes.create_string_buffer(lib.cs_stencil_params_size())
            rc = lib.cs_stencil_prepare(
                params, self.vdim, self.N,
                (ctypes.c_int * self.n_off)(*self.deltas), self.n_off, n1, n2,
                self.terms[0].ctypes.data_as(ctypes.c_void_p),
                self.set_masks.ctypes.data_as(ctypes.c_void_p),
                len(self.descs), (ctypes.c_uint * 6)(*divs), self.n_win)
            if rc != 0:
                raise ValueError(f"cs_stencil_prepare refused the operator: "
                                 f"CUDA error {rc} (vdim={self.vdim}, "
                                 f"N={self.N}, node shape {self.node_shape})")
            self._params = params
        return self._params

    def launch(self, x: torch.Tensor, windows: bool = True) -> torch.Tensor:
        """The fused kernel: the scalar sets and, with ``windows``, the
        window residuals (``cs_apply_plain``'s function); without, the sets
        alone (``cs_main_plain``'s).  Either counts one launch."""
        self._check(x, "x")
        params = self.kernel_params()
        y = torch.empty_like(x)
        rc = build_library().cs_stencil_apply(
            params, x.data_ptr(), y.data_ptr(), self.cls_terms.data_ptr(),
            self.slots.data_ptr() if windows else None, self.Wwin.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cs_stencil_apply launch failed: CUDA error "
                               f"{rc} (vdim={self.vdim}, N={self.N}, "
                               f"{len(self.sets)} sets, {self.n_win} windows)")
        self.launches += 1
        count_launch(f"cs_apply_v{self.vdim}")
        return y

    def masks(self) -> torch.Tensor:
        """The class planes ``[len(descs), N]`` f32 on the operator's device
        (built on first use; only the plain version reads them)."""
        if self._masks is None:
            self._masks = torch.from_numpy(_masks_np(
                self.descs, self.node_shape, self.N)).to(self.device)
        return self._masks


# ----------------------------------------------------------------------
# Plain torch version (the CPU path, and the kernel's check on the card)
# ----------------------------------------------------------------------

def _shifted(x: torch.Tensor, deltas) -> list:
    """x[:, n + δ] for every δ, zero outside [0, N)."""
    N = x.shape[1]
    P = max(abs(int(dd)) for dd in deltas)
    xp = torch.nn.functional.pad(x, (P, P))
    return [xp[:, P + dd:P + dd + N] for dd in deltas]


def cs_main_plain(op: CSFlatStencilOperator, x: torch.Tensor) -> torch.Tensor:
    """K3 in plain torch: set-major, (o, b, a) within a set, zero scalars
    skipped, each class set weighted by its explicit 0/1 mask plane."""
    v = op.vdim
    xs = _shifted(x, op.deltas)
    masks = op.masks() if len(op.sets) > 1 else None
    scal = np.asarray(op.sets, np.float64).astype(np.float32)
    y = torch.zeros_like(x)
    for si in range(len(op.sets)):
        acc = [torch.zeros_like(x[0]) for _ in range(v)]
        for o in range(op.n_off):
            for b in range(v):
                for a in range(v):
                    k = (o * v + a) * v + b
                    if scal[si, k] != 0.0:
                        # a float32 0-d view: the product rounds in f32
                        acc[a] = acc[a] + op.scalars[si, k] * xs[o][b]
        for a in range(v):
            y[a] = y[a] + (acc[a] if si == 0 else masks[si - 1] * acc[a])
    return y


def cs_window_plain(op: CSFlatStencilOperator, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """K4 in plain torch: y[:, window nodes] += Σ_{o,b} R·x(n+δ_o), per
    output component over (o, b); returns a new tensor."""
    v, N = op.vdim, op.N
    y = y.clone()
    if op.n_win == 0:
        return y
    nodes = (op.win_idx.to(torch.int64)[:, None] * WINDOW
             + torch.arange(WINDOW, device=x.device)[None, :]).reshape(-1)
    keep = nodes < N
    nodes, pos = nodes[keep], torch.nonzero(keep).reshape(-1)
    R = op.Wwin[:, pos]
    gathered = []
    for dd in op.deltas:
        m = nodes + int(dd)
        inside = (m >= 0) & (m < N)
        gathered.append(torch.where(inside[None, :],
                                    x[:, m.clamp(0, N - 1)],
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device)))
    for a in range(v):
        acc = y[a, nodes]
        for o in range(op.n_off):
            for b in range(v):
                acc = acc + R[(o * v + a) * v + b] * gathered[o][b]
        y[a, nodes] = acc
    return y


def cs_apply_plain(op: CSFlatStencilOperator, x: torch.Tensor) -> torch.Tensor:
    """The whole CS apply in plain torch: K4's pass on K3's output."""
    return cs_window_plain(op, x, cs_main_plain(op, x))
