"""Result data model: time-series scalar fields and solve/plot results.

Shape- and metadata-compatible with the reference result model
(``fenics_mcp_server.py:168-198``): ``coords`` is an ``[N][3]``
3D embedding of every DOF, ``values`` is ``[Nt][N]`` and ``times`` is ``[Nt]``.
Unlike the reference (which materializes Python lists per snapshot — an
O(Nt*N) boxing cost, fenics_mcp_server.py:314,:443), fields here hold numpy
arrays and only convert to lists on demand.

Artifacts are pickled to disk so large arrays stay out of the MCP JSON-RPC
channel (same design as fenics_mcp_server.py:1961-1974).
"""

from __future__ import annotations

import pickle
import uuid
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Any, Dict, List, Union

import numpy as np

Array = Union[np.ndarray, List]


@dataclass
class TimeSeriesField:
    """A scalar field sampled at N points over Nt times, embedded in 3D.

    coords: [N][3] — every DOF/point embedded in 3D space
    values: [Nt][N] — field values per time step
    times:  [Nt]
    dim:    actual PDE dimension (1/2/3), used for plot routing and titles
    meta:   extra info (field name, unit, pde type, geometry, solver stats...)
    """

    coords: Array
    values: Array
    times: Array
    dim: int
    meta: Dict[str, Any] = dc_field(default_factory=dict)

    # ------------------------------------------------------------------
    def coords_array(self) -> np.ndarray:
        return np.asarray(self.coords, dtype=np.float64)

    def values_array(self) -> np.ndarray:
        return np.asarray(self.values, dtype=np.float64)

    def times_array(self) -> np.ndarray:
        return np.asarray(self.times, dtype=np.float64)

    def as_lists(self) -> "TimeSeriesField":
        """Reference-exact representation (lists of floats)."""
        return TimeSeriesField(
            coords=self.coords_array().tolist(),
            values=self.values_array().tolist(),
            times=self.times_array().tolist(),
            dim=self.dim,
            meta=dict(self.meta),
        )


@dataclass
class SolveResult:
    """Solve result: path of the pickled TimeSeriesField + metadata."""

    data_file: str
    dim: int
    meta: Dict[str, Any]


@dataclass
class PlotResult:
    """Plot result: path of the generated interactive HTML file."""

    html_path: str


# ----------------------------------------------------------------------
# Artifact IO
# ----------------------------------------------------------------------

def save_field(field: TimeSeriesField, data_dir: str, prefix: str) -> str:
    """Pickle a TimeSeriesField to ``<data_dir>/<prefix>_<uuid8>.pkl``.

    Mirrors the reference artifact layout (fenics_mcp_server.py:1961-1968).
    """
    data_path = Path(data_dir)
    data_path.mkdir(parents=True, exist_ok=True)
    filename = f"{prefix}_{uuid.uuid4().hex[:8]}.pkl"
    filepath = data_path / filename
    with open(filepath, "wb") as f:
        pickle.dump(field, f, protocol=pickle.HIGHEST_PROTOCOL)
    return str(filepath)


def load_field(data_file: str) -> TimeSeriesField:
    """Load a pickled TimeSeriesField, tolerating foreign pickles.

    Accepts pickles produced by this package, plus duck-typed objects with
    coords/values/times/dim/meta attributes (e.g. the reference's own class),
    plus plain dicts.
    """
    with open(data_file, "rb") as f:
        obj = _RenamingUnpickler(f).load()
    if isinstance(obj, TimeSeriesField):
        return obj
    if isinstance(obj, dict) and {"coords", "values", "times"} <= set(obj):
        return TimeSeriesField(
            coords=obj["coords"], values=obj["values"], times=obj["times"],
            dim=int(obj.get("dim", 1)), meta=dict(obj.get("meta", {})),
        )
    if all(hasattr(obj, a) for a in ("coords", "values", "times", "dim", "meta")):
        return TimeSeriesField(
            coords=obj.coords, values=obj.values, times=obj.times,
            dim=int(obj.dim), meta=dict(obj.meta),
        )
    raise TypeError(f"Unrecognized field pickle: {type(obj)!r}")


class _RenamingUnpickler(pickle.Unpickler):
    """Map TimeSeriesField classes from other module paths onto ours, and
    restrict everything else to a numpy/stdlib safelist.

    ``load_field`` is reachable from the MCP tool
    ``plot_time_series_field_from_file`` with a caller-supplied path, so a
    permissive unpickler would be an arbitrary-code-execution hole.  Only the
    three local dataclasses plus the numpy reconstruction helpers (what a
    pickled array-of-floats field actually needs) are allowed.
    """

    _SAFE = {
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy._core.numeric", "_frombuffer"),
        ("collections", "OrderedDict"),
        ("builtins", "complex"),
    }

    def find_class(self, module, name):  # noqa: D102
        if name == "TimeSeriesField":
            return TimeSeriesField
        if name in ("SolveResult", "PlotResult"):
            return {"SolveResult": SolveResult, "PlotResult": PlotResult}[name]
        if (module, name) in self._SAFE or module.startswith("numpy.dtypes"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} (not on the field-pickle "
            "safelist)")
