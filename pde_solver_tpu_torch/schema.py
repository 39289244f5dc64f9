"""PDE parameter schema — the IR between the agent layer and the solvers.

Field names, types and defaults are contract-compatible with the reference
schema (``pde_schema.py:13-84``) so natural-language queries
route through parser → dispatcher → solver unchanged.  The implementation is
new: it adds validation, canonicalization helpers and round-trip (de)serialization
used by the conversation-memory merge path.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields as dc_fields
from typing import Any, Dict, List, Optional


@dataclass
class PDEParameters:
    """Structured representation of a PDE problem extracted from natural language."""

    # What PDE
    pde_type: str = "heat"  # "heat" | "wave" | "advection" | "poisson" | "elasticity" | "other"
    dim: int = 1  # 1 | 2 | 3

    # Domain geometry
    domain_size: Dict[str, float] = field(default_factory=dict)
    geometry_type: Optional[str] = None  # "box" | "cylinder" | "sphere" | "cube" | "column" ...
    geometry_params: Dict[str, float] = field(default_factory=dict)
    coordinate_system: Optional[str] = None  # "cartesian" | "cylindrical" | "spherical"

    # Spatial discretization
    nx: Optional[int] = None
    ny: Optional[int] = None
    nz: Optional[int] = None

    # Material / physical parameters
    diffusivity: Optional[float] = None
    wave_speed: Optional[float] = None
    young_modulus: Optional[float] = None
    poisson_ratio: Optional[float] = None
    density: Optional[float] = None
    material_params: Dict[str, float] = field(default_factory=dict)

    # Composite material (high-conductivity core)
    core_radius: Optional[float] = None
    core_diffusivity: Optional[float] = None

    # Boundary conditions
    bc_type: str = "dirichlet"  # "dirichlet" | "neumann" | "robin" | "mixed"
    bc_values: Dict[str, Any] = field(default_factory=dict)

    # Initial condition
    initial_type: Optional[str] = None  # "constant" | "zero" | "cosine" | "sine"
    initial_value: Optional[float] = None
    initial_function: Optional[str] = None
    initial_amplitude: Optional[float] = None
    initial_wavenumber: Optional[float] = None

    # Source term
    source_type: Optional[str] = None  # "none" | "constant"
    source_value: Optional[float] = None

    # Steady-state mode
    steady: Optional[bool] = None

    # Time discretization
    dt: Optional[float] = None
    num_steps: Optional[int] = None
    total_time: Optional[float] = None

    # Metadata
    field_name: str = "temperature"
    unit: str = "°C"
    notes: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable dict (reference parity: pde_schema.py:74-84)."""
        out: Dict[str, Any] = {}
        for key, value in self.__dict__.items():
            if isinstance(value, (int, float, str, bool, type(None), dict, list)):
                out[key] = value
            else:
                out[key] = str(value)
        return out

    @classmethod
    def field_names(cls) -> set:
        return {f.name for f in dc_fields(cls)}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PDEParameters":
        """Build from a dict, silently dropping unknown keys (LLM robustness)."""
        known = cls.field_names()
        return cls(**{k: v for k, v in (data or {}).items() if k in known})
