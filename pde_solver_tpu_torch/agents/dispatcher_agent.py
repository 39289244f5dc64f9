"""Dispatcher Agent: :class:`PDEParameters` → solver tool call + plot + summary.

Routing parity with the reference dispatcher (dispatcher_agent.py:97-324):
deterministic Python (never an LLM), same geometry-alias normalization, the
same pde_type × dim × geometry routing table, the same argument-builder
defaults and heuristics (characteristic-time dt/num_steps, r1/r2/h cylinder
mapping, gravity → body-force conversion, quantity validation).

Structural upgrade: tools are invoked through a pluggable :class:`ToolSet` —
:class:`LocalToolSet` calls ``pde_solver_tpu_torch.api`` in-process (no subprocess
round-trip), :class:`MCPToolSet` speaks MCP stdio to an external server
(the reference's only mode).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

from pde_solver_tpu_torch.schema import PDEParameters

_CYL_ALIASES = ("cylinder", "cylindrical", "column", "tube", "pipe", "tunnel")
_SPH_ALIASES = ("sphere", "spherical", "ball")
_BOX_ALIASES = ("cube", "cubic", "box", "rectangular")


class ToolSet:
    """Protocol: async call(tool_name, args) → result dict."""

    async def call(self, name: str, args: Dict[str, Any]) -> Any:  # pragma: no cover
        raise NotImplementedError

    async def tool_names(self) -> list:  # pragma: no cover
        raise NotImplementedError


class LocalToolSet(ToolSet):
    """Direct in-process calls into pde_solver_tpu_torch.api."""

    def __init__(self):
        from pde_solver_tpu_torch import api as _api
        self._api = _api
        self._names = [n for n in (
            "solve_heat_1D", "solve_heat_2D", "solve_heat_3D",
            "solve_heat_3D_spherical", "solve_heat_1D_cylindrical",
            "solve_heat_1D_spherical", "solve_heat_2D_cylindrical",
            "solve_heat_2D_spherical", "solve_elasticity_1D_static",
            "solve_elasticity_2D_static", "solve_elasticity_3D_static",
            "solve_elasticity_3D_dynamic",
            "solve_wave_1D", "solve_wave_2D", "solve_wave_3D",
            "solve_heat_1D_mixed", "solve_heat_2D_mixed",
            "solve_heat_3D_mixed", "solve_heat_radial_mixed",
            "solve_elasticity_1D_loaded", "solve_elasticity_2D_loaded",
            "solve_elasticity_3D_loaded",
            "solve_advection_1D", "solve_advection_2D", "solve_advection_3D",
            "solve_elasticity_2D_modal", "solve_elasticity_3D_modal",
            "solve_heat_1D_nonlinear", "solve_heat_2D_nonlinear",
            "plot_time_series_field_from_file", "plot_time_series_field",
        )]

    async def tool_names(self) -> list:
        return list(self._names)

    async def call(self, name: str, args: Dict[str, Any]) -> Any:
        if name not in self._names:
            raise ValueError(f"Unknown tool {name}")
        result = getattr(self._api, name)(**args)
        if dataclasses.is_dataclass(result):
            return dataclasses.asdict(result)
        return result


class MCPToolSet(ToolSet):
    """Tools served by an MCP stdio subprocess (pde_solver_tpu_torch.mcp.client)."""

    def __init__(self, server_cmd=None):
        from pde_solver_tpu_torch.mcp.client import StdioMCPClient
        self._client = StdioMCPClient(server_cmd)

    async def tool_names(self) -> list:
        return [t["name"] for t in await self._client.list_tools()]

    async def call(self, name: str, args: Dict[str, Any]) -> Any:
        return await self._client.call_tool(name, args)


def _extract_value(obj: Any, target_key: str) -> Optional[Any]:
    """Recursively pull a key out of nested dicts/lists/objects — tolerant of
    wrapper layers MCP clients add (reference dispatcher_agent.py:1255-1319)."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        for key, val in obj.items():
            if str(key).lower() == target_key.lower():
                return val
        for wrapper in ("content", "result", "data", "output", "response"):
            if wrapper in obj and isinstance(obj[wrapper], (dict, list)):
                found = _extract_value(obj[wrapper], target_key)
                if found is not None:
                    return found
        for val in obj.values():
            found = _extract_value(val, target_key)
            if found is not None:
                return found
        return None
    if isinstance(obj, (list, tuple)):
        for item in obj:
            found = _extract_value(item, target_key)
            if found is not None:
                return found
        return None
    if isinstance(obj, str):
        try:
            return _extract_value(json.loads(obj), target_key)
        except (json.JSONDecodeError, ValueError):
            return None
    if hasattr(obj, target_key):
        return getattr(obj, target_key)
    if hasattr(obj, "__dict__"):
        return _extract_value(vars(obj), target_key)
    return None


def normalize_geometry(params: PDEParameters) -> str:
    """Geometry alias normalization + inference (dispatcher_agent.py:117-146)."""
    g = (params.geometry_type or "").lower()
    if g in _BOX_ALIASES:
        return "box"
    if g in _CYL_ALIASES:
        return "cylinder"
    if g in _SPH_ALIASES:
        return "sphere"
    if g:
        return "box"
    if params.coordinate_system:
        cs = str(params.coordinate_system).lower()
        if cs == "cylindrical":
            return "cylinder"
        if cs == "spherical":
            return "sphere"
        return "box"
    domain = params.domain_size or {}
    has_r = "r1" in domain or "r2" in domain
    if has_r and "h" in domain:
        return "cylinder"
    if has_r:
        return "sphere"
    return "box"


def _time_defaults(params: PDEParameters, char_len: float) -> Tuple[float, int]:
    """dt/num_steps heuristics (dispatcher_agent.py:393-404)."""
    dt, num_steps = params.dt, params.num_steps
    if dt is None or num_steps is None:
        k = params.diffusivity or 1.0
        t_char = char_len ** 2 / (2 * k) if k > 0 else 0.1
        if dt is None:
            dt = min(t_char / 200, 0.01)
        if num_steps is None:
            if params.total_time:
                num_steps = max(int(params.total_time / dt), 100) if dt > 0 else 200
            else:
                num_steps = max(int(t_char / dt), 200) if dt > 0 else 200
    return (dt or 0.01), (num_steps or 200)


def _common_heat_args(params: PDEParameters) -> Dict[str, Any]:
    initial_type = params.initial_type or "constant"
    if initial_type == "constant":
        T_initial = params.initial_value
    elif initial_type == "zero":
        T_initial = 0.0
    else:
        T_initial = params.initial_value if params.initial_value is not None else 0.0
    return {
        "steady": params.steady if params.steady is not None else False,
        "source_type": params.source_type or "none",
        "source_value": params.source_value if params.source_value is not None else 0.0,
        "initial_type": initial_type,
        "initial_amplitude": (params.initial_amplitude
                              if params.initial_amplitude is not None else 1.0),
        "_T_initial": T_initial,
    }


# legacy directional Dirichlet keys → mixed-tool face names
_TFACE_TO_FACE = {"T_left": "left", "T_right": "right", "T_side": "sides",
                  "T_top": "top", "T_bottom": "bottom", "T_front": "front",
                  "T_back": "back", "T_boundary": "all",
                  "T_inner": "inner", "T_outer": "outer"}


def _mixed_bc_spec(params: PDEParameters) -> Optional[Dict[str, Any]]:
    """Normalized per-face BC spec when the query needs the *_mixed tools.

    Returns None for pure-Dirichlet queries (reference-compatible routing
    unchanged).  A query is "mixed" when bc_values carries any typed face
    spec ({"type": "robin"|"neumann"|"insulated", ...} — the parser emits
    these for convective/flux/insulated phrasing) or when bc_type itself is
    robin/neumann/mixed.  Dirichlet entries (typed, face-keyed numbers, or
    legacy T_left-style keys) are folded into the same spec dict.
    """
    bc = params.bc_values or {}
    has_typed = any(isinstance(v, dict) and v.get("type") for v in bc.values())
    if not has_typed and (params.bc_type or "dirichlet") not in (
            "robin", "neumann", "mixed"):
        return None
    radial = (params.dim == 1
              and normalize_geometry(params) in ("cylinder", "sphere"))
    all_faces = (["outer", "inner"] if radial else
                 {1: ["left", "right"],
                  2: ["left", "right", "bottom", "top"],
                  3: ["left", "right", "front", "back", "bottom", "top"],
                  }.get(params.dim, ["left", "right"]))

    def expand(name: str):
        """Group names → concrete faces, so precedence works per PHYSICAL
        face (a quench rule's T_outer and a convective 'all' spec must
        collide, not coexist under different keys)."""
        if name in ("all", "boundary", "everywhere", "surface"):
            return list(all_faces)
        if name in ("sides", "side", "lateral", "walls"):
            return (["outer"] if radial else
                    [f for f in all_faces if f not in ("left", "right")])
        return [name]

    spec: Dict[str, Any] = {}
    # precedence (lowest → highest): legacy Dirichlet numbers, then typed
    # GROUP specs ("sides"/"all"), then typed specs on specifically-named
    # faces — "bottom at 25 C, other faces insulated" must keep the bottom
    # Dirichlet even though the sides group expands over bottom too
    for k, v in bc.items():
        if isinstance(v, (int, float)):
            for face in expand(_TFACE_TO_FACE.get(k, str(k).lower())):
                spec[face] = {"type": "dirichlet", "value": float(v)}
    typed = [(expand(_TFACE_TO_FACE.get(k, str(k).lower())), v)
             for k, v in bc.items()
             if isinstance(v, dict) and v.get("type")]
    for faces, v in sorted(typed, key=lambda fv: -len(fv[0])):
        for face in faces:
            spec[face] = v
    return spec or None


def _bc_get(bc: Dict[str, Any], *keys, default=None):
    """Case/format-tolerant BC lookup preserving explicit 0.0 values
    (dispatcher_agent.py:356-386)."""
    for k in keys:
        for variant in (k, k.lower(), k.capitalize(), k.upper(),
                        k + "_boundary", k.lower() + "_boundary"):
            if variant in bc:
                return bc[variant]
    return default


class DispatcherAgent:
    """Deterministic router from PDEParameters to solver + plot tool calls."""

    def __init__(self, toolset: Optional[ToolSet] = None, llm=None):
        self.toolset = toolset or LocalToolSet()
        self.llm = llm  # kept for interface parity; routing never uses it

    # ------------------------------------------------------------------
    # Routing (pure — unit-testable without tool execution)
    # ------------------------------------------------------------------

    def route(self, params: PDEParameters) -> Tuple[str, Dict[str, Any]]:
        if params.pde_type == "poisson":
            # Poisson/Laplace −κΔu = f IS the steady diffusion problem —
            # route onto the steady heat family (extension: the reference's
            # schema names the type but its dispatcher cannot route it)
            params = dataclasses.replace(params, pde_type="heat",
                                         steady=True)
        if params.pde_type == "heat":
            geometry = normalize_geometry(params)
            # Robin/Neumann/insulated faces route to the *_mixed extension
            # tools (the reference's tools are Dirichlet-only): per-face
            # Cartesian tools, or the radial tool for 1D shells (convective
            # quenching).  Pure-Dirichlet queries keep the reference routes.
            mixed = _mixed_bc_spec(params)
            # nonlinear κ(T): steady Cartesian 1D/2D queries with the
            # parser's nonlinear_kappa note route to the Picard tools
            if "nonlinear_kappa" in (params.notes or []):
                if (params.steady and params.dim in (1, 2)
                        and geometry not in ("cylinder", "sphere")
                        and not mixed):
                    return (f"solve_heat_{params.dim}D_nonlinear",
                            self._heat_nonlinear_args(params))
                # honest fallthrough instead of silently dropping beta
                # (r5 battery-19): the Picard tools cover steady Cartesian
                # 1D/2D only
                params.notes.append(
                    "temperature-dependent conductivity requested - the "
                    "nonlinear Picard solver covers steady Cartesian 1D/2D "
                    "only; this solve uses constant kappa0")
            if params.dim == 1:
                if geometry in ("cylinder", "sphere"):
                    if mixed:
                        return ("solve_heat_radial_mixed",
                                self._radial_mixed_args(params, geometry,
                                                        mixed))
                if geometry == "cylinder":
                    return "solve_heat_1D_cylindrical", self._radial_args(params, "cylinder")
                if geometry == "sphere":
                    return "solve_heat_1D_spherical", self._radial_args(params, "sphere")
                if mixed:
                    return ("solve_heat_1D_mixed",
                            self._heat_mixed_args(params, 1, mixed))
                return "solve_heat_1D", self._heat_1d_args(params)
            if params.dim == 2:
                if geometry == "cylinder":
                    return "solve_heat_2D_cylindrical", self._heat_2d_cyl_args(params)
                if geometry == "sphere":
                    return "solve_heat_2D_spherical", self._heat_2d_sph_args(params)
                if mixed:
                    return ("solve_heat_2D_mixed",
                            self._heat_mixed_args(params, 2, mixed))
                return "solve_heat_2D", self._heat_2d_args(params)
            if params.dim == 3:
                if geometry == "sphere":
                    return "solve_heat_3D_spherical", self._heat_3d_sph_args(params)
                if mixed and geometry != "cylinder":
                    # 3D cylinders keep the reference tool (its r-weighted
                    # box embedding has no per-face mixed analog yet)
                    return ("solve_heat_3D_mixed",
                            self._heat_mixed_args(params, 3, mixed))
                return "solve_heat_3D", self._heat_3d_args(params, geometry)
            raise ValueError(f"Unsupported dimension: {params.dim}")
        if params.pde_type == "elasticity":
            # Modal analysis beats dynamics when both cues fire ("vibration
            # modes" contains a vibration word): an explicit "modal" note
            # routes to the eigen tool.
            if "modal" in (params.notes or []):
                if params.dim == 2:
                    return ("solve_elasticity_2D_modal",
                            self._elast_modal_args(params, dim=2))
                return ("solve_elasticity_3D_modal",
                        self._elast_modal_args(params))
            # Dynamics is OPT-IN via an explicit "dynamic" note (set by the
            # parser only for vibration/oscillation/dynamic phrasing) so
            # every query the reference handles still routes to the static
            # solvers (its elasticity is static-only).
            if params.dim == 3 and "dynamic" in (params.notes or []):
                return ("solve_elasticity_3D_dynamic",
                        self._elast_3d_dynamic_args(params))
            loads = self._load_spec(params)
            if loads and params.dim in (1, 2, 3):
                return (f"solve_elasticity_{params.dim}D_loaded",
                        self._elast_loaded_args(params, loads))
            name = f"solve_elasticity_{params.dim}D_static"
            builder = {1: self._elast_1d_args, 2: self._elast_2d_args,
                       3: self._elast_3d_args}.get(params.dim)
            if builder is None:
                raise ValueError(f"Unsupported dimension: {params.dim}")
            return name, builder(params)
        if params.pde_type == "wave":
            # Extension beyond the reference: its parser emits
            # pde_type="wave" (pde_parser_agent.py:205) but its dispatcher
            # routes nothing for it — every wave query errors out.  Here
            # they solve on Cartesian domains (curvilinear wave geometries
            # are treated as their bounding box).
            if params.dim not in (1, 2, 3):
                raise ValueError(f"Unsupported dimension: {params.dim}")
            return (f"solve_wave_{params.dim}D",
                    self._wave_args(params, params.dim))
        if params.pde_type == "advection":
            # Extension beyond the reference: its schema lists
            # pde_type="advection" but its dispatcher has no route.
            if params.dim not in (1, 2, 3):
                raise ValueError(f"Unsupported dimension: {params.dim}")
            return (f"solve_advection_{params.dim}D",
                    self._advection_args(params))
        raise ValueError(
            "Currently only 'heat', 'elasticity', 'wave' and 'advection' "
            f"PDE types are supported, got: {params.pde_type}")

    # ----- heat arg builders -----

    def _heat_1d_args(self, params: PDEParameters) -> Dict[str, Any]:
        domain = params.domain_size or {}
        length = None
        for key in ("length", "Length", "L", "l"):
            if key in domain:
                length = domain[key]
                break
        if length is None and isinstance(domain.get("domain_size"), (int, float)):
            length = float(domain["domain_size"])
        length = float(length) if length is not None else 2.0
        bc = params.bc_values or {}
        common = _common_heat_args(params)
        dt, num_steps = _time_defaults(params, length)
        return {
            "length": length, "nx": params.nx or 50,
            "diffusivity": params.diffusivity or 1.0,
            "T_left": _bc_get(bc, "T_left", "left", default=20.0),
            "T_right": _bc_get(bc, "T_right", "right", default=0.0),
            "T_initial": common["_T_initial"] if common["_T_initial"] is not None else 0.0,
            "dt": dt, "num_steps": num_steps, "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
            "initial_wavenumber": (params.initial_wavenumber
                                   if params.initial_wavenumber is not None else 1.0),
        }

    @staticmethod
    def _domain_xy(domain: Dict[str, Any]) -> Tuple[float, float]:
        if isinstance(domain.get("domain_size"), (int, float)):
            s = float(domain["domain_size"])
            return s, s
        Lx = (domain.get("Lx") or domain.get("lx") or domain.get("width")
              or domain.get("Width") or domain.get("W") or 1.0)
        Ly = (domain.get("Ly") or domain.get("ly") or domain.get("height")
              or domain.get("Height") or domain.get("H") or 1.0)
        return float(Lx), float(Ly)

    def _heat_2d_args(self, params: PDEParameters) -> Dict[str, Any]:
        domain = params.domain_size or {}
        Lx, Ly = self._domain_xy(domain)
        bc = params.bc_values or {}
        common = _common_heat_args(params)
        dt, num_steps = _time_defaults(params, (Lx + Ly) / 2)
        T_initial = common["_T_initial"]
        if common["initial_type"] == "constant" and T_initial is None:
            T_initial = 20.0
        return {
            "Lx": Lx, "Ly": Ly, "nx": params.nx or 30, "ny": params.ny or 30,
            "diffusivity": params.diffusivity or 1.0,
            "T_boundary": _bc_get(bc, "T_boundary", default=0.0),
            "T_initial": T_initial if T_initial is not None else 0.0,
            "dt": dt, "num_steps": num_steps, "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
            "initial_wavenumber": (params.initial_wavenumber
                                   if params.initial_wavenumber is not None else 1.0),
        }

    def _heat_3d_args(self, params: PDEParameters, geometry: str) -> Dict[str, Any]:
        domain = params.domain_size or {}
        gp = params.geometry_params or {}
        bc = params.bc_values or {}
        has_cyl_notation = ("r1" in domain or "r2" in domain) and "h" in domain

        if isinstance(domain.get("domain_size"), (int, float)):
            s = float(domain["domain_size"])
            Lx = Ly = Lz = s
        elif geometry == "cylinder":
            if has_cyl_notation:
                r2 = domain.get("r2")
                h = domain.get("h")
                if r2 is None:
                    raise ValueError(
                        "For cylindrical geometry, domain_size must contain 'r2' (outer radius)")
                if h is None:
                    raise ValueError(
                        "For cylindrical geometry, domain_size must contain 'h' (height)")
                Lx, Ly, Lz = float(h), float(r2 * 2), float(r2 * 2)
            else:
                # axial extent: explicit Lx, else the parsed cylinder
                # height (the reference's h → axis length mapping above)
                Lx = float(domain.get("Lx") or domain.get("h") or 2.0)
                r2 = (gp.get("cylinder_radius") or gp.get("r2")
                      or gp.get("r_outer") or 0.5)
                Ly = Lz = float(r2 * 2)
        else:
            Lx, Ly = self._domain_xy(domain)
            Lz = float(domain.get("Lz") or domain.get("lz") or domain.get("depth")
                       or domain.get("Depth") or domain.get("D") or 1.0)

        common = _common_heat_args(params)
        dt, num_steps = _time_defaults(params, (Lx + Ly + Lz) / 3)
        T_initial = common["_T_initial"]
        if common["initial_type"] == "constant" and T_initial is None:
            T_initial = 20.0
        args: Dict[str, Any] = {
            "Lx": Lx, "Ly": Ly, "Lz": Lz,
            "nx": params.nx or 10, "ny": params.ny or 10, "nz": params.nz or 10,
            "diffusivity": params.diffusivity or 1.0,
            "T_boundary": _bc_get(bc, "T_boundary", default=0.0),
            "T_initial": T_initial if T_initial is not None else 0.0,
            "dt": dt, "num_steps": num_steps, "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
            "initial_wavenumber": (params.initial_wavenumber
                                   if params.initial_wavenumber is not None else 1.0),
        }
        if geometry == "cylinder":
            args["geometry_type"] = "cylinder"
            r1 = domain.get("r1", 0.0) if has_cyl_notation else None
            if has_cyl_notation:
                r2 = domain.get("r2")
                args["Lx"] = float(domain.get("h"))
                args["cylinder_radius"] = float(r2)
            else:
                r2 = (gp.get("cylinder_radius") or gp.get("r_outer")
                      or gp.get("r2") or gp.get("radius") or 0.5)
                args["cylinder_radius"] = float(r2)
            for bc_key, arg_key in (("T_left", "T_left"), ("T_right", "T_right"),
                                    ("T_side", "T_side")):
                val = _bc_get(bc, bc_key)
                if val is not None:
                    args[arg_key] = val
            # composite core: core_radius = r1 for hollow cylinders, else a
            # 30% default (dispatcher_agent.py:730-758)
            if params.core_diffusivity is not None:
                if params.core_radius is not None:
                    args["core_radius"] = float(params.core_radius)
                elif r1 is not None and r1 > 0.0:
                    args["core_radius"] = float(r1)
                elif r2 is not None:
                    args["core_radius"] = float(r2) * 0.3
                else:
                    args["core_radius"] = 0.1
                args["core_diffusivity"] = float(params.core_diffusivity)
        else:
            args["geometry_type"] = "box"
        return args

    @staticmethod
    def _load_spec(params: PDEParameters) -> Optional[Dict[str, Any]]:
        """Per-face surface-load specs (force/traction/pressure/force_axial)
        from bc_values — routes to the solve_elasticity_*_loaded extension
        tools; None keeps the reference's body-force-only routing."""
        bc = params.bc_values or {}
        out = {k: v for k, v in bc.items()
               if isinstance(v, dict) and str(v.get("type", "")).lower()
               in ("force", "traction", "pressure", "force_axial")}
        return out or None

    def _elast_loaded_args(self, params: PDEParameters,
                           loads: Dict[str, Any]) -> Dict[str, Any]:
        if params.dim == 1:
            args = self._elast_1d_args(params)
            end = 0.0
            area = float((params.material_params or {}).get("area", 1.0))
            for spec in loads.values():
                kind = str(spec.get("type", "")).lower()
                if kind == "force_axial":
                    end += float(spec.get("value", 0.0))
                elif kind == "force":
                    vec = list(spec.get("vector", [0.0]))
                    end += float(vec[0]) if vec else 0.0
                elif kind in ("traction", "pressure"):
                    # an axial STRESS on the bar end: F = sigma * A (the
                    # default unit cross-section makes end_load = sigma,
                    # the bar solver's own normalization)
                    if kind == "traction":
                        vec = list(spec.get("vector", [0.0]))
                        sig = float(vec[0]) if vec else 0.0
                    else:
                        sig = -float(spec.get("value", 0.0))
                    end += sig * area
            args["end_load"] = end
            return args
        builder = {2: self._elast_2d_args, 3: self._elast_3d_args}[params.dim]
        args = builder(params)
        d = params.dim
        args["loads"] = {
            face: ({"type": "force",
                    "vector": [float(spec.get("value", 0.0))] + [0.0] * (d - 1)}
                   if str(spec.get("type", "")).lower() == "force_axial"
                   else spec)
            for face, spec in loads.items()}
        return args

    def _elast_modal_args(self, params: PDEParameters,
                          dim: int = 3) -> Dict[str, Any]:
        domain = params.domain_size or {}
        Lx, Ly = self._domain_xy(domain)
        if not domain:
            Lx, Ly = 1.0, 0.2  # default slender beam
        mp = params.material_params or {}
        args: Dict[str, Any] = {
            "Lx": float(domain.get("Lx") or domain.get("length")
                        or domain.get("L") or Lx),
            "Ly": Ly if domain else 0.2,
            "nx": params.nx or (16 if dim == 3 else 24),
            "ny": params.ny or 6,
            "E": params.young_modulus if params.young_modulus is not None
            else 210e9,
            "nu": params.poisson_ratio if params.poisson_ratio is not None
            else 0.3,
            "rho": params.density if params.density is not None else 7800.0,
            "num_modes": int(mp.get("num_modes", 4)), "data_dir": "data",
        }
        if dim == 3:
            Lz = float(domain.get("Lz") or domain.get("lz")
                       or domain.get("depth")
                       or (0.2 if not domain else Ly))
            args["Lz"] = Lz
            args["nz"] = params.nz or 6
        else:
            ps = mp.get("plane_stress")
            args["plane_stress"] = True if ps is None else bool(ps)
        return args

    def _heat_nonlinear_args(self, params: PDEParameters) -> Dict[str, Any]:
        mp = params.material_params or {}
        beta = float(mp.get("beta", 0.01))
        kappa0 = params.diffusivity if params.diffusivity is not None else 1.0
        if params.dim == 1:
            args = self._heat_1d_args(params)
            keep = {k: args[k] for k in ("length", "nx", "T_left",
                                         "T_right", "source_type",
                                         "source_value", "data_dir")}
            keep["T_initial"] = 0.5 * (keep["T_left"] + keep["T_right"])
        else:
            args = self._heat_2d_args(params)
            keep = {k: args[k] for k in ("Lx", "Ly", "nx", "ny",
                                         "T_boundary", "source_type",
                                         "source_value", "data_dir")}
            t_left = _bc_get(params.bc_values or {}, "T_left", "left")
            if t_left is not None:
                keep["T_left"] = float(t_left)
            keep["T_initial"] = keep["T_boundary"]
        keep["kappa0"] = float(kappa0)
        keep["beta"] = beta
        return keep

    def _heat_mixed_args(self, params: PDEParameters, dim: int,
                         spec: Dict[str, Any]) -> Dict[str, Any]:
        """Args for the solve_heat_*_mixed extension tools: the matching
        Cartesian builder's sizes/stepping with the Dirichlet-specific keys
        replaced by the per-face boundary_conditions spec."""
        if dim == 1:
            args = self._heat_1d_args(params)
            args.pop("T_left", None)
            args.pop("T_right", None)
        elif dim == 2:
            args = self._heat_2d_args(params)
            args.pop("T_boundary", None)
        else:
            args = self._heat_3d_args(params, "box")
            for k in ("T_boundary", "T_left", "T_right", "T_side",
                      "geometry_type", "cylinder_radius"):
                args.pop(k, None)
            # composite cores are a solve_heat_3D feature; keep mixed tools
            # box-homogeneous (route() only sends geometry == "box" here)
            args.pop("core_radius", None)
            args.pop("core_diffusivity", None)
        args["boundary_conditions"] = spec
        return args

    def _radial_mixed_args(self, params: PDEParameters, kind: str,
                           spec: Dict[str, Any]) -> Dict[str, Any]:
        """Args for solve_heat_radial_mixed: the radial builder's geometry/
        stepping with inner/outer Dirichlet keys folded into the spec."""
        args = self._radial_args(params, kind)
        # only explicitly-parsed Dirichlet values enter the spec (the radial
        # builder's 100/20 defaults must not override typed faces)
        bc = params.bc_values or {}
        for key, face in (("T_inner", "inner"), ("T_outer", "outer")):
            if key in bc and face not in spec:
                spec[face] = {"type": "dirichlet", "value": float(bc[key])}
        args.pop("T_inner", None)
        args.pop("T_outer", None)
        for k in ("initial_type", "initial_amplitude"):
            args.pop(k, None)  # radial_mixed keeps the constant-IC contract
        args["kind"] = kind
        args["boundary_conditions"] = spec
        return args

    def _radial_args(self, params: PDEParameters, kind: str) -> Dict[str, Any]:
        gp = params.geometry_params or {}
        bc = params.bc_values or {}
        radius_key = "cylinder_radius" if kind == "cylinder" else "sphere_radius"
        r_inner = gp.get("r_inner") or 0.0
        r_outer = gp.get("r_outer") or gp.get(radius_key) or gp.get("radius") or 1.0
        common = _common_heat_args(params)
        return {
            "r_inner": float(r_inner), "r_outer": float(r_outer),
            "nr": params.nx or 50,
            "diffusivity": params.diffusivity or 1.0,
            "T_inner": _bc_get(bc, "T_inner", "T_boundary", default=100.0),
            "T_outer": _bc_get(bc, "T_outer", "T_boundary", default=20.0),
            "T_initial": (params.initial_value
                          if params.initial_value is not None else 20.0),
            "dt": params.dt or 0.01, "num_steps": params.num_steps or 50,
            "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
        }

    def _heat_2d_cyl_args(self, params: PDEParameters) -> Dict[str, Any]:
        domain = params.domain_size or {}
        gp = params.geometry_params or {}
        bc = params.bc_values or {}
        common = _common_heat_args(params)
        return {
            "r_inner": float(gp.get("r_inner") or 0.0),
            "r_outer": float(gp.get("r_outer") or gp.get("cylinder_radius")
                             or gp.get("radius") or 1.0),
            "z_length": float(domain.get("Lx") or domain.get("length")
                              or domain.get("L") or domain.get("h") or 2.0),
            "nr": params.nx or 30, "nz": params.ny or 30,
            "diffusivity": params.diffusivity or 1.0,
            "T_boundary": _bc_get(bc, "T_boundary", default=20.0),
            "T_initial": (params.initial_value
                          if params.initial_value is not None else 20.0),
            "dt": params.dt or 0.01, "num_steps": params.num_steps or 50,
            "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
        }

    def _heat_2d_sph_args(self, params: PDEParameters) -> Dict[str, Any]:
        gp = params.geometry_params or {}
        bc = params.bc_values or {}
        common = _common_heat_args(params)
        return {
            "r_inner": float(gp.get("r_inner") or 0.0),
            "r_outer": float(gp.get("r_outer") or gp.get("sphere_radius")
                             or gp.get("radius") or 1.0),
            "nr": params.nx or 30, "ntheta": params.ny or 30,
            "diffusivity": params.diffusivity or 1.0,
            "T_boundary": _bc_get(bc, "T_boundary", default=20.0),
            "T_initial": (params.initial_value
                          if params.initial_value is not None else 20.0),
            "dt": params.dt or 0.01, "num_steps": params.num_steps or 50,
            "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
        }

    def _heat_3d_sph_args(self, params: PDEParameters) -> Dict[str, Any]:
        gp = params.geometry_params or {}
        domain = params.domain_size or {}
        bc = params.bc_values or {}
        common = _common_heat_args(params)
        r_outer = (gp.get("r_outer") or gp.get("sphere_radius") or gp.get("radius")
                   or domain.get("r2") or 1.0)
        r_inner = gp.get("r_inner") or domain.get("r1") or 0.0
        return {
            "r_inner": float(r_inner), "r_outer": float(r_outer),
            "nr": params.nx or 20, "ntheta": params.ny or 20, "nphi": params.nz or 20,
            "diffusivity": params.diffusivity or 1.0,
            "T_boundary": _bc_get(bc, "T_boundary", default=20.0),
            "T_initial": (params.initial_value
                          if params.initial_value is not None else 20.0),
            "dt": params.dt or 0.01, "num_steps": params.num_steps or 50,
            "data_dir": "data",
            "steady": common["steady"], "source_type": common["source_type"],
            "source_value": common["source_value"],
            "initial_type": common["initial_type"],
            "initial_amplitude": common["initial_amplitude"],
        }

    # ----- wave arg builder (extension tools) -----

    def _advection_args(self, params: PDEParameters) -> Dict[str, Any]:
        """Args for the solve_advection_*D extension tools: velocity from
        material_params (vx/vy/vz or scalar velocity = +x flow), CFL-aware
        dt default (0.4·h/|v|), transit-time horizon."""
        dim = params.dim
        domain = params.domain_size or {}
        mp = params.material_params or {}
        args: Dict[str, Any] = {}
        if dim == 1:
            length = None
            for key in ("length", "Length", "L", "l"):
                if key in domain:
                    length = float(domain[key])
                    break
            length = length if length is not None else 2.0
            nx = params.nx or 200
            args.update({"length": length, "nx": nx})
            sizes, cells = [length], [nx]
        elif dim == 2:
            Lx, Ly = self._domain_xy(domain)
            nx, ny = params.nx or 60, params.ny or 60
            args.update({"Lx": Lx, "Ly": Ly, "nx": nx, "ny": ny})
            sizes, cells = [Lx, Ly], [nx, ny]
        else:
            Lx, Ly = self._domain_xy(domain)
            Lz = float(domain.get("Lz") or domain.get("lz")
                       or domain.get("depth") or 1.0)
            nx, ny, nz = params.nx or 24, params.ny or 24, params.nz or 24
            args.update({"Lx": Lx, "Ly": Ly, "Lz": Lz,
                         "nx": nx, "ny": ny, "nz": nz})
            sizes, cells = [Lx, Ly, Lz], [nx, ny, nz]
        vel = [float(mp.get(k, 0.0)) for k in ("vx", "vy", "vz")][:dim]
        if not any(vel):
            vel[0] = float(mp.get("velocity", params.wave_speed or 1.0))
        if dim == 1:
            args["velocity"] = vel[0]
        else:
            for k, val in zip(("vx", "vy", "vz"), vel):
                args[k] = val
        speed = float(sum(v * v for v in vel)) ** 0.5 if any(vel) else 1.0
        h_min = min(s / c for s, c in zip(sizes, cells))
        kappa = params.diffusivity if params.diffusivity is not None else 0.01
        dt = params.dt if params.dt is not None else \
            max(min(0.4 * h_min / speed, 0.01), 1e-5)
        if params.num_steps is not None:
            num_steps = params.num_steps
        elif params.total_time and dt > 0:
            num_steps = max(int(params.total_time / dt), 10)
        else:
            # default horizon: half a domain transit
            num_steps = int(min(max(0.5 * sizes[0] / (speed * dt), 50), 400))
        args.update({
            "diffusivity": kappa,
            "T_boundary": _bc_get(params.bc_values or {}, "T_boundary",
                                  default=0.0),
            "T_initial": (params.initial_value
                          if params.initial_value is not None else 0.0),
            "initial_type": ("gaussian" if (params.initial_type or
                             "gaussian") not in ("constant", "zero")
                             else params.initial_type),
            "pulse_width": float(mp.get("pulse_width", 0.1)),
            "pulse_amplitude": (params.initial_amplitude
                                if params.initial_amplitude is not None
                                else 1.0),
            "dt": dt, "num_steps": num_steps, "data_dir": "data",
            "source_type": params.source_type or "none",
            "source_value": params.source_value or 0.0,
        })
        if dim == 3:
            args.pop("pulse_center", None)
        return args

    def _wave_args(self, params: PDEParameters, dim: int) -> Dict[str, Any]:
        domain = params.domain_size or {}
        c = float(params.wave_speed or 1.0)
        bc = params.bc_values or {}
        args: Dict[str, Any] = {}
        if dim == 1:
            length = None
            for key in ("length", "Length", "L", "l"):
                if key in domain:
                    length = float(domain[key])
                    break
            if length is None and isinstance(domain.get("domain_size"),
                                             (int, float)):
                length = float(domain["domain_size"])
            length = length if length is not None else 2.0
            args.update({"length": length, "nx": params.nx or 50})
            char_len = length
        elif dim == 2:
            Lx, Ly = self._domain_xy(domain)
            args.update({"Lx": Lx, "Ly": Ly, "nx": params.nx or 30,
                         "ny": params.ny or 30})
            char_len = min(Lx, Ly)
        else:
            Lx, Ly = self._domain_xy(domain)
            Lz = float(domain.get("Lz") or domain.get("lz")
                       or domain.get("depth") or domain.get("Depth")
                       or domain.get("D") or 1.0)
            args.update({"Lx": Lx, "Ly": Ly, "Lz": Lz,
                         "nx": params.nx or 20, "ny": params.ny or 20,
                         "nz": params.nz or 20})
            char_len = min(Lx, Ly, Lz)
        # dt/num_steps: the wave timescale is the fundamental period
        # T = 2·char_len/c (not the heat L²/κ heuristic) — default 100
        # steps per period, two periods total.
        period = 2.0 * char_len / c if c > 0 else 1.0
        dt = params.dt if params.dt is not None else period / 100.0
        if params.num_steps is not None:
            num_steps = params.num_steps
        elif params.total_time and dt > 0:
            num_steps = max(int(params.total_time / dt), 10)
        else:
            num_steps = 200
        initial_type = params.initial_type or "sine"
        if initial_type not in ("constant", "zero", "cosine", "sine"):
            initial_type = "sine"
        args.update({
            "wave_speed": c,
            "boundary_value": _bc_get(bc, "u_boundary", "T_boundary",
                                      "boundary", default=0.0),
            "source_value": params.source_value or 0.0,
            "initial_type": initial_type,
            "initial_amplitude": (params.initial_amplitude
                                  if params.initial_amplitude is not None
                                  else 1.0),
            "initial_wavenumber": params.initial_wavenumber,
            "dt": dt, "num_steps": num_steps, "data_dir": "data",
        })
        return args

    # ----- elasticity arg builders -----

    @staticmethod
    def _quantity(params: PDEParameters) -> str:
        # "displacement" is an extension: the reference clamps the output
        # quantity to stress|strain (ref dispatcher_agent.py:1002-1005),
        # answering "deflection?" with von Mises stress
        q = (params.material_params or {}).get("quantity") or "stress"
        return q if q in ("stress", "strain", "displacement") else "stress"

    def _elast_1d_args(self, params: PDEParameters) -> Dict[str, Any]:
        domain = params.domain_size or {}
        L = None
        for key in ("length", "L", "l", "Length"):
            if key in domain:
                L = domain[key]
                break
        if L is None and isinstance(domain.get("domain_size"), (int, float)):
            L = float(domain["domain_size"])
        mp = params.material_params or {}
        return {
            "L": float(L) if L is not None else 1.0,
            "nx": params.nx or 50,
            "E": params.young_modulus if params.young_modulus is not None else 210e9,
            "area": mp.get("area") or mp.get("cross_sectional_area") or 1.0,
            "body_force": mp.get("body_force") or mp.get("body_force_x") or 0.0,
            "quantity": self._quantity(params),
            "data_dir": "data",
        }

    def _elast_2d_args(self, params: PDEParameters) -> Dict[str, Any]:
        domain = params.domain_size or {}
        Lx, Ly = self._domain_xy(domain)
        if "length" in domain and not any(
                k in domain for k in ("Lx", "lx", "width", "Width", "W")):
            # a 1D member upgraded to the bending plane ("a 3 m beam
            # carries ..."): the span is the stated length, the section
            # height defaults to a slender L/10 (r5 battery-23 — the
            # beam's length was silently dropped for a 1 m default)
            Lx = float(domain["length"])
            if not any(k in domain
                       for k in ("Ly", "ly", "height", "Height", "H")):
                Ly = Lx / 10.0
        mp = params.material_params or {}
        gravity = mp.get("gravity") or mp.get("apply_gravity") or False
        if gravity and mp.get("body_fy") is None and mp.get("body_force_y") is None:
            density = params.density if params.density is not None else 7800.0
            body_fy = -9.81 * density
            body_fx = mp.get("body_fx") or mp.get("body_force_x") or 0.0
        else:
            body_fx = mp.get("body_fx") or mp.get("body_force_x") or 0.0
            body_fy = mp.get("body_fy") or mp.get("body_force_y") or 0.0
        if mp.get("udl"):
            # distributed line load w [N/m] along the span, smeared over
            # the section height (unit thickness in plane stress) as a
            # gravity-like body-force density w/Ly [N/m³] (r5 battery-23)
            body_fy = body_fy - float(mp["udl"]) / max(Ly, 1e-12)
        plane_stress = mp.get("plane_stress")
        return {
            "Lx": Lx, "Ly": Ly, "nx": params.nx or 30, "ny": params.ny or 30,
            "E": params.young_modulus if params.young_modulus is not None else 210e9,
            "nu": params.poisson_ratio if params.poisson_ratio is not None else 0.3,
            "body_fx": body_fx, "body_fy": body_fy,
            "quantity": self._quantity(params),
            "plane_stress": True if plane_stress is None else bool(plane_stress),
            "data_dir": "data",
        }

    def _elast_3d_dynamic_args(self, params: PDEParameters) -> Dict[str, Any]:
        args = self._elast_3d_args(params)
        args.pop("quantity", None)
        args["rho"] = params.density if params.density is not None else 7800.0
        # dt/num_steps heuristics mirror the heat-solver defaults policy:
        # explicit values win; otherwise total_time spreads over 50 steps.
        num_steps = params.num_steps or 50
        if params.dt is not None:
            dt = params.dt
        elif params.total_time is not None:
            dt = params.total_time / num_steps
        else:
            dt = 1e-4
        args["dt"] = float(dt)
        args["num_steps"] = int(num_steps)
        return args

    def _elast_3d_args(self, params: PDEParameters) -> Dict[str, Any]:
        domain = params.domain_size or {}
        if any(k in domain for k in ("Lx", "lx", "width")):
            Lx, Ly = self._domain_xy(domain)
            Lz = float(domain.get("Lz") or domain.get("lz") or domain.get("depth")
                       or domain.get("Depth") or domain.get("D") or 1.0)
        elif isinstance(domain.get("domain_size"), (int, float)):
            Lx = Ly = Lz = float(domain["domain_size"])
        else:
            Lx = Ly = Lz = 1.0
        mp = params.material_params or {}
        gravity = mp.get("gravity") or mp.get("apply_gravity") or False
        body_fx = mp.get("body_fx") or mp.get("body_force_x") or 0.0
        body_fy = mp.get("body_fy") or mp.get("body_force_y") or 0.0
        if gravity:
            density = params.density if params.density is not None else 7800.0
            body_fz = mp.get("body_fz") or mp.get("body_force_z") or (-9.81 * density)
        else:
            body_fz = mp.get("body_fz") or mp.get("body_force_z") or 0.0
        return {
            "Lx": Lx, "Ly": Ly, "Lz": Lz,
            "nx": params.nx or 10, "ny": params.ny or 10, "nz": params.nz or 10,
            "E": params.young_modulus if params.young_modulus is not None else 210e9,
            "nu": params.poisson_ratio if params.poisson_ratio is not None else 0.3,
            "body_fx": body_fx, "body_fy": body_fy, "body_fz": body_fz,
            "quantity": self._quantity(params),
            "data_dir": "data",
        }

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    async def dispatch(self, pde_params: PDEParameters) -> Dict[str, Any]:
        """Solve + plot + summarize; error envelope on failure
        (reference dispatcher_agent.py:320-324)."""
        solver_args: Dict[str, Any] = {}
        try:
            solver_name, solver_args = self.route(pde_params)
            # Time-scheme opt-in (framework extension — the reference only
            # steps backward Euler): a "crank-nicolson" query rides the
            # parser's notes channel and flips SolverConfig.theta for this
            # solve.  In-process effect only (LocalToolSet); an external MCP
            # server opts in via PDE_TPU_TIME_SCHEME=crank_nicolson.
            wants_cn = any("crank_nicolson" in str(n)
                           for n in (pde_params.notes or []))
            if wants_cn:
                # contextvar-scoped override: a concurrent dispatch in the
                # same process keeps its own theta (no global mutation
                # around the await)
                from pde_solver_tpu_torch.config import config_overrides
                with config_overrides(theta=0.5):
                    solver_result = await self.toolset.call(solver_name,
                                                            solver_args)
            else:
                solver_result = await self.toolset.call(solver_name,
                                                        solver_args)
            if isinstance(solver_result, dict) and "error" in solver_result:
                raise ValueError(f"Solver returned an error: {solver_result['error']}")
            data_file = _extract_value(solver_result, "data_file")
            if not data_file:
                raise ValueError(
                    f"Solver did not return a data_file. Result: {solver_result!r:.500}")

            base = os.path.basename(str(data_file)).split(".")[0]
            prefix = f"{pde_params.pde_type}_{pde_params.dim}d_"
            unique = base[len(prefix):] if base.startswith(prefix) else base.split("_")[-1]
            plot_result = await self.toolset.call("plot_time_series_field_from_file", {
                "data_file": data_file,
                "field_name": None,  # read from artifact metadata
                "unit": None,
                "output_dir": "plots",
                "filename": f"{pde_params.pde_type}_{pde_params.dim}d_{unique}.html",
            })
            html_path = _extract_value(plot_result, "html_path")
            if not html_path:
                raise ValueError(f"Plot tool did not return html_path: {plot_result!r:.500}")
            return {
                "solver_result": solver_result,
                "plot_result": plot_result,
                "data_file": data_file,
                "html_path": html_path,
                "summary": self._generate_summary(pde_params, solver_result, plot_result),
            }
        except Exception as exc:  # structured error envelope, never raise
            return {"error": str(exc), "solver_args": solver_args}

    # ------------------------------------------------------------------

    @staticmethod
    def _generate_summary(params: PDEParameters, solver_result: Any,
                          plot_result: Any) -> str:
        """Human-readable simulation summary (dispatcher_agent.py:1146-1253)."""
        data_file = _extract_value(solver_result, "data_file") or "N/A"
        html_path = _extract_value(plot_result, "html_path") or "N/A"

        if params.pde_type == "heat":
            mode = "steady-state" if params.steady else "transient"
            material = f"Diffusivity: {params.diffusivity or 'default'}"
        elif params.pde_type == "wave":
            mode = "transient (Newmark)"
            material = f"Wave speed: {params.wave_speed or 'default'}"
        else:
            mode = ("dynamic (Newmark)" if "dynamic" in (params.notes or [])
                    else "static")
            E_str = (f"{params.young_modulus / 1e9:.1f} GPa"
                     if params.young_modulus else "default")
            nu_str = (f"{params.poisson_ratio}"
                      if params.poisson_ratio is not None else "default")
            material = f"Young's Modulus: {E_str}, Poisson's Ratio: {nu_str}"

        lines = [
            "Simulation Summary:",
            f"- PDE Type: {params.pde_type}",
            f"- Dimension: {params.dim}D",
            f"- Mode: {mode}",
            f"- Domain: {params.domain_size}",
            f"- Spatial Resolution: nx={params.nx or 'auto'}, "
            f"ny={params.ny or 'auto'}, nz={params.nz or 'auto'}",
            f"- Material Parameters: {material}",
            f"- Boundary Conditions: {params.bc_values if params.bc_values else 'default'}",
        ]
        if params.pde_type in ("heat", "wave"):
            if params.initial_type in ("cosine", "sine"):
                a = params.initial_amplitude if params.initial_amplitude is not None else 1.0
                k = params.initial_wavenumber if params.initial_wavenumber is not None else 1.0
                ic = f"{params.initial_type} (amplitude: {a}, wavenumber: {k})"
            elif params.initial_type == "zero":
                ic = "zero"
            elif params.initial_value is not None:
                ic = f"constant ({params.initial_value})"
            else:
                ic = "default"
            src = "none"
            if params.source_type and params.source_type != "none":
                src = f"{params.source_type} (value: {params.source_value})"
            elif params.source_value:
                src = f"constant (value: {params.source_value})"
            lines += [
                f"- Initial Condition: {ic}",
                f"- Source Term: {src}",
                f"- Time Step: {params.dt or 'auto'}, "
                f"Number of Steps: {params.num_steps or 'auto'}",
            ]
        else:
            mp = params.material_params or {}
            quantity = mp.get("quantity") or "stress"
            forces = [f"{ax}: {mp.get(key)}"
                      for ax, key in (("x", "body_fx"), ("y", "body_fy"), ("z", "body_fz"))
                      if mp.get(key)]
            if mp.get("gravity"):
                forces.append("gravity: on")
            if forces:
                lines.append(f"- Body Forces: {', '.join(forces)}")
            lines.append(f"- Output Quantity: {quantity}")
        # sentence-like notes (capability warnings, merge records) surface
        # to the user; single-token internal flags (modal/dynamic/...) stay
        # internal (r5 battery-19)
        for note in (params.notes or []):
            if " " in note:
                lines.append(f"- Note: {note}")
        lines += ["", "Results:", f"- Data file: {data_file}",
                  f"- Visualization: {html_path}"]
        # Surface a failed convergence to the NL user (VERDICT r2 weak #4:
        # previously nothing in the summary reflected converged=False).
        stats = _extract_value(solver_result, "solver_stats")
        if isinstance(stats, dict) and stats.get("converged") is False:
            relres = stats.get("relative_residual")
            tgt = stats.get("convergence_target")
            detail = ""
            if relres is not None:
                detail = f" (relative residual {relres:.2e}"
                detail += f", target {tgt:.0e})" if tgt else ")"
            lines.append(
                f"- WARNING: the solver did NOT reach its accuracy "
                f"target{detail}; treat the results as approximate.")
        return "\n".join(lines).strip()
