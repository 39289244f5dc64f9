"""PDE Parser Agent: natural language → :class:`PDEParameters`.

Capability parity with the reference parser (pde_parser_agent.py:755-1114):
one LLM call with a schema-describing system prompt, followed by defensive
normalization (key aliasing, nested-value unwrapping, composite-material
keyword detection, dataclass field filtering).  Two upgrades over the
reference:

* a deterministic **rule-based extractor** used when no LLM is configured
  (zero-network operation) and as the fallback when the LLM reply is
  unusable — the reference falls back to hard-coded defaults instead;
* unit handling (GPa/MPa, cm/mm) folded into normalization.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

from pde_solver_tpu_torch.agents.llm import ChatLLM, extract_json_block
from pde_solver_tpu_torch.schema import PDEParameters

PARSER_SYSTEM_PROMPT = """You convert natural-language PDE problem descriptions into a strict JSON object.

Output ONLY a JSON object (no prose) with any of these fields (omit unknown ones):
- pde_type: "heat" | "elasticity" (heat covers temperature/diffusion/conduction; elasticity covers stress/strain/displacement)
- dim: 1 | 2 | 3  (rod/bar → 1; plate/rectangle → 2; cube/box/full cylinder → 3; radial-only cylinder or sphere problems → 1)
- domain_size: object, e.g. {"length": 2.0} for 1D, {"Lx": 1.0, "Ly": 1.0} for 2D, {"Lx":1.0,"Ly":0.2,"Lz":0.2} for 3D boxes; cylinders may use {"r1": inner_radius, "r2": outer_radius, "h": height}; spheres {"r1":..., "r2":...}
- geometry_type: "box" | "cylinder" | "sphere"
- geometry_params: e.g. {"r_inner": 0.1, "r_outer": 1.0} or {"cylinder_radius": 0.5} or {"sphere_radius": 1.0}
- coordinate_system: "cartesian" | "cylindrical" | "spherical"
- nx, ny, nz: integer mesh resolutions
- diffusivity: number (heat)
- young_modulus: number in Pa; poisson_ratio: number; density: number (elasticity)
- material_params: object; may include {"area":..., "body_force":..., "body_fx":..., "body_fy":..., "body_fz":..., "gravity": true, "quantity": "stress"|"strain", "plane_stress": true|false}
- core_radius, core_diffusivity: numbers (composite material with high-conductivity core)
- bc_type: "dirichlet" (default)
- bc_values: object, e.g. {"T_left": 20.0, "T_right": 0.0} (1D), {"T_boundary": 0.0} (2D/3D uniform), {"T_inner":100,"T_outer":20} (radial), {"T_left":..., "T_right":..., "T_side":...} (directional 3D)
- initial_type: "constant" | "zero" | "cosine" | "sine"; initial_value, initial_amplitude, initial_wavenumber: numbers
- source_type: "none" | "constant"; source_value: number
- steady: true | false
- dt, total_time: numbers; num_steps: integer

Rules:
- Convert units to SI (GPa→Pa, cm→m). Temperatures stay in °C.
- "steady state"/"equilibrium" → steady=true; otherwise transient.
- If gravity is mentioned for elasticity set material_params.gravity=true.
- A high-conductivity core implies core_radius and core_diffusivity.
- Vibration/oscillation/dynamic phrasing for elasticity → pde_type
  "elasticity", steady=false, and notes=["dynamic"] (routes to the Newmark
  elastodynamics solver); "crank-nicolson"/"trapezoidal" stepping →
  notes=["time_scheme:crank_nicolson"].
- Do not invent values that are not stated or clearly implied.
"""

# canonical-key aliases (reference normalize_key, pde_parser_agent.py:18-110)
_KEY_ALIASES = {
    "pde": "pde_type", "type": "pde_type", "equation_type": "pde_type",
    "dimension": "dim", "dimensions": "dim", "spatial_dimension": "dim",
    "domain": "domain_size", "domainsize": "domain_size",
    "geometry": "geometry_type",
    "boundary_conditions": "bc_values", "boundary_values": "bc_values",
    "bcs": "bc_values", "bc": "bc_values",
    "initial_condition": "initial_value", "initial_temperature": "initial_value",
    "ic": "initial_value",
    "thermal_diffusivity": "diffusivity", "alpha": "diffusivity", "kappa": "diffusivity",
    "youngs_modulus": "young_modulus", "young_s_modulus": "young_modulus",
    "e_modulus": "young_modulus", "elastic_modulus": "young_modulus",
    "poissons_ratio": "poisson_ratio", "poisson_s_ratio": "poisson_ratio", "nu": "poisson_ratio",
    "time_step": "dt", "timestep": "dt",
    "n_steps": "num_steps", "number_of_steps": "num_steps", "nsteps": "num_steps",
    "steady_state": "steady",
    "source": "source_value", "heat_source": "source_value",
}

_NUMERIC_FIELDS = {
    "diffusivity", "young_modulus", "poisson_ratio", "density", "core_radius",
    "core_diffusivity", "initial_value", "initial_amplitude", "initial_wavenumber",
    "source_value", "dt", "total_time", "wave_speed",
}
_INT_FIELDS = {"dim", "nx", "ny", "nz", "num_steps"}
_DICT_FIELDS = {"domain_size", "geometry_params", "material_params", "bc_values"}


def _norm_key(key: str) -> str:
    k = re.sub(r"[^a-z0-9]+", "_", str(key).strip().lower()).strip("_")
    return _KEY_ALIASES.get(k, k)


def _unwrap(value: Any) -> Any:
    """Unwrap {"value": x} / {"magnitude": x} nests the LLM sometimes emits
    (reference unwrap_nested_structures, pde_parser_agent.py:113-152)."""
    if isinstance(value, dict):
        for probe in ("value", "magnitude", "amount"):
            if set(value.keys()) == {probe}:
                return _unwrap(value[probe])
        return {k: _unwrap(v) for k, v in value.items()}
    return value


def normalize_params_dict(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Alias keys, unwrap nests, coerce types, drop unknowns."""
    known = PDEParameters.field_names()
    out: Dict[str, Any] = {}
    for key, value in (raw or {}).items():
        k = _norm_key(key)
        if k not in known:
            continue
        v = _unwrap(value)
        try:
            if k in _NUMERIC_FIELDS and v is not None and not isinstance(v, (dict, list)):
                v = float(v)
            elif k in _INT_FIELDS and v is not None and not isinstance(v, (dict, list)):
                v = int(float(v))
            elif k in _DICT_FIELDS:
                if not isinstance(v, dict):
                    continue
                v = {str(kk): vv for kk, vv in v.items()}
            elif k == "steady" and isinstance(v, str):
                v = v.strip().lower() in ("true", "yes", "1", "steady")
        except (TypeError, ValueError):
            continue
        out[k] = v
    return out


# ----------------------------------------------------------------------
# Rule-based extraction (deterministic, zero-network)
# ----------------------------------------------------------------------

_NUM = r"([-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)"
# NOTE: every length-unit group below lists alternatives LONGEST FIRST with
# a \b inside the group — regex alternation is ordered, so "(m|cm|mm)"
# matches the bare "m" against the first letter of "mm" and the value
# silently keeps scale 1.0 ("200 mm" → 200.0 m) whenever nothing after the
# group forces backtracking.


def _unit_scale(unit: Optional[str]) -> float:
    u = (unit or "m").strip().lower()
    if u.startswith("milli"):
        return 1e-3
    if u.startswith("centi"):
        return 1e-2
    if u.startswith("kilo"):
        return 1e3
    return {"nm": 1e-9, "um": 1e-6, "µm": 1e-6,
            "micron": 1e-6, "microns": 1e-6,
            "mm": 1e-3, "cm": 1e-2,
            "m": 1.0, "meter": 1.0, "meters": 1.0, "metre": 1.0, "metres": 1.0,
            "km": 1e3}.get(u, 1.0)


def rule_based_parse(text: str) -> Dict[str, Any]:
    """Regex-driven extraction of PDEParameters fields from English text."""
    t = " " + text.lower().strip() + " "
    # Kelvin temperatures → Celsius up front so every downstream pattern
    # sees one temperature unit ("900 K cools in 300 K surroundings",
    # r5 battery-15).  The lookbehind rejects digits embedded in units
    # ("W/m2K" must not become a temperature); e-notation never matches
    # because its mantissa digit is letter-preceded.
    t = re.sub(r"(?<![\w/.^²³])(\d+(?:\.\d+)?)\s*°?\s*k(?:elvins?)?\b",
               lambda m: f"{float(m.group(1)) - 273.15:g} °c", t)
    # Fahrenheit likewise ("212 F" was silently read as 212 °C,
    # r5 battery-20); same embedded-digit protection
    t = re.sub(r"(?<![\w/.^²³])(-?\d+(?:\.\d+)?)\s*°?\s*"
               r"f(?:ahrenheit)?\b",
               lambda m: f"{(float(m.group(1)) - 32.0) * 5.0 / 9.0:g} °c", t)
    # spelled-out signs and halves: "minus 10 C" lost the BC entirely,
    # "a half-metre rod" lost the length (r5 battery-20)
    t = re.sub(r"\bminus\s+(\d)", r"-\1", t)
    t = re.sub(r"(?<!and a )\bhalf[- ]a?\s*(met(?:er|re)|mm|cm)\b",
               r"0.5 \1", t)  # "one and a half metres" stays untouched
    # unicode minus → ASCII ("right end −50C" silently lost the BC,
    # r5 battery-23)
    t = t.replace("−", "-")
    # imperial lengths → metres up front, the same way Kelvin/Fahrenheit
    # normalize, so every downstream length pattern sees metric ("a 6 inch
    # thick concrete slab" and "a 3 ft long rod" silently solved default
    # domains, r5 battery-24).  Only the unambiguous words — bare "in" is
    # a preposition and '"' is a quote.
    t = re.sub(r"(\d+(?:\.\d+)?)\s*(?:inch(?:es)?|in\.)\b",
               lambda m: f"{float(m.group(1)) * 0.0254:g} m", t)
    t = re.sub(r"(\d+(?:\.\d+)?)\s*(?:ft|feet|foot)\b",
               lambda m: f"{float(m.group(1)) * 0.3048:g} m", t)
    # scientific notation written ×10^n / ×10⁻ⁿ → e-notation so _NUM reads
    # the true value ("α = 1.2×10⁻⁵" parsed as diffusivity 1.2 AND a
    # spurious 1.2×10 m domain, r5 battery-23).  Digit lookbehind + a
    # required caret/superscript exponent keep "0.5m × 0.5m" dimension
    # pairs out of reach.
    _sup = str.maketrans("⁰¹²³⁴⁵⁶⁷⁸⁹⁻⁺", "0123456789-+")
    t = re.sub(r"(?<=\d)\s*[×x*]\s*10\s*(?:\^\s*\(?\s*(-?\d+)\s*\)?|"
               r"([⁻⁺]?[⁰¹²³⁴⁵⁶⁷⁸⁹]+))",
               lambda m: "e" + (m.group(1) or m.group(2).translate(_sup)),
               t)
    out: Dict[str, Any] = {}
    domain: Dict[str, float] = {}
    geometry_params: Dict[str, float] = {}
    bc: Dict[str, float] = {}
    material: Dict[str, Any] = {}

    dim_radial_default = False  # geometry-defaulted dim=1 (upgradable)

    # --- PDE type ---
    if re.search(r"navier[-\s]?stokes|turbulen|\breynolds\b|schr(?:ö|o)dinger"
                 r"|maxwell", t):
        # honestly unsupported physics: route to the dispatcher's clean
        # error envelope instead of silently "solving" a default problem
        out["pde_type"] = "other"
    elif re.search(r"elastic|stress|strain|displacement|deform|cantilever"
                 r"|beam bend|vibrat|oscillat|\bclamp|body\s+force"
                 r"|\bbends?\b|\bbending\b|deflect", t):
        out["pde_type"] = "elasticity"
    elif re.search(r"\badvect|convection[-\s]diffusion"
                   r"|\b(?:pollutant|contaminant|tracer|dye|plume|smoke)\b"
                   r"|\bdispers\w+", t):
        # extension: the reference's schema lists pde_type="advection"
        # (pde_schema.py:15) but its dispatcher cannot route it
        out["pde_type"] = "advection"
    elif re.search(r"poisson(?:'s)?\s+equation|laplace(?:'s)?\s+equation"
                   r"|\bpotential\s+(?:field|problem|equation)\b", t):
        # extension: pde_type="poisson" (also in the reference's schema
        # comment) — mathematically the steady diffusion problem; the
        # dispatcher routes it onto the steady heat solvers
        out["pde_type"] = "poisson"
        out["steady"] = True
    elif re.search(r"(?<!temperature )(?<!thermal )(?<!heat )"
                   r"\bwave\b(?!\s*number)", t):
        # the reference parser emits pde_type="wave" (pde_parser_agent.py:205
        # type list) but its dispatcher has no wave route; here the type
        # dispatches to the Newmark wave family (api.solve_wave_{1,2,3}D)
        out["pde_type"] = "wave"
    else:
        out["pde_type"] = "heat"
    # gravity / mechanical-load phrasing with NO thermal cue implies
    # elasticity (the reference's parser prompt only ever mentions gravity
    # and loads in the elasticity section, pde_parser_agent.py:385-395):
    # "a steel beam ... under gravity", "fixed at the left face, loaded by
    # gravity".  Any temperature/heat word keeps the heat routing.
    if out["pde_type"] == "heat" \
            and re.search(r"\bgravity\b|\bload(?:ed|s|ing)?\b|self[- ]weight"
                          r"|own\s+weight|\btensile\b|\btraction\b"
                          # verb forms too: "compressed by 50 kN" stayed on
                          # the heat route (r5 battery-24)
                          r"|\btension\b|\bcompress(?:ed|es|ing|ion|ive)?\b"
                          r"|\bpressure\b|(?:force|load)\s+of\s+\d"
                          # "a 500 N axial force", "pull/stretch the end"
                          # (r5 battery-17: number-first forces and the
                          # pulling verbs routed to heat)
                          r"|\d\s*(?:kn|mn|n)\s+(?:[a-z]+\s+)?(?:force|load)\b"
                          r"|\baxial\b|\bpull(?:ed|ing|s)?\b"
                          r"|\bstretch(?:ed|ing)?\b", t) \
            and not re.search(r"heat|thermal|temperatur|diffusiv|conduct"
                              r"|°|degrees|\bcool|\bhot\b|insulat"
                              r"|\d\s*°?\s*c\b|quench", t):
        out["pde_type"] = "elasticity"
    # flow velocity (advection): tuple "(vx, vy[, vz])" or a scalar speed
    # (written into the shared `material` dict → material_params)
    if out["pde_type"] == "advection":
        m = re.search(r"velocity\s*(?:of|=|:|is)?\s*\(\s*" + _NUM
                      + r"\s*,\s*" + _NUM + r"(?:\s*,\s*" + _NUM
                      + r")?\s*\)", t)
        if m:
            material["vx"] = float(m.group(1))
            material["vy"] = float(m.group(2))
            if m.group(3) is not None:
                material["vz"] = float(m.group(3))
                out["dim"] = 3
            else:
                out.setdefault("dim", 2)
        else:
            m = re.search(r"(?:velocity|flow\s+speed|flow|wind\s+speed|"
                          r"speed|carried\s+(?:by\s+\w+\s+)?at|"
                          r"(?:air|water|wind|current|fluid)?\s*"
                          r"(?:moving|flowing|blowing)\s+at)\s*"
                          r"(?:of|=|:|is)?\s*" + _NUM
                          + r"\s*(?:m\s*/\s*s)?", t)
            if m:
                material["velocity"] = float(m.group(1))

    m = re.search(r"wave\s+speed\s*(?:of|=|:|is|to)?\s*" + _NUM, t)
    if m:
        out["wave_speed"] = float(m.group(1))
        # "vibrating membrane with wave speed 5": an explicit wave speed
        # with no elastic-material cue means the scalar wave equation, not
        # elastodynamics (vibrat/oscillat alone route to elasticity above)
        if out["pde_type"] == "elasticity" and not re.search(
                r"stress|strain|modulus|young|gpa|\belastic|deform|poisson",
                t):
            out["pde_type"] = "wave"

    # --- geometry ---
    # "circular"/"tunnel" → cylinder per the reference's CRITICAL keyword
    # list (pde_parser_agent.py:239 "circular, cylindrical, column, tube")
    # "column" is a cylinder word for heat (the reference's keyword list),
    # but an elastic column under load is the 1D axial bar ("a 2 m aluminum
    # column compressed by 50 kN" routed to a heat cylinder, r5 battery-24)
    _cyl = (r"\bcylind|\bpipe\b|\btube\b|\bannul|\bcircular\b|\btunnel\b"
            + (r"" if out.get("pde_type") == "elasticity"
               else r"|\bcolumn\b"))
    if re.search(_cyl, t):
        out["geometry_type"] = "cylinder"
    elif re.search(r"\b(?:rod|wire|cable|bar|shaft)\b", t) \
            and re.search(r"\bradius\b|\bdiamet", t) \
            and not re.search(r"elastic|stress|strain|force|load|tensile",
                              t):
        # "a fuel rod of radius 1 cm": a rod WITH a radius is a cylinder
        # (bare "rod" stays the 1D Cartesian cue; elastic bars keep their
        # 1D axial route regardless)
        out["geometry_type"] = "cylinder"
    elif re.search(r"\bspher|\bball\b|\bshell\b", t):
        out["geometry_type"] = "sphere"
    elif re.search(r"\bcube\b|\bbox\b|(?<!of )\bbrick\b(?!\s+(?:wall|slab))",
                   t):
        # "brick" names the shape only when it is not a material modifier:
        # "a brick wall 30 cm thick" and "10 cm of brick" solved 3D boxes
        # (r5 battery-24)
        out["geometry_type"] = "box"

    # --- dimension ---
    m = re.search(r"\b([123])\s*[- ]?d\b", t)
    if m:
        out["dim"] = int(m.group(1))
    elif re.search(r"one[- ]dimensional", t):
        out["dim"] = 1
    elif re.search(r"two[- ]dimensional", t):
        out["dim"] = 2
    elif re.search(r"three[- ]dimensional", t):
        out["dim"] = 3
    elif re.search(r"\brod\b|\bbar\b|\bwire\b|\bstring\b", t) or (
            out.get("pde_type") == "elasticity"
            and re.search(r"\bcolumn\b", t)):
        # an elastic column under axial load is the 1D bar (r5 battery-24;
        # for heat "column" stays a cylinder word per the reference list)
        out["dim"] = 1
    elif re.search(r"\bplate\b|\bsquare\b(?!\s+cross)|\bmembrane\b"
                   r"|\brectangle\b|\bdrum(?:head)?\b", t):
        # "a 5 cm square cross-section" describes the section, not a 2D
        # domain (r5 battery-24)
        out["dim"] = 2
    elif re.search(r"\bcube\b|\bbox\b|(?<!of )\bbrick\b(?!\s+(?:wall|slab))",
                   t):
        out["dim"] = 3
    elif re.search(r"axi[- ]?symmetric", t) \
            and out.get("geometry_type") in ("cylinder", "sphere"):
        out["dim"] = 2  # r-z / r-θ section
    elif out.get("geometry_type") in ("cylinder", "sphere"):
        out["dim"] = 1  # radial by default — may be upgraded to 3 below
        dim_radial_default = True

    # --- sizes: "A x B (x C)" with optional per-number units; separators
    # are "x", "×", "*", or "by" (reference: "Recognize x, *, by, × as
    # separators", pde_parser_agent.py:472) — units may differ per number
    # ("2 m by 30 cm" → Lx=2.0, Ly=0.3)
    _sep = r"\s*(?:[x×*]|\bby\b)\s*"
    m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?" + _sep + _NUM
                  + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?(?:" + _sep + _NUM
                  + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?)?", t)
    if m:
        a = float(m.group(1)) * _unit_scale(m.group(2))
        b = float(m.group(3)) * _unit_scale(m.group(4))
        if m.group(5):
            c = float(m.group(5)) * _unit_scale(m.group(6))
            domain.update({"Lx": a, "Ly": b, "Lz": c})
            # three explicit dimensions trump a shape word ("plate
            # 1m*0.2m*0.2" is 3D — reference CRITICAL FOR 3D CARTESIAN,
            # pde_parser_agent.py:246)
            out["dim"] = 3
        else:
            domain.update({"Lx": a, "Ly": b})
            out.setdefault("dim", 2)

    # --- single length: "2 meter rod", "length (of) 2 m", "a 2 m steel
    # cantilever beam" (up to two interposed words, r5 battery-15) ---
    m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)[- ]*"
                  r"(?:long )?(?:[a-z]+\s+){0,2}?"
                  r"(rod|bar|wire|string|beam|fin|corridor|channel|duct|"
                  r"column|domain|rod,|bar,)\b", t)
    if m and "Lx" in domain:
        # an A×B×C box already parsed: "a 1 m x 0.2 m x 0.2 m steel beam"
        # must not ALSO set a 1D length from its last factor
        # (r5 battery-18)
        m = None
    if not m:
        # trailing-adjective phrasing: "2 m long", "3 m in length"
        m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)"
                      r"\s*[- ]*(?:long\b|in\s+length)", t)
    if not m:
        m = re.search(r"(?:length|long)\s*(?:of|=|:|to)?\s*" + _NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?", t)
        if m:
            domain.setdefault("length", float(m.group(1)) * _unit_scale(m.group(2)))
    else:
        domain.setdefault("length", float(m.group(1)) * _unit_scale(m.group(2)))
    # "3 m tall/high" → cylinder height (reference CRITICAL FOR CYLINDRICAL
    # 3D: radius + height, pde_parser_agent.py:247-254)
    m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)"
                  r"\s*[- ]*(?:tall\b|high\b|in\s+height)", t)
    if m:
        domain.setdefault("h", float(m.group(1)) * _unit_scale(m.group(2)))
    # "50 mm wide" / "width of 5 cm" — a box/beam cross-section dimension
    m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)"
                  r"\s*[- ]*(?:wide\b|in\s+width)", t)
    if m is None:
        m = re.search(r"\bwidth\s*(?:of|=|:|to)?\s*" + _NUM
                      + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?", t)
    _width = float(m.group(1)) * _unit_scale(m.group(2)) if m else None
    # fold "L long + W wide (+ H tall)" into box extents: a beam/box given
    # a cross-section is 3-D (2-D when only the width is given), and the
    # bare-cylinder "h" capture above becomes the z extent
    if (_width is not None and "length" in domain and "Lx" not in domain
            and out.get("geometry_type") not in ("cylinder", "sphere")):
        if "h" in domain:
            domain.update({"Lx": domain.pop("length"), "Ly": _width,
                           "Lz": domain.pop("h")})
            out["dim"] = 3
        else:
            domain.update({"Lx": domain.pop("length"), "Ly": _width})
            out.setdefault("dim", 2)
    # "50 cm square plate" → equal in-plane extents
    m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?"
                  r"\s*square\b", t)
    if m and "Lx" not in domain:
        s = float(m.group(1)) * _unit_scale(m.group(2))
        domain.update({"Lx": s, "Ly": s})
        out.setdefault("dim", 2)
    # "cube with 30 cm sides" / "sides of 0.5 m" → equal box extents
    m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?"
                  r"\s*(?:per\s+)?sides?\b", t)
    if m is None:
        m = re.search(r"\bsides?\s*(?:of|=|:)?\s*" + _NUM
                      + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)?", t)
    if (m and re.search(r"\bcube\b|\bbox\b|\bbrick\b", t)
            and "Lx" not in domain):
        s = float(m.group(1)) * _unit_scale(m.group(2))
        domain.update({"Lx": s, "Ly": s, "Lz": s})
        out["dim"] = 3
    # value-first cube side: "a 10 cm aluminum cube" (r5 battery-21)
    if "Lx" not in domain:
        m = re.search(_NUM + r"\s*((?:mm|cm|meter(?:s)?|metre(?:s)?|m)\b)"
                      r"\s*(?:[a-z]+\s+){0,2}?cube\b", t)
        if m:
            s = float(m.group(1)) * _unit_scale(m.group(2))
            domain.update({"Lx": s, "Ly": s, "Lz": s})
            out["dim"] = 3

    # --- radii / height ---
    m = re.search(r"inner\s+radius\s*(?:of|=|:|to)?\s*" + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m:
        geometry_params["r_inner"] = float(m.group(1)) * _unit_scale(m.group(2))
    m = re.search(r"outer\s+radius\s*(?:of|=|:|to)?\s*" + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m:
        geometry_params["r_outer"] = float(m.group(1)) * _unit_scale(m.group(2))
    # "inner diameter 5 cm and outer diameter 6 cm" → the radius pair
    # (r5 battery-16: the generic diameter rule grabbed the first value
    # as one solid-cylinder radius and dropped the annulus entirely)
    m = re.search(r"inner\s+diamet(?:er|re)\s*(?:of|=|:|to)?\s*" + _NUM
                  + r"\s*((?:mm|cm|m)\b)?", t)
    if m:
        geometry_params.setdefault(
            "r_inner", 0.5 * float(m.group(1)) * _unit_scale(m.group(2)))
    m = re.search(r"outer\s+diamet(?:er|re)\s*(?:of|=|:|to)?\s*" + _NUM
                  + r"\s*((?:mm|cm|m)\b)?", t)
    if m:
        geometry_params.setdefault(
            "r_outer", 0.5 * float(m.group(1)) * _unit_scale(m.group(2)))
    m = re.search(r"(?<!inner )(?<!outer )(?<!core )(?<!core of )\bradius\s*(?:of|=|:|to)?\s*" + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m is None and not geometry_params:
        # value-first phrasing: "0.2 m radius" (reference cylindrical
        # examples, pde_parser_agent.py:247-254)
        m = re.search(_NUM + r"\s*((?:mm|cm|m)\b)?\s*(?:in\s+)?radius\b", t)
    if m and "r_outer" not in geometry_params:
        r = float(m.group(1)) * _unit_scale(m.group(2))
        if out.get("geometry_type") == "sphere":
            geometry_params["sphere_radius"] = r
        else:
            geometry_params["cylinder_radius"] = r
    # diameter phrasing → radius (only when no explicit radius was given)
    m = re.search(r"(?<!inner )(?<!outer )diamet(?:er|re)\s*(?:of|=|:|to)?\s*"
                  + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m is None:
        # value-first: "a shaft 5 cm in diameter", "an 8 cm diameter
        # cylinder" (r5 battery-16/21)
        m = re.search(_NUM + r"\s*((?:mm|cm|m)\b)?\s*(?:in\s+)?"
                      r"diamet(?:er|re)\b", t)
    if m and not geometry_params:
        r = 0.5 * float(m.group(1)) * _unit_scale(m.group(2))
        if out.get("geometry_type") == "sphere":
            geometry_params["sphere_radius"] = r
        elif out.get("geometry_type") == "cylinder":
            geometry_params["cylinder_radius"] = r
    # wall thickness (hollow cylinders/shells): the second radius is implied
    # — "inner radius 5 cm with a 2 cm wall" → r_outer = 0.05 + 0.02
    # (VERDICT r2 weak #7 phrasing; reference prompt's hollow-cylinder
    # conventions at pde_parser_agent.py:248-265)
    m = re.search(r"(?:wall\s+thickness|wall|thickness)\s*(?:of|=|:|to)?\s*"
                  + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m is None:
        m = re.search(_NUM + r"\s*((?:mm|cm|m)\b)?\s*(?:thick\s+)?wall", t)
    if m and out.get("geometry_type") in ("cylinder", "sphere"):
        t_wall = float(m.group(1)) * _unit_scale(m.group(2))
        if "r_inner" in geometry_params and "r_outer" not in geometry_params:
            geometry_params["r_outer"] = geometry_params["r_inner"] + t_wall
        elif "r_outer" in geometry_params and "r_inner" not in geometry_params:
            geometry_params["r_inner"] = max(
                geometry_params["r_outer"] - t_wall, 0.0)
        else:
            key = ("sphere_radius" if out.get("geometry_type") == "sphere"
                   else "cylinder_radius")
            if key in geometry_params:
                geometry_params["r_outer"] = geometry_params.pop(key)
                geometry_params["r_inner"] = max(
                    geometry_params["r_outer"] - t_wall, 0.0)
    elif re.search(r"\bhollow\b", t) and "r_inner" not in geometry_params:
        # "hollow" with one radius only: keep it as the outer radius and
        # leave r_inner to the dispatcher's annulus default
        key = ("sphere_radius" if out.get("geometry_type") == "sphere"
               else "cylinder_radius")
        if key in geometry_params:
            geometry_params["r_outer"] = geometry_params.pop(key)
    m = re.search(r"height\s*(?:of|=|:|to)?\s*" + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m is None and (out.get("geometry_type") == "cylinder"
                      or re.search(r"cylind|pipe|tube|annul|\bshell\b", t)):
        # bare "h = 2 m" means HEIGHT only in a cylinder context; in heat
        # problems h is otherwise the film coefficient (r5 battery-14:
        # "h = 150" on a sphere became a 150 m domain height)
        m = re.search(r"\bh\s*(?:=|:)\s*" + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
        if m and re.match(r"\s*/?\s*w\s*/?\s*m", t[m.end():]):
            m = None  # "h = 25 W/m²K" is a film coefficient, not a height
        elif m and not m.group(2) and re.search(
                r"convect|exposed\s+to|loses\s+heat|film|"
                r"heat[-\s]?transfer\s+coefficient|\bambient\b|"
                r"\bsurroundings?\b|\bair\s+(?:is\s+)?at\b"
                r"|\bcools?\b|\bcooling\b|\broom\b", t):
            # a UNIT-LESS "h = 8" in a text that talks about convection is
            # the film coefficient even in a pipe/cylinder context
            # (r5 battery-15: it became an 8 m pipe height; battery-16:
            # 'outside air at 25°C with h = 10' became a 10 m height)
            m = None
    if m:
        domain["h"] = float(m.group(1)) * _unit_scale(m.group(2))
    # bare material thickness ("30nm thick conductor") is a cross-section
    # property, NOT the domain length (reference pde_parser_agent.py:424-429
    # CRITICAL rule) — record it in notes, never in domain_size.
    # EXCEPTION (r5 battery-16): for a planar conduction object (slab,
    # wall, wafer, pane, window, plate in a 1D reading) the thickness IS
    # the conduction path — use it as the length when no other length was
    # given ("a concrete slab 20 cm thick" solved a default 1 m domain).
    m = re.search(_NUM + r"\s*(nm|um|µm|microns?|mm|cm|m)?\s*"
                  r"thick(?:ness)?\b(?!\s+wall)", t)
    # an explicit through-thickness question makes ANY planar object
    # (incl. a plate that defaulted to dim 2) a 1D conduction problem
    # (r5 battery-23: "steady temperature through the thickness?")
    through = bool(re.search(r"through\s+(?:the|its)\s+thickness"
                             r"|through-thickness", t))
    if m and through and out.get("geometry_type") not in ("cylinder",
                                                          "sphere"):
        out["dim"] = 1
    if m and out.get("geometry_type") not in ("cylinder", "sphere"):
        if ("length" not in domain and "Lx" not in domain
                and out.get("dim") in (None, 1)
                and (through
                     or re.search(r"\bslab\b|\bwall\b|\bwafer\b|\bpane\b"
                                  r"|\bwindow\b|\blayer\b", t))):
            domain["length"] = float(m.group(1)) * _unit_scale(m.group(2))
        else:
            out.setdefault("notes", []).append(
                f"Thickness mentioned ({m.group(1)}{m.group(2) or 'm'}) - "
                f"material property, using default length")
    # value-first planar objects with no 'thick' keyword: "a 30 cm
    # concrete wall" — the stated size IS the conduction path
    # (r5 battery-23: q2 solved a default 1 m domain)
    if ("length" not in domain and "Lx" not in domain
            and out.get("dim") in (None, 1)
            and out.get("geometry_type") not in ("cylinder", "sphere")
            and not geometry_params):
        m = re.search(_NUM + r"\s*(mm|cm|m)\s+(?:[a-z]+\s+)?"
                      r"(?:wall|slab|pane|wafer)\b", t)
        if m:
            domain["length"] = float(m.group(1)) * _unit_scale(m.group(2))

    # --- temperatures ---
    # optional copula BEFORE the verb phrase: "is held at", "are kept at",
    # "is at" (r5 battery-14: 'The left edge is held at 150°C' lost the BC)
    # the (?!…unit) lookahead rejects lengths masquerading as temperatures:
    # "cube of side 0.3 m" must not become T_side=0.3 (r5 battery-15)
    temp = (r"\s*(?:(?:is|are|was|were)\s+)?"
            r"(?:of|=|:|is|at|to|temperature(?: of| at| to)?|fixed at|held at|"
            r"kept at|set to|stays? at|sits? at|remains? at|maintained at|"
            r"raised to|lowered to|heated to|cooled to|brought to|"
            r"drops? to|starts? at)?\s*"
            + _NUM + r"(?![\d.])(?!\s*(?:mm|cm|km|m|meters?|metres?)\b)"
            r"\s*°?\s*c?\b")
    pairs = [
        (r"left(?:\s+(?:end|edge|side|face|boundary))?" + temp, "T_left"),
        (r"right(?:\s+(?:end|edge|side|face|boundary))?" + temp, "T_right"),
        # fin phrasing: the base is the clamped/heated end (x=0), the tip
        # is the far end (r5 battery-15: "base maintained at 200°C")
        (r"\b(?:base|root)(?:\s+(?:end|edge|face|surface))?" + temp,
         "T_left"),
        (r"\btip(?:\s+(?:end|edge|face|surface))?" + temp, "T_right"),
        # "inner radius 2 cm at 300°C": the radius clause may sit between
        # the face word and its temperature (r5 battery-14)
        # the (?![\d.]) stops backtracking from splitting the radius number
        # ("radius 1|0 cm" must not yield T=0)
        (r"inner(?:\s+(?:surface|wall|boundary|edge))?"
         r"(?:\s+(?:at\s+)?radius\s+(?:of\s+)?[-+]?\d+(?:\.\d+)?(?![\d.])"
         r"\s*(?:nm|um|µm|mm|cm|m)?)?" + temp, "T_inner"),
        (r"outer(?:\s+(?:surface|wall|boundary|edge))?"
         r"(?:\s+(?:at\s+)?radius\s+(?:of\s+)?[-+]?\d+(?:\.\d+)?(?![\d.])"
         r"\s*(?:nm|um|µm|mm|cm|m)?)?" + temp, "T_outer"),
        (r"\b(?:side|wall|curved surface|lateral)(?:\s+(?:boundary|surface))?" + temp, "T_side"),
        (r"(?<!left )(?<!right )(?<!inner )(?<!outer )(?<!side )"
         r"(?:boundary|boundaries|surface|edges|walls)"
         r"(?:\s+(?:temperature|held|kept|fixed))?" + temp, "T_boundary"),
    ]
    for pat, key in pairs:
        m = re.search(pat, t)
        if m and key not in bc:
            bc[key] = float(m.group(1))
    # temperature-first with the face named AFTER the value: "heated to
    # 200°C at the left end" silently lost the BC (r5 battery-24).  The
    # face-first `pairs` above already ran, so they keep priority.
    for fm in re.finditer(
            r"(?:heated|cooled|held|kept|maintained|fixed|raised|lowered|"
            r"set|brought)\s+(?:to|at)\s+" + _NUM
            + r"(?![\d.])(?!\s*(?:mm|cm|km|m|meters?|metres?)\b)"
            r"\s*°?\s*c?\b[^.;,]{0,25}?\b(?:at|on)\s+(?:the\s+)?"
            r"(left|right)\b", t):
        bc.setdefault(f"T_{fm.group(2)}", float(fm.group(1)))
    # mathematical notation: u(0)=1, u(L)=0, T(0)=0, T(L)=100,
    # du/dt = α d²u/dx², on [0, L]
    m = re.search(r"\b[ut]\s*\(\s*0\s*\)\s*=\s*" + _NUM, t)
    if m:
        bc.setdefault("T_left", float(m.group(1)))
    m = re.search(r"\b[ut]\s*\(\s*l\s*\)\s*=\s*" + _NUM, t)
    if m:
        bc.setdefault("T_right", float(m.group(1)))
    for m in re.finditer(r"\b[ut]\s*\(\s*" + _NUM + r"\s*\)\s*=\s*" + _NUM,
                         t):
        if float(m.group(1)) != 0.0:  # u(L) = value (u(0) handled above)
            bc.setdefault("T_right", float(m.group(2)))
            domain.setdefault("length", float(m.group(1)))
            break
    m = re.search(r"d\s*u\s*/\s*d\s*t\s*=\s*" + _NUM
                  + r"\s*\*?\s*d\s*[²2]?\s*u", t)
    if m:
        out.setdefault("diffusivity", float(m.group(1)))
    m = re.search(r"\bon\s*\[\s*0\s*,\s*" + _NUM + r"\s*\]", t)
    if m:
        domain.setdefault("length", float(m.group(1)))

    # "ends at 100 and 0 degrees" → left/right in written order
    # (checked BEFORE the symmetric rule so the first value isn't
    # claimed for both ends)
    m = re.search(r"\bends" + temp + r"\s*(?:°?c)?\s*and\s*" + _NUM, t)
    if m and "T_left" not in bc and "T_right" not in bc:
        bc["T_left"] = float(m.group(1))
        bc["T_right"] = float(m.group(2))
    # "both ends at 0" / bare "ends kept at 0" (r5 battery-15) →
    # symmetric 1D Dirichlet pair; "both faces sit at 15°C" names the two
    # sides of a wall/slab the same way (r5 battery-23)
    m = re.search(r"(?:\bboth\s+(?:ends|faces|sides|surfaces)"
                  r"|(?:\bthe\s+|\b)ends)" + temp, t)
    if m:
        bc.setdefault("T_left", float(m.group(1)))
        bc.setdefault("T_right", float(m.group(1)))
    # "keep the ends ... ice-cold at 0°C": an adjective (plus the object
    # restatement) may interpose between 'ends' and the value
    # (r5 battery-23); sentence-bounded so a later temperature cannot be
    # grabbed across a period
    if "T_left" not in bc and "T_right" not in bc:
        m = re.search(r"\b(?:keep|keeping|hold|holding)\s+(?:the\s+)?"
                      r"(?:both\s+)?ends\b[^.;!?]{0,60}?\bat\s+"
                      + _NUM + r"\s*°?\s*c\b", t)
        if m:
            bc["T_left"] = bc["T_right"] = float(m.group(1))
    # "one face at -10°C and the other at 22°C" → left/right in written
    # order (r5 battery-16: both BCs were silently dropped)
    # the connector is optional: "one face at 40°C the other at 10°C"
    # dropped both values (r5 battery-24)
    m = re.search(r"one\s+(?:face|side|end|surface)" + temp
                  + r"\s*(?:°?\s*c)?\s*[,;]?\s*(?:(?:and|while)\s+)?"
                  r"the\s+other"
                  r"(?:\s+(?:face|side|end|surface))?" + temp, t)
    if m and "T_left" not in bc and "T_right" not in bc:
        bc["T_left"] = float(m.group(1))
        bc["T_right"] = float(m.group(2))
    # top/bottom/"all faces" phrasing → the uniform boundary value
    m = re.search(r"(?:top|bottom|all\s+(?:four\s+|six\s+)?"
                  r"(?:sides|faces|edges|boundaries|surfaces))"
                  r"(?:\s+(?:face|surface|edge|boundary))?" + temp, t)
    if m and "T_boundary" not in bc:
        bc["T_boundary"] = float(m.group(1))
    # DISTINCT per-face temperatures ("top: 100°C; bottom: 0°C") cannot be
    # one uniform boundary — emit typed Dirichlet faces instead
    # (r5 battery-15: the bottom value was silently dropped)
    face_temps: Dict[str, float] = {}
    for fm in re.finditer(r"\b(top|bottom|front|back)\b"
                          r"(?:\s+(?:face|surface|edge))?" + temp, t):
        face_temps.setdefault(fm.group(1), float(fm.group(2)))
    if len(set(face_temps.values())) >= 2:
        for f, v in face_temps.items():
            bc.setdefault(f, {"type": "dirichlet", "value": v})
        bc.pop("T_boundary", None)
    # "inside at 25, outside at -5": inner/outer for curvilinear shells,
    # left/right for a Cartesian wall/slab
    curvilinear = out.get("geometry_type") in ("cylinder", "sphere")
    for word, curv_key, cart_key in (("inside", "T_inner", "T_left"),
                                     ("outside", "T_outer", "T_right")):
        m = re.search(r"\b" + word + temp, t)
        if m is None:
            # number-first: "water at 80 C inside", "20 C on the outside",
            # "fluid at 90°C flows inside" (one interposed verb/word,
            # r5 battery-15)
            m = re.search(r"(?:at\s+)?" + _NUM
                          + r"(?!\s*(?:mm|cm|km|m|meters?|metres?)\b)"
                          r"\s*°?\s*c?\s+"
                          r"(?:[a-z]+\s+)?(?:on\s+the\s+)?" + word + r"\b", t)
        if m:
            bc.setdefault(curv_key if curvilinear else cart_key,
                          float(m.group(1)))
    if curvilinear:
        # a fluid carried BY the pipe wets the inner surface: "steam at
        # 120°C flows in a copper pipe", "the pipe carries oil at 80°C"
        # (r5 battery-16 — no literal 'inside' word anywhere)
        m = (re.search(r"(?:steam|water|oil|gas|fluid|liquid)\s+at\s*"
                       + _NUM + r"\s*°?\s*c?\s+"
                       r"(?:flow\w*|runs?|moves?|passes?|circulat\w*)\s+"
                       r"(?:in(?:side)?|through)\b", t)
             or re.search(r"carr(?:ies|ying)\s+"
                          r"(?:steam|water|oil|gas|fluid|liquid)\s+at\s*"
                          + _NUM, t))
        if m:
            bc.setdefault("T_inner", float(m.group(1)))
    # "air at 20 C outside with h = 6": a convective outer surface — the
    # ambient fluid named with a temperature, an outside marker, and a
    # film coefficient right after
    m = re.search(r"(?:air|gas|surroundings)\s*(?:at)?\s*" + _NUM
                  + r"\s*°?\s*c?\s*(?:on\s+the\s+)?out(?:side|er)\b"
                  r"[^.;]{0,25}?\bh\s*(?:=|:|of)?\s*" + _NUM, t)
    if m:
        bc["outer"] = {"type": "robin", "h": float(m.group(2)),
                       "T_ambient": float(m.group(1))}
        bc.pop("T_outer", None)
    # "quenched from 800 C to 20 C" → initial 800, boundary 20
    m = re.search(r"quench(?:ed|ing)?\s+from\s*" + _NUM
                  + r"\s*°?\s*[cf]?\s*(?:down\s+)?to\s*" + _NUM, t)
    if m:
        out.setdefault("initial_value", float(m.group(1)))
        out.setdefault("initial_type", "constant")
        for key in (("T_outer", "T_boundary") if curvilinear
                    else ("T_boundary",)):
            bc.setdefault(key, float(m.group(2)))

    # --- convective (Robin) / flux (Neumann) / insulated faces ---
    # Extension beyond the reference (Dirichlet-only heat BCs,
    # fenics_mcp_server.py:294-297): typed per-face specs ride bc_values and
    # route to the solve_heat_*_mixed tools.
    face_noun = r"(?:\s+(?:end|edge|face|faces|side|surface|wall|boundary))?"
    # NOTE: singular "wall" is deliberately NOT a face word — "brick wall"
    # names the object, not a face ("side wall" still matches via side+noun)
    face_pat = (r"\b(left|right|top|bottom|front|back|inner|outer|inside|"
                r"outside|sides|side|walls|lateral|ends|tip|base|"
                r"all\s+(?:other\s+)?faces|other\s+faces|all\s+sides|"
                r"all\s+surfaces|surface)" + face_noun)

    def _faces_of(word: str):
        w = re.sub(r"\s+", " ", word.strip())
        if w in ("side", "sides", "walls", "lateral"):
            return ["sides"]
        if "other" in w:
            return ["sides"]
        if w.startswith("all") or w == "surface":
            # bare "surface"/"all": every exposed face — the radial tool
            # resolves this to the outer surface (+ inner when hollow)
            return ["all"]
        if w == "ends":
            return ["left", "right"]
        if w == "inside":
            return ["inner"]
        if w == "outside":
            return ["outer"]
        if w == "base":
            return ["left"]
        if w == "tip":
            return ["right"]
        return [w]

    def _face_near(i: int, j: int, prefer_after: bool = False):
        """Nearest face mention around cue span [i, j).  The before-window
        stops at a sentence boundary: 'the tip is insulated. The fin loses
        heat to 30°C air' must not hang the Robin spec on the previous
        sentence's face (r5 battery-15).  A face word INSIDE the cue span
        itself wins outright ('outside air at 25°C' — r5 battery-16)."""
        within = re.search(face_pat, t[i:j])
        if within:
            return _faces_of(within.group(1))
        bwin = re.split(r"[.;!?]\s", t[max(0, i - 70):i])[-1]
        before = [m for m in re.finditer(face_pat, bwin)]
        after = re.search(face_pat, t[j:j + 70])
        if prefer_after and after:
            return _faces_of(after.group(1))
        if before:
            return _faces_of(before[-1].group(1))
        if after:
            return _faces_of(after.group(1))
        return None

    conv_cue = (r"convect(?:s|ion|ive|ing)?|cool(?:ed|ing|s)?\s+(?:by|in)\s+"
                r"(?:a\s+)?(?:[\d.]+\s*°?\s*c\s+)?"
                r"(?:convection|(?:the\s+)?air|water|oil|bath|furnace|oven)"
                # "exposed to 15°C air with h = 10": the ambient temperature
                # may sit between 'to' and the medium word (r5 battery-15)
                r"|exposed\s+to\s+(?:[\d.]+\s*°?\s*c\s+)?(?:\w+\s+)?"
                r"(?:air|fluid|coolant|flow)|loses\s+heat\s+to|"
                r"quench(?:ed|ing)?"
                # immersion with the medium temperature up front: "in a
                # 700°C furnace", "into an 80 C oil bath" (r5 battery-14)
                r"|(?:in|into)\s+an?\s+[\d.]+\s*°?\s*c\s+"
                r"(?:furnace|oven|bath|chamber|environment|room)"
                # medium-first immersion: "in water at 20°C, h = 500"
                # (r5 battery-15) — the named ambient temperature is what
                # distinguishes this from a bare "a rod in water" mention
                r"|(?:in|into)\s+(?:the\s+)?(?:water|oil|air|coolant)\s+"
                r"at\s+[\d.]"
                # "outside/ambient air at 25°C with h = 10" — the qualified
                # air mention plus its own temperature is a convection cue
                # even without a convect verb (r5 battery-16)
                r"|(?:ambient|outside|surrounding)\s+air\s+(?:is\s+)?"
                r"at\s+[-+]?[\d.]")
    for cm in re.finditer(conv_cue, t):
        is_quench = cm.group(0).startswith("quench")
        faces = _face_near(cm.start(), cm.end()) or ["all"]
        win = t[max(0, cm.start() - 90):cm.end() + 170]
        hm = (re.search(r"(?:heat[-\s]?transfer|convection|convective|film)\s+"
                        r"coefficient\s*(?:of|=|:|is)?\s*" + _NUM, win)
              or re.search(r"\bh\s*(?:=|:)\s*" + _NUM, win)
              # bare "h 300 W/m2K" — the trailing unit disambiguates from
              # the cylinder-height "h 2 m" pattern
              or re.search(r"\bh\s*(?:of)?\s*" + _NUM
                           + r"\s*w\s*/?\s*m", win))
        if is_quench and not hm:
            # no film coefficient → the quench stays the Dirichlet rule
            # above (reference-compatible immersion at the bath temperature)
            continue
        def _ambient_in(w):
            return (re.search(r"(?:ambient|air|fluid|surroundings?|"
                              r"environment|room|chamber|"
                              r"coolant|bath|water|oil|furnace|oven)"
                              r"(?:\s+temperature)?\s*"
                              r"(?:of|at|=|:|is)?\s*" + _NUM, w)
                    or re.search(r"to\s*" + _NUM + r"\s*°?\s*c?\s*"
                                 r"(?:air|ambient|surroundings|water|oil|"
                                 r"bath|coolant)", w)
                    # number-first: "a 30 C furnace", "25 C oil",
                    # "a 20 C room" (r5 battery-21)
                    or re.search(_NUM + r"\s*°?\s*c\s+(?:air|furnace|oven|"
                                 r"water|oil|bath|coolant|environment|"
                                 r"room|chamber|surroundings)", w))
        # prefer an ambient named in/after the cue itself ("exposed to 20°C
        # air"); the before-window is a FALLBACK only — another boundary's
        # fluid temperature in the preceding clause must not leak in
        # (r5 battery-15: 'fluid at 90°C flows inside, outside exposed to
        # 20°C air' hung T_ambient=90 on the outer face)
        am = (_ambient_in(t[cm.start():cm.end() + 170])
              or _ambient_in(win))
        h_val = float(hm.group(1)) if hm else 10.0
        t_inf = float(am.group(1)) if am else 20.0
        if not hm:
            out.setdefault("notes", []).append(
                "convection requested without a heat-transfer coefficient - "
                "using h=10 W/m^2K")
        if not am:
            out.setdefault("notes", []).append(
                "convection requested without an ambient temperature - "
                "using 20 degC")
        for f in faces:
            bc.setdefault(f, {"type": "robin", "h": h_val,
                              "T_ambient": t_inf})
    # faces with their own explicit Dirichlet phrase anywhere in the text
    # (computed before the flux rules: "left end receives a heat flux of
    # 1000 W/m2, right end at 0°C" must not hang the flux on 'right' —
    # r5 battery-18)
    dirichlet_faces = {fw for fw in ("left", "right", "top", "bottom",
                                     "front", "back", "inner", "outer")
                       if re.search(r"\b" + fw + face_noun + temp, t)}
    for fm in re.finditer(r"heat\s+flux\s*(?:of|=|:)?\s*" + _NUM
                          + r"(?:\s*(k|m)?w\s*/?\s*m)?", t):
        faces = _face_near(fm.start(), fm.end(), prefer_after=True) or ["left"]
        if all(f in dirichlet_faces for f in faces):
            alt = _face_near(fm.start(), fm.end())  # before-preferred
            if alt and not all(f in dirichlet_faces for f in alt):
                faces = alt
        q = float(fm.group(1)) * {"k": 1e3, "m": 1e6}.get(fm.group(2) or "",
                                                         1.0)
        win = t[max(0, fm.start() - 60):fm.end() + 90]
        if re.search(r"\bout(?:ward)?\b|removed|extracted|leav(?:es|ing)|"
                     r"drawn", win):
            q = -abs(q)
        for f in faces:
            bc.setdefault(f, {"type": "neumann", "flux": q})
    # flux given as a bare power density near a face ("heat a rod from the
    # left with 1000 W/m2"); the (?!\s*k) guard rejects film-coefficient
    # units (W/m²K)
    for fm in re.finditer(r"(?:with|of|applying|apply|deliver(?:s|ing)?|"
                          r"input\s+of)\s+" + _NUM
                          + r"\s*(k|m)?w\s*/?\s*m\s*[²2]?(?!\s*k)\b", t):
        faces = _face_near(fm.start(), fm.end()) or ["left"]
        q = float(fm.group(1)) * {"k": 1e3, "m": 1e6}.get(fm.group(2) or "",
                                                          1.0)
        for f in faces:
            bc.setdefault(f, {"type": "neumann", "flux": q})
    # ("bottom face is held at 40°C … all other faces are adiabatic" must
    # not insulate the bottom — dirichlet_faces computed above the flux
    # rules; r5 battery-15)
    for im in re.finditer(r"\binsulated\b|\badiabatic\b", t):
        # conjunction-aware: "top and bottom insulated", "front, back and
        # left faces are adiabatic" — collect EVERY face in the adjacent
        # window (the nearest-single-face heuristic drops listed faces).
        # Windows stop at sentence boundaries: 'right edge is kept at 25°C.
        # The top and bottom are insulated' must not insulate "right"
        # (r5 battery-14).  Decimal points ("0.3 m") don't split — the
        # boundary needs trailing whitespace.
        bwin = re.split(r"[.;!?]\s", t[max(0, im.start() - 70):im.start()])[-1]
        fwin = re.split(r"[.;!?]\s", t[im.end():im.end() + 70])[0]
        before = [m for m in re.finditer(face_pat, bwin)]
        faces = []
        for m in (before or re.finditer(face_pat, fwin)):
            for f in _faces_of(m.group(1)):
                if f not in faces:
                    faces.append(f)
        for f in faces:
            # a face with an explicit Dirichlet temperature keeps it
            if ("T_" + f) in bc or ("T_" + f.rstrip("s")) in bc \
                    or f in dirichlet_faces:
                continue
            bc.setdefault(f, {"type": "insulated"})
    # --- sinusoidal boundary driving ("varies between 10 and 30 °C with a
    # period of 60 s", "daily temperature cycle between -5 and 15") —
    # extension: the reference's BCs are constant ---
    m = re.search(r"(?:varies|oscillat\w*|swings?|cycl\w*)\s*"
                  r"(?:sinusoidally\s+)?between\s*" + _NUM
                  + r"\s*°?\s*c?\s*and\s*" + _NUM, t)
    if m is None:
        m = re.search(r"(?:daily|diurnal|annual|seasonal)\s+"
                      r"(?:temperature\s+)?cycle\s+between\s*" + _NUM
                      + r"\s*°?\s*c?\s*and\s*" + _NUM, t)
    if m:
        lo, hi = float(m.group(1)), float(m.group(2))
        base, amp = 0.5 * (lo + hi), 0.5 * abs(hi - lo)
        pm = re.search(r"period\s*(?:of)?\s*" + _NUM
                       + r"\s*(days?|hours?|h\b|min(?:utes)?|s(?:ec(?:onds)?)?)?",
                       t)
        if pm:
            scale = {"day": 86400.0, "days": 86400.0, "hour": 3600.0,
                     "hours": 3600.0, "h": 3600.0, "min": 60.0,
                     "minutes": 60.0}.get((pm.group(2) or "s").strip(), 1.0)
            period = float(pm.group(1)) * scale
        elif re.search(r"daily|diurnal", t):
            period = 86400.0
        elif re.search(r"annual|seasonal", t):
            period = 365.25 * 86400.0
        else:
            period = 1.0
            out.setdefault("notes", []).append(
                "oscillating boundary requested without a period - "
                "using 1 s")
        faces = _face_near(m.start(), m.end()) or ["left"]
        for f in faces:
            bc[f] = {"type": "dirichlet", "value": base,
                     "amplitude": amp, "period": period}
        out["steady"] = False

    # A singular named-face Dirichlet ("bottom at 25 C") is folded into
    # T_boundary by the reference-parity rule above — right for the
    # reference's uniform-boundary tools, wrong when the query ALSO names
    # typed faces ("other faces insulated"): the catch-all would spread the
    # value to every face the typed specs don't cover.  With typed specs
    # present, reinterpret it as that one face's Dirichlet value.
    if "T_boundary" in bc and any(isinstance(v, dict) and v.get("type")
                                  for v in bc.values()):
        m = re.search(r"\b(top|bottom|front|back)\b"
                      r"(?:\s+(?:face|surface|edge))?" + temp, t)
        if m and float(m.group(2)) == bc["T_boundary"] \
                and not re.search(r"\b(?:top|bottom)\s+and\s+"
                                  r"(?:top|bottom)\b|all\s+(?:faces|sides)",
                                  t):
            bc[m.group(1)] = {"type": "dirichlet",
                              "value": bc.pop("T_boundary")}

    # standalone film-coefficient / ambient mentions without a convection
    # cue ("change the heat transfer coefficient to 50") ride a _robin_update
    # entry; the follow-up merge applies it to existing robin face specs
    has_robin = any(isinstance(v, dict) and v.get("type") == "robin"
                    for v in bc.values())
    if not has_robin:
        upd = {}
        m = (re.search(r"(?:heat[-\s]?transfer|convection|convective|film)"
                       r"\s+coefficient\s*(?:of|to|=|:|is)?\s*" + _NUM, t)
             or re.search(r"\bh\s*(?:=|:)\s*" + _NUM, t)
             or re.search(r"\bh\s*(?:of)?\s*" + _NUM + r"\s*w\s*/?\s*m", t))
        if m and float(m.group(1)) == domain.get("h"):
            m = None  # that "h = …" was the cylinder HEIGHT, already taken
        if m:
            upd["h"] = float(m.group(1))
        m = re.search(r"(?:ambient|surroundings?|bath|coolant)\s*"
                      r"(?:temperature)?\s*(?:of|to|at|=|:|is)?\s*" + _NUM, t)
        if m:
            upd["T_ambient"] = float(m.group(1))
        if upd:
            bc["_robin_update"] = upd

    if any(isinstance(v, dict) and v.get("type") for v in bc.values()):
        out["bc_type"] = "mixed"

    m = re.search(r"initial(?:ly)?(?:\s+temperature| temp| condition)?"
                  + temp.replace("fixed at", "fixed at|initially"), t)
    if m is None:
        # "initially at a uniform 25°C": the article/uniform qualifier sits
        # between the connector and the value (r5 battery-15)
        m = re.search(r"initial(?:ly)?(?:\s+temperature| temp| condition)?"
                      r"\s*(?:is|was)?\s*(?:of|=|:|at|to)?\s*"
                      r"(?:a\s+)?(?:uniform(?:ly)?\s+)?" + _NUM
                      + r"\s*°?\s*c?\b", t)
    if m:
        out["initial_value"] = float(m.group(1))
        out["initial_type"] = "constant"
    else:
        # "the block starts at 500°C and cools …" (r5 battery-14); the
        # quench rule above already claims "quenched from X to Y"
        m = re.search(r"(?:starts?|starting|begins?|beginning)\s+"
                      r"(?:out\s+)?(?:at|from)\s*" + _NUM + r"\s*°?\s*c?\b", t)
        if m is None:
            # "a block at 900 K cools by convection" / "a sphere at 20°C
            # goes into a 180°C oven": the body temperature named right
            # before a cooling/immersion verb is the initial state
            # (r5 battery-15/16)
            m = re.search(r"\bat\s+" + _NUM + r"\s*°?\s*c\b,?\s*"
                          r"(?:it\s+|that\s+)?"
                          r"(?:cool|(?:goes|sits?|is\s+(?:placed|put|"
                          r"dropped)|placed|put|dropped)\s+in(?:to)?\b)", t)
        if m and not out.get("steady"):
            out.setdefault("initial_value", float(m.group(1)))
            out.setdefault("initial_type", "constant")
    # reference parse order (pde_parser_agent.py:335-348, FIRST match wins):
    # cosine > sine > zero > constant
    if re.search(r"\bcosine\b|cos\(", t):
        out["initial_type"] = "cosine"
    elif re.search(r"initial.*\bsine\b|\bsine\b.*initial|sin\(", t):
        out["initial_type"] = "sine"
    elif re.search(r"zero\s+initial|initial\s+(?:condition|temperature|value)?"
                   r"\s*(?:of|=|:|is|to)?\s*zero\b", t):
        out["initial_type"] = "zero"
        out["initial_value"] = 0.0
    # "a Gaussian hot spot ... on top of a 20°C background": the
    # background IS the (uniform) initial value (r5 battery-23)
    m = re.search(_NUM + r"\s*°?\s*c\s+background", t)
    if m and not out.get("steady"):
        out.setdefault("initial_value", float(m.group(1)))
        out.setdefault("initial_type", "constant")
    # non-uniform initial profiles (step / Gaussian) are not in the
    # contract (initial_type: constant|zero|cosine|sine) — say so instead
    # of silently solving from a uniform state (r5 battery-23)
    if out.get("pde_type") in (None, "heat") and not out.get("steady") \
            and (re.search(r"\b(?:left|right)\s+half\b[^.;!?]{0,40}?"
                           r"\bat\b", t)
                 or re.search(r"\bgaussian\b|\bhot\s+spot\b", t)):
        out.setdefault("notes", []).append(
            "Non-uniform initial profiles (step/Gaussian) are not "
            "supported - the simulation starts from a uniform initial "
            "value instead.")
    # radiation is not a supported boundary mechanism — note it rather
    # than silently dropping the emissivity (r5 battery-23)
    if out.get("pde_type") in (None, "heat") \
            and re.search(r"\bradiat(?:es?|ion|ing|ive)\b|\bemissivit", t):
        out.setdefault("notes", []).append(
            "Radiative heat exchange is not supported - only the stated "
            "convection/ambient conditions are applied (no linearized "
            "radiation).")
    m = re.search(r"amplitude\s*(?:of|=|:|to)?\s*" + _NUM, t)
    if m:
        out["initial_amplitude"] = float(m.group(1))
    m = re.search(r"wave\s*number\s*(?:of|=|:|to)?\s*" + _NUM, t)
    if m:
        out["initial_wavenumber"] = float(m.group(1))

    # --- material: heat ---
    m = re.search(r"(?:(?<!core )diffusivity|(?<!core )(?:thermal\s+)?conductivity)\s*(?:of|=|:|is|to)?\s*"
                  + _NUM, t)
    if m is None and out["pde_type"] in ("heat", "poisson", "advection"):
        # math-notation "alpha = 9.7e-5" (heat only: in elasticity alpha is
        # the thermal-expansion coefficient; r5 battery-15)
        m = re.search(r"\b(?:alpha|α)\s*(?:=|:)\s*" + _NUM, t)
    if m:
        out["diffusivity"] = float(m.group(1))

    # --- material: elasticity ---
    m = re.search(r"(?:young'?s?\s+modulus|modulus\s+of\s+elasticity|\be)"
                  r"\s*(?:of|=|:|is|to)?\s*" + _NUM + r"\s*(gpa|mpa|kpa|pa)\b", t)
    if m is None:
        m = re.search(r"young'?s?\s+modulus\s*(?:of|=|:|is|to)?\s*" + _NUM
                      + r"\s*(gpa|mpa|kpa|pa)?", t)
    if m:
        scale = {"gpa": 1e9, "mpa": 1e6, "kpa": 1e3, "pa": 1.0, None: 1.0}[m.group(2)]
        out["young_modulus"] = float(m.group(1)) * scale
    m = re.search(r"(?:poisson'?s?(?:\s+ratio)?|\bnu\b)\s*(?:of|=|:|is|to)?\s*"
                  + _NUM, t)
    if m:
        out["poisson_ratio"] = float(m.group(1))
    m = re.search(r"density\s*(?:of|=|:|is|to)?\s*" + _NUM, t)
    if m:
        out["density"] = float(m.group(1))
    if re.search(r"\bgravity\b|self[- ]weight|own weight", t):
        material["gravity"] = True
    m = re.search(r"(?:cross[- ]?sectional\s+)?area\s*(?:of|=|:|is|to)?\s*"
                  + _NUM + r"\s*(mm|cm|m)?\s*(?:\^?2|²)?", t)
    if m:
        scale = {"mm": 1e-6, "cm": 1e-4}.get(m.group(2), 1.0)
        material["area"] = float(m.group(1)) * scale
    # body-force component forms first (reference material_params contract:
    # body_fx/body_fy/body_fz for 2D/3D, pde_parser_agent.py:313-314):
    #   tuple "(fx, fy[, fz])" / "in the negative z direction" / "downward"
    _bf = r"body\s+forces?\s*(?:of|=|:|is|to)?\s*"
    m = re.search(_bf + r"\(\s*" + _NUM + r"\s*,\s*" + _NUM
                  + r"(?:\s*,\s*" + _NUM + r")?\s*\)", t)
    if m:
        material["body_fx"] = float(m.group(1))
        material["body_fy"] = float(m.group(2))
        if m.group(3) is not None:
            material["body_fz"] = float(m.group(3))
            out["dim"] = 3
        else:
            out.setdefault("dim", 2)
    else:
        _unit_sfx = r"(?:\s*n\s*/?\s*m\s*[³3²2]?)?"
        m = re.search(_bf + _NUM + _unit_sfx
                      + r"\s*(?:acting\s+|applied\s+)?(?:in|along)\s+(?:the\s+)?"
                      r"(negative|positive|minus|plus|[-+])?\s*([xyz])\b"
                      r"\s*[- ]?(?:direction|axis)?", t)
        if m:
            sign = -1.0 if m.group(2) in ("negative", "minus", "-") else 1.0
            material[f"body_f{m.group(3)}"] = sign * float(m.group(1))
        else:
            m = (re.search(r"downward\s+body\s+forces?\s*(?:of|=|:|is|to)?\s*"
                           + _NUM, t)
                 or re.search(_bf + _NUM + _unit_sfx
                              + r"\s*(?:acting\s+|pointing\s+)?"
                              r"(?:downwards?\b|down\b)", t))
            if m:
                # gravity-like orientation: −y in 2D, −z in 3D (reference
                # gravity rules, pde_parser_agent.py:385-393); the 1D bar
                # takes a scalar axial load (api.solve_elasticity_1D_static)
                if out.get("dim", 1) == 1:
                    material["body_force"] = float(m.group(1))
                else:
                    axis = "z" if out.get("dim") == 3 else "y"
                    material[f"body_f{axis}"] = -abs(float(m.group(1)))
            else:
                m = re.search(_bf + _NUM, t)
                if m:
                    material["body_force"] = float(m.group(1))
    if out.get("pde_type") == "elasticity":
        if re.search(r"(?:fixed|clamped|held)\s*(?:at|on)?\s*(?:the\s+)?both\s+ends", t) \
                or re.search(r"both\s+ends\s+(?:fixed|clamped|held)", t):
            # the 1D bar solver (and the reference's, ref
            # fenics_mcp_server.py:1470-1587) is fixed-free; surface the
            # mismatch in the summary instead of silently ignoring it
            out.setdefault("notes", []).append(
                "both-ends fixity requested - the 1D bar solver clamps the "
                "left end only (fixed-free), right end is traction-free")
        if re.search(r"(?<!plane )\bstrain\b(?!.*stress)", t) \
                and not re.search(r"\bstress\b", t):
            # "plane strain" is an analysis MODE, not an output-quantity
            # request (r5 battery-22)
            material["quantity"] = "strain"
        elif not re.search(r"\bstress\b|\bstrain\b", t) and re.search(
                r"\bdeflection\b|\bdisplacement\b|\belongation\b|\bsag\b"
                r"|how\s+(?:much|far)\s+(?:does|do|will|would)\b[^.;?]*?"
                r"\b(?:deflect|bend|sag|stretch|compress|shorten|extend|"
                r"move|displace)", t):
            # an explicit deflection/stretch question gets the actual
            # displacement field (extension — the reference answers with
            # von Mises stress; r5 battery-23)
            material["quantity"] = "displacement"
        if re.search(r"plane\s+strain", t):
            material["plane_stress"] = False
        elif re.search(r"plane\s+stress", t):
            material["plane_stress"] = True

        # --- surface loads (end load / traction / pressure) — extension:
        # the reference's elasticity accepts body forces only ---
        def _force_scale(u):
            return {"kn": 1e3, "mn": 1e6}.get((u or "").strip(), 1.0)

        def _press_scale(u):
            return {"kpa": 1e3, "mpa": 1e6, "gpa": 1e9}.get(
                (u or "").strip(), 1.0)

        # distributed line loads ("a uniformly distributed load of
        # 2 kN/m") are NOT point loads: record the intensity for the
        # dispatcher's body-force conversion and upgrade to the bending
        # plane (r5 battery-23: the UDL became a 2 kN END force)
        m = re.search(r"(?:uniform(?:ly)?\s+)?distributed\s+load\s*"
                      r"(?:of|=|:)?\s*" + _NUM
                      + r"\s*(kn|mn|n)?\s*(?:/|\bper\s+)\s*"
                      r"m(?:eter|etre)?\b", t)
        if m is None:
            m = re.search(r"(?:carries|under|with)\s+(?:a\s+)?" + _NUM
                          + r"\s*(kn|mn|n)\s*(?:/|\s+per\s+)\s*"
                          r"m(?:eter|etre)?\b", t)
        if m:
            material["udl"] = float(m.group(1)) * _force_scale(m.group(2))
            if out.get("dim", 1) == 1:
                out["dim"] = 2
        m = None if "udl" in material else re.search(
            r"(?:point\s+|tip\s+|end\s+|applied\s+)?"
            r"(?:load|force)\s*(?:of|=|:|to)?\s*" + _NUM
            + r"\s*(kn|mn|n)?\b(?!\s*/)", t)
        if m is None:
            # number-first phrasing: "stretched by a 20 kN tensile force"
            # (the unit is REQUIRED here to avoid matching bare counts)
            m = re.search(_NUM + r"\s*(kn|mn|n)\s+(?:tensile\s+|axial\s+|"
                          r"compressive\s+|downward\s+|vertical\s+|"
                          r"transverse\s+|sideways\s+|lateral\s+|"
                          r"point\s+|tip\s+|end\s+)?"
                          r"(?:load|force|pull|push)\b", t)
        if m is None:
            # "loaded by 10 kN", "loaded with 500 N" (r5 battery-22)
            m = re.search(r"load(?:ed)?\s+(?:by|with)\s+" + _NUM
                          + r"\s*(kn|mn|n)\b", t)
        if m is None:
            # verb-only phrasing: "pull the right end with 500 N",
            # "compressed by 50 kN" (r5 battery-17/24 — the unit is
            # required, no force/load noun)
            m = re.search(r"(?:pull|stretch|compress)\w*[^.;]{0,60}?"
                          r"\b(?:with|by)\s+"
                          + _NUM + r"\s*(kn|mn|n)\b", t)
        if m and "udl" not in material \
                and not re.search(r"body\s+forces?", t[:m.start()][-25:]):
            F = float(m.group(1)) * _force_scale(m.group(2))
            win = t[max(0, m.start() - 80):m.end() + 100]
            tip = re.search(r"(?:free\s+end|tip|end|right)", win)
            axial = re.search(r"\baxial|tension|tensile|pull|stretch"
                              r"|horizontal", win)
            compress = re.search(r"compress", win)
            down = re.search(r"downward|vertical|down\b|transverse"
                             r"|bending|sideways|lateral", win)
            dim_now = out.get("dim", 1)
            if dim_now == 1 and down and not (axial or compress):
                # a transverse/sideways load on a 1D-shaped member is a
                # BENDING problem — the 1D bar is axial-only, so upgrade
                # to the 2D cantilever plane
                out["dim"] = dim_now = 2
            if dim_now == 1 or (axial or compress) and not down:
                sign = -1.0 if compress else 1.0
                if dim_now == 1:
                    bc.setdefault("right", {"type": "force_axial",
                                            "value": sign * F})
                else:
                    vec = [sign * F] + [0.0] * (dim_now - 1)
                    bc.setdefault("right", {"type": "force", "vector": vec})
            elif tip or down:
                # tip/transverse load on a cantilever: bending, gravity-like
                # orientation (−y in 2D, −z in 3D)
                vec = [0.0] * dim_now
                vec[-1] = -abs(F)
                bc.setdefault("right", {"type": "force", "vector": vec})
        m = re.search(r"pressure\s*(?:of|=|:)?\s*" + _NUM
                      + r"\s*(gpa|mpa|kpa|pa)?\b", t)
        if m is None:
            # number-first: "under 1 kPa pressure" (unit required)
            m = re.search(_NUM + r"\s*(gpa|mpa|kpa|pa)\s+pressure\b", t)
        if m:
            p_val = float(m.group(1)) * _press_scale(m.group(2))
            # "internal pressure" names its own face — a 5 MPa internal
            # pressure landed on the OUTER wall (r5 battery-23)
            if re.search(r"(?:internal|inner)\s+pressure", t):
                faces = ["inner"]
            elif re.search(r"(?:external|outer|outside)\s+pressure", t):
                faces = ["outer"]
            else:
                faces = _face_near(m.start(), m.end(), prefer_after=True) \
                    or ["top"]
            for f in faces:
                bc.setdefault(f, {"type": "pressure", "value": p_val})
        # "applying 30 MPa tension at the right end" — a named axial
        # STRESS is a traction, not a point force (r5 battery-15)
        m = re.search(_NUM + r"\s*(gpa|mpa|kpa|pa)\s*(?:of\s+)?"
                      r"(tension|tensile\s+stress|compression|"
                      r"compressive\s+stress)\b", t)
        if m:
            s_val = float(m.group(1)) * _press_scale(m.group(2))
            if m.group(3).startswith("compress"):
                s_val = -s_val
            dim_now = max(out.get("dim", 1), 1)
            vec = [s_val] + [0.0] * (dim_now - 1)
            faces = _face_near(m.start(), m.end(), prefer_after=True) \
                or ["right"]
            for f in faces:
                bc.setdefault(f, {"type": "traction", "vector": vec})
        m = re.search(r"traction\s*(?:of|=|:)?\s*" + _NUM
                      + r"\s*(gpa|mpa|kpa|pa)?\b", t)
        if m:
            t_val = float(m.group(1)) * _press_scale(m.group(2))
            win = t[max(0, m.start() - 60):m.end() + 100]
            faces = _face_near(m.start(), m.end(), prefer_after=True) \
                or ["right"]
            dim_now = out.get("dim", 1)
            vec = [0.0] * max(dim_now, 1)
            if re.search(r"downward|vertical|shear", win) and dim_now > 1:
                vec[-1] = -t_val
            else:
                vec[0] = t_val
            for f in faces:
                bc.setdefault(f, {"type": "traction", "vector": vec})

    # --- composite core ---
    m = re.search(r"core\s+(?:of\s+)?radius\s*(?:of|=|:|to)?\s*" + _NUM + r"\s*((?:mm|cm|m)\b)?", t)
    if m:
        out["core_radius"] = float(m.group(1)) * _unit_scale(m.group(2))
    m = re.search(r"core\s+(?:diffusivity|conductivity)\s*(?:of|=|:|to)?\s*" + _NUM, t)
    if m:
        out["core_diffusivity"] = float(m.group(1))
    # keyword-only mentions (conductor/insulator/core) get context-sensitive
    # defaults in PDEParserAgent._composite_postprocess, applied to the LLM
    # path too — no flat default here

    # --- source / steady / stepping ---
    # phrase list from the reference's source rules (pde_parser_agent.py:
    # 350-358): "heat source of X", "internal heat generation of X",
    # "heating of X", "with a source X"
    # a volumetric power-density unit is unambiguous and carries its own
    # scale — try it FIRST so "volumetric heating of 2 MW/m³" scales to
    # 2e6 instead of the phrase rules grabbing the bare 2 (r5 battery-15)
    m = re.search(_NUM + r"\s*(?:(k|m)?w)\s*/?\s*(m|cm|mm)\s*[³3]", t)
    if m:
        val = float(m.group(1)) * {"k": 1e3, "m": 1e6}.get(m.group(2) or "",
                                                           1.0)
        val *= {"cm": 1e6, "mm": 1e9}.get(m.group(3), 1.0)
        out["source_type"] = "constant"
        out["source_value"] = val
        m = None
    elif not out.get("source_type"):
        m = re.search(r"(?:heat\s+)?source\s*(?:of|=|:|value|to)?\s*" + _NUM,
                      t)
    if not m and not out.get("source_type"):
        m = re.search(r"(?:internal\s+)?heat\s+generation\s*(?:of|=|:|rate(?:\s+of)?)?\s*"
                      + _NUM, t)
    if not m and not out.get("source_type"):
        m = re.search(r"\bheating\s+of\s+" + _NUM, t)
    if not m and not out.get("source_type"):
        # "generating 5e7 W/m3", "dissipating 50 W/cm3" — verb-cued
        m = re.search(r"(?:generat(?:ing|es|e)|dissipat(?:ing|es|e))\s+"
                      + _NUM + r"\s*(?:w\s*/?\s*(m|cm|mm)\s*[³3]?)?", t)
        if m:
            val = float(m.group(1))
            val *= {"cm": 1e6, "mm": 1e9}.get(m.group(2), 1.0)
            out["source_type"] = "constant"
            out["source_value"] = val
            m = None  # handled (incl. units); skip the generic setter
    if m:
        out["source_type"] = "constant"
        out["source_value"] = float(m.group(1))
    if re.search(r"steady[- ]?state|\bsteady\b|equilibrium", t):
        out["steady"] = True
    elif re.search(r"\btransient\b|\bunsteady\b|time[-\s]dependent"
                   r"|\btime\s+evolution\b", t):
        # explicit transient phrasing ("make it transient" follow-ups must
        # override a previous steady=True — r5 battery-17)
        out["steady"] = False

    # --- temperature-dependent conductivity κ(T) = κ0(1+βT) (nonlinear
    # extension; the reference is linear-only) ---
    # explicit formula "kappa = 50*(1 + 0.002*T)" / "k = 20(1 - 0.005 T)"
    # carries kappa0 AND beta, and is itself the nonlinear cue
    # (r5 battery-19: the formula was parsed as nothing at all)
    fm = re.search(r"\b(?:kappa|κ|k)\s*(?:\(\s*t\s*\))?\s*(?:=|:)\s*"
                   + _NUM + r"\s*\*?\s*\(\s*1\s*([+-])\s*" + _NUM
                   + r"\s*\*?\s*t\s*\)", t)
    if fm:
        out.setdefault("notes", []).append("nonlinear_kappa")
        out.setdefault("diffusivity", float(fm.group(1)))
        sgn = -1.0 if fm.group(2) == "-" else 1.0
        material["beta"] = sgn * float(fm.group(3))
    elif re.search(r"temperature[-\s]dependent\s+(?:thermal\s+)?"
                   r"(?:conductivity|diffusivity)"
                   r"|(?:conductivity|diffusivity)\s+(?:that\s+)?"
                   r"(?:increases|decreases|varies|depends)\s+(?:with|on)\s+"
                   r"temperature"
                   r"|nonlinear\s+(?:heat\s+)?conduct", t):
        out.setdefault("notes", []).append("nonlinear_kappa")
        m = re.search(r"(?:beta|temperature\s+coefficient)\s*"
                      r"(?:of|=|:)?\s*" + _NUM, t)
        if m:
            material["beta"] = float(m.group(1))
        if re.search(r"decreases\s+(?:with|on)\s+temperature", t):
            material["beta"] = -abs(material.get("beta", 0.01))
    m = re.search(r"(?:dt|time step)\s*(?:of|=|:|to)?\s*" + _NUM, t)
    if m:
        out["dt"] = float(m.group(1))
    m = re.search(_NUM + r"\s*(?:time\s*)?steps", t)
    if m:
        out["num_steps"] = int(float(m.group(1)))
    m = re.search(r"(?:total time|t[_\s]?final|t[_\s]?end|final\s+time|"
                  r"end\s+time|for|until|over|during|show|after|simulate|"
                  r"track\w*)\s*(?:t\s*=|=|:)?\s*"
                  r"(?:the\s+first\s+)?" + _NUM
                  + r"\s*(days?|hours?|hrs?|h|ms|millisec(?:ond)?s?|"
                  r"min(?:ute)?s?|s(?:ec(?:ond)?s?)?)\b", t)
    if m:
        u = m.group(2) or "s"
        scale = (86400.0 if u.startswith("d") else 3600.0 if u.startswith("h")
                 else 1e-3 if (u == "ms" or u.startswith("milli"))
                 else 60.0 if u.startswith("m") else 1.0)
        out["total_time"] = float(m.group(1)) * scale
    elif "total_time" not in out:
        # "show the first hour" — unit named without a number (r5 battery-14)
        m = re.search(r"the\s+first\s+(day|hour|minute)", t)
        if m:
            out["total_time"] = {"day": 86400.0, "hour": 3600.0,
                                 "minute": 60.0}[m.group(1)]
        else:
            # "for half an hour" (r5 battery-15), "two and a half hours",
            # "an hour and a half" (r5 battery-23)
            words = {"a": 1.0, "an": 1.0, "one": 1.0, "two": 2.0,
                     "three": 3.0, "four": 4.0, "five": 5.0, "six": 6.0,
                     "seven": 7.0, "eight": 8.0, "nine": 9.0, "ten": 10.0}
            units = {"day": 86400.0, "hour": 3600.0, "minute": 60.0}
            m = re.search(r"(?:for|over|during|show)\s+"
                          r"(?:(\w+)\s+and\s+a\s+half|half\s+an?)\s+"
                          r"(day|hour|minute)s?", t)
            if m and (m.group(1) is None or m.group(1) in words):
                out["total_time"] = ((words.get(m.group(1), 0.0) + 0.5)
                                     * units[m.group(2)])
            else:
                m = re.search(r"(?:for|over|during|show)\s+an?\s+"
                              r"(day|hour|minute)\s+and\s+a\s+half", t)
                if m:
                    out["total_time"] = 1.5 * units[m.group(1)]
    m = re.search(_NUM + r"\s*(?:nodes|mesh points|grid points|cells|elements)", t)
    if m:
        out["nx"] = int(float(m.group(1)))

    # --- time integration scheme (framework extension: the reference only
    # has backward Euler; "crank-nicolson" requests ride the notes channel
    # and flip SolverConfig.theta in the dispatcher) ---
    if re.search(r"crank[\s–-]*nicol?son|trapezoidal\s+(?:rule|scheme|stepping)", t):
        out.setdefault("notes", []).append("time_scheme:crank_nicolson")

    # --- modal analysis opt-in (framework extension: natural frequencies
    # and mode shapes via subspace iteration, ops/eigen.py) ---
    if re.search(r"natural\s+frequenc|eigen\s*frequenc|eigenmode"
                 r"|modal\s+analysis|(?:vibration|normal)\s+modes?"
                 r"|mode\s+shapes?|resonant?\s+frequenc", t):
        out["pde_type"] = "elasticity"
        out.setdefault("notes", []).append("modal")
        m = re.search(r"(?:first|lowest)\s+(\d+)\s+(?:natural\s+|vibration"
                      r"\s+|eigen\s*|normal\s+)?(?:modes?|frequenc)", t)
        if m:
            material["num_modes"] = int(m.group(1))
    # --- elastodynamics opt-in (framework extension: the reference's
    # elasticity is static-only) — only explicit vibration/dynamic phrasing
    # routes to the Newmark solver, so reference-style queries are untouched ---
    if out.get("pde_type") == "elasticity" and re.search(
            r"vibrat|oscillat|\bdynamic|elastodynamic", t) \
            and "modal" not in (out.get("notes") or []):
        out.setdefault("notes", []).append("dynamic")
        out["steady"] = False

    # --- coordinate system from geometry ---
    if out.get("geometry_type") == "cylinder":
        out.setdefault("coordinate_system", "cylindrical")
    elif out.get("geometry_type") == "sphere":
        out.setdefault("coordinate_system", "spherical")

    # --- radial→3D upgrade for solid cylinders with an axial extent or a
    # composite core: the reference's cylindrical-3D rule ("MUST extract
    # radius and height", pde_parser_agent.py:247-254) and every composite
    # example (:674-681) emit dim=3; the 1D radial tools remain for hollow
    # annuli/shells and explicit 1D/radial phrasing
    if (dim_radial_default and out.get("geometry_type") == "cylinder"
            and "r_inner" not in geometry_params
            and not re.search(r"\bhollow\b|\bannul|\bradial\b", t)
            and ("h" in domain or out.get("core_radius") is not None
                 or out.get("core_diffusivity") is not None)):
        out["dim"] = 3

    if domain:
        out["domain_size"] = domain
    if geometry_params:
        out["geometry_params"] = geometry_params
    # a through-thickness 1D problem stated with top/bottom faces (a wafer
    # or slab): bottom is x=0, top is x=L (r5 battery-16) — typed per-face
    # specs keep their type, Dirichlet values become the end temperatures
    if out.get("dim", 1) == 1 and not out.get("geometry_type"):
        for face, key in (("bottom", "T_left"), ("top", "T_right")):
            spec = bc.get(face)
            if isinstance(spec, dict) and spec.get("type") == "dirichlet" \
                    and set(spec) <= {"type", "value"} and key not in bc:
                # PLAIN Dirichlet only — sinusoidally-driven faces keep
                # their typed spec (amplitude/period must not be dropped)
                bc[key] = float(spec["value"])
                del bc[face]
    if bc:
        out["bc_values"] = bc
    if material:
        out["material_params"] = material
    out.setdefault("dim", 1)
    return out


# ----------------------------------------------------------------------

class PDEParserAgent:
    """NL → PDEParameters via LLM (when available) with rule-based fallback."""

    def __init__(self, llm: Optional[ChatLLM] = None):
        self.llm = llm

    def parse(self, description: str, context: Optional[str] = None) -> PDEParameters:
        params, _ = self.parse_with_provenance(description, context=context)
        return params

    def parse_with_provenance(self, description: str,
                              context: Optional[str] = None
                              ) -> Tuple[PDEParameters, str]:
        """Returns (params, source) where source ∈ {"llm", "rules"}.

        ``context`` (e.g. previous-simulation parameters for follow-ups) is
        prepended for the LLM path only — the rule-based extractor always
        sees just the user's text, merging happens in the orchestrator.
        """
        raw: Optional[Dict[str, Any]] = None
        source = "rules"
        if self.llm is not None:
            try:
                user_msg = (f"{context}\n\n{description}" if context else description)
                reply = self.llm.invoke([
                    {"role": "system", "content": PARSER_SYSTEM_PROMPT},
                    {"role": "user", "content": user_msg},
                ])
                raw = extract_json_block(reply)
                if raw:
                    source = "llm"
            except Exception:
                raw = None
        if not raw:
            raw = rule_based_parse(description)
            source = "rules"
        normalized = normalize_params_dict(raw)
        normalized = self._composite_postprocess(description, normalized)
        return PDEParameters.from_dict(normalized), source

    @staticmethod
    def _composite_postprocess(description: str, params: Dict[str, Any]) -> Dict[str, Any]:
        """Composite-material keyword detection (reference
        pde_parser_agent.py:926-996): a mentioned conductive core implies
        core parameters even if the LLM omitted them."""
        t = description.lower()
        mentions_core = bool(re.search(
            r"(?:high[- ]conductivity|conductive|copper|metal)\s+core"
            r"|core\s+(?:of|with|diffusivity)"
            # the reference's MANDATORY DETECTION keyword list
            # (pde_parser_agent.py:275-280): "heat conductor", "conductor
            # in the middle/center", "insulator", "composite material"
            r"|heat\s+conductor"
            r"|(?:conductor|insulator|core)\s+(?:in|at)\s+the\s+(?:middle|center|centre)"
            r"|composite\s+material"
            r"|with\s+an?\s+(?:conductor|insulator)\b", t))
        # composite cores exist for curvilinear heat solvers and for the 3D
        # Cartesian box (solve_heat_3D's cylinder-in-box core) — not for a
        # bare 1D/2D Cartesian mention like "a thick conductor"
        is_composite_geom = (params.get("geometry_type") in ("cylinder", "sphere")
                             or params.get("coordinate_system")
                             in ("cylindrical", "spherical")
                             or params.get("dim") == 3)
        if (mentions_core and is_composite_geom
                and params.get("pde_type", "heat") == "heat"
                and params.get("core_diffusivity") is None):
            # context defaults (pde_parser_agent.py:288-296): high → 100,
            # insulator/low → 0.01, neutral mention → 10
            if re.search(r"high\s+(?:conductivity|diffusivity)|copper|aluminum"
                         r"|aluminium|\bmetal\b", t):
                params["core_diffusivity"] = 100.0
            elif re.search(r"\binsulator\b|low\s+(?:conductivity|diffusivity)"
                           r"|\bwood\b|\bplastic\b", t):
                params["core_diffusivity"] = 0.01
            else:
                params["core_diffusivity"] = 10.0
        if params.get("core_diffusivity") is not None and params.get("core_radius") is None:
            gp = params.get("geometry_params") or {}
            r_in = gp.get("r_inner")
            r_out = gp.get("r_outer") or gp.get("cylinder_radius") \
                or gp.get("sphere_radius")
            if r_in:
                # hollow geometry: core fills the bore (reference example,
                # pde_parser_agent.py:302-305)
                params["core_radius"] = float(r_in)
            elif r_out:
                params["core_radius"] = 0.3 * float(r_out)
            elif mentions_core:
                params["core_radius"] = 0.1  # reference default :311
        # composite cylinder cores are a solve_heat_3D feature (the 1D
        # radial tool has none, matching the reference) — every reference
        # composite example emits dim=3 (pde_parser_agent.py:674-681);
        # explicit 1D/radial phrasing keeps the radial route
        if (params.get("core_diffusivity") is not None
                and params.get("geometry_type") == "cylinder"
                and params.get("dim") in (None, 1)
                and not re.search(r"\b1[- ]?d\b|one[- ]dimensional"
                                  r"|\bradial\b", t)):
            params["dim"] = 3
        return params
