"""Multi-agent orchestrator: session driver for natural-language PDE solving.

Behavior parity with the reference orchestrator
(multi_agent_orchestrator.py:30-941): greeting/non-PDE
detection with PDE-keyword priority, optional LLM query validation (lenient
on failure), follow-up detection against conversation memory, domain-size
re-normalization from the raw text, parameter merging that only overrides
explicitly-mentioned fields, dispatch, memory recording, and a CLI chat loop.

Differences by design:
* the LLM is optional — with no API key the parser runs rule-based and
  validation is skipped, so the whole stack works offline;
* solvers run in-process by default (LocalToolSet) instead of requiring an
  MCP stdio subprocess; pass ``toolset=MCPToolSet()`` for the reference
  topology.
"""

from __future__ import annotations

import asyncio
import re
from typing import Any, Dict, Optional, Tuple

from pde_solver_tpu_torch.agents.dispatcher_agent import DispatcherAgent, ToolSet
from pde_solver_tpu_torch.agents.llm import ChatLLM, default_llm, extract_json_block
from pde_solver_tpu_torch.agents.memory import ConversationMemory
from pde_solver_tpu_torch.agents.parser_agent import PDEParserAgent
from pde_solver_tpu_torch.schema import PDEParameters

_PDE_KEYWORDS = [
    "heat", "temperature", "diffusion", "conduction", "transfer",
    "elasticity", "stress", "strain", "displacement", "force",
    "solve", "simulate", "simulation", "pde", "equation",
    "rod", "bar", "plate", "cube", "domain", "boundary",
    "1d", "2d", "3d", "one-dimensional", "two-dimensional", "three-dimensional",
    "initial", "condition", "young", "modulus", "poisson", "ratio",
    "length", "meter", "m ", "lx", "ly", "lz", "width", "height", "depth",
    "celsius", "c ", "kelvin", "pa", "gpa", "source", "steady", "transient",
    "cylinder", "sphere",
]

_GREETINGS = [
    "hi", "hello", "hey", "greetings", "good morning", "good afternoon",
    "good evening", "what's up", "whats up", "how are you", "how do you do",
    "nice to meet you", "thanks", "thank you", "bye", "goodbye", "see you",
    "see ya",
]

_FOLLOWUP_KEYWORDS = [
    "change", "modify", "update", "different", "same", "again",
    "repeat", "rerun", "previous", "last", "before", "instead",
    "with", "without", "adjust", "set", "make", "add", "remove",
    "increase", "decrease", "new", "also", "too", "and",
]

_GEOMETRY_KEYWORDS = ["rod", "bar", "plate", "cube", "domain", "length",
                      "meter", "m ", "lx", "ly", "lz", "width", "height",
                      "depth",
                      # curvilinear/self-contained shapes: a full query
                      # naming its own geometry is NOT a follow-up (r4 CLI
                      # battery: "heat in a sphere of radius 0.5 m, ..."
                      # inherited pde_type=elasticity from a stale context)
                      "cylinder", "sphere", "shell", "tube", "pipe", "ball",
                      "tunnel", "radius", "box", "beam", "cantilever",
                      "cm ", "mm "]

_VALIDATION_PROMPT = """You are a PDE problem validator. Decide whether the user query describes a
partial-differential-equation problem solvable with numerical methods (heat
transfer/diffusion, elasticity, wave, or similar field equations over spatial
domains with boundary conditions). General questions, arithmetic, jokes or
chit-chat are NOT PDE problems.

User query: "{query}"

Respond with ONLY a JSON object:
{{"is_pde_problem": true/false, "justification": "one or two sentences"}}
Be strict: if ambiguous or unclear, return false."""


class MultiAgentOrchestrator:
    """Coordinates the parser and dispatcher agents with conversation memory."""

    def __init__(self, model_name: str = "gpt-4o", temperature: float = 0.0,
                 memory_file: Optional[str] = "conversation_memory.json",
                 llm: Optional[ChatLLM] = None,
                 toolset: Optional[ToolSet] = None,
                 require_llm: bool = False):
        if llm is None:
            llm = default_llm()
        if llm is None and require_llm:
            raise RuntimeError(
                "OPENAI_API_KEY not found. Please set it in your environment "
                "or create a .env file with OPENAI_API_KEY=your_key")
        self.llm = llm
        self.memory = ConversationMemory(persist_file=memory_file)
        self.parser_agent = PDEParserAgent(llm=llm)
        self.dispatcher_agent = DispatcherAgent(toolset=toolset, llm=llm)
        self._initialized = True

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    async def solve(self, description: str) -> Dict[str, Any]:
        """NL query → {pde_params, dispatch_result, summary, html_path,
        data_file} (or {response, status} for greetings / {error, ...})."""
        if self._is_greeting_or_non_pde_query(description):
            response = self._handle_greeting(description)
            self.memory.add_user_message(description)
            self.memory.add_ai_message(response)
            self.memory.save()
            return {"response": response, "html_path": None, "data_file": None,
                    "status": "greeting", "summary": response}

        self.memory.add_user_message(description)
        is_followup = self._is_followup_question(description)

        if not is_followup:
            is_pde, justification = self._validate_pde_query(description)
            if not is_pde:
                response = (
                    "I can only solve PDE problems (heat transfer and elasticity). "
                    f"This query doesn't look like one: {justification}\n\n"
                    "Try something like: \"Solve 1D heat transfer in a 2 meter rod, "
                    "left end at 20°C, right end at 0°C\"")
                self.memory.add_ai_message(response)
                self.memory.save()
                return {"response": response, "html_path": None, "data_file": None,
                        "status": "not_pde", "summary": response}

        try:
            # Parse (follow-ups get the previous parameters as context)
            if is_followup and self.memory.current_simulation \
                    and self.memory.current_simulation.pde_params:
                prev = self.memory.current_simulation.pde_params
                context = (self._format_previous_params(prev)
                           + "\n\nUser's follow-up request:")
                new_params = self.parser_agent.parse(description, context=context)
                params = self._merge_parameters(prev, new_params, description)
            else:
                params = self.parser_agent.parse(description)
                params.domain_size = self._normalize_domain_size(
                    params.domain_size, params.dim, description)
                # the parser's _robin_update carrier is a follow-up patch;
                # on a FRESH query it must not leak downstream as a bogus
                # face.  A standalone film coefficient here implies
                # convection on the exposed surface (r5 battery-14).
                upd = (params.bc_values or {}).pop("_robin_update", None)
                if upd and "h" in upd:
                    params.bc_values.setdefault("all", {
                        "type": "robin", "h": upd["h"],
                        "T_ambient": upd.get("T_ambient", 20.0)})

            dispatch_result = await self.dispatcher_agent.dispatch(params)
            if "error" in dispatch_result:
                response = f"Solver error: {dispatch_result['error']}"
                self.memory.add_ai_message(response)
                self.memory.save()
                return {"error": dispatch_result["error"],
                        "pde_params": params.to_dict(),
                        "solver_args": dispatch_result.get("solver_args"),
                        "summary": response}

            summary = dispatch_result.get("summary", "")
            self.memory.add_ai_message(summary)
            self.memory.record_simulation(
                user_query=description,
                pde_params=params.to_dict(),
                solver_result=_plain(dispatch_result.get("solver_result")),
                html_path=dispatch_result.get("html_path"),
                data_file=dispatch_result.get("data_file"),
                summary=summary,
            )
            self.memory.save()
            return {
                "pde_params": params.to_dict(),
                "dispatch_result": dispatch_result,
                "summary": summary,
                "html_path": dispatch_result.get("html_path"),
                "data_file": dispatch_result.get("data_file"),
            }
        except Exception as exc:
            response = f"Failed to process the request: {exc}"
            self.memory.add_ai_message(response)
            self.memory.save()
            return {"error": str(exc), "summary": response}

    # ------------------------------------------------------------------
    # Detection helpers
    # ------------------------------------------------------------------

    def _is_greeting_or_non_pde_query(self, description: str) -> bool:
        """PDE keywords take priority over greeting words
        (multi_agent_orchestrator.py:330-370)."""
        t = description.lower().strip()
        if any(k in t for k in _PDE_KEYWORDS):
            return False
        if len(t) <= 5 and any(g in t for g in ("hi", "hey", "bye", "ok", "yes",
                                                "no", "okay")):
            return True
        return any(g in t for g in _GREETINGS)

    def _handle_greeting(self, description: str) -> str:
        t = description.lower().strip()
        if any(w in t for w in ("thanks", "thank you")):
            return ("You're welcome! Feel free to ask me any PDE problems "
                    "you'd like to solve.")
        if any(w in t for w in ("bye", "goodbye", "see you")):
            return "Goodbye! Come back anytime with your PDE problems."
        return (
            "Hello! I'm a PDE solver assistant running on a PyTorch/CUDA FEM "
            "framework. I can solve:\n"
            "- Heat transfer problems (1D/2D/3D, Cartesian, cylindrical, spherical)\n"
            "- Static elasticity problems (1D bar, 2D plane stress/strain, 3D)\n"
            "- Transient and steady-state modes, heat sources, composite materials\n\n"
            "Try: \"Solve 1D heat transfer in a 2 meter rod, left end at 20°C, "
            "right end at 0°C\"")

    def _validate_pde_query(self, description: str) -> Tuple[bool, str]:
        """LLM validation with lenient fallback
        (multi_agent_orchestrator.py:372-440); in keyless rule-based mode a
        keyword screen stands in — a query with not one physics word would
        otherwise be "solved" as the default problem."""
        if self.llm is None:
            t = description.lower()
            physics = re.search(
                r"heat|thermal|temperatur|diffus|conduct|cool|quench|"
                r"insulat|convect|flux|elastic|stress|strain|deform|load|"
                r"force|pressure|beam|cantilever|vibrat|oscillat|wave|"
                r"advect|pollutant|tracer|plume|smoke|poisson|laplace|"
                r"\bpde\b|equation|solve|simulat|\brod\b|plate|cylinder|"
                r"sphere|membrane|bend|frequenc|modal|°|degrees|\bbar\b|"
                r"\bu\s*\(", t)
            if physics is None:
                return False, ("no heat/elasticity/wave/advection vocabulary "
                               "found (rule-based screen)")
            return True, "rule-based mode: physics keywords present"
        try:
            reply = self.llm.invoke([
                {"role": "system",
                 "content": "You are a PDE problem validator. Always respond with valid JSON."},
                {"role": "user", "content": _VALIDATION_PROMPT.format(query=description)},
            ])
            parsed = extract_json_block(reply) or {}
            return (bool(parsed.get("is_pde_problem", False)),
                    str(parsed.get("justification", "No justification provided.")))
        except Exception as exc:
            return True, f"Validation error ({exc}) — proceeding with PDE assumption."

    def _is_followup_question(self, description: str) -> bool:
        """(multi_agent_orchestrator.py:473-508)"""
        if not self.memory.current_simulation:
            return False
        t = description.lower().strip()
        if any(k in t for k in _FOLLOWUP_KEYWORDS):
            return True
        if len(description.split()) <= 6:
            return True
        if not any(k in t for k in _GEOMETRY_KEYWORDS):
            return True
        return False

    @staticmethod
    def _format_previous_params(prev: Dict[str, Any]) -> str:
        lines = ["Previous simulation parameters (preserve these unless "
                 "explicitly changed):", ""]
        for key, val in prev.items():
            if val not in (None, {}, []):
                lines.append(f"{key}: {val}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # Normalization + merging
    # ------------------------------------------------------------------

    @staticmethod
    def _normalize_domain_size(domain_size: Dict[str, Any], dim: int,
                               description: str = "") -> Dict[str, float]:
        """Repair malformed {"domain_size": value} nests, re-extracting the
        true extents from the raw text when possible
        (multi_agent_orchestrator.py:574-644)."""
        if not domain_size:
            return {}
        if not ("domain_size" in domain_size
                and isinstance(domain_size["domain_size"], (int, float))):
            return domain_size
        value = float(domain_size["domain_size"])
        tl = (description or "").lower()
        has_thick = "thick" in tl
        if dim == 1 and has_thick and value < 1e-6:
            return {"length": 2.0}
        num = r"(\d+(?:\.\d+)?)"
        if dim == 2 and description:
            m = re.findall(num + r"\s*m\s*[x\*×]\s*" + num + r"\s*m", description,
                           re.IGNORECASE)
            if m:
                return {"Lx": float(m[0][0]), "Ly": float(m[0][1])}
        if dim == 3 and description:
            m = re.findall(num + r"\s*m\s*[x\*×]\s*" + num + r"\s*m\s*[x\*×]\s*"
                           + num + r"\s*m", description, re.IGNORECASE)
            if m:
                return {"Lx": float(m[0][0]), "Ly": float(m[0][1]),
                        "Lz": float(m[0][2])}
        if dim == 1:
            return {"length": value}
        if dim == 2:
            return {"Lx": value, "Ly": value}
        if dim == 3:
            return {"Lx": value, "Ly": value, "Lz": value}
        return {}

    def _merge_parameters(self, prev: Dict[str, Any], new: PDEParameters,
                          description: str) -> PDEParameters:
        """Start from the previous simulation; override only fields the
        follow-up explicitly mentions (multi_agent_orchestrator.py:646-819)."""
        merged = PDEParameters.from_dict(prev)
        merged.domain_size = dict(prev.get("domain_size") or {})
        merged.bc_values = dict(prev.get("bc_values") or {})
        merged.material_params = dict(prev.get("material_params") or {})
        merged.geometry_params = dict(prev.get("geometry_params") or {})

        t = description.lower()
        # dimension: only override on explicit mention
        dim_sets = {1: ("1d", "1-d", "one-dimensional", "one dimensional",
                        "rod", "bar", "wire", "string"),
                    2: ("2d", "2-d", "two-dimensional", "two dimensional",
                        "plate", "sheet", "membrane"),
                    3: ("3d", "3-d", "three-dimensional", "three dimensional",
                        "cube", "box")}
        explicit_dim = next((d for d, kws in dim_sets.items()
                             if any(k in t for k in kws)), None)
        if explicit_dim is not None:
            merged.dim = explicit_dim
        elif prev.get("dim", 1) == 1 and new.dim and new.dim != 1:
            merged.dim = new.dim

        if (explicit_dim is not None and explicit_dim != prev.get("dim")
                and (new.bc_values or new.initial_value is not None)):
            # an explicit dimension switch that carries its own boundary or
            # initial data is a NEW problem statement misclassified as a
            # follow-up by the 'and'/'with' keywords — stale per-face BCs
            # from the old shape must not leak (r5 battery-14: a 1D rod
            # followed by a self-contained 2D plate-in-air query kept the
            # rod's T_left/T_right Dirichlet edges)
            merged.bc_values = {}

        if any(k in t for k in ("wave", "advection", "poisson", "laplace",
                                "elasticity")) \
                and new.pde_type and new.pde_type != "heat":
            merged.pde_type = new.pde_type
        elif new.pde_type == "elasticity" and any(
                k in t for k in ("elastic", "stress", "strain",
                                 "displacement", "deform", "cantilever",
                                 "clamp", "body force", "gravity", "loaded",
                                 "vibrat", "oscillat", "self-weight",
                                 "own weight")):
            # the parser infers elasticity from these cues (it never sees
            # the literal word "elasticity" in e.g. "a steel beam under
            # gravity, fixed at the left face") — a follow-up-classified
            # but self-contained query carrying such a cue IS the explicit
            # mention the reference's merge rule asks for (r4 CLI battery:
            # 'and'/'with' in any full query makes it a "follow-up", and
            # the stale heat pde_type silently survived)
            merged.pde_type = "elasticity"
        elif new.pde_type == "heat" and any(
                k in t for k in ("heat", "temperature", "thermal",
                                 "diffusion", "conduction")):
            # symmetric switch-back: an explicit heat mention overrides a
            # previous elasticity context (reference rule: "DO NOT change
            # pde_type unless explicitly mentioned" — this IS the mention)
            merged.pde_type = "heat"

        # A geometry switch means a NEW problem's shape — inheriting the
        # previous shape's per-face boundary data onto a different geometry
        # is never right (r4 CLI battery: a self-contained sphere-quench
        # query classified as follow-up by the 'with' keyword dragged a
        # slab's flux/Dirichlet faces along).  Start geometry-coupled
        # fields from the new parse alone.
        if (new.geometry_type
                and new.geometry_type != prev.get("geometry_type")):
            merged.bc_values = {}
            merged.geometry_params = {}
            merged.domain_size = {}
            merged.core_radius = None
            merged.core_diffusivity = None

        if new.domain_size:
            dim_for_norm = new.dim if new.dim is not None else merged.dim
            merged.domain_size = self._normalize_domain_size(
                new.domain_size, dim_for_norm, description)
        for attr in ("nx", "ny", "nz", "initial_value", "initial_amplitude",
                     "initial_wavenumber", "source_value", "dt", "num_steps",
                     "total_time", "diffusivity", "young_modulus",
                     "poisson_ratio", "density", "core_radius",
                     "core_diffusivity", "wave_speed"):
            val = getattr(new, attr)
            if val is not None:
                setattr(merged, attr, val)
        if new.bc_values:
            # a face set by the follow-up replaces the SAME face's stale
            # spec in the other representation too: "add convection on the
            # right" must drop a previous T_right Dirichlet, and "set the
            # right end to 50" must drop a previous typed right-face spec
            # (r5 battery-17: both coexisted and the solve saw conflicting
            # BCs on one face)
            scalar_of = {"left": "T_left", "right": "T_right",
                         "inner": "T_inner", "outer": "T_outer",
                         "side": "T_side", "sides": "T_side",
                         "all": "T_boundary"}
            face_of = {v: k for k, v in scalar_of.items() if k != "sides"}
            for k in new.bc_values:
                if k in scalar_of:
                    merged.bc_values.pop(scalar_of[k], None)
                elif k in face_of:
                    merged.bc_values.pop(face_of[k], None)
                    if k == "T_side":
                        merged.bc_values.pop("sides", None)
            merged.bc_values.update(new.bc_values)
        # standalone h/ambient follow-ups ("change the heat transfer
        # coefficient to 50") apply to every existing robin face spec
        robin_upd = merged.bc_values.pop("_robin_update", None)
        if robin_upd:
            for key, val in list(merged.bc_values.items()):
                if (isinstance(val, dict) and str(val.get("type", "")).lower()
                        in ("robin", "convection", "convective")):
                    patched = dict(val)
                    patched.update(robin_upd)
                    merged.bc_values[key] = patched
        if new.material_params:
            merged.material_params.update(new.material_params)
        if new.geometry_params:
            merged.geometry_params.update(new.geometry_params)
        if new.geometry_type:
            merged.geometry_type = new.geometry_type
        if new.coordinate_system:
            merged.coordinate_system = new.coordinate_system
        if new.initial_type:
            merged.initial_type = new.initial_type
        if new.source_type and new.source_type != "none":
            merged.source_type = new.source_type
        if re.search(r"(?:remove|drop|turn\s+off|switch\s+off|without|no)\s+"
                     r"(?:the\s+)?(?:heat\s+)?(?:source|generation)", t):
            # explicit source removal ("remove the heat source" silently
            # kept the previous source — r5 battery-17)
            merged.source_type = "none"
            merged.source_value = None
        if new.steady is not None:
            merged.steady = new.steady
        if new.field_name:
            merged.field_name = new.field_name
        if new.unit:
            merged.unit = new.unit

        changed = [label for label, cond in (
            ("domain", bool(new.domain_size)),
            ("boundary conditions", bool(new.bc_values)),
            ("initial condition", new.initial_value is not None),
            ("source term", bool(new.source_type) or new.source_value is not None),
            ("steady-state mode", new.steady is not None),
        ) if cond]
        merged.notes = ([f"Modified: {', '.join(changed)}. All other parameters "
                         "preserved from previous simulation."]
                        if changed else
                        ["All parameters preserved from previous simulation."])
        return merged

    # ------------------------------------------------------------------

    def get_memory(self) -> ConversationMemory:
        return self.memory

    def clear_memory(self) -> None:
        self.memory.clear()
        self.memory.save()


def _plain(obj: Any) -> Any:
    """Make a result JSON-serializable for memory persistence."""
    import dataclasses
    import json as _json
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
    try:
        _json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return str(obj)


# ----------------------------------------------------------------------
# CLI chat loop (reference multi_agent_orchestrator.py:831-941)
# ----------------------------------------------------------------------

async def run_chat_loop() -> None:
    orch = MultiAgentOrchestrator()
    mode = "LLM-assisted" if orch.llm is not None else "rule-based (no API key)"
    print(f"PDE solver chat — {mode}. Commands: exit/quit, clear, history.")
    while True:
        try:
            user_input = input("\nYou: ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not user_input:
            continue
        if user_input.lower() in ("exit", "quit"):
            break
        if user_input.lower() == "clear":
            orch.clear_memory()
            print("Memory cleared.")
            continue
        if user_input.lower() == "history":
            for rec in orch.memory.simulation_history:
                print(f"- [{rec.timestamp}] {rec.user_query}")
            continue
        result = await orch.solve(user_input)
        print("\n" + str(result.get("summary", result)))
        if result.get("html_path"):
            print(f"\nInteractive plot: {result['html_path']}")


if __name__ == "__main__":
    asyncio.run(run_chat_loop())
