"""MCP stdio server of the port: JSON-RPC 2.0 loop exposing the 31
solver/plot tools of ``pde_solver_tpu_torch.api``.

Run it as ``python -m pde_solver_tpu_torch.mcp.server``.  The solves run on
the card unless ``PDE_TPU_DEVICE=cpu`` is set (``config._GLOBAL``); a tool
that fails, a missing card included, answers with ``isError`` content.

Protocol subset implemented (matching what LangChain/FastMCP clients use):

* ``initialize`` → protocol version + capabilities + serverInfo
* ``notifications/initialized`` (ignored)
* ``tools/list`` → tool descriptors with JSON input schemas generated from
  the ``pde_solver_tpu_torch.api`` signatures
* ``tools/call`` → runs the tool, returns the result as JSON text content
  (dataclasses serialized to dicts), or ``isError`` content on failure; logs
  (INFO, stderr) its seconds and the kernel launches it made
* ``ping`` → {}

Messages are newline-delimited JSON on stdio.  All solver logging goes to
stderr so the JSON-RPC channel stays clean — the concern the reference
spends ~90 lines of stdout-capture shims on (fenics_mcp_server.py:72-159);
here nothing in the solve path prints to stdout in the first place.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import sys
import time
import traceback
import typing
from typing import Any, Callable, Dict, List, Optional

from pde_solver_tpu_torch.ops import stencil_kernels
from pde_solver_tpu_torch.utils.observability import get_logger

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "pde-solver-tpu-torch", "version": "0.1.0"}

_TYPE_MAP = {float: "number", int: "integer", str: "string", bool: "boolean"}


def _json_type(annotation) -> Dict[str, Any]:
    origin = typing.get_origin(annotation)
    if origin is typing.Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return _json_type(args[0])
        return {}
    if annotation in _TYPE_MAP:
        return {"type": _TYPE_MAP[annotation]}
    if origin in (list, typing.List):
        return {"type": "array"}
    if origin in (dict, typing.Dict):
        return {"type": "object"}
    return {}


def tool_descriptor(fn: Callable) -> Dict[str, Any]:
    """Build an MCP tool descriptor (name/description/inputSchema) from a
    Python function signature."""
    sig = inspect.signature(fn)
    props: Dict[str, Any] = {}
    required: List[str] = []
    hints = typing.get_type_hints(fn)
    for name, param in sig.parameters.items():
        schema = _json_type(hints.get(name, param.annotation))
        if param.default is not inspect.Parameter.empty:
            if param.default is not None:
                schema = {**schema, "default": param.default}
        else:
            required.append(name)
        props[name] = schema or {}
    return {
        "name": fn.__name__,
        "description": inspect.getdoc(fn) or "",
        "inputSchema": {"type": "object", "properties": props,
                        "required": required},
    }


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Kernel launches by name since the ``KERNEL_LAUNCHES`` snapshot
    ``before`` (what one tool call launched on the card)."""
    now = stencil_kernels.KERNEL_LAUNCHES
    return {k: n - before.get(k, 0) for k, n in sorted(now.items())
            if n != before.get(k, 0)}


def _serialize_result(result: Any) -> str:
    if dataclasses.is_dataclass(result):
        result = dataclasses.asdict(result)
    return json.dumps(result, default=str)


class MCPServer:
    """Newline-delimited JSON-RPC 2.0 loop over stdio."""

    def __init__(self, tools: Optional[Dict[str, Callable]] = None):
        self.tools = tools if tools is not None else default_tools()

    # ------------------------------------------------------------------
    def handle(self, message: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Handle one request; returns the response (None for notifications)."""
        method = message.get("method")
        msg_id = message.get("id")
        is_notification = msg_id is None

        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": SERVER_INFO,
                }
            elif method in ("notifications/initialized", "initialized"):
                return None
            elif method == "ping":
                result = {}
            elif method == "tools/list":
                result = {"tools": [tool_descriptor(fn) for fn in self.tools.values()]}
            elif method == "tools/call":
                params = message.get("params") or {}
                name = params.get("name")
                args = params.get("arguments") or {}
                if name not in self.tools:
                    raise ValueError(f"Unknown tool: {name}")
                t0 = time.perf_counter()
                before = dict(stencil_kernels.KERNEL_LAUNCHES)
                out = self.tools[name](**args)
                get_logger().info(
                    "tools/call %s: %.3f s, kernel launches %s", name,
                    time.perf_counter() - t0, json.dumps(_launches_since(before)))
                result = {
                    "content": [{"type": "text", "text": _serialize_result(out)}],
                    "isError": False,
                }
            else:
                if is_notification:
                    return None
                return {"jsonrpc": "2.0", "id": msg_id,
                        "error": {"code": -32601, "message": f"Method not found: {method}"}}
        except Exception as exc:
            traceback.print_exc(file=sys.stderr)
            if method == "tools/call":
                return {"jsonrpc": "2.0", "id": msg_id,
                        "result": {"content": [{"type": "text", "text": str(exc)}],
                                   "isError": True}}
            if is_notification:
                return None
            return {"jsonrpc": "2.0", "id": msg_id,
                    "error": {"code": -32603, "message": str(exc)}}
        if is_notification:
            return None
        return {"jsonrpc": "2.0", "id": msg_id, "result": result}

    # ------------------------------------------------------------------
    def run_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                message = json.loads(line)
            except json.JSONDecodeError:
                continue
            response = self.handle(message)
            if response is not None:
                stdout.write(json.dumps(response) + "\n")
                stdout.flush()


def default_tools() -> Dict[str, Callable]:
    """The reference's 13-tool surface (same names as its MCP server), plus
    the elastodynamics extension tool."""
    from pde_solver_tpu_torch import api
    names = [
        "solve_heat_1D", "solve_heat_2D", "solve_heat_3D_spherical",
        "solve_heat_3D", "solve_heat_1D_cylindrical", "solve_heat_1D_spherical",
        "solve_heat_2D_cylindrical", "solve_heat_2D_spherical",
        "solve_elasticity_1D_static", "solve_elasticity_2D_static",
        "solve_elasticity_3D_static", "plot_time_series_field_from_file",
        "plot_time_series_field",
        # extensions beyond the reference (see api.solve_elasticity_3D_dynamic
        # and api.solve_wave_1D — the reference parses pde_type="wave" but
        # has no solver for it)
        "solve_elasticity_3D_dynamic",
        "solve_wave_1D", "solve_wave_2D", "solve_wave_3D",
        # per-face Dirichlet/Robin/Neumann/insulated heat BCs — the
        # reference is Dirichlet-only (fenics_mcp_server.py:294-297)
        "solve_heat_1D_mixed", "solve_heat_2D_mixed", "solve_heat_3D_mixed",
        "solve_heat_radial_mixed",
        # surface loads (end load / traction / pressure) — the reference's
        # elasticity accepts body forces only (fenics_mcp_server.py:1670-1674)
        "solve_elasticity_1D_loaded", "solve_elasticity_2D_loaded",
        "solve_elasticity_3D_loaded",
        # advection-diffusion — the reference parses pde_type="advection"
        # (pde_schema.py:15) but has no solver for it
        "solve_advection_1D", "solve_advection_2D", "solve_advection_3D",
        # modal analysis (natural frequencies/mode shapes) — the reference
        # has no eigen capability
        "solve_elasticity_2D_modal", "solve_elasticity_3D_modal",
        # nonlinear conductivity k(T) — the reference is linear-only
        "solve_heat_1D_nonlinear", "solve_heat_2D_nonlinear",
    ]
    return {n: getattr(api, n) for n in names}


def main() -> None:
    MCPServer().run_stdio()


if __name__ == "__main__":
    main()
