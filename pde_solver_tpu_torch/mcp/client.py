"""MCP stdio client: spawns a server subprocess and speaks JSON-RPC 2.0.

The counterpart of the reference's ``MultiServerMCPClient`` usage
(multi_agent_orchestrator.py:70-78): the server process is launched with
``python -m pde_solver_tpu_torch.mcp.server`` (the port's server, never the
JAX package's ``server.py``) and messages flow newline-delimited over its
stdin/stdout.  Tool-call results arrive as JSON text content and are decoded
back into dicts.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class StdioMCPClient:
    """Async client for a newline-delimited MCP stdio server."""

    def __init__(self, server_cmd: Optional[Sequence[str]] = None,
                 request_timeout: float = 600.0):
        if server_cmd is None:
            server_cmd = [sys.executable, "-m", "pde_solver_tpu_torch.mcp.server"]
        self.server_cmd = list(server_cmd)
        self.request_timeout = request_timeout
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._next_id = 0
        self._lock = asyncio.Lock()

    # ------------------------------------------------------------------
    async def _ensure_started(self) -> None:
        if self._proc is not None and self._proc.returncode is None:
            return
        # the package's parent directory goes first on the server's path,
        # so ``-m pde_solver_tpu_torch...`` resolves from any working
        # directory (relative data_dir / output_dir stay the caller's)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        self._proc = await asyncio.create_subprocess_exec(
            *self.server_cmd,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            env=env,
        )
        await self._request("initialize", {
            "protocolVersion": "2024-11-05",
            "capabilities": {},
            "clientInfo": {"name": "pde-solver-tpu-torch-client", "version": "0.1.0"},
        })
        await self._notify("notifications/initialized", {})

    async def _request(self, method: str, params: Dict[str, Any]) -> Any:
        self._next_id += 1
        msg_id = self._next_id
        payload = {"jsonrpc": "2.0", "id": msg_id, "method": method,
                   "params": params}
        self._proc.stdin.write((json.dumps(payload) + "\n").encode())
        await self._proc.stdin.drain()
        while True:
            line = await asyncio.wait_for(self._proc.stdout.readline(),
                                          timeout=self.request_timeout)
            if not line:
                raise RuntimeError("MCP server closed the stream")
            try:
                msg = json.loads(line.decode())
            except json.JSONDecodeError:
                continue
            if msg.get("id") == msg_id:
                if "error" in msg:
                    raise RuntimeError(f"MCP error: {msg['error']}")
                return msg.get("result")

    async def _notify(self, method: str, params: Dict[str, Any]) -> None:
        payload = {"jsonrpc": "2.0", "method": method, "params": params}
        self._proc.stdin.write((json.dumps(payload) + "\n").encode())
        await self._proc.stdin.drain()

    # ------------------------------------------------------------------
    async def list_tools(self) -> List[Dict[str, Any]]:
        async with self._lock:
            await self._ensure_started()
            result = await self._request("tools/list", {})
        return result.get("tools", [])

    async def call_tool(self, name: str, arguments: Dict[str, Any]) -> Any:
        async with self._lock:
            await self._ensure_started()
            result = await self._request("tools/call",
                                         {"name": name, "arguments": arguments})
        if result.get("isError"):
            text = "".join(c.get("text", "") for c in result.get("content", []))
            return {"error": text}
        texts = [c.get("text", "") for c in result.get("content", [])
                 if c.get("type") == "text"]
        joined = "\n".join(texts)
        try:
            return json.loads(joined)
        except json.JSONDecodeError:
            return joined

    async def close(self) -> None:
        if self._proc is not None and self._proc.returncode is None:
            self._proc.stdin.close()
            try:
                await asyncio.wait_for(self._proc.wait(), timeout=5)
            except asyncio.TimeoutError:
                self._proc.kill()
        self._proc = None
