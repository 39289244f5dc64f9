"""The port's MCP stdio server and client against the JAX package's: the
protocol cases of ``tests/test_mcp.py``, the 31 tool descriptors, the
serialised payload of every tool, and a subprocess round trip of
``python -m pde_solver_tpu_torch.mcp.server`` whose stdout is read line by
line (every line must be JSON-RPC: stdout is the protocol channel).

The port's tools run on the CPU in its "mixed" policy; the JAX package's in
its float64 CPU default."""

import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu.mcp.server import _serialize_result as ref_serialize
from pde_solver_tpu.mcp.server import default_tools as ref_default_tools
from pde_solver_tpu.mcp.server import tool_descriptor as ref_descriptor
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.agents.dispatcher_agent import LocalToolSet
from pde_solver_tpu_torch.mcp.client import StdioMCPClient
from pde_solver_tpu_torch.mcp.server import (MCPServer, default_tools,
                                             tool_descriptor)
from torch_stats import port_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", precision="mixed")
CPU_ENV = {"PDE_TPU_DEVICE": "cpu", "PDE_TPU_PRECISION": "mixed"}
TOOLS = sorted(ref_default_tools())
# one small call per tool; with the route config below every tool that has
# a device path takes it (MG, flat CG, the transient scans), as at full size
SMALL = {
    "solve_heat_1D": dict(nx=8, num_steps=2),
    "solve_heat_2D": dict(nx=4, ny=4, num_steps=2),
    "solve_heat_3D": dict(nx=3, ny=3, nz=3, num_steps=2),
    "solve_heat_3D_spherical": dict(nr=3, ntheta=4, nphi=4, num_steps=2),
    "solve_heat_1D_cylindrical": dict(nr=8, num_steps=2),
    "solve_heat_1D_spherical": dict(nr=8, num_steps=2),
    "solve_heat_2D_cylindrical": dict(nr=4, nz=4, num_steps=2),
    "solve_heat_2D_spherical": dict(nr=4, ntheta=4, num_steps=2),
    "solve_elasticity_1D_static": dict(nx=8),
    "solve_elasticity_2D_static": dict(nx=4, ny=4),
    "solve_elasticity_3D_static": dict(nx=4, ny=2, nz=2),
    "solve_elasticity_3D_dynamic": dict(nx=4, ny=2, nz=2, num_steps=2),
    "solve_wave_1D": dict(nx=8, num_steps=2),
    "solve_wave_2D": dict(nx=4, ny=4, num_steps=2),
    "solve_wave_3D": dict(nx=3, ny=3, nz=3, num_steps=2),
    "solve_heat_1D_mixed": dict(nx=8, num_steps=2),
    "solve_heat_2D_mixed": dict(nx=4, ny=4, num_steps=2),
    "solve_heat_3D_mixed": dict(nx=3, ny=3, nz=3, num_steps=2),
    "solve_heat_radial_mixed": dict(nr=8, num_steps=2),
    "solve_elasticity_1D_loaded": dict(nx=8),
    "solve_elasticity_2D_loaded": dict(nx=4, ny=4),
    "solve_elasticity_3D_loaded": dict(nx=4, ny=2, nz=2),
    "solve_advection_1D": dict(nx=8, num_steps=2),
    "solve_advection_2D": dict(nx=4, ny=4, num_steps=2),
    "solve_advection_3D": dict(nx=3, ny=3, nz=3, num_steps=2),
    "solve_elasticity_2D_modal": dict(nx=8, ny=2, num_modes=2),
    "solve_elasticity_3D_modal": dict(nx=6, ny=2, nz=2, num_modes=2),
    "solve_heat_1D_nonlinear": dict(nx=8),
    "solve_heat_2D_nonlinear": dict(nx=4, ny=4),
}
ROUTE = dict(host_direct_threshold=0, mg_threshold=100,
             transient_mg_threshold=100)


def _call(srv, name, arguments, msg_id=1):
    return srv.handle({"jsonrpc": "2.0", "id": msg_id, "method": "tools/call",
                       "params": {"name": name, "arguments": arguments}})


# ----------------------------------------------------------------------
# protocol (the cases of tests/test_mcp.py)
# ----------------------------------------------------------------------

def test_initialize_and_tools_list():
    srv = MCPServer()
    resp = srv.handle({"jsonrpc": "2.0", "id": 1, "method": "initialize",
                       "params": {"protocolVersion": "2024-11-05"}})
    assert resp["result"]["protocolVersion"] == "2024-11-05"
    assert resp["result"]["serverInfo"]["name"] == "pde-solver-tpu-torch"
    assert srv.handle({"jsonrpc": "2.0",
                       "method": "notifications/initialized"}) is None
    tools = srv.handle({"jsonrpc": "2.0", "id": 2,
                        "method": "tools/list"})["result"]["tools"]
    names = [t["name"] for t in tools]
    assert len(names) == 31
    assert names == list(ref_default_tools())
    assert sorted(names) == sorted(
        asyncio.run(LocalToolSet().tool_names()))


def test_tool_descriptor_schema():
    desc = tool_descriptor(default_tools()["solve_heat_1D"])
    props = desc["inputSchema"]["properties"]
    assert props["length"] == {"type": "number", "default": 2.0}
    assert props["nx"] == {"type": "integer", "default": 50}
    assert desc["inputSchema"]["required"] == []


@pytest.mark.parametrize("tool", TOOLS)
def test_input_schema_equals_reference(tool):
    port = tool_descriptor(default_tools()[tool])
    ref = ref_descriptor(ref_default_tools()[tool])
    assert port["name"] == ref["name"] == tool
    assert port["inputSchema"] == ref["inputSchema"]


def test_tools_call_round_trip(tmp_path):
    srv = MCPServer()
    with config.config_overrides(**CPU):
        resp = _call(srv, "solve_heat_1D", {"nx": 8, "num_steps": 2,
                                            "data_dir": str(tmp_path)})
    result = resp["result"]
    assert result["isError"] is False
    payload = json.loads(result["content"][0]["text"])
    assert os.path.exists(payload["data_file"])
    assert payload["dim"] == 1


def test_tools_call_unknown_tool_is_error_content():
    resp = _call(MCPServer(), "nope", {}, msg_id=4)
    assert resp["result"]["isError"] is True


def test_unknown_method_error():
    resp = MCPServer().handle({"jsonrpc": "2.0", "id": 5,
                               "method": "bogus/method"})
    assert resp["error"]["code"] == -32601


def test_a_call_that_reaches_a_missing_card_is_error_content(tmp_path):
    """The default device is the card; without one the call fails loudly
    (``isError``) and nothing moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    resp = _call(MCPServer(), "solve_heat_1D",
                 {"nx": 8, "num_steps": 2, "data_dir": str(tmp_path)})
    assert resp["result"]["isError"] is True
    assert not list(tmp_path.iterdir())


# ----------------------------------------------------------------------
# serialised payloads: the JAX payload's keys, a JSON number where it has one
# ----------------------------------------------------------------------

def _same_shape(port, ref, path="$"):
    """Mismatches between two decoded JSON payloads: keys, and the JSON type
    of every leaf (numbers are numbers in both; bool, null and str alike).
    The port's ``solver_stats`` adds what its request adds
    (``torch_stats.port_keys``)."""
    def kind(x):
        if isinstance(x, bool) or x is None:
            return type(x).__name__
        if isinstance(x, (int, float)):
            return "number"
        return type(x).__name__

    if kind(port) != kind(ref):
        return [f"{path}: {port!r:.80} vs reference {ref!r:.80}"]
    out = []
    if isinstance(ref, dict):
        keys = set(ref)
        if path == "$.meta.solver_stats":
            keys |= port_keys()
        if set(port) != keys:
            out.append(f"{path}: keys {sorted(set(port) ^ keys)}")
        for k in set(port) & set(ref):
            out += _same_shape(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        if len(port) != len(ref):
            out.append(f"{path}: length {len(port)} vs {len(ref)}")
        for i, (a, b) in enumerate(zip(port, ref)):
            out += _same_shape(a, b, f"{path}[{i}]")
    return out


@pytest.mark.parametrize("tool", sorted(SMALL))
def test_payload_has_the_reference_keys_and_numbers(tool, tmp_path):
    kw = SMALL[tool]
    with ref_config.config_overrides(**ROUTE):
        ref = json.loads(ref_serialize(getattr(ref_api, tool)(
            **kw, data_dir=str(tmp_path / "ref"))))
    with config.config_overrides(**CPU, **ROUTE):
        text = _call(MCPServer(), tool,
                     dict(kw, data_dir=str(tmp_path / "port")))
    result = text["result"]
    assert result["isError"] is False, result
    port = json.loads(result["content"][0]["text"])
    assert _same_shape(port, ref) == []
    assert port["meta"]["solver_stats"]["converged"] is True


def test_plot_payloads_have_the_reference_keys(tmp_path):
    with config.config_overrides(**CPU):
        data_file = json.loads(_call(MCPServer(), "solve_heat_2D", dict(
            nx=4, ny=4, num_steps=2, data_dir=str(tmp_path)))["result"]
            ["content"][0]["text"])["data_file"]
    for tool, args in (
            ("plot_time_series_field_from_file", dict(data_file=data_file,
                                                     filename="f.html")),
            ("plot_time_series_field", dict(
                coords=[[0.0, 0, 0], [1.0, 0, 0]], values=[[0.0, 1.0]],
                times=[0.0], dim=1, filename="raw.html"))):
        args = dict(args, output_dir=str(tmp_path / "plots"))
        port = json.loads(_call(MCPServer(), tool, args)["result"]
                          ["content"][0]["text"])
        ref = json.loads(ref_serialize(getattr(ref_api, tool)(**args)))
        assert _same_shape(port, ref) == []
        assert port == ref


# ----------------------------------------------------------------------
# the server as a subprocess
# ----------------------------------------------------------------------

def _server_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PDE_TPU_") and k != "OPENAI_API_KEY"}
    env.update(extra)
    return env


def test_raw_stdio_lines_are_all_json_rpc(tmp_path):
    """Solve, plot and a bad tool over raw JSON-RPC lines; every stdout line
    of the server parses as a JSON-RPC 2.0 response."""
    data = str(tmp_path / "data")
    plots = str(tmp_path / "plots")
    lines = [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize",
         "params": {"protocolVersion": "2024-11-05"}},
        {"jsonrpc": "2.0", "method": "notifications/initialized"},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
         "params": {"name": "solve_heat_1D",
                    "arguments": {"nx": 8, "num_steps": 2, "data_dir": data}}},
        {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
         "params": {"name": "does_not_exist", "arguments": {}}},
    ]
    proc = subprocess.run(
        [sys.executable, "-m", "pde_solver_tpu_torch.mcp.server"],
        input="".join(json.dumps(m) + "\n" for m in lines), cwd=REPO,
        env=_server_env(**CPU_ENV, PDE_TPU_LOG_LEVEL="INFO"),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    # INFO logging goes to stderr, with each call's seconds and launches
    assert "INFO tools/call solve_heat_1D: " in proc.stderr
    out = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [m["jsonrpc"] for m in out] == ["2.0"] * 4
    assert [m["id"] for m in out] == [1, 2, 3, 4]
    assert len(out[1]["result"]["tools"]) == 31
    solved = json.loads(out[2]["result"]["content"][0]["text"])
    assert out[2]["result"]["isError"] is False
    assert os.path.exists(solved["data_file"])
    assert out[3]["result"]["isError"] is True

    # the plot, on a second server (a fresh process per request batch)
    plot_req = {"jsonrpc": "2.0", "id": 5, "method": "tools/call",
                "params": {"name": "plot_time_series_field_from_file",
                           "arguments": {"data_file": solved["data_file"],
                                         "output_dir": plots}}}
    proc = subprocess.run(
        [sys.executable, "-m", "pde_solver_tpu_torch.mcp.server"],
        input=json.dumps(plot_req) + "\n", cwd=REPO,
        env=_server_env(**CPU_ENV), capture_output=True, text=True,
        timeout=60)
    (resp,) = [json.loads(line) for line in proc.stdout.splitlines()]
    html_path = json.loads(resp["result"]["content"][0]["text"])["html_path"]
    assert "Plotly.newPlot" in open(html_path).read()


def test_client_round_trip_starts_the_port_server(tmp_path, monkeypatch):
    """The port's client starts ``python -m pde_solver_tpu_torch.mcp.server``
    (never the JAX package's ``server.py``) from any working directory."""
    client = StdioMCPClient(request_timeout=60)
    assert client.server_cmd == [sys.executable, "-m",
                                 "pde_solver_tpu_torch.mcp.server"]
    for k, v in CPU_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)

    async def scenario():
        try:
            tools = await client.list_tools()
            assert len(tools) == 31
            res = await client.call_tool("solve_heat_1D", {
                "nx": 8, "num_steps": 2, "data_dir": "data"})
            assert os.path.exists(res["data_file"])
            assert res["meta"]["solver_stats"]["converged"] is True
            plot = await client.call_tool("plot_time_series_field_from_file",
                                          {"data_file": res["data_file"],
                                           "output_dir": "plots"})
            assert os.path.exists(plot["html_path"])
            bad = await client.call_tool("does_not_exist", {})
            assert "error" in bad
        finally:
            await client.close()

    asyncio.run(scenario())
    # relative paths resolved in the caller's working directory
    assert list((tmp_path / "data").glob("heat_1d_*.pkl"))
    assert list((tmp_path / "plots").glob("*.html"))


@pytest.mark.parametrize("env,device", [({}, "cuda"),
                                        ({"PDE_TPU_DEVICE": "cpu"}, "cpu")])
def test_pde_tpu_device_selects_the_device(env, device):
    code = ("from pde_solver_tpu_torch import config;"
            "print(config.get_config().device)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_server_env(**env), capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == device
