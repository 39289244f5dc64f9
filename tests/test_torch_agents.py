"""The port's agent layer (parser, dispatcher, orchestrator, memory) against
the JAX package's: the same query gives the same parameters, the same tool
and the same arguments; a conversation of follow-ups merges to the same
parameters; and the nine ``app.EXAMPLES`` run end to end through both
orchestrators on the CPU with fields that agree.

The queries are every string the JAX package's ``tests/test_agents.py``
parses or sends to an orchestrator, read from that file, plus the examples.
The parser runs rule-based (``llm=None``, no network)."""

import ast
import asyncio
import os

import numpy as np
import pytest

import app as ref_app
from pde_solver_tpu import config as ref_config
from pde_solver_tpu.agents import dispatcher_agent as ref_dispatcher
from pde_solver_tpu.agents import orchestrator as ref_orchestrator
from pde_solver_tpu.agents import parser_agent as ref_parser
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu_torch import app, config
from pde_solver_tpu_torch.agents import dispatcher_agent, orchestrator
from pde_solver_tpu_torch.agents import parser_agent
from pde_solver_tpu_torch.fields import load_field

TESTS = os.path.dirname(os.path.abspath(__file__))
CPU = dict(device="cpu", precision="mixed")


def _agent_test_strings():
    """(queries, conversations) of tests/test_agents.py: the first string
    argument of every parse / solve call, and the ``solve`` strings of each
    test function that sends two or more, in source order."""
    with open(os.path.join(TESTS, "test_agents.py")) as f:
        tree = ast.parse(f.read())
    queries, conversations = [], []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        said = []
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call) and call.args
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                continue
            f = call.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name in ("rule_based_parse", "parse", "parse_with_provenance",
                        "solve"):
                queries.append(call.args[0].value)
            if name == "solve":
                said.append((call.lineno, call.args[0].value))
        if len(said) >= 2:
            conversations.append([q for _, q in sorted(said)])
    return list(dict.fromkeys(queries)), conversations


_QUERIES, _CONVERSATIONS = _agent_test_strings()
QUERIES = list(dict.fromkeys(_QUERIES + list(ref_app.EXAMPLES)))
CONVERSATIONS = _CONVERSATIONS + [
    [ref_app.EXAMPLES[0], "change the left boundary to 50°C"]]


class _Recording(dispatcher_agent.ToolSet):
    """Records every tool call; returns a result of the right form without
    solving anything."""

    def __init__(self):
        self.calls = []

    async def tool_names(self):
        return []

    async def call(self, name, args):
        self.calls.append((name, dict(args)))
        if name.startswith("plot_"):
            return {"html_path": f"plots/{args.get('filename')}"}
        return {"data_file": f"data/{name}_0123abcd.pkl", "dim": 1,
                "meta": {"solver_stats": {"converged": True}}}


def test_examples_are_the_root_apps():
    assert app.EXAMPLES == ref_app.EXAMPLES
    assert len(QUERIES) >= 40 and len(CONVERSATIONS) >= 5


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_rule_based_parse_equals_reference(i):
    q = QUERIES[i]
    raw, raw_ref = parser_agent.rule_based_parse(q), ref_parser.rule_based_parse(q)
    assert raw == raw_ref
    assert parser_agent.normalize_params_dict(dict(raw)) == \
        ref_parser.normalize_params_dict(dict(raw_ref))
    assert parser_agent.PDEParserAgent(llm=None).parse(q).to_dict() == \
        ref_parser.PDEParserAgent(llm=None).parse(q).to_dict()


def _route(disp_mod, parser_mod, q):
    params = parser_mod.PDEParserAgent(llm=None).parse(q)
    try:
        return disp_mod.DispatcherAgent(toolset=_Recording()).route(params)
    except Exception as exc:  # an unroutable query: the same error in both
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_dispatcher_routes_as_reference(i):
    q = QUERIES[i]
    assert _route(dispatcher_agent, parser_agent, q) == \
        _route(ref_dispatcher, ref_parser, q)


def _converse(orch_mod, queries, workdir):
    rec = _Recording()
    orch = orch_mod.MultiAgentOrchestrator(llm=None, memory_file=None,
                                           toolset=rec)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        out = []
        for q in queries:
            res = asyncio.run(orch.solve(q))
            out.append({k: res.get(k) for k in
                        ("status", "pde_params", "error", "html_path",
                         "data_file")})
            if res.get("status") != "greeting":
                out[-1]["summary"] = res.get("summary")
    finally:
        os.chdir(cwd)
    return out, rec.calls


@pytest.mark.parametrize("i", range(len(CONVERSATIONS)))
def test_follow_up_merge_equals_reference(i, tmp_path):
    """A conversation (a query and its follow-ups) through both orchestrators
    with a recording tool set: the same merged parameters, summaries and
    tool calls at every turn."""
    queries = CONVERSATIONS[i]
    port, port_calls = _converse(orchestrator, queries, tmp_path)
    ref, ref_calls = _converse(ref_orchestrator, queries, tmp_path)
    assert port == ref
    assert port_calls == ref_calls


def test_change_the_left_boundary_merges(tmp_path):
    (first, second), calls = _converse(
        orchestrator, [ref_app.EXAMPLES[0], "change the left boundary to 50°C"],
        tmp_path)
    assert first["pde_params"]["bc_values"]["T_left"] == 20.0
    assert second["pde_params"]["bc_values"] == {"T_left": 50.0,
                                                 "T_right": 0.0}
    assert second["pde_params"]["domain_size"] == \
        first["pde_params"]["domain_size"]
    (tool, args), (tool2, args2) = calls[0], calls[2]
    assert tool == tool2 == "solve_heat_1D"
    assert args2 == dict(args, T_left=50.0)


def _solve_example(orch_mod, load, q):
    res = asyncio.run(orch_mod.MultiAgentOrchestrator(
        llm=None, memory_file=None).solve(q))
    assert "error" not in res, res
    assert os.path.exists(res["data_file"]) and os.path.exists(res["html_path"])
    return res, load(res["data_file"]).values_array()


@pytest.mark.parametrize("i", range(len(ref_app.EXAMPLES)))
def test_example_end_to_end_matches_reference(i, tmp_path, monkeypatch):
    """Both packages in their CPU default, "auto", which resolves to
    float64: the port's field within 1e-9 of the JAX package's."""
    monkeypatch.chdir(tmp_path)
    q = ref_app.EXAMPLES[i]
    ref, v64 = _solve_example(ref_orchestrator, ref_load, q)
    with config.config_overrides(device="cpu"):
        port, v = _solve_example(orchestrator, load_field, q)
    assert port["pde_params"] == ref["pde_params"]
    meta = port["dispatch_result"]["solver_result"]["meta"]
    meta_ref = ref["dispatch_result"]["solver_result"]["meta"]
    assert {k: x for k, x in meta.items() if k != "solver_stats"} == \
        {k: x for k, x in meta_ref.items() if k != "solver_stats"}
    assert os.path.basename(port["html_path"]).split("_")[:-1] == \
        os.path.basename(ref["html_path"]).split("_")[:-1]
    assert v.shape == v64.shape and np.all(np.isfinite(v))
    gap = np.abs(v - v64).max() / np.abs(v64).max()
    assert gap <= 1e-9, gap


def test_crank_nicolson_override_uses_the_port_config(tmp_path, monkeypatch):
    """A "crank-nicolson" query flips the port's ``SolverConfig.theta`` for
    the solve only (in process: the dispatcher's override is a contextvar),
    and the JAX package's config stays untouched."""
    monkeypatch.chdir(tmp_path)
    seen = {}

    class Spy(dispatcher_agent.LocalToolSet):
        async def call(self, name, args):
            if name.startswith("solve_"):
                seen["theta"] = config.get_config().theta
                seen["ref_theta"] = ref_config.get_config().theta
                args = dict(args, nx=6, ny=6, num_steps=2)
            with config.config_overrides(**CPU):
                return await super().call(name, args)

    params = parser_agent.PDEParserAgent(llm=None).parse(
        "solve heat in a 1 m x 1 m plate with crank-nicolson stepping, "
        "boundary at 0 C, initial temperature 20 C, 4 steps")
    assert params.notes == ["time_scheme:crank_nicolson"]
    out = asyncio.run(dispatcher_agent.DispatcherAgent(toolset=Spy())
                      .dispatch(params))
    assert "error" not in out, out.get("error")
    assert seen == {"theta": 0.5, "ref_theta": 1.0}
    assert config.get_config().theta == 1.0
