"""The port's chat front end, ``pde_solver_tpu_torch/app.py``: the
fake-streamlit harness of ``tests/test_ui.py`` (no network, no card,
streamlit not installed) drives ``run_streamlit`` and checks the chat
history, the embedded plot HTML and the two download payloads; then the
terminal chat loop, in process and as ``python -m pde_solver_tpu_torch.app
--cli`` on the CPU.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from pde_solver_tpu_torch import app, config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", precision="mixed")


class _Rerun(Exception):
    """Stands in for streamlit's RerunException (st.rerun raises)."""


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _SessionState(dict):
    """Attribute + item access, like streamlit's SessionState."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def _make_fake_streamlit(chat_input_value):
    st = types.ModuleType("streamlit")
    st.session_state = _SessionState()
    st.calls = {"markdown": [], "download_button": [], "chat_message": [],
                "button_keys": [], "rerun": 0}

    st.set_page_config = lambda **kw: None
    st.title = lambda *a, **kw: None
    st.sidebar = _Ctx()
    st.spinner = lambda *a, **kw: _Ctx()
    st.markdown = lambda text, **kw: st.calls["markdown"].append(text)

    def button(label, key=None, **kw):
        st.calls["button_keys"].append(key or label)
        return False

    st.button = button

    def chat_message(role):
        st.calls["chat_message"].append(role)
        return _Ctx()

    st.chat_message = chat_message
    st.columns = lambda n: tuple(_Ctx() for _ in range(n))

    def download_button(label, data, file_name, mime, **kw):
        st.calls["download_button"].append(
            {"label": label, "data": data, "file_name": file_name,
             "mime": mime})

    st.download_button = download_button
    st.chat_input = lambda *a, **kw: chat_input_value

    def rerun():
        st.calls["rerun"] += 1
        raise _Rerun()

    st.rerun = rerun

    components = types.ModuleType("streamlit.components.v1")
    components.rendered = []
    components.html = lambda html, **kw: components.rendered.append(html)
    components_pkg = types.ModuleType("streamlit.components")
    components_pkg.v1 = components

    runtime = types.ModuleType("streamlit.runtime")
    runtime.exists = lambda: True
    st.runtime = runtime
    st.components = components_pkg
    return st, components, runtime


class _StubOrchestrator:
    """Deterministic orchestrator: records prompts, returns fixed artifacts."""

    def __init__(self, html_path, data_file):
        self.prompts = []
        self._result = {
            "summary": "Simulation Summary:\n- PDE Type: heat (stub)",
            "html_path": html_path,
            "data_file": data_file,
        }

    async def solve(self, prompt):
        self.prompts.append(prompt)
        return dict(self._result)

    def clear_memory(self):
        pass


@pytest.fixture()
def fake_ui(tmp_path, monkeypatch):
    html_path = tmp_path / "plot.html"
    html_path.write_text("<html><body><script>Plotly.newPlot()"
                         "</script></body></html>")
    data_file = tmp_path / "result.pkl"
    data_file.write_bytes(b"\x80\x04pickle-payload")

    def build(chat_input_value):
        st, components, runtime = _make_fake_streamlit(chat_input_value)
        monkeypatch.setitem(sys.modules, "streamlit", st)
        monkeypatch.setitem(sys.modules, "streamlit.components", st.components)
        monkeypatch.setitem(sys.modules, "streamlit.components.v1", components)
        monkeypatch.setitem(sys.modules, "streamlit.runtime", runtime)
        stub = _StubOrchestrator(str(html_path), str(data_file))
        st.session_state.orchestrator = stub
        st.session_state.history = []
        return st, components, stub

    return build, html_path, data_file


def test_prompt_appends_history_and_reruns(fake_ui):
    build, _, _ = fake_ui
    st, _, stub = build("solve heat in a 2 m rod, ends at 20 and 0 C")

    with pytest.raises(_Rerun):
        app.run_streamlit()

    assert stub.prompts == ["solve heat in a 2 m rod, ends at 20 and 0 C"]
    hist = st.session_state.history
    assert [h["role"] for h in hist] == ["user", "assistant"]
    assert hist[0]["content"].startswith("solve heat")
    assert "Simulation Summary" in hist[1]["content"]
    assert hist[1]["html_path"].endswith("plot.html")
    assert hist[1]["data_file"].endswith("result.pkl")
    assert st.calls["rerun"] == 1


def test_history_render_embeds_html_and_downloads(fake_ui):
    """On the post-rerun render (no new prompt) every assistant entry with a
    plot embeds the HTML and offers BOTH download payloads (ref
    app.py:236-264: two columns when both artifacts exist)."""
    build, html_path, data_file = fake_ui
    st, components, _ = build(None)
    st.session_state.history = [
        {"role": "user", "content": "q"},
        {"role": "assistant", "content": "a",
         "html_path": str(html_path), "data_file": str(data_file)},
    ]

    app.run_streamlit()  # chat_input None → pure render, no rerun

    assert st.calls["chat_message"] == ["user", "assistant"]
    assert components.rendered == [html_path.read_text()]
    dls = {d["file_name"]: d for d in st.calls["download_button"]}
    assert set(dls) == {"plot.html", "result.pkl"}
    assert dls["plot.html"]["data"] == html_path.read_bytes()
    assert dls["plot.html"]["mime"] == "text/html"
    assert dls["result.pkl"]["data"] == data_file.read_bytes()
    assert dls["result.pkl"]["mime"] == "application/octet-stream"
    assert st.calls["rerun"] == 0


def test_missing_data_file_offers_html_only(fake_ui, tmp_path):
    build, html_path, _ = fake_ui
    st, components, _ = build(None)
    st.session_state.history = [
        {"role": "assistant", "content": "a",
         "html_path": str(html_path),
         "data_file": str(tmp_path / "gone.pkl")},
    ]

    app.run_streamlit()

    labels = [d["file_name"] for d in st.calls["download_button"]]
    assert labels == ["plot.html"]
    assert components.rendered  # plot still embedded


def test_example_buttons_registered(fake_ui):
    build, _, _ = fake_ui
    st, _, _ = build(None)

    app.run_streamlit()

    # every example prompt gets a sidebar button, plus clear-memory
    for ex in app.EXAMPLES:
        assert ex in st.calls["button_keys"]
    assert "Clear memory" in st.calls["button_keys"]


def test_cli_chat_loop_in_process(tmp_path, monkeypatch, capsys):
    """``app.main()`` with ``--cli``: a greeting, a solve, the history and
    exit; the solve's plot is written and named."""
    said = iter(["hello", "Solve 1D heat in a 1 meter rod, 8 nodes, 2 steps, "
                 "left end at 5°C", "history", "exit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(said))
    monkeypatch.setattr(sys, "argv", ["app", "--cli"])
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.chdir(tmp_path)
    with config.config_overrides(**CPU):
        app.main()
    out = capsys.readouterr().out
    assert "rule-based (no API key)" in out
    assert "Simulation Summary" in out
    html = out.split("Interactive plot: ")[1].split()[0]
    assert os.path.exists(html)
    assert "Plotly.newPlot" in open(html).read()
    memory = json.load(open(tmp_path / "conversation_memory.json"))
    assert memory["current_simulation"]["pde_params"]["dim"] == 1


@pytest.mark.parametrize("how", ["module", "script"])
def test_cli_entry_point(how, tmp_path):
    """``python -m pde_solver_tpu_torch.app --cli`` (package on the path)
    and the file run as a script, as ``streamlit run`` runs it (the file
    puts its package's parent on the path), under ``PDE_TPU_DEVICE=cpu
    PDE_TPU_PRECISION=mixed``, from another directory."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PDE_TPU_") and k not in ("OPENAI_API_KEY",
                                                          "PYTHONPATH")}
    env.update(PDE_TPU_DEVICE="cpu", PDE_TPU_PRECISION="mixed")
    if how == "module":
        cmd = ["-m", "pde_solver_tpu_torch.app"]
        env["PYTHONPATH"] = REPO
    else:
        cmd = [os.path.join(REPO, "pde_solver_tpu_torch", "app.py")]
    proc = subprocess.run(
        [sys.executable, *cmd, "--cli"],
        input="Solve 1D heat in a 1 meter rod, 8 nodes, 2 steps, left end "
              "at 5°C\nexit\n", cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    html = proc.stdout.split("Interactive plot: ")[1].split()[0]
    assert os.path.exists(tmp_path / html)
    assert list((tmp_path / "data").glob("heat_1d_*.pkl"))


def test_chip_smoke_service_phase_rehearsal(tmp_path):
    """``chip_smoke.service_phase`` on the CPU at a small size: the server
    subprocess (``PDE_TPU_DEVICE=cpu``) serves a 16×8×8 cantilever equal to
    the in-process solve and its plot, an 8³ heat scan twice (the second
    call keeps the first one's step programs), and the nine examples
    run."""
    import time

    import chip_smoke
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    small = dict(chip_smoke.FLAGSHIP, nx=16, ny=8, nz=8)
    with config.config_overrides(**CPU):
        t = time.perf_counter()
        ref = api.solve_elasticity_3D_static(**small,
                                             data_dir=str(tmp_path / "ref"))
        wall = time.perf_counter() - t

    def counted(label, fn):
        sk.reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        return res, dict(sk.KERNEL_LAUNCHES), time.perf_counter() - t

    with config.config_overrides(**CPU):
        launches = chip_smoke.service_phase(
            counted, small, chip_smoke.field(ref)[0],
            ref.meta["solver_stats"]["cg_iterations"], wall,
            str(tmp_path / "service"), wanted=(), device="cpu",
            server_env={"PDE_TPU_DEVICE": "cpu",
                        "PDE_TPU_PRECISION": "mixed"},
            disk_hits=(),       # 6,561 DOF: under the prep cache's gate
            heat=dict(nx=8, ny=8, nz=8))
    assert launches == {}
    # the served plot and the nine examples' plots
    assert len(list((tmp_path / "service" / "plots").glob("*.html"))) == 10


@pytest.mark.parametrize("stray", ["print('ready')", "print('{}')"])
def test_json_rpc_pipe_refuses_a_stray_stdout_line(stray):
    """A server that writes anything but the reply on stdout fails the
    chip run (a client that skips lines that are not JSON would not)."""
    import chip_smoke

    server = ("import sys, json\n" + stray + "\nfor line in sys.stdin:\n"
              "    m = json.loads(line)\n"
              "    print(json.dumps({'jsonrpc': '2.0', 'id': m['id'], "
              "'result': {}}), flush=True)\n")
    pipe = chip_smoke.JsonRpcPipe([sys.executable, "-c", server], None, None,
                                  subprocess.DEVNULL)
    try:
        with pytest.raises(RuntimeError, match="is not its JSON-RPC reply"):
            pipe.request("ping", timeout=30)
    finally:
        pipe.kill()
