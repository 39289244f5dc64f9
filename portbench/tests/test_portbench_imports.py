"""No run loads JAX or the JAX package, and the reference loads nothing
of the program: top-level module names compared whole (the port's name
begins with the JAX package's)."""

import json
import subprocess
import sys
import types

import pytest

from portbench.lib import harness
from portbench.tests import tiny

CHECK = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level(body, root=tiny.REPO):
    out = subprocess.run([sys.executable, "-c",
                          CHECK.format(root=root, body=body)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_package():
    names = top_level("from portbench.reference import p1, heat_theta, "
                      "elasticity_static")
    assert not names & {"jax", "jaxlib", "flax", "pde_solver_tpu",
                        "pde_solver_tpu_torch"}


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(str(tmp_path))
    body = ("from portbench.lib import harness\n"
            "out = harness.run_cell({root!r}, 'heat3d-128.followup', 5, "
            "0.5, True, device='cpu')\n"
            "assert out['correct'], out\n").format(root=root)
    names = top_level(body, root)
    assert "pde_solver_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "pde_solver_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "pde_solver_tpu_torch.api" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pde_solver_tpu.api",
                        types.ModuleType("pde_solver_tpu.api"))
    assert harness.forbidden_modules() == ["pde_solver_tpu.api"]


def test_a_run_with_jax_loaded_gives_no_result(tmp_path, monkeypatch):
    root = tiny.make_root(str(tmp_path))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(SystemExit):
        harness.run_cell(root, "heat3d-128.followup", 5, 0.2, False,
                         device="cpu")
