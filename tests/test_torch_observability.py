"""The port's spans and counters (``utils.observability``) on the CPU: how
spans nest and close into a request's stats, how a span's device clocks
add up, the scans' set-up, stepping and fetch spans, the static
elasticity path's spans and counters on a tiny mixed-precision solve (its
content keys' bytes, its caches' hits), the profiler marks, and the INFO
lines that ``chip_smoke.py`` parses, timed by the same spans."""

import logging
import os

import chip_smoke
import numpy as np
import pytest
import torch

from pde_solver_tpu_torch import api
from pde_solver_tpu_torch.config import config_overrides
from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu_torch.models.elasticity import lame_parameters
from pde_solver_tpu_torch.ops import (assembly, device_loop, linsolve,
                                      timestepping)
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu_torch.ops import stencil_kernels as sk
from pde_solver_tpu_torch.utils import kept
from pde_solver_tpu_torch.utils import observability as obs
from pde_solver_tpu_torch.utils.observability import get_logger

# 9×5×5 nodes, 675 unknowns: over the lowered content-key gate (600), so
# the prep key hashes it and the hierarchy key is named by that key, while
# the coarse levels (135) and the projection's scalar mass system (225)
# stay under it
BOX = dict(Lx=1.0, Ly=0.25, Lz=0.25, nx=8, ny=4, nz=4, body_fz=-7.7e4)
KEY_MIN_DOF = 600
# the MG hierarchy and the df2 F-cycle ("auto" is "f64" on the CPU)
SOLVE_CFG = dict(device="cpu", precision="mixed", mg_threshold=100,
                 host_direct_threshold=0)
NEW_SECONDS = ("assembly_stencil", "assembly_load", "hash", "prep",
               "hierarchy", "ladder", "df2", "fetch", "von_mises",
               "projection")
PHASES = ("assembly", "solve", "postprocess")


def _clear_caches():
    kept.clear_all()


@pytest.fixture()
def small_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", KEY_MIN_DOF)
    monkeypatch.setenv("PDE_TPU_DISK_CACHE", "0")
    _clear_caches()
    yield tmp_path
    _clear_caches()


def _solve(data_dir):
    """One tiny static solve; (its stats, its request's records)."""
    with config_overrides(**SOLVE_CFG):
        res = api.solve_elasticity_3D_static(**BOX, data_dir=str(data_dir))
    return res.meta["solver_stats"], obs.last_request()


@pytest.fixture()
def two_calls(small_keys):
    """The same request twice: cold, then with the memory caches warm."""
    return [_solve(small_keys) for _ in range(2)]


def _key_bytes(call: int) -> int:
    """What the prep key hashes: the stencil's class grids (3×3 float64
    blocks at each of 3³ classes and every offset) and the free mask
    (float64 per unknown), and on the cold call (0) the raw stencil too,
    3×3 float64 blocks at every node and offset.  The hierarchy key is
    named by the prep key and hashes nothing."""
    mesh = box_mesh(BOX["nx"], BOX["ny"], BOX["nz"], (0.0, 0.0, 0.0),
                    (BOX["Lx"], BOX["Ly"], BOX["Lz"]))
    n_off = len(assembly.assemble_elasticity_stencil(
        mesh, *lame_parameters(210e9, 0.3, "3d")))
    nodes = mesh.num_nodes
    cold = n_off * nodes * 9 * 8 if call == 0 else 0
    return cold + n_off * 27 * 9 * 8 + nodes * 3 * 8


# ---- spans and requests -----------------------------------------------------

@pytest.mark.parametrize("calls", [1, 2, 3])
def test_spans_nest_in_one_request_and_do_not_leak(calls):
    ids = []
    for i in range(calls):
        stats = {}
        with obs.request(stats):
            with obs.span("solve"):
                with obs.span("setup.prep"):
                    with obs.span("setup.hash"):
                        obs.count("hashed_bytes", 7 + i)
                with obs.span("solve.df2"):
                    obs.count("df2_rounds")
            with obs.span("postprocess"):
                pass
        req = obs.last_request()
        assert [(s.name, s.parent) for s in req.spans] == [
            ("solve", -1), ("setup.prep", 0), ("setup.hash", 1),
            ("solve.df2", 0), ("postprocess", -1)]
        assert {s.request for s in req.spans} == {req.id}
        assert all(0 < s.start_ns <= s.end_ns for s in req.spans)
        assert stats["hashed_bytes"] == req.counters["hashed_bytes"] == 7 + i
        assert stats["df2_rounds"] == 1
        assert set(obs.COUNTERS) <= set(stats)
        assert {k for k in stats if k.endswith("_seconds")} == {
            "solve_seconds", "prep_seconds", "hash_seconds", "df2_seconds",
            "postprocess_seconds"}
        spans = {s.name: s for s in req.spans}
        assert stats["solve_seconds"] == spans["solve"].seconds
        assert spans["solve"].seconds >= (spans["setup.prep"].seconds
                                          + spans["solve.df2"].seconds)
        ids.append(req.id)
    assert len(set(ids)) == calls


def test_span_outside_a_request_opens_its_own():
    with obs.span("capture") as sp:
        obs.count("graphs_captured")
    req = obs.last_request()
    assert req.spans == [sp] and sp.parent == -1
    assert req.counters["graphs_captured"] == 1
    obs.count("graphs_captured")      # no request open: nothing to count in
    assert obs.last_request() is req


def test_a_request_inside_a_request_is_refused():
    with obs.request() as stats:
        with obs.span("solve"):
            with pytest.raises(RuntimeError):
                with obs.request():
                    pass
    assert [s.name for s in obs.last_request().spans] == ["solve"]
    assert "solve_seconds" in stats


def test_request_counts_the_process_totals(monkeypatch):
    monkeypatch.setattr(sk, "KERNEL_LAUNCHES", {"v3_f32": 4})
    monkeypatch.setattr(device_loop, "HOST_READS", {"cg": 9})
    for launches, reads in ((5, 2), (0, 0), (1, 3)):
        with obs.request() as stats:
            sk.count_launch("v3_f32", None, launches)
            for _ in range(reads):
                device_loop.count_read("mg_pcg")
        assert stats["kernel_launches"] == launches
        assert stats["host_reads"] == reads


@pytest.mark.parametrize("name", ["setup", "df2", "solve.rounds"])
def test_an_unknown_span_is_refused(name):
    with pytest.raises(KeyError):
        obs.span(name)


def test_device_clock_is_silent_off_the_card():
    with obs.request() as stats:
        with obs.device_clock("solve.df2", "cpu"):
            pass
    assert not any(k.endswith("_device_seconds") for k in stats)


class _Event:
    """A stand-in for a timing CUDA event: its record is a time in ms."""

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self, stream=None):
        self.ms = _Event.clock.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_device_clocks_of_a_span_add_up(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    # three pieces of device work, 2 + 5 + 0.5 ms, with host time between
    _Event.clock = [10.0, 12.0, 40.0, 45.0, 90.0, 90.5]
    with obs.request() as stats:
        for _ in range(3):
            with obs.device_clock("solve.df2", "cuda"):
                pass
    assert [k for k, _, _ in obs.last_request().clocks] == [
        "df2_device_seconds"] * 3
    assert stats["df2_device_seconds"] == pytest.approx(7.5e-3)
    assert not [k for k in stats if k.endswith("_seconds")
                and k != "df2_device_seconds"]


# ---- the scans --------------------------------------------------------------

def _heat_problem():
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    u0 = np.asarray(bc.apply_values(20.0 * np.ones(mesh.node_shape)))
    return mesh, K, M, bc, b, u0


@pytest.mark.parametrize("checkpoint", [0, 4])
@pytest.mark.parametrize("kind", ["theta", "newmark"])
def test_a_scan_reports_its_spans_seconds(tmp_path, kind, checkpoint):
    """A scan's set-up, stepping and fetch are its spans: the result's
    seconds are the request's, and a checkpointed scan's file I/O has its
    own."""
    mesh, K, M, bc, b, u0 = _heat_problem()
    kept.clear_all()
    with config_overrides(device="cpu", transient_checkpoint_every=checkpoint,
                          checkpoint_dir=str(tmp_path)):
        with obs.request() as stats:
            if kind == "theta":
                res = timestepping.run_transient(K, M, mesh, bc, b, u0,
                                                 dt=0.01, num_steps=10)
            else:
                res = timestepping.run_newmark(K, M, mesh, bc, b, u0,
                                               np.zeros_like(u0), 0.01, 10)
    kept.clear_all()
    for key in ("setup", "scan", "fetch"):
        assert stats[key + "_seconds"] == pytest.approx(
            getattr(res, key + "_seconds"), rel=1e-12, abs=1e-12), key
        assert stats[key + "_seconds"] > 0, key
    assert ("checkpoint_seconds" in stats) == bool(checkpoint)
    names = [s.name for s in obs.last_request().spans]
    assert names.count("scan.setup") == 2
    assert names.count("scan") == (3 if checkpoint else 1)


# ---- the static elasticity path ---------------------------------------------

@pytest.mark.parametrize("call", [0, 1])
def test_static_solve_reports_every_key(two_calls, call):
    stats, req = two_calls[call]
    assert stats["converged"]
    for key in PHASES + NEW_SECONDS:
        assert stats[key + "_seconds"] > 0, key
    assert set(obs.COUNTERS) <= set(stats)
    assert all(isinstance(stats[c], int) for c in obs.COUNTERS)
    # no card: no capture, no device clock, no kernel
    assert "capture_seconds" not in stats
    assert "df2_device_seconds" not in stats
    assert stats["graphs_captured"] == stats["graph_replays"] == 0
    assert stats["kernel_launches"] == 0
    assert stats["df2_rounds"] >= 1 and stats["host_reads"] >= 1
    assert {s.request for s in req.spans} == {req.id}


@pytest.mark.parametrize("call", [0, 1])
def test_child_spans_fit_in_their_parent(two_calls, call):
    _, req = two_calls[call]
    spans = req.spans
    for i, sp in enumerate(spans):
        kids = [c for c in spans if c.parent == i]
        assert sum(c.seconds for c in kids) <= sp.seconds
        assert all(sp.start_ns <= c.start_ns <= c.end_ns <= sp.end_ns
                   for c in kids)
    top = {s.name for s in spans if s.parent < 0}
    assert top == set(PHASES)
    under = {spans[s.parent].name + "/" + s.name for s in spans
             if s.parent >= 0}
    assert {"assembly/assembly.stencil", "assembly/assembly.load",
            "solve/setup.prep", "setup.prep/setup.hash",
            "solve/setup.hierarchy",
            "solve/setup.ladder", "solve/solve.df2", "solve/solve.fetch",
            "postprocess/postprocess.von_mises",
            "postprocess/postprocess.projection"} <= under
    # the system has a content key: the hierarchy key hashes nothing
    assert "setup.hierarchy/setup.hash" not in under


@pytest.mark.parametrize("call", [0, 1])
def test_hashed_bytes_are_the_keys_inputs(two_calls, call):
    stats, req = two_calls[call]
    assert stats["hashed_bytes"] == _key_bytes(call)
    spans = req.spans
    keys = [s for s in spans
            if s.name == "setup.hash" and spans[s.parent].name != s.name]
    assert [spans[s.parent].name for s in keys] == ["setup.prep"]
    # the warm call's prep key takes its stencil hash from the memo
    if call == 0:
        assert stats["stencil_digest_reuses"] == 0
    else:
        assert stats["stencil_digest_reuses"] >= 1


@pytest.mark.parametrize("call", [0, 1])
def test_static_solve_assembles_on_the_class_grid(two_calls, call):
    stats, _ = two_calls[call]
    # the elasticity stencil, the projection's mass stencil, and on the
    # cold call the hierarchy's coarse elasticity stencils
    assert stats["stencils_by_class"] >= 2
    assert stats["stencils_by_slices"] == 0


@pytest.mark.parametrize("call, hits, builds", [(0, 0, 1), (1, 1, 0)])
def test_second_call_hits_the_memory_caches(two_calls, call, hits, builds):
    stats, _ = two_calls[call]
    assert stats["prep_memory_hits"] == hits
    assert stats["hierarchy_hits"] == hits
    assert stats["hierarchy_builds"] == builds
    assert stats["prep_disk_hits"] == stats["hierarchy_disk_hits"] == 0
    # the fine system's prep on the cold call, and the projection's
    # (under the key gate) on both
    assert stats["prep_builds"] >= 1 + builds


def test_memo_cold_and_warm_solves_are_bit_equal(small_keys, monkeypatch):
    """The same solve with the stencil memo cold, then warm (every other
    cache emptied): the same field, bit for bit, and the same prep and
    hierarchy disk-entry names, those of the full hash."""
    from pde_solver_tpu_torch.fields import load_field
    from pde_solver_tpu_torch.utils import diskcache

    real, keys, systems = linsolve._prep_cache_key, [], []
    prepare = linsolve.prepare_system

    def spy_key(stencil, free, node_shape, vdim):
        keys.append(real(stencil, free, node_shape, vdim))
        if not systems:     # the first call's fine stencil, hashed in full
            keys.append(real({o: np.array(W) for o, W in stencil.items()},
                             free, node_shape, vdim))
        return keys[-1]

    def spy_prepare(*args, **kwargs):
        sysm = prepare(*args, **kwargs)
        systems.append(sysm)
        return sysm

    monkeypatch.setattr(linsolve, "_prep_cache_key", spy_key)
    monkeypatch.setattr(linsolve, "prepare_system", spy_prepare)
    values, reuses = [], []
    for _ in range(2):
        # every kept cache but the stencil hash states, which the second
        # request reuses
        for cache in (linsolve._PREP_CACHE, linsolve._MG_CACHE,
                      linsolve._FLAT_OP_CACHE):
            cache.clear()
        with config_overrides(**SOLVE_CFG):
            res = api.solve_elasticity_3D_static(**BOX,
                                                 data_dir=str(small_keys))
        values.append(load_field(res.data_file).values)
        reuses.append(res.meta["solver_stats"]["stencil_digest_reuses"])
    assert np.array_equal(values[0], values[1])
    assert reuses == [0, 1]
    assert len(set(keys)) == 1 and len(keys) == 3
    assert len({diskcache._path("prep", k) for k in keys}) == 1
    assert len({diskcache._path("mgh", (k, 3)) for k in keys}) == 1
    # the hierarchy key names the system by its content key, unhashed;
    # a system under the key gate is hashed as before
    sysm = next(s for s in systems if s.ckey is not None)
    mesh = box_mesh(BOX["nx"], BOX["ny"], BOX["nz"], (0.0, 0.0, 0.0),
                    (BOX["Lx"], BOX["Ly"], BOX["Lz"]))
    for ckey, spans in ((sysm.ckey, 0), (None, 1)):
        stats = {}
        with obs.request(stats):
            linsolve._mg_cache_key(mesh, 3, "mixed",
                                   sysm._replace(ckey=ckey),
                                   torch.device("cpu"))
        names = [s.name for s in obs.last_request().spans]
        assert names.count("setup.hash") == spans
        assert (stats["hashed_bytes"] > 0) == bool(spans)


# ---- the profiler's marks ---------------------------------------------------

@pytest.mark.parametrize("profiled", [False, True])
def test_spans_mark_the_profile_only_while_it_records(small_keys,
                                                      monkeypatch, profiled):
    _solve(small_keys)                 # cold: the caches fill
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    class Counting:
        def __init__(self, name):
            entered.append(name)
            self.mark = real(name)

        def __enter__(self):
            return self.mark.__enter__()

        def __exit__(self, *exc):
            return self.mark.__exit__(*exc)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _solve(small_keys)
        marks = {e.name for e in prof.events() if e.name.startswith("pde.")}
        assert {"pde.assembly", "pde.assembly.stencil", "pde.assembly.load",
                "pde.solve", "pde.setup.prep", "pde.setup.hash",
                "pde.setup.hierarchy", "pde.setup.ladder", "pde.solve.df2",
                "pde.solve.fetch", "pde.postprocess",
                "pde.postprocess.von_mises",
                "pde.postprocess.projection"} <= marks
        assert {n for n in entered if n.startswith("pde.")} == marks
    else:
        _solve(small_keys)
        assert not [n for n in entered if n.startswith("pde.")]


# ---- the INFO lines chip_smoke.py parses ------------------------------------

@pytest.fixture()
def log_lines():
    """The port logger's INFO messages while the test runs."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = get_logger()
    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    yield lines
    logger.removeHandler(handler)
    logger.setLevel(level)


@pytest.mark.parametrize("disk", ["store", "hit"])
def test_info_lines_still_parse_and_read_the_spans(small_keys, monkeypatch,
                                                   log_lines, disk):
    monkeypatch.setenv("PDE_TPU_DISK_CACHE", "1")
    monkeypatch.setenv("PDE_TPU_CACHE_DIR", str(small_keys / "cache"))
    if disk == "hit":
        _solve(small_keys)             # the entries go to disk
        _clear_caches()
        log_lines.clear()
    _, req = _solve(small_keys)
    dof = 9 * 5 * 5 * 3
    setup = chip_smoke.setup_seconds(log_lines, dof)
    assert set(setup) == {"prepare_system", "hierarchy", "ladder", "total"}
    first = {}
    for sp in req.spans:
        first.setdefault(sp.name, sp)
    # one clock a phase: the lines print the spans' seconds
    assert setup["prepare_system"] == pytest.approx(
        first["setup.prep"].seconds, abs=5e-4)
    assert setup["ladder"] == pytest.approx(first["setup.ladder"].seconds,
                                            abs=5e-4)
    events = chip_smoke.disk_events(log_lines, dof)
    assert set(events) == {("prep", disk), ("hierarchy", disk)}
    span = "load" if disk == "hit" else "store"
    for kind in ("prep", "hierarchy"):
        seconds, size = events[kind, disk]
        assert size > 0
        assert seconds == pytest.approx(
            first[f"setup.{kind}.{span}"].seconds, abs=5e-4)
    assert os.path.isdir(small_keys / "cache")
    assert np.isfinite(setup["total"])
