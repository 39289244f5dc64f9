"""The port's device von Mises on the CPU: ``_von_mises_device`` against
the JAX package's (jit on the CPU) and both against the host float64 path,
the size and device gate of ``von_mises_fields``, and no host fallback when
the device evaluation fails.

Bounds: 1e-6·max|vm| between the two packages' device evaluations,
1e-5·max|vm| against float64."""

import numpy as np
import pytest

from pde_solver_tpu.mesh import box_mesh as ref_box_mesh
from pde_solver_tpu.mesh import rectangle_mesh as ref_rectangle_mesh
from pde_solver_tpu.models import elasticity as ref_el
from pde_solver_tpu_torch.config import config_overrides
from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu_torch.models import elasticity as el

MESHES = {
    "8x4x4": lambda mk: mk[0](8, 4, 4, (0, 0, 0), (1.0, 0.2, 0.2)),
    "16x8x8": lambda mk: mk[0](16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2)),
    "9x7 plane strain": lambda mk: mk[1](9, 7, (0, 0), (1.0, 0.7)),
}
PORT, REF = (box_mesh, rectangle_mesh), (ref_box_mesh, ref_rectangle_mesh)


def _case(name, with_iso):
    mesh, ref_mesh = MESHES[name](PORT), MESHES[name](REF)
    d = mesh.dim
    rng = np.random.default_rng(3)
    u = 1e-3 * rng.standard_normal(mesh.node_shape + (d,))
    lam, mu = el.lame_parameters(210e9, 0.3, "3d" if d == 3
                                 else "plane_strain")
    iso = None
    if with_iso:
        dT = 50.0 * rng.standard_normal(mesh.node_shape)
        iso = el.thermal_stress_coefficient(210e9, 0.3, 1.2e-5, "3d") \
            * el._cellwise_mean(mesh, dT)
    return mesh, ref_mesh, u, lam, mu, iso


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("with_iso", [False, True], ids=["plain", "iso"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_device_von_mises_matches_reference_and_host(name, with_iso):
    mesh, ref_mesh, u, lam, mu, iso = _case(name, with_iso)
    port = el._von_mises_device(mesh, u, lam, mu, iso=iso, device="cpu")
    ref = ref_el._von_mises_device(ref_mesh, u, lam, mu, iso=iso)
    host = el._vm_from_gradients(el._element_gradients(mesh, u), np,
                                 mesh.dim, lam, mu, iso=iso)
    for p, r, h in zip(port, ref, host):
        assert p.dtype == np.float32 and p.shape == np.shape(r) == h.shape
        assert _gap(p, r) <= 1e-6
        assert _gap(p, h) <= 1e-5 and _gap(r, h) <= 1e-5


def test_device_von_mises_keeps_small_strains_under_large_displacements():
    """A large displacement with a small strain (a cantilever's tip): the
    gradients difference nearby displacements, so the JAX package's
    all-float32 sum keeps float32's precision of |u| only; the port sums
    them in float64 and stays within 1e-5·max|vm| of the host path."""
    mesh, ref_mesh, u, lam, mu, _ = _case("16x8x8", False)
    u = 1e-2 * u + 1.0                  # strains ~1e-4, |u| ~ 1
    host = el._vm_from_gradients(el._element_gradients(mesh, u), np, 3, lam,
                                 mu)
    port = el._von_mises_device(mesh, u, lam, mu, device="cpu")
    ref = ref_el._von_mises_device(ref_mesh, u, lam, mu)
    for p, r, h in zip(port, ref, host):
        assert _gap(p, h) <= 1e-5
        assert _gap(r, h) > 1e-5        # why the port sums in float64


def test_cellwise_mean_is_the_thermal_loads_mean():
    mesh = box_mesh(4, 3, 2, (0, 0, 0), (1.0, 0.5, 0.4))
    dT = np.random.default_rng(0).standard_normal(mesh.node_shape)
    np.testing.assert_array_equal(
        el._cellwise_mean(mesh, dT),
        ref_el._cellwise_mean(ref_box_mesh(4, 3, 2, (0, 0, 0),
                                           (1.0, 0.5, 0.4)), dT))


def test_gate_routes_to_the_host_on_the_cpu(monkeypatch):
    mesh, _, u, lam, mu, iso = _case("8x4x4", True)
    monkeypatch.setattr(el, "_VM_DEVICE_MIN_SIZE", 10)
    called = []
    monkeypatch.setattr(el, "_von_mises_device",
                        lambda *a, **kw: called.append(kw) or None)
    host = el._vm_from_gradients(el._element_gradients(mesh, u), np, 3, lam,
                                 mu, iso=iso)
    for device in ("cpu", None):
        with config_overrides(device="cpu"):
            out = el.von_mises_fields(mesh, u, lam, mu, iso=iso,
                                      device=device)
        assert not called
        for a, b in zip(out, host):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)


def test_gate_routes_big_card_solves_to_the_device(monkeypatch):
    mesh, _, u, lam, mu, _ = _case("8x4x4", False)
    called = []
    monkeypatch.setattr(el, "_von_mises_device",
                        lambda *a, **kw: called.append(kw["device"]) or "dev")
    monkeypatch.setattr(el, "_VM_DEVICE_MIN_SIZE", u.size + 1)
    with config_overrides(device="cuda"):
        assert el.von_mises_fields(mesh, u, lam, mu)[0].dtype == np.float64
    monkeypatch.setattr(el, "_VM_DEVICE_MIN_SIZE", u.size)
    with config_overrides(device="cuda"):
        assert el.von_mises_fields(mesh, u, lam, mu) == "dev"
    assert [str(d) for d in called] == ["cuda"]


def test_a_failing_device_evaluation_raises(monkeypatch):
    """No host fallback: the error of the card reaches the caller."""
    mesh, _, u, lam, mu, _ = _case("8x4x4", False)
    monkeypatch.setattr(el, "_VM_DEVICE_MIN_SIZE", 10)

    def fail(*a, **kw):
        raise RuntimeError("device von Mises failed")

    monkeypatch.setattr(el, "_von_mises_device", fail)
    with pytest.raises(RuntimeError, match="device von Mises failed"):
        el.von_mises_fields(mesh, u, lam, mu, device="cuda")


def test_static_solve_takes_the_gate_with_its_device(monkeypatch, tmp_path):
    """``solve_elasticity_nd`` hands its configured device to the gate."""
    seen = []
    orig = el.von_mises_fields

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return orig(*a, **kw)

    monkeypatch.setattr(el, "von_mises_fields", spy)
    mesh = box_mesh(4, 2, 2, (0, 0, 0), (1.0, 0.2, 0.2))
    with config_overrides(device="cpu"):
        values, info = el.solve_elasticity_nd(
            mesh, 210e9, 0.3, np.array([0.0, 0.0, -7.65e4]), "3d")
    assert seen == ["cpu"] and info["converged"]
    assert np.all(np.isfinite(values))


def test_chip_smoke_device_von_mises_phase_rehearsal():
    """``chip_smoke.device_von_mises_phase`` on a call recorded on the
    CPU's float32 device path: within its bound of the host float64 path,
    and a planted fault in the recorded field fails it."""
    import chip_smoke

    mesh, _, u, lam, mu, iso = _case("16x8x8", True)
    out = el._von_mises_device(mesh, u, lam, mu, iso=iso, device="cpu")
    rec = dict(mesh=mesh, u=u, lam=lam, mu=mu, iso=iso, device="cpu",
               out=out, seconds=0.0)
    res = chip_smoke.device_von_mises_phase(rec, "cpu", device="cpu")
    assert max(res["gap_stress"], res["gap_strain"]) <= 1e-5
    bad = (out[0].copy(), out[1])
    bad[0].flat[7] *= 1.001
    with pytest.raises(RuntimeError, match="chip_smoke check failed"):
        chip_smoke.device_von_mises_phase(dict(rec, out=bad), "cpu",
                                          device="cpu")
    host = tuple(a.astype(np.float64) for a in out)
    with pytest.raises(RuntimeError, match="did not run on the card"):
        chip_smoke.device_von_mises_phase(dict(rec, out=host), "cpu",
                                          device="cpu")
