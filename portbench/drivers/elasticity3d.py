"""Requests to the port's ``api.solve_elasticity_3D_static`` on a clamped
box, and their check.

A request is a load case: the body force ρ·g·s·(sin θ cos φ, sin θ sin φ,
−cos θ) of a load factor s, a tilt θ from the downward vertical and an
azimuth φ, with ρ and g the configuration's.  The answer is the von Mises
field the tool pickles, held against
:mod:`portbench.reference.elasticity_static` by its largest gap as a
share of the reference's largest value (``vm_gap``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

from portbench.lib import tool

LOAD_KEYS = ("load_factor", "tilt_deg", "azimuth_deg")
# the program's own path one precision below the float64-grade solve the
# configuration states: float32 CG on the kernel-backed operator
CONTROL = {"precision": "f32"}


def body_force(config: Dict, req: Dict) -> List[float]:
    w = float(config["density"]) * float(config["gravity"]) * float(
        req["load_factor"])
    th, ph = math.radians(req["tilt_deg"]), math.radians(req["azimuth_deg"])
    return [w * math.sin(th) * math.cos(ph), w * math.sin(th) * math.sin(ph),
            -w * math.cos(th)]


class Driver:
    def __init__(self, config: Dict, device):
        self.config = config
        self.device = device
        self.overrides = dict(config.get("config_overrides", {}),
                              device=str(device))
        self._ref = None

    def call(self, req: Dict, data_dir: str,
             overrides: Optional[Dict] = None) -> Dict:
        fx, fy, fz = body_force(self.config, req)
        kwargs = dict(self.config["tool_args"], body_fx=fx, body_fy=fy,
                      body_fz=fz, data_dir=data_dir,
                      **{k: v for k, v in req.items() if k not in LOAD_KEYS})
        return tool.call(self.config["tool"], kwargs,
                         dict(self.overrides, **(overrides or {})), req, 1)

    finite = staticmethod(tool.finite)
    discard = staticmethod(tool.discard)

    def reference(self):
        """The float64 reference, built once."""
        from portbench.reference.elasticity_static import Cantilever

        if self._ref is None:
            self._ref = Cantilever(self.config, self.device)
        return self._ref

    def compare(self, recs: List[Dict]) -> Dict[str, float]:
        ref = self.reference()
        gap = 0.0
        for rec in recs:
            vm = tool.values(rec)[0][0]
            vm_ref = ref.von_mises(body_force(self.config, rec["request"]))
            gap = max(gap, vm_gap(vm, vm_ref))
        return {"vm_gap": gap}

    def control(self, recs: List[Dict]) -> Dict[str, float]:
        """The program with its float32 path switched on, on the same
        requests, read as compare reads the program; a call that gives no
        field reads inf."""
        gap = 0.0
        for rec in recs:
            low = self.call(rec["request"], os.path.dirname(rec["file"]),
                            CONTROL)
            if "file" not in low:
                return {"vm_gap": math.inf}
            gap = max(gap, self.compare([low])["vm_gap"])
            tool.discard(low)
        return {"vm_gap": gap}


def vm_gap(vm, vm_ref) -> float:
    if vm.shape != vm_ref.shape:
        return math.inf
    return float(np.abs(vm - vm_ref).max()) / (
        float(np.abs(vm_ref).max()) or 1.0)
