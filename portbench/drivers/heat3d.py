"""Requests to the port's ``api.solve_heat_3D`` on a box, and their check.

A request sets the directional Dirichlet data (``T_left``, ``T_right``,
``T_side``), the initial temperature and, where the mix draws it, the
diffusivity; every other argument is the configuration's.  The answer is
the pickled ``TimeSeriesField``: its kept frames are held against the
plain θ-scheme of :mod:`portbench.reference.heat_theta`, by the largest
gap over all frames and nodes as a share of the reference's largest
magnitude (``frame_gap``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from portbench.lib import tool


class Driver:
    def __init__(self, config: Dict, device):
        self.config = config
        self.device = device
        self.overrides = dict(config.get("config_overrides", {}),
                              device=str(device))

    def call(self, req: Dict, data_dir: str) -> Dict:
        kwargs = dict(self.config["tool_args"], **req, data_dir=data_dir)
        return tool.call(self.config["tool"], kwargs, self.overrides, req,
                         int(kwargs["num_steps"]))

    finite = staticmethod(tool.finite)
    discard = staticmethod(tool.discard)

    def reference(self, req: Dict, **kw) -> Dict:
        from portbench.reference import heat_theta

        return heat_theta.trajectory(self.config, req, self.device, **kw)

    def compare(self, recs: List[Dict]) -> Dict[str, float]:
        gap = 0.0
        for rec in recs:
            values, times = tool.values(rec)
            ref = self.reference(rec["request"])
            gap = max(gap, frame_gap(values, times, ref))
        return {"frame_gap": gap}

    def control(self, recs: List[Dict]) -> Dict[str, float]:
        """The reference in the program's place in bfloat16, the precision
        below the float32 the scan states, read as compare reads the
        program: the same step solves to the same stopping rule, with only
        the type lowered."""
        import torch

        gap = 0.0
        for rec in recs:
            ref = self.reference(rec["request"])
            low = self.reference(rec["request"], dtype=torch.bfloat16)
            gap = max(gap, frame_gap(low["values"], low["times"], ref))
        return {"frame_gap": gap}


def frame_gap(values, times, ref) -> float:
    """Largest |program − reference| over the kept frames, as a share of the
    reference's largest magnitude; inf where the frames kept differ."""
    if values.shape != ref["values"].shape or not np.allclose(
            times, ref["times"], rtol=0, atol=1e-12):
        return math.inf
    scale = float(np.abs(ref["values"]).max()) or 1.0
    return float(np.abs(values - ref["values"]).max()) / scale
