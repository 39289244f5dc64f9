#!/usr/bin/env python3
"""Energy balance of the float32 Newmark scan on one GPU, by mesh width and
step tolerance.

    python3 newmark_energy.py

Runs ``solve_elasticity_3D_dynamic`` on the flagship's cantilever (1 m ×
0.2 m × 0.2 m, E = 210 GPa, released under gravity from rest, 10 steps of
1e-4 s) at 40×16×16 and 80×32×32 cells, each at ``transient_inner_tol``
1e-6 and 1e-8, and prints |½vᵀMv + ½uᵀKu − fᵀu| / |fᵀu| at the last
frame, evaluated on the host in float64 (0 in exact arithmetic).  A
balance that does not move with the step tolerance and grows fourfold per
halving of the mesh width is the float32 right side f − K ũ of the scan
(``chip_smoke.py`` reads the same balance at 160×64×64).  About 30 s on an
H100; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import chip_smoke as cs

CELLS = ((40, 16, 16), (80, 32, 32))
TOLS = (1e-6, 1e-8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("newmark_energy: no CUDA card", file=sys.stderr)
        return 2
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "newmark_energy")
    calls = cs.spy_newmark()
    for cells in CELLS:
        for tol in TOLS:
            kw = dict(cs.DYNAMIC_3D, nx=cells[0], ny=cells[1], nz=cells[2])
            del calls[:]
            with config_overrides(device="cuda", transient_inner_tol=tol,
                                  transient_mg_threshold=100,
                                  mg_threshold=100):
                api.solve_elasticity_3D_dynamic(**kw, data_dir=data_dir)
            (K, M, _, _, f, *_), _, res = calls[-1]
            share = cs.energy_share(K, M, f, res)
            print(f"{'x'.join(str(c) for c in cells)} cells, "
                  f"transient_inner_tol={tol:.0e}: "
                  f"{res.total_cg_iterations / kw['num_steps']:.1f} "
                  f"iterations a step, relres "
                  f"{res.max_relative_residual:.3e}, energy balance off by "
                  f"{share:.3e} of fᵀu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
