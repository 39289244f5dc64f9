"""On the card, at each cell's own size: the control (the reference in the
program's place, in the precision below the configuration's) fails the
cell's limit on three seeds, and the program meets it on the same seeds.
Marked ``cuda``: skips without a card.  Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -q \\
        portbench/tests/test_portbench_card.py
"""

import json
import os

import pytest

from portbench.tests import tiny

CELLS = ["cantilever3d-2M.loadcases"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.calibrate import calibrate

    with open(os.path.join(tiny.REPO, "portbench", "workloads",
                           cell + ".json")) as f:
        limits = json.load(f)["limits"]
    seeds = [2**31 + 11, 2**31 + 12, 2**31 + 13]
    _, summary = calibrate(tiny.REPO, cell, seeds, seeds)
    for key, limit in limits.items():
        assert summary[key]["lower"] <= limit, summary[key]
        assert summary[key]["upper"] > limit, summary[key]
