"""Traffic: the same seed gives the same requests, the cycle sends every
value equally often with none repeated within its window, and the mixes
as committed draw inside their ranges."""

import itertools
import json
import os

import pytest

from portbench.lib import traffic

MIXES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "traffic")


def mix(name):
    with open(os.path.join(MIXES, name + ".json")) as f:
        return json.load(f)


def take(m, seed, n):
    return list(itertools.islice(traffic.requests(m, seed), n))


@pytest.mark.parametrize("name", ["followup", "materials", "loadcases"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 3 * 2**40])
def test_same_seed_same_requests(name, seed):
    m = mix(name)
    assert take(m, seed, 12) == take(m, seed, 12)
    assert take(m, seed, 12) != take(m, seed + 1, 12)


@pytest.mark.parametrize("name", ["followup", "materials", "loadcases"])
def test_draws_in_range(name):
    m = mix(name)
    for req in take(m, 99, 200):
        assert set(req) == set(m["draw"])
        for k, spec in m["draw"].items():
            if "uniform" in spec:
                lo, hi = spec["uniform"]
                assert lo <= req[k] <= hi
            elif "cycle" in spec:
                assert req[k] in spec["cycle"]


@pytest.mark.parametrize("seed", [1, 2, 3, 2**33])
def test_cycle_is_balanced_and_spaced(seed):
    m = mix("materials")
    spec = m["draw"]["diffusivity"]
    vals = [r["diffusivity"] for r in take(m, seed, 40)]
    k = spec["no_repeat_within"]
    for i in range(len(vals) - k + 1):
        assert len(set(vals[i:i + k])) == k
    for block in range(10):
        assert sorted(vals[4 * block:4 * block + 4]) == sorted(spec["cycle"])
    assert m["warmup"][0]["diffusivity"] not in spec["cycle"]
