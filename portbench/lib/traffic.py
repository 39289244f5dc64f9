"""The one traffic generator: a mix's data file in, requests out.

A mix (``traffic/<name>.json``) holds

* ``warmup``: the requests set-up sends, as given (a list of parameter
  dicts);
* ``draw``: per parameter, how each window request draws it:
  ``{"uniform": [lo, hi]}``, ``{"value": x}``, or
  ``{"cycle": [v1, v2, ...], "no_repeat_within": k}``: blocks of the
  values in a drawn order, each value once a block, so every seed sends
  the same values as often, with no value twice among any k requests in a
  row.

Every draw comes from ``--seed`` (numpy's PCG64, which takes any whole
number); parameters are drawn in their sorted order, so a mix file's key
order does not change the requests.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def _cycle(rng: np.random.Generator, values: List, window: int
           ) -> Iterator:
    recent: List = []
    while True:
        for _ in range(10_000):
            block = [values[i] for i in rng.permutation(len(values))]
            seq = recent + block
            if all(len(set(seq[i:i + window])) == len(seq[i:i + window])
                   for i in range(len(seq) - window + 1)):
                break
        else:
            raise ValueError(f"no order of {values} keeps {window} apart")
        for v in block:
            yield v
        recent = (recent + block)[-(window - 1):] if window > 1 else []


def requests(mix: Dict, seed: int) -> Iterator[Dict]:
    """The window's requests, endless, the same for the same seed."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    draws = mix.get("draw", {})
    cycles = {}
    for name in sorted(draws):
        spec = draws[name]
        if "cycle" in spec:
            cycles[name] = _cycle(np.random.Generator(np.random.PCG64(
                [int(seed), len(cycles) + 1])), list(spec["cycle"]),
                int(spec.get("no_repeat_within", 1)))
    while True:
        req = {}
        for name in sorted(draws):
            spec = draws[name]
            if "uniform" in spec:
                lo, hi = spec["uniform"]
                req[name] = float(rng.uniform(lo, hi))
            elif "value" in spec:
                req[name] = spec["value"]
            elif "cycle" in spec:
                req[name] = next(cycles[name])
            else:
                raise ValueError(f"unknown draw for {name!r}: {spec}")
        yield req


def warmup(mix: Dict) -> List[Dict]:
    return [dict(r) for r in mix.get("warmup", [])]
