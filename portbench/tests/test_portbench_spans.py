"""A traced run wraps each span target and the launch counter of the
program, and stops where one of them is gone, so that no layer falls
silently out of the breakdown."""

import importlib

import pytest

from portbench.lib import trace


def test_every_target_is_wrapped_and_put_back():
    launches = {}
    originals = {(m, a): getattr(importlib.import_module(m), a)
                 for m, a, _ in trace.SPANS + (trace.COUNTER + ("",),)}
    undo = trace.install_spans(launches)
    try:
        assert len(undo) == len(originals)
        for (m, a), fn in originals.items():
            now = getattr(importlib.import_module(m), a)
            assert now is not fn and now.__wrapped__ is fn
    finally:
        trace.remove_spans(undo)
    for (m, a), fn in originals.items():
        assert getattr(importlib.import_module(m), a) is fn


@pytest.mark.parametrize("target", [trace.SPANS[-1][:2], trace.COUNTER,
                                    (trace.COUNTER[0], trace.CAPTURING)],
                         ids=["span", "counter", "capture-flag"])
def test_a_missing_target_stops_the_traced_run(target, monkeypatch):
    mod = importlib.import_module(target[0])
    monkeypatch.delattr(mod, target[1])
    before = {(m, a): getattr(importlib.import_module(m), a, None)
              for m, a, _ in trace.SPANS}
    with pytest.raises(trace.MissingTarget, match=target[1]):
        trace.install_spans({})
    for (m, a), fn in before.items():   # nothing was left wrapped
        assert getattr(importlib.import_module(m), a, None) is fn
