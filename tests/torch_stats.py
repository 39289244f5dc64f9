"""The keys of the port's ``solver_stats`` against the JAX package's."""

from pde_solver_tpu_torch.ops.timestepping import SCAN_STATS
from pde_solver_tpu_torch.utils import observability as obs


def port_keys() -> set:
    """What the port's latest request adds to its tool's stats: its
    counters, the seconds of each span it opened and of each device clock
    it read, and, where it ran a scan, the scan's tallies."""
    req = obs.last_request()
    names = {sp.name for sp in req.spans}
    return (set(obs.COUNTERS)
            | {obs.SPAN_KEYS[name] + "_seconds" for name in names}
            | {key for key, _, _ in req.clocks}
            | (set(SCAN_STATS) if "scan" in names else set()))


def same_keys(stats, stats_ref) -> bool:
    """The port's stats (its latest request's) hold every key of the JAX
    package's, and besides them what that request added."""
    return set(stats) == set(stats_ref) | port_keys()
