"""Host ms of the live farm's ``emit`` a block: the span the farm opens
around its chain's ``emit`` (``StreamFarm.run(spans=)``), by the host clock,
the mean over the window's blocks."""
from gpubench.measure import host_mean_ms


def read(r):
    return host_mean_ms(r, "farm.emit")
