"""Host ms to enqueue one block of a render job: the benchmark's host clock
around each block's ``emit`` (no synchronise), the mean over the window's
blocks."""
from gpubench.measure import host_mean_ms


def read(r):
    return host_mean_ms(r, "emit")
