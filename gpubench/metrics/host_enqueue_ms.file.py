"""Host ms to enqueue one block of the node chain rendered to a file, by
``host_enqueue_ms.render``'s arithmetic: the benchmark's host clock around
each block's ``emit`` (no synchronise), the mean over the window's blocks."""
from functools import partial

from gpubench.measure import host_mean_ms

read = partial(host_mean_ms, name="emit")
