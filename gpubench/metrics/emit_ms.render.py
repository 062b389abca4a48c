"""Host ms of a render job's block ``emit`` under the profiler: the mean
length of the program's outermost ``rodio.emit.*`` spans in the profiled
stretch (one a block: ``Limit`` over ``FusedWidePipeline``)."""
from gpubench.metrics.idle_in_emit_share import emit_ms as read  # noqa: F401
