"""Host ms of a file render's block ``emit`` under the profiler, by
``emit_ms.render``'s arithmetic: the mean length of the program's
outermost ``rodio.emit.*`` spans in the profiled stretch (one a block:
``Limit`` over ``AutomaticGainControl``, ``BltFilter`` and
``LoopedDecoder``)."""
from gpubench.metrics.idle_in_emit_share import emit_ms as read  # noqa: F401
