"""Host ms of the ``Resample`` node's ``emit`` a block: the mean length of
the program's ``rodio.emit.Resample`` spans in the profiled stretch (one a
block; the resampler gathers its buffer's frames inside the span). None
where the program opens no such span."""
from gpubench.metrics.idle_in_emit_share import program_spans

SPAN = "rodio.emit.Resample"


def read(r):
    spans = program_spans(r, SPAN.__eq__)
    if not spans:
        return None
    return sum(e - s for _, s, e in spans) / len(spans) * 1e-3
