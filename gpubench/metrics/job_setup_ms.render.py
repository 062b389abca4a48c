"""Host ms a render job spends in its set-up on the card: the union of the
program's ``rodio.setup.buffer`` (``SamplesBuffer``'s zero-padded copy),
``rodio.setup.probe`` (the content probe) and ``rodio.setup.time_major``
(the fused pipeline's transposed copy) spans in the profiled stretch, over
its jobs."""
from gpubench.measure import union_us
from gpubench.metrics.idle_in_emit_share import program_spans

SETUP = ("rodio.setup.buffer", "rodio.setup.probe", "rodio.setup.time_major")


def read(r):
    spans = program_spans(r, SETUP.__contains__)
    if not spans or not r.units:
        return None
    return union_us(spans) * 1e-3 / r.units
