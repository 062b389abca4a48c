"""The part of the profiled stretch in which no operation runs on the card
while the host is inside a block's ``emit``: the idle gaps of the device's
intervals that the program's outermost ``rodio.emit.*`` spans cover, over
the stretch's span, in %. A part of ``device_idle_share``; None without
device intervals or without the program's spans.

The span arithmetic the other readers of the program's spans share
(``emit_ms.*``, ``job_setup_ms.render``) is here too."""
from gpubench.measure import idle_gaps, union_us

#: the prefix of the program's spans around a node's ``emit``
EMIT = "rodio.emit."


def program_spans(r, keep):
    """(name, start_us, end_us) of the stretch's host events whose name
    ``keep`` accepts, clipped to the stretch."""
    if r is None or "span_start_us" not in r.shapes:
        return []
    s0, s1 = r.shapes["span_start_us"], r.shapes["span_end_us"]
    out = []
    for name, s, e in r.cpu_events:
        if keep(name):
            s, e = max(s, s0), min(e, s1)
            if e > s:
                out.append((name, s, e))
    return out


def outermost(spans):
    """The spans no other one of them contains, by start."""
    out = []
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        if out and s >= out[-1][1] and e <= out[-1][2]:
            continue
        out.append((name, s, e))
    return out


def emits(r):
    return outermost(program_spans(r, lambda name: name.startswith(EMIT)))


def emit_ms(r):
    """The mean length of the outermost emit spans, in ms."""
    spans = emits(r)
    if not spans:
        return None
    return sum(e - s for _, s, e in spans) / len(spans) * 1e-3


def covered_us(gaps, spans) -> float:
    """Length of the part of the (start, end) ``gaps`` that the union of
    ``spans`` covers."""
    return sum(union_us([(n, max(s, a), min(e, b)) for n, s, e in spans
                         if min(e, b) > max(s, a)])
               for a, b in gaps)


def read(r):
    if r is None or not r.kernels or r.span_us <= 0:
        return None
    spans = emits(r)
    if not spans:
        return None
    gaps = idle_gaps(r.kernels, (r.shapes["span_start_us"], r.shapes["span_end_us"]))
    return 100.0 * covered_us(gaps, spans) / r.span_us
