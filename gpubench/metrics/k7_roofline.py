"""K7's share of its roofline as the AGC's gain smoother: the least time of
its bytes, operations and serial chain at the chain's block
(``kernels/k7.py``, ``peaks.json``; the chain bounds it) over its mean time
by name in the profiled stretch, in %."""
from gpubench.kernels import k7
from gpubench.measure import roofline_pct


def read(r):
    return roofline_pct(r, k7, (r.shapes if r is not None else {}).get("agc_samples"))
