"""K5's share of its roofline as the per-stream limiter: the least time its
bytes, operations and serial chain take at the cell's block
(``kernels/k5.py``, ``peaks.json``; the integrator's chain bounds it) over
its mean time by name in the profiled stretch, in %. None where no K5 ran."""
from gpubench.kernels import k5
from gpubench.measure import roofline_pct


def read(r):
    sh = r.shapes if r is not None else {}
    return roofline_pct(r, k5, sh.get("lanes"), sh.get("block"), sh.get("fr"), sh.get("to"),
                        sh.get("channels"))
