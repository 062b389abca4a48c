"""K6's share of its roofline: the least time its bytes, operations and
serial chain take at the cell's block (``kernels/k6.py``, ``peaks.json``;
the smoother's chain bounds it) over its mean time by name in the profiled
stretch, in %. None where no K6 ran."""
from gpubench.kernels import k6
from gpubench.measure import roofline_pct


def read(r):
    sh = r.shapes if r is not None else {}
    return roofline_pct(r, k6, sh.get("lanes"), sh.get("block"), sh.get("fr"), sh.get("to"),
                        sh.get("channels"))
