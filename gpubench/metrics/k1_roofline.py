"""K1's share of its roofline: the least time its bytes, operations and
serial chain take at the cell's block (``kernels/k1.py``, ``peaks.json``;
the chain bounds it) over its mean time by name in the profiled stretch, in
%."""
from gpubench.kernels import k1
from gpubench.measure import roofline_pct


def read(r):
    sh = r.shapes if r is not None else {}
    return roofline_pct(r, k1, sh.get("lanes"), sh.get("block"), sh.get("fr"), sh.get("to"),
                        sh.get("channels"))
