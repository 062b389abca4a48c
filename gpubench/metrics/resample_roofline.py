"""The resampler's pass as a share of its roofline: the least time its bytes
take at the cell's block (``kernels/resample_lerp.py``, ``peaks.json``) over
its mean time by name in the profiled stretch, in %. None where no such
kernel ran."""
from gpubench.kernels import resample_lerp
from gpubench.measure import roofline_pct


def read(r):
    sh = r.shapes if r is not None else {}
    return roofline_pct(r, resample_lerp, sh.get("lanes"), sh.get("block"), sh.get("fr"),
                        sh.get("to"), sh.get("channels"))
