"""K2's device ms a block: the mean time of the serial plan's f32-ring
instance by name (``kernels/k2.py``'s ``NAME``) in the profiled stretch.
None where no K2 ran."""
import re

from gpubench.kernels import k2


def read(r):
    times = [e - s for n, s, e in (r.kernels if r is not None else [])
             if re.search(k2.NAME, n)]
    return sum(times) / len(times) * 1e-3 if times else None
