"""Device busy ms a unit (a job, a block or a buffer): the union of the
device's intervals over the profiled stretch, over its units."""
from gpubench.measure import union_us


def read(r):
    if r is None or not r.kernels or not r.units:
        return None
    return union_us(r.kernels) * 1e-3 / r.units
