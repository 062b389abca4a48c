"""Device operations (kernels, copies, fills) a sink buffer launches, from
the profiler's trace over the profiled stretch."""


def read(r):
    if r is None or not r.kernels or not r.units:
        return None
    return len(r.kernels) / r.units
