"""The share of the profiled stretch in which no operation ran on the card:
1 - (union of the device's intervals / the stretch's span), in %."""
from gpubench.measure import idle_pct


def read(r):
    return idle_pct(r)
