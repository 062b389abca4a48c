"""Host ms the live farm spends assembling a block's push from its decode
FIFOs and encoding it for the wire: the farm's ``assemble`` span
(``StreamFarm.run(spans=)``), the mean over the window's blocks."""
from gpubench.measure import host_mean_ms


def read(r):
    return host_mean_ms(r, "farm.assemble")
