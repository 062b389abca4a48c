"""``device_idle_share`` over the live farm's profiled blocks."""
from gpubench.measure import idle_pct as read  # noqa: F401
