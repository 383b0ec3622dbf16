"""device_idle_pct.robot (device): device_idle_pct for one robot's ticks,
the NumPy inputs' copies to the card inside each tick's span."""

from portbench.trace import idle_pct as read  # noqa: F401
