"""device_idle_pct (device): the share of the traced window in which no
fleet tick's device work ran, in % (trace.idle_pct)."""

from portbench.trace import idle_pct as read  # noqa: F401
