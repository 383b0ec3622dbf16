"""tick_ms_p95: the 95th percentile over every tick of the window of the
host's time from handing a fleet tick's inputs to the port until its
commands are on the host, in ms (harness.p95_ms)."""

from portbench.harness import p95_ms as read  # noqa: F401
