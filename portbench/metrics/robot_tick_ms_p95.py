"""robot_tick_ms_p95: the 95th percentile over every tick of the window of
one robot's tick (compute_velocity_commands on its NumPy inputs, until the
command is on the host), in ms (harness.p95_ms)."""

from portbench.harness import p95_ms as read  # noqa: F401
