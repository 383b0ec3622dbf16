"""device_idle_pct.campaign (device): device_idle_pct for campaigns, each
campaign's span from its first to its last device activity counted busy
(a campaign is one launch, its ticks and LM loops conditional bodies)."""

from portbench.trace import idle_pct as read  # noqa: F401
