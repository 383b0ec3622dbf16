"""fused_iter_roofline_pct (kernels: csrc/fused_iter.cu, K2): K2's least
time a call (portbench/work/fused_iter.py: the larger of its operations at
the FP32 peak and its bytes at the HBM peak, counted from the cell's shapes
and the people in view after the FOV filter, averaged over the traced
ticks) over the mean device time of a K2 call in the profile, in %. None
where the segment launched no K2 (launch_counts) or the profile lists none."""

import re

from portbench import harness, trace

KERNEL = re.compile(r"\bfused_kernel\b")


def read(r):
    if not getattr(r, "fused_iter_calls", 0) or not getattr(r, "in_view", None):
        return None
    durations = []
    for a, b in r.session.spans.get(r.span, []):
        durations += [(d[1] - d[0]) * 1e-6 for d in trace.activities(r.session, a, b)
                      if KERNEL.search(d[2])]
    if not durations:
        return None
    work = harness.load_by_path("work", "fused_iter")
    least = [work.least_seconds(in_view_lanes=lanes, valid_people=people, **r.fused_iter_shape)[0]
             for lanes, people in r.in_view]
    return 100.0 * (sum(least) / len(least)) / (sum(durations) / len(durations))
