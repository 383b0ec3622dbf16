"""head_ms_per_tick (tick head: step_pre, with K5): the device time of the
tick graph's kernels before its first lm_continue, in ms, averaged over the
traced ticks; the head lies outside every conditional body, so the profile
lists it every launch."""

from portbench import trace


def read(r):
    heads = [h for h in trace.head_seconds(r.session, r.span) if h is not None]
    return sum(heads) / len(heads) * 1e3 if heads else None
