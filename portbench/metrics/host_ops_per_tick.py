"""host_ops_per_tick (entry and compiled tick): the host's operations a
tick of the traced segment, from the port's own counter
step.tick.host_launches (input copies, graph launches, output clones)."""


def read(r):
    return r.host_ops / r.ticks if getattr(r, "host_ops", None) is not None else None
