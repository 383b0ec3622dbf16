"""solves_per_s: robot solves completed in the window over the window's
seconds (all of both)."""


def read(r):
    w = getattr(r, "window", None)
    return w.solves / w.seconds if w is not None and w.seconds > 0 else None
