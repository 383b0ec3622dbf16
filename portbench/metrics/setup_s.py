"""setup_s: seconds from the process's start to the first timed tick:
imports, the card's context, the kernel library from the port's build
cache (or its first build), the inputs made from the seed and put on the
card, and the warm-up that captures every shape the cell uses."""


def read(r):
    return r.setup_s
