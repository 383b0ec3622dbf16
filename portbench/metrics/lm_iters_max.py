"""lm_iters_max (LM driver): the most LM iterations any lane ran in a
tick (aux.solve.iterations), which sets how many loop bodies the tick's
WHILE node runs, averaged over the traced ticks."""


def read(r):
    its = getattr(r, "iterations", None)
    return sum(float(x.max()) for x in its) / len(its) if its else None
