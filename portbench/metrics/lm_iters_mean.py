"""lm_iters_mean (LM driver): aux.solve.iterations averaged over every
lane of every traced tick."""


def read(r):
    its = getattr(r, "iterations", None)
    return sum(float(x.mean()) for x in its) / len(its) if its else None
