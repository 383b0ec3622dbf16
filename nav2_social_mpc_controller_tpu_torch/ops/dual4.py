"""Minimal forward-mode dual numbers with a fixed 4-wide tangent basis.

Counterpart of the JAX package's ``ops/dual4.py``. Every critic residual is
DIAGONAL in the rollout step axis, so its Jacobian contribution reduces to
per-step partials w.r.t. the 4 step inputs the social-work critic consumes —
(x, y, yaw, v) — which are then chain-contracted against the rollout
sensitivities. Carrying 4 named tangents through a mechanical forward
evaluation avoids hand-deriving the Moussaid social-force gradient
(social_work_cost_function.hpp:164-228).

Representation: ``(p, (t0, t1, t2, t3))`` — a primal tensor plus 4 tangent
tensors of the same shape; a tangent entry may be ``None`` (symbolic zero),
so seeding with one-hots keeps early ops sparse. Plain elementwise torch over
tensors of any matching shape. Kernel K2 (csrc/fused_iter.cu) repeats these
rules operation for operation with dense tangents.
"""

import torch

K = 4  # tangent basis: d/dx, d/dy, d/dyaw, d/dv


def const(p):
    return (p, (None, None, None, None))


def seed(p, k):
    """Primal p whose tangent is 1 along basis direction k."""
    t = [None] * K
    t[k] = torch.ones_like(p)
    return (p, tuple(t))


def _zip2(ta, tb, f_a, f_b):
    """Combine tangent tuples: f_a applied to a's tangents, f_b to b's,
    summed where both exist; None stays symbolic."""
    out = []
    for a, b in zip(ta, tb):
        if a is None and b is None:
            out.append(None)
        elif a is None:
            out.append(f_b(b))
        elif b is None:
            out.append(f_a(a))
        else:
            out.append(f_a(a) + f_b(b))
    return tuple(out)


def _map1(t, f):
    return tuple(None if x is None else f(x) for x in t)


def add(a, b):
    return (a[0] + b[0], _zip2(a[1], b[1], lambda x: x, lambda x: x))


def sub(a, b):
    return (a[0] - b[0], _zip2(a[1], b[1], lambda x: x, lambda x: -x))


def mul(a, b):
    pa, pb = a[0], b[0]
    return (pa * pb, _zip2(a[1], b[1], lambda x: x * pb, lambda x: pa * x))


def scale(a, c):
    """a * c with c a constant (float or tensor)."""
    return (a[0] * c, _map1(a[1], lambda x: x * c))


def neg(a):
    return (-a[0], _map1(a[1], lambda x: -x))


def div(a, b):
    """a / b. The b-tangent term is ((-pa * inv) * inv) * x, left to right:
    inv * inv alone is never formed, so a divisor at the 1e-30 floor of the
    social force (inv = 1e30) does not overflow float32 by itself."""
    pa, pb = a[0], b[0]
    inv = 1.0 / pb
    return (pa * inv, _zip2(a[1], b[1], lambda x: x * inv, lambda x: -pa * inv * inv * x))


def exp(a):
    e = torch.exp(a[0])
    return (e, _map1(a[1], lambda x: e * x))


def sqrt_(a):
    r = torch.sqrt(a[0])
    half_inv = 0.5 / r
    return (r, _map1(a[1], lambda x: half_inv * x))


def cos(a):
    s = torch.sin(a[0])
    return (torch.cos(a[0]), _map1(a[1], lambda x: -s * x))


def sin(a):
    c = torch.cos(a[0])
    return (torch.sin(a[0]), _map1(a[1], lambda x: c * x))


def atan2(y, x):
    """d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)."""
    py, px = y[0], x[0]
    denom = px * px + py * py
    return (
        torch.atan2(py, px),
        _zip2(y[1], x[1], lambda ty: px / denom * ty, lambda tx: -py / denom * tx),
    )


def where(cond, a, b):
    """Select with a CONSTANT condition (no tangent through cond). A tangent
    that is symbolic on one side only comes out DENSE (zeros on that side)."""

    def sel(x, y):
        if x is None and y is None:
            return None
        if x is None:
            x = torch.zeros_like(y)
        if y is None:
            y = torch.zeros_like(x)
        return torch.where(cond, x, y)

    return (torch.where(cond, a[0], b[0]), tuple(sel(x, y) for x, y in zip(a[1], b[1])))


def tangents(a):
    """Densify: the 4 tangent tensors, with zeros for symbolic zeros."""
    return tuple(torch.zeros_like(a[0]) if t is None else t for t in a[1])
