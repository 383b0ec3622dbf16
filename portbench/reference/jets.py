"""Float64 NumPy dual numbers ("jets") for the parity oracle's Jacobians.

A frozen copy of the repository's parity/jets.py, kept with the benchmark
so that the yardstick does not move when that file does. It differs in
this paragraph, the path below, and jsqrt at 0, whose tangent is infinite
as the C++ jets' is, where Python's float division raises (a person
exactly on the robot's pose in a closed-loop campaign; the critic then
replaces that distance and drops the tangent).

Ceres differentiates every critic with forward-mode jets
(ceres::DynamicAutoDiffCostFunction — e.g. the templated operator() of
the reference's include/nav2_social_mpc_controller/critics/distance_cost_function.hpp:96-132
instantiated at ceres::Jet): each scalar carries its value plus exact
partial derivatives along the decision-variable basis. The oracle's
original central-difference probe (eps = 1e-7) reproduced those Jacobians
only to ~1e-7 relative — enough to converge to the same optimum, but the FD
noise became the measurement floor of the parity instrument itself
(VERDICT r4 missing-item 2: a 2.5e-4 outlier in the jacobi-scaling study
was attributed to probe noise rather than semantics). This module is the
NumPy-f64 port of the dual-number pattern already used on the TPU side
(nav2_social_mpc_controller_tpu/ops/dual4.py), with a D-wide tangent basis
matching the oracle's decision vector — the oracle residual math evaluates
UNCHANGED over either plain floats or jets, so the Jacobian now has the
same semantics as Ceres' (exact, cell-local for the bicubic interpolant,
tangent-killing on the same branches).

The primal arithmetic of a jet op is the identical float64 expression the
plain path executes, so enabling jets changes no residual value — only how
derivatives are obtained (pinned by tests/test_oracle_jets.py).
"""

import math

import numpy as np


class Jet:
    """value + exact gradient along a fixed D-wide basis (float64)."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = float(v)
        self.d = np.asarray(d, dtype=np.float64)

    # ---- arithmetic -----------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Jet):
            return Jet(self.v + o.v, self.d + o.d)
        if isinstance(o, np.ndarray):
            return NotImplemented
        return Jet(self.v + o, self.d)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Jet):
            return Jet(self.v - o.v, self.d - o.d)
        if isinstance(o, np.ndarray):
            return NotImplemented
        return Jet(self.v - o, self.d)

    def __rsub__(self, o):
        if isinstance(o, np.ndarray):
            return NotImplemented
        return Jet(o - self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Jet):
            return Jet(self.v * o.v, self.v * o.d + o.v * self.d)
        if isinstance(o, np.ndarray):
            return NotImplemented
        return Jet(self.v * o, self.d * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        # Primal uses true division (NOT v * (1/o.v)) so jet evaluation is
        # bit-identical to the plain float path; only tangents use inv.
        if isinstance(o, Jet):
            inv = 1.0 / o.v
            pv = self.v / o.v
            return Jet(pv, (self.d - pv * o.d) * inv)
        if isinstance(o, np.ndarray):
            return NotImplemented
        return Jet(self.v / o, self.d / o)

    def __rtruediv__(self, o):
        if isinstance(o, np.ndarray):
            return NotImplemented
        pv = o / self.v
        return Jet(pv, -(pv / self.v) * self.d)

    def __pow__(self, n):
        if not isinstance(n, int):
            raise TypeError("Jet ** only supports integer exponents")
        return Jet(self.v**n, (n * self.v ** (n - 1)) * self.d)

    def __neg__(self):
        return Jet(-self.v, -self.d)

    def __pos__(self):
        return self

    def __abs__(self):
        return Jet(abs(self.v), self.d if self.v >= 0 else -self.d)

    # ---- comparisons (on the primal, as ceres::Jet does) ----------------
    def _cmp(self, o, op):
        ov = o.v if isinstance(o, Jet) else o
        return op(self.v, ov)

    def __lt__(self, o):
        return self._cmp(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._cmp(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._cmp(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._cmp(o, lambda a, b: a >= b)

    def __eq__(self, o):
        return self._cmp(o, lambda a, b: a == b)

    def __ne__(self, o):
        return self._cmp(o, lambda a, b: a != b)

    __hash__ = None  # mutable-ish numeric; never used as a dict key

    def __repr__(self):
        return f"Jet({self.v!r}, {self.d!r})"


def val(x):
    """Primal of a jet or plain number."""
    return x.v if isinstance(x, Jet) else float(x)


def seed(u_flat):
    """(D,) float vector -> (D,) object array of jets with identity basis."""
    u_flat = np.asarray(u_flat, dtype=np.float64)
    d = u_flat.shape[0]
    out = np.empty(d, dtype=object)
    eye = np.eye(d)
    for k in range(d):
        out[k] = Jet(u_flat[k], eye[k])
    return out


def value_and_jacobian(residual_fn, u_flat):
    """Evaluate residual_fn once over a jet-seeded u: (r (R,), J (R, D)).

    residual_fn must be scalar-generic (the oracle's is); entries of its
    output that carry no u-dependence come back as plain floats with a zero
    Jacobian row."""
    u_flat = np.asarray(u_flat, dtype=np.float64)
    d = u_flat.shape[0]
    rj = residual_fn(seed(u_flat))
    r = np.array([val(x) for x in rj], dtype=np.float64)
    jac = np.vstack(
        [x.d if isinstance(x, Jet) else np.zeros(d) for x in rj]
    )
    return r, jac


# ---- scalar-generic math (dispatch on Jet vs float) ----------------------


def jsin(x):
    if isinstance(x, Jet):
        return Jet(math.sin(x.v), math.cos(x.v) * x.d)
    return math.sin(x)


def jcos(x):
    if isinstance(x, Jet):
        return Jet(math.cos(x.v), -math.sin(x.v) * x.d)
    return math.cos(x)


def jexp(x):
    if isinstance(x, Jet):
        e = math.exp(x.v)
        return Jet(e, e * x.d)
    return math.exp(x)


def jsqrt(x):
    if isinstance(x, Jet):
        r = math.sqrt(x.v)
        with np.errstate(divide="ignore", invalid="ignore"):
            return Jet(r, (np.float64(0.5) / r) * x.d)
    return math.sqrt(x)


def jatan2(y, x):
    """d atan2(y, x) = (x dy - y dx) / (x^2 + y^2) — identical to the
    ceres::Jet atan2 rule."""
    if not isinstance(y, Jet) and not isinstance(x, Jet):
        return math.atan2(y, x)
    yv, xv = val(y), val(x)
    denom = xv * xv + yv * yv
    dy = y.d if isinstance(y, Jet) else 0.0
    dx = x.d if isinstance(x, Jet) else 0.0
    return Jet(math.atan2(yv, xv), (xv * dy - yv * dx) / denom)
