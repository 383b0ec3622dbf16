"""K2's frozen work counts (portbench/work/fused_iter.py) against a count
made here from a plain transcription of the social-work row
(SocialWorkCost::computeSocialForce, sfm.hpp:237-281) on 4 forward-mode
tangents, and the whole evaluation's count against one worked out by hand
at a small shape."""

import math

from portbench import harness

work = harness.load_by_path("work", "fused_iter")


class Counter:
    n = 0


class D4:
    """A value with 4 tangents that counts the operations it does: +, -,
    x, /, sqrt and each elementary function one each."""

    def __init__(self, p, t=(0.0, 0.0, 0.0, 0.0)):
        self.p, self.t = p, list(t)

    @staticmethod
    def ops(k):
        Counter.n += k

    def __add__(self, o):
        self.ops(5)
        return D4(self.p + o.p, [a + b for a, b in zip(self.t, o.t)])

    def __sub__(self, o):
        self.ops(5)
        return D4(self.p - o.p, [a - b for a, b in zip(self.t, o.t)])

    def __mul__(self, o):
        self.ops(13)
        return D4(self.p * o.p, [a * o.p + self.p * b for a, b in zip(self.t, o.t)])

    def scale(self, c):
        self.ops(5)
        return D4(self.p * c, [a * c for a in self.t])

    def __neg__(self):
        self.ops(5)
        return D4(-self.p, [-a for a in self.t])

    def __truediv__(self, o):
        self.ops(16)  # inv, p, (-p inv) inv, then 3 a tangent
        inv = 1.0 / o.p
        return D4(self.p * inv, [a * inv - self.p * inv * inv * b for a, b in zip(self.t, o.t)])

    def sqrt(self):
        self.ops(6)  # sqrt, 0.5 / root, 4 tangents
        r = math.sqrt(self.p)
        return D4(r, [0.5 / r * a for a in self.t])

    def exp(self):
        self.ops(5)
        e = math.exp(self.p)
        return D4(e, [e * a for a in self.t])

    def cos(self):
        self.ops(7)  # sin, cos, -sin, 4 tangents
        return D4(math.cos(self.p), [-math.sin(self.p) * a for a in self.t])

    def sin(self):
        self.ops(4)  # cos already formed
        return D4(math.sin(self.p), [math.cos(self.p) * a for a in self.t])


def atan2(y, x):
    D4.ops(19)  # x^2 + y^2 (3), atan2, x / d, -y / d (3), 3 a tangent
    d = x.p * x.p + y.p * y.p
    return D4(math.atan2(y.p, x.p), [x.p / d * a - y.p / d * b for a, b in zip(y.t, x.t)])


def pair_force(mx, my, mvx, mvy, ox, oy, ovx, ovy):
    lam, gamma, n, nprime, factor = 2.0, 0.35, 2.0, 3.0, 2.1
    dx, dy = mx - ox, my - oy
    dn = (dx * dx + dy * dy).sqrt()
    ddx, ddy = dx / dn, dy / dn
    ix = (mvx - ovx).scale(lam) + ddx
    iy = (mvy - ovy).scale(lam) + ddy
    il = (ix * ix + iy * iy).sqrt()
    idx, idy = ix / il, iy / il
    theta = atan2(ddy, ddx) - atan2(idy, idx)
    D4.ops(3)  # the wrap, atan2(sin, cos), on the primal
    b = il.scale(gamma)
    dob = dn / b
    bt = b * theta
    bt3 = bt.scale(nprime)
    fvel = -(-(dob + bt3 * bt3)).exp()
    bt2 = bt.scale(n)
    fang = (-(dob + bt2 * bt2)).exp().scale(-1.0).scale(1.0)
    lnx = -idy
    fx = (fvel * idx + fang * lnx).scale(factor)
    fy = (fvel * idy + fang * idx).scale(factor)
    return fx, fy


def counted(fn):
    Counter.n = 0
    fn()
    return Counter.n


def seeds():
    def seed(p, k):
        t = [0.0] * 4
        t[k] = 1.0
        return D4(p, t)
    return seed(0.1, 0), seed(0.2, 1), seed(0.3, 2), seed(0.4, 3)


def test_pair_force_counts():
    px, py, yaw, v = seeds()
    vx, vy = D4(0.2), D4(-0.1)
    other = (D4(1.0), D4(0.5), D4(0.3), D4(0.1))
    sfx = sfy = wp = D4(0.0)

    def on_robot():
        fx, fy = pair_force(px, py, vx, vy, *other)
        return sfx + fx, sfy + fy

    def on_slot():
        fx, fy = pair_force(*other, px, py, vx, vy)
        return wp + (fx * fx + fy * fy)

    assert counted(on_robot) == work.PAIR_ON_ROBOT_OPS
    assert counted(on_slot) == work.PAIR_ON_SLOT_OPS


def test_step_in_view_count():
    px, py, yaw, v = seeds()
    sfx = sfy = wp = D4(0.5, [1, 2, 3, 4])

    def step():
        rvx, rvy = v * yaw.cos(), v * yaw.sin()
        wr = sfx * sfx + sfy * sfy
        return rvx, rvy, ((wr + wp) + D4(1e-6)).scale(120.0)

    assert counted(step) == work.STEP_IN_VIEW_OPS


def test_operations_by_hand():
    """B = 2 scenarios, S = 3 steps, NB = 1 (D = 2), N = 2 slots; one
    scenario has one person in view."""
    per_row = 3 + 8 * 2 + 2 * 3 + 12
    rows = 2 * 3 * 5 + 1 * 3 * 3
    people = 3 * (1 * 426 + 1 * 2 * 452 + 1 * 83)
    assert work.operations(2, 3, 1, 2, in_view_lanes=1, valid_people=1) == rows * per_row + people


def test_bytes_by_hand():
    per_step = 4 * (3 + 1 + 4 + 1 + 3 + 2) + 3
    per_lane = 4 * (2 + 1 + 2 + 4)
    people = 1 * 3 * 2 * 5 * 4
    assert work.bytes_moved(2, 3, 1, 2, in_view_lanes=1) == 2 * (3 * per_step + per_lane) + people


def test_least_time_is_the_larger():
    t, by = work.least_seconds(4096, 29, 3, 3, 3000, 6000)
    ops = work.operations(4096, 29, 3, 3, 3000, 6000) / work.F32_FLOPS_PER_S
    byt = work.bytes_moved(4096, 29, 3, 3, 3000) / work.HBM_BYTES_PER_S
    assert t == max(ops, byt) and by == ("operations" if ops >= byt else "bytes")
