"""The trajectorizer kernel's one-pass lookahead search (csrc/trajectorize.cu:
search_point, reduce_search), modelled in float32 on the CPU and held to the
plain version's index (controller/trajectorizer.py: _lookahead_point).

The kernel gives a scenario L lanes (16 or 32; the model takes 8 as
well, the schedule at any power of two). Lane l walks waypoints
l, l + L, ... in ascending order once a step and forms the largest index
within the lookahead, the least masked distance with the largest index at
it, and a NaN flag, computing no distance past n (a masked +inf is a
minimiser only where the least is +inf); then log2(L) shuffle rounds, each
lane taking its partner lane ^ off, combine the maxima of the first and the
least (distance, index) pairs, ties to the larger index, a NaN entering as
(-inf, 0). The model below runs that schedule lane by lane on the distances
the plain version computes, so what it checks is the order of the search
and of the reduction, for every step of a plain rollout of each plan:

- utils/scenarios.py's TRAJECTORIZER_CASES (no waypoint, one, a full plan,
  every waypoint beyond the lookahead, tied minimisers, ...);
- random plans from a NumPy seed at P = 1, 31, 33 and 128, with planted
  ties (repeated waypoints, beyond the lookahead and within it) and a NaN
  waypoint before n and past it.

A model that swaps the roles of the within-maximum and of the least
distance gives another index on these plans, so the test can fail.
No card, no JAX: a few seconds.
"""

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch.controller import trajectorizer as ttraj
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import PathInput
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_trajectorizer_cases

LANES = (8, 16, 32)


def plain_index(px, py, valid, rx, ry, lookahead):
    """_lookahead_point's index, by its own operations (its coordinates are
    held to _lookahead_point's in the test)."""
    p = px.shape[1]
    idx = torch.arange(p)[None, :]
    dist = torch.hypot(rx[:, None] - px, ry[:, None] - py)
    within = valid & (dist <= lookahead)
    idx_within = torch.where(within, idx, -1).max(dim=1).values
    masked = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    is_min = masked == masked.min(dim=1, keepdim=True).values
    idx_min = torch.where(is_min, idx, -1).max(dim=1).values
    return torch.where(idx_within >= 0, idx_within, idx_min).clamp(0, p - 1), dist


def kernel_search(dist, n, lookahead, lanes, swap=False):
    """The kernel's search on distances `dist` (R, P) float32 with n (R,)
    valid waypoints: each of `lanes` lanes a pass over its waypoints, then
    the shuffle rounds. `swap`: a wrong model that prefers the least
    distance over the within-maximum. Returns the index (R,)."""
    r, p = dist.shape
    look = np.float32(lookahead)
    within = np.full((r, lanes), -1, np.int64)
    least = np.full((r, lanes), np.inf, np.float32)
    at = np.full((r, lanes), -1, np.int64)
    nan = np.zeros((r, lanes), bool)
    lane = np.arange(lanes)
    for j in range(-(-p // lanes)):
        i = lane + j * lanes  # (L,) this round's waypoint of each lane
        held = i < p
        ic = np.minimum(i, p - 1)
        valid = held[None, :] & (i[None, :] < n[:, None])
        d = dist[:, ic]
        within = np.where(valid & (d <= look), i[None, :], within)
        isnan = valid & np.isnan(d)
        nan |= isnan
        finite = valid & ~isnan
        lower = finite & (d < least)
        tie = finite & (d == least)
        least = np.where(lower, d, least)
        at = np.where(lower | tie, i[None, :], at)
        # past n: a masked +inf, a minimiser only at an infinite least
        past = held[None, :] & ~valid & (least == np.inf)
        at = np.where(past, i[None, :], at)
    key = np.where(nan, np.float32(-np.inf), least)
    idx = np.where(nan, 0, at)
    off = lanes // 2
    while off:
        partner = lane ^ off
        within = np.maximum(within, within[:, partner])
        k2, i2 = key[:, partner], idx[:, partner]
        take = (k2 < key) | ((k2 == key) & (i2 > idx))
        key = np.where(take, k2, key)
        idx = np.where(take, i2, idx)
        off //= 2
    within, idx = within[:, 0], idx[:, 0]
    least_idx = np.maximum(idx, 0)
    if swap:
        return np.where(least_idx >= 0, least_idx, within)
    return np.where(within >= 0, within, least_idx)


def random_plans(p, batch, seed):
    """`batch` plans of P waypoints around the robot: a random walk, with
    repeated waypoints (exact ties) within reach and, in a plan that runs
    away from 6 m off, its nearest waypoint thrice beyond the lookahead; a NaN
    waypoint before n in some plans and past n in others, n from 0 to P
    (0 and 1 in the last two)."""
    rng = np.random.default_rng(seed)
    pose = np.concatenate([rng.uniform(-2, 2, (batch, 2)), rng.uniform(-np.pi, np.pi, (batch, 1))],
                          axis=1)
    pts = np.cumsum(rng.normal(0.0, 0.3, (batch, p, 2)), axis=1) + rng.uniform(-3, 3, (batch, 1, 2))
    n = rng.integers(0, p + 1, batch).astype(np.int32)
    n[: batch // 4] = p
    n[-1], n[-2] = 0, 1  # no valid waypoint; one
    for b in range(batch):
        if p >= 4 and b % 6 == 3:  # the plan runs away from 6 m off; its nearest point thrice
            pts[b] = pose[b, :2] + np.stack([6.0 + np.cumsum(rng.uniform(0.1, 0.3, p)),
                                             rng.normal(0.0, 0.2, p)], axis=1)
            pts[b, rng.choice(np.arange(1, p), 2, replace=False)] = pts[b, 0]
        elif p >= 4 and b % 3 == 0:  # ties: one waypoint repeated at three places
            src = rng.integers(0, p)
            pts[b, rng.choice(p, 3, replace=False)] = pts[b, src]
        if p >= 2 and b % 5 == 1:  # a NaN waypoint before n
            pts[b, rng.integers(0, max(int(n[b]), 1))] = np.nan
        if b % 5 == 2 and n[b] < p:  # a NaN waypoint past n
            pts[b, rng.integers(int(n[b]), p)] = np.nan
    path = PathInput(points=torch.tensor(pts, dtype=torch.float32),
                     yaw=torch.zeros((batch, p)), n=torch.tensor(n))
    return path, torch.tensor(pose, dtype=torch.float32)


def cases_plans():
    tr = C.benchmark_social_config().trajectorizer
    path, pose, _ = make_trajectorizer_cases(tr, 44, 128, seed=3)
    return tr, PathInput(*(torch.as_tensor(x) for x in path)), torch.as_tensor(pose)


def rollout_poses(tr, path, pose):
    """The robot poses of a plain rollout of each plan, one row a (plan,
    step): the poses the search sees on the card."""
    out = ttraj.trajectorize_plain(tr, path, pose)
    steps = out.poses[:, :-1]  # (B, S, 3): the pose each step searches from
    b, s = steps.shape[:2]
    rep = lambda t: t.repeat_interleave(s, dim=0)  # noqa: E731
    return (PathInput(rep(path.points), rep(path.yaw), rep(path.n)),
            steps.reshape(b * s, 3))


def check(tr, path, pose, lanes):
    """Model index == plain index on every step of a plain rollout; returns
    how many rows the swapped model gets wrong."""
    path, pose = rollout_poses(tr, path, pose)
    px, py = path.points[..., 0], path.points[..., 1]
    rx, ry = pose[:, 0], pose[:, 1]
    want, dist = plain_index(px, py, path.valid, rx, ry, tr.lookahead_dist)
    wpx, wpy = ttraj._lookahead_point(px, py, path.valid, rx, ry, tr.lookahead_dist)
    got_x = torch.gather(px, 1, want[:, None])[:, 0]
    got_y = torch.gather(py, 1, want[:, None])[:, 0]
    assert torch.equal(got_x.isnan(), wpx.isnan()) and torch.equal(got_y.isnan(), wpy.isnan())
    keep = ~(got_x.isnan() | got_y.isnan())
    assert torch.equal(got_x[keep], wpx[keep]) and torch.equal(got_y[keep], wpy[keep])
    d = dist.numpy()
    n = path.n.numpy().astype(np.int64)
    got = kernel_search(d, n, tr.lookahead_dist, lanes)
    np.testing.assert_array_equal(got, want.numpy())
    return int((kernel_search(d, n, tr.lookahead_dist, lanes, swap=True) != want.numpy()).sum())


@pytest.mark.parametrize("lanes", LANES)
def test_search_equals_plain_index_on_the_cases(lanes):
    """Every TRAJECTORIZER_CASES plan, every step of its plain rollout."""
    tr, path, pose = cases_plans()
    assert check(tr, path, pose, lanes) > 0


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("p", [1, 31, 33, 128])
def test_search_equals_plain_index_on_random_plans(p, lanes):
    """Random plans with planted ties and NaN waypoints before and past n."""
    tr = C.benchmark_social_config().trajectorizer
    path, pose = random_plans(p, 24, seed=p)
    swapped = check(tr, path, pose, lanes)
    assert p == 1 or swapped > 0


def test_the_plans_reach_every_branch_of_the_search():
    """The random plans hold the cases the search must get right: a NaN
    before n, a NaN past n, no valid waypoint, ties beyond the lookahead."""
    path, pose = random_plans(33, 24, seed=33)
    pts, n = path.points.numpy(), path.n.numpy()
    idx = np.arange(33)[None, :]
    nan = np.isnan(pts).any(axis=2)
    assert (nan & (idx < n[:, None])).any() and (nan & (idx >= n[:, None])).any()
    assert (n == 0).any()
    tr = C.benchmark_social_config().trajectorizer
    full, rows = rollout_poses(tr, path, pose)
    _, dist = plain_index(full.points[..., 0], full.points[..., 1], full.valid, rows[:, 0],
                          rows[:, 1], tr.lookahead_dist)
    masked = torch.where(full.valid, dist, torch.full_like(dist, float("inf")))
    least = masked.min(dim=1, keepdim=True).values
    ties = ((masked == least).sum(dim=1) > 1) & (least[:, 0] > tr.lookahead_dist) \
        & torch.isfinite(least[:, 0])
    assert bool(ties.any())
