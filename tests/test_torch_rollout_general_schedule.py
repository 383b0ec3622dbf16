"""The general rollout's new schedule (csrc/rollout.cuh: rollout_general_warp)
keeps the bits of the one it replaced, modelled in float32 on the CPU.

The sensitivity rows of block k at a step are dt times a running sum: the
carry out of the chunks of 32 steps before, plus an inclusive Kogge-Stone
scan over the chunk's 32 lanes (rounds of 1, 2, 4, 8, 16: lane l adds lane
l - off's value) of the integrands

    dx/dv, dy/dv   blk == k ? cos, sin of the previous heading : +0.0
    dx/dw, dy/dw   -v sin, v cos times dt * (steps of block k before s)

The design before ran the four scans of every block in every chunk, one
warp a scenario. The general form now deals the blocks over W warps (warp
w takes blocks w, w + W, ...) and skips the scans of a (block, chunk) pair
with no step of the block: the dx/dv and dy/dv rows are then dt * carry,
and before the block's first step (its count 0) the dx/dw and dy/dw rows
too, but only where every lane's v cos and v sin is finite (at one chunk,
S <= 32, the kernel carries nothing and runs every scan). Both schedules
are modelled here step for step, the scans with numpy's float32 additions
(each rounded, as the card's), and held bit-equal (NaN where NaN) at
NB = 7, 9, 12, 18, 36, S = 29, 39, 69, 123, W = 1, 2, 4, 8 and B = 12:
block maps of the port's shrunk horizons, one that is not contiguous in
the steps (blocks interleaved), a -0.0 control, and a chunk with a NaN and
an infinite control, where the skip must not apply (a model that skips it
there anyway differs, so the test can fail). FMA contraction is the card's
and not modelled: the card tests hold the kernels to the same bits.
No card, no JAX: a few seconds.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")

F = np.float32
DT = F(0.05)
LANES = 32


def scan(x):
    """Inclusive Kogge-Stone scan over the last axis of 32 lanes, float32,
    in the card's order (rollout.cuh: warp_scan)."""
    x = x.astype(F)
    off = 1
    while off < LANES:
        y = np.concatenate([np.zeros_like(x[..., :off]), x[..., :-off]], axis=-1)
        x = np.where(np.arange(LANES) >= off, x + y, x).astype(F)
        off *= 2
    return x


def chunk_inputs(u, block_idx, th0):
    """Per chunk of 32 steps: (on, blk, cos / sin of the previous heading,
    v cos, v sin) of every scenario, (B, 32) each, the heading summed by
    the same scans; the values feed both schedules alike."""
    b, s = block_idx.shape
    out = []
    sum_w = np.zeros(b, F)
    cos_last, sin_last = np.cos(th0).astype(F), np.sin(th0).astype(F)
    for s0 in range(0, s, LANES):
        lane = np.arange(LANES)
        on = (s0 + lane) < s
        blk = np.where(on[None, :], block_idx[:, np.minimum(s0 + lane, s - 1)], -1)
        gathered = np.take_along_axis(u.reshape(b, -1, 2), np.maximum(blk, 0)[..., None], axis=1)
        v = np.where(on[None, :], gathered[..., 0], F(0)).astype(F)
        w = np.where(on[None, :], gathered[..., 1], F(0)).astype(F)
        cum_w = (sum_w[:, None] + scan(w)).astype(F)
        th = (th0[:, None] + DT * cum_w).astype(F)
        cos_th, sin_th = np.cos(th).astype(F), np.sin(th).astype(F)
        cosp = np.concatenate([cos_last[:, None], cos_th[:, :-1]], axis=1)
        sinp = np.concatenate([sin_last[:, None], sin_th[:, :-1]], axis=1)
        out.append((on, blk, cosp, sinp, (v * cosp).astype(F), (v * sinp).astype(F)))
        sum_w, cos_last, sin_last = cum_w[:, -1], cos_th[:, -1], sin_th[:, -1]
    return out


def block_chunk(carry, count, mine, cosp, sinp, vc, vs, v_scans, w_scans):
    """One (block, chunk) pair of every scenario (B, 32): the four sums and
    the next carries (B,) and counts (B,). Where v_scans / w_scans (B,) is
    False the scans are skipped: the sum is the carry, which stays."""
    below = np.cumsum(mine, axis=1) - mine  # steps of the block on the lanes before
    dth_prev = (DT * (count[:, None] + below).astype(F)).astype(F)
    sums = [(carry[q][:, None] + scan(x)).astype(F) for q, x in enumerate((
        np.where(mine == 1, cosp, F(0)), np.where(mine == 1, sinp, F(0)),
        (-vs) * dth_prev, vc * dth_prev))]
    for q, scanned in enumerate((v_scans, v_scans, w_scans, w_scans)):
        sums[q] = np.where(scanned[:, None], sums[q], carry[q][:, None]).astype(F)
    rows = [(DT * x).astype(F) for x in sums]
    return rows, [x[:, -1] for x in sums], count + mine.sum(axis=1)


def sensitivities(u, block_idx, th0, nb, warps=None, skip_nonfinite=False):
    """The (B, 4 NB, S) rows. warps None: the design before (every block's
    four scans in every chunk, blocks in order); else the general form's
    schedule on `warps` warps. skip_nonfinite: a wrong schedule that skips
    the dx/dw scans before a block's first step even where a v cos or
    v sin is not finite."""
    b, s = block_idx.shape
    rows = np.zeros((b, 4 * nb, s), F)
    order = (list(range(nb)) if warps is None else
             [k for w in range(warps) for k in range(w, nb, warps)])
    carry = {k: [np.zeros(b, F) for _ in range(4)] for k in range(nb)}
    count = {k: np.zeros(b, np.int64) for k in range(nb)}
    every = np.ones(b, bool)
    for c, (on, blk, cosp, sinp, vc, vs) in enumerate(chunk_inputs(u, block_idx, th0)):
        finite = np.isfinite(vc).all(axis=1) & np.isfinite(vs).all(axis=1)
        steps = np.arange(c * LANES, c * LANES + LANES)[on]
        for k in order:
            mine = (blk == k).astype(np.int64)
            v_scans = w_scans = every
            if warps is not None:
                v_scans = mine.any(axis=1)
                w_scans = v_scans | (count[k] != 0) | ~(finite | skip_nonfinite)
            r, carry[k], count[k] = block_chunk(carry[k], count[k], mine, cosp, sinp, vc, vs,
                                                v_scans, w_scans)
            for q in range(4):
                rows[:, q * nb + k, steps] = r[q][:, on]
    return rows


def same_bits(a, b):
    nan = np.isnan(a)
    same = a.view(np.int32)[~nan] == b.view(np.int32)[~nan]
    return bool((nan == np.isnan(b)).all() and same.all())


def inputs(nb, s, seed):
    """B = 12 scenarios: blocks of 1 or 2 over a shrunk horizon (the port's
    block maps, motion.block_index_sequence_dynamic), two with blocks
    interleaved in the steps (not contiguous), one with a -0.0 control, one
    with a NaN and one with an infinite control in its last chunk."""
    rng = np.random.default_rng(seed)
    b = 12
    u = rng.uniform(-0.8, 0.8, (b, 2 * nb)).astype(F)
    horizon = rng.integers(1, nb + 1, b)
    horizon[0] = nb
    length = np.where(np.arange(b) % 2 == 0, 1, 2)
    j = np.arange(s)[None, :]
    block_idx = np.minimum(j, horizon[:, None] * length[:, None] - 1) // length[:, None]
    block_idx = np.minimum(block_idx, nb - 1)
    block_idx[1] = j[0] % nb  # interleaved
    block_idx[2] = rng.permutation(np.arange(s) % nb)  # interleaved at random
    u[3, 0::2] = F(-0.0)  # every v of one scenario -0.0
    u[4, 1] = F(-0.0)
    last = block_idx[5, -1]
    u[5, 2 * last] = F(np.nan)
    u[6, 2 * block_idx[6, -1]] = F(np.inf)
    th0 = rng.uniform(-np.pi, np.pi, b).astype(F)
    return u, block_idx.astype(np.int64), th0


@pytest.mark.parametrize("s", [29, 39, 69, 123])
@pytest.mark.parametrize("nb", [7, 9, 12, 18, 36])
def test_general_schedule_keeps_the_bits(nb, s):
    """Every W: the dealt, skipping schedule equals the one before, bit for
    bit, NaN where NaN."""
    u, block_idx, th0 = inputs(nb, s, seed=nb * 1000 + s)
    want = sensitivities(u, block_idx, th0, nb)
    for warps in (1, 2, 4, 8):
        assert same_bits(sensitivities(u, block_idx, th0, nb, warps), want), warps


@pytest.mark.parametrize("nb,s", [(9, 69), (36, 123)])
def test_skipping_past_a_non_finite_control_would_change_the_bits(nb, s):
    """The condition on finite v cos, v sin matters: skipping the dx/dw
    scans of a block not yet started in a chunk where a control is NaN or
    infinite drops the NaN those scans carry, so such a schedule differs."""
    u, block_idx, th0 = inputs(nb, s, seed=7)
    for i in (5, 6):  # a non-finite control in the first chunk, blocks of 4 steps
        block_idx[i] = np.minimum(np.arange(s) // 4, nb - 1)
        u[i, 0] = F(np.nan) if i == 5 else F(np.inf)
    want = sensitivities(u, block_idx, th0, nb)
    assert same_bits(sensitivities(u, block_idx, th0, nb, 4), want)
    assert not same_bits(sensitivities(u, block_idx, th0, nb, 4, skip_nonfinite=True), want)


def test_the_inputs_reach_the_skips():
    """The block maps hold (block, chunk) pairs with no step of the block,
    both before its first step and after its last, and a chunk where every
    lane of a block is -0.0."""
    u, block_idx, _ = inputs(12, 123, seed=0)
    before = after = 0
    for row in block_idx:
        for c in range(0, 123, 32):
            chunk = set(row[c:c + 32].tolist())
            for k in range(12):
                if k not in chunk:
                    first = np.flatnonzero(row == k)
                    if first.size and first[0] > c:
                        before += 1
                    elif first.size:
                        after += 1
    assert before > 0 and after > 0
    assert (np.signbit(u[3, 0::2]) & (u[3, 0::2] == 0)).all()
