"""The shapes the CUDA kernels take: the one source of both the wrappers'
checks and the kernels' dispatch tables and limits.

Each kernel has a templated form, unrolled for a shape it was compiled for,
and the kernels that a config with more blocks runs have a general form too,
which takes NB and D at run time. The sets below are what the templated
forms are instantiated for; ``header()`` writes them as the X-macro lists of
``kernel_shapes.h``, which ``_build.py`` generates into each build and from
which every ``csrc/*.cu`` dispatch expands its cases, and writes the general
forms' limits beside them. The two cannot drift: there is no other list.

  BLOCKS         NB of K2 (fused_iter.cu), K6 (rollout_prep.cu) and the
                 rollout-sample kernel: 1..6, D = 2 NB.
  SOLVE_DIMS     D of K3 / K4 (tr_iter.cu) and K7's damped step
                 (spd_solve.cu): every even D from 2 to 12.
  SPD_SOLVE_DIMS D of K7's standalone solve spd_solve(a, b): 1..16.
  SFM_SHAPES     (N, sources per lane) of K5 (sfm_scan.cu): N = 1..32 with
                 the sources per lane ``sources_per_lane(N)`` gives; N from
                 33 to GENERAL_MAX_AGENTS runs K5's general form.

Past those lists the general forms run (``form``): NB from 7 to
GENERAL_MAX_BLOCKS for K2, K6 and rollout_sample, every even D from 14 to
2 GENERAL_MAX_BLOCKS for K3, K4 and K7's damped step, every D from 17 to
GENERAL_MAX_DIM for K7's standalone solve. The templated forms stop at 6
blocks because K2 keeps 1 + D + D(D+1)/2 partial sums a lane in registers
(91 at D = 12) and the rows layout of the solves a row per lane of a 16-lane
segment; the general forms keep their sums in shared memory instead, and
what bounds them is one block's shared memory (227 KB on an H100): the
general solve holds one system's Cholesky factor there, D x (D | 1) floats
and six vectors of D (``general_solve_shared_bytes``), which fits up to
D = 237 (a block a system; up to D = 32 a warp a system, in registers,
and several systems a block: ``general_solve_geometry``). A config of NB blocks solves D = 2 NB, so NB stops at 118. K2's
general form holds 15 floats a step there beside a tile of steps' staged
columns (``fused_general_shared_bytes``), which at D = 236 and a one-step
tile leaves room for S = 3748 (GENERAL_MAX_STEPS).

K5's templated form stops at N = 32 because a scenario's force lanes must
fit one warp (at N = 33 no count of sources per lane does). Past that its
general form runs (``form`` with kind "agents"): up to SFM_GENERAL_THREADS
threads a scenario, with every agent's scan state in shared memory, 64
bytes an agent, beside 16 a thread (``sfm_general_shared_bytes``); one
block's 227 KB holds one scenario of N = 3567 on 256 threads
(GENERAL_MAX_AGENTS).

What stays refused: past those limits.
"""

BLOCKS = tuple(range(1, 7))
SOLVE_DIMS = tuple(range(2, 13, 2))
SPD_SOLVE_DIMS = tuple(range(1, 17))
MAX_TEMPLATED_AGENTS = 32  # K5's templated form: N = 1..32

# Dynamic shared memory one block may opt in to on an H100 (and an H200).
SHARED_BYTES_PER_BLOCK = 232448


def general_solve_shared_bytes(d: int) -> int:
    """Shared memory of one system of the general solve
    (csrc/damped_step.cuh): the factor, D rows of D | 1 floats (an odd row
    stride, free of bank conflicts), and six vectors of D floats."""
    return 4 * (d * (d | 1) + 6 * d)


# K7's general solve (csrc/damped_step.cuh): a warp a system up to
# GENERAL_SOLVE_WARP_MAX_D, GENERAL_SOLVE_SYSTEMS of them a block, the
# system in registers; a block a system above, a thread a row (at least
# GENERAL_SOLVE_MIN_THREADS threads).
GENERAL_SOLVE_WARP_MAX_D = 32
GENERAL_SOLVE_SYSTEMS = 4
GENERAL_SOLVE_MIN_THREADS = 128


def general_solve_geometry(d: int):
    """The launch of K7's general solve (the damped step, scaled or not,
    and the standalone solve) at D, as the wrappers pass it to the C entry:
    (threads a system, systems a block, shared bytes a block). Up to D = 32
    a warp a system, no shared memory; above, a thread a row in whole warps,
    at least GENERAL_SOLVE_MIN_THREADS, and general_solve_shared_bytes(d).
    The C entry refuses a geometry its kernels do not take."""
    if d <= GENERAL_SOLVE_WARP_MAX_D:
        return 32, GENERAL_SOLVE_SYSTEMS, 0
    return max(GENERAL_SOLVE_MIN_THREADS, 32 * -(-d // 32)), 1, general_solve_shared_bytes(d)


# K2's general form (csrc/fused_general.cu): blocks of FUSED_GENERAL_BLOCK
# threads, and the most steps a tile of its second phase stages.
FUSED_GENERAL_BLOCK = 128
FUSED_GENERAL_STEP_TILE = 8


def fused_general_shared_bytes(s: int, d: int = 0, tile: int = 1) -> int:
    """Shared memory of one scenario of K2's general form at S steps and
    D = 2 NB columns: a step tile of `tile` steps staged, four float4s a
    column pair and step (its two columns' sensitivities and M_s times
    each), then each step's 10 sums of p p^T, 4 of r p and its cost,
    padded to 16 bytes. The defaults, the most columns and a one-step tile,
    bound the steps it takes (GENERAL_MAX_STEPS); d = 0 stands for them."""
    d = d or 2 * GENERAL_MAX_BLOCKS
    return 32 * d * tile + -(-4 * 15 * s // 16) * 16


def fused_general_geometry(nb: int, s: int):
    """The launch of K2's general form at NB blocks and S steps, as the C
    entry takes it: (threads a scenario, scenarios a block, step tile,
    shared bytes a block). A warp a scenario up to D = 32, 128 threads
    above; as many scenarios a block of FUSED_GENERAL_BLOCK as that leaves
    if they fit in 48 KB, else one; a tile of FUSED_GENERAL_STEP_TILE steps
    (S if fewer), fewer only where a long rollout's sums leave no room."""
    d = 2 * nb
    threads = 32 if d <= 32 else 128
    tile = min(s, FUSED_GENERAL_STEP_TILE)
    while tile > 1 and fused_general_shared_bytes(s, d, tile) > SHARED_BYTES_PER_BLOCK:
        tile -= 1
    spb = FUSED_GENERAL_BLOCK // threads
    if spb * fused_general_shared_bytes(s, d, tile) > 48 * 1024:
        spb = 1
    return threads, spb, tile, spb * fused_general_shared_bytes(s, d, tile)


# K5's general form: blocks of this many threads, one or more scenarios each.
SFM_GENERAL_THREADS = 256


def sfm_general_shared_bytes(n: int, threads: int = SFM_GENERAL_THREADS) -> int:
    """Shared memory of one scenario of K5's general form
    (csrc/sfm_scan.cu) on `threads` threads: each agent's position and
    velocity in two buffers (two float4s) and 8 words of the rest of its
    scan state (heading, goal, obstacle entry, the step's social force, a
    word of flags, rank and window corner), the robot's float4 in two
    buffers, and a float4 a thread (its agent's desired and obstacle
    forces)."""
    return 64 * n + 32 + 16 * threads


GENERAL_MAX_DIM = max(
    d for d in range(1, 1024) if general_solve_shared_bytes(d) <= SHARED_BYTES_PER_BLOCK)
GENERAL_MAX_BLOCKS = GENERAL_MAX_DIM // 2
GENERAL_MAX_STEPS = max(
    s for s in range(1, SHARED_BYTES_PER_BLOCK // 60 + 1)
    if fused_general_shared_bytes(s, 2 * GENERAL_MAX_BLOCKS, 1) <= SHARED_BYTES_PER_BLOCK)

SOLVE_WHY = ("the general form holds one system's Cholesky factor in one block's shared "
             f"memory, {SHARED_BYTES_PER_BLOCK} bytes on an H100, which fits "
             f"D <= {GENERAL_MAX_DIM}")
GENERAL_MAX_AGENTS = (SHARED_BYTES_PER_BLOCK - sfm_general_shared_bytes(0)) // 64
AGENTS_WHY = ("K5's general form keeps 64 bytes of each agent's scan state and 16 of each "
              f"of its threads in one block's shared memory, {SHARED_BYTES_PER_BLOCK} bytes on an "
              f"H100, which holds N <= {GENERAL_MAX_AGENTS}")
TEMPLATED, GENERAL = "templated", "general"


def form(fn: str, kind: str, n: int) -> str:
    """Which form of a kernel runs a shape on the card: TEMPLATED where the
    shape is instantiated, GENERAL up to the general limit; past it raise,
    naming the limit and why. The lists are read at each call (a cross-check
    of the two forms empties them for a while to take the general forms).

    kind "blocks": n = NB of K2, K6 and rollout_sample; "solve": n = D of
    K3, K4 and K7's damped step (D = 2 NB, even); "spd_solve": n = D of K7's
    standalone solve; "agents": n = N of K5."""
    if kind == "blocks":
        if n in BLOCKS:
            return TEMPLATED
        if 1 <= n <= GENERAL_MAX_BLOCKS:
            return GENERAL
        raise ValueError(
            f"{fn}: the kernels take NB from 1 to {GENERAL_MAX_BLOCKS} (templated for "
            f"{BLOCKS[0]}..{BLOCKS[-1]}, general above): a config of NB blocks solves "
            f"D = 2 NB, and {SOLVE_WHY}; got {n}")
    if kind == "solve":
        if n in SOLVE_DIMS:
            return TEMPLATED
        if n % 2 == 0 and 2 <= n <= 2 * GENERAL_MAX_BLOCKS:
            return GENERAL
        raise ValueError(
            f"{fn}: the kernel takes every even D from 2 to {2 * GENERAL_MAX_BLOCKS} "
            f"(D = 2 NB; templated for D in {list(SOLVE_DIMS)}, general above): "
            f"{SOLVE_WHY}; got {n}")
    if kind == "spd_solve":
        if n in SPD_SOLVE_DIMS:
            return TEMPLATED
        if 1 <= n <= GENERAL_MAX_DIM:
            return GENERAL
        raise ValueError(
            f"{fn}: the kernel takes D from 1 to {GENERAL_MAX_DIM} (templated for D in "
            f"{SPD_SOLVE_DIMS[0]}..{SPD_SOLVE_DIMS[-1]}, general above): {SOLVE_WHY}; "
            f"got {n}")
    if kind == "agents":
        if any(n == shape[0] for shape in SFM_SHAPES):
            return TEMPLATED
        if 1 <= n <= GENERAL_MAX_AGENTS:
            return GENERAL
        raise ValueError(
            f"{fn}: the kernel takes 1 to {GENERAL_MAX_AGENTS} agents (templated for "
            f"1..{MAX_TEMPLATED_AGENTS}: a scenario's force lanes fit one warp of 32; general "
            f"above): {AGENTS_WHY}; got {n}")
    raise ValueError(f"{fn}: unknown kernel kind {kind!r}")


def sources_per_lane(n_agents: int) -> int:
    """K5's sources per lane for N agents: the fewest with which the
    scenario's force lanes, N * ceil(N / sources), fit one warp of 32."""
    for spl in range(1, n_agents + 1):
        if n_agents * -(-n_agents // spl) <= 32:
            return spl
    raise ValueError(f"{n_agents} agents do not fit one warp of force lanes")


SFM_SHAPES = tuple((n, sources_per_lane(n)) for n in range(1, MAX_TEMPLATED_AGENTS + 1))

# macro name -> the tuples it lists, in kernel_shapes.h
LISTS = {
    "SOCIAL_MPC_BLOCKS": tuple((nb,) for nb in BLOCKS),
    "SOCIAL_MPC_SOLVE_DIMS": tuple((d,) for d in SOLVE_DIMS),
    "SOCIAL_MPC_SPD_SOLVE_DIMS": tuple((d,) for d in SPD_SOLVE_DIMS),
    "SOCIAL_MPC_SFM_SHAPES": SFM_SHAPES,
}

# macro name -> value, in kernel_shapes.h: the general forms' limits (and K5's
# general block size, K2's general step tile, the general solve's last D a
# warp a system, one block's shared memory)
LIMITS = {
    "SOCIAL_MPC_GENERAL_MAX_BLOCKS": GENERAL_MAX_BLOCKS,
    "SOCIAL_MPC_GENERAL_MAX_DIM": GENERAL_MAX_DIM,
    "SOCIAL_MPC_GENERAL_MAX_STEPS": GENERAL_MAX_STEPS,
    "SOCIAL_MPC_SFM_GENERAL_MAX_AGENTS": GENERAL_MAX_AGENTS,
    "SOCIAL_MPC_SFM_GENERAL_THREADS": SFM_GENERAL_THREADS,
    "SOCIAL_MPC_FUSED_GENERAL_STEP_TILE": FUSED_GENERAL_STEP_TILE,
    "SOCIAL_MPC_GENERAL_SOLVE_WARP_MAX_D": GENERAL_SOLVE_WARP_MAX_D,
    "SOCIAL_MPC_SHARED_BYTES_PER_BLOCK": SHARED_BYTES_PER_BLOCK,
}

HEADER_NAME = "kernel_shapes.h"


def header() -> str:
    """kernel_shapes.h: each list as an X-macro, `LIST(X)` expanding to
    X(a) X(b) ... (X(n, spl) for K5), then each limit as a constant."""
    lines = ["// Generated by nav2_social_mpc_controller_tpu_torch/kernel_shapes.py; do not edit.",
             "#pragma once", ""]
    for name, items in LISTS.items():
        cases = " ".join(f"X({', '.join(str(v) for v in item)})" for item in items)
        lines.append(f"#define {name}(X) {cases}")
    lines.append("")
    for name, value in LIMITS.items():
        lines.append(f"#define {name} {value}")
    return "\n".join(lines) + "\n"
