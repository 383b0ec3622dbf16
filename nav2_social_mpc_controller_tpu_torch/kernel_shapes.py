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
                 the sources per lane ``sources_per_lane(N)`` gives.

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
D = 237. A config of NB blocks solves D = 2 NB, so NB stops at 118. K2's
general form holds 15 floats a step there (``fused_general_shared_bytes``).

What stays refused: past those limits, and K5 past N = 32: a scenario's
force lanes must fit one warp, and at N = 33 no count of sources per lane
does.
"""

BLOCKS = tuple(range(1, 7))
SOLVE_DIMS = tuple(range(2, 13, 2))
SPD_SOLVE_DIMS = tuple(range(1, 17))
MAX_AGENTS = 32

# Dynamic shared memory one block may opt in to on an H100 (and an H200).
SHARED_BYTES_PER_BLOCK = 232448


def general_solve_shared_bytes(d: int) -> int:
    """Shared memory of one system of the general solve
    (csrc/damped_step.cuh): the factor, D rows of D | 1 floats (an odd row
    stride, free of bank conflicts), and six vectors of D floats."""
    return 4 * (d * (d | 1) + 6 * d)


def fused_general_shared_bytes(s: int) -> int:
    """Shared memory of one scenario of K2's general form
    (csrc/fused_general.cu): a step's 10 sums of p p^T, 4 of r p and its
    cost, for S steps."""
    return 4 * 15 * s


GENERAL_MAX_DIM = max(
    d for d in range(1, 1024) if general_solve_shared_bytes(d) <= SHARED_BYTES_PER_BLOCK)
GENERAL_MAX_BLOCKS = GENERAL_MAX_DIM // 2
GENERAL_MAX_STEPS = SHARED_BYTES_PER_BLOCK // fused_general_shared_bytes(1)

SOLVE_WHY = ("the general form holds one system's Cholesky factor in one block's shared "
             f"memory, {SHARED_BYTES_PER_BLOCK} bytes on an H100, which fits "
             f"D <= {GENERAL_MAX_DIM}")
TEMPLATED, GENERAL = "templated", "general"


def form(fn: str, kind: str, n: int) -> str:
    """Which form of a kernel runs a shape on the card: TEMPLATED where the
    shape is instantiated, GENERAL up to the general limit; past it raise,
    naming the limit and why. The lists are read at each call (a cross-check
    of the two forms empties them for a while to take the general forms).

    kind "blocks": n = NB of K2, K6 and rollout_sample; "solve": n = D of
    K3, K4 and K7's damped step (D = 2 NB, even); "spd_solve": n = D of K7's
    standalone solve."""
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
    raise ValueError(f"{fn}: unknown kernel kind {kind!r}")


def sources_per_lane(n_agents: int) -> int:
    """K5's sources per lane for N agents: the fewest with which the
    scenario's force lanes, N * ceil(N / sources), fit one warp of 32."""
    for spl in range(1, n_agents + 1):
        if n_agents * -(-n_agents // spl) <= 32:
            return spl
    raise ValueError(f"{n_agents} agents do not fit one warp of force lanes")


SFM_SHAPES = tuple((n, sources_per_lane(n)) for n in range(1, MAX_AGENTS + 1))

# macro name -> the tuples it lists, in kernel_shapes.h
LISTS = {
    "SOCIAL_MPC_BLOCKS": tuple((nb,) for nb in BLOCKS),
    "SOCIAL_MPC_SOLVE_DIMS": tuple((d,) for d in SOLVE_DIMS),
    "SOCIAL_MPC_SPD_SOLVE_DIMS": tuple((d,) for d in SPD_SOLVE_DIMS),
    "SOCIAL_MPC_SFM_SHAPES": SFM_SHAPES,
}

# macro name -> value, in kernel_shapes.h: the general forms' limits
LIMITS = {
    "SOCIAL_MPC_GENERAL_MAX_BLOCKS": GENERAL_MAX_BLOCKS,
    "SOCIAL_MPC_GENERAL_MAX_DIM": GENERAL_MAX_DIM,
    "SOCIAL_MPC_GENERAL_MAX_STEPS": GENERAL_MAX_STEPS,
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
