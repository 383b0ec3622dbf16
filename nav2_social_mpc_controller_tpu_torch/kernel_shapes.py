"""The shapes the CUDA kernels are instantiated for: the one source of both
the wrappers' checks and the kernels' dispatch tables.

Every kernel is a template over a shape its arithmetic is unrolled for, so
the card runs a shape only if it was compiled for it. The sets below are
what the wrappers accept on a CUDA tensor; ``header()`` writes them as the
X-macro lists of ``kernel_shapes.h``, which ``_build.py`` generates into each
build and from which every ``csrc/*.cu`` dispatch expands its cases. The two
cannot drift: there is no other list.

  BLOCKS         NB of K2 (fused_iter.cu), K6 (rollout_prep.cu) and the
                 rollout-sample kernel: 1..6, D = 2 NB.
  SOLVE_DIMS     D of K3 / K4 (tr_iter.cu) and K7's damped step
                 (spd_solve.cu): every even D from 2 to 12.
  SPD_SOLVE_DIMS D of K7's standalone solve spd_solve(a, b): 1..16.
  SFM_SHAPES     (N, sources per lane) of K5 (sfm_scan.cu): N = 1..32 with
                 the sources per lane ``sources_per_lane(N)`` gives.

What stays refused, and why: NB > 6 (D > 12), because K2 keeps 1 + D +
D(D+1)/2 partial sums per lane in registers (91 at D = 12, 153 at D = 16):
a wider problem needs a K2 that reduces a JtJ tile in shared memory. The
standalone solve past D = 16: its row layout holds a row per lane of a
16-lane segment. K5 past N = 32: a scenario's force lanes must fit one warp,
and at N = 33 no count of sources per lane does.
"""

BLOCKS = tuple(range(1, 7))
SOLVE_DIMS = tuple(range(2, 13, 2))
SPD_SOLVE_DIMS = tuple(range(1, 17))
MAX_AGENTS = 32


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

HEADER_NAME = "kernel_shapes.h"


def header() -> str:
    """kernel_shapes.h: each list as an X-macro, `LIST(X)` expanding to
    X(a) X(b) ... (X(n, spl) for K5)."""
    lines = ["// Generated by nav2_social_mpc_controller_tpu_torch/kernel_shapes.py; do not edit.",
             "#pragma once", ""]
    for name, items in LISTS.items():
        cases = " ".join(f"X({', '.join(str(v) for v in item)})" for item in items)
        lines.append(f"#define {name}(X) {cases}")
    return "\n".join(lines) + "\n"
