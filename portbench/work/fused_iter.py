"""K2's work (csrc/fused_iter.cu, ops/fused_iter.py: fused_cost_g_jtj): the
operations and bytes one evaluation needs, counted from the cell's shapes,
never from the build, so the same work gets the same bound whatever
implements it; and the published peaks of one NVIDIA H100 SXM it is held
to.

One evaluation, per scenario with S steps, D = 2 NB decision variables and
N people slots:

* operations, counted as +, -, x, /, sqrt and each elementary function
  (exp, sin, cos, atan2) one each:
  - the rows: each step has 5 residual rows (velocity, goal-align,
    path-follow, path-align, obstacle) and a step of a scenario with a
    person in view 3 more (social work, agent angle, proxemics); each
    row's 4 partials (x, y, yaw, v) reach the step's pose and velocity
    sensitivities (D each) and are contracted into the cost, g and the
    upper triangle of JtJ: ROW_OPS_FIXED + ROW_OPS_PER_D D + D (D + 1)
    a row, and ROW_EVAL_OPS for a row's own value and partials;
  - the people: the social-work row takes, for a step in view, the force
    on the robot from each valid person and on each of the N slots from
    the robot, each a social-force pair carried on 4 forward-mode tangents
    (PAIR_ON_ROBOT_OPS, PAIR_ON_SLOT_OPS), and the robot's duals and the
    row's total (STEP_IN_VIEW_OPS);
* bytes, each input read once and each output written once: per step the
  pose (3), velocity (1), the sensitivities of x, y to each block's v
  and w (4 NB) and of yaw (NB), the costmap sample and its two gradients
  (3), the reference point (2), 3 one-byte masks; per scenario u (D), the
  cost (1), g (D) and JtJ (D x D); for a step in view each slot's 5
  fields of the projected people.

The constants are counted from the reference's formulas
(SocialWorkCost::computeSocialForce, sfm.hpp:237-281, forward mode with 4
tangents as the reference's Ceres jets carry them);
tests/test_work_counts.py counts them again from a plain transcription.
"""

F32_FLOPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3 (data sheet)

# One social-force pair on 4 tangents (2 sqrt, 4 divisions, 2 atan2, the
# wrap as atan2(sin, cos), 2 exp and their tangents' chain rule), with its
# accumulation: into the force on the robot (from a valid person), or as
# the force on a slot squared into the social work (every slot).
PAIR_ON_ROBOT_OPS = 426
PAIR_ON_SLOT_OPS = 452
# A step in view: the robot's velocity duals (v cos yaw, v sin yaw) and
# the row's total, w (|F_robot|^2 + sum over slots + 1e-6), on 4 tangents.
STEP_IN_VIEW_OPS = 83
ROW_EVAL_OPS = 12  # a plain row's value and its 4 partials
ROW_OPS_FIXED = 3  # cost: r * r accumulated
ROW_OPS_PER_D = 8  # J row = 4 partials x D sensitivities, g += r J
STEP_ROWS, SOCIAL_ROWS = 5, 3


def operations(batch: int, steps: int, nb: int, slots: int, in_view_lanes: int,
               valid_people: int) -> float:
    """Operations of one evaluation: `in_view_lanes` scenarios have a
    person in view, `valid_people` persons in view in all (after the FOV
    filter)."""
    d = 2 * nb
    per_row = ROW_OPS_FIXED + ROW_OPS_PER_D * d + d * (d + 1) + ROW_EVAL_OPS
    rows = batch * steps * STEP_ROWS + in_view_lanes * steps * SOCIAL_ROWS
    people = steps * (valid_people * PAIR_ON_ROBOT_OPS + in_view_lanes * slots * PAIR_ON_SLOT_OPS
                      + in_view_lanes * STEP_IN_VIEW_OPS)
    return float(rows * per_row + people)


def bytes_moved(batch: int, steps: int, nb: int, slots: int, in_view_lanes: int) -> float:
    d = 2 * nb
    per_step = 4 * (3 + 1 + 4 * nb + nb + 3 + 2) + 3
    per_lane = 4 * (d + 1 + d + d * d)
    people = in_view_lanes * steps * slots * 5 * 4
    return float(batch * (steps * per_step + per_lane) + people)


def least_seconds(batch, steps, nb, slots, in_view_lanes, valid_people):
    """The larger of the operations over the FP32 peak and the bytes over
    the HBM peak, and which of the two it is."""
    t_ops = operations(batch, steps, nb, slots, in_view_lanes, valid_people) / F32_FLOPS_PER_S
    t_bytes = bytes_moved(batch, steps, nb, slots, in_view_lanes) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
