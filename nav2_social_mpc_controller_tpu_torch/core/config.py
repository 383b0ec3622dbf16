"""Typed configuration tree mirroring the reference's ROS 2 parameter
namespace, with identical names and defaults, so the reference's YAML files
load verbatim.

Reference param declarations:
  controller level: social_mpc_controller.cpp:59-65
  trajectorizer.*:  path_trajectorizer.cpp:52-71
  optimizer.* / optimizer.weights.*: optimizer.cpp:16-85

Everything here is static (plain Python numbers), read once when a step
closure is built, exactly like the reference reads params once at configure()
time. This is the PyTorch port's own copy of the JAX package's
``core/config.py``: same field names and defaults, no import of that package.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

# Linear-solver names accepted by the reference (optimizer.hpp:71-77 +
# optimizer.cpp:31-45). All map to the same batched dense Cholesky path;
# the name is validated for config compatibility only.
VALID_LINEAR_SOLVER_TYPES = (
    "DENSE_QR",
    "DENSE_NORMAL_CHOLESKY",
    "SPARSE_NORMAL_CHOLESKY",
    "DENSE_SCHUR",
    "ITERATIVE_SCHUR",
)


@dataclasses.dataclass(frozen=True)
class WeightsConfig:
    """optimizer.weights.* (defaults: optimizer.cpp:57-75)."""

    distance_weight: float = 3.0
    social_weight: float = 1.0
    velocity_weight: float = 0.5
    angle_weight: float = 0.0
    agent_angle_weight: float = 0.5
    proxemics_weight: float = 90.0
    velocity_feasibility_weight: float = 0.5
    obstacle_weight: float = 0.0
    goal_align_weight: float = 0.0
    # Latent critic weights: compiled into the reference's critic library but
    # never added to the problem (SURVEY.md section 2.2); off by default.
    curvature_weight: float = 0.0
    curvature_max_angle: float = 0.4
    pure_angle_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """optimizer.* (defaults: optimizer.cpp:26-83)."""

    linear_solver_type: str = "SPARSE_NORMAL_CHOLESKY"
    param_tol: float = 1e-15
    fn_tol: float = 1e-7
    gradient_tol: float = 1e-10
    max_iterations: int = 100
    debug_optimizer: bool = False
    control_horizon: int = 5
    parameter_block_length: int = 5
    current_path_weight: float = 1.0
    current_cmds_weight: float = 1.0
    weights: WeightsConfig = dataclasses.field(default_factory=WeightsConfig)

    # Hardcoded in the reference but configurable here:
    desired_linear_vel: float = 0.6  # optimizer.cpp:238
    v_min: float = 0.0  # box bounds, optimizer.cpp:373-379
    v_max: float = 0.6
    w_min: float = -1.4
    w_max: float = 1.4

    # Performance knob (no reference equivalent; 0 = disabled): crop the
    # costmap once per tick to an (n, n) window centered on the robot before
    # the LM loop, so every obstacle-critic sample reads the window instead
    # of the full grid. EXACT-output requirement: the window must
    # cover the robot's reachable set, i.e.
    #   n/2 >= (S*time_step*v_max + front_offset)/resolution + 2 bicubic taps
    # (= 30.4 cells for the benchmark configs at resolution 0.05, so 64 is
    # safe). Samples never leave a window that satisfies this, making the
    # crop bit-identical to full-grid sampling including border clamping.
    obstacle_window_cells: int = 0

    # Framework extension (no reference equivalent): how the LM solve is
    # warm-started on ticks after the first.
    #   "reference" (default) — exact reference semantics: decision block b
    #     initializes from optimization ROW b's velocity, i.e. block 0 from
    #     the measured speed and blocks 1.. from the 0.5/0.5 blend of the
    #     trajectorizer's step-(b-1) command with the PREVIOUS tick's
    #     step-(b-1) command (optimizer.cpp:256-260 + format_to_optimize
    #     :484-551). Note this is NOT the previous solution: rows 1..B-1 all
    #     lie inside block 0's span, so blocks 1.. restart from the previous
    #     BLOCK-0 value — the solver re-traverses most of the distance every
    #     tick (see docs/performance.md, warm-start economics).
    #   "previous_solution" — initialize block b from the previous tick's
    #     OWN block-b optimum (carry.prev_cmds[b*block_length]). Converges in
    #     far fewer LM iterations on warm ticks; final commands may differ
    #     from the reference wherever the reference's 40-iteration cap binds
    #     before convergence (the solution is then trajectory-dependent).
    warm_start_mode: str = "reference"

    def __post_init__(self):
        if self.linear_solver_type not in VALID_LINEAR_SOLVER_TYPES:
            raise ValueError(
                f"Invalid linear_solver_type {self.linear_solver_type!r}. "
                f"Valid values are {', '.join(VALID_LINEAR_SOLVER_TYPES)}"
            )
        if self.warm_start_mode not in ("reference", "previous_solution"):
            raise ValueError(
                f"Invalid warm_start_mode {self.warm_start_mode!r}. "
                "Valid values are 'reference', 'previous_solution'"
            )


@dataclasses.dataclass(frozen=True)
class TrajectorizerConfig:
    """trajectorizer.* (defaults: path_trajectorizer.cpp:52-59)."""

    omnidirectional: bool = False
    desired_linear_vel: float = 0.4
    lookahead_dist: float = 0.4
    max_angular_vel: float = 1.0
    time_step: float = 0.05
    max_time: float = 3.0

    @property
    def max_steps(self) -> int:
        """round(max_time / time_step) (path_trajectorizer.cpp:84)."""
        return int(round(self.max_time / self.time_step))


@dataclasses.dataclass(frozen=True)
class SocialMPCConfig:
    """Top-level controller config (social_mpc_controller.cpp:59-65) plus
    framework shape parameters."""

    desired_linear_vel: float = 0.5
    fov_angle: float = math.pi / 4.0
    trajectorizer: TrajectorizerConfig = dataclasses.field(default_factory=TrajectorizerConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)

    # Static-shape parameters of the batched build (no reference equivalent;
    # the reference hardcodes 3 agents, optimizer.cpp:467-479):
    n_agents: int = 3
    # Maximum input-plan points after path-handler windowing:
    max_path_points: int = 128
    # SFM constants used in people projection (optimizer.cpp:584-591,614-615)
    people_desired_vel: float = 0.5
    people_radius: float = 0.5
    robot_sfm_desired_vel: float = 0.6
    robot_sfm_radius: float = 0.5
    goal_radius: float = 0.25
    # transformGlobalPlan / getTransformedGoal distances
    # (social_mpc_controller.cpp:169-171)
    max_robot_pose_search_dist: float = 4.0
    goal_dist: float = 2.5

    # Performance knob (no reference equivalent; 0 = disabled): window the
    # projection scan's per-step nearest-obstacle lookups to an (n, n) table
    # cropped once per tick around each agent's starting cell.
    # EXACT-output requirement:
    #   n/2 >= ceil(people_desired_vel * time_step * (max_steps - 1)
    #               / esdf_resolution) + 1
    # (= 16 cells for the benchmark configs at resolution 0.05, so 32 is
    # safe at H=18 and 44 at the H=36 stress horizon).
    esdf_window_cells: int = 0

    @property
    def horizon_steps(self) -> int:
        """Max rollout steps S of the optimization problem.

        format_to_optimize truncates the trajectorized path to
        maxsize-1 = round(max_time/time_step)-1 poses when longer
        (optimizer.cpp:492-497), giving at most maxsize-2 velocity steps;
        an untruncated path of max_steps+1 poses gives max_steps... the
        binding cap is maxsize-2 when the trajectorizer saturates.
        We size buffers to max_steps (an upper bound for every case).
        """
        return self.trajectorizer.max_steps

    @property
    def n_blocks(self) -> int:
        """Number of 2-wide decision-variable blocks:
        ceil(control_horizon / parameter_block_length) with the reference's
        min() clamps (optimizer.cpp:248-249)."""
        h = self.optimizer.control_horizon
        b = min(self.optimizer.parameter_block_length, h)
        return -(-h // b)


def _subtree(d: Dict[str, Any], *keys: str) -> Dict[str, Any]:
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return {}
        d = d[k]
    return d if isinstance(d, dict) else {}


def _pick(d: Dict[str, Any], fields) -> Dict[str, Any]:
    return {k: d[k] for k in fields if k in d}


def load_config_from_yaml(path: str, plugin_name: str = "FollowPath") -> SocialMPCConfig:
    """Load a SocialMPCConfig from a reference-format ROS 2 params YAML.

    Accepts the reference's files verbatim (e.g.
    params/soc_work_obst_parameters_in_benchmark.yaml): navigates
    controller_server -> ros__parameters -> <plugin_name>. Also accepts a
    bare {trajectorizer: ..., optimizer: ...} mapping.
    """
    import yaml  # only the YAML loader needs it

    with open(path) as f:
        raw = yaml.safe_load(f)

    plugin = _subtree(raw, "controller_server", "ros__parameters", plugin_name)
    if not plugin:
        plugin = _subtree(raw, plugin_name) or raw or {}

    tr = _pick(
        _subtree(plugin, "trajectorizer"),
        [f.name for f in dataclasses.fields(TrajectorizerConfig)],
    )
    opt_raw = _subtree(plugin, "optimizer")
    wt = _pick(
        _subtree(opt_raw, "weights"),
        [f.name for f in dataclasses.fields(WeightsConfig)],
    )
    opt = _pick(opt_raw, [f.name for f in dataclasses.fields(OptimizerConfig)])
    opt.pop("weights", None)
    top = _pick(plugin, ["desired_linear_vel", "fov_angle"])

    return SocialMPCConfig(
        **top,
        trajectorizer=TrajectorizerConfig(**tr),
        optimizer=OptimizerConfig(weights=WeightsConfig(**wt), **opt),
    )


def benchmark_social_config(**overrides) -> SocialMPCConfig:
    """The soc_work_obst_parameters_in_benchmark.yaml configuration
    (params/soc_work_obst_parameters_in_benchmark.yaml:106-137), inlined."""
    base = dict(
        desired_linear_vel=0.5,
        esdf_window_cells=32,
        trajectorizer=TrajectorizerConfig(
            omnidirectional=False,
            desired_linear_vel=0.6,
            lookahead_dist=2.0,
            max_angular_vel=1.4,
            time_step=0.05,
            max_time=1.5,
        ),
        optimizer=OptimizerConfig(
            linear_solver_type="DENSE_SCHUR",
            param_tol=1e-9,
            fn_tol=1e-5,
            gradient_tol=1e-8,
            max_iterations=40,
            control_horizon=18,
            parameter_block_length=6,
            current_path_weight=1.0,
            current_cmds_weight=0.5,
            obstacle_window_cells=64,
            weights=WeightsConfig(
                distance_weight=20.0,
                social_weight=120.0,
                velocity_weight=10.0,
                angle_weight=250.0,
                agent_angle_weight=40.0,
                velocity_feasibility_weight=5.0,
                goal_align_weight=10.0,
                obstacle_weight=0.13,
            ),
        ),
    )
    base.update(overrides)
    return SocialMPCConfig(**base)


def benchmark_omni_6agents_config(**overrides) -> SocialMPCConfig:
    """BASELINE.json config 3: omnidirectional robot, 6 agents, proxemics +
    agent-angle critics, H=18. The optimizer's decision variables stay
    (v, w) — the reference's omnidirectional flag only changes the reference
    trajectory's control law (path_trajectorizer.cpp:190-194)."""
    cfg = benchmark_social_config(**overrides)
    return dataclasses.replace(
        cfg,
        n_agents=6,
        trajectorizer=dataclasses.replace(cfg.trajectorizer, omnidirectional=True),
    )


def benchmark_stress_h36_config(**overrides) -> SocialMPCConfig:
    """BASELINE.json config 5: H=36 stress horizon (6 blocks -> 12 decision
    vars); max_time extended so the row budget covers the horizon."""
    cfg = benchmark_social_config(**overrides)
    return dataclasses.replace(
        cfg,
        esdf_window_cells=44,  # 39 scan steps -> 19.5-cell drift bound
        trajectorizer=dataclasses.replace(cfg.trajectorizer, max_time=2.0),
        optimizer=dataclasses.replace(cfg.optimizer, control_horizon=36),
    )


def benchmark_obstacle_only_config(**overrides) -> SocialMPCConfig:
    """The obst_only_parameters_in_benchmark.yaml configuration
    (params/obst_only_parameters_in_benchmark.yaml:115-136): identical
    solver/horizon setup, social_weight and agent_angle_weight zeroed
    (proxemics keeps its declared default of 90.0, which never fires with an
    empty people list)."""
    cfg = benchmark_social_config(**overrides)
    return dataclasses.replace(
        cfg,
        optimizer=dataclasses.replace(
            cfg.optimizer,
            weights=dataclasses.replace(
                cfg.optimizer.weights,
                social_weight=0.0,
                agent_angle_weight=0.0,
            ),
        ),
    )


def config_from_dict(d: Dict[str, Any]) -> SocialMPCConfig:
    """Rebuild a SocialMPCConfig from ``dataclasses.asdict`` of one — the
    port's or the JAX package's, whose field names are identical. This is how
    a configuration crosses between the two packages without either
    importing the other."""
    d = dict(d)
    tr = TrajectorizerConfig(**d.pop("trajectorizer"))
    opt = dict(d.pop("optimizer"))
    weights = WeightsConfig(**opt.pop("weights"))
    return SocialMPCConfig(
        trajectorizer=tr, optimizer=OptimizerConfig(weights=weights, **opt), **d
    )
