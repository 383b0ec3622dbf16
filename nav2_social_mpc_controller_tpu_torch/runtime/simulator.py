"""Closed-loop simulator: the framework's replacement for the reference's
Gazebo validation loop (SURVEY.md section 4 — the reference was validated by
driving a simulated Jackal with the controller at 20 Hz).

Each tick: the controller produces a command from the current world state,
the robot integrates it for one control period, and pedestrians advance
under the Social Force Model (reacting to the robot). B closed loops run in
lockstep through the batched step (``make_step_batch``, the kernels on the
card); the per-tick state stays on the device, and the host reads nothing
until the caller does.

This is both a demo and the behavioral test harness: tests assert the robot
makes progress along the plan, respects velocity bounds, and keeps social
distance from pedestrians.
"""

from typing import NamedTuple

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    first_lane,
    make_carry,
    make_step_batch,
)
from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import (
    AgentsState,
    Scenario,
    resolve_device,
    scenario_from_numpy,
)
from nav2_social_mpc_controller_tpu_torch.core.validate import validate_batch_windows
from nav2_social_mpc_controller_tpu_torch.models import sfm
from nav2_social_mpc_controller_tpu_torch.models.motion import integrate_step
from nav2_social_mpc_controller_tpu_torch.world.grid import esdf_nearest_obstacle_diff


class SimResult(NamedTuple):
    robot_traj: torch.Tensor  # (B, T+1, 3) robot poses
    people_traj: torch.Tensor  # (B, T+1, N, 6)
    cmds: torch.Tensor  # (B, T, 2) executed [v, w]
    status: torch.Tensor  # (B, T) int32 controller status per tick
    min_people_dist: torch.Tensor  # (B,) closest robot-pedestrian approach (inf: nobody)
    goal_dist: torch.Tensor  # (B,) final distance to the plan's last point


def advance_people(cfg: SocialMPCConfig, people: AgentsState, robot_pose, robot_speed, esdf, dt):
    """One SFM step for the simulated pedestrians (robot as social agent).

    Pedestrians feel all three forces of the controller's own world model —
    desired + social + obstacle (sfm.hpp:205-235, 462-485) — so the
    Gazebo-replacement harness is no more forgiving than the SFM world the
    controller assumes during people projection (models/sfm.py).
    people.state (B, N, 6); robot_pose (B, 3); robot_speed (B, 2)."""
    st = people.state
    valid = people.valid
    pos = st[..., 0:2]
    yaw = st[..., 2]
    lv = st[..., 4]
    vel = torch.stack([lv * torch.cos(yaw), lv * torch.sin(yaw)], dim=-1)
    goal = pos + vel * 10.0  # keep walking their way

    r_vel = torch.stack(
        [robot_speed[:, 0] * torch.cos(robot_pose[:, 2]),
         robot_speed[:, 0] * torch.sin(robot_pose[:, 2])], dim=-1
    )
    all_pos = torch.cat([pos, robot_pose[:, None, 0:2]], dim=1)
    all_vel = torch.cat([vel, r_vel[:, None, :]], dim=1)
    all_valid = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
    social = sfm.pairwise_social_force(all_pos, all_vel, all_valid, sfm.DEFAULT_PARAMS)[:, :-1]

    desired = torch.full_like(yaw, cfg.people_desired_vel)
    f_des, _ = sfm.desired_force(
        pos, vel, goal, valid, cfg.goal_radius, desired, sfm.DEFAULT_PARAMS
    )
    obs_entry, obs_in = esdf_nearest_obstacle_diff(
        esdf.distances, esdf.indexes, esdf.origin, esdf.resolution, pos
    )
    f_obs = sfm.obstacle_force(
        pos, obs_entry, obs_in & esdf.valid[:, None] & valid, cfg.people_radius,
        sfm.DEFAULT_PARAMS,
    )
    pos_n, vel_n, yaw_n, lv_n, av_n, _ = sfm.sfm_update(
        pos, vel, yaw, f_des + social + f_obs, desired, goal, valid, cfg.goal_radius, dt
    )
    new = torch.stack(
        [pos_n[..., 0], pos_n[..., 1], yaw_n, st[..., 3], lv_n, av_n], dim=-1
    )
    return AgentsState(state=torch.where(valid[..., None], new, st))


def simulate(cfg: SocialMPCConfig, scenario: Scenario, n_ticks: int,
             control_period: float = 0.05, device="cuda", dtype=torch.float32) -> SimResult:
    """Run B closed loops for n_ticks on a BATCHED scenario (NumPy or tensor
    leaves; put on `device` with float dtype `dtype`). The windows are
    checked once, here; the ticks run the unchecked batched step."""
    if np.ndim(scenario.robot.pose) != 2:
        raise ValueError("simulate takes a batched scenario; make_simulate also takes one")
    dev = resolve_device(device)
    scen = start = scenario_from_numpy(scenario, device=dev, dtype=dtype)
    validate_batch_windows(cfg, scen)
    batch = scen.robot.pose.shape[0]
    step = make_step_batch(cfg, device=dev, dtype=dtype, validate=False)
    ctrl_carry = make_carry(cfg, batch, device=dev, dtype=dtype)

    poses, people_t, cmds, status, pds = [], [], [], [], []
    for _ in range(n_ticks):
        cmd, aux, ctrl_carry = step(scen, ctrl_carry)

        pose = scen.robot.pose
        x, y, th = integrate_step(
            pose[:, 0], pose[:, 1], pose[:, 2], cmd.linear_x, cmd.linear_y, cmd.angular_z,
            control_period,
        )
        new_pose = torch.stack([x, y, th], dim=-1)
        new_speed = torch.stack([cmd.linear_x, cmd.angular_z], dim=-1)

        # The pedestrians react to the PRE-tick robot pose and speed.
        people = advance_people(
            cfg, scen.people, pose, scen.robot.speed, scen.esdf, control_period
        )
        scen = scen._replace(
            robot=scen.robot._replace(pose=new_pose, speed=new_speed), people=people
        )

        pd = torch.sqrt(((people.state[..., 0:2] - new_pose[:, None, 0:2]) ** 2).sum(-1))
        pd = torch.where(people.valid, pd, torch.full_like(pd, float("inf"))).amin(dim=1)
        poses.append(new_pose)
        people_t.append(people.state)
        cmds.append(new_speed)
        status.append(aux.status)
        pds.append(pd)

    robot_traj = torch.stack([start.robot.pose] + poses, dim=1)
    people_traj = torch.stack([start.people.state] + people_t, dim=1)
    last = (start.path.n.long() - 1).clamp(0, start.path.points.shape[1] - 1)
    goal = torch.gather(start.path.points, 1, last[:, None, None].expand(-1, 1, 2))[:, 0]
    goal_dist = torch.sqrt(((robot_traj[:, -1, 0:2] - goal) ** 2).sum(-1))
    return SimResult(
        robot_traj=robot_traj,
        people_traj=people_traj,
        cmds=torch.stack(cmds, dim=1),
        status=torch.stack(status, dim=1),
        min_people_dist=torch.stack(pds, dim=1).amin(dim=1),
        goal_dist=goal_dist,
    )


def make_simulate(cfg: SocialMPCConfig, n_ticks: int, control_period: float = 0.05,
                  device="cuda", dtype=torch.float32):
    """sim(scenario) -> SimResult: `simulate` for a batched scenario, or
    for one unbatched scenario run as a batch of one (the result then
    unbatched too)."""

    def sim(scenario: Scenario) -> SimResult:
        if np.ndim(scenario.robot.pose) == 1:
            res = simulate(cfg, scenario_from_numpy(scenario, device=device, dtype=dtype),
                           n_ticks, control_period, device, dtype)
            return first_lane(res)
        return simulate(cfg, scenario, n_ticks, control_period, device, dtype)

    return sim
