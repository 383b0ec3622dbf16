"""Angle utilities (reference: angles/angles.h usage + wrapToPi in
social_work_cost_function.hpp:39-46). Elementwise on tensors."""

import math

import torch


def wrap_to_pi(angle):
    """Wrap angle(s) to (-pi, pi], matching the reference loop ``while (a <=
    -pi) a += 2pi; while (a > pi) a -= 2pi`` (sfm.hpp:252-260) for finite
    inputs."""
    # remainder (sign of the divisor) maps to [0, 2pi); shift to (-pi, pi]
    a = torch.remainder(-angle + math.pi, 2.0 * math.pi)
    return -(a - math.pi)


def wrap_atan2(angle):
    """atan2(sin(a), cos(a)) wrap — the critics' wrapAngle helper
    (agent_angle_cost_function.hpp:154). Output in [-pi, pi]."""
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def shortest_angular_distance(a_from, a_to):
    """Shortest signed angular distance from a_from to a_to
    (angles::shortest_angular_distance, used by the FOV filter)."""
    return wrap_to_pi(a_to - a_from)
