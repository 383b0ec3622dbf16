"""The benchmark's scenario generator: portbench/gen/scenario_gen.cpp,
built with g++ into portbench/.cache/ at first use and opened with ctypes.

``generate(params, batch, seed, people)`` fills one batch of scenarios as
NumPy arrays, lane i from the splitmix seed ``seed * 2**32 + i``, so lanes
are distinct within a seed and across seeds, and the same seed gives the
same batch. The arrays are what both sides read: the harness puts them on
the card for the port, the reference reads them as they are.
"""

import ctypes
import os
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "scenario_gen.cpp")
CACHE_DIR = os.path.join(os.path.dirname(HERE), ".cache")
LIB_PATH = os.path.join(CACHE_DIR, "libportbench_scenario.so")

PATH_KINDS = {"dealt": -1, "sine": 0, "straight": 1, "arc": 2}

_lib = None


def _build():
    """g++ the generator into the cache unless a library newer than the
    source is there; a build goes to a name of its own and is renamed into
    place, so two processes never open a half-written file."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE):
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE, "-lpthread"],
                   check=True, capture_output=True)
    os.replace(tmp, LIB_PATH)


def load():
    global _lib
    if _lib is None:
        _build()
        lib = ctypes.CDLL(LIB_PATH)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.generate_scenarios.argtypes = [
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int32,
            f32p, f32p, i32p, f32p, f32p, f32p, f32p, f32p, i32p,
        ]
        lib.generate_scenarios.restype = None
        _lib = lib
    return _lib


def lane_seed_base(seed: int) -> int:
    """The generator's base seed for a run's --seed: lanes take base + i."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    return (int(seed) << 32) & ((1 << 64) - 1)


def generate(params: dict, batch: int, seed: int, people: int, n_agents: int,
             max_path_points: int, threads: int = 0) -> dict:
    """One batch of scenarios as a dict of NumPy arrays, batch-leading:
    path_points (B, P, 2), path_yaw (B, P), path_n (B,), robot_pose (B, 3),
    robot_speed (B, 2), people (B, N, 6; t = -1 marks no person),
    costmap (B, H, W), esdf_dist (B, H, W), esdf_idx (B, H, W) int32,
    origin (B, 2), resolution (B,), esdf_valid (B,).

    `params` is the traffic's scenario block: grid [H, W], resolution,
    origin [x, y], path_points, path_kind (a key of PATH_KINDS),
    obstacles (bool)."""
    h, w = params["grid"]
    res = float(params["resolution"])
    ox, oy = params["origin"]
    p = int(max_path_points)
    n = int(n_agents)
    out = {
        "path_points": np.empty((batch, p, 2), np.float32),
        "path_yaw": np.empty((batch, p), np.float32),
        "path_n": np.empty((batch,), np.int32),
        "robot_pose": np.empty((batch, 3), np.float32),
        "robot_speed": np.empty((batch, 2), np.float32),
        "people": np.empty((batch, n, 6), np.float32),
        "costmap": np.empty((batch, h, w), np.float32),
        "esdf_dist": np.empty((batch, h, w), np.float32),
        "esdf_idx": np.empty((batch, h, w), np.int32),
    }
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ptr = {k: v.ctypes.data_as(i32p if v.dtype == np.int32 else f32p) for k, v in out.items()}
    load().generate_scenarios(
        lane_seed_base(seed), batch, threads, PATH_KINDS[params["path_kind"]],
        int(params["path_points"]), p, n, min(int(people), n), h, w, res, ox, oy,
        1 if params["obstacles"] else 0,
        ptr["path_points"], ptr["path_yaw"], ptr["path_n"], ptr["robot_pose"],
        ptr["robot_speed"], ptr["people"], ptr["costmap"], ptr["esdf_dist"], ptr["esdf_idx"],
    )
    out["origin"] = np.tile(np.asarray([ox, oy], np.float32), (batch, 1))
    out["resolution"] = np.full((batch,), res, np.float32)
    out["esdf_valid"] = np.ones((batch,), bool)
    return out


def lanes(batch_arrays: dict, idx) -> dict:
    """The arrays of the lanes `idx` (an index array or a slice)."""
    return {k: v[idx] for k, v in batch_arrays.items()}
