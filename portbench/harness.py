"""What every cell shares: BENCHMARK.json and the files it names, the
card, the guard against JAX, the window's statistics and the result line.

Everything that belongs to one configuration, traffic mix, entry point or
metric lives in a file of its own that this module finds by name:
portbench/configs/<config>.json, portbench/traffic/<traffic>.json (whose
"driver" names portbench/drivers/<driver>.py), portbench/metrics/<metric>.py,
portbench/work/<kernel>.py and portbench/limits/<cell>.json.
"""

import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "nav2_social_mpc_controller_tpu_torch"
# Top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package the port was written from. Compared whole:
# the port's name begins with the JAX package's.
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "nav2_social_mpc_controller_tpu")
# Keys of a configuration file that are not SocialMPCConfig fields.
CONFIG_META = ("source", "deployment", "reduced", "assumed", "dtype", "people_per_scenario")


def read_json(*parts):
    path = os.path.join(*parts)
    with open(path) as f:
        return json.load(f)


def benchmark():
    return read_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload named {name!r} in BENCHMARK.json")


def config_doc(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(ROOT, c["file"])
    raise SystemExit(f"portbench: no config named {name!r} in BENCHMARK.json")


def port_config(doc: dict):
    """The port's SocialMPCConfig from a configuration file, through the
    port's config_from_dict (never one of its preset functions)."""
    from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict

    return config_from_dict({k: v for k, v in doc.items() if k not in CONFIG_META})


def traffic(name: str) -> dict:
    return read_json(HERE, "traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    path = os.path.join(HERE, "limits", f"{cell_name}.json")
    return read_json(path) if os.path.exists(path) else {}


def driver_module(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_by_path(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, and those without a list whose moved
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_TOP_LEVEL})


def require_card(chips: int):
    """Exit with code 2 and no result unless this process sees `chips`
    CUDA devices; never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} visible")


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit_w():
    """The card's power limit as nvidia-smi reads it (None where it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between order statistics
    (numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def p95_ms(r):
    """The 95th percentile, in ms, over every tick of the measured window
    (None without one)."""
    w = getattr(r, "window", None)
    return percentile(w.tick_seconds, 95) * 1e3 if w and w.tick_seconds else None


def metric(value, unit):
    return {"value": value, "unit": unit}


def finite(x) -> bool:
    return x is not None and math.isfinite(x)


# ------------------------------------------------------------ inputs and ticks


def scenario_of(arrays: dict, lane=None):
    """The port's Scenario of generated arrays (portbench/gen/native.py):
    the whole batch, or with `lane` one unbatched scenario, NumPy leaves."""
    from nav2_social_mpc_controller_tpu_torch.core.types import (
        AgentsState, Costmap, ObstacleDistanceGrid, PathInput, RobotState, Scenario)

    a = arrays if lane is None else {k: v[lane] for k, v in arrays.items()}
    return Scenario(
        path=PathInput(points=a["path_points"], yaw=a["path_yaw"], n=a["path_n"]),
        robot=RobotState(pose=a["robot_pose"], speed=a["robot_speed"]),
        people=AgentsState(state=a["people"]),
        costmap=Costmap(data=a["costmap"], origin=a["origin"], resolution=a["resolution"]),
        esdf=ObstacleDistanceGrid(distances=a["esdf_dist"], indexes=a["esdf_idx"],
                                  origin=a["origin"], resolution=a["resolution"],
                                  valid=a["esdf_valid"]),
    )


def plan_poses(arrays: dict, ticks: int, stride: int):
    """[(B, 3) float32] for k < ticks: each robot at its plan point
    stride * k (the last point where the plan is shorter), heading along
    the plan there."""
    import numpy as np

    b = arrays["path_n"].shape[0]
    out = []
    for k in range(ticks):
        i = np.minimum(stride * k, arrays["path_n"].astype(np.int64) - 1)
        rows = np.arange(b)
        pts = arrays["path_points"][rows, i]
        out.append(np.concatenate([pts, arrays["path_yaw"][rows, i][:, None]], axis=1)
                   .astype(np.float32))
    return out


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fov_in_view(config_doc: dict, arrays: dict, poses, people=None):
    """(lanes with a person in view, persons in view) for each tick's
    robot poses (B, 3): the reference's FOV and costmap filter
    (social_mpc_controller.cpp:197-215) on the generated people, or on
    people[t] (B, N, 6) where given; vectorised NumPy."""
    import numpy as np

    out = []
    h, w = arrays["costmap"].shape[1:]
    ox, oy = arrays["origin"][:, 0:1], arrays["origin"][:, 1:2]
    res = arrays["resolution"][:, None]
    for t, pose in enumerate(poses):
        st = np.asarray(arrays["people"] if people is None else people[t], np.float64)
        px, py = st[..., 0], st[..., 1]
        in_map = (px >= ox) & (py >= oy) & ((px - ox) / res < w) & ((py - oy) / res < h)
        ang = np.arctan2(py - pose[:, 1:2], px - pose[:, 0:1]) - pose[:, 2:3]
        rel = np.arctan2(np.sin(ang), np.cos(ang))
        keep = (st[..., 3] != -1.0) & in_map & (np.abs(rel) < config_doc["fov_angle"])
        out.append((int(keep.any(axis=1).sum()), int(keep.sum())))
    return out


def replay_tick(prog, extra=()):
    """A function that replays a one-launch tick program's stage graphs as
    its last tick ran them: the head (which rewrites the LM state from the
    tick's static inputs), each LM chunk as often as the device's counter
    says that tick's loops ran it, the tail, then each graph of `extra`.
    Every run of a tick rewrites these buffers before it reads them."""
    graphs = [prog.head.graph]
    for n_runs, chunk in zip(prog.last_runs(), prog.chunks):
        graphs += [chunk.graph] * n_runs
    graphs += [prog.tail.graph, *extra]

    def replay():
        for g in graphs:
            g.replay()
    return replay


def tick_answers(v, w, aux, lanes=None):
    """What one tick returned for `lanes` (None: an unbatched tick), as
    NumPy: the command, status, plan cursor, the solution's commands and
    path, the trajectorizer's path, the projected people and the LM
    solve's initial cost."""
    import numpy as np

    def pick(x):
        x = x if lanes is None else x[lanes]
        return x.detach().cpu().numpy()

    fields = dict(status=aux.status, cursor=aux.plan_start_index, cmds=aux.cmds,
                  path=aux.local_path, ref_path=aux.ref_path, people_proj=aux.people_proj,
                  initial_cost=aux.solve.initial_cost)
    got = {k: pick(x) for k, x in fields.items()}
    v = np.asarray(v if lanes is None else np.asarray(v)[lanes])
    w = np.asarray(w if lanes is None else np.asarray(w)[lanes])
    if lanes is None:
        return [dict(got, cmd=(float(v), float(w)))]
    return [dict({k: x[i] for k, x in got.items()}, cmd=(float(v[i]), float(w[i])))
            for i in range(len(lanes))]


class Window:
    """What a measured window holds: each tick's seconds (host clock, from
    handing the inputs over until the commands are on the host), the solves
    done and failed, and the window's seconds."""

    def __init__(self):
        self.tick_seconds = []
        self.solves = 0
        self.failed = 0
        self.seconds = 0.0
