"""How `correct` is decided: the program's answers on lanes sampled from
the seed against the plain reference (portbench/reference/), run after the
window in worker processes, and each number compared against its limit
(portbench/limits/<cell>.json).

A controller tick's answer is compared field by field: the status, the
plan cursor and the people in view exactly; the trajectorizer's reference
path, the projected people and the initial cost (the evaluation at the
warm start, relative) by the widest gap; the command, the solution (every
step's command: the carry's prev_cmds), the re-rolled path (its
prev_path) and the initial cost by the median gap over the answers (the
initial cost's widest gap is kept as a diagnostic: from the second tick on
it is the cost at each side's own warm start), since from an episode's
second tick on each side warm-starts from its own last solution and a lane
that the 40-iteration cap stopped carries where rounding left it into the
next tick (PERF.md). An episode's first tick, where both sides start from
an empty carry, is judged apart, answer by answer: its command, solution,
path, projected people and initial cost by the widest gap (first_*), its
solution by the median gap too (first_solution_gap_median), and
its whole answer (the command as the first block, the solution's later
blocks) by the reference's cost there: first_cost_excess is the widest
share by which that cost lies above the reference's own solve's. It judges
the LM solve where two sound solutions part along a flat or symmetric
valley, as on a straight plan with no person (PERF.md). Answer by answer
also: first_cmd_off_share is the share of turning first ticks whose
command is more than 1e-3 off, so that a fault on a part of the lanes
shows where a widest gap swings by nature.
A closed-loop campaign's world update is compared by the widest gap of the
robot's next pose, the people's next state and the closest approach, and
its first controller tick's command by the widest gap.
"""

import math
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench.reference import jobs as reference_jobs


def run_reference(jobs: list, workers: int = 0) -> list:
    """reference_jobs.run(job) for every job, in spawned worker processes
    (NumPy and the reference only), in order."""
    fn = reference_jobs.run
    if not jobs:
        return []
    workers = workers or max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    if workers == 1:
        return [fn(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(fn, jobs))


def _gap(a, b) -> float:
    """The widest absolute gap of two arrays of one shape; inf where
    either holds a non-finite number the other does not."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    with np.errstate(invalid="ignore"):
        d = np.where((a == b) | (np.isnan(a) & np.isnan(b)), 0.0, np.abs(a - b))
    return float(np.nan_to_num(d, nan=math.inf).max()) if d.size else 0.0


def _excess(cost: float, best: float) -> float:
    """How far, as a share of `best`, `cost` lies above it (0 below it);
    inf where either is not finite."""
    if not (math.isfinite(cost) and math.isfinite(best)):
        return math.inf
    return max(0.0, (cost - best) / max(best, 1e-30))


class Numbers:
    """The compared numbers of one run. Each gap is collected per answer;
    a number is the widest of them (WIDEST), their median (MEDIAN), or the
    share of them above a gap of its own (SHARE: name -> (gap, above)),
    and the counts are exact."""

    WIDEST = ()
    MEDIAN = ()
    SHARE = {}
    COUNTS = ()

    def __init__(self):
        self.gaps = {k: [] for k in self.WIDEST + self.MEDIAN + ("first_turning_cmd_gap",)}
        self.counts = {k: 0 for k in self.COUNTS}
        self.answers = 0

    def gap(self, name, a, b):
        self.gaps[name].append(_gap(a, b))

    def values(self) -> dict:
        out = {k: (max(self.gaps[k]) if self.gaps[k] else 0.0) for k in self.WIDEST}
        out.update({f"{k}_median": (float(np.median(self.gaps[k])) if self.gaps[k] else 0.0)
                    for k in self.MEDIAN})
        out.update({k: (float(np.mean(np.asarray(self.gaps[g]) > above)) if self.gaps[g] else 0.0)
                    for k, (g, above) in self.SHARE.items()})
        out.update(self.counts)
        return out

    def spread(self) -> dict:
        """Diagnostics: each gap's median, 90th percentile and widest."""
        return {k: [float(np.median(v)), float(np.percentile(v, 90)), max(v)]
                for k, v in self.gaps.items() if v}


class TickNumbers(Numbers):
    # The fields an episode's first tick is judged on apart: there both
    # sides start from an empty carry, so nothing the warm start carried
    # over from an earlier tick's solve stands between them.
    FIRST = ("cmd_gap", "solution_gap", "path_gap", "people_gap", "initial_cost_gap")
    WIDEST = ("ref_path_gap", "people_gap", "initial_cost_gap", "first_cost_excess") + \
        tuple(f"first_{k}" for k in FIRST)
    # The first ticks' solution also by its median: its widest gap comes
    # from lanes the cap stops and swings as wide as the control's (PERF.md).
    MEDIAN = ("cmd_gap", "solution_gap", "path_gap", "initial_cost_gap", "first_solution_gap")
    # Of the first ticks whose reference command turns (|w| >= 0.05), the
    # share whose command is more than 1e-3 off the reference's: float32
    # rounding leaves most within 1e-6, a bfloat16 command is at least that
    # far off wherever v sits at 0.6, and where the plan runs straight the
    # float64 solve can stop on the symmetric saddle w = 0 that float32
    # rounding leaves (PERF.md).
    SHARE = {"first_cmd_off_share": ("first_turning_cmd_gap", 1e-3)}
    TURNING = 0.05
    COUNTS = ("status_mismatches", "cursor_mismatches", "people_count_mismatches")

    def add(self, prog: dict, ref: dict, first: bool = False, alone: bool = False):
        """One tick's answer: prog holds what the program returned (NumPy,
        unbatched), ref a reference_tick dict; `first`: the tick starts an
        episode (both sides from an empty carry); `alone`: a first tick
        sampled without its episode, which counts only in the counts and
        the first-tick numbers."""
        self.answers += 1
        if int(prog["status"]) != ref["status"]:
            self.counts["status_mismatches"] += 1
            return
        if int(prog["cursor"]) != ref["cursor"]:
            self.counts["cursor_mismatches"] += 1
        got = {"cmd_gap": _gap(prog["cmd"], ref["cmd"])}
        if ref["ref_path"] is not None:
            n = len(ref["ref_path"])
            got["ref_path_gap"] = _gap(prog["ref_path"][:n], ref["ref_path"])
        if ref["status"] == 0:
            n = len(ref["cmds"])
            got["solution_gap"] = _gap(prog["cmds"][:n], ref["cmds"])
            got["path_gap"] = _gap(prog["path"][:n], ref["path"])
            c = ref["initial_cost"]
            got["initial_cost_gap"] = _gap(float(prog["initial_cost"]) / max(c, 1e-30), 1.0)
            people = self._people(prog["people_proj"], ref["people_proj"])
            if people is not None:
                got["people_gap"] = people
        if first and "cost_at_answer" in ref:
            got["cost_excess"] = _excess(ref["cost_at_answer"], ref["final_cost"])
        if first and abs(ref["cmd"][1]) >= self.TURNING:
            self.gaps["first_turning_cmd_gap"].append(got["cmd_gap"])
        for k, v in got.items():
            if k == "cost_excess":
                self.gaps["first_cost_excess"].append(v)
                continue
            if not alone:
                self.gaps[k].append(v)
            if first and k in self.FIRST:
                self.gaps[f"first_{k}"].append(v)

    def _people(self, prog, ref):
        """Projected people step by step: the program keeps a person in its
        slot (t = -1 marks the others), the reference packs the valid ones
        first; compared in order on x, y and speed. None where the counts
        differ (counted as a mismatch)."""
        worst = 0.0
        for s in range(min(len(ref), len(prog))):
            mine = prog[s][prog[s][:, 3] != -1.0]
            theirs = ref[s][ref[s][:, 3] != -1.0]
            if len(mine) != len(theirs):
                self.counts["people_count_mismatches"] += 1
                return None
            if len(mine):
                worst = max(worst, _gap(mine[:, [0, 1, 4]], theirs[:, [0, 1, 4]]))
        return worst


class CampaignNumbers(Numbers):
    WIDEST = ("world_pose_gap", "world_people_gap", "min_people_dist_gap", "first_cmd_gap")
    MEDIAN = ("cmd_gap",)
    SHARE = TickNumbers.SHARE
    COUNTS = ("status_mismatches",)

    def add_tick(self, prog: dict, ref: dict, first: bool = False, alone: bool = False):
        """One controller tick's command and status; `first`: the
        campaign's first tick (both sides from an empty carry); `alone`:
        a first tick sampled without the ticks after it, which counts only
        in the status and the first-tick number."""
        self.answers += 1
        if int(prog["status"]) != ref["status"]:
            self.counts["status_mismatches"] += 1
            return
        if not alone:
            self.gap("cmd_gap", prog["cmd"], ref["cmd"])
        if first:
            self.gap("first_cmd_gap", prog["cmd"], ref["cmd"])
            if abs(ref["cmd"][1]) >= TickNumbers.TURNING:
                self.gap("first_turning_cmd_gap", prog["cmd"], ref["cmd"])

    def add_world(self, robot_traj, people_traj, ref_steps, min_people_dist):
        """One lane's campaign: ref_steps[t] = (pose', people', closest) from
        the program's state at t, and the closest approach over the
        campaign."""
        people_gap = 0.0
        closest = math.inf
        for t, (pose, people, pd) in enumerate(ref_steps):
            self.gap("world_pose_gap", robot_traj[t + 1], pose)
            valid = np.asarray(people)[:, 3] != -1.0
            if valid.any():
                people_gap = max(people_gap, _gap(people_traj[t + 1][valid][:, [0, 1, 4]],
                                                  np.asarray(people)[valid][:, [0, 1, 4]]))
            closest = min(closest, pd)
        self.gaps["world_people_gap"].append(people_gap)
        self.gap("min_people_dist_gap", min_people_dist, closest)


def judged(answer: dict) -> dict:
    """What the reference takes of an episode's first answer to cost it:
    the command and the solution (None where it has no solution)."""
    if answer.get("cmds") is None:
        return None
    return dict(cmd=tuple(float(x) for x in answer["cmd"]),
                cmds=np.asarray(answer["cmds"], np.float64))


def judge(values: dict, limits: dict):
    """(correct, checks): every number the cell's limits name within its
    limit; checks[name] = {"value", "limit"}. A number that is missing, or
    not finite, or has no limit, is not within it. An empty `limits` is
    never correct."""
    checks = {}
    ok = bool(limits)
    for name, limit in limits.items():
        value = values.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def report(checks: dict, spread: dict):
    """The compared numbers beside their limits, as the last lines of
    standard error."""
    for name, row in spread.items():
        print(f"portbench: spread {name} median {row[0]} p90 {row[1]}", file=sys.stderr)
    for name, c in checks.items():
        print(f"portbench: check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()


def sample_lanes(rng, batch: int, k: int):
    return np.sort(rng.choice(batch, size=min(k, batch), replace=False))
