"""The traced run's readings: a torch.profiler session over a segment of
ticks, and what the per-layer readers take from it.

CUPTI lists the kernels of a conditional (WHILE) node's body once a launch,
not once a run, so the profile's kernels are never summed into busy time:
a tick's (or a campaign's) device time is the span from its first to its
last device activity, and the device's operations by name are composed
from the last tick replayed stage graph by stage graph under the profiler,
its loop bodies as often as the device counted them (as chip_smoke.py's
one_launch_profile composes a tick), times the segment's ticks. The profiler
now and then loses a session's first records late in a long run: every
session runs behind PAD_KERNELS empty spin kernels, whose records are the
ones lost, and a session that kept none of them is taken again; a replayed
stage is profiled until its largest profile has come twice (chip_smoke.py's
count_kernels_and_copies).
"""

import json
import os
import tempfile

PAD_KERNELS = 128
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def is_copy(name: str) -> bool:
    """A device copy: a memcpy or memset, or ATen's copy kernel."""
    n = name.lower()
    return n.startswith(("memcpy", "memset")) or "direct_copy_kernel" in name


class Session:
    """with Session() as s: ... under torch.profiler; ``s.span(name)``
    marks a host span. After the block: ``device`` (start, end, name)
    of every device activity in µs, sorted, the pad kernels left out;
    ``spans`` {name: [(start, end)]} of the host spans; ``pads`` the pad
    kernels seen."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(0)
        return self

    def span(self, name: str):
        import torch

        return torch.profiler.record_function(name)

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.device, self.spans, self.pads = [], {}, 0
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
            if cat in DEVICE_CATS:
                if "spin_kernel" in ev["name"]:
                    self.pads += 1
                else:
                    self.device.append((start, end, ev["name"]))
            elif cat == "user_annotation":
                self.spans.setdefault(ev["name"], []).append((start, end))
        self.device.sort()
        for v in self.spans.values():
            v.sort()


def traced(run_segment, span_name: str, tries: int = 3):
    """Run run_segment(session) under a Session until the profile kept some
    pad records and every `span_name` span holds a device activity; returns
    the session (fails after `tries`)."""
    for _ in range(tries):
        with Session() as s:
            run_segment(s)
        spans = s.spans.get(span_name, [])
        if s.pads and spans and all(activities(s, a, b) for a, b in spans):
            return s
    raise SystemExit(f"portbench: torch.profiler lost the records of {span_name} spans "
                     f"in {tries} tries")


def activities(s: Session, start: float, end: float):
    """The device activities that start inside [start, end)."""
    return [d for d in s.device if start <= d[0] < end]


def busy_spans(s: Session, span_name: str):
    """(host span, device span) of every `span_name` span: the device span
    from its first device activity's start to its last one's end."""
    out = []
    for a, b in s.spans.get(span_name, []):
        acts = activities(s, a, b)
        out.append(((a, b), (acts[0][0], max(d[1] for d in acts))))
    return out


def window_and_busy(s: Session, span_name: str):
    """(window_s, busy_s): the segment from the first span's start to the
    last one's end, and the sum of the spans' device spans."""
    pairs = busy_spans(s, span_name)
    window = (pairs[-1][0][1] - pairs[0][0][0]) * 1e-6
    busy = sum(d[1] - d[0] for _, d in pairs) * 1e-6
    return window, busy


def idle_pct(r):
    """The share of the traced window, in %, in which none of the segment's
    spans had device work: the window less, for each span, the time from
    its first to its last device activity (the profile's kernels are not
    summed: CUPTI lists a WHILE body's kernels once a launch)."""
    window, busy = window_and_busy(r.session, r.span)
    return 100.0 * (1.0 - busy / window) if window > 0 else None


def idle_gaps(s: Session, span_name: str, labels, top: int = 10):
    """The device's idle time in the segment outside every span's device
    span, shared out by what the host was doing: each gap's overlap with
    the host spans of `labels` (disjoint), the rest "between spans":
    [[label, seconds], ...], largest first."""
    pairs = busy_spans(s, span_name)
    gaps = []
    for k, ((a, b), (d0, d1)) in enumerate(pairs):
        gaps += [(a, d0), (d1, b)]
        if k + 1 < len(pairs):
            gaps.append((b, pairs[k + 1][0][0]))
    totals = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        left = g1 - g0
        for name in labels:
            over = sum(max(0.0, min(g1, y) - max(g0, x)) for x, y in s.spans.get(name, []))
            if over > 0:
                totals[name] = totals.get(name, 0.0) + over * 1e-6
                left -= over
        if left > 0:
            totals["between spans"] = totals.get("between spans", 0.0) + left * 1e-6
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]


def head_seconds(s: Session, span_name: str, loop_kernel: str = "lm_continue"):
    """Per span: the summed device time of the kernels of the tick's graph
    before its first `loop_kernel` (the head: it lies outside every
    conditional body, so CUPTI lists it every launch), the input copies
    ahead of the graph left out. None for a span without the loop kernel."""
    out = []
    for a, b in s.spans.get(span_name, []):
        acts = activities(s, a, b)
        k = 0
        while k < len(acts) and is_copy(acts[k][2]):
            k += 1
        total, found = 0.0, False
        for d in acts[k:]:
            if loop_kernel in d[2]:
                found = True
                break
            if not is_copy(d[2]):
                total += d[1] - d[0]
        out.append(total * 1e-6 if found else None)
    return out


# ------------------------------------------------------------ composed profile


def _profile_once(fn):
    """{device activity name: [count, device s]} of one call of fn() behind
    the pad kernels."""
    with Session() as s:
        fn()
    by_name = {}
    for d0, d1, name in s.device:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (d1 - d0) * 1e-6
    return by_name


def profile_replay(fn, tries: int = 3, most: int = 8):
    """{name: [count, s]} of one call of fn(), which launches the same work
    each call: profiled at least `tries` times and until the profile with
    the most records has come twice (records are lost, never added), at
    most `most` times; fails if none came twice."""
    seen = []
    best = None
    for k in range(most):
        by_name = _profile_once(fn)
        counts = {n: c for n, (c, _) in by_name.items()}
        seen.append((counts, by_name))
        twice = [p for i, p in enumerate(seen) if p[0] and any(p[0] == q[0] for q in seen[:i])]
        size = max(sum(p[0].values()) for p in seen)
        if twice:
            best = max(twice, key=lambda p: sum(p[0].values()))
            if k + 1 >= tries and sum(best[0].values()) == size:
                break
    if best is None:
        raise SystemExit("portbench: torch.profiler gave no profile of a stage replay twice")
    return best[1]


def compose(replay, times: int):
    """The device's operations by name over a segment of `times` ticks:
    one tick replayed stage by stage under the profiler (replay(), see
    harness.replay_tick) times `times`. Returns {name: seconds}."""
    return {name: sec * times for name, (_, sec) in profile_replay(replay).items()}


def top_ops(by_name: dict, top: int = 10):
    return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
