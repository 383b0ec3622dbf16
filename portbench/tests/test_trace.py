"""The traced run's arithmetic on a made-up profile: busy spans from each
tick's first to last device activity (never the kernels summed), the idle
gaps by host span, the head before the first lm_continue, and the composed
operations."""

import pytest

from portbench import harness, trace


def session():
    s = trace.Session.__new__(trace.Session)
    # two ticks of 100 us; a body kernel listed once inside each
    s.spans = {"tick": [(0.0, 100.0), (120.0, 220.0)], "step": [(0.0, 30.0), (120.0, 150.0)],
               "commands to host": [(90.0, 100.0), (210.0, 220.0)]}
    s.device = sorted([
        (10.0, 12.0, "Memcpy DtoD (Device -> Device)"),
        (20.0, 25.0, "trajectorize_kernel"), (25.0, 30.0, "void fused_kernel<3>(x)"),
        (31.0, 32.0, "lm_continue_kernel"), (40.0, 44.0, "void fused_kernel<3>(x)"),
        (80.0, 85.0, "tail"),
        (135.0, 140.0, "trajectorize_kernel"), (141.0, 142.0, "lm_continue_kernel"),
        (190.0, 195.0, "tail"),
    ])
    s.pads = 128
    return s


def test_window_and_busy():
    window, busy = trace.window_and_busy(session(), "tick")
    assert window == pytest.approx(220e-6)
    assert busy == pytest.approx((85 - 10 + 195 - 135) * 1e-6)


def test_idle_gaps_by_host_span():
    gaps = dict(trace.idle_gaps(session(), "tick", ("step", "commands to host")))
    # 0-10 and 120-135 under step; 90-100 and 210-220 under commands to
    # host; 85-90, 195-210 and 100-120 under neither
    assert gaps["step"] == pytest.approx(25e-6)
    assert gaps["commands to host"] == pytest.approx(20e-6)
    assert gaps["between spans"] == pytest.approx(40e-6)
    window, busy = trace.window_and_busy(session(), "tick")
    assert sum(gaps.values()) == pytest.approx(window - busy)


def test_head_seconds():
    assert trace.head_seconds(session(), "tick") == pytest.approx([10e-6, 5e-6])


def test_readers_on_the_profile():
    r = harness.load_by_path("metrics", "device_idle_pct")
    s = session()
    from types import SimpleNamespace

    rd = SimpleNamespace(session=s, span="tick")
    window, busy = trace.window_and_busy(s, "tick")
    assert r.read(rd) == pytest.approx(100 * (1 - busy / window))
    head = harness.load_by_path("metrics", "head_ms_per_tick").read(rd)
    assert head == pytest.approx(7.5e-3)


def test_fused_iter_roofline_reader():
    from types import SimpleNamespace

    work = harness.load_by_path("work", "fused_iter")
    shape = dict(batch=4096, steps=29, nb=3, slots=3)
    rd = SimpleNamespace(session=session(), span="tick", fused_iter_calls=10,
                         in_view=[(100, 150), (120, 160)], fused_iter_shape=shape)
    least = (work.least_seconds(in_view_lanes=100, valid_people=150, **shape)[0]
             + work.least_seconds(in_view_lanes=120, valid_people=160, **shape)[0]) / 2
    got = harness.load_by_path("metrics", "fused_iter_roofline_pct").read(rd)
    assert got == pytest.approx(100 * least / 4.5e-6)
    rd.fused_iter_calls = 0
    assert harness.load_by_path("metrics", "fused_iter_roofline_pct").read(rd) is None


def test_compose_times_the_replays(monkeypatch):
    monkeypatch.setattr(trace, "profile_replay", lambda fn: {"k": [2, 1e-3], "m": [1, 2e-3]})
    assert trace.compose(None, 10) == {"k": pytest.approx(1e-2), "m": pytest.approx(2e-2)}
    assert trace.top_ops({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]
