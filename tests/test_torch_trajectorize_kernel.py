"""The trajectorizer's kernel (csrc/trajectorize.cu) and its plain version.

On the CPU the wrapper ``trajectorize`` is ``trajectorize_plain`` bit for
bit, and the plain version matches the JAX package's trajectorize (its
jitted lax.scan, vmapped) in float64 within 1e-12 on plans that reach every
branch of the loop: no waypoint and one (not ok), a full plan of
max_path_points, every waypoint beyond the lookahead, tied minimisers,
rotate-in-place with |dtheta| just above and just below pi/2 to either
side, a goal reached after one step and one never reached; for the
unicycle configs (lookahead 2.0, 30 and 40 steps), the reference's default
trajectorizer (lookahead 0.4, 60 steps) and the omnidirectional config. The
test marked ``gpu`` holds the kernel against the plain version on the card
on the same cases at B = 4101:

    python -m pytest tests/test_torch_trajectorize_kernel.py -q --noconftest -p no:cacheprovider -m gpu
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller import trajectorizer as ttraj
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import PathInput
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import (
    TRAJECTORIZER_CASES,
    make_trajectorizer_cases,
)

torch.set_num_threads(1)
ATOL = 1e-12

CONFIGS = {
    "social": lambda: C.benchmark_social_config().trajectorizer,
    "stress36": lambda: C.benchmark_stress_h36_config().trajectorizer,
    "omni6": lambda: C.benchmark_omni_6agents_config().trajectorizer,
    "default": C.TrajectorizerConfig,
}


def _cases(name, batch, np_dtype, device="cpu", seed=0):
    """(config, PathInput, robot poses, case index per lane) on `device`."""
    tr = CONFIGS[name]()
    path, pose, case = make_trajectorizer_cases(tr, batch, C.SocialMPCConfig().max_path_points,
                                                seed, dtype=np_dtype)
    tpath = PathInput(*(torch.as_tensor(x, device=device) for x in path))
    return tr, path, pose, case, tpath, torch.as_tensor(pose, device=device)


@functools.lru_cache(maxsize=None)
def _jax_trajectorize(tr):
    """The JAX package's trajectorize, vmapped and jitted (imported here:
    the gpu tests run where JAX need not be installed)."""
    import jax

    from nav2_social_mpc_controller_tpu.controller import trajectorizer as jtraj
    from nav2_social_mpc_controller_tpu.core import config as jconfig

    jtr = jconfig.TrajectorizerConfig(**dataclasses.asdict(tr))
    return jax.jit(jax.vmap(lambda p, r: jtraj.trajectorize(jtr, p, r)))


def _assert_same_bits(got, want):
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_wrapper_is_the_plain_version_on_the_cpu(name, dtype):
    """CPU tensors take the plain version: the same bits, no kernel
    launched."""
    tr, _, _, _, path, pose = _cases(name, 16, dtype)
    before = dict(_build.launch_counts)
    _assert_same_bits(ttraj.trajectorize(tr, path, pose), ttraj.trajectorize_plain(tr, path, pose))
    assert _build.launch_counts == before


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_version_matches_jax_f64(name):
    """Every case of TRAJECTORIZER_CASES against the JAX package's jitted
    scan in float64, and each case's defining outcome."""
    import jax.numpy as jnp

    from nav2_social_mpc_controller_tpu.core.types import PathInput as JPathInput

    tr, path, pose, case, tpath, tpose = _cases(name, 2 * len(TRAJECTORIZER_CASES), np.float64)
    ref = _jax_trajectorize(tr)(JPathInput(*(jnp.asarray(x) for x in path)), jnp.asarray(pose))
    got = ttraj.trajectorize_plain(tr, tpath, tpose)
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(ref.n_steps))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.cmds.numpy(), np.asarray(ref.cmds), atol=ATOL, rtol=0)
    assert got.poses.shape == (len(case), tr.max_steps + 1, 3)

    names = np.array(TRAJECTORIZER_CASES)[case]
    steps, ok, first = got.n_steps.numpy(), got.ok.numpy(), got.cmds[:, 0].numpy()
    none = np.isin(names, ("no_points", "one_point"))
    assert not ok[none].any() and (steps[none] == 0).all() and (first[none] == 0.0).all()
    assert ok[~none].all()
    assert (steps[names == "goal_at_step_1"] == 1).all()
    assert (steps[names == "goal_never_reached"] == tr.max_steps).all()
    np.testing.assert_array_equal(got.poses[:, 0].numpy(), pose)
    if not tr.omnidirectional:
        rotate_above = np.char.endswith(names, "_above")
        rotate_below = np.char.endswith(names, "_below")
        assert (first[rotate_above, 0] == 0.0).all()  # rotate in place
        assert (np.abs(first[rotate_above, 2]) == np.float64(tr.max_angular_vel)).all()
        assert (first[rotate_below, 0] == np.float64(tr.desired_linear_vel)).all()
        left = np.char.find(names, "_left_") >= 0
        assert (first[left & rotate_above, 2] > 0).all()
        assert (first[~left & rotate_above, 2] < 0).all()
    else:
        assert (first[~none, 2] == 0.0).all() and (np.abs(first[~none, 1]) > 0).any()


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trajectorizer's CUDA kernel has no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_equals_plain_version_on_the_card(card, name):
    """B = 4101 (a ragged last block) of every case: the kernel's outputs
    equal the plain version's on the card bit for bit, in one launch; a
    float64 tensor on the card is refused."""
    tr, _, _, _, path, pose = _cases(name, 4101, np.float32, device=card, seed=1)
    before = _build.launch_counts["trajectorize"]
    got = ttraj.trajectorize(tr, path, pose)
    assert _build.launch_counts["trajectorize"] == before + 1
    _assert_same_bits(got, ttraj.trajectorize_plain(tr, path, pose))
    one = ttraj.trajectorize(tr, PathInput(*(x[5:6] for x in path)), pose[5:6])
    for a, b in zip(one, got):
        assert torch.equal(a[0], b[5])  # a lane alone computes what it does in the batch
    with pytest.raises(ValueError):
        ttraj.trajectorize(tr, PathInput(*(x.double() if x.is_floating_point() else x
                                           for x in path)), pose.double())


def _plan_windows(card, batch):
    """The plan windows a first tick hands the trajectorizer (plan cursor
    0), for `batch` generated social scenarios, and the robot poses."""
    from nav2_social_mpc_controller_tpu_torch.controller.path_handler import transform_global_plan
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    cfg = C.benchmark_social_config()
    sc = scenario_from_numpy(make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=3),
                             device=card)
    pose = sc.robot.pose.contiguous()
    h, w = sc.costmap.data.shape[-2:]
    thr = torch.maximum(w * sc.costmap.resolution, h * sc.costmap.resolution) / 2.0
    win = transform_global_plan(sc.path, pose, cfg.max_robot_pose_search_dist, thr).path
    return cfg.trajectorizer, PathInput(*(x.contiguous() for x in win)), pose


@pytest.mark.gpu
@pytest.mark.parametrize("p", [33, 128])
@pytest.mark.parametrize("b", [1, 3, 4101])
def test_kernel_at_every_lane_count(card, b, p, monkeypatch):
    """At the edges of the lanes a scenario (B = 1, 3, 4101; P = 33 and 128
    waypoints, 1 to 16 a lane in registers): every case of
    TRAJECTORIZER_CASES bit for bit against the plain version at the lanes
    kernel_shapes.trajectorize_lanes gives and at 16 and 32."""
    from nav2_social_mpc_controller_tpu_torch import kernel_shapes

    tr = CONFIGS["social"]()
    path, pose, _ = make_trajectorizer_cases(tr, b, p, seed=b + p)
    path = PathInput(*(torch.as_tensor(x, device=card) for x in path))
    pose = torch.as_tensor(pose, device=card)
    want = ttraj.trajectorize_plain(tr, path, pose)
    _assert_same_bits(ttraj.trajectorize(tr, path, pose), want)
    for lanes in kernel_shapes.TRAJECTORIZE_LANES:
        monkeypatch.setattr(kernel_shapes, "trajectorize_lanes", lambda _b, n=lanes: n)
        _assert_same_bits(ttraj.trajectorize(tr, path, pose), want)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 1024])
def test_kernel_on_plan_windows(card, b):
    """The plan windows of a first social tick, bit for bit."""
    tr, path, pose = _plan_windows(card, b)
    _assert_same_bits(ttraj.trajectorize(tr, path, pose), ttraj.trajectorize_plain(tr, path, pose))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [200, 2000])
def test_kernel_past_128_waypoints(card, p):
    """Past 128 waypoints a plan is searched from shared memory where a
    block's plans fit 48 KB (P = 200) and from device memory past that
    (P = 2000): bit for bit, every case, B = 301."""
    tr = CONFIGS["default"]()
    path, pose, _ = make_trajectorizer_cases(tr, 301, p, seed=p)
    path = PathInput(*(torch.as_tensor(x, device=card) for x in path))
    pose = torch.as_tensor(pose, device=card)
    _assert_same_bits(ttraj.trajectorize(tr, path, pose), ttraj.trajectorize_plain(tr, path, pose))


@pytest.mark.gpu
def test_kernel_captured_equals_eager(card):
    """The trajectorizer captured in a CUDA graph and replayed gives the
    eager launch's bits (every case, B = 4101)."""
    tr, _, _, _, path, pose = _cases("social", 4101, np.float32, device=card, seed=2)
    eager = ttraj.trajectorize(tr, path, pose)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ttraj.trajectorize(tr, path, pose)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ttraj.trajectorize(tr, path, pose)
    graph.replay()
    torch.cuda.synchronize()
    _assert_same_bits(captured, eager)
