"""The shapes the CUDA kernels are instantiated for (kernel_shapes.py): the
dispatch tables of ``csrc/*.cu``, generated into every build as
kernel_shapes.h, against the sets the wrappers check; the limits past which
the wrappers refuse, with messages that name them; and the header in the
include path of every compile. No card and no nvcc: the sources are read as
text and the compiler is a stand-in."""

import ctypes
import os
import re
import subprocess
import sys
import textwrap

import pytest

from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes
from nav2_social_mpc_controller_tpu_torch.models import sfm
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter, rollout_cuda
from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve

# C entry -> (source, the X-macro list its dispatch expands)
DISPATCH = {
    "social_mpc_rollout_sample_f32": ("rollout_sample.cu", "SOCIAL_MPC_BLOCKS"),
    "social_mpc_rollout_prep_f32": ("rollout_prep.cu", "SOCIAL_MPC_BLOCKS"),
    "social_mpc_fused_iter_f32": ("fused_iter.cu", "SOCIAL_MPC_BLOCKS"),
    "social_mpc_propose_f32": ("tr_iter.cu", "SOCIAL_MPC_SOLVE_DIMS"),
    "social_mpc_commit_f32": ("tr_iter.cu", "SOCIAL_MPC_SOLVE_DIMS"),
    "social_mpc_damped_step_f32": ("spd_solve.cu", "SOCIAL_MPC_SOLVE_DIMS"),
    "social_mpc_spd_solve_f32": ("spd_solve.cu", "SOCIAL_MPC_SPD_SOLVE_DIMS"),
    "social_mpc_sfm_scan_f32": ("sfm_scan.cu", "SOCIAL_MPC_SFM_SHAPES"),
}


def _parse_header(text):
    """{macro name: tuples} of a kernel_shapes.h text, read as the C
    preprocessor would expand each list."""
    out = {}
    for m in re.finditer(r"#define (\w+)\(X\) (.*)", text):
        out[m.group(1)] = tuple(
            tuple(int(v) for v in args.split(","))
            for args in re.findall(r"X\(([^)]*)\)", m.group(2)))
    return out


def _entry_body(source, entry):
    """The text of C entry `entry` in csrc/`source`, to the next entry."""
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        text = f.read()
    start = text.index(f'extern "C" int {entry}(')
    end = text.find('extern "C"', start + 1)
    return text[start:] if end < 0 else text[start:end]


def test_the_header_lists_every_wrapper_set():
    """kernel_shapes.h, parsed back, lists exactly what the wrappers accept
    on the card: NB of K2, K6 and rollout_sample; D of K3, K4 and K7's
    damped step; D of K7's standalone solve; (N, sources per lane) of K5 as
    scan_geometry chooses them."""
    lists = _parse_header(kernel_shapes.header())
    assert set(lists) == set(kernel_shapes.LISTS)
    blocks = tuple(nb for (nb,) in lists["SOCIAL_MPC_BLOCKS"])
    assert blocks == rollout_cuda.KERNEL_BLOCKS == fused_iter.KERNEL_BLOCKS == tuple(range(1, 7))
    assert tuple(d for (d,) in lists["SOCIAL_MPC_SOLVE_DIMS"]) == cuda_solve.KERNEL_DIMS \
        == (2, 4, 6, 8, 10, 12)
    assert tuple(d for (d,) in lists["SOCIAL_MPC_SPD_SOLVE_DIMS"]) == cuda_solve.SPD_SOLVE_DIMS \
        == tuple(range(1, 17))
    assert lists["SOCIAL_MPC_SFM_SHAPES"] == tuple(
        (n, sfm.scan_geometry(n, 1).sources_per_lane)
        for n in range(1, kernel_shapes.MAX_TEMPLATED_AGENTS + 1))
    assert kernel_shapes.MAX_TEMPLATED_AGENTS == 32
    assert sfm.KERNEL_MAX_AGENTS == kernel_shapes.GENERAL_MAX_AGENTS == 3567


@pytest.mark.parametrize("entry", sorted(DISPATCH))
def test_every_dispatch_expands_its_list(entry):
    """Each C entry's switch takes its cases from the generated list and
    names no shape of its own."""
    source, macro = DISPATCH[entry]
    body = _entry_body(source, entry)
    assert "switch" in body and f"{macro}(" in body
    assert "kernel_shapes.h" in open(os.path.join(_build.CSRC_DIR, source)).read()
    for other in set(kernel_shapes.LISTS) - {macro}:
        assert f"{other}(" not in body


def test_no_source_lists_a_shape_by_hand():
    """No case label of csrc/ is a literal number: every shape dispatch is
    one of the generated lists."""
    for name in sorted(os.listdir(_build.CSRC_DIR)):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            text = f.read()
        assert not re.search(r"\bcase\s+[0-9][0-9\s*+]*:", text), name


LIMIT_NB = kernel_shapes.GENERAL_MAX_BLOCKS
LIMIT_D = kernel_shapes.GENERAL_MAX_DIM
LIMIT_N = kernel_shapes.GENERAL_MAX_AGENTS


@pytest.mark.parametrize("check,limit,message", [
    (lambda: rollout_cuda.check_blocks("rollout_sample", LIMIT_NB + 1), f"NB from 1 to {LIMIT_NB}",
     "shared memory"),
    (lambda: cuda_solve.check_dims("propose", 2 * LIMIT_NB + 2),
     f"every even D from 2 to {2 * LIMIT_NB}", "shared memory"),
    (lambda: cuda_solve.check_dims("damped_step", 5), f"every even D from 2 to {2 * LIMIT_NB}",
     "D = 2 NB"),
    (lambda: cuda_solve.check_dims("spd_solve", LIMIT_D + 1, cuda_solve.SPD_SOLVE_DIMS),
     f"D from 1 to {LIMIT_D}", "shared memory"),
    (lambda: sfm.scan_geometry(LIMIT_N + 1, 8), f"1 to {LIMIT_N} agents", "shared memory"),
], ids=["NB119", "propose_D238", "damped_step_D5", "spd_solve_D238", "N3568"])
def test_the_wrappers_refuse_past_the_limits_and_say_why(check, limit, message):
    with pytest.raises(ValueError) as err:
        check()
    assert limit in str(err.value) and message in str(err.value)


def test_the_general_limits_are_what_one_block_s_shared_memory_holds():
    """The general solve's factor and vectors fit 227 KB at D = 237 and not
    at 238: NB stops at 118, past the 64 blocks (D = 128) a horizon of 64
    steps in blocks of one needs."""
    assert kernel_shapes.SHARED_BYTES_PER_BLOCK == 227 * 1024 == 232448
    assert kernel_shapes.general_solve_shared_bytes(LIMIT_D) <= 232448
    assert kernel_shapes.general_solve_shared_bytes(LIMIT_D + 1) > 232448
    assert (LIMIT_D, LIMIT_NB) == (237, 118)
    assert LIMIT_NB >= 64 and 2 * LIMIT_NB >= 128
    assert kernel_shapes.fused_general_shared_bytes(kernel_shapes.GENERAL_MAX_STEPS) <= 232448
    assert kernel_shapes.sfm_general_shared_bytes(LIMIT_N) <= 232448
    assert kernel_shapes.sfm_general_shared_bytes(LIMIT_N + 1) > 232448
    lists = kernel_shapes.header()
    for name, value in kernel_shapes.LIMITS.items():
        assert f"#define {name} {value}\n" in lists


@pytest.mark.parametrize("check", [
    lambda: rollout_cuda.check_blocks("rollout_prep", 1),
    lambda: rollout_cuda.check_blocks("rollout_sample", 6),
    lambda: cuda_solve.check_dims("commit", 2),
    lambda: cuda_solve.check_dims("spd_solve", 16, cuda_solve.SPD_SOLVE_DIMS),
    lambda: sfm.scan_geometry(32, 4101),
    lambda: sfm.scan_geometry(33, 4101),
    lambda: sfm.scan_geometry(LIMIT_N, 1),
    lambda: rollout_cuda.check_blocks("rollout_sample", 7),
    lambda: rollout_cuda.check_blocks("fused_cost_g_jtj", 64),
    lambda: rollout_cuda.check_blocks("fused_cost_g_jtj", LIMIT_NB),
    lambda: cuda_solve.check_dims("propose", 14),
    lambda: cuda_solve.check_dims("propose", 128),
    lambda: cuda_solve.check_dims("damped_step", 2 * LIMIT_NB),
    lambda: cuda_solve.check_dims("spd_solve", 17, cuda_solve.SPD_SOLVE_DIMS),
    lambda: cuda_solve.check_dims("spd_solve", LIMIT_D, cuda_solve.SPD_SOLVE_DIMS),
], ids=["NB1", "NB6", "commit_D2", "spd_solve_D16", "N32", "N33", "N3567", "NB7", "NB64", "NB118",
        "propose_D14", "propose_D128", "damped_step_D236", "spd_solve_D17", "spd_solve_D237"])
def test_the_wrappers_take_the_new_shapes(check):
    check()


@pytest.mark.parametrize("kind,n,form", [
    ("blocks", 1, "templated"), ("blocks", 6, "templated"), ("blocks", 7, "general"),
    ("blocks", 18, "general"), ("solve", 12, "templated"), ("solve", 14, "general"),
    ("solve", 36, "general"), ("spd_solve", 16, "templated"), ("spd_solve", 17, "general"),
    ("spd_solve", 33, "general"), ("agents", 1, "templated"), ("agents", 32, "templated"),
    ("agents", 33, "general"), ("agents", 64, "general"), ("agents", LIMIT_N, "general"),
])
def test_the_wrappers_pick_the_templated_form_where_it_is_instantiated(kind, n, form):
    """One function chooses: the templated form for a shape of its list, the
    general form past it; the wrappers count each under its own name."""
    assert kernel_shapes.form("f", kind, n) == form
    name = "sfm_scan" if kind == "agents" else "fused_iter"
    assert _build.counter_name(name, form) == (name if form == "templated" else name + "_general")
    assert _build.counter_name(name, form) in _build.launch_counts


def test_form_reads_the_lists_at_each_call(monkeypatch):
    """A cross-check of the two forms takes the general forms at a templated
    shape by emptying the lists for a while: form reads them at each call."""
    for name in ("BLOCKS", "SOLVE_DIMS", "SPD_SOLVE_DIMS", "SFM_SHAPES"):
        monkeypatch.setattr(kernel_shapes, name, ())
    assert rollout_cuda.check_blocks("rollout_sample", 3) == kernel_shapes.GENERAL
    assert cuda_solve.check_dims("propose", 6) == kernel_shapes.GENERAL
    assert cuda_solve.check_dims("spd_solve", 5, cuda_solve.SPD_SOLVE_DIMS) == kernel_shapes.GENERAL
    assert isinstance(sfm.scan_geometry(24, 8), sfm.GeneralScanGeometry)
    # the build's dispatch tables are made at import and keep every case
    assert "#define SOCIAL_MPC_BLOCKS(X) X(1) X(2) X(3) X(4) X(5) X(6)\n" in kernel_shapes.header()
    monkeypatch.undo()
    assert cuda_solve.check_dims("propose", 6) == kernel_shapes.TEMPLATED


@pytest.mark.parametrize("entry,limit", [
    ("social_mpc_rollout_prep_general_f32", "SOCIAL_MPC_GENERAL_MAX_BLOCKS"),
    ("social_mpc_rollout_sample_general_f32", "SOCIAL_MPC_GENERAL_MAX_BLOCKS"),
    ("social_mpc_fused_iter_general_f32", "SOCIAL_MPC_GENERAL_MAX_BLOCKS"),
    ("social_mpc_commit_general_f32", "SOCIAL_MPC_GENERAL_MAX_DIM"),
    ("social_mpc_damped_step_general_f32", "SOCIAL_MPC_GENERAL_MAX_DIM"),
    ("social_mpc_spd_solve_general_f32", "SOCIAL_MPC_GENERAL_MAX_DIM"),
    ("social_mpc_sfm_scan_general_f32", "SOCIAL_MPC_SFM_GENERAL_MAX_AGENTS"),
])
def test_every_general_entry_checks_its_generated_limit(entry, limit):
    """A general form's C entry refuses past the limit kernel_shapes.h
    carries, names no shape of its own and expands no list; _build declares
    it with its templated form's arguments, K7's two and the general
    rollouts with the launch geometry the wrapper passes
    (kernel_shapes.general_solve_geometry: three ints;
    rollout_general_geometry: two) before the stream, which the entry
    checks."""
    source = next(f for f in sorted(os.listdir(_build.CSRC_DIR)) if f.endswith(".cu")
                  and f'extern "C" int {entry}(' in open(os.path.join(_build.CSRC_DIR, f)).read())
    body = _entry_body(source, entry)
    assert limit in body and "switch" not in body
    for name in kernel_shapes.LISTS:
        assert f"{name}(" not in body
    assert entry in _build.GENERAL_ENTRIES
    templated = _build._SIGNATURES[entry.replace("_general", "")]
    if entry in _build.GEOMETRY_ENTRIES:
        ints = 2 if "rollout" in entry else 3
        assert _build.GEOMETRY_ENTRIES[entry] == ints
        assert _build._SIGNATURES[entry] == templated[:-1] + [ctypes.c_int] * ints + templated[-1:]
        assert ("general_geometry_ok(NB, warps, share)" if "rollout" in entry else
                "general_geometry_ok(D, threads, systems, shared)") in body
    else:
        assert _build._SIGNATURES[entry] == templated


def test_general_entries_are_the_sources_own():
    """_build declares exactly the general C entries the sources define;
    propose's general form has none of its own: it is K7's general damped
    step without the scale (one body, damped_step.cuh)."""
    defined = set()
    for f in sorted(os.listdir(_build.CSRC_DIR)):
        if f.endswith(".cu"):
            text = open(os.path.join(_build.CSRC_DIR, f)).read()
            defined |= set(re.findall(r'extern "C" int (social_mpc_\w+_general_f32)\(', text))
    assert defined == set(_build.GENERAL_ENTRIES)
    assert "social_mpc_propose_general_f32" not in defined


def test_scan_shared_memory_passes_48_kb_only_past_94_steps_at_one_agent():
    """K5's block at N = 1 holds 32 scenarios: (64 + 32 * steps) float4s,
    48 KB exactly at 94 steps; the launch opts in to more above that."""
    geo = sfm.scan_geometry(1, 1024)
    assert sfm.scan_shared_bytes(geo, 1, 95) == 48 * 1024
    assert sfm.scan_shared_bytes(geo, 1, 96) > 48 * 1024
    assert sfm.scan_shared_bytes(sfm.scan_geometry(32, 8), 32, 400) < 48 * 1024


@pytest.mark.parametrize("n,shared", [(33, 8384), (64, 12352), (128, 12320), (703, 49120),
                                      (704, 49184), (LIMIT_N, 232416)])
def test_general_scan_shared_memory_and_its_limit(n, shared):
    """K5's general form: per scenario 64 bytes an agent, 32 for the robot
    and 16 a thread of the scenario's, whatever the steps, times the
    scenarios of a block of 256 (2 to 64 agents, 1 above); past
    48 KB (from 704 agents) the launch opts in; the limit is the most
    agents one block's 227 KB holds on 256 threads, and the kernel reads
    the limit and the block from the generated header."""
    geo = sfm.scan_geometry(n, 3)
    assert sfm.scan_shared_bytes(geo, n, 30) == sfm.scan_shared_bytes(geo, n, 400) == shared
    assert (shared > 48 * 1024) == (n >= 704)
    assert geo.threads == kernel_shapes.SFM_GENERAL_THREADS == 256
    header = kernel_shapes.header()
    assert f"#define SOCIAL_MPC_SFM_GENERAL_MAX_AGENTS {LIMIT_N}\n" in header
    assert "#define SOCIAL_MPC_SFM_GENERAL_THREADS 256\n" in header
    with open(os.path.join(_build.CSRC_DIR, "sfm_scan.cu")) as f:
        source = f.read()
    assert "kGeneralThreads = SOCIAL_MPC_SFM_GENERAL_THREADS;" in source
    assert "return (size_t)64 * n + 32 + (size_t)16 * threads;" in source


@pytest.mark.parametrize("n,threads,spb,shared", [
    (33, 128, 2, 2 * (64 * 33 + 32 + 16 * 128)),
    (64, 128, 2, 2 * (64 * 64 + 32 + 16 * 128)),   # social_n64
    (128, 256, 1, 64 * 128 + 32 + 16 * 256),
    (LIMIT_N, 256, 1, 64 * LIMIT_N + 32 + 16 * 256),
])
def test_general_scan_threads_and_shared_bytes(n, threads, spb, shared):
    """K5's general form: threads a scenario from N (four warps to 64
    agents, the block above), scenarios a block, and a block's shared
    memory, from kernel_shapes.sfm_general_shared_bytes."""
    assert sfm.general_threads_per_scenario(n) == threads
    geo = sfm.scan_geometry(n, 4096)
    assert (geo.threads_per_scenario, geo.scenarios_per_block) == (threads, spb)
    assert kernel_shapes.sfm_general_shared_bytes(n, threads) * spb == shared
    assert sfm.scan_shared_bytes(geo, n, 30) == shared <= kernel_shapes.SHARED_BYTES_PER_BLOCK
    assert kernel_shapes.sfm_general_shared_bytes(LIMIT_N) == 64 * LIMIT_N + 32 + 16 * 256


@pytest.mark.parametrize("nb,s,want", [
    (7, 29, (32, 4, 8, 4 * (32 * 14 * 8 + 1744))),     # a warp a scenario, four a block
    (9, 29, (32, 4, 8, 4 * (32 * 18 * 8 + 1744))),     # social_bl2
    (12, 39, (32, 4, 8, 4 * (32 * 24 * 8 + 2352))),    # stress36_bl3
    (18, 29, (128, 1, 8, 32 * 36 * 8 + 1744)),         # social_bl1: 128 threads a scenario
    (18, 69, (128, 1, 8, 32 * 36 * 8 + 4144)),
    (16, 123, (32, 1, 8, 32 * 32 * 8 + 7392)),         # four would pass 48 KB: one a block
    (118, 123, (128, 1, 8, 32 * 236 * 8 + 7392)),      # the limit
    (118, 3748, (128, 1, 1, 32 * 236 + 224880)),       # the longest rollout: a one-step tile
])
def test_fused_general_geometry(nb, s, want):
    """K2's general form: threads a scenario (a warp to D = 32, 128 above),
    scenarios a block (as many as fit a block of 128 in 48 KB), the step
    tile its second phase stages (8 steps, S if fewer, fewer only where the
    sums leave no room) and a block's shared memory, within one block's
    227 KB; the kernel reads the tile and the block's bytes from the
    generated header."""
    assert kernel_shapes.fused_general_geometry(nb, s) == want
    threads, spb, tile, shared = want
    assert spb * threads <= kernel_shapes.FUSED_GENERAL_BLOCK
    assert shared == spb * kernel_shapes.fused_general_shared_bytes(s, 2 * nb, tile)
    assert shared <= kernel_shapes.SHARED_BYTES_PER_BLOCK
    assert s <= kernel_shapes.GENERAL_MAX_STEPS == 3748
    header = kernel_shapes.header()
    assert "#define SOCIAL_MPC_FUSED_GENERAL_STEP_TILE 8\n" in header
    assert "#define SOCIAL_MPC_SHARED_BYTES_PER_BLOCK 232448\n" in header
    with open(os.path.join(_build.CSRC_DIR, "fused_general.cu")) as f:
        source = f.read()
    assert "STEP_TILE = SOCIAL_MPC_FUSED_GENERAL_STEP_TILE;" in source
    assert "GENERAL_BLOCK = 128;" in source


FAKE_NVCC = textwrap.dedent("""\
    import os, sys
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-c" in args:
        with open(os.path.join(args[args.index("-I") + 1], "kernel_shapes.h")) as f:
            header = f.read()
        with open(out, "w") as f:
            f.write(header)
        sys.exit(0)
    with open(out, "w") as f:
        for obj in args[args.index("-o") + 2:]:
            f.write(open(obj).read())
""")

BUILD_CHILD = textwrap.dedent("""\
    import sys
    from nav2_social_mpc_controller_tpu_torch import _build
    _build.CSRC_DIR, _build.BUILD_DIR = sys.argv[1:3]
    _build.find_nvcc = lambda: sys.argv[3]
    print(_build.build())
""")


def test_every_compile_includes_the_generated_header(tmp_path):
    """_build compiles each source with the directory of this build's
    kernel_shapes.h on its include path (a stand-in nvcc that copies the
    header it finds into its object)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", BUILD_CHILD, str(csrc), str(tmp_path / "build"), str(nvcc)],
        capture_output=True, text=True, cwd=repo, env={**os.environ, "PYTHONPATH": repo},
        timeout=120)
    assert out.returncode == 0, out.stderr
    with open(out.stdout.strip()) as f:
        assert f.read() == 2 * kernel_shapes.header()


@pytest.mark.parametrize("warps", kernel_shapes.ROLLOUT_GENERAL_WARPS)
def test_rollout_general_geometry_at_every_block_count(warps, monkeypatch):
    """The general rollout's launch at every NB the general forms take, at
    each warps a scenario: ceil(NB / W) blocks a warp, taken where it fits
    the last register ceiling and refused past it, as the C entries refuse
    it (eight warps take every NB); the kernels read the ceiling from the
    generated header."""
    monkeypatch.setattr(kernel_shapes, "rollout_general_warps", lambda *_: warps)
    for nb in range(1, kernel_shapes.GENERAL_MAX_BLOCKS + 1):
        share = -(-nb // warps)
        if share > kernel_shapes.ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS:
            assert warps < kernel_shapes.ROLLOUT_GENERAL_WARPS[-1]
            with pytest.raises(ValueError):
                kernel_shapes.rollout_general_geometry(nb, 1, 33)
            continue
        assert kernel_shapes.rollout_general_geometry(nb, 1, 33) == (warps, share)
    assert (f"#define SOCIAL_MPC_ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS "
            f"{kernel_shapes.ROLLOUT_GENERAL_CEILINGS[-1]}\n") in kernel_shapes.header()
    with open(os.path.join(_build.CSRC_DIR, "rollout.cuh")) as f:
        source = f.read()
    assert "= SOCIAL_MPC_ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS;" in source
    assert "share <= GENERAL_MAX_REGISTER_BLOCKS" in source
    monkeypatch.setattr(kernel_shapes, "rollout_general_warps", lambda *_: 3)
    with pytest.raises(ValueError):
        kernel_shapes.rollout_general_geometry(9, 1, 33)


@pytest.mark.parametrize("steps", [29, 69])
@pytest.mark.parametrize("batch", [1, 16, 256, 1024, 4096, 4101])
def test_rollout_general_default_warps(batch, steps):
    """The wrappers' warps a scenario: one of ROLLOUT_GENERAL_WARPS at every
    NB, never more blocks a warp than the register ceilings hold and past
    one chunk at most 8 where eight warps allow it, more warps as the batch
    falls (at NB = 9 one at B = 4096 and one chunk, two past it and at
    B = 1024; eight at B <= 256)."""
    cap = (kernel_shapes.ROLLOUT_GENERAL_BLOCKS_A_WARP if steps > 32
           else kernel_shapes.ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS)
    for nb in range(1, kernel_shapes.GENERAL_MAX_BLOCKS + 1):
        w, share = kernel_shapes.rollout_general_geometry(nb, batch, steps)
        assert w in kernel_shapes.ROLLOUT_GENERAL_WARPS
        assert share <= kernel_shapes.ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS
        assert w == 8 or (w * batch >= kernel_shapes.ROLLOUT_GENERAL_FULL_WARPS
                          and share <= cap)
    assert kernel_shapes.rollout_general_warps(9, 4096, 29) == 1
    assert kernel_shapes.rollout_general_warps(9, 4096, 69) == 2
    assert kernel_shapes.rollout_general_warps(12, 1024, 39) == 2
    assert kernel_shapes.rollout_general_warps(18, 1024, 29) == 2
    assert kernel_shapes.rollout_general_warps(18, 1024, 69) == 4
    assert kernel_shapes.rollout_general_warps(36, 256, 69) == 8


@pytest.mark.parametrize("b", [1, 3, 1024, 1025, 4096, 4101])
def test_trajectorize_lanes(b):
    """The trajectorizer's lanes a scenario divide a warp, one of the two
    its entry takes."""
    assert kernel_shapes.trajectorize_lanes(b) in kernel_shapes.TRAJECTORIZE_LANES
    with open(os.path.join(_build.CSRC_DIR, "trajectorize.cu")) as f:
        assert "if (lanes != 16 && lanes != 32)" in f.read()
