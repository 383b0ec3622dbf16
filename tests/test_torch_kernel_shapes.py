"""The shapes the CUDA kernels are instantiated for (kernel_shapes.py): the
dispatch tables of ``csrc/*.cu``, generated into every build as
kernel_shapes.h, against the sets the wrappers check; the limits past which
the wrappers refuse, with messages that name them; and the header in the
include path of every compile. No card and no nvcc: the sources are read as
text and the compiler is a stand-in."""

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
        for n in range(1, sfm.KERNEL_MAX_AGENTS + 1))
    assert sfm.KERNEL_MAX_AGENTS == 32


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


@pytest.mark.parametrize("check,limit,message", [
    (lambda: rollout_cuda.check_blocks("rollout_sample", LIMIT_NB + 1), f"NB from 1 to {LIMIT_NB}",
     "shared memory"),
    (lambda: cuda_solve.check_dims("propose", 2 * LIMIT_NB + 2),
     f"every even D from 2 to {2 * LIMIT_NB}", "shared memory"),
    (lambda: cuda_solve.check_dims("damped_step", 5), f"every even D from 2 to {2 * LIMIT_NB}",
     "D = 2 NB"),
    (lambda: cuda_solve.check_dims("spd_solve", LIMIT_D + 1, cuda_solve.SPD_SOLVE_DIMS),
     f"D from 1 to {LIMIT_D}", "shared memory"),
    (lambda: sfm.scan_geometry(33, 8), "1 to 32 agents", "one warp"),
], ids=["NB119", "propose_D238", "damped_step_D5", "spd_solve_D238", "N33"])
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
    lists = kernel_shapes.header()
    for name, value in kernel_shapes.LIMITS.items():
        assert f"#define {name} {value}\n" in lists


@pytest.mark.parametrize("check", [
    lambda: rollout_cuda.check_blocks("rollout_prep", 1),
    lambda: rollout_cuda.check_blocks("rollout_sample", 6),
    lambda: cuda_solve.check_dims("commit", 2),
    lambda: cuda_solve.check_dims("spd_solve", 16, cuda_solve.SPD_SOLVE_DIMS),
    lambda: sfm.scan_geometry(32, 4101),
    lambda: rollout_cuda.check_blocks("rollout_sample", 7),
    lambda: rollout_cuda.check_blocks("fused_cost_g_jtj", 64),
    lambda: rollout_cuda.check_blocks("fused_cost_g_jtj", LIMIT_NB),
    lambda: cuda_solve.check_dims("propose", 14),
    lambda: cuda_solve.check_dims("propose", 128),
    lambda: cuda_solve.check_dims("damped_step", 2 * LIMIT_NB),
    lambda: cuda_solve.check_dims("spd_solve", 17, cuda_solve.SPD_SOLVE_DIMS),
    lambda: cuda_solve.check_dims("spd_solve", LIMIT_D, cuda_solve.SPD_SOLVE_DIMS),
], ids=["NB1", "NB6", "commit_D2", "spd_solve_D16", "N32", "NB7", "NB64", "NB118",
        "propose_D14", "propose_D128", "damped_step_D236", "spd_solve_D17", "spd_solve_D237"])
def test_the_wrappers_take_the_new_shapes(check):
    check()


@pytest.mark.parametrize("kind,n,form", [
    ("blocks", 1, "templated"), ("blocks", 6, "templated"), ("blocks", 7, "general"),
    ("blocks", 18, "general"), ("solve", 12, "templated"), ("solve", 14, "general"),
    ("solve", 36, "general"), ("spd_solve", 16, "templated"), ("spd_solve", 17, "general"),
    ("spd_solve", 33, "general"),
])
def test_the_wrappers_pick_the_templated_form_where_it_is_instantiated(kind, n, form):
    """One function chooses: the templated form for a shape of its list, the
    general form past it; the wrappers count each under its own name."""
    assert kernel_shapes.form("f", kind, n) == form
    assert _build.counter_name("fused_iter", form) == (
        "fused_iter" if form == "templated" else "fused_iter_general")
    assert _build.counter_name("fused_iter", form) in _build.launch_counts


def test_form_reads_the_lists_at_each_call(monkeypatch):
    """A cross-check of the two forms takes the general forms at a templated
    shape by emptying the lists for a while: form reads them at each call."""
    for name in ("BLOCKS", "SOLVE_DIMS", "SPD_SOLVE_DIMS"):
        monkeypatch.setattr(kernel_shapes, name, ())
    assert rollout_cuda.check_blocks("rollout_sample", 3) == kernel_shapes.GENERAL
    assert cuda_solve.check_dims("propose", 6) == kernel_shapes.GENERAL
    assert cuda_solve.check_dims("spd_solve", 5, cuda_solve.SPD_SOLVE_DIMS) == kernel_shapes.GENERAL
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
])
def test_every_general_entry_checks_its_generated_limit(entry, limit):
    """A general form's C entry refuses past the limit kernel_shapes.h
    carries, names no shape of its own and expands no list; _build declares
    it with its templated form's arguments."""
    source = next(f for f in sorted(os.listdir(_build.CSRC_DIR)) if f.endswith(".cu")
                  and f'extern "C" int {entry}(' in open(os.path.join(_build.CSRC_DIR, f)).read())
    body = _entry_body(source, entry)
    assert limit in body and "switch" not in body
    for name in kernel_shapes.LISTS:
        assert f"{name}(" not in body
    assert entry in _build.GENERAL_ENTRIES
    assert _build._SIGNATURES[entry] == _build._SIGNATURES[entry.replace("_general", "")]


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
