"""Builds and loads the package's CUDA kernels.

The ten sources under ``csrc/`` (eleven kernels, seven of them with a general
form that takes NB, D or N at run time, ``fused_general.cu`` K2's, K7's general
damped step K3's as well, ``sfm_scan.cu`` K5's past 32 agents; ``tr_iter.cu`` holds K3 and K4; ``trajectorize.cu`` is the port's own, the counterpart of the JAX
package's jitted trajectorizer scan; ``tick_graph.cu`` is the port's own
too, the loops' conditions ``lm_continue`` and ``compact_continue`` and the
primitives of the parent graphs that run a tick, a compacted tick or a
simulated campaign as one launch, the counterparts of the JAX package's
``lax.while_loop``s and ``lax.scan``) expose a plain C interface (no PyTorch
headers), so each compiles in seconds (the headers ``chol.cuh``,
``damped_step.cuh``, ``bicubic.cuh``, ``rollout.cuh`` and ``fused_rows.cuh``
hold the code that two kernels share).
The shapes each kernel is instantiated for, and the general forms' limits,
come from ``kernel_shapes.py``, written into every build as
``kernel_shapes.h`` (``write_shapes_header``), whose X-macro lists the
sources' dispatch tables expand.
``load()`` compiles every ``*.cu`` for Hopper
(``sm_90a``) with one ``nvcc`` process per source, all started together,
links the objects into one shared library under ``build/`` (git-ignored),
opens it with ``ctypes`` and declares every entry point's ``argtypes``.
Each build compiles into a directory of its own and renames the finished
library into place, so processes that build at once on a fresh tree (the
ranks of a campaign) never link or open each other's half-written files.
It runs at first use, never at import: importing the package needs neither
``nvcc`` nor a card. A failed build raises; nothing falls back.

No ``--use_fast_math``: division, sqrtf, sinf/cosf/atan2f stay IEEE, because
the trust-region ratio rho decides accept/reject.

The launch counters live here too: each kernel wrapper adds one to its entry
of ``launch_counts`` where it launches its kernel, and nowhere else, so a run
can show that it really went through the kernels. K7's two entries, the
damped step and the standalone solve, count under ``spd_solve``. A kernel's
general form (NB, D or N at run time, past kernel_shapes' lists) counts under
its own name, the templated form's with ``_general`` appended
(``counter_name``). A tick
or a campaign launched as one graph (controller/graph.py,
controller/graph_compacted.py, runtime/simulator.py) runs its loops' bodies
as often as the device decides: what it owes the counters is read from the device
when the counts are read (``LaunchCounts``), never inside the tick.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

from nav2_social_mpc_controller_tpu_torch import kernel_shapes

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
LIB_NAME = "libsocial_mpc_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


class LaunchCounts(dict):
    """Kernel name -> launches. Sources whose launches only the device has
    counted (``owe(source)``: a source with a ``drain()`` that returns
    {name: launches} since its last drain) are drained into the counts when
    they are read, outside any capture. ``add`` counts without draining, for
    the host's own tallies inside a tick."""

    def __init__(self, *args):
        super().__init__(*args)
        self._owed = []

    def owe(self, source) -> None:
        if not any(s is source for s in self._owed):
            self._owed.append(source)

    def add(self, name: str, n: int) -> None:
        dict.__setitem__(self, name, dict.__getitem__(self, name) + n)

    def settle(self) -> None:
        """Drain every source that owes launches (a read of the device)."""
        if not self._owed:
            return
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        owed, self._owed = self._owed, []
        for source in owed:
            for name, n in source.drain().items():
                self.add(name, n)

    def __getitem__(self, name):
        self.settle()
        return dict.__getitem__(self, name)

    def __iter__(self):
        self.settle()
        return dict.__iter__(self)

    def keys(self):
        self.settle()
        return dict.keys(self)

    def values(self):
        self.settle()
        return dict.values(self)

    def items(self):
        self.settle()
        return dict.items(self)

    def __eq__(self, other):
        self.settle()
        return dict.__eq__(self, other)

    __hash__ = None

    def __repr__(self):
        self.settle()
        return dict.__repr__(self)


launch_counts = LaunchCounts({
    "sfm_scan": 0, "rollout_prep": 0, "bicubic": 0, "rollout_sample": 0, "fused_iter": 0,
    "propose": 0, "commit": 0, "spd_solve": 0, "trajectorize": 0, "lm_continue": 0,
    "compact_continue": 0,
    # the general forms (NB and D at run time, past kernel_shapes' lists)
    "rollout_prep_general": 0, "rollout_sample_general": 0, "fused_iter_general": 0,
    "propose_general": 0, "commit_general": 0, "spd_solve_general": 0,
    # K5's general form (N at run time, past 32 agents)
    "sfm_scan_general": 0,
})

GENERAL_SUFFIX = "_general"


def counter_name(name: str, form: str) -> str:
    """The launch counter of kernel `name` in `form` (kernel_shapes.form):
    a general form counts under its own name, so that a run shows which
    form it went through."""
    return name if form == kernel_shapes.TEMPLATED else name + GENERAL_SUFFIX

_lock = threading.Lock()
_lib = None
last_build_log = ""  # the compilers' output of the last build()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_ulonglong

# name -> argtypes; every entry returns the cudaError_t of its launch.
_SIGNATURES = {
    # win, row, col, val, drow, dcol, B, S, H, W, stream
    "social_mpc_bicubic_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # u, px, py, pth, v, dxdv, dydv, dxdw, dydw, (4 batch strides), dth, eb,
    # val, drow, dcol, agents, (3 agent strides), m_step, m_vel, m_social,
    # active, steer, refx, refy, scal, vfm, cost, g, jtj, B, S, NB, n_vf, N,
    # 11 floats (9 weights, desired, front), stream
    "social_mpc_fused_iter_f32": (
        [_P] * 9 + [_I] * 4 + [_P] * 6 + [_I] * 3 + [_P] * 9 + [_P] * 3 + [_I] * 5
        + [_F] * 11 + [_P]
    ),
    # u, pose0, block_idx, win_origin, resolution, planes, sens, B, S, NB,
    # dt, front, stream
    "social_mpc_rollout_prep_f32": [_P] * 7 + [_I] * 3 + [_F] * 2 + [_P],
    # u, pose0, block_idx, win_origin, resolution, win, planes, sens, B, S,
    # NB, H, W, dt, front, stream
    "social_mpc_rollout_sample_f32": [_P] * 8 + [_I] * 5 + [_F] * 2 + [_P],
    # u, g, jtj, radius, lower, upper, u_new, delta, model_change, B, D,
    # min_diagonal, max_diagonal, stream
    "social_mpc_propose_f32": [_P] * 9 + [_I, _I, _F, _F, _P],
    # 16 inputs, 10 outputs, B, D, 7 floats (tolerances...), stream
    "social_mpc_commit_f32": [_P] * 26 + [_I, _I] + [_F] * 7 + [_P],
    # people, rows, n_rows, indexes, origin, resolution, esdf_valid, out,
    # B, N, S+1, H, W, window, sources per lane, blocks, 14 floats (maxtime,
    # dt, SFM parameters...), stream
    "social_mpc_sfm_scan_f32": [_P] * 8 + [_I] * 8 + [_F] * 14 + [_P],
    # a, b, x, N, D, stream
    "social_mpc_spd_solve_f32": [_P, _P, _P, _I, _I, _P],
    # u, g, jtj, radius, lower, upper, jac_scale (or NULL), u_new, delta,
    # model_change, B, D, min_diagonal, max_diagonal, stream
    "social_mpc_damped_step_f32": [_P] * 10 + [_I, _I, _F, _F, _P],
    # points, n, pose0, poses, cmds, n_steps, ok, B, P, S, lookahead_dist,
    # desired_linear_vel, max_angular_vel, time_step, omnidirectional, lanes
    # a scenario (kernel_shapes.trajectorize_lanes), stream
    "social_mpc_trajectorize_f32": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_I, _I, _P],
    # graph_out
    "social_mpc_graph_create": [_P],
    # graph, handle_out
    "social_mpc_graph_handle": [_P, _P],
    # graph, dep, child, node_out
    "social_mpc_graph_add_child": [_P, _P, _P, _P],
    # graph, dep, handle, is_while, node_out, body_out
    "social_mpc_graph_add_conditional": [_P, _P, _U, _I, _P, _P],
    # graph, dep, handle, done, n, stats, out, reset, add, need,
    # max_iterations, check_done, slot, node_out
    "social_mpc_graph_add_lm_continue": [_P, _P, _U, _P, _I, _P, _P] + [_I] * 6 + [_P],
    # graph, dep, handles, n_handles, handle_mask, done, width, next_width,
    # stats, out, rung, n_rungs, reset, check_every, max_iterations, finish,
    # node_out
    "social_mpc_graph_add_compact_continue": [_P, _P, _P, _I, _I, _P, _I, _I, _P, _P]
    + [_I] * 6 + [_P],
    # graph, exec_out
    "social_mpc_graph_instantiate": [_P, _P],
    # exec, stream
    "social_mpc_graph_launch": [_P, _P],
    # graph, exec (or NULL)
    "social_mpc_graph_destroy": [_P, _P],
    # graph, counts (32 int64)
    "social_mpc_graph_node_types": [_P, _P],
    # done, n, stats, out, reset, add, need, max_iterations, check_done,
    # slot, stream
    "social_mpc_lm_continue": [_P, _I, _P, _P] + [_I] * 6 + [_P],
    # done, width, next_width, stats, out, rung, n_rungs, reset,
    # check_every, max_iterations, finish, stream
    "social_mpc_compact_continue": [_P, _I, _I, _P, _P] + [_I] * 6 + [_P],
}

# The general forms (kernel_shapes.form) take their templated forms' arguments.
GENERAL_ENTRIES = tuple(f"social_mpc_{k}_general_f32" for k in (
    "rollout_prep", "rollout_sample", "fused_iter", "commit", "damped_step", "spd_solve",
    "sfm_scan"))
_SIGNATURES.update({name: _SIGNATURES[name.replace("_general", "")] for name in GENERAL_ENTRIES})
# K7's general entries take the launch geometry too, before the stream
# (kernel_shapes.general_solve_geometry: threads a system, systems a block,
# shared bytes a block); so do the general rollouts
# (kernel_shapes.rollout_general_geometry: warps a scenario, blocks a warp).
# Entry -> the geometry's ints.
GEOMETRY_ENTRIES = {"social_mpc_damped_step_general_f32": 3, "social_mpc_spd_solve_general_f32": 3,
                    "social_mpc_rollout_prep_general_f32": 2,
                    "social_mpc_rollout_sample_general_f32": 2}
_SIGNATURES.update({name: _SIGNATURES[name][:-1] + [_I] * n + [_P]
                    for name, n in GEOMETRY_ENTRIES.items()})

def reset_launch_counts() -> None:
    """Every count to 0, launches owed by the device included."""
    launch_counts.settle()
    for k in launch_counts:
        launch_counts[k] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled from csrc/ at first "
            "use and need the CUDA toolkit"
        )
    return nvcc


def sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def write_shapes_header(directory: str) -> str:
    """kernel_shapes.h (kernel_shapes.header()) into `directory`, replaced
    whole so that a concurrent reader never sees half of it; returns the
    directory, the include path the sources need."""
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".h")
    with os.fdopen(fd, "w") as f:
        f.write(kernel_shapes.header())
    os.replace(tmp, os.path.join(directory, kernel_shapes.HEADER_NAME))
    return directory


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    deps = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)] + [kernel_shapes.__file__]
    return any(os.path.getmtime(p) > built for p in deps)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into build/libsocial_mpc_kernels.so (if stale) and
    return its path. With verbose=True, ptxas prints each kernel's registers
    and spills to the returned log (see ``last_build_log``)."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    if not _stale(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="objects.", dir=BUILD_DIR) as obj_dir:
        _compile_and_link(nvcc, obj_dir, lib_path, verbose)
    return lib_path


def _compile_and_link(nvcc: str, obj_dir: str, lib_path: str, verbose: bool) -> None:
    """Compile every source into `obj_dir` (this build's own), link them
    into a file of `obj_dir` and rename it onto `lib_path`."""
    global last_build_log
    extra = ("-Xptxas", "-v") if verbose else ()
    include = write_shapes_header(obj_dir)
    procs = []
    for src in sources():
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", include, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, proc in procs:  # wait for every compiler before judging
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    last_build_log = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{last_build_log}")
    tmp = os.path.join(obj_dir, LIB_NAME)
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def check_tensor(fn: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape on this
    (CUDA) device — what the kernels take."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}, "
            f"contiguous={t.is_contiguous()}"
        )
