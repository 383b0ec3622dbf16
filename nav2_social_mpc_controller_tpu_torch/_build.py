"""Builds and loads the package's CUDA kernels.

The sources under ``csrc/`` expose a plain C interface (no PyTorch headers),
so each compiles in seconds (the headers ``chol.cuh``, ``damped_step.cuh``,
``bicubic.cuh`` and ``rollout.cuh`` hold the code that two kernels share).
``load()`` compiles every ``*.cu`` for Hopper
(``sm_90a``) with one ``nvcc`` process per source, all started together,
links the objects into one shared library under ``build/`` (git-ignored),
opens it with ``ctypes`` and declares every entry point's ``argtypes``.
It runs at first use, never at import: importing the package needs neither
``nvcc`` nor a card. A failed build raises; nothing falls back.

No ``--use_fast_math``: division, sqrtf, sinf/cosf/atan2f stay IEEE, because
the trust-region ratio rho decides accept/reject.

The launch counters live here too: each kernel wrapper adds one to its entry
of ``launch_counts`` where it launches its kernel, and nowhere else, so a run
can show that it really went through the kernels. K7's two entries, the
damped step and the standalone solve, count under ``spd_solve``.
"""

import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
LIB_NAME = "libsocial_mpc_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

launch_counts = {
    "sfm_scan": 0, "rollout_prep": 0, "bicubic": 0, "rollout_sample": 0, "fused_iter": 0,
    "propose": 0, "commit": 0, "spd_solve": 0,
}

_lock = threading.Lock()
_lib = None
last_build_log = ""  # the compilers' output of the last build()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

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
}


def reset_launch_counts() -> None:
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


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    deps = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)]
    return any(os.path.getmtime(p) > built for p in deps)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into build/libsocial_mpc_kernels.so (if stale) and
    return its path. With verbose=True, ptxas prints each kernel's registers
    and spills to the returned log (see ``last_build_log``)."""
    global last_build_log
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    if not _stale(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj]
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
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


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
