"""ctypes binding for the native ESDF builder (runtime/esdf_builder.cpp, the
package's own copy), compiled on demand with g++ into the package's build/
directory (runtime/native.py).

Produces the obstacle_distance grid layout the reference consumes
(distances [m] + nearest-obstacle flat index x + y*W,
obstacle_distance_interface.hpp / optimizer.cpp:702): the host-side
data-loading layer for scenario generation. Falls back to a NumPy
brute-force transform when no compiler is available.
"""

import ctypes
import subprocess
import threading

import numpy as np

from nav2_social_mpc_controller_tpu_torch.runtime.native import build_and_load, source
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import brute_force_esdf

_lock = threading.Lock()
_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = build_and_load("libesdf.so", [source("esdf_builder.cpp")])
            lib.esdf_build.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_float,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.esdf_build.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _load_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_esdf(occupancy: np.ndarray, resolution: float, empty_value: float = 1e3):
    """Exact EDT from an occupancy grid (nonzero == obstacle).

    Returns (distances (H, W) float32 [m], indexes (H, W) int32 flat
    x + y*W). Uses the native O(HW) builder when available, else the NumPy
    brute force (O(HW * n_obstacles), utils/scenarios.py)."""
    occ = np.ascontiguousarray(occupancy != 0, dtype=np.uint8)
    h, w = occ.shape
    lib = _load()
    if lib is not None:
        dist = np.empty((h, w), np.float32)
        idx = np.empty((h, w), np.int32)
        lib.esdf_build(
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int32(h),
            np.int32(w),
            np.float32(resolution),
            np.float32(empty_value),
            dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return dist, idx
    return brute_force_esdf(occ, resolution, empty_value)
