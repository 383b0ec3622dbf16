"""Builds the host-side C++ helpers of ``runtime/`` (``esdf_builder.cpp``,
``scenario_gen.cpp``) with g++ into the package's git-ignored ``build/``
directory, at first use, and opens them with ctypes. A library is rebuilt
when a source is newer than it; a build goes to a temporary name and is
renamed into place, so processes that build at once do not see each other's
half-written files."""

import ctypes
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")


def source(name: str) -> str:
    return os.path.join(_HERE, name)


def build_and_load(lib_name: str, sources, extra=()):
    """g++ -O3 -shared -fPIC `sources` into build/`lib_name` (if stale) and
    return the ctypes.CDLL; raises OSError or CalledProcessError when g++
    is missing or fails."""
    lib_path = os.path.join(BUILD_DIR, lib_name)
    src_mtime = max(os.path.getmtime(s) for s in sources)
    if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < src_mtime:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, *sources, *extra],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path)
