"""ctypes binding of the native real-time executor (port of
tum_control_tpu/utils/rt_runtime.py).

The C++ executor (csrc/rt_runtime.cc, host code) provides the absolute-
deadline cycle clock, deadline-miss counting, a lock-free telemetry ring
and native p50/p99 latency statistics for the serving loop (deploy_rt.py).

The library is built from the port's own source with g++ at the first
`RealtimeExecutor(...)`, never at import, into
`build/runtime/librt_runtime-<hash>.so`; the hash covers the source and the
flags, so an edited source never loads a stale library. A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "rt_runtime.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "runtime")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")  # runtime/Makefile

_LIB = None
_LIB_LOCK = threading.Lock()


class _Stats(ctypes.Structure):
    _fields_ = [
        ("cycles", ctypes.c_uint64),
        ("deadline_misses", ctypes.c_uint64),
        ("dropped_records", ctypes.c_uint64),
        ("solve_ms_p50", ctypes.c_double),
        ("solve_ms_p99", ctypes.c_double),
        ("solve_ms_max", ctypes.c_double),
        ("solve_ms_mean", ctypes.c_double),
    ]


_TELEMETRY_DTYPE = np.dtype(
    [
        ("cycle", "<u8"), ("t_start_ns", "<u8"), ("solve_ns", "<u8"),
        ("status", "<i4"), ("cost", "<f4"), ("lat_dev", "<f4"),
        ("vel_dev", "<f4"), ("u0", "<f4"), ("u1", "<f4"),
    ],
    align=True,
)


def lib_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librt_runtime-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile csrc/rt_runtime.cc unless this source's library exists;
    returns its path. Raises with the compiler's output on failure."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the real-time executor cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds leave one whole library
    return out


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        lib.rt_create.restype = ctypes.c_void_p
        lib.rt_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.rt_destroy.restype = None
        lib.rt_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_begin_cycle.restype = ctypes.c_uint64
        lib.rt_begin_cycle.argtypes = [ctypes.c_void_p]
        lib.rt_record.restype = None
        lib.rt_record.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.rt_stats.restype = None
        lib.rt_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Stats)]
        lib.rt_export.restype = ctypes.c_uint64
        lib.rt_export.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_record_size.restype = ctypes.c_uint64
        lib.rt_record_size.argtypes = []
        if lib.rt_record_size() != _TELEMETRY_DTYPE.itemsize:
            raise RuntimeError(f"telemetry record is {lib.rt_record_size()} bytes in the "
                               f"library, {_TELEMETRY_DTYPE.itemsize} in _TELEMETRY_DTYPE")
        _LIB = lib
        return lib


def read_telemetry(path: str) -> np.ndarray:
    """Load a binary telemetry export as a structured numpy array."""
    return np.fromfile(path, dtype=_TELEMETRY_DTYPE)


class RealtimeExecutor:
    """Thin handle over the native executor; builds the library at the first
    instance."""

    def __init__(self, period_s: float, ring_capacity: int = 1 << 16):
        self._lib = _load_lib()
        self._h = self._lib.rt_create(int(period_s * 1e9), ring_capacity)

    def begin_cycle(self) -> int:
        """Sleep until the next absolute deadline; returns the cycle's start
        (monotonic ns). A cycle that starts late counts a miss and re-anchors
        the grid."""
        return self._lib.rt_begin_cycle(self._h)

    def record(self, t_start_ns, solve_ns, status, cost, lat_dev, vel_dev, u0, u1):
        self._lib.rt_record(
            self._h, int(t_start_ns), int(solve_ns), int(status),
            float(cost), float(lat_dev), float(vel_dev), float(u0), float(u1),
        )

    def stats(self) -> dict:
        s = _Stats()
        self._lib.rt_stats(self._h, ctypes.byref(s))
        return {f: getattr(s, f) for f, _ in s._fields_}

    def export(self, path: str) -> int:
        """Append the ring's records to `path`; returns how many."""
        return int(self._lib.rt_export(self._h, path.encode()))

    def close(self):
        if self._h:
            self._lib.rt_destroy(self._h)
            self._h = None
