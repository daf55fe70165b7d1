"""Build and load the hand-written CUDA kernels (route: nvcc -> .so -> ctypes).

Each `csrc/<name>.cu` compiles on its own into `build/kernels/lib<name>-<hash>.so`
with a plain C interface; the hash covers the source and the headers it
includes, so an edited source never loads a stale library. The first call of
any kernel wrapper builds every missing library at once, one `nvcc` process
per source, all started together. Nothing is built when a module is imported:
the CPU tests import every module on machines that have no `nvcc`.

The wrappers count their launches in `LAUNCHES` (one per kernel launch, and
nowhere else), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")

HEADERS = ("model.cuh", "trisolve.cuh", "common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"linearize": 0, "condense": 0, "condense_from": 0, "cholesky": 0, "chol_solve": 0,
            "ipm_iteration": 0, "condense_mxu": 0, "cholesky_unblocked": 0,
            "chol_solve_unblocked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: argument types (every pointer and the
# stream as c_void_p); each returns the cudaError_t of its launch as int
SIGNATURES = {
    "linearize": {"linearize_f32": [_P, _P, _P, _I, _P, _I, _P],
                  "linearize_tires_f32": [_P, _P, _P, _I, _P, _P, _I, _I, _P],
                  "linearize_launch_plan": [_I, _P]},
    "condense": {"condense_f32": [_P] * 6 + [_I] * 4 + [_P],
                 "condense_from_f32": [_P] * 7 + [_I] * 6 + [_P],
                 "condense_aug_f32": [_P] * 5 + [_I] * 4 + [_P],
                 "condense_launch_plan": [_I] * 4 + [_P]},
    "chol": {"cholesky_f32": [_P, _P, _I, _I, _P], "chol_solve_f32": [_P, _P, _P, _I, _I, _P],
             "cholesky_unblocked_f32": [_P, _P, _I, _I, _P],
             "cholesky_smem_bytes": [_I],
             "chol_solve_unblocked_f32": [_P, _P, _P, _I, _I, _P],
             "chol_solve_plan": [_I, _P]},
    "ipm_iter": {"ipm_iteration_f32": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
                 "ipm_iteration_plan": [_I, _I, _P]},
}

_LIBS: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        p = os.path.join(CSRC_DIR, f)
        if os.path.exists(p):
            with open(p, "rb") as fh:
                h.update(f.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> dict:
    """Build every library that is not built yet, in parallel; return
    {name: compiler log} for the libraries built by this call."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SIGNATURES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        with open(out + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all libraries if
    needed, with its entry points' argument and return types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_status(fn_name: str, status: int):
    if status != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: cudaError {status}")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """Dispatch rule shared by every wrapper: False for CPU tensors (plain
    PyTorch version), True for CUDA float32 tensors (the kernel, launched
    through ops/diffmode.py::kernel_with_plain_vjp); anything else raises."""
    if {t.device.type for t in tensors} == {"cpu"}:
        return False
    check_kernel_inputs(*tensors)
    return True


def check_kernel_inputs(*tensors: torch.Tensor):
    """Raises unless every tensor is a contiguous CUDA float32 tensor, what
    a kernel's entry point takes."""
    devs = {t.device.type for t in tensors}
    if devs != {"cuda"}:
        raise ValueError(f"kernel inputs must all lie on CUDA, got {devs}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
