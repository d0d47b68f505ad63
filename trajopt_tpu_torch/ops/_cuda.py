"""Build, load and launch-check the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` (one
process per source, in parallel), linked into one shared library with a
plain C interface and loaded with `ctypes`.  The library lands in ``trajopt_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
loads in milliseconds.  Nothing here runs at import time: importing the
package on a machine without ``nvcc`` or a GPU is fine, and only a CUDA
tensor reaching a wrapper triggers the build.

``--use_fast_math`` is deliberately absent: the GJK stale test compares
floats for equality and the GMW pivot rule relies on IEEE division/sqrt.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("topk.cu", "gjk.cu", "gjk_fw.cu", "chol.cu", "eig.cu", "graph_cond.cu", "slack.cu")
HEADERS = ("chol_device.cuh",)   # included by sources; hashed with them
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Launch counts per kernel.  Each wrapper adds one where it launches its
# kernel and nowhere else, so a run can prove its main path used them.
# LAUNCH_SHAPES splits the same counts by (kernel, call shape key).  They
# count host calls: while a CUDA graph is captured a call adds a kernel node,
# which then runs uncounted, once per replay at the graph's top level and 0
# or more times a launch inside a conditional node's body
# (`runtime.graph.FusedRun.kernel_nodes` keeps the per-capture count,
# `FusedRun.executions` the executions of the last launch).
LAUNCHES = {"smallest_k": 0, "gjk_exact": 0, "gjk_fw": 0, "mod_chol": 0, "chol_solve": 0,
            "factor_solve": 0, "eigvalsh": 0, "set_condition": 0, "slack_step": 0}
LAUNCH_SHAPES: collections.Counter = collections.Counter()

_lib: ctypes.CDLL | None = None
build_info: dict = {}

_vp, _int, _float, _u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
_SIGNATURES = {
    "trajopt_smallest_k_warp": [_vp, _vp, _vp, _int, _int, _int, _vp],
    "trajopt_smallest_k_radix": [_vp, _vp, _vp, _int, _int, _int, _vp],
    "trajopt_smallest_k_rounds": [_vp, _vp, _vp, _int, _int, _int, _vp],
    "trajopt_gjk_exact": [_vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    "trajopt_gjk_fw": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp],
    "trajopt_mod_chol": [_vp, _vp, _vp, _int, _int, _int, _int, _float, _vp],
    "trajopt_chol_solve": [_vp, _vp, _vp, _int, _int, _int, _vp],
    "trajopt_factor_solve": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _float, _vp],
    "trajopt_chol_probe": [_vp, _int, _int, _vp],
    "trajopt_slack_step": [_vp, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                           _vp, _vp, _int, _int, _int, _float, _float, _float, _float, _int,
                           _float, _vp],
    "trajopt_eigvalsh": [_vp, _vp, _int, _int, _vp],
    "trajopt_eig_probe": [_vp, _int, _vp],
    "trajopt_set_condition": [_u64, _vp, _int, _vp, _vp],
    "trajopt_mark": [_vp, _vp, ctypes.c_longlong, ctypes.c_longlong, _vp],
    "trajopt_cond_probe": [_vp],
    "trajopt_cond_handle": [_vp, _vp, _vp],
    "trajopt_cond_node": [_vp, _u64, _int, _int, _vp],
    "trajopt_stream_create": [_vp],
    "trajopt_capture_body": [_vp, _vp],
    "trajopt_end_body": [_vp, _vp],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed "
                           "to build trajopt_tpu_torch's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _build() -> Path:
    nvcc = _nvcc()
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    out = BUILD_DIR / f"libtrajopt_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in SOURCES]
    cmds = [[nvcc, *FLAGS, "-c", "-o", str(o), str(CSRC / s)] for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = ""
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    build_info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                      log=log + proc.stdout + proc.stderr)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.trajopt_error_string.argtypes = [ctypes.c_int]
        handle.trajopt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check_launch(err: int, name: str, shape: tuple = ()) -> None:
    """Raise if a launch was refused (the kernel then never ran, and a later
    synchronize would not report it); otherwise count the launch, also
    under ``shape``: (input shape, parameter name, value), formatted only
    when read (`shape_label`)."""
    check_error(err, name)
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, shape)] += 1


def check_error(err: int, name: str) -> None:
    """Raise if the launch of ``name`` returned a CUDA error."""
    if err != 0:
        msg = lib().trajopt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 CUDA tensors and nothing else."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA (or CPU) tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def shape_label(shape: tuple) -> str:
    """The label of a shape key: (torch.Size([32, 4000]), "k", 64) reads
    "[32,4000] k=64", and a value that is itself a shape reads as one:
    (torch.Size([64, 33, 33]), "b", torch.Size([64, 33, 2])) is
    "[64,33,33] b=[64,33,2]"."""
    if not shape:
        return ""
    dims, param, value = shape
    if isinstance(value, tuple):
        value = f"[{','.join(map(str, value))}]"
    return f"[{','.join(map(str, dims))}] {param}={value}"


def stream() -> int:
    """The current device's current CUDA stream, as a raw handle: what
    ``torch.cuda.current_stream().cuda_stream`` gives without building a
    Stream object, which costs more host time than a launch."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
