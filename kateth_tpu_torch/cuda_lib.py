"""Build, load and count the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface, one library per ``.cu`` file,
all compiled at once on first use into ``build/kateth_tpu_torch/<hash>/``
beside the package (the hash covers every .cu and .cuh file, so an edited
source builds anew).  The libraries are loaded with ctypes.  A failed build raises;
nothing falls back to the plain path.

``LAUNCHES`` counts the kernel launches: each wrapper adds one where it
launches its kernel, so a run can show which kernels its path went through.
``MONT_MUL_LAUNCHES`` splits K1's launches by their number of lanes.  A
launch recorded into a CUDA graph launches nothing until the graph is
replayed: graphs.py takes a capture's counts back out with
``launch_counts`` and ``add_launch_counts`` and adds them at every replay.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "kateth_tpu_torch")

#: library name -> its source in csrc/
LIBRARIES = {
    "kernels": "kernels.cu",
    "miller": "miller.cu",
    "hard_part": "hard_part.cu",
    "g2_ladder": "g2_ladder.cu",
    "msm": "msm.cu",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

#: kernel -> (library, C launcher, its argument types before the stream)
KERNELS = {
    "mont_mul": ("kernels", "kateth_mont_mul", [_I, _P, _P, _P, _L]),
    "pow_chain": ("kernels", "kateth_pow_chain", [_I, _P, _P, _L, _P]),
    "g1_ladder": ("kernels", "kateth_g1_ladder", [_P, _P, _P, _P, _P, _P, _P, _L]),
    "miller": ("miller", "kateth_miller", [_P, _P, _P, _P, _P, _L]),
    "hard_part": ("hard_part", "kateth_hard_part", [_P, _P, _L]),
    "g2_ladder": ("g2_ladder", "kateth_g2_ladder", [_P, _P, _P, _P, _P, _P, _P, _L]),
    "prefix_scan": ("msm", "kateth_chain_prefix", [_P, _P, _P, _P, _P, _P, _L, _I]),
    "comb_chain_sum": ("msm", "kateth_comb_chain_sum", [_P, _P, _P, _P, _P, _P, _L, _I]),
}

#: launches per kernel since the last reset_launch_counts()
LAUNCHES = {name: 0 for name in KERNELS}

#: mont_mul launches by lane count since the last reset_launch_counts():
#: a launch's time depends on its width, and most launches are narrow
MONT_MUL_LAUNCHES = {"<=1024": 0, "<=65536": 0, ">65536": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, MONT_MUL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict[str, dict[str, int]]:
    """A copy of both counters."""
    return {"launches": dict(LAUNCHES), "mont_mul_lanes": dict(MONT_MUL_LAUNCHES)}


def add_launch_counts(counts: dict[str, dict[str, int]], times: int = 1) -> None:
    """Add `times` times counts (a launch_counts() difference) to both
    counters."""
    for name, v in counts["launches"].items():
        LAUNCHES[name] += times * v
    for name, v in counts["mont_mul_lanes"].items():
        MONT_MUL_LAUNCHES[name] += times * v


def count_mont_mul_lanes(lanes: int) -> None:
    """Count one mont_mul launch of `lanes` lanes in its bucket."""
    MONT_MUL_LAUNCHES["<=1024" if lanes <= 1024 else "<=65536" if lanes <= 65536 else ">65536"] += 1


@functools.cache
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [_P, _P, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = _I
    return lib


def graph_nodes(raw_graph: int) -> int:
    """The number of nodes of a captured CUDA graph (a cudaGraph_t, as
    torch.cuda.CUDAGraph.raw_cuda_graph() gives it), from libcuda."""
    n = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(raw_graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def source_hash() -> str:
    """Hash of what nvcc reads: the .cu and .cuh files of csrc/."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if not name.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, source_hash())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> float:
    """Compile every library that is not built yet, all nvcc processes at
    once.  Returns the seconds spent; raises RuntimeError on any failure."""
    out_dir = build_dir()
    todo = [
        name for name in LIBRARIES if not os.path.exists(os.path.join(out_dir, f"lib{name}.so"))
    ]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
            "-o", tmp, os.path.join(CSRC, LIBRARIES[name]),
        ]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, f"lib{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"{LIBRARIES[name]}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, os.path.join(out_dir, f"lib{name}.so"))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    build_all()
    lib = ctypes.CDLL(os.path.join(build_dir(), f"lib{name}.so"))
    for lib_name, fn, argtypes in KERNELS.values():
        if lib_name == name:
            getattr(lib, fn).argtypes = [*argtypes, _P]
            getattr(lib, fn).restype = ctypes.c_int
    lib.kateth_error_string.argtypes = [ctypes.c_int]
    lib.kateth_error_string.restype = ctypes.c_char_p
    return lib


def check_cuda(*tensors: torch.Tensor) -> int:
    """Every operand of a launch: on one CUDA device, int64, contiguous.
    Returns that device's index."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError("kernel operands must share one CUDA device")
        if t.dtype != torch.int64:
            raise TypeError(f"kernel operands are int64 digit planes, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return index


#: the caller's current stream on a device index, as an int: the raw
#: handle where this PyTorch has the call, which builds no Stream object
_current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
#: the current CUDA device's index, and making a device current: the raw
#: calls where this PyTorch has them
_get_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
_set_device = getattr(torch._C, "_cuda_setDevice", None) or torch.cuda.set_device

#: kernel -> its C launcher, bound once
_LAUNCHERS: dict[str, ctypes._CFuncPtr] = {}


def _launcher(kernel: str) -> ctypes._CFuncPtr:
    lib_name, fn, _ = KERNELS[kernel]
    _LAUNCHERS[kernel] = getattr(library(lib_name), fn)
    return _LAUNCHERS[kernel]


def launch(kernel: str, device: int, *args) -> None:
    """Call `kernel`'s C launcher on CUDA device `device` (the index
    check_cuda returns), on that device's current stream, raise on a launch
    error, and count the launch.  The launch runs with `device` current: a
    caller on another device has it made current for the call and restored
    after it."""
    fn = _LAUNCHERS.get(kernel) or _launcher(kernel)
    caller = _get_device()
    if caller != device:
        _set_device(device)
    try:
        err = fn(*args, _current_stream(device))
    finally:
        if caller != device:
            _set_device(caller)
    if err != 0:
        msg = library(KERNELS[kernel][0]).kateth_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({err})")
    LAUNCHES[kernel] += 1
