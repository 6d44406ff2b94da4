"""Build and load the CUDA kernels of `vechat_tpu_torch/csrc/*.cu`.

Each source is compiled by `nvcc` for `sm_90a` into its own shared library
with a plain C interface under `vechat_tpu_torch/_build/`, at first use, and
loaded with ctypes; ptxas's report of each build (registers, spills) is
kept beside its library (`ptxas_usage`). A library is rebuilt when its source (or a header in
`csrc/`) is newer. All sources build in parallel, one `nvcc` each. A failed
build raises with nvcc's stderr; there is no fallback.

The launch counters live here too: every wrapper adds one to its kernel's
count where it launches the kernel, and nowhere else; K1's, K3's and K4's
wrappers, and F1's, also tally their launch shapes, and G2's to G6's the
form each launch took.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from typing import Dict, Sequence

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
SOURCES = ("poa_linear", "pairwise_nw", "poa_affine", "poa_convex", "mix_peak", "graph_cycle",
           "graph_build", "graph_consensus", "poa_full")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "poa_dp": 0,
    "poa_walk": 0,
    "poa_expand": 0,
    "pairwise_banded": 0,
    "pairwise_tiled": 0,
    "poa_dp_affine": 0,
    "poa_walk_affine": 0,
    "poa_dp_convex": 0,
    "poa_walk_convex": 0,
    "poa_walk_dense": 0,
    "mix_peak": 0,
    "graph_dfs": 0,
    "graph_topo": 0,
    "graph_topo_bundled": 0,
    "graph_fuse": 0,
    "graph_reach": 0,
    "graph_bundle": 0,
    "poa_full_dp": 0,
    "poa_full_walk": 0,
}
# K1's launch shapes since the last reset_launches(): (B, D, N, W, P, ring
# in "shared" or "global" memory) -> launches
K1_SHAPES: Dict[tuple, int] = {}
# K3's launch shapes since the last reset_launches(): (T, BW, NP) -> launches
K3_SHAPES: Dict[tuple, int] = {}
# K4's launch shapes since the last reset_launches(): (NP, T, W) -> launches
K4_SHAPES: Dict[tuple, int] = {}
# F1's launch shapes since the last reset_launches(): (B, N, S, P) -> launches
FULL_SHAPES: Dict[tuple, int] = {}
# G2's to G6's launches since the last reset_launches(): (kernel, N, form)
# -> launches. G3, G4 and G5: "shared" or "global"; G2 and G6, which choose
# a window at a time: "shared" where every window's rows fit a block's
# shared memory, else "by window" (a window past it reads its rows where
# they lie)
BUILD_FORMS: Counter = Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    K1_SHAPES.clear()
    K3_SHAPES.clear()
    K4_SHAPES.clear()
    FULL_SHAPES.clear()
    BUILD_FORMS.clear()


def on_device(dev):
    """`torch.cuda.device(dev)` where `dev` is not the current CUDA device,
    else a context that does nothing: a launch on the current device skips
    the switch there and back."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def resolve_device(device) -> "torch.device":
    """The torch device for `device`; a CUDA device must exist."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA backend requested but torch.cuda.is_available() is false; "
            "use --backend torch or --backend host to run on the CPU"
        )
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in deps)


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile the stale sources among `names`, all at once. Returns
    {name: ptxas report} for the sources compiled by this call."""
    stale = [n for n in names if _stale(n)]
    if not stale:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in stale:
        # temp path + atomic rename: a process with the old library mapped
        # keeps its inode
        tmp = _lib_path(n) + ".build.%d" % os.getpid()
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports, errors = {}, []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{err}{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, _lib_path(n))
        reports[n] = err + out
        with open(_lib_path(n) + ".ptxas.txt", "w") as f:
            f.write(reports[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def ptxas_usage(name: str) -> Dict[str, dict]:
    """{entry function: {"registers", "stack", "spill_stores", "spill_loads"}}
    of `csrc/<name>.cu` as ptxas reported them at its last build (nvcc's
    -Xptxas -v, kept beside the library); {} before a build."""
    path = _lib_path(name) + ".ptxas.txt"
    if not os.path.exists(path):
        return {}
    usage, fn = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
                usage[fn] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                usage[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                usage[fn]["registers"] = int(m.group(1))
    return usage


def get_lib(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if rc != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: cudaError {rc} ({msg})")
