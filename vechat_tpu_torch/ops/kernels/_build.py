"""Build and load the CUDA kernels of `vechat_tpu_torch/csrc/*.cu`.

Each source is compiled by `nvcc` for `sm_90a` into its own shared library
with a plain C interface under `vechat_tpu_torch/_build/`, at first use, and
loaded with ctypes. A library is rebuilt when its source (or a header in
`csrc/`) is newer. All sources build in parallel, one `nvcc` each. A failed
build raises with nvcc's stderr; there is no fallback.

The launch counters live here too: every wrapper adds one to its kernel's
count where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
SOURCES = ("poa_linear", "pairwise_nw")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "poa_dp": 0,
    "poa_walk": 0,
    "pairwise_banded": 0,
    "pairwise_tiled": 0,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


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
