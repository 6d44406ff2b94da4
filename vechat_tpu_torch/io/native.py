"""Native (C++) parser bindings.

Builds csrc/fastx.cpp into a shared library on first use (g++ -O3, linked
against zlib) and exposes it through ctypes. Falls back to the pure-Python
parser when the toolchain or zlib is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_SRC = os.path.join(_REPO_ROOT, "csrc", "fastx.cpp")
# the port builds the shared host sources into its own build directory
_LIB = os.path.join(_PKG_ROOT, "_build", "_fastx_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        # build to a temp path + atomic rename so a running process with the
        # old .so mapped keeps its inode
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        tmp = _LIB + ".build.%d" % os.getpid()
        cmd = [
            "g++",
            "-O3",
            "-std=c++17",
            "-shared",
            "-fPIC",
            _SRC,
            "-o",
            tmp,
            "-lz",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
    lib = ctypes.CDLL(_LIB)
    lib.fastx_parse.restype = ctypes.c_void_p
    lib.fastx_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fastx_error.restype = ctypes.c_char_p
    lib.fastx_error.argtypes = [ctypes.c_void_p]
    lib.fastx_count.restype = ctypes.c_long
    lib.fastx_count.argtypes = [ctypes.c_void_p]
    for fn in (lib.fastx_name, lib.fastx_seq, lib.fastx_qual):
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_char_p),
        ]
    lib.fastx_free.restype = None
    lib.fastx_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            _lib = _build()
            _failed = _lib is None
    return _lib


def read_fastx_native(path, shorten_names: bool = True) -> Optional[List]:
    """Parse with the native library; returns None when unavailable so the
    caller can fall back to the Python implementation."""
    lib = get_lib()
    if lib is None:
        return None
    from .fastx import SeqRecord

    h = lib.fastx_parse(os.fspath(path).encode(), 1 if shorten_names else 0)
    try:
        err = lib.fastx_error(h)
        if err:
            raise ValueError(f"{err.decode()}: {path}")
        n = lib.fastx_count(h)
        out = []
        ptr = ctypes.c_char_p()
        for i in range(n):
            ln = lib.fastx_name(h, i, ctypes.byref(ptr))
            name = ctypes.string_at(ptr, ln).decode()
            ls = lib.fastx_seq(h, i, ctypes.byref(ptr))
            seq = ctypes.string_at(ptr, ls).decode()
            lq = lib.fastx_qual(h, i, ctypes.byref(ptr))
            qual = ctypes.string_at(ptr, lq).decode() if lq else None
            out.append(SeqRecord(name, seq, qual))
        return out
    finally:
        lib.fastx_free(h)
