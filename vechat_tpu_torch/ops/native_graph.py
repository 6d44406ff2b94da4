"""ctypes bindings for the native C++ POA graph runtime (csrc/poagraph.cpp).

`NativePoaGraph` is duck-type compatible with the subset of
ops.poagraph.PoaGraph used by the correction drivers and the device backend;
it replaces the Python graph-op hot path (the reference keeps these ops in
C++ too — vendor/spoa/src/graph.cpp). Falls back transparently: callers use
`make_graph()` which returns the Python oracle when the toolchain is
unavailable or VECHAT_NO_NATIVE is set.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from .poagraph import Alignment, PoaGraph

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_SRC = os.path.join(_REPO_ROOT, "csrc", "poagraph.cpp")
# the port builds the shared host sources into its own build directory
_LIB = os.path.join(_PKG_ROOT, "_build", "_poagraph_native.so")

_lock = threading.Lock()
_lib = None
_failed = False
_warned_sort_fallback = False

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")


def _loads_ok(path: str) -> bool:
    """Probe the lib in a SUBPROCESS: a stale -march=native build on a
    machine without those ISA extensions dies with SIGILL, which cannot be
    caught in-process."""
    code = (
        "import ctypes,sys;l=ctypes.CDLL(sys.argv[1]);"
        "l.poa_create.restype=ctypes.c_void_p;"
        "l.poa_free.argtypes=[ctypes.c_void_p];l.poa_free(l.poa_create())"
    )
    try:
        r = subprocess.run(
            ["python3", "-c", code, path], capture_output=True, timeout=30
        )
        return r.returncode == 0
    except Exception:
        return False


def _build():
    if not os.path.exists(_SRC):
        return None
    stale = not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(
        _SRC
    )
    if not stale and not _loads_ok(_LIB):
        stale = True  # prebuilt for a different ISA (e.g. AVX-512 elsewhere)
    if stale:
        # -march=native: the candidate loop of align_linear auto-vectorizes
        # (AVX-512: 16 int32 lanes; measured 2.3x realign throughput,
        # scripts/host_dp_bench.py). int32 arithmetic is ISA-independent so
        # results stay byte-identical. Falls back to portable -O3 when the
        # native build fails or does not load.
        built = False
        # build to a temp path and rename: atomic replace keeps the old
        # inode alive for any running process that still has it mapped
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        tmp = _LIB + ".build.%d" % os.getpid()
        for extra in (["-march=native", "-funroll-loops"], []):
            cmd = (
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
                + extra
                + [_SRC, "-o", tmp]
            )
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=180)
            except Exception:
                continue
            if _loads_ok(tmp):
                os.replace(tmp, _LIB)
                built = True
                break
        if os.path.exists(tmp):
            os.unlink(tmp)
        if not built:
            return None
    lib = ctypes.CDLL(_LIB)
    lib.poa_create.restype = ctypes.c_void_p
    lib.poa_free.argtypes = [ctypes.c_void_p]
    lib.poa_num_nodes.argtypes = [ctypes.c_void_p]
    lib.poa_num_nodes.restype = ctypes.c_int
    lib.poa_num_edges.argtypes = [ctypes.c_void_p]
    lib.poa_num_edges.restype = ctypes.c_int
    lib.poa_total_edge_weight.argtypes = [ctypes.c_void_p]
    lib.poa_total_edge_weight.restype = ctypes.c_longlong
    lib.poa_add_alignment.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, ctypes.c_int, _u8p, ctypes.c_int, _u32p,
    ]
    lib.poa_add_weights.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, ctypes.c_int, ctypes.c_int, _u32p,
    ]
    lib.poa_add_weights.restype = ctypes.c_int
    lib.poa_prune.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.poa_largest_subgraph.argtypes = [ctypes.c_void_p]
    lib.poa_largest_subgraph.restype = ctypes.c_void_p
    lib.poa_subgraph.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _i32p,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.poa_subgraph.restype = ctypes.c_void_p
    lib.poa_corrected.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int, _u8p]
    lib.poa_corrected.restype = ctypes.c_int
    lib.poa_consensus.argtypes = [ctypes.c_void_p, _u8p, _i32p, ctypes.c_int]
    lib.poa_consensus.restype = ctypes.c_int
    lib.poa_max_in_degree.argtypes = [ctypes.c_void_p]
    lib.poa_max_in_degree.restype = ctypes.c_int
    lib.poa_dense.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _i32p, _i32p, _i32p,
        _i32p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.poa_dense.restype = ctypes.c_int
    lib.poa_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _i32p, _i32p, _i32p,
        _i32p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.poa_edges.restype = ctypes.c_int
    lib.poa_align.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _i32p, _i32p, ctypes.c_int,
    ]
    lib.poa_align.restype = ctypes.c_int
    lib.pw_align.argtypes = [
        _u8p, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.pw_align.restype = ctypes.c_int
    lib.pw_align_cigar.argtypes = [
        _u8p, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.pw_align_cigar.restype = ctypes.c_int
    lib.poa_align_batch.argtypes = [
        ctypes.c_void_p, _u8p, _i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _i32p, _i32p,
        ctypes.c_int,
    ]
    lib.poa_align_batch.restype = ctypes.c_int
    lib.poa_realign_round.argtypes = [
        ctypes.c_void_p, _u8p, _i32p, _u8p, _u32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.poa_realign_round.restype = ctypes.c_int
    _i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.poa_save_sizes.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 5
    lib.poa_save.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i32p, _i64p, _i32p, _i32p, _i32p,
        _i32p, _i32p,
    ]
    lib.poa_load.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _i32p, _i32p,
        _i64p, _i32p, _i32p, _i32p, _i32p, _i32p,
    ]
    lib.poa_load.restype = ctypes.c_void_p
    lib.layer_sort_order.argtypes = [_i32p, ctypes.c_int, _i32p]
    lib.chain_clusters.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, _u8p, ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def chain_clusters(cl, a_s, b_sgn, k: int, lookback: int = 32):
    """Best-scoring colinear chain per diagonal cluster (minimap2-like DP,
    csrc/poagraph.cpp:chain_clusters). Returns (keep uint8[m], score f32[m])
    or None when the native lib is unavailable. Anchor extent is implicit:
    every anchor spans exactly k bases, so only query starts are needed."""
    import ctypes

    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    cl = np.ascontiguousarray(cl, dtype=np.int64)
    a_s = np.ascontiguousarray(a_s, dtype=np.int64)
    b_sgn = np.ascontiguousarray(b_sgn, dtype=np.int64)
    m = len(cl)
    keep = np.zeros(m, dtype=np.uint8)
    score = np.zeros(m, dtype=np.float32)
    lib.chain_clusters(
        cl, a_s, b_sgn, m, k, lookback, keep,
        score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return keep, score


def layer_sort_order(begins) -> "np.ndarray":
    """Layer processing order, replaying the reference's UNSTABLE std::sort
    of rank[1:] by layer begin (src/window.cpp:97,210) via the native
    libstdc++ sort — byte-parity with the reference binary depends on the
    tie order of equal-begin layers. Falls back to a stable argsort when
    the native lib is unavailable (documented parity gap; warned once so
    machines without the .so can't silently diverge from goldens)."""
    import numpy as np

    begins = np.ascontiguousarray(begins, dtype=np.int32)
    lib = get_lib()
    if lib is None:
        global _warned_sort_fallback
        if not _warned_sort_fallback:
            _warned_sort_fallback = True
            import sys

            print(
                "[vechat_tpu::native_graph] WARNING: native lib unavailable; "
                "layer_sort_order falling back to stable argsort — equal-begin "
                "layer tie order (and thus consensus bytes) may differ from "
                "the reference binary on this machine",
                file=sys.stderr,
            )
        return np.argsort(begins, kind="stable").astype(np.int32)
    out = np.empty(len(begins), dtype=np.int32)
    lib.layer_sort_order(begins, len(begins), out)
    return out


def get_lib():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            _lib = _build()
            _failed = _lib is None
    return _lib


def native_available() -> bool:
    if os.environ.get("VECHAT_NO_NATIVE"):
        return False
    return get_lib() is not None


_ALIGN_TYPE = {"nw": 0, "sw": 1, "ov": 2}


class NativePoaGraph:
    """Handle wrapper; mirrors the PoaGraph interface used by the drivers."""

    __slots__ = ("_h", "_lib")

    def __init__(self, handle=None):
        self._lib = get_lib()
        self._h = handle if handle is not None else self._lib.poa_create()

    def __del__(self):
        try:
            if self._h:
                self._lib.poa_free(self._h)
                self._h = None
        except Exception:
            pass

    # ---------------------------------------------------------------- basics

    def num_nodes(self) -> int:
        return self._lib.poa_num_nodes(self._h)

    def num_edges(self) -> int:
        return self._lib.poa_num_edges(self._h)

    def total_edge_weight(self) -> int:
        return self._lib.poa_total_edge_weight(self._h)

    def max_in_degree(self) -> int:
        return self._lib.poa_max_in_degree(self._h)

    @staticmethod
    def _split_aln(alignment: Alignment):
        if alignment:
            an = np.asarray([a for a, _ in alignment], dtype=np.int32)
            ap = np.asarray([b for _, b in alignment], dtype=np.int32)
        else:
            an = np.empty(0, dtype=np.int32)
            ap = np.empty(0, dtype=np.int32)
        return np.ascontiguousarray(an), np.ascontiguousarray(ap)

    def add_alignment(self, alignment: Alignment, codes, weights) -> None:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        weights = np.ascontiguousarray(weights, dtype=np.uint32)
        if len(codes) == 0:
            return
        if len(codes) != len(weights):
            raise ValueError("sequence and weights are of unequal size")
        an, ap = self._split_aln(alignment)
        self._lib.poa_add_alignment(
            self._h, an, ap, len(an), codes, len(codes), weights
        )

    def add_weights(self, alignment: Alignment, codes, weights) -> bool:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        weights = np.ascontiguousarray(weights, dtype=np.uint32)
        if len(codes) != len(weights):
            raise ValueError("sequence and weights are of unequal size")
        an, ap = self._split_aln(alignment)
        return bool(
            self._lib.poa_add_weights(self._h, an, ap, len(an), len(codes), weights)
        )

    def prune_graph(
        self, min_weight, min_confidence, min_support, average_weight
    ) -> None:
        self._lib.poa_prune(
            self._h, float(min_confidence), float(min_support), float(average_weight)
        )

    def largest_subgraph(self) -> "NativePoaGraph":
        return NativePoaGraph(self._lib.poa_largest_subgraph(self._h))

    def subgraph(self, begin: int, end: int) -> Tuple["NativePoaGraph", List[int]]:
        out_map = np.zeros(max(self.num_nodes(), 1), dtype=np.int32)
        out_len = ctypes.c_int(0)
        h = self._lib.poa_subgraph(
            self._h, int(begin), int(end), out_map, ctypes.byref(out_len)
        )
        return NativePoaGraph(h), [int(v) for v in out_map[: out_len.value]]

    update_alignment = staticmethod(PoaGraph.update_alignment)

    def generate_corrected_sequence(self, alignment: Alignment) -> List[int]:
        an, _ = self._split_aln(alignment)
        out = np.zeros(max(len(an), 1), dtype=np.uint8)
        k = self._lib.poa_corrected(self._h, an, len(an), out)
        return [int(v) for v in out[:k]]

    def generate_consensus_with_coverage(self) -> Tuple[List[int], List[int]]:
        cap = self.num_nodes() + 1
        out = np.zeros(cap, dtype=np.uint8)
        cov = np.zeros(cap, dtype=np.int32)
        k = self._lib.poa_consensus(self._h, out, cov, 1)
        return [int(v) for v in out[:k]], [int(v) for v in cov[:k]]

    def generate_consensus(self) -> List[int]:
        return self.generate_consensus_with_coverage()[0]

    # ------------------------------------------------------- device interface

    def dense(self, n_cap: int, p_cap: int) -> Optional[dict]:
        codes = np.zeros(n_cap, dtype=np.int32)
        preds = np.zeros(p_cap * n_cap, dtype=np.int32)
        node_id = np.zeros(n_cap, dtype=np.int32)
        sink = np.zeros(n_cap, dtype=np.int32)
        nn = ctypes.c_int(0)
        ok = self._lib.poa_dense(
            self._h, n_cap, p_cap, codes, preds, node_id, sink, ctypes.byref(nn)
        )
        if not ok:
            return None
        return dict(
            codes=codes.astype(np.uint8),
            # kernel expects [P, N]; poa_dense writes slot-major already
            preds_pn=preds.reshape(p_cap, n_cap),
            node_id=node_id,
            is_sink=sink.astype(bool),
            n_nodes=int(nn.value),
        )

    def edges_dense(self, n_cap: int, e_cap: int) -> Optional[dict]:
        """Flat edge-list export for the device graph cycle (codes by node
        id, edges in insertion = slot order). None when caps exceeded."""
        codes = np.zeros(n_cap, dtype=np.int32)
        tails = np.zeros(e_cap, dtype=np.int32)
        heads = np.zeros(e_cap, dtype=np.int32)
        weights = np.zeros(e_cap, dtype=np.int32)
        n = ctypes.c_int(0)
        m = ctypes.c_int(0)
        ok = self._lib.poa_edges(
            self._h, n_cap, e_cap, codes, tails, heads, weights,
            ctypes.byref(n), ctypes.byref(m),
        )
        if not ok:
            return None
        return dict(
            codes=codes, tails=tails, heads=heads, weights=weights,
            n_nodes=int(n.value), n_edges=int(m.value),
        )

    # -------------------------------------------------- checkpoint (cereal role)

    def save_npz(self, path: str) -> None:
        """Serialize the full graph state to an npz checkpoint (the cereal
        role, reference: vendor/spoa/include/spoa/graph.hpp:195-297)."""
        n = ctypes.c_int(0)
        m = ctypes.c_int(0)
        nlab = ctypes.c_int(0)
        nal = ctypes.c_int(0)
        nseq = ctypes.c_int(0)
        self._lib.poa_save_sizes(
            self._h,
            ctypes.byref(n),
            ctypes.byref(m),
            ctypes.byref(nlab),
            ctypes.byref(nal),
            ctypes.byref(nseq),
        )
        n, m, nlab, nal, nseq = n.value, m.value, nlab.value, nal.value, nseq.value
        codes = np.zeros(max(n, 1), np.int32)
        tails = np.zeros(max(m, 1), np.int32)
        heads = np.zeros(max(m, 1), np.int32)
        w = np.zeros(max(m, 1), np.int64)
        lab_off = np.zeros(m + 1, np.int32)
        labels = np.zeros(max(nlab, 1), np.int32)
        al_off = np.zeros(n + 1, np.int32)
        al = np.zeros(max(nal, 1), np.int32)
        seqs = np.zeros(max(nseq, 1), np.int32)
        self._lib.poa_save(
            self._h, codes, tails, heads, w, lab_off, labels, al_off, al, seqs
        )
        np.savez(
            path,
            kind=np.array(["native_poagraph_v1"]),
            n=n, m=m, nseq=nseq,
            codes=codes[:n], tails=tails[:m], heads=heads[:m], w=w[:m],
            lab_off=lab_off, labels=labels[:nlab],
            al_off=al_off, al=al[:nal], seqs=seqs[:nseq],
        )

    @classmethod
    def load_npz(cls, path: str) -> "NativePoaGraph":
        d = np.load(path if str(path).endswith(".npz") else str(path))
        n, m, nseq = int(d["n"]), int(d["m"]), int(d["nseq"])
        pad = lambda a, dt: np.ascontiguousarray(
            a if len(a) else np.zeros(1, dt), dtype=dt
        )
        h = get_lib().poa_load(
            n, m, nseq,
            pad(d["codes"], np.int32), pad(d["tails"], np.int32),
            pad(d["heads"], np.int32), pad(d["w"], np.int64),
            pad(d["lab_off"], np.int32), pad(d["labels"], np.int32),
            pad(d["al_off"], np.int32), pad(d["al"], np.int32),
            pad(d["seqs"], np.int32),
        )
        return cls(h)

    BATCH_LANES = 32  # csrc kLanes: max sequences per lane-batched DP call

    def realign_round(self, seqs, modes, weights, nw_scores, sw_scores) -> None:
        """One whole realign round in native code: lane-batch-align every
        sequence against this (structurally frozen) pruned graph, then
        AddWeights in the given order — semantically identical to the
        per-sequence align/add_weights loop (csrc poa_realign_round).
        seqs: list of uint8 code arrays; modes: 'nw'/'sw' per seq;
        weights: list of uint32 arrays aligned with seqs."""
        n = len(seqs)
        if n == 0:
            return
        seqs = [np.ascontiguousarray(s, dtype=np.uint8) for s in seqs]
        lens = np.array([len(s) for s in seqs], dtype=np.int32)
        flat = (
            np.ascontiguousarray(np.concatenate(seqs), dtype=np.uint8)
            if lens.sum()
            else np.zeros(1, dtype=np.uint8)
        )
        wflat = (
            np.ascontiguousarray(
                np.concatenate(
                    [np.ascontiguousarray(w, dtype=np.uint32) for w in weights]
                ),
                dtype=np.uint32,
            )
            if lens.sum()
            else np.zeros(1, dtype=np.uint32)
        )
        mcodes = np.array(
            [0 if m == "nw" else 1 for m in modes], dtype=np.uint8
        )
        r = self._lib.poa_realign_round(
            self._h, flat, lens, mcodes, wflat, n,
            int(nw_scores[0]), int(nw_scores[1]), int(nw_scores[2]),
            int(sw_scores[0]), int(sw_scores[1]), int(sw_scores[2]),
        )
        if r != 0:
            raise RuntimeError("native realign round failed")

    def align_host_batch(
        self, seq_list, mode: str, m: int, x: int, g: int
    ) -> List[Alignment]:
        """Lane-batched native aligner: all sequences against THIS graph in
        one SIMD-lane-parallel DP per <=32-seq chunk, byte-identical to
        per-sequence align_host (csrc align_linear_batch)."""
        n_nodes = self.num_nodes()
        out: List[Alignment] = [[] for _ in seq_list]
        if n_nodes == 0:
            return out
        live = [i for i, s in enumerate(seq_list) if len(s)]
        atype = _ALIGN_TYPE[mode]
        for off in range(0, len(live), self.BATCH_LANES):
            chunk = live[off : off + self.BATCH_LANES]
            seqs = [
                np.ascontiguousarray(seq_list[i], dtype=np.uint8)
                for i in chunk
            ]
            lens = np.array([len(s) for s in seqs], dtype=np.int32)
            flat = np.ascontiguousarray(np.concatenate(seqs), dtype=np.uint8)
            cap = n_nodes + int(lens.max()) + 2
            on = np.empty(len(chunk) * cap, dtype=np.int32)
            op = np.empty(len(chunk) * cap, dtype=np.int32)
            cnt = np.empty(len(chunk), dtype=np.int32)
            r = self._lib.poa_align_batch(
                self._h, flat, lens, len(chunk), atype, int(m), int(x),
                int(g), on, op, cnt, cap,
            )
            if r != 0:
                raise RuntimeError("native batch alignment failed")
            for li, i in enumerate(chunk):
                c = int(cnt[li])
                if c < 0:
                    raise RuntimeError("native alignment overflow")
                out[i] = list(
                    zip(
                        on[li * cap : li * cap + c].tolist(),
                        op[li * cap : li * cap + c].tolist(),
                    )
                )
        return out

    def align_host(self, seq_codes, mode: str, m: int, x: int, g: int) -> Alignment:
        """Native scalar fallback aligner (linear gap)."""
        seq_codes = np.ascontiguousarray(seq_codes, dtype=np.uint8)
        if len(seq_codes) == 0 or self.num_nodes() == 0:
            return []
        cap = self.num_nodes() + len(seq_codes) + 2
        on = np.zeros(cap, dtype=np.int32)
        op = np.zeros(cap, dtype=np.int32)
        cnt = self._lib.poa_align(
            self._h,
            seq_codes,
            len(seq_codes),
            _ALIGN_TYPE[mode],
            int(m),
            int(x),
            int(g),
            on,
            op,
            cap,
        )
        if cnt < 0:
            raise RuntimeError("native alignment overflow")
        return list(zip(on[:cnt].tolist(), op[:cnt].tolist()))


def make_graph():
    """Factory: native graph when available, Python oracle otherwise."""
    if native_available():
        return NativePoaGraph()
    return PoaGraph()
