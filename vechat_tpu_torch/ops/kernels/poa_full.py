"""Full-matrix linear-gap sequence-to-graph DP with its traceback (B10), on
two CUDA kernels in `csrc/poa_full.cu`, their plain PyTorch versions, and
the batch aligner backend over them (`--backend full`).

Counterpart of `vechat_tpu/ops/kernels/poa_jax.py`: `poa_align_batch_device`
(plain XLA there: a `fori_loop` over the DP rows and a batched traceback
`fori_loop`) and `JaxAlignerBackend`, which the reference's CLIs offer as
`--backend jax`. It computes what K1 and the walks compute (`poa_linear.py`),
in another layout: one sequence a graph, the whole int32 H matrix
[B, N + 1, S + 1] kept, the walk reading H itself instead of direction
codes. Inputs are packed by `dense.graph_to_dense`, the same layout as the
JAX package's.

F1 (`full_dp`, `poa_full_dp_kernel`). One block a window, one thread a
column (W = S + 1 rounded up to a warp, at most 1024: 24 warps at the top
bucket S = 767). A row reads its predecessor rows of H from global memory
(the L2, mostly), takes the diagonal and vertical candidates, then the
in-row gap as a block-wide inclusive max-scan of H[j] - j*g: five shuffle
steps in each warp, then each warp's carry from the warps to its left,
published in shared memory. The row just computed stays in registers
(the thread's column and, by a shuffle or the carry, its left neighbour),
so a row whose predecessor is the row before it reads nothing from memory,
and the block passes one barrier a row: a row's stores are read by a later
row only after the next row's barrier. Rows past a graph's node count and
columns past its sequence are neither computed nor written; no result
reads them.

F2 (`full_walk`, `poa_full_walk_kernel`). One warp a window. The warp first
finds the best cell, the first maximal one in (rank, column) order among
the mode's cells (nw: the sink rows at column seq_len; ov: the sink rows'
cells; sw: every cell), each lane keeping its own first maximum and the
warp reducing to the largest value at the lowest flat index. Then the
serial walk: at each step lane s tests diagonal slot s and vertical slot s
of the node's predecessors (P <= 32), one ballot for each kind, and `__ffs`
picks the first true one in the reference's order, diagonal slots, then
vertical, then horizontal; with none true it takes diagonal slot 0, as the
reference's argmax does (a DP that F1 computed always has one true). The
pairs are written back to front, -2 before them, and the walk ends at its
exact step count (the reference steps L times with an active mask).

What bounds them on the card: F1's chain of a row (the predecessor rows'
loads, the scan's shuffles, the barrier), N rows a window, one block a
window, so a batch of 64 windows fills 64 of the 132 SMs; F2's chain of
dependent loads a step (the node's predecessors, then their H cells).
Neither bytes nor operations come near the card's rates (`chip_smoke.py`
phase 9).

On a CPU tensor each wrapper runs its plain version (the tests, and
`make_backend("full", ..., device="cpu")`); on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph_align import LinearAligner
from ..poagraph import Alignment, PoaGraph
from . import _build
from .backend import DeviceProgramCounters
from .dense import bucket, graph_to_dense

NEG = -(2**30)
MODES = {"nw": 0, "sw": 1, "ov": 2}
W_MAX = 1024  # F1: a thread a column, one block a window
P_MAX = 32  # F2: a lane a predecessor slot

# B10's own buckets (poa_jax.py:270-272) and its cells a dispatch (:346)
N_BUCKETS = (64, 128, 256, 512, 1024, 1536, 2048)
S_BUCKETS = (63, 127, 255, 511, 767)
P_BUCKETS = (4, 8, 16)
MAX_CELLS_PER_CALL = 1 << 28


# ------------------------------------------------------------ plain versions


def _dp_full_plain(codes, preds, n_nodes, seq, seq_len, align_type, m, x, g):
    """Plain PyTorch version of F1: the row loop of poa_jax.py:135-153 over
    every row. Returns H [B, N + 1, S + 1] int32."""
    B, N, P = preds.shape
    S = seq.shape[1]
    W = S + 1
    dev = seq.device
    jg = torch.arange(W, dtype=torch.int32, device=dev) * g
    H = torch.zeros((B, N + 1, W), dtype=torch.int32, device=dev)
    if align_type != "sw":
        H[:, 0] = jg
    seq32 = seq.to(torch.int32)
    codes32 = codes.to(torch.int32)
    preds64 = preds.long()
    for n in range(N):
        prof = torch.where(seq32 == codes32[:, n, None], m, x).to(torch.int32)
        pred_rows = torch.gather(H, 1, preds64[:, n, :, None].expand(B, P, W))
        diag = pred_rows[:, :, :-1] + prof[:, None, :]
        vert = pred_rows[:, :, 1:] + g
        cand = torch.maximum(diag, vert).amax(dim=1)
        if align_type == "nw":
            h0 = pred_rows[:, :, 0].amax(dim=1) + g
        else:
            h0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        full = torch.cat([h0[:, None], cand], dim=1)
        run = torch.cummax(full - jg, dim=1).values + jg
        if align_type == "sw":
            run = run.clamp_min(0)
        H[:, n + 1] = run
    return H


def _best_cell_plain(H, is_sink, n_nodes, seq_len, align_type):
    """The first maximal cell in (rank, column) order among the mode's
    cells (poa_jax.py:155-186): (max_i, max_j, max_score) [B] int64, both
    indices 0 for an sw alignment whose best score is not positive."""
    B, N1, W = H.shape
    N, S = N1 - 1, W - 1
    dev = H.device
    row_valid = torch.arange(N, device=dev)[None, :] < n_nodes.long()[:, None]
    col_valid = torch.arange(1, W, device=dev)[None, :] <= seq_len.long()[:, None]
    sink = is_sink.bool()
    if align_type == "nw":
        last = torch.gather(H[:, 1:, :], 2, seq_len.long()[:, None, None].expand(B, N, 1))[..., 0]
        vals = torch.where(row_valid & sink, last, NEG)
        return vals.argmax(dim=1) + 1, seq_len.long(), vals.amax(dim=1).long()
    mask = row_valid[:, :, None] & col_valid[:, None, :]
    if align_type == "ov":
        mask = mask & sink[:, :, None]
    vals = torch.where(mask, H[:, 1:, 1:], NEG).reshape(B, -1)
    flat = vals.argmax(dim=1)
    max_i, max_j = flat // S + 1, flat % S + 1
    score = vals.amax(dim=1).long()
    if align_type == "sw":
        empty = score <= 0  # the reference keeps a best cell only above 0
        max_i = torch.where(empty, 0, max_i)
        max_j = torch.where(empty, 0, max_j)
    return max_i, max_j, score


def _walk_full_plain(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type, m, x,
                     g):
    """Plain PyTorch version of F2: the best cell, then the batched traceback
    of poa_jax.py:189-265, all walks stepping together until the last one
    ends (the reference steps L times; a finished walk changes nothing).
    Returns (pairs [B, L, 2] int32 back to front, -2 before them,
    count [B] int32, score [B] int32)."""
    B, N, P = preds.shape
    S = seq.shape[1]
    L = N + S + 1
    dev = H.device
    max_i, max_j, score = _best_cell_plain(H, is_sink, n_nodes, seq_len, align_type)
    bidx = torch.arange(B, device=dev)
    bcol = bidx[:, None]
    codes64, seq64, preds64, nid64 = codes.long(), seq.long(), preds.long(), node_id.long()

    def alive(i, j):
        if align_type == "sw":
            return H[bidx, i, j] != 0
        if align_type == "nw":
            return ~((i == 0) & (j == 0))
        return ~((i == 0) | (j == 0))

    start_empty = (max_i == 0) & (max_j == 0)
    i, j = max_i.clone(), max_j.clone()
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    active = alive(i, j) & ~start_empty
    pairs = torch.full((B, L, 2), -2, dtype=torch.int32, device=dev)
    for step in range(L):
        if step % 64 == 0 and not bool(active.any()):
            break
        h_ij = H[bidx, i, j]
        node = (i - 1).clamp_min(0)
        jm1 = (j - 1).clamp_min(0)
        match = torch.where(seq64[bidx, jm1] == codes64[bidx, node], m, x)
        p_idx = preds64[bidx, node]  # [B, P]
        diag_ok = ((i != 0) & (j != 0))[:, None] & (h_ij[:, None] == H[bcol, p_idx, jm1[:, None]]
                                                    + match[:, None])
        vert_ok = (i != 0)[:, None] & (h_ij[:, None] == H[bcol, p_idx, j[:, None]] + g)
        horiz_ok = (j != 0) & (h_ij == H[bidx, i, jm1] + g)
        cands = torch.cat([diag_ok, vert_ok, horiz_ok[:, None]], dim=1)
        choice = cands.to(torch.uint8).argmax(dim=1)  # the first true; 0 with none
        is_diag = choice < P
        is_vert = (choice >= P) & (choice < 2 * P)
        slot = torch.where(is_diag, choice, choice - P).clamp_max(P - 1)
        pred_row = torch.gather(p_idx, 1, slot[:, None])[:, 0]
        prev_i = torch.where(is_diag | is_vert, pred_row, i)
        prev_j = torch.where(is_diag | ~is_vert, j - 1, j)
        pair = torch.stack([torch.where(i == prev_i, -1, nid64[bidx, node]),
                            torch.where(j == prev_j, -1, j - 1)], dim=1)
        pos = L - 1 - k
        pairs[bidx[active], pos[active]] = pair[active].to(torch.int32)
        i = torch.where(active, prev_i, i)
        j = torch.where(active, prev_j, j)
        k = torch.where(active, k + 1, k)
        active = active & alive(i, j)
    count = torch.where(start_empty, 0, k)
    return pairs, count.to(torch.int32), score.to(torch.int32)


def _full_plain(codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type, m, x, g):
    """Plain PyTorch version of B10 (F1 then F2) on tensors of one device:
    `poa_align_batch_full`'s outputs, equal to the JAX package's."""
    H = _dp_full_plain(codes, preds, n_nodes, seq, seq_len, align_type, m, x, g)
    return _walk_full_plain(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type,
                            m, x, g)


# ----------------------------------------------------------------- kernels

_DP_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_WALK_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("poa_full")
    if lib.poa_full_dp_launch.argtypes is None:
        lib.poa_full_dp_launch.argtypes = _DP_ARGS
        lib.poa_full_dp_launch.restype = ctypes.c_int
        lib.poa_full_walk_launch.argtypes = _WALK_ARGS
        lib.poa_full_walk_launch.restype = ctypes.c_int
    return lib


def _inputs(codes, preds, node_id, is_sink, n_nodes, seq, seq_len, device):
    """The seven inputs on `device`: codes, seq and is_sink as uint8, the
    rest int32, all contiguous; raises on shapes that do not agree."""

    def t(a, dtype):
        a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        return a.to(device=device, dtype=dtype).contiguous()

    out = (t(codes, torch.uint8), t(preds, torch.int32), t(node_id, torch.int32),
           t(is_sink, torch.uint8), t(n_nodes, torch.int32), t(seq, torch.uint8),
           t(seq_len, torch.int32))
    codes, preds, node_id, is_sink, n_nodes, seq, seq_len = out
    if preds.dim() != 3 or seq.dim() != 2:
        raise ValueError("B10 takes preds [B, N, P] and seq [B, S]")
    B, N, _ = preds.shape
    if (codes.shape != (B, N) or node_id.shape != (B, N) or is_sink.shape != (B, N)
            or n_nodes.shape != (B,) or seq.shape[0] != B or seq_len.shape != (B,)):
        raise ValueError("B10 takes codes, node_id and is_sink [B, N], n_nodes and seq_len [B]")
    return out


def _check_card(dev, **tensors):
    """Raise unless each (tensor, dtype) of `tensors` is a contiguous tensor
    of that dtype on `dev`: what the kernels read."""
    for name, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")


def full_dp(codes, preds, n_nodes, seq, seq_len, align_type, m, x, g):
    """F1: H [B, N + 1, S + 1] int32 of each window (codes uint8 [B, N], preds
    int32 [B, N, P], n_nodes and seq_len int32 [B], seq uint8 [B, S], on one
    device). On the card only rows 0..n_nodes and columns 0..seq_len are
    written. CPU tensors take the plain version; CUDA tensors launch F1 or
    raise."""
    dev = seq.device
    if dev.type == "cpu":
        return _dp_full_plain(codes, preds, n_nodes, seq, seq_len, align_type, m, x, g)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N, P = preds.shape
    S = seq.shape[1]
    _check_card(dev, codes=(codes, torch.uint8), preds=(preds, torch.int32),
                n_nodes=(n_nodes, torch.int32), seq=(seq, torch.uint8),
                seq_len=(seq_len, torch.int32))
    if S + 1 > W_MAX:
        raise ValueError(f"F1 takes S + 1 <= {W_MAX} columns, got S={S}")
    H = torch.empty((B, N + 1, S + 1), dtype=torch.int32, device=dev)
    if B:
        launch_dp(codes, preds, n_nodes, seq, seq_len, H, align_type, m, x, g)
    return H


def launch_dp(codes, preds, n_nodes, seq, seq_len, H, align_type, m, x, g):
    """F1 alone on `full_dp`'s buffers, all on the card (`chip_smoke.py`
    times it apart from the wrapper)."""
    B, N, P = preds.shape
    S = seq.shape[1]
    stream = torch.cuda.current_stream(seq.device).cuda_stream
    with torch.cuda.device(seq.device):
        rc = _lib().poa_full_dp_launch(
            codes.data_ptr(), preds.data_ptr(), n_nodes.data_ptr(), seq.data_ptr(),
            seq_len.data_ptr(), H.data_ptr(), B, N, P, S, MODES[align_type], m, x, g, stream)
    _build.check(_lib(), rc, "poa_full_dp")
    _build.LAUNCHES["poa_full_dp"] += 1
    shape = (B, N, S, P)
    _build.FULL_SHAPES[shape] = _build.FULL_SHAPES.get(shape, 0) + 1


def full_walk(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type, m, x, g):
    """F2 on F1's H and the inputs of `full_dp` (node_id int32 and is_sink
    uint8 [B, N] besides): (pairs [B, L, 2] int32 back to front, -2 before
    them, L = N + S + 1; count [B]; score [B]). CPU tensors take the plain
    version; CUDA tensors launch F2 or raise."""
    dev = H.device
    if dev.type == "cpu":
        return _walk_full_plain(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len,
                                align_type, m, x, g)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N, P = preds.shape
    S = seq.shape[1]
    _check_card(dev, H=(H, torch.int32), codes=(codes, torch.uint8), preds=(preds, torch.int32),
                node_id=(node_id, torch.int32), is_sink=(is_sink, torch.uint8),
                n_nodes=(n_nodes, torch.int32), seq=(seq, torch.uint8),
                seq_len=(seq_len, torch.int32))
    if H.shape != (B, N + 1, S + 1):
        raise ValueError(f"H has shape {tuple(H.shape)}, expected {(B, N + 1, S + 1)}")
    if P > P_MAX:
        raise ValueError(f"F2 takes P <= {P_MAX} predecessor slots, got {P}")
    pairs = torch.empty((B, N + S + 1, 2), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    score = torch.empty_like(count)
    if B:
        launch_walk(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, pairs, count, score,
                    align_type, m, x, g)
    return pairs, count, score


def launch_walk(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, pairs, count, score,
                align_type, m, x, g):
    """F2 alone on `full_walk`'s buffers, all on the card. The kernel writes
    every element of its outputs."""
    B, N, P = preds.shape
    S = seq.shape[1]
    stream = torch.cuda.current_stream(H.device).cuda_stream
    with torch.cuda.device(H.device):
        rc = _lib().poa_full_walk_launch(
            H.data_ptr(), codes.data_ptr(), preds.data_ptr(), node_id.data_ptr(),
            is_sink.data_ptr(), n_nodes.data_ptr(), seq.data_ptr(), seq_len.data_ptr(),
            pairs.data_ptr(), count.data_ptr(), score.data_ptr(), B, N, P, S,
            MODES[align_type], m, x, g, stream)
    _build.check(_lib(), rc, "poa_full_walk")
    _build.LAUNCHES["poa_full_walk"] += 1


def poa_align_batch_full(codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type: str,
                         m: int, x: int, g: int, device="cuda"):
    """B10, the argument layout and outputs of `poa_align_batch_device`
    (poa_jax.py:102-117): codes uint8 [B, N], preds int32 [B, N, P] (DP
    rows, rank + 1; 0 the virtual row; padding slots repeat slot 0),
    node_id [B, N], is_sink [B, N], n_nodes [B], seq uint8 [B, S] (0xFF
    padding), seq_len [B]; numpy arrays or tensors. Each window needs
    n_nodes >= 1, a sink among its nodes and seq_len >= 1 (the backend's
    items; rows and columns past them are skipped on the card).

    Returns (pairs [B, L, 2] int32, count [B], score [B]) with L = N + S + 1:
    rows (node id | -1, sequence position | -1) in forward order from index
    L - count, -2 before them. Tensors on `device`, the card unless the
    caller asks for "cpu" (the plain versions); without a GPU "cuda"
    raises."""
    if align_type not in MODES:
        raise ValueError(f"unknown align_type {align_type!r}")
    dev = _build.resolve_device(device)
    codes, preds, node_id, is_sink, n_nodes, seq, seq_len = _inputs(
        codes, preds, node_id, is_sink, n_nodes, seq, seq_len, dev)
    H = full_dp(codes, preds, n_nodes, seq, seq_len, align_type, m, x, g)
    return full_walk(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type, m, x, g)


# ------------------------------------------------------------------ backend


class FullAlignerBackend(DeviceProgramCounters):
    """Batch aligner on B10 (F1 and F2) on one device, the counterpart of
    `JaxAlignerBackend` (poa_jax.py:283-409). Items are grouped by B10's
    (mode, node, sequence, in-degree) buckets and cut into dispatches of at
    most `MAX_CELLS_PER_CALL` DP cells, one launch of each kernel a
    dispatch; a batch is not padded to the reference's `B_SIZES`. An item
    past a bucket, or whose graph `graph_to_dense` refuses, goes to the host
    engine and is counted in `fallbacks`; an empty item gives []. It has no
    `edit_align_batch`, so overlap pairs take the host route, as with the
    reference backend. With VECHAT_DEVICE_CYCLE/BUILD/LINEAR=1 the device
    programs run on `self.device` with their own DP (K1 and the dense walk),
    as they do with `TorchAlignerBackend`."""

    supports_graph_cycle = True

    def __init__(self, match: int, mismatch: int, gap: int, device="cuda"):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        dev = _build.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._host_nw = LinearAligner("nw", match, mismatch, gap)
        self._host_sw = LinearAligner("sw", 3, -5, -4)  # src/window.cpp:326
        self.fallbacks = 0
        self.device_alignments = 0
        self.cell_updates = 0
        self.t_pack = 0.0  # buckets, dense conversion, batch arrays
        self.t_device = 0.0  # upload, both kernels, the outputs' fetch
        self.t_decode = 0.0  # alignment lists
        self.t_host_fb = 0.0  # host-route alignments
        self.n_dispatches = 0
        self.n_calls = 0
        self._init_program_counters()

    def counters(self) -> Dict[str, float]:
        """Device and host-route counts, the device programs' counts and
        seconds, and the launches of every kernel in this process."""
        out = dict(device_alignments=self.device_alignments, fallbacks=self.fallbacks,
                   cell_updates=self.cell_updates, n_dispatches=self.n_dispatches)
        out.update(self.program_counters())
        out.update({f"launches_{k}": v for k, v in _build.LAUNCHES.items()})
        return out

    def _scores(self, mode: str) -> Tuple[int, int, int]:
        if mode == "nw":
            return self.match, self.mismatch, self.gap
        return 3, -5, -4

    def _host_align(self, codes, graph, mode):
        t0 = time.perf_counter()
        self.fallbacks += 1
        if hasattr(graph, "align_host"):
            out = graph.align_host(codes, mode, *self._scores(mode))
        else:
            eng = self._host_nw if mode == "nw" else self._host_sw
            out = eng.align(codes, graph)
        self.t_host_fb += time.perf_counter() - t0
        return out

    def align_batch(self, items: Sequence[Tuple[np.ndarray, PoaGraph, str]]) -> List[Alignment]:
        self.n_calls += 1
        results: List[Optional[Alignment]] = [None] * len(items)
        groups: Dict[Tuple[str, int, int, int], List[int]] = {}
        for idx, (codes, graph, mode) in enumerate(items):
            nn, sl = graph.num_nodes(), len(codes)
            if nn == 0 or sl == 0:
                results[idx] = []
                continue
            if hasattr(graph, "max_in_degree"):
                max_deg = graph.max_in_degree()
            else:
                max_deg = max((len(ins) for ins in graph.inedges), default=0)
            key = (mode, bucket(nn, N_BUCKETS), bucket(sl, S_BUCKETS),
                   bucket(max(max_deg, 1), P_BUCKETS))
            if None in key:
                results[idx] = self._host_align(codes, graph, mode)
                continue
            groups.setdefault(key, []).append(idx)
        for (mode, nb, sb, pb), idxs in groups.items():
            max_b = max(1, min(256, MAX_CELLS_PER_CALL // ((nb + 1) * (sb + 1))))
            for off in range(0, len(idxs), max_b):
                self._run_chunk(items, results, idxs[off : off + max_b], mode, nb, sb, pb)
        return results  # type: ignore[return-value]

    def _run_chunk(self, items, results, idxs, mode, nb, sb, pb):
        t0 = time.perf_counter()
        packed = []
        for idx in idxs:
            codes, graph, _ = items[idx]
            d = graph_to_dense(graph, nb, pb)
            if d is None:
                results[idx] = self._host_align(codes, graph, mode)
                continue
            packed.append((idx, d, codes))
        if not packed:
            return
        B = len(packed)
        codes_arr = np.zeros((B, nb), np.uint8)
        preds_arr = np.zeros((B, nb, pb), np.int32)
        nid_arr = np.zeros((B, nb), np.int32)
        sink_arr = np.ones((B, nb), bool)
        nn_arr = np.ones(B, np.int32)
        seq_arr = np.full((B, sb), 0xFF, np.uint8)
        sl_arr = np.ones(B, np.int32)
        for bi, (_, d, codes) in enumerate(packed):
            codes_arr[bi] = d["codes"]
            preds_arr[bi] = d["preds"]
            nid_arr[bi] = d["node_id"]
            sink_arr[bi] = d["is_sink"]
            nn_arr[bi] = d["n_nodes"]
            seq_arr[bi, : len(codes)] = codes
            sl_arr[bi] = len(codes)
        self.t_pack += time.perf_counter() - t0

        t0 = time.perf_counter()
        pairs, count, _ = poa_align_batch_full(codes_arr, preds_arr, nid_arr, sink_arr, nn_arr,
                                               seq_arr, sl_arr, mode, *self._scores(mode),
                                               device=self.device)
        count = count.cpu().tolist()
        pairs = pairs.cpu().numpy()
        self.t_device += time.perf_counter() - t0
        self.n_dispatches += 1

        t0 = time.perf_counter()
        L = pairs.shape[1]
        for bi, (idx, _, _) in enumerate(packed):
            c = count[bi]
            results[idx] = list(zip(pairs[bi, L - c :, 0].tolist(), pairs[bi, L - c :, 1].tolist()))
            self.device_alignments += 1
            self.cell_updates += int(nn_arr[bi]) * int(sl_arr[bi])
        self.t_decode += time.perf_counter() - t0
