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

F1 (`full_dp`, `poa_full_dp_kernel`). One block a window, K columns a
thread in registers (`f1_columns`, as the launcher picks them from S: 1 up
to 256 columns, 4 above; at S = 767, 6 warps). The block first stages the
window's in-slots in shared memory (int16, each row's distinct ones first
with their count) and its codes and sink flags. A row takes its
predecessor rows from registers (the row before), from nothing (row 0),
from a ring of the last `RING` = 16 rows in shared memory, or, for an
older row, from global memory, where it was stored rows ago. The in-row gap is a block-wide inclusive max-scan of
H[j] - j*g: serial over a thread's K columns, five shuffle steps over the
warp's thread totals, then each warp's carry from the totals to its left,
published in shared memory. One barrier a row: a row's ring reads come
before its barrier and its ring write after, so the slot it overwrites is
no longer read, and a row is read from the ring only after the next
row's barrier. A row's word and first slot are read a row ahead. While
it writes the rows, each thread keeps the first row where the largest of
its cells of the mode's cells (nw: the sink rows at column seq_len; ov:
the sink rows' cells; sw: every cell) rose, and at the end finds that
row's first column at the value; one block reduction gives the window's
best: (score, flat index), the largest value at the lowest flat index in
(rank, column) order, the index -1 in sw when no cell is positive. Rows
past a graph's node count and columns past its sequence are not
computed; no result reads them.

F2 (`full_walk`, `poa_full_walk_kernel`). One warp a window, from F1's
best cell. The warp stages the window's in-slots (int16), codes and read
in shared memory (4 warps a block where they fit). At each step lane s
reads slot s of the node's predecessors (P <= 32) from shared memory and
loads its two H cells, every lane the horizontal cell: one round trip to
the L2 or device memory a step. One ballot for each kind, and `__ffs`
picks the first true one in the reference's order, diagonal slots, then
vertical, then horizontal; with none true it takes diagonal slot 0, as
the reference's argmax does (a DP that F1 computed always has one true).
The chosen cell, shuffled from its lane, is the next step's h. The pairs
are written back to front, -2 before them, and the walk ends at its exact
step count (the reference steps L times with an active mask).

What bounds them on the card: F1's chain of a row (the predecessors'
shared loads, the scan's serial part and shuffles, the barrier, the
carry), N rows a window, one block a window; F2's chain of steps, one
dependent load each. Neither bytes nor operations come near the card's
rates (`chip_smoke.py` phase 9).

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
W_MAX = 1024  # F1: one block a window, at most 1024 threads at one column each
P_MAX = 32  # F2: a lane a predecessor slot
RING = 16  # F1: the last rows kept in shared memory (kRing in csrc/poa_full.cu)

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


def _best_packed_plain(H, is_sink, n_nodes, seq_len, align_type):
    """F1's second output from `_best_cell_plain`: [B, 2] int32 of (score,
    flat index), the index the rank in nw, rank * S + column - 1 in sw and
    ov, and -1 for an sw window whose best score is not positive."""
    S = H.shape[2] - 1
    max_i, max_j, score = _best_cell_plain(H, is_sink, n_nodes, seq_len, align_type)
    flat = max_i - 1 if align_type == "nw" else (max_i - 1) * S + max_j - 1
    flat = torch.where((max_i == 0) & (max_j == 0), -1, flat)
    return torch.stack([score, flat], dim=1).to(torch.int32)


def _best_cell_of(best, seq_len, align_type, S):
    """(max_i, max_j, score) [B] int64 of F1's packed best, as
    `_best_cell_plain` gives them."""
    score, flat = best[:, 0].long(), best[:, 1].long()
    if align_type == "nw":
        return flat + 1, seq_len.long(), score
    empty = flat < 0
    return (torch.where(empty, 0, flat // S + 1), torch.where(empty, 0, flat % S + 1), score)


def _walk_full_plain(H, codes, preds, node_id, is_sink, n_nodes, seq, seq_len, align_type, m, x,
                     g):
    """Plain PyTorch version of F2: the best cell, then the batched traceback
    of poa_jax.py:189-265, all walks stepping together until the last one
    ends (the reference steps L times; a finished walk changes nothing).
    Returns (pairs [B, L, 2] int32 back to front, -2 before them,
    count [B] int32, score [B] int32)."""
    best = _best_cell_plain(H, is_sink, n_nodes, seq_len, align_type)
    return _traceback_plain(H, *best, codes, preds, node_id, seq, align_type, m, x, g)


def _traceback_plain(H, max_i, max_j, score, codes, preds, node_id, seq, align_type, m, x, g):
    """The traceback of `_walk_full_plain` from a best cell (max_i, max_j,
    score; both indices 0: no walk)."""
    B, N, P = preds.shape
    S = seq.shape[1]
    L = N + S + 1
    dev = H.device
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

_DP_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_WALK_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_PLAN_OUT = ctypes.POINTER(ctypes.c_int)


def _lib():
    lib = _build.get_lib("poa_full")
    if lib.poa_full_dp_launch.argtypes is None:
        lib.poa_full_dp_launch.argtypes = _DP_ARGS
        lib.poa_full_dp_launch.restype = ctypes.c_int
        lib.poa_full_walk_launch.argtypes = _WALK_ARGS
        lib.poa_full_walk_launch.restype = ctypes.c_int
        lib.poa_full_dp_plan.argtypes = [ctypes.c_int] * 3 + [_PLAN_OUT]
        lib.poa_full_walk_plan.argtypes = [ctypes.c_int] * 3 + [_PLAN_OUT]
        lib.poa_full_attrs.argtypes = [ctypes.c_int] * 3 + [_PLAN_OUT]
    return lib


def f1_columns(S: int) -> int:
    """F1's columns a thread at S, as its launcher picks them (`dp_columns`
    in the source): 1 up to 256 columns (S = 63, 127, 255: 2, 4 and 8
    warps), 4 above (S = 511: 4 warps; 767: 6; 1023: 8)."""
    return 1 if S + 1 <= 256 else 4


def dp_plan(N, P, S):
    """(threads, dynamic shared bytes) of F1 at this shape; threads 0 where
    it cannot launch (the shared memory of a block exceeded). Needs the
    built library."""
    smem = ctypes.c_int(0)
    threads = _lib().poa_full_dp_plan(N, P, S, ctypes.byref(smem))
    return threads, smem.value


def walk_plan(N, P, S):
    """(warps a block, dynamic shared bytes) of F2 at this shape; 0 warps
    where one window's staging exceeds a block's shared memory."""
    smem = ctypes.c_int(0)
    warps = _lib().poa_full_walk_plan(N, P, S, ctypes.byref(smem))
    return warps, smem.value


def kernel_attrs(which: str, align_type: str, S: int = 767) -> Dict[str, int]:
    """Registers a thread, static and local memory of F1 ("dp", the build
    its launcher takes at S) or F2 ("walk") in `align_type`, from
    cudaFuncGetAttributes."""
    out = (ctypes.c_int * 3)()
    rc = _lib().poa_full_attrs(0 if which == "dp" else 1, MODES[align_type], S, out)
    _build.check(_lib(), rc, f"poa_full_{which} attributes")
    return dict(registers=out[0], static_smem_bytes=out[1], local_bytes=out[2])


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


def full_dp(codes, preds, is_sink, n_nodes, seq, seq_len, align_type, m, x, g):
    """F1: (H [B, N + 1, S + 1] int32, best [B, 2] int32) of each window
    (codes uint8 [B, N], preds int32 [B, N, P], is_sink uint8 [B, N],
    n_nodes and seq_len int32 [B], seq uint8 [B, S], on one device). best
    is (score, flat index) of the first maximal cell in (rank, column)
    order among the mode's cells, the index -1 in sw when the score is not
    positive (`_best_packed_plain`). On the card H holds rows 0..n_nodes
    at columns 0..seq_len (a thread may also store its columns past
    seq_len; nothing reads them). CPU tensors take the plain version;
    CUDA tensors launch F1 or raise."""
    dev = seq.device
    if dev.type == "cpu":
        H = _dp_full_plain(codes, preds, n_nodes, seq, seq_len, align_type, m, x, g)
        return H, _best_packed_plain(H, is_sink, n_nodes, seq_len, align_type)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N, P = preds.shape
    S = seq.shape[1]
    _check_card(dev, codes=(codes, torch.uint8), preds=(preds, torch.int32),
                is_sink=(is_sink, torch.uint8), n_nodes=(n_nodes, torch.int32),
                seq=(seq, torch.uint8), seq_len=(seq_len, torch.int32))
    if S + 1 > W_MAX:
        raise ValueError(f"F1 takes S + 1 <= {W_MAX} columns, got S={S}")
    H = torch.empty((B, N + 1, S + 1), dtype=torch.int32, device=dev)
    best = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B:
        launch_dp(codes, preds, is_sink, n_nodes, seq, seq_len, H, best, align_type, m, x, g)
    return H, best


def launch_dp(codes, preds, is_sink, n_nodes, seq, seq_len, H, best, align_type, m, x, g):
    """F1 alone on `full_dp`'s buffers, all on the card (`chip_smoke.py`
    times it apart from the wrapper). Raises where the launcher refuses
    the shape (`dp_plan`)."""
    B, N, P = preds.shape
    S = seq.shape[1]
    stream = torch.cuda.current_stream(seq.device).cuda_stream
    with torch.cuda.device(seq.device):
        rc = _lib().poa_full_dp_launch(
            codes.data_ptr(), preds.data_ptr(), is_sink.data_ptr(), n_nodes.data_ptr(),
            seq.data_ptr(), seq_len.data_ptr(), H.data_ptr(), best.data_ptr(), B, N, P, S,
            MODES[align_type], m, x, g, stream)
    _build.check(_lib(), rc, "poa_full_dp")
    _build.LAUNCHES["poa_full_dp"] += 1
    shape = (B, N, S, P)
    _build.FULL_SHAPES[shape] = _build.FULL_SHAPES.get(shape, 0) + 1


def full_walk(H, best, codes, preds, node_id, n_nodes, seq, seq_len, align_type, m, x, g):
    """F2 on F1's H and best and the inputs of `full_dp` (node_id int32
    [B, N] besides): (pairs [B, L, 2] int32 back to front, -2 before them,
    L = N + S + 1; count [B]; score [B]). CPU tensors take the plain
    version; CUDA tensors launch F2 or raise."""
    dev = H.device
    if dev.type == "cpu":
        S = seq.shape[1]
        return _traceback_plain(H, *_best_cell_of(best, seq_len, align_type, S), codes, preds,
                                node_id, seq, align_type, m, x, g)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N, P = preds.shape
    S = seq.shape[1]
    _check_card(dev, H=(H, torch.int32), best=(best, torch.int32), codes=(codes, torch.uint8),
                preds=(preds, torch.int32), node_id=(node_id, torch.int32),
                n_nodes=(n_nodes, torch.int32), seq=(seq, torch.uint8),
                seq_len=(seq_len, torch.int32))
    if H.shape != (B, N + 1, S + 1) or best.shape != (B, 2):
        raise ValueError(f"H has shape {tuple(H.shape)} and best {tuple(best.shape)}, expected "
                         f"{(B, N + 1, S + 1)} and {(B, 2)}")
    if P > P_MAX:
        raise ValueError(f"F2 takes P <= {P_MAX} predecessor slots, got {P}")
    pairs = torch.empty((B, N + S + 1, 2), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    score = torch.empty_like(count)
    if B:
        launch_walk(H, best, codes, preds, node_id, n_nodes, seq, seq_len, pairs, count, score,
                    align_type, m, x, g)
    return pairs, count, score


def launch_walk(H, best, codes, preds, node_id, n_nodes, seq, seq_len, pairs, count, score,
                align_type, m, x, g):
    """F2 alone on `full_walk`'s buffers, all on the card. The kernel writes
    every element of its outputs. Raises where the launcher refuses the
    shape (`walk_plan`)."""
    B, N, P = preds.shape
    S = seq.shape[1]
    stream = torch.cuda.current_stream(H.device).cuda_stream
    with torch.cuda.device(H.device):
        rc = _lib().poa_full_walk_launch(
            H.data_ptr(), best.data_ptr(), codes.data_ptr(), preds.data_ptr(),
            node_id.data_ptr(), n_nodes.data_ptr(), seq.data_ptr(), seq_len.data_ptr(),
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
    H, best = full_dp(codes, preds, is_sink, n_nodes, seq, seq_len, align_type, m, x, g)
    return full_walk(H, best, codes, preds, node_id, n_nodes, seq, seq_len, align_type, m, x, g)


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
