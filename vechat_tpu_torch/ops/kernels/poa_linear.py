"""Linear-gap sequence-to-graph DP (K1) and its traceback walks, run-length
(K2) and dense: CUDA kernels in `csrc/poa_linear.cu`, their plain PyTorch
versions, and the host helpers that decode the walks.

Replaces `vechat_tpu/ops/kernels/poa_pallas.py`: `_dp_kernel` (the Pallas
kernel behind `_poa_dp_pallas`), `_traceback_walk_rle` and `_traceback_walk`.
The direction codes, the run-marker scheme, the best-cell pack and the
run-header layout are the reference's, bit for bit, so `runs_to_pairs_np`
decodes both.

K1 (`poa_dp`). One warp per (window graph b, sequence d), looping over DP
rows 1..n_nodes; thread t of the warp owns the W/32 contiguous lanes
[t*W/32, (t+1)*W/32) and keeps them in registers (W a multiple of 32, at
most 1024). Each row takes one packed max over the row's in-edge candidates
(``value << SH | prio << 9 | delta``, so the max also picks the move and
the predecessor row), then the in-row gap as a max-plus scan: serial over a
thread's lanes, then five shuffle steps across the warp. This replaced one
block per (b, d) with a thread per lane, whose every row waited at three
block barriers behind dependent loads of the graph row: the warp needs one
`__syncwarp` a row, fetches the graph rows 32 at a time a batch ahead, and
does the in-edge maxes with Hopper's add-then-max (DPX) instructions. What
bounds it now is the latency of each row's chain of dependent steps (ring
load, the two scans, ring store): the main path's launches give about one
warp to each scheduler of the card, and twice the warps take only 1.1-1.2x
the time (`k1_probe.py` at the repository root). A block holds up to
`K1_WARPS_MAX` warps (sequences) of one window. The int16 H ring takes one
slice per warp in shared memory when a block's slices fit, else a global
scratch ring; direction rows are staged per warp and written in 16-byte
pieces (`dp_launch_plan` holds this arithmetic).

K2 (`traceback_walk_rle`). One warp per walk. It replaced one thread per
walk whose every step was a dependent device-memory load of one direction
code. The warp stages a tile of its walk's codes in shared memory (64 rows
by 64 columns ending at the walk's cell, copied with cp.async, every piece
in flight at once), steps from there, and restages only when the walk
leaves the tile through its top or left edge or jumps to a predecessor
above it. A marked diagonal or vertical run is jumped in one step; each
step writes one packed header into ``runs[step, walk]``. Bound by the
chain of dependent steps and one device-memory latency a tile.

The expansion (`expand_walk_pairs`). The headers of every walk expanded to
(node id, position) pairs, front to back, in one flat int16 buffer: the
card's counterpart of the host decode of the JAX backend
(`runs_to_pairs_np` then `ranks_to_node_ids_np`, kept below for the tests).
One warp a walk: a shuffle scan of 32 headers' run lengths, then the lanes
take the pairs in turn, so a long run spreads over the warp.

The dense walk (`traceback_walk_dense`), which the sharded route of
`parallel/mesh.py` uses: the pairs back to front in int16 [B, D, L] rows,
-2 before them. One warp a walk, stepping with K2's tile cursor, so a
marked run is one step of the chain (its pairs are arithmetic, the ones
the unit walk of the plain version steps through). The warp keeps 32 run
headers in its lanes and expands them as the expansion does, the lanes
looking up node ids off the chain; it cuts the last run where the walk
reaches L pairs, and writes its rows' -2 columns itself. It needs K2's
16-byte rows (W % 8 == 0).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

NEGV = -(2**30)  # combo-domain -inf (decodes below any fits_int16 value)
NEG16 = -16000  # value-domain -inf for int16-stored H rows
TIE = 4096  # row-tie field width in the packed best-cell combo
DELTA_BITS = 9  # predecessor row-distance field; ring must stay < 2**9
DMASK = (1 << DELTA_BITS) - 1
MODES = {"nw": 0, "sw": 1, "ov": 2}

# RLE run-header field layout (packed int32, nonnegative):
#   bits [19, 31): pn0 + 2   (first pair's rank field; -1 = insertion)
#   bits [9, 19):  pp0 + 2   (first pair's position field; -1 = deletion)
#   bits [0, 9):   r          (pairs in this step; 0 = inactive step)
# Pair k of a step (k in [0, r)) is (pn0 - k*dn, pp0 - k*dp) with dn = 1,
# dp = (pp0 >= 0) for r > 1 (arithmetic runs); r == 1 steps use the header
# pair verbatim. Headers are written in walk order (back-to-front pairs).
RUN_R_BITS = 9
RUN_PP_BITS = 10
RUN_PN_SHIFT = RUN_R_BITS + RUN_PP_BITS

# largest shared-memory H ring a block of the affine and convex DPs (K5, K6)
# takes (bytes); larger rings live in a global scratch ring
SMEM_RING_MAX = 200 * 1024

# K1's launch: warps (sequences of one window) per block, and the shared
# memory a block may take (227 KB on Hopper)
K1_WARPS_MAX = 4
SMEM_MAX = 227 * 1024


def dp_launch_plan(B: int, D: int, W: int, R: int, P: int) -> dict:
    """K1's launch for B windows of D sequences, width W, an H ring of R
    rows and P in-edge slots: lanes per thread, in-edge slots fetched ahead
    in registers (8 or 16; slots past 16 are read in the row loop), warps
    (sequences) per block, grid (B, groups of D), threads, shared-memory
    bytes of a block, and whether the ring lies in shared memory. Each warp
    takes a [2, W] int16 stage for its direction rows and, in shared memory,
    its [R+1, W] int16 ring; the ring goes to global memory when the slices
    of a block of min(D, K1_WARPS_MAX) warps do not fit, so that a block
    keeps its warps (fewer would leave most of each SM's schedulers idle).
    Raises on a W that is not a multiple of 32 in [32, 1024]."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError(f"W={W} must be a multiple of 32 in [32, 1024]")
    warps = max(1, min(D, K1_WARPS_MAX))
    stage, ring = 2 * W * 2, (R + 1) * W * 2
    use_smem = warps * (stage + ring) <= SMEM_MAX
    slice_bytes = stage + (ring if use_smem else 0)
    return dict(lanes_per_thread=W // 32, edge_slots=8 if P <= 8 else 16, warps=warps,
                grid=(B, -(-D // warps)), threads=32 * warps,
                smem_bytes=warps * slice_bytes, use_smem=use_smem)


def fits_int16(n_cap: int, w_cap: int, m: int, x: int, g: int) -> bool:
    """Worst-case |score| bound for the int16 H rows (the reference's
    precision selection, simd_alignment_engine_implementation.hpp:684-725).
    Leaves headroom above NEG16 for poison arithmetic."""
    worst = (n_cap + w_cap + 2) * max(abs(m), abs(x), abs(g))
    return worst <= 14000 and n_cap + 1 < TIE


def max_pred_distance(preds_np: np.ndarray, n_nodes: int) -> int:
    """Max (DP row - predecessor row) over real predecessor slots of a dense
    graph (preds_np [N, P], values = DP rows, 0 = row-0 boundary). Row-0
    preds are excluded: the kernel pins row 0 in a dedicated ring slot."""
    n = int(n_nodes)
    if n <= 0:
        return 0
    pr = preds_np[:n].astype(np.int64)
    rows = np.arange(1, n + 1, dtype=np.int64)[:, None]
    return int(np.where(pr > 0, rows - pr, 0).max(initial=0))


def sh_bits(P: int) -> int:
    """Bits below the value field: priority code (codes span [0, 2P+1] plus
    two reserved run-marker codes at the top of the field) plus the
    DELTA_BITS predecessor-distance field."""
    return int(np.ceil(np.log2(2 * P + 4))) + DELTA_BITS


def markers(P: int) -> Tuple[int, int]:
    """Run-marker priority codes (top two values of the prio field): cells
    whose move is diagonal (resp. vertical) with delta 1 carry MARKER_D
    (resp. MARKER_V) and, in the delta field, the length of the chain of
    such cells ending there, so the walk can jump the chain in one step."""
    pb = sh_bits(P) - DELTA_BITS
    if pb > 6:
        raise ValueError(f"P={P} pushes marker codes past int16 direction range")
    marker_d = (1 << pb) - 1
    return marker_d, marker_d - 1


def ring_slots(preds: torch.Tensor, R: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring slot and row distance of every predecessor slot, and the true
    in-degree, from preds [B, P, N] (DP rows, 0 = row-0 boundary, padding
    repeats slot 0). hslot is the ring slot of the predecessor row (R = the
    pinned row 0), delta the row distance (0 = "to row 0").
    Returns (hslot [B, P, N], delta [B, P, N], deg [B, N]), int32."""
    N = preds.shape[2]
    rows = torch.arange(1, N + 1, dtype=torch.int32, device=preds.device)[None, None, :]
    pz = preds == 0
    hslot = torch.where(pz, R, torch.remainder(preds - 1, R))
    delta = torch.where(pz, 0, rows - preds)
    deg = (preds[:, 1:, :] != preds[:, :1, :]).sum(dim=1, dtype=torch.int32) + 1
    return hslot.to(torch.int32), delta.to(torch.int32), deg.contiguous()


def pack_aux(preds: torch.Tensor, R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot candidate pack and true in-degree from preds [B, P, N].

    aux[b, p, r] = hslot << 16 | (prio << DELTA_BITS) + delta, with prio the
    diagonal priority of slot p (see `ring_slots` for hslot and delta).
    Returns (aux [B, P, N] int32, deg [B, N] int32)."""
    P = preds.shape[1]
    hslot, delta, deg = ring_slots(preds, R)
    dprio = (2 * P + 1 - torch.arange(P, dtype=torch.int32, device=preds.device))[None, :, None]
    aux = (hslot << 16) | ((dprio << DELTA_BITS) + delta)
    return aux.to(torch.int32).contiguous(), deg


def to_i32(a, device) -> torch.Tensor:
    """numpy array or tensor of any integer dtype -> contiguous int32 tensor
    on `device`."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check_inputs(tensors, dtype, device):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_dp_inputs(codes, aux, deg, sink, n_nodes, seqp, slen, R):
    """Shapes, dtype, device and contiguity of a POA DP wrapper's inputs
    (the linear, affine and convex kernels take the same ones); the ring
    must fit the DELTA_BITS distance field. Returns (B, P, N, D, W)."""
    if aux.dim() != 3 or seqp.dim() != 3:
        raise ValueError("aux must be [B, P, N] and seqp [B, D, W]")
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    if R >= (1 << DELTA_BITS) or R < 1:
        raise ValueError(f"ring {R} outside [1, {1 << DELTA_BITS})")
    shapes = dict(codes=(B, N), deg=(B, N), sink=(B, N), n_nodes=(B,), seqp=(B, D, W), slen=(B, D))
    tensors = dict(codes=codes, aux=aux, deg=deg, sink=sink, n_nodes=n_nodes, seqp=seqp, slen=slen)
    for name, shp in shapes.items():
        if tuple(tensors[name].shape) != shp:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, expected {shp}")
    _check_inputs(tensors, torch.int32, seqp.device)
    if seqp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seqp.device}")
    if seqp.device.type == "cuda" and (W % 32 or W > 1024):
        raise ValueError(f"W={W} must be a multiple of 32 and <= 1024")
    return B, P, N, D, W


def best_masks(n_nodes, sink, slen, N, W, mode, dev):
    """(cell_mask [B, D, W], best_row [B, N], jlane [1, 1, W]) of a plain DP:
    the lanes and rows that may hold the best cell (real rows; sink rows
    only, in nw/ov)."""
    jlane = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    sl = slen[:, :, None]
    cell_mask = (jlane == sl) if mode == "nw" else (jlane != 0) & (jlane <= sl)
    rows = torch.arange(1, N + 1, device=dev)[None, :]
    best_row = rows <= n_nodes[:, None]
    if mode != "sw":
        best_row = best_row & (sink != 0)
    return cell_mask, best_row, jlane


def best_init(B, D, W, mode, dev):
    """Initial packed best cells [B, D, W] of a plain DP."""
    if mode == "sw":
        return torch.zeros((B, D, W), dtype=torch.int32, device=dev)
    return torch.full((B, D, W), NEG16 * TIE + (TIE - 1), dtype=torch.int32, device=dev)


def best_cell(bestc, jlane, mode):
    """(maxi, maxj, score) [B, D] int32 from the packed best cells
    (score * TIE + (TIE - 1 - row)): highest score, lowest row, lowest lane."""
    W = bestc.shape[2]
    best = bestc.max(dim=2).values
    score = best >> 12
    i_pick = (TIE - 1) - (best & (TIE - 1))
    j_pick = torch.where(bestc == best[:, :, None], jlane, W).min(dim=2).values
    empty = score <= 0 if mode == "sw" else i_pick == 0
    i32 = torch.int32
    return torch.where(empty, 0, i_pick).to(i32), torch.where(empty, 0, j_pick).to(i32), score.to(i32)


# ------------------------------------------------------------------ K1: DP


def _dp_plain(codes, aux, deg, sink, n_nodes, seqp, slen, mode, m, x, g, R):
    """Plain PyTorch version of K1: vectorised over B, D, W and the in-edge
    slots, a Python loop over DP rows. Same outputs as the kernel, bit for
    bit (rows past a graph's n_nodes hold values nothing reads)."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dev = seqp.device
    SH = sh_bits(P)
    MASKC = (1 << SH) - 1
    HORIZ_CODE = 1 << DELTA_BITS
    MARKER_D, MARKER_V = markers(P)
    VADJ = g * (1 << SH) - (P << DELTA_BITS)
    i32 = torch.int32
    ring_base = torch.arange(B, device=dev)[:, None] * (R + 1)
    cell_mask, best_row, jlane = best_masks(n_nodes, sink, slen, N, W, mode, dev)
    jg = jlane * g
    lane0 = jlane == 0
    prof_m = torch.full((), m * (1 << SH), dtype=i32, device=dev)
    prof_x = torch.full((), x * (1 << SH), dtype=i32, device=dev)
    hrow = (aux >> 16).long() + ring_base[:, :, None]  # [B, P, N] row of Hf
    dpack = (aux & 0xFFFF)[:, :, :, None, None]  # [B, P, N, 1, 1]
    slot_live = (torch.arange(P, device=dev)[None, :, None] < deg[:, None, :])[..., None, None]

    H = torch.zeros((B, R + 1, D, W), dtype=torch.int16, device=dev)
    Hf = H.view(B * (R + 1), D, W)
    dirs = torch.zeros((B, N + 1, D, W), dtype=torch.int16, device=dev)
    bestc = best_init(B, D, W, mode, dev)
    if mode != "sw":
        H[:, R] = jg.to(torch.int16)
        dirs[:, 0] = HORIZ_CODE
    rld = torch.zeros((B, D, W), dtype=i32, device=dev)
    rlv = torch.zeros((B, D, W), dtype=i32, device=dev)
    n_max = int(n_nodes.max()) if B else 0
    deg_max = deg.max(dim=0).values.tolist() if B else []
    for hr in range(1, n_max + 1):
        r = hr - 1
        pm = deg_max[r]
        prof = torch.where(seqp == codes[:, r, None, None], prof_m, prof_x)
        rowv = Hf.index_select(0, hrow[:, :pm, r].reshape(-1)).view(B, pm, D, W)
        rowv = rowv.to(i32) * (1 << SH)
        dp = dpack[:, :pm, r]
        diag = torch.roll(rowv, 1, dims=3) + (prof[:, None] + dp)
        diag[..., 0] = NEGV
        cand = torch.maximum(diag, rowv + (VADJ + dp))
        # padding slots repeat slot 0 at a lower priority: masking them
        # leaves the max unchanged
        acc = cand.masked_fill_(~slot_live[:, :pm, r], NEGV).amax(dim=1)
        if mode != "nw":
            acc.masked_fill_(lane0, 0)
        local_val = acc >> SH
        run = torch.cummax(local_val - jg, dim=2).values + jg
        if mode == "sw":
            run.clamp_min_(0)
        # horizontal loses every tie (last in reference priority order)
        dcode = torch.where(run == local_val, acc & MASKC, HORIZ_CODE)
        if mode == "sw":
            dcode.masked_fill_(run == 0, 0)  # the stop code
        # run markers: a diagonal unit-delta chain continues the previous
        # row's chain one lane to the left, a vertical one the same lane
        unit = (dcode & DMASK) == 1
        isd1 = unit & (dcode >= (P + 2) << DELTA_BITS)
        isv1 = unit & (dcode >= 2 << DELTA_BITS) & ~isd1
        rld = torch.where(isd1, torch.roll(rld, 1, dims=2).add_(1).clamp_max_(DMASK), 0)
        rlv = torch.where(isv1, (rlv + 1).clamp_max_(DMASK), 0)
        dcode = torch.where(isd1, rld | (MARKER_D << DELTA_BITS), dcode)
        dcode = torch.where(isv1, rlv | (MARKER_V << DELTA_BITS), dcode)
        H[:, r % R] = run.to(torch.int16)
        dirs[:, hr] = dcode.to(torch.int16)
        upd = cell_mask & best_row[:, r, None, None]
        bestc = torch.where(upd, torch.maximum(bestc, run * TIE + (TIE - 1 - hr)), bestc)
    return (dirs, *best_cell(bestc, jlane, mode))


_DP_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_WALK_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_WALK_DENSE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_EXPAND_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("poa_linear")
    if lib.poa_dp_launch.argtypes is None:
        lib.poa_dp_launch.argtypes = _DP_ARGS
        lib.poa_dp_launch.restype = ctypes.c_int
        lib.poa_walk_launch.argtypes = _WALK_ARGS
        lib.poa_walk_launch.restype = ctypes.c_int
        lib.poa_walk_dense_launch.argtypes = _WALK_DENSE_ARGS
        lib.poa_walk_dense_launch.restype = ctypes.c_int
        lib.poa_expand_launch.argtypes = _EXPAND_ARGS
        lib.poa_expand_launch.restype = ctypes.c_int
    return lib


def poa_dp(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, R):
    """K1. codes/deg/sink [B, N], aux [B, P, N], n_nodes [B], seqp [B, D, W]
    (lane j = code of sequence position j-1), slen [B, D]; all int32 on one
    device. R: H-ring rows (every predecessor distance <= R).

    Returns dirs [B, N+1, D, W] int16 (rows past a graph's n_nodes are
    undefined on the card), maxi, maxj, score [B, D] int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    B, P, N, D, W = check_dp_inputs(codes, aux, deg, sink, n_nodes, seqp, slen, R)
    mode = MODES[align_type]
    if seqp.device.type == "cpu":
        return _dp_plain(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, R)
    dev = seqp.device
    dirs = torch.empty((B, N + 1, D, W), dtype=torch.int16, device=dev)
    maxi = torch.empty((B, D), dtype=torch.int32, device=dev)
    maxj = torch.empty_like(maxi)
    score = torch.empty_like(maxi)
    if B * D == 0:
        return dirs, maxi, maxj, score
    plan = dp_launch_plan(B, D, W, R, P)
    use_smem = plan["use_smem"]
    hring = None if use_smem else torch.empty((B * D, R + 1, W), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().poa_dp_launch(
            codes.data_ptr(), aux.data_ptr(), deg.data_ptr(), sink.data_ptr(),
            n_nodes.data_ptr(), seqp.data_ptr(), slen.data_ptr(),
            dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), score.data_ptr(),
            0 if hring is None else hring.data_ptr(),
            B, N, P, D, W, R, mode, m, x, g, sh_bits(P),
            plan["edge_slots"], plan["warps"], int(use_smem), plan["smem_bytes"],
            stream,
        )
    _build.check(_lib(), rc, "poa_dp")
    _build.LAUNCHES["poa_dp"] += 1
    shape = (B, D, N, W, P, "shared" if use_smem else "global")
    _build.K1_SHAPES[shape] = _build.K1_SHAPES.get(shape, 0) + 1
    return dirs, maxi, maxj, score


# --------------------------------------------------------------- K2: walk


def _decode_move(code, P):
    MARKER_D, MARKER_V = markers(P)
    pr = code >> DELTA_BITS
    dl = code & DMASK
    is_mrkd = pr == MARKER_D
    is_mrkv = pr == MARKER_V
    is_run = is_mrkd | is_mrkv
    is_diag = ((pr >= P + 2) & (pr < MARKER_V)) | is_mrkd
    is_vert = ((pr >= 2) & (pr <= P + 1)) | is_mrkv
    delta = torch.where(is_run, 1, dl)
    run_len = torch.where(is_run, dl, 1)
    return is_diag, is_vert, delta, is_run, run_len, pr == 0


def _walk_plain(dirs, maxi, maxj, mode, L, P):
    """Plain PyTorch version of K2: all B*D walks step together, a Python
    loop over steps. Returns (runs [L, B*D] int32, steps, count [B, D])."""
    B, N1, D, W = dirs.shape
    BD = B * D
    dev = dirs.device
    cf = dirs.reshape(-1)
    w = torch.arange(BD, device=dev)
    bidx, didx = w // D, w % D
    i = maxi.reshape(BD).to(torch.int64)
    j = maxj.reshape(BD).to(torch.int64)
    started = ~((i == 0) & (j == 0))
    active = started & (i != 0) & (j != 0) if mode == "ov" else started
    cnt = torch.zeros(BD, dtype=torch.int32, device=dev)
    runs = torch.zeros((L, BD), dtype=torch.int32, device=dev)
    step = 0
    while step < L and bool(active.any()):
        code = cf[((bidx * N1 + i) * D + didx) * W + j].to(torch.int32)
        is_diag, is_vert, delta, is_run, r, is_stop = _decode_move(code, P)
        do = active & ~is_stop if mode == "sw" else active
        moves = is_diag | is_vert
        prev_i1 = torch.where(moves, i - delta, i)
        prev_i1 = torch.where(delta == 0, torch.where(moves, 0, i), prev_i1)
        prev_j1 = torch.where(is_diag | ~is_vert, j - 1, j)
        pn0 = torch.where(prev_i1 == i, -1, i - 1)
        pp0 = torch.where(prev_j1 == j, -1, j - 1)
        prev_i = torch.where(is_run, i - r, prev_i1)
        prev_j = torch.where(is_run & is_diag, j - r, prev_j1)
        header = ((pn0 + 2) << RUN_PN_SHIFT) | ((pp0 + 2) << RUN_R_BITS) | torch.where(is_run, r, 1)
        runs[step] = torch.where(do, header, 0).to(torch.int32)
        i = torch.where(do, prev_i, i)
        j = torch.where(do, prev_j, j)
        cnt = cnt + torch.where(do, torch.where(is_run, r, 1), 0).to(torch.int32)
        if mode == "sw":
            active = do
        elif mode == "nw":
            active = do & ~((i == 0) & (j == 0))
        else:
            active = do & ~((i == 0) | (j == 0))
        step += 1
    # a step with no live walk writes nothing: count the last live one
    used = runs.ne(0).any(dim=1).nonzero()
    steps = int(used.max()) + 1 if used.numel() else 0
    cnt = torch.where(started, cnt, 0)
    return runs, steps, cnt.reshape(B, D)


def traceback_walk_rle(dirs, maxi, maxj, align_type, L, P):
    """K2. dirs [B, N1, D, W] int16 from `poa_dp`, maxi/maxj [B, D] int32.

    Returns (runs [L, B*D] int32 walk-order headers, zero past each walk's
    end; steps, the number of leading rows that hold a header; count
    [B, D] pairs per walk). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (and need W % 8 == 0)."""
    B, N1, D, W = dirs.shape
    if N1 + 1 >= (1 << 12) or W + 1 >= (1 << RUN_PP_BITS):
        raise ValueError(f"shape N1={N1}, W={W} exceeds rle header fields")
    dev = dirs.device
    if dirs.dtype != torch.int16 or not dirs.is_contiguous():
        raise ValueError("dirs must be a contiguous int16 tensor")
    for name, t in dict(maxi=maxi, maxj=maxj).items():
        if tuple(t.shape) != (B, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, D)}")
    _check_inputs(dict(maxi=maxi, maxj=maxj), torch.int32, dev)
    if dev.type == "cpu":
        return _walk_plain(dirs, maxi, maxj, align_type, L, P)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if W % 8 or dirs.data_ptr() % 16:
        raise ValueError("dirs rows must start on 16-byte boundaries (W % 8 == 0)")
    BD = B * D
    runs = torch.zeros((L, BD), dtype=torch.int32, device=dev)
    count = torch.empty((B, D), dtype=torch.int32, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    if BD == 0:
        return runs, 0, count
    launch_walk(dirs, maxi, maxj, runs, count, steps, align_type, L, P)
    return runs, int(steps.item()), count


def launch_walk(dirs, maxi, maxj, runs, count, steps, align_type, L, P):
    """K2's kernel alone, on the buffers `traceback_walk_rle` makes (runs
    zeroed, steps [1] zeroed, all on the card); `chip_smoke.py` times it
    apart from that glue. A walk writes only its own headers, so a second
    launch on the same buffers gives the same outputs."""
    B, N1, D, W = dirs.shape
    stream = torch.cuda.current_stream(dirs.device).cuda_stream
    with torch.cuda.device(dirs.device):
        rc = _lib().poa_walk_launch(
            dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), runs.data_ptr(),
            count.data_ptr(), steps.data_ptr(), B, N1, D, W, L, P, MODES[align_type], stream,
        )
    _build.check(_lib(), rc, "poa_walk")
    _build.LAUNCHES["poa_walk"] += 1


# ------------------------------------------------------- the expansion


def _expand_plain(runs, steps, count, node_id):
    """Plain PyTorch version of the expansion, vectorised over every header
    (repeat_interleave stretches the runs, a gather maps ranks to node ids
    and reverses each walk). Same outputs as the kernel."""
    B, D = count.shape
    BD, N = B * D, node_id.shape[1]
    dev = runs.device
    cnt = count.reshape(BD).to(torch.int64)
    ends = torch.cumsum(cnt, 0)
    offsets = ends - cnt
    # walk-major: each walk's headers in walk order, zeros past its end
    h = runs[:steps].T.reshape(-1).to(torch.int64)
    r = h & ((1 << RUN_R_BITS) - 1)
    keep = r > 0
    h, r = h[keep], r[keep]
    walk = torch.arange(BD, device=dev).repeat_interleave(steps)[keep]
    got = torch.zeros(BD, dtype=torch.int64, device=dev).index_add_(0, walk, r)
    if not torch.equal(got, cnt):
        raise RuntimeError("the walks' headers hold other pair counts than `count`")
    total = int(ends[-1]) if BD else 0
    pn0 = (h >> RUN_PN_SHIFT) - 2
    pp0 = ((h >> RUN_R_BITS) & ((1 << RUN_PP_BITS) - 1)) - 2
    # pair k of a run of r > 1 steps back k rows, and k positions unless a
    # deletion run (pp0 = -1)
    k = torch.arange(total, device=dev) - (torch.cumsum(r, 0) - r).repeat_interleave(r)
    stretch = (r > 1).repeat_interleave(r)
    pn = pn0.repeat_interleave(r) - k * stretch
    pp = pp0.repeat_interleave(r) - k * (stretch & (pp0 >= 0).repeat_interleave(r))
    wk = walk.repeat_interleave(r)
    node = node_id.reshape(-1).to(torch.int64)[(wk // D) * N + pn.clamp_min(0)]
    pairs = torch.stack([torch.where(pn >= 0, node, -1), pp], dim=1).to(torch.int16)
    # walk order is back to front: pair t of walk w goes to
    # offsets[w] + count[w] - 1 - (t - offsets[w]), a map that is its own inverse
    return pairs[2 * offsets[wk] + cnt[wk] - 1 - torch.arange(total, device=dev)], offsets


def expand_walk_pairs(runs, steps, count, node_id):
    """The expansion. runs [L, B*D] int32 and steps from `traceback_walk_rle`,
    count [B, D] int32, node_id [B, N] int32 (the node id of each DP rank).

    Returns (pairs [total, 2] int16, offsets [B*D] int64): walk w's pairs,
    front to back, are pairs[offsets[w] : offsets[w] + count[w]], each (node
    id, or -1 for an insertion; position, or -1 for a deletion); offsets is
    the exclusive scan of count and total its sum. Headers that hold other
    pair counts than `count`, more or fewer, raise on both devices. int16
    holds both fields
    (node ids of the window graphs below 4096, positions below 1024) in half
    the bytes of int32, as the dense walk's buffers do. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if runs.dim() != 2 or count.dim() != 2 or node_id.dim() != 2:
        raise ValueError("runs must be [L, B*D], count [B, D] and node_id [B, N]")
    B, D = count.shape
    L, BD = runs.shape
    if BD != B * D or node_id.shape[0] != B or not 0 <= steps <= L:
        raise ValueError(f"runs {tuple(runs.shape)}, count {tuple(count.shape)}, node_id "
                         f"{tuple(node_id.shape)} and steps {steps} do not agree")
    dev = runs.device
    _check_inputs(dict(runs=runs, count=count, node_id=node_id), torch.int32, dev)
    if dev.type == "cpu":
        return _expand_plain(runs, steps, count, node_id)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cnt = count.reshape(BD)
    ends = torch.cumsum(cnt, 0)
    offsets = ends - cnt
    total = int(ends[-1]) if BD else 0
    pairs = torch.empty((total, 2), dtype=torch.int16, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    if BD and steps:
        launch_expand(runs, steps, cnt, offsets, node_id, pairs, err)
    if (total and not steps) or int(err.item()):
        raise RuntimeError("the walks' headers hold other pair counts than `count`")
    return pairs, offsets


def launch_expand(runs, steps, cnt, offsets, node_id, pairs, err):
    """The expansion kernel alone, on the buffers `expand_walk_pairs` makes
    (cnt [B*D] int32, offsets [B*D] int64, pairs [total, 2] int16, err [1]
    int32 zeroed, which the kernel sets where a walk's headers and its count
    disagree, all on the card); `chip_smoke.py` times it apart from that
    glue."""
    BD = cnt.shape[0]
    stream = torch.cuda.current_stream(runs.device).cuda_stream
    with torch.cuda.device(runs.device):
        rc = _lib().poa_expand_launch(
            runs.data_ptr(), cnt.data_ptr(), offsets.data_ptr(), node_id.data_ptr(),
            pairs.data_ptr(), err.data_ptr(), BD, BD // node_id.shape[0], node_id.shape[1],
            steps, stream,
        )
    _build.check(_lib(), rc, "poa_expand")
    _build.LAUNCHES["poa_expand"] += 1


# ------------------------------------------------------- the dense walk


def _walk_dense_plain(dirs, maxi, maxj, mode, L, P, node_id=None):
    """Plain PyTorch version of the dense walk: all B*D walks step together,
    one gather a step, one pair a step (a run marker is the unit move it
    stands for). Returns (pn, pp [B, D, L] int16, count [B, D] int32)."""
    B, N1, D, W = dirs.shape
    BD = B * D
    dev = dirs.device
    cf = dirs.reshape(-1)
    w = torch.arange(BD, device=dev)
    bidx, didx = w // D, w % D
    i = maxi.reshape(BD).to(torch.int64)
    j = maxj.reshape(BD).to(torch.int64)
    started = ~((i == 0) & (j == 0))
    active = started & (i != 0) & (j != 0) if mode == "ov" else started
    cnt = torch.zeros(BD, dtype=torch.int32, device=dev)
    pn = torch.full((BD, L), -2, dtype=torch.int16, device=dev)
    pp = torch.full((BD, L), -2, dtype=torch.int16, device=dev)
    nid = None if node_id is None else node_id.reshape(-1).to(torch.int64)
    step = 0
    while step < L and bool(active.any()):
        code = cf[((bidx * N1 + i) * D + didx) * W + j].to(torch.int32)
        is_diag, is_vert, delta, _, _, is_stop = _decode_move(code, P)
        do = active & ~is_stop if mode == "sw" else active
        moves = is_diag | is_vert
        prev_i = torch.where(moves, i - delta, i)
        # delta 0: the predecessor is row 0
        prev_i = torch.where(delta == 0, torch.where(moves, 0, i), prev_i)
        prev_j = torch.where(is_diag | ~is_vert, j - 1, j)
        rank = (i - 1).clamp_min(0)
        node = rank if nid is None else nid[bidx * (N1 - 1) + rank]
        col = L - 1 - step
        pn[:, col] = torch.where(do, torch.where(prev_i == i, -1, node), -2).to(torch.int16)
        pp[:, col] = torch.where(do, torch.where(prev_j == j, -1, j - 1), -2).to(torch.int16)
        i = torch.where(do, prev_i, i)
        j = torch.where(do, prev_j, j)
        cnt = cnt + do.to(torch.int32)
        if mode == "sw":
            active = do
        elif mode == "nw":
            active = do & ~((i == 0) & (j == 0))
        else:
            active = do & ~((i == 0) | (j == 0))
        step += 1
    cnt = torch.where(started, cnt, 0)
    return pn.reshape(B, D, L), pp.reshape(B, D, L), cnt.reshape(B, D)


def traceback_walk_dense(dirs, maxi, maxj, align_type, L, P, node_id=None):
    """The dense walk. dirs [B, N1, D, W] int16 from `poa_dp`, maxi/maxj
    [B, D] int32; node_id [B, N1-1] int32 or None.

    Returns (pn, pp [B, D, L] int16, count [B, D] int32): the pairs of walk
    (b, d) back to front, so that `pn[b, d, L-c:]` with c = count[b, d] is
    the alignment front to back; every column before it holds -2. pn holds
    DP ranks (row - 1), or node ids when `node_id` is given; -1 marks an
    insertion (pn) or a deletion (pp). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise (and need W % 8 == 0)."""
    B, N1, D, W = dirs.shape
    if N1 > 32767 or W > 32767:
        raise ValueError(f"shape N1={N1}, W={W} exceeds the int16 pair fields")
    dev = dirs.device
    if dirs.dtype != torch.int16 or not dirs.is_contiguous():
        raise ValueError("dirs must be a contiguous int16 tensor")
    ints = dict(maxi=maxi, maxj=maxj)
    shapes = dict(maxi=(B, D), maxj=(B, D))
    if node_id is not None:
        ints["node_id"] = node_id
        shapes["node_id"] = (B, N1 - 1)
    for name, t in ints.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    _check_inputs(ints, torch.int32, dev)
    if dev.type == "cpu":
        return _walk_dense_plain(dirs, maxi, maxj, align_type, L, P, node_id)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if W % 8 or dirs.data_ptr() % 16:
        raise ValueError("dirs rows must start on 16-byte boundaries (W % 8 == 0)")
    pn = torch.empty((B, D, L), dtype=torch.int16, device=dev)
    pp = torch.empty_like(pn)
    count = torch.empty((B, D), dtype=torch.int32, device=dev)
    if B * D == 0:
        return pn, pp, count
    launch_walk_dense(dirs, maxi, maxj, node_id, pn, pp, count, align_type, L, P)
    return pn, pp, count


def launch_walk_dense(dirs, maxi, maxj, node_id, pn, pp, count, align_type, L, P):
    """The dense walk's kernel alone, on the buffers `traceback_walk_dense`
    makes (all on the card); `chip_smoke.py` times it apart from that glue.
    The kernel writes every column of pn and pp and every count, so a
    second launch on the same buffers gives the same outputs."""
    B, N1, D, W = dirs.shape
    stream = torch.cuda.current_stream(dirs.device).cuda_stream
    with torch.cuda.device(dirs.device):
        rc = _lib().poa_walk_dense_launch(
            dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(),
            0 if node_id is None else node_id.data_ptr(),
            pn.data_ptr(), pp.data_ptr(), count.data_ptr(),
            B, N1, D, W, L, P, MODES[align_type], stream,
        )
    _build.check(_lib(), rc, "poa_walk_dense")
    _build.LAUNCHES["poa_walk_dense"] += 1


# ------------------------------------------------------- public entry point


def poa_align(codes, preds, sink, n_nodes, seqp, seq_len, align_type, m, x, g,
              ring: int = 0, device="cuda", emit_rle: bool = True,
              emit_node_ids: bool = False, node_id=None, emit_pairs: bool = False):
    """K1 then a walk on the JAX package's layouts (`poa_align_pallas`):
    codes/sink [B, 1, N], preds [B, P, N] (DP rows), n_nodes [B, 1, 1], seqp
    [B, D, W], seq_len [B, 1, D]; numpy arrays or tensors of any integer
    dtype. ring: H-ring rows (0 = full history). L = N + W.

    With emit_rle (K2) returns (runs [L, B*D] int32, steps, count [B, 1, D],
    score [B, 1, D]); with emit_pairs as well, K2's headers expanded on the
    device (`expand_walk_pairs`), (pairs [total, 2] int16, offsets [B*D]
    int64, count, score), pairs holding the ids of `node_id` [B, 1, N].
    Without emit_rle (the dense walk) returns (pn, pp [B, D, L] int16, count,
    score) as `traceback_walk_dense` lays them out; pn holds DP ranks, or
    with emit_node_ids the ids of `node_id`.

    Tensors on `device`, which is the card unless the caller asks for "cpu"
    (the plain versions); without a GPU, "cuda" raises."""
    device = _build.resolve_device(device)
    if emit_node_ids and (emit_rle or node_id is None):
        raise ValueError("emit_node_ids needs emit_rle=False and node_id")
    if emit_pairs and (not emit_rle or node_id is None):
        raise ValueError("emit_pairs needs emit_rle and node_id")

    def t(a):
        return to_i32(a, device)

    preds = t(preds)
    B, P, N = preds.shape
    seqp = t(seqp)
    D, W = seqp.shape[1], seqp.shape[2]
    R = N if ring <= 0 or ring > N else ring
    aux, deg = pack_aux(preds, R)
    dirs, maxi, maxj, score = poa_dp(
        t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N),
        t(n_nodes).reshape(B), seqp, t(seq_len).reshape(B, D),
        align_type, m, x, g, R,
    )
    if emit_rle:
        runs, steps, count = traceback_walk_rle(dirs, maxi, maxj, align_type, N + W, P)
        if emit_pairs:
            pairs, offsets = expand_walk_pairs(runs, steps, count, t(node_id).reshape(B, N))
            return pairs, offsets, count[:, None, :], score[:, None, :]
        return runs, steps, count[:, None, :], score[:, None, :]
    nid = t(node_id).reshape(B, N) if emit_node_ids else None
    pn, pp, count = traceback_walk_dense(dirs, maxi, maxj, align_type, N + W, P, nid)
    return pn, pp, count[:, None, :], score[:, None, :]


# ------------------------------------------------------------ host decode


def runs_to_pairs_np(runs_w: np.ndarray):
    """Expand one walk's headers (runs_w [S] int32, walk order) to
    front-to-back (pn, pp) int64 arrays. np.repeat does the run stretch."""
    r = runs_w & ((1 << RUN_R_BITS) - 1)
    m = r > 0
    rr = r[m].astype(np.int64)
    pn0 = ((runs_w[m] >> RUN_PN_SHIFT) & 0xFFF).astype(np.int64) - 2
    pp0 = ((runs_w[m] >> RUN_R_BITS) & ((1 << RUN_PP_BITS) - 1)).astype(np.int64) - 2
    total = int(rr.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts = np.zeros(len(rr), np.int64)
    np.cumsum(rr[:-1], out=starts[1:])
    k = np.arange(total, dtype=np.int64) - np.repeat(starts, rr)
    dn = (rr > 1).astype(np.int64)
    dp = ((rr > 1) & (pp0 >= 0)).astype(np.int64)
    pn = np.repeat(pn0, rr) - k * np.repeat(dn, rr)
    pp = np.repeat(pp0, rr) - k * np.repeat(dp, rr)
    return pn[::-1], pp[::-1]


def ranks_to_node_ids_np(pn: np.ndarray, node_id_row: np.ndarray) -> np.ndarray:
    """Host-side rank -> node-id decode for one window (node_id_row [N])."""
    out = pn.copy()
    pos = pn >= 0
    out[pos] = node_id_row[pn[pos]]
    return out
