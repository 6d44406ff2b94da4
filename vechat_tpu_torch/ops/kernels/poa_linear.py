"""Linear-gap sequence-to-graph DP (K1) and its run-length traceback walk
(K2): CUDA kernels in `csrc/poa_linear.cu`, their plain PyTorch versions,
and the host helpers that decode the walk.

Replaces `vechat_tpu/ops/kernels/poa_pallas.py`: `_dp_kernel` (the Pallas
kernel behind `_poa_dp_pallas`) and `_traceback_walk_rle`. The direction
codes, the run-marker scheme, the best-cell pack and the run-header layout
are the reference's, bit for bit, so `runs_to_pairs_np` decodes both.

K1 (`poa_dp`). One thread block per (window graph b, sequence d), one
thread per lane j (W <= 1024), looping over DP rows 1..n_nodes. Each row
takes one packed max over the row's in-edge candidates
(``value << SH | prio << 9 | delta``, so the max also picks the move and
the predecessor row), then an inclusive max-scan across the block for the
in-row gap. On this card the kernel is bound by the serial row chain: per
row, a few dependent loads from the H ring and three block barriers (two
in the scan). The design keeps the H ring (int16) in shared memory whenever
``(R+1)*W*2`` bytes fit, else in a global scratch ring that stays in L2,
and writes each direction row with one coalesced int16 store per lane.
Memory traffic (the dirs tensor, ``(N+1)*D*W*2`` bytes) is far below what
the chain takes.

K2 (`traceback_walk_rle`). One thread per walk (B*D threads). Each step
reads one direction code and writes one packed header into
``runs[step, walk]``, so a warp's stores coalesce. A marked diagonal or
vertical run is jumped in one step. Bound by dependent-load latency: one
dirs read per step, steps serial per walk.
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

# largest shared-memory H ring a K1 block takes (bytes); larger rings live
# in a global scratch ring
SMEM_RING_MAX = 200 * 1024


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


def pack_aux(preds: torch.Tensor, R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot candidate pack and true in-degree from preds [B, P, N]
    (DP rows, 0 = row-0 boundary, padding repeats slot 0).

    aux[b, p, r] = hslot << 16 | (prio << DELTA_BITS) + delta, where hslot
    is the H-ring slot of the predecessor row (R = the pinned row 0), prio
    the diagonal priority of slot p and delta the row distance.
    Returns (aux [B, P, N] int32, deg [B, N] int32)."""
    B, P, N = preds.shape
    dev = preds.device
    rows = torch.arange(1, N + 1, dtype=torch.int32, device=dev)[None, None, :]
    pz = preds == 0
    hslot = torch.where(pz, R, torch.remainder(preds - 1, R))
    delta = torch.where(pz, 0, rows - preds)
    dprio = (2 * P + 1 - torch.arange(P, dtype=torch.int32, device=dev))[None, :, None]
    aux = (hslot << 16) | ((dprio << DELTA_BITS) + delta)
    deg = (preds[:, 1:, :] != preds[:, :1, :]).sum(dim=1, dtype=torch.int32) + 1
    return aux.to(torch.int32).contiguous(), deg.contiguous()


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
    jlane = torch.arange(W, dtype=i32, device=dev)[None, None, :]
    jg = jlane * g
    lane0 = jlane == 0
    sl = slen[:, :, None]
    cell_mask = (jlane == sl) if mode == "nw" else (jlane != 0) & (jlane <= sl)
    # rows that may hold the best cell: real rows, and sink rows in nw/ov
    rows = torch.arange(1, N + 1, device=dev)[None, :]
    best_row = rows <= n_nodes[:, None]
    if mode != "sw":
        best_row = best_row & (sink != 0)
    prof_m = torch.full((), m * (1 << SH), dtype=i32, device=dev)
    prof_x = torch.full((), x * (1 << SH), dtype=i32, device=dev)
    hrow = (aux >> 16).long() + ring_base[:, :, None]  # [B, P, N] row of Hf
    dpack = (aux & 0xFFFF)[:, :, :, None, None]  # [B, P, N, 1, 1]
    slot_live = (torch.arange(P, device=dev)[None, :, None] < deg[:, None, :])[..., None, None]

    H = torch.zeros((B, R + 1, D, W), dtype=torch.int16, device=dev)
    Hf = H.view(B * (R + 1), D, W)
    dirs = torch.zeros((B, N + 1, D, W), dtype=torch.int16, device=dev)
    if mode == "sw":
        bestc = torch.zeros((B, D, W), dtype=i32, device=dev)
    else:
        H[:, R] = jg.to(torch.int16)
        bestc = torch.full((B, D, W), NEG16 * TIE + (TIE - 1), dtype=i32, device=dev)
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

    best = bestc.max(dim=2).values  # [B, D]
    score = best >> 12
    i_pick = (TIE - 1) - (best & (TIE - 1))
    j_pick = torch.where(bestc == best[:, :, None], jlane, W).min(dim=2).values
    empty = score <= 0 if mode == "sw" else i_pick == 0
    maxi = torch.where(empty, 0, i_pick).to(i32)
    maxj = torch.where(empty, 0, j_pick).to(i32)
    return dirs, maxi, maxj, score.to(i32)


_DP_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_WALK_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("poa_linear")
    if lib.poa_dp_launch.argtypes is None:
        lib.poa_dp_launch.argtypes = _DP_ARGS
        lib.poa_dp_launch.restype = ctypes.c_int
        lib.poa_walk_launch.argtypes = _WALK_ARGS
        lib.poa_walk_launch.restype = ctypes.c_int
    return lib


def _check_inputs(tensors, dtype, device):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def poa_dp(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, R):
    """K1. codes/deg/sink [B, N], aux [B, P, N], n_nodes [B], seqp [B, D, W]
    (lane j = code of sequence position j-1), slen [B, D]; all int32 on one
    device. R: H-ring rows (every predecessor distance <= R).

    Returns dirs [B, N+1, D, W] int16 (rows past a graph's n_nodes are
    undefined on the card), maxi, maxj, score [B, D] int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    if R >= (1 << DELTA_BITS) or R < 1:
        raise ValueError(f"ring {R} outside [1, {1 << DELTA_BITS})")
    shapes = dict(codes=(B, N), deg=(B, N), sink=(B, N), n_nodes=(B,), slen=(B, D))
    tensors = dict(codes=codes, aux=aux, deg=deg, sink=sink, n_nodes=n_nodes, seqp=seqp, slen=slen)
    for name, shp in shapes.items():
        if tuple(tensors[name].shape) != shp:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, expected {shp}")
    _check_inputs(tensors, torch.int32, seqp.device)
    mode = MODES[align_type]
    if seqp.device.type == "cpu":
        return _dp_plain(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, R)
    if seqp.device.type != "cuda":
        raise ValueError(f"unsupported device {seqp.device}")
    if W % 32 or W > 1024:
        raise ValueError(f"W={W} must be a multiple of 32 and <= 1024")
    dev = seqp.device
    dirs = torch.empty((B, N + 1, D, W), dtype=torch.int16, device=dev)
    maxi = torch.empty((B, D), dtype=torch.int32, device=dev)
    maxj = torch.empty_like(maxi)
    score = torch.empty_like(maxi)
    ring_bytes = (R + 1) * W * 2
    use_smem = ring_bytes <= SMEM_RING_MAX
    hring = None if use_smem else torch.empty((B * D, R + 1, W), dtype=torch.int16, device=dev)
    if B * D == 0:
        return dirs, maxi, maxj, score
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().poa_dp_launch(
            codes.data_ptr(), aux.data_ptr(), deg.data_ptr(), sink.data_ptr(),
            n_nodes.data_ptr(), seqp.data_ptr(), slen.data_ptr(),
            dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), score.data_ptr(),
            0 if hring is None else hring.data_ptr(),
            B, N, P, D, W, R, mode, m, x, g, int(use_smem), sh_bits(P),
            stream,
        )
    _build.check(_lib(), rc, "poa_dp")
    _build.LAUNCHES["poa_dp"] += 1
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
    tensors launch the kernel or raise."""
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
    BD = B * D
    runs = torch.zeros((L, BD), dtype=torch.int32, device=dev)
    count = torch.empty((B, D), dtype=torch.int32, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    if BD == 0:
        return runs, 0, count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().poa_walk_launch(
            dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), runs.data_ptr(),
            count.data_ptr(), steps.data_ptr(),
            B, N1, D, W, L, P, MODES[align_type],
            stream,
        )
    _build.check(_lib(), rc, "poa_walk")
    _build.LAUNCHES["poa_walk"] += 1
    return runs, int(steps.item()), count


# ------------------------------------------------------- public entry point


def poa_align(codes, preds, sink, n_nodes, seqp, seq_len, align_type, m, x, g,
              ring: int = 0, device="cuda"):
    """K1 then K2 on the JAX package's layouts (`poa_align_pallas(...,
    emit_rle=True)`): codes/sink [B, 1, N], preds [B, P, N] (DP rows),
    n_nodes [B, 1, 1], seqp [B, D, W], seq_len [B, 1, D]; numpy arrays or
    tensors of any integer dtype. ring: H-ring rows (0 = full history).

    Returns (runs [L, B*D] int32, steps, count [B, 1, D], score [B, 1, D]),
    tensors on `device`; L = N + W. `device` is the card unless the caller
    asks for "cpu" (the plain versions); without a GPU, "cuda" raises."""
    device = _build.resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(
            device=device, dtype=torch.int32
        ).contiguous()

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
    runs, steps, count = traceback_walk_rle(dirs, maxi, maxj, align_type, N + W, P)
    return runs, steps, count[:, None, :], score[:, None, :]


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
