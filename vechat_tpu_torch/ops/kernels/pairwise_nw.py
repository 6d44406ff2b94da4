"""Batched pairwise global edit-distance alignment: the banded exact kernel
(K3) and the 512x512 tile kernel (K4) in `csrc/pairwise_nw.cu`, their plain
PyTorch versions, and `DevicePairwiseAligner`, which routes overlap pairs
to them and assembles CIGARs.

Replaces `vechat_tpu/ops/kernels/pairwise_pallas.py`: `_kernel_banded`
(the Pallas kernel behind `_pairwise_banded_impl`) and `_kernel` (behind
`_pairwise_nw_pallas_impl`). Ties break M > D > I as in the host oracle
(ops/pairwise.py), so accepted banded CIGARs equal `edit_align`'s.

Both kernels run one thread block per pair with one thread per lane (BW
or W <= 1024 threads) and a Python-free row loop: per row one block-wide
max-scan for the horizontal (insertion) chain. The two rolling H rows sit
in shared memory; the direction matrix (one int8 per cell, 2.3 MB per pair
at 2560x896) goes to global scratch, and one thread walks it back. On this
card both kernels are bound by the serial chain of row barriers and by the
walk's dependent loads, not by bytes or operations; the grid fills the card
with one block per pair.

The public functions keep the JAX package's layouts ([B, T, 1, S] target
codes, [B, 1, S] lengths, S pairs per program); the wrappers reshape to one
row per pair. The banded kernel indexes the query directly at
j = r + lo + l, so its wrapper joins the JAX layout's row-1 window and
entering elements into one array.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

NEG = -(2**28)
DSUB = 8  # tile pairs per program in the JAX layout
BSUB = 4  # banded pairs per program in the JAX layout

_BANDED_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_TILED_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("pairwise_nw")
    if lib.banded_launch.argtypes is None:
        lib.banded_launch.argtypes = _BANDED_ARGS
        lib.banded_launch.restype = ctypes.c_int
        lib.tiled_launch.argtypes = _TILED_ARGS
        lib.tiled_launch.restype = ctypes.c_int
    return lib


def _check(tensors, shapes, device):
    for name, t in tensors.items():
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")


# ----------------------------------------------------------- K3: banded NW


def _banded_plain(t, ext, tlen, qlen, lo, BW):
    """Plain PyTorch version of K3: vectorised over pairs and lanes, a
    Python loop over rows and walk steps. Pairs run in order of falling
    target length, so row r only touches the pairs that reach it; rows
    past a pair's target length are never read, so none is computed."""
    NP, T = t.shape
    L = T + BW
    dev = t.device
    i32 = torch.int32
    order = torch.argsort(tlen, descending=True, stable=True)
    t, ext, tlen, qlen, lo = (a[order] for a in (t, ext, tlen, qlen, lo))
    tl = tlen.tolist()
    lane = torch.arange(BW, dtype=i32, device=dev)[None, :]
    j0 = lo[:, None] + lane
    H = torch.where((j0 >= 0) & (j0 <= qlen[:, None]), -j0, NEG)
    fin = H.clone()  # row tlen of every pair
    DIR = torch.zeros((NP, T + 1, BW), dtype=torch.int8, device=dev)
    DIR[:, 0] = 2
    negcol = torch.full((NP, 1), NEG, dtype=i32, device=dev)
    n_act = NP
    for i in range(tl[0] if NP else 0):
        r = i + 1
        while tl[n_act - 1] < r:
            n_act -= 1
        h = H[:n_act]
        jv = j0[:n_act] + r
        prof = (ext[:n_act, i : i + BW] == t[:n_act, i : i + 1]).to(i32) - 1
        diag = torch.where(jv >= 1, h + prof, NEG)
        vert = torch.cat([h[:, 1:], negcol[:n_act]], dim=1) - 1
        acc = torch.where(jv == 0, -r, torch.maximum(diag, vert))
        run = torch.cummax(acc + lane, dim=1).values - lane
        run = torch.where((jv >= 0) & (jv <= qlen[:n_act, None]), run, NEG)
        d = torch.where(run == diag, 0, torch.where(run == vert, 1, 2))
        DIR[:n_act, r] = d.to(torch.int8)
        H = run
        p = n_act - 1
        while p >= 0 and tl[p] == r:  # pairs whose last row this is
            fin[p] = run[p]
            p -= 1
    lstar = (qlen - tlen - lo).long()
    inb = (lstar >= 0) & (lstar < BW)
    dist = -torch.where(inb, fin.gather(1, lstar.clamp(0, BW - 1)[:, None])[:, 0], NEG)

    pt = torch.full((NP, L), -2, dtype=i32, device=dev)
    pq = torch.full((NP, L), -2, dtype=i32, device=dev)
    pidx = torch.arange(NP, device=dev)
    i = tlen.long()
    ll = lstar
    lod = lo.long()
    ok = ~((tlen == 0) & (qlen == 0))
    count = torch.zeros(NP, dtype=i32, device=dev)
    k = 0
    # the step bound and the clipping stop the walks of band-overflow pairs
    while k < L and bool(ok.any()):
        i = i.clamp(0, T)
        ll = ll.clamp(0, BW - 1)
        dv = DIR[pidx, i, ll]
        dg, vt = dv == 0, dv == 1
        jq = i + lod + ll
        pi = torch.where(dg | vt, i - 1, i)
        pl = torch.where(dg, ll, torch.where(vt, ll + 1, ll - 1))
        pt[:, L - 1 - k] = torch.where(ok, torch.where(i == pi, -1, i - 1), -2).to(i32)
        pq[:, L - 1 - k] = torch.where(ok, torch.where(vt, -1, jq - 1), -2).to(i32)
        count += ok.to(i32)
        i = torch.where(ok, pi, i)
        ll = torch.where(ok, pl, ll)
        ok = ok & ~((i == 0) & (i + lod + ll == 0))
        k += 1
    inv = torch.argsort(order)
    return (
        pt[inv].to(torch.int16),
        pq[inv].to(torch.int16),
        count[inv],
        dist[inv].to(i32),
    )


def banded_nw(t, ext, tlen, qlen, lo, BW):
    """K3 on kernel layouts: t [NP, T] target codes, ext [NP, BW+T] with
    ext[p, x] = q_p[lo_p + x] (0xFF outside q), tlen/qlen/lo [NP]; int32.

    Returns pt, pq [NP, T+BW] int16 (walk pairs right-aligned, -2 padding,
    -1 = gap), count, dist [NP] int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    NP, T = t.shape
    dev = t.device
    shapes = dict(t=(NP, T), ext=(NP, BW + T), tlen=(NP,), qlen=(NP,), lo=(NP,))
    _check(dict(t=t, ext=ext, tlen=tlen, qlen=qlen, lo=lo), shapes, dev)
    if dev.type == "cpu":
        return _banded_plain(t, ext, tlen, qlen, lo, BW)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if BW % 32 or BW > 1024:
        raise ValueError(f"BW={BW} must be a multiple of 32 and <= 1024")
    L = T + BW
    pt = torch.full((NP, L), -2, dtype=torch.int16, device=dev)
    pq = torch.full((NP, L), -2, dtype=torch.int16, device=dev)
    count = torch.empty(NP, dtype=torch.int32, device=dev)
    dist = torch.empty(NP, dtype=torch.int32, device=dev)
    if NP == 0:
        return pt, pq, count, dist
    scratch = torch.empty((NP, T + 1, BW), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().banded_launch(
            t.data_ptr(), ext.data_ptr(), tlen.data_ptr(), qlen.data_ptr(), lo.data_ptr(),
            scratch.data_ptr(), pt.data_ptr(), pq.data_ptr(), count.data_ptr(),
            dist.data_ptr(), NP, T, BW, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(_lib(), rc, "pairwise_banded")
    _build.LAUNCHES["pairwise_banded"] += 1
    return pt, pq, count, dist


def _as_i32(a, device):
    a = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=torch.int32)


def banded_inputs(tcodes, tlen, qwin0, qent, qlen, lo, BW, device="cuda"):
    """The JAX layouts of `_pairwise_banded_jit` (tcodes [B, T, 1, S],
    tlen/qlen/lo [B, 1, S], qwin0 [B, S, BW] the query window of row 1,
    qent [B, T, 1, S] the element entering the window at each row; numpy
    arrays or tensors) as `banded_nw`'s arguments on `device`: one row per
    pair, and the window and entering elements joined into one array."""
    device = _build.resolve_device(device)
    tcodes = _as_i32(tcodes, device)
    B, T, _, S = tcodes.shape
    t = tcodes[:, :, 0, :].permute(0, 2, 1).reshape(B * S, T).contiguous()
    ext = torch.cat(
        [
            _as_i32(qwin0, device).reshape(B * S, BW),
            _as_i32(qent, device)[:, :, 0, :].permute(0, 2, 1).reshape(B * S, T),
        ],
        dim=1,
    ).contiguous()
    flat = lambda a: _as_i32(a, device).reshape(B * S).contiguous()  # noqa: E731
    return t, ext, flat(tlen), flat(qlen), flat(lo)


def pairwise_banded(tcodes, tlen, qwin0, qent, qlen, lo, BW, device="cuda"):
    """K3 on the JAX layouts of `_pairwise_banded_jit` (see `banded_inputs`).
    Returns pt, pq [B, S, T+BW] int16, count, dist [B, 1, S] int32 on
    `device`: the card unless the caller asks for "cpu" (the plain
    version); without a GPU, "cuda" raises."""
    B, T, _, S = np.shape(tcodes)
    pt, pq, count, dist = banded_nw(
        *banded_inputs(tcodes, tlen, qwin0, qent, qlen, lo, BW, device), BW
    )
    L = T + BW
    return (
        pt.reshape(B, S, L),
        pq.reshape(B, S, L),
        count.reshape(B, 1, S),
        dist.reshape(B, 1, S),
    )


# ------------------------------------------------------------ K4: tiled NW


def _tiled_plain(t, q, tlen, qlen):
    """Plain PyTorch version of K4: vectorised over tiles and lanes, a
    Python loop over rows and walk steps."""
    NP, T = t.shape
    W = q.shape[1]
    L = T + W
    dev = t.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    tl = tlen[:, None]
    H = (-lane).expand(NP, W).contiguous()
    DIR = torch.zeros((NP, T + 1, W), dtype=torch.int8, device=dev)
    DIR[:, 0] = 2
    tmax = int(tlen.max()) if NP else 0
    for r in range(tmax):
        prof = torch.where(q == t[:, r : r + 1], 0, -1)
        diag = torch.where(lane == 0, NEG, torch.roll(H, 1, dims=1)) + prof
        vert = H - 1
        val = torch.where(lane == 0, H[:, :1] - 1, torch.maximum(diag, vert))
        run = torch.cummax(val + lane, dim=1).values - lane
        d = torch.where(run == diag, 0, torch.where(run == vert, 1, 2)).to(torch.int8)
        past = r >= tl  # frozen rows: never read by the walk
        H = torch.where(past, H, run)
        DIR[:, r + 1] = torch.where(past, DIR[:, r], d)
    ql = qlen.long()
    inb = (ql >= 0) & (ql < W)
    fin = H.gather(1, ql.clamp(0, W - 1)[:, None])[:, 0]
    dist = -torch.where(inb, fin, NEG)

    pt = torch.full((NP, L), -2, dtype=torch.int32, device=dev)
    pq = torch.full((NP, L), -2, dtype=torch.int32, device=dev)
    pidx = torch.arange(NP, device=dev)
    i, j = tlen.long(), ql
    ok = ~((tlen == 0) & (qlen == 0))
    count = torch.zeros(NP, dtype=torch.int32, device=dev)
    k = 0
    while k < L and bool(ok.any()):
        dv = DIR[pidx, i.clamp(0, T), j.clamp(0, W - 1)]
        dg, vt = dv == 0, dv == 1
        pi = torch.where(dg | vt, i - 1, i)
        pj = torch.where(dg | ~vt, j - 1, j)
        pt[:, L - 1 - k] = torch.where(ok, torch.where(i == pi, -1, i - 1), -2).to(torch.int32)
        pq[:, L - 1 - k] = torch.where(ok, torch.where(j == pj, -1, j - 1), -2).to(torch.int32)
        count += ok.to(torch.int32)
        i = torch.where(ok, pi, i)
        j = torch.where(ok, pj, j)
        ok = ok & ~((i == 0) & (j == 0))
        k += 1
    return pt, pq, count, dist.to(torch.int32)


def tiled_nw(t, q, tlen, qlen):
    """K4 on kernel layouts: t [NP, T] target codes, q [NP, W] query codes
    at lane j = position j-1, tlen/qlen [NP]; int32.

    Returns pt, pq [NP, T+W] int32 (walk pairs right-aligned, -2 padding,
    -1 = gap), count, dist [NP] int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    NP, T = t.shape
    W = q.shape[1]
    dev = t.device
    shapes = dict(t=(NP, T), q=(NP, W), tlen=(NP,), qlen=(NP,))
    _check(dict(t=t, q=q, tlen=tlen, qlen=qlen), shapes, dev)
    if dev.type == "cpu":
        return _tiled_plain(t, q, tlen, qlen)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if W % 32 or W > 1024:
        raise ValueError(f"W={W} must be a multiple of 32 and <= 1024")
    L = T + W
    pt = torch.full((NP, L), -2, dtype=torch.int32, device=dev)
    pq = torch.full((NP, L), -2, dtype=torch.int32, device=dev)
    count = torch.empty(NP, dtype=torch.int32, device=dev)
    dist = torch.empty(NP, dtype=torch.int32, device=dev)
    if NP == 0:
        return pt, pq, count, dist
    scratch = torch.empty((NP, T + 1, W), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tiled_launch(
            t.data_ptr(), q.data_ptr(), tlen.data_ptr(), qlen.data_ptr(), scratch.data_ptr(),
            pt.data_ptr(), pq.data_ptr(), count.data_ptr(), dist.data_ptr(), NP, T, W,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(_lib(), rc, "pairwise_tiled")
    _build.LAUNCHES["pairwise_tiled"] += 1
    return pt, pq, count, dist


def tiled_inputs(tcodes, tlen, qcodes, qlen, device="cuda"):
    """The JAX layouts of `pairwise_nw_pallas` (tcodes [B, T, 1, S],
    tlen/qlen [B, 1, S], qcodes [B, S, W]; numpy arrays or tensors) as
    `tiled_nw`'s arguments on `device`, one row per tile."""
    device = _build.resolve_device(device)
    tcodes = _as_i32(tcodes, device)
    B, T, _, S = tcodes.shape
    qcodes = _as_i32(qcodes, device)
    t = tcodes[:, :, 0, :].permute(0, 2, 1).reshape(B * S, T).contiguous()
    flat = lambda a: _as_i32(a, device).reshape(B * S).contiguous()  # noqa: E731
    return t, qcodes.reshape(B * S, -1).contiguous(), flat(tlen), flat(qlen)


def pairwise_nw(tcodes, tlen, qcodes, qlen, device="cuda"):
    """K4 on the JAX layouts of `pairwise_nw_pallas` (see `tiled_inputs`).
    Returns pt, pq [B, S, T+W] int32, count, dist [B, 1, S] on `device`:
    the card unless the caller asks for "cpu" (the plain version); without
    a GPU, "cuda" raises."""
    B, T, _, S = np.shape(tcodes)
    L = T + np.shape(qcodes)[2]
    pt, pq, count, dist = tiled_nw(*tiled_inputs(tcodes, tlen, qcodes, qlen, device))
    return (
        pt.reshape(B, S, L),
        pq.reshape(B, S, L),
        count.reshape(B, 1, S),
        dist.reshape(B, 1, S),
    )


# ------------------------------------------------------ anchors and tiling


def _minimizer_anchors(q: np.ndarray, t: np.ndarray, k: int = 15, w: int = 5):
    """Colinear (q_pos, t_pos) anchors between two code arrays."""
    from ...pipeline.overlapper import _hash64

    def mins(codes):
        n = len(codes) - k + 1
        if n <= 0:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        window = np.lib.stride_tricks.sliding_window_view(codes, k)
        weights = np.uint64(1) << (
            np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
        )
        km = (window.astype(np.uint64) * weights[None, :]).sum(
            axis=1, dtype=np.uint64
        )
        h = _hash64(km)
        if n <= w:
            best = int(np.argmin(h))
            return h[best : best + 1], np.array([best])
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        arg = np.argmin(win, axis=1)
        pos = np.unique(arg + np.arange(len(arg)))
        return h[pos], pos.astype(np.int64)

    qh, qp = mins(q)
    th, tp = mins(t)
    if len(qh) == 0 or len(th) == 0:
        return np.empty((0, 2), np.int64)
    order_t = np.argsort(th, kind="stable")
    th_s, tp_s = th[order_t], tp[order_t]
    lo = np.searchsorted(th_s, qh, side="left")
    hi = np.searchsorted(th_s, qh, side="right")
    anchors = []
    for i in range(len(qh)):
        for s in range(lo[i], min(hi[i], lo[i] + 4)):
            anchors.append((int(qp[i]), int(tp_s[s])))
    if not anchors:
        return np.empty((0, 2), np.int64)
    a = np.array(anchors, dtype=np.int64)
    # densest diagonal band, then monotonic chain
    diag = a[:, 0] - a[:, 1]
    med = np.median(diag)
    a = a[np.abs(diag - med) <= 200]
    if len(a) == 0:
        return np.empty((0, 2), np.int64)
    a = a[np.lexsort((a[:, 0], a[:, 1]))]
    keep = []
    last_q = -1
    last_t = -1
    for qp_, tp_ in a:
        if qp_ > last_q and tp_ > last_t:
            keep.append((qp_, tp_))
            last_q, last_t = qp_, tp_
    return np.array(keep, dtype=np.int64) if keep else np.empty((0, 2), np.int64)


def tile_cut_points(
    q_len: int, t_len: int, anchors: np.ndarray, max_span: int
) -> Optional[List[Tuple[int, int]]]:
    """Cut positions (q, t) splitting the global alignment into tiles whose
    q/t spans both fit max_span. None when anchor gaps are too large."""
    cuts = [(0, 0)]
    cq = ct = 0
    ai = 0
    n = len(anchors)
    while t_len - ct > max_span or q_len - cq > max_span:
        # furthest anchor keeping both spans within max_span
        best = None
        while ai < n:
            aq, at = int(anchors[ai][0]), int(anchors[ai][1])
            if aq - cq <= max_span and at - ct <= max_span:
                if aq > cq and at > ct:
                    best = (aq, at)
                ai += 1
            else:
                break
        if best is None:
            return None
        cuts.append(best)
        cq, ct = best
    cuts.append((q_len, t_len))
    return cuts


def pack_banded(pairs, T: int, BW: int):
    """JAX-layout inputs of `pairwise_banded` for (query, target) code
    pairs, BSUB per program: the band of a pair spans diagonals
    [lo, lo + BW) with lo = min(0, lq - lt) - k, k = (BW-1 - |lq-lt|) // 2."""
    B = (len(pairs) + BSUB - 1) // BSUB
    tcodes = np.zeros((B, T, 1, BSUB), np.int32)
    tlen = np.ones((B, 1, BSUB), np.int32)
    qwin0 = np.full((B, BSUB, BW), 0xFF, np.int32)
    qent = np.full((B, T, 1, BSUB), 0xFF, np.int32)
    qlen = np.zeros((B, 1, BSUB), np.int32)
    lo = np.zeros((B, 1, BSUB), np.int32)
    for n, (q, t) in enumerate(pairs):
        b, d = divmod(n, BSUB)
        lq, lt = len(q), len(t)
        k = (BW - 1 - abs(lq - lt)) // 2
        lod = min(0, lq - lt) - k
        tcodes[b, :lt, 0, d] = t
        tlen[b, 0, d] = lt
        # row-1 window qwin0[l] = q[lo + l]; entering element for row r+1
        # is qent[r-1] = q[r + lo + BW - 1] (pad 0xFF)
        qa = np.asarray(q, dtype=np.int32)
        w_idx = lod + np.arange(BW)
        ok = (w_idx >= 0) & (w_idx < lq)
        qwin0[b, d] = np.where(ok, qa[np.clip(w_idx, 0, lq - 1)], 0xFF)
        e_idx = np.arange(1, T + 1) + lod + BW - 1
        ok = (e_idx >= 0) & (e_idx < lq)
        qent[b, :, 0, d] = np.where(ok, qa[np.clip(e_idx, 0, lq - 1)], 0xFF)
        qlen[b, 0, d] = lq
        lo[b, 0, d] = lod
    return tcodes, tlen, qwin0, qent, qlen, lo


def pack_tiles(tiles, T: int, W: int):
    """JAX-layout inputs of `pairwise_nw` for (query, target) code tiles,
    DSUB per program; padding slots align 'A' against 'A'."""
    B = (len(tiles) + DSUB - 1) // DSUB
    tcodes = np.zeros((B, T, 1, DSUB), np.int32)
    tlen = np.ones((B, 1, DSUB), np.int32)
    qcodes = np.full((B, DSUB, W), 0xFF, np.int32)
    qcodes[:, :, 1] = 0
    qlen = np.ones((B, 1, DSUB), np.int32)
    for n, (qs, ts) in enumerate(tiles):
        b, d = divmod(n, DSUB)
        tcodes[b, : len(ts), 0, d] = ts
        tlen[b, 0, d] = len(ts)
        qcodes[b, d, 1 : 1 + len(qs)] = qs
        qlen[b, 0, d] = len(qs)
    return tcodes, tlen, qcodes, qlen


def _ops_from_pairs(tp: np.ndarray, qp: np.ndarray) -> np.ndarray:
    return np.where(tp == -1, "I", np.where(qp == -1, "D", "M"))


class DevicePairwiseAligner:
    """Batched device NW on the pairwise kernels; returns CIGARs.

    Two device formulations, routed by size:
    * EXACT banded mode (K3) for pairs fitting the band buckets: full global
      NW over a diagonal corridor, accepted only when the edit distance
      provably fits the band (Ukkonen: a d-edit path strays at most d
      diagonals from the corridor), so accepted CIGARs equal the host
      oracle's. Overflow pairs take the exact host path.
    * anchor-tiled mode (K4) for pairs beyond the banded buckets
      (near-optimal; PARITY.md divergence #3).

    Runs on the card unless the caller passes device="cpu" (the plain
    versions); without a GPU, "cuda" raises.
    """

    TILE_T = 511  # target rows per tile bucket (T = 512 with +1)
    TILE_W = 512  # query lanes (W)
    # (T, BW) banded buckets: one block of BW threads per pair, DIR scratch
    # (T+1)*BW int8 per pair in device memory
    EXACT_BUCKETS = ((640, 384), (2560, 896))
    PAIRS_PER_LAUNCH = 256  # bounds the DIR scratch (587 MB at 2560x896)
    TILES_PER_LAUNCH = 512

    def __init__(self, device="cuda"):
        self.device = _build.resolve_device(device)
        self.device_tiles = 0
        self.host_fallbacks = 0
        self.exact_pairs = 0
        self.exact_rejects = 0  # band overflow -> host fallback
        self.t_tile = 0.0  # anchors + cut points + tile assembly
        self.t_device = 0.0  # upload + execute + fetch
        self.t_host = 0.0  # host-fallback tiles/pairs
        self.t_asm = 0.0  # ops -> CIGAR assembly
        self.n_dispatches = 0

    def _exact_bucket(self, lq: int, lt: int):
        """Smallest (T, BW) bucket that can hold this pair with a usable
        verification margin, or None."""
        for T, BW in self.EXACT_BUCKETS:
            if lt <= T and lq <= T:
                k = (BW - 1 - abs(lq - lt)) // 2
                if k >= 16:  # enough margin to ever accept
                    return T, BW
        return None

    def edit_align_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]):
        out: List[Optional[str]] = [None] * len(pairs)
        exact_idx = {}
        rest = []
        for pi, (q, t) in enumerate(pairs):
            bk = self._exact_bucket(len(q), len(t))
            if bk is not None:
                exact_idx.setdefault(bk, []).append(pi)
            else:
                rest.append(pi)
        for bk, idxs in exact_idx.items():
            self._run_exact(bk, [(pi, pairs[pi]) for pi in idxs], out)
        if rest:
            tiled = self._tiled_align_batch([pairs[pi] for pi in rest])
            for pi, cg in zip(rest, tiled):
                out[pi] = cg
        return out

    def _run_exact(self, bucket, jobs, out):
        """Banded exact device alignment for (pi, (q, t)) jobs; rejected
        (band-overflow) pairs take the exact host path."""
        from ..pairwise import edit_align, ops_to_cigar

        T, BW = bucket
        for off in range(0, len(jobs), self.PAIRS_PER_LAUNCH):
            chunk = jobs[off : off + self.PAIRS_PER_LAUNCH]
            _t0 = time.perf_counter()
            arrs = pack_banded([qt for _, qt in chunk], T, BW)
            self.t_tile += time.perf_counter() - _t0
            _td = time.perf_counter()
            pt, pq, count, dist = pairwise_banded(*arrs, BW, device=self.device)
            pt, pq = pt.cpu().numpy(), pq.cpu().numpy()
            count, dist = count.cpu().numpy(), dist.cpu().numpy()
            self.t_device += time.perf_counter() - _td
            self.n_dispatches += 1
            Lr = pt.shape[2]
            for n, (pi, (q, t)) in enumerate(chunk):
                b, d = divmod(n, BSUB)
                lq, lt = len(q), len(t)
                k = (BW - 1 - abs(lq - lt)) // 2
                if int(dist[b, 0, d]) <= k - 2:
                    _ta = time.perf_counter()
                    c = int(count[b, 0, d])
                    ops = _ops_from_pairs(pt[b, d, Lr - c :], pq[b, d, Lr - c :])
                    out[pi] = ops_to_cigar(ops.tolist())
                    self.exact_pairs += 1
                    self.t_asm += time.perf_counter() - _ta
                else:
                    _th = time.perf_counter()
                    out[pi] = edit_align(np.asarray(q), np.asarray(t))
                    self.exact_rejects += 1
                    self.host_fallbacks += 1
                    self.t_host += time.perf_counter() - _th

    def _tiled_align_batch(self, pairs):
        from ..pairwise import edit_align, ops_to_cigar

        _t0 = time.perf_counter()
        # 1. tile every pair
        jobs = []  # (pair idx, tile order, q_sub, t_sub)
        results_ops: List[Optional[List[Optional[List[str]]]]] = []
        for pi, (q, t) in enumerate(pairs):
            q = np.asarray(q)
            t = np.asarray(t)
            max_span = self.TILE_T - 1
            if len(q) <= max_span and len(t) <= max_span:
                cuts = [(0, 0), (len(q), len(t))]
            else:
                anchors = _minimizer_anchors(q, t)
                cuts = tile_cut_points(len(q), len(t), anchors, max_span)
            if cuts is None:
                self.host_fallbacks += 1
                results_ops.append(None)  # full host fallback
                continue
            tiles = [
                (q[q0:q1], t[t0:t1])
                for (q0, t0), (q1, t1) in zip(cuts[:-1], cuts[1:])
            ]
            results_ops.append([None] * len(tiles))
            for ti, (qs, ts) in enumerate(tiles):
                jobs.append((pi, ti, qs, ts))
        self.t_tile += time.perf_counter() - _t0

        # 2. run device tiles
        self._run_tiles(jobs, results_ops)

        # 3. assemble CIGARs
        _t0 = time.perf_counter()
        out = []
        for pi, (q, t) in enumerate(pairs):
            if results_ops[pi] is None:
                _th = time.perf_counter()
                out.append(edit_align(np.asarray(q), np.asarray(t)))
                self.t_host += time.perf_counter() - _th
                continue
            ops: List[str] = []
            for tile_ops in results_ops[pi]:
                ops.extend(tile_ops)
            out.append(ops_to_cigar(ops))
        self.t_asm += time.perf_counter() - _t0
        return out

    def _run_tiles(self, jobs, results_ops):
        from ..pairwise import _full_dp_cigar

        _t0 = time.perf_counter()
        device_jobs = []
        for job in jobs:
            pi, ti, qs, ts = job
            if len(qs) == 0 or len(ts) == 0 or len(qs) >= self.TILE_W:
                # degenerate or oversized: host
                self.host_fallbacks += 1
                results_ops[pi][ti] = (
                    ["I"] * len(qs)
                    if len(ts) == 0
                    else ["D"] * len(ts)
                    if len(qs) == 0
                    else _full_dp_cigar(qs, ts)
                )
            else:
                device_jobs.append(job)
        self.t_host += time.perf_counter() - _t0

        T, W = self.TILE_T + 1, self.TILE_W
        for off in range(0, len(device_jobs), self.TILES_PER_LAUNCH):
            chunk = device_jobs[off : off + self.TILES_PER_LAUNCH]
            _t0 = time.perf_counter()
            arrs = pack_tiles([(qs, ts) for _, _, qs, ts in chunk], T, W)
            self.t_tile += time.perf_counter() - _t0
            _td = time.perf_counter()
            pt, pq, count, _ = pairwise_nw(*arrs, device=self.device)
            pt, pq, count = pt.cpu().numpy(), pq.cpu().numpy(), count.cpu().numpy()
            self.t_device += time.perf_counter() - _td
            self.n_dispatches += 1
            L = pt.shape[2]
            _ta = time.perf_counter()
            for n, (pi, ti, qs, ts) in enumerate(chunk):
                b, d = divmod(n, DSUB)
                c = int(count[b, 0, d])
                results_ops[pi][ti] = _ops_from_pairs(
                    pt[b, d, L - c :], pq[b, d, L - c :]
                ).tolist()
                self.device_tiles += 1
            self.t_asm += time.perf_counter() - _ta
