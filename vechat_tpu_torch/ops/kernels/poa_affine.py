"""Affine-gap sequence-to-graph DP (K5) and its three-state traceback walk
(K5w): CUDA kernels in `csrc/poa_affine.cu`, and their plain PyTorch
versions.

Replaces `vechat_tpu/ops/kernels/poa_pallas_affine.py`: `_dp_kernel_affine`
(the Pallas kernel behind `_poa_dp_pallas_affine`) and
`_traceback_walk_affine`. Gap model of the reference SISD engine:

  F[i][j] = max_p max(H[p][j] + g, F[p][j] + e)        (graph-gap channel)
  E[i][j] = max(H[i][j-1] + g, E[i][j-1] + e)          (sequence-gap channel)
  H[i][j] = max(diag_p + prof, F[i][j], E[i][j] [, 0])

Direction words (int32 per cell, ``FE << 16 | Hcode``, see `poa_gap.py`):
Hcode ranks, per in-edge slot, F-extend THEN F-open; the F-chain code in FE
ranks F-open THEN F-extend (the reference's chain loop); bit EB_BIT of FE
says E was formed by extension. Both ranks come from packed maxes
(``value << SH | prio << 9 | delta``), so one max picks the move and the
predecessor row.

K5 (`poa_dp_affine`). One thread block per (graph b, sequence d) of W / LPT
threads, each owning LPT contiguous lanes in registers
(`k5_lanes_per_thread` picks LPT per W), a loop over DP rows. The E
recurrence is a prefix max of ``A0[j] - j*e`` read one lane to the left:
serial over a thread's lanes, a shuffle scan across the warp, one carry a
warp from the totals the warps publish before the row's single block
barrier. An in-edge from the row just
above takes H and F from registers; a warp's first lane rebuilds the left
warp's last H from published values instead of reading a ring slot that
would race. The two int16 rings serve the other in-edges and sit in shared
memory while ``2*(R+1)*W*2`` bytes fit K5's own limit (`K5_SMEM_RING_MAX`,
Hopper's 227 KB less the row exchange), else in a global scratch ring. The
kernel is bound by the latency of the row chain: the spoa path launches one
block. The direction rows are int32, 4 bytes a cell.

K5w (`traceback_walk_affine`). One warp a walk over tiles of its int32
direction words staged in shared memory; the pairs go out 32 columns at a
time, with node ids when given `node_id`, and the warp writes the -2
columns itself (`poa_gap.py`). An nw walk ends at cell (0, 0) in any state
(`poa_gap._walk3_plain` says why).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, poa_gap
from .poa_gap import CHAIN_BIT
from .poa_linear import (
    DELTA_BITS,
    MODES,
    NEG16,
    NEGV,
    SMEM_MAX,
    TIE,
    best_cell,
    best_init,
    best_masks,
    check_dp_inputs,
    ring_slots,
    to_i32,
)

EB_BIT = CHAIN_BIT  # E-extension flag bit in the FE halfword

# K5's launch: the lanes a thread its kernel is instantiated for, and the
# bytes its two rings may take in shared memory (Hopper's 227 KB a block,
# less the row exchange and the reductions' 224 ints)
K5_LPTS = (1, 2, 3, 4, 5, 6)
K5_SMEM_RING_MAX = SMEM_MAX - 224 * 4


def k5_lanes_per_thread(W: int) -> int:
    """K5's lanes a thread at width W: the largest of K5_LPTS that divides
    W/32, so that the block's W / LPT threads are whole warps (at the spoa
    path's W=576, 6: three warps, the fastest of those measured; PERF.md).
    Raises on a W that is not a multiple of 32 in [32, 1024]."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError(f"W={W} must be a multiple of 32 in [32, 1024]")
    return max(n for n in K5_LPTS if (W // 32) % n == 0)


def fits_int16_affine(n_cap: int, w_cap: int, m: int, x: int, g: int, e: int) -> bool:
    worst = (n_cap + w_cap + 2) * max(abs(m), abs(x), abs(g), abs(e))
    return worst <= 14000 and n_cap + 1 < TIE


def sh_bits_aff(P: int) -> int:
    """H-combo shift: prio space 3P+3 + delta field."""
    return int(np.ceil(np.log2(3 * P + 3))) + DELTA_BITS


def shf_bits(P: int) -> int:
    """F-combo shift: prio space 2P + delta field."""
    return int(np.ceil(np.log2(max(2 * P, 2)))) + DELTA_BITS


def pack_aux_gap(preds: torch.Tensor, R: int):
    """aux[b, p, r] = hslot << 16 | delta (no priority: the affine and
    convex kernels rank each slot's candidates themselves) and the true
    in-degree, from preds [B, P, N]. Returns (aux int32, deg [B, N] int32)."""
    hslot, delta, deg = ring_slots(preds, R)
    return ((hslot << 16) | delta).to(torch.int32).contiguous(), deg


# ------------------------------------------------------------------ K5: DP


def _dp_affine_plain(codes, aux, deg, sink, n_nodes, seqp, slen, mode, m, x, g, e, R):
    """Plain PyTorch version of K5: vectorised over B, D, W and the in-edge
    slots, a Python loop over DP rows. Same outputs as the kernel, bit for
    bit (rows past a graph's n_nodes hold values nothing reads)."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dev = seqp.device
    i32 = torch.int32
    SH, SHF = sh_bits_aff(P), shf_bits(P)
    NPRIO = 3 * P + 3
    MASKC, MASKF = (1 << SH) - 1, (1 << SHF) - 1
    const = lambda v: torch.full((), v, dtype=i32, device=dev)  # noqa: E731
    EEXT = const((NPRIO - 1 - 3 * P) << DELTA_BITS)
    EOPEN = const((NPRIO - 1 - (3 * P + 1)) << DELTA_BITS)
    HSTOP = 0
    prof_m, prof_x = const(m * (1 << SH)), const(x * (1 << SH))
    cell_mask, best_row, jlane = best_masks(n_nodes, sink, slen, N, W, mode, dev)
    lane0 = jlane == 0
    je = jlane * e
    # per-slot priorities: H dispatch (diag; F-extend then F-open) and the
    # F chain (F-open then F-extend)
    pidx = torch.arange(P, dtype=i32, device=dev)[None, :, None, None]
    hp_diag = (NPRIO - 1 - pidx) << DELTA_BITS
    hp_fext = (NPRIO - 1 - (P + 2 * pidx)) << DELTA_BITS
    hp_fopen = (NPRIO - 1 - (P + 2 * pidx + 1)) << DELTA_BITS
    fp_open = (2 * P - 1 - 2 * pidx) << DELTA_BITS
    fp_ext = (2 * P - 1 - (2 * pidx + 1)) << DELTA_BITS
    ring_base = torch.arange(B, device=dev)[:, None] * (R + 1)
    hrow = (aux >> 16).long() + ring_base[:, :, None]  # [B, P, N] row of Hf / Ff
    dlt = (aux & 0xFFFF)[:, :, :, None, None]  # [B, P, N, 1, 1]
    slot_live = (torch.arange(P, device=dev)[None, :, None] < deg[:, None, :])[..., None, None]

    H = torch.zeros((B, R + 1, D, W), dtype=torch.int16, device=dev)
    F = torch.zeros((B, R + 1, D, W), dtype=torch.int16, device=dev)
    Hf, Ff = H.view(B * (R + 1), D, W), F.view(B * (R + 1), D, W)
    dirs = torch.zeros((B, N + 1, D, W), dtype=i32, device=dev)
    if mode != "sw":
        H[:, R] = torch.where(lane0, 0, g + (jlane - 1) * e).to(torch.int16)
        row0_h = torch.where(jlane == 1, EOPEN, EEXT)
        row0_fe = (jlane >= 2).to(i32) << EB_BIT
        dirs[:, 0] = (row0_fe << 16) | row0_h
    F[:, R] = torch.where(lane0, g - e, NEG16).to(torch.int16)
    bestc = best_init(B, D, W, mode, dev)
    n_max = int(n_nodes.max()) if B else 0
    deg_max = deg.max(dim=0).values.tolist() if B else []
    for hr in range(1, n_max + 1):
        r = hr - 1
        pm = deg_max[r]
        prof = torch.where(seqp == codes[:, r, None, None], prof_m, prof_x)[:, None]
        sel = hrow[:, :pm, r].reshape(-1)
        rowH = Hf.index_select(0, sel).view(B, pm, D, W).to(i32)
        rowF = Ff.index_select(0, sel).view(B, pm, D, W).to(i32)
        d = dlt[:, :pm, r]
        dead = ~slot_live[:, :pm, r]
        diag = torch.roll(rowH * (1 << SH), 1, dims=3) + (prof + hp_diag[:, :pm] + d)
        diag[..., 0] = NEGV
        vext, vopen = rowF + e, rowH + g
        fext = vext * (1 << SH) + (hp_fext[:, :pm] + d)
        fopen = vopen * (1 << SH) + (hp_fopen[:, :pm] + d)
        # padding slots repeat slot 0 at lower priorities: masking them
        # leaves both maxes unchanged
        acc = torch.maximum(diag, torch.maximum(fext, fopen)).masked_fill_(dead, NEGV).amax(dim=1)
        ff = torch.maximum(
            vext * (1 << SHF) + (fp_ext[:, :pm] + d), vopen * (1 << SHF) + (fp_open[:, :pm] + d)
        )
        facc = ff.masked_fill_(dead, NEGV).amax(dim=1)
        Fr, fcode = facc >> SHF, facc & MASKF
        A, hcode = acc >> SH, acc & MASKC
        if mode != "nw":
            # sw/ov: H[i][0] = 0; the boundary column never back-tracks
            A = A.masked_fill(lane0, 0)
            hcode = hcode.masked_fill(lane0, HSTOP)
        A0 = A.clamp_min(0) if mode == "sw" else A
        # E scan: S[j] = A0[j] - j*e; M = running max; E[j] = M[j-1] + g + (j-1)e
        t = torch.cummax(A0 - je, dim=2).values
        Erow = torch.roll(t, 1, dims=2) + (g - e) + je
        Erow = Erow.masked_fill(lane0, NEG16)
        EB = (Erow == torch.roll(Erow, 1, dims=2) + e) & (jlane >= 2)
        Hfin = torch.maximum(A0, Erow)
        hcode = torch.where(Erow > A0, torch.where(EB, EEXT, EOPEN), hcode)
        if mode == "sw":
            Hfin = Hfin.clamp_min(0)
            hcode = hcode.masked_fill(Hfin == 0, HSTOP)
        # clamp the poison floor so dead lanes cannot drift past int16
        H[:, r % R] = Hfin.clamp_min(NEG16).to(torch.int16)
        F[:, r % R] = Fr.clamp_min(NEG16).to(torch.int16)
        fe = fcode | (EB.to(i32) << EB_BIT)
        dirs[:, hr] = (fe << 16) | hcode
        upd = cell_mask & best_row[:, r, None, None]
        bestc = torch.where(upd, torch.maximum(bestc, Hfin * TIE + (TIE - 1 - hr)), bestc)
    return (dirs, *best_cell(bestc, jlane, mode))


_DP_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("poa_affine")
    if lib.poa_dp_affine_launch.argtypes is None:
        lib.poa_dp_affine_launch.argtypes = _DP_ARGS
        lib.poa_dp_affine_launch.restype = ctypes.c_int
        lib.poa_walk_affine_launch.argtypes = poa_gap.WALK3_ARGS
        lib.poa_walk_affine_launch.restype = ctypes.c_int
    return lib


def poa_dp_affine(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e, R):
    """K5. codes/deg/sink [B, N], aux [B, P, N] (`pack_aux_gap`), n_nodes
    [B], seqp [B, D, W] (lane j = code of sequence position j-1), slen
    [B, D]; all int32 on one device. R: ring rows (every predecessor
    distance <= R).

    Returns dirs [B, N+1, D, W] int32 (rows past a graph's n_nodes are
    undefined on the card), maxi, maxj, score [B, D] int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    B, P, N, D, W = check_dp_inputs(codes, aux, deg, sink, n_nodes, seqp, slen, R)
    MODES[align_type]  # an unknown mode raises on either device
    dev = seqp.device
    if dev.type == "cpu":
        return _dp_affine_plain(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e, R)
    lpt = k5_lanes_per_thread(W)
    dirs, maxi, maxj, score, rings = poa_gap.dp_buffers(B, N, D, W, R, 2, dev, K5_SMEM_RING_MAX)
    if B * D == 0:
        return dirs, maxi, maxj, score
    with torch.cuda.device(dev):
        rc = launch_dp_affine(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e,
                              R, (dirs, maxi, maxj, score, rings), lpt)
    _build.check(_lib(), rc, "poa_dp_affine")
    _build.LAUNCHES["poa_dp_affine"] += 1
    return dirs, maxi, maxj, score


def launch_dp_affine(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e, R, out,
                     lanes_per_thread):
    """K5's C launcher on checked inputs and the buffers `out` (dirs, maxi,
    maxj, score, rings of `poa_gap.dp_buffers` at K5_SMEM_RING_MAX), on the
    current stream, at `lanes_per_thread` (one of K5_LPTS dividing W/32;
    the launcher returns an error for any other); counts nothing and
    returns the cudaError_t. The wrapper calls it at
    `k5_lanes_per_thread(W)`; timing the kernel alone (a CUDA graph of
    launches) and at other lanes a thread calls it directly."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dirs, maxi, maxj, score, rings = out
    return _lib().poa_dp_affine_launch(
        codes.data_ptr(), aux.data_ptr(), deg.data_ptr(), sink.data_ptr(),
        n_nodes.data_ptr(), seqp.data_ptr(), slen.data_ptr(),
        dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), score.data_ptr(),
        0 if rings is None else rings.data_ptr(),
        B, N, P, D, W, R, MODES[align_type], m, x, g, e, int(rings is None),
        sh_bits_aff(P), lanes_per_thread,
        torch.cuda.current_stream(seqp.device).cuda_stream,
    )


# -------------------------------------------------------------- K5w: walk


def _walk_affine_plain(dirs, maxi, maxj, mode, L, P, node_id=None):
    """Plain PyTorch version of K5w (H / F-chain / E-chain)."""
    return poa_gap._walk3_plain(dirs, maxi, maxj, mode, L, P, 1, node_id)


def traceback_walk_affine(dirs, maxi, maxj, align_type, L, P, node_id=None):
    """K5w. dirs [B, N1, D, W] int32 from `poa_dp_affine`, maxi/maxj [B, D]
    int32; node_id [B, N1-1] int32 or None. Returns pn, pp [B, D, L] int32
    (pairs back to front in the last `count` columns, -2 elsewhere; pn
    holds DP ranks, or node ids with `node_id`) and count [B, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return poa_gap.walk3(dirs, maxi, maxj, align_type, L, P, 1, _lib, "poa_walk_affine",
                         node_id)


# ------------------------------------------------------- public entry point


def poa_align_affine(codes, preds, sink, n_nodes, seqp, seq_len, align_type, m, x, g, e,
                     ring: int = 0, device="cuda", node_id=None):
    """K5 then K5w on the JAX package's layouts (`poa_align_pallas_affine`):
    codes/sink [B, 1, N], preds [B, P, N] (DP rows), n_nodes [B, 1, 1],
    seqp [B, D, W], seq_len [B, 1, D]; numpy arrays or tensors of any
    integer dtype. ring: ring rows (0 = full history). node_id [B, 1, N]:
    pn holds these node ids (`emit_node_ids=True`), not DP ranks (without
    it, as `emit_node_ids=False`).

    Returns (pn, pp [B, D, L], count [B, 1, D], score [B, 1, D]), int32
    tensors on `device`; L = 2N + W (F chains can visit more rows than a
    linear path). `device` is the card unless the caller asks for "cpu"
    (the plain versions); without a GPU, "cuda" raises. On the card W must
    be a multiple of 4 (the walk copies its tiles in 16-byte pieces), else
    the walk raises."""
    device = _build.resolve_device(device)
    preds = to_i32(preds, device)
    B, P, N = preds.shape
    seqp = to_i32(seqp, device)
    D, W = seqp.shape[1], seqp.shape[2]
    nid = None if node_id is None else to_i32(node_id, device).reshape(B, N)
    R = N if ring <= 0 or ring > N else ring
    aux, deg = pack_aux_gap(preds, R)
    dirs, maxi, maxj, score = poa_dp_affine(
        to_i32(codes, device).reshape(B, N), aux, deg,
        to_i32(sink, device).reshape(B, N), to_i32(n_nodes, device).reshape(B),
        seqp, to_i32(seq_len, device).reshape(B, D),
        align_type, m, x, g, e, R,
    )
    pn, pp, count = traceback_walk_affine(dirs, maxi, maxj, align_type, 2 * N + W, P, nid)
    return pn, pp, count[:, None, :], score[:, None, :]
