"""Convex (dual-affine, min-of-two-affines) sequence-to-graph DP (K6) and
its three-state traceback walk (K6w): CUDA kernels in `csrc/poa_convex.cu`,
and their plain PyTorch versions.

Replaces `vechat_tpu/ops/kernels/poa_pallas_convex.py`: `_dp_kernel_convex`
(the Pallas kernel behind `_poa_dp_pallas_convex`) and
`_traceback_walk_convex`. Channels (F, E) with (g, e) and (O, Q) with (q, c):

  F[i][j] = max_p max(H[p][j] + g, F[p][j] + e)
  O[i][j] = max_p max(H[p][j] + q, O[p][j] + c)
  E[i][j] = max(H[i][j-1] + g, E[i][j-1] + e)
  Q[i][j] = max(H[i][j-1] + q, Q[i][j-1] + c)
  H[i][j] = max(diag, F, O, E, Q [, 0])

The in-row (E, Q) pair is coupled through H. With A0 the pre-E/Q H and the
convex ordering q < g < e < c it is the max-plus linear recurrence

  [E_j]   [e  g]   [E_{j-1}]   [A0[j-1]+g]
  [Q_j] = [q  c] x [Q_{j-1}] + [A0[j-1]+q]

solved in the plain version by a doubling scan over the row that applies
the matrix power M^(2^s) at offset 2^s (`mat_powers`), as the reference
does; the kernel composes the same max-plus products in another order
(`k6_powers`), with the same result.

Direction words (int32 per cell, ``FOCB << 16 | Hcode``, see `poa_gap.py`):
Hcode ranks diag per slot; per slot F-ext, F-open, O-ext, O-open; then
E-ext, E-open, Q-ext, Q-open; the sw stop. FOCB: bit CB_BIT = E or Q
extends; below it the vertical-chain code: continue through the first slot
whose F or O EXTENDS to the final value (all continues rank before all
stops), else stop at the first slot that opens it.

K6 (`poa_dp_convex`). One thread block per (graph b, sequence d) of W / LPT
threads, each owning LPT contiguous lanes in registers
(`k6_lanes_per_thread` picks LPT per W), a loop over DP rows, on K5's row
machinery (`csrc/gap_rows.cuh`). The scan is serial over a thread's lanes,
a shuffle scan across the warp applying M^(LPT 2^s), and one carry a warp
from the totals the warps publish before the row's single block barrier,
scanned across the warps' lanes with M^(32 LPT 2^s); every power of M
comes from the host
(`k6_powers`). An in-edge from the row just above takes H, F and O from
registers; a warp's first lane rebuilds the left warp's last H from
published values. The three int16 rings (H, F, O) serve the other
in-edges and sit in shared memory while ``3*(R+1)*W*2`` bytes fit K6's own
limit (`K6_SMEM_RING_MAX`, Hopper's 227 KB less the row exchange), else in
a global scratch ring. The kernel is bound by the latency of the row
chain: the spoa path launches one block.

K6w (`traceback_walk_convex`). One warp a walk over tiles of its int32
direction words staged in shared memory; the pairs go out 32 columns at a
time, with node ids when given `node_id`, and the warp writes the -2
columns itself (`poa_gap.py`). An nw walk ends at cell (0, 0) in any state
(`poa_gap._walk3_plain` says why).

P (in-edge slots) is capped at P_CAP so the Hcode priorities (5P+5) and the
delta fit 16 bits; graphs of larger in-degree go to the host engine.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, poa_gap
from .poa_affine import pack_aux_gap
from .poa_gap import CHAIN_BIT
from .poa_linear import (
    DELTA_BITS,
    DMASK,
    MODES,
    NEG16,
    NEGV,
    SMEM_MAX,
    TIE,
    best_cell,
    best_init,
    best_masks,
    check_dp_inputs,
    to_i32,
)

CB_BIT = CHAIN_BIT  # "E or Q extends" flag bit in the FOCB halfword
P_CAP = 8

# K6's launch: the lanes a thread its kernel is instantiated for, and the
# bytes its three rings may take in shared memory (Hopper's 227 KB a block,
# less the row exchange and the reductions' 352 ints)
K6_LPTS = (1, 2, 3, 4, 5, 6)
K6_SMEM_RING_MAX = SMEM_MAX - 352 * 4


def k6_lanes_per_thread(W: int) -> int:
    """K6's lanes a thread at width W: the largest of K6_LPTS that divides
    W/32 (whole warps) and leaves the block at least four warps, one to
    each of an SM's schedulers; 1 below W=128. At the spoa engine's widths
    128, 320, 576, 768: 1, 2, 3, 6, the fastest of every choice measured
    there at one block (PERF.md, `k1_probe.py time-k6`). Raises on a W
    that is not a multiple of 32 in [32, 1024]."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError(f"W={W} must be a multiple of 32 in [32, 1024]")
    return max(n for n in K6_LPTS if (W // 32) % n == 0 and (n == 1 or W // (32 * n) >= 4))


def fits_int16_convex(
    n_cap: int, w_cap: int, m: int, x: int, g: int, e: int, q: int, c: int
) -> bool:
    worst = (n_cap + w_cap + 2) * max(abs(m), abs(x), abs(g), abs(e), abs(q), abs(c))
    return worst <= 14000 and n_cap + 1 < TIE


def sh_bits_cvx(P: int) -> int:
    return int(np.ceil(np.log2(5 * P + 5))) + DELTA_BITS


def shf_bits_cvx(P: int) -> int:
    return int(np.ceil(np.log2(max(2 * P, 2)))) + DELTA_BITS


def mat_powers(g: int, e: int, q: int, c: int, log_w: int):
    """Max-plus powers M^(2^s), s < log_w, of M = [[e, g], [q, c]]
    (Python ints)."""
    out = [[[e, g], [q, c]]]
    for _ in range(log_w - 1):
        out.append(_mp_mul(out[-1], out[-1]))
    return out


def _mp_mul(A, B):
    return [[max(A[i][0] + B[0][j], A[i][1] + B[1][j]) for j in range(2)] for i in range(2)]


def mat_power(g: int, e: int, q: int, c: int, k: int):
    """Max-plus power M^k, k >= 1, of M = [[e, g], [q, c]] (Python ints),
    by squaring."""
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    out, sq = None, [[e, g], [q, c]]
    while k:
        if k & 1:
            out = sq if out is None else _mp_mul(out, sq)
        k >>= 1
        if k:
            sq = _mp_mul(sq, sq)
    return out


@functools.lru_cache(maxsize=64)
def k6_powers(g: int, e: int, q: int, c: int, lpt: int):
    """The powers of M = [[e, g], [q, c]] that K6 at `lpt` lanes a thread
    takes (`MpPowers` in csrc/gap_rows.cuh), each flattened (m11, m12, m21,
    m22): M^1..M^6, M^(lpt 2^s) and M^(32 lpt 2^s) for s < 5, and
    M^(32 lpt - 1). Returns a tuple of 68 ints."""
    mats = [mat_power(g, e, q, c, k) for k in range(1, 7)]
    mats += [mat_power(g, e, q, c, lpt << s) for s in range(5)]
    mats += [mat_power(g, e, q, c, 32 * lpt << s) for s in range(5)]
    mats += [mat_power(g, e, q, c, 32 * lpt - 1)]
    return tuple(v for M in mats for row in M for v in row)


@functools.lru_cache(maxsize=64)
def _powers_arg(g: int, e: int, q: int, c: int, lpt: int):
    p = k6_powers(g, e, q, c, lpt)
    return (ctypes.c_int * len(p))(*p)


def _log_w(W: int) -> int:
    return int(np.ceil(np.log2(W)))


def _check_p(P: int) -> None:
    if P > P_CAP:
        raise ValueError(f"convex kernel supports P <= {P_CAP}, got {P}")


# ------------------------------------------------------------------ K6: DP


def _dp_convex_plain(codes, aux, deg, sink, n_nodes, seqp, slen, mode, m, x, g, e, q, c, R):
    """Plain PyTorch version of K6: vectorised over B, D, W and the in-edge
    slots, a Python loop over DP rows. Same outputs as the kernel, bit for
    bit (rows past a graph's n_nodes hold values nothing reads)."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dev = seqp.device
    i32 = torch.int32
    SH, SHF = sh_bits_cvx(P), shf_bits_cvx(P)
    NPRIO = 5 * P + 5
    MASKC = (1 << SH) - 1
    SLOTMASK = (1 << (SHF - DELTA_BITS)) - 1
    BIGS = 1 << 20
    const = lambda v: torch.full((), v, dtype=i32, device=dev)  # noqa: E731
    EEXT = const((NPRIO - 1 - 5 * P) << DELTA_BITS)
    EOPEN = const((NPRIO - 1 - (5 * P + 1)) << DELTA_BITS)
    QEXT = const((NPRIO - 1 - (5 * P + 2)) << DELTA_BITS)
    QOPEN = const((NPRIO - 1 - (5 * P + 3)) << DELTA_BITS)
    HSTOP = 0
    prof_m, prof_x = const(m * (1 << SH)), const(x * (1 << SH))
    cell_mask, best_row, jlane = best_masks(n_nodes, sink, slen, N, W, mode, dev)
    lane0 = jlane == 0
    log_w = _log_w(W)
    MP = mat_powers(g, e, q, c, log_w)
    scan_ok = [jlane >= (1 << s) for s in range(log_w)]
    # per-slot priorities: H dispatch (diag; F-ext, F-open, O-ext, O-open)
    # and the channel winners (slot priority descending: a packed max picks
    # the first slot on ties)
    pidx = torch.arange(P, dtype=i32, device=dev)[None, :, None, None]
    hp_diag = (NPRIO - 1 - pidx) << DELTA_BITS
    hp_v = [(NPRIO - 1 - (P + 4 * pidx + k)) << DELTA_BITS for k in range(4)]
    sp_all = (P - 1 - pidx) << DELTA_BITS
    ring_base = torch.arange(B, device=dev)[:, None] * (R + 1)
    hrow = (aux >> 16).long() + ring_base[:, :, None]  # [B, P, N] row of the flat rings
    dlt = (aux & 0xFFFF)[:, :, :, None, None]  # [B, P, N, 1, 1]
    slot_live = (torch.arange(P, device=dev)[None, :, None] < deg[:, None, :])[..., None, None]

    H, F, O = (torch.zeros((B, R + 1, D, W), dtype=torch.int16, device=dev) for _ in range(3))
    Hf, Ff, Of = (t.view(B * (R + 1), D, W) for t in (H, F, O))
    dirs = torch.zeros((B, N + 1, D, W), dtype=i32, device=dev)
    if mode != "sw":
        e_init = g + (jlane - 1) * e
        q_init = q + (jlane - 1) * c
        H[:, R] = torch.where(lane0, 0, torch.maximum(e_init, q_init)).to(torch.int16)
        # dispatch along row 0: lane 1 E-open; beyond it E-ext where the E
        # line carries the max, else Q-ext
        row0_h = torch.where(jlane == 1, EOPEN, torch.where(e_init >= q_init, EEXT, QEXT))
        row0_cb = (jlane >= 2).to(i32) << CB_BIT
        dirs[:, 0] = (row0_cb << 16) | row0_h
    F[:, R] = torch.where(lane0, g - e, NEG16).to(torch.int16)
    O[:, R] = torch.where(lane0, q - c, NEG16).to(torch.int16)
    bestc = best_init(B, D, W, mode, dev)

    def slot_of(combo):
        return (P - 1) - ((combo >> DELTA_BITS) & SLOTMASK)

    n_max = int(n_nodes.max()) if B else 0
    deg_max = deg.max(dim=0).values.tolist() if B else []
    for hr in range(1, n_max + 1):
        r = hr - 1
        pm = deg_max[r]
        prof = torch.where(seqp == codes[:, r, None, None], prof_m, prof_x)[:, None]
        sel = hrow[:, :pm, r].reshape(-1)
        rowH, rowF, rowO = (
            t.index_select(0, sel).view(B, pm, D, W).to(i32) for t in (Hf, Ff, Of)
        )
        d = dlt[:, :pm, r]
        dead = ~slot_live[:, :pm, r]
        diag = torch.roll(rowH * (1 << SH), 1, dims=3) + (prof + hp_diag[:, :pm] + d)
        diag[..., 0] = NEGV
        vals = (rowF + e, rowH + g, rowO + c, rowH + q)  # F-ext, F-open, O-ext, O-open
        cand = diag
        for v, hp in zip(vals, hp_v):
            cand = torch.maximum(cand, v * (1 << SH) + (hp[:, :pm] + d))
        # padding slots repeat slot 0 at lower priorities: masking them
        # leaves every max unchanged
        acc = cand.masked_fill_(dead, NEGV).amax(dim=1)
        sp = sp_all[:, :pm] + d
        fe_, fo_, oe_, oo_ = (
            (v * (1 << SHF) + sp).masked_fill_(dead, NEGV).amax(dim=1) for v in vals
        )
        # opens masked at lane 0: F/O column-0 values are pure extends
        fo_ = fo_.masked_fill(lane0, NEGV)
        oo_ = oo_.masked_fill(lane0, NEGV)
        Fr = torch.maximum(fe_, fo_) >> SHF
        Or = torch.maximum(oe_, oo_) >> SHF
        A, hcode = acc >> SH, acc & MASKC

        # vertical-chain code: first slot whose channel EXTENDS to the final
        # F/O value, else first slot that OPENS it
        fe_slot = torch.where((fe_ >> SHF) == Fr, slot_of(fe_), BIGS)
        oe_slot = torch.where((oe_ >> SHF) == Or, slot_of(oe_), BIGS)
        fo_slot = torch.where((fo_ >> SHF) == Fr, slot_of(fo_), BIGS)
        oo_slot = torch.where((oo_ >> SHF) == Or, slot_of(oo_), BIGS)
        cont_slot = torch.minimum(fe_slot, oe_slot)
        stop_slot = torch.minimum(fo_slot, oo_slot)
        cont_delta = torch.where(fe_slot <= oe_slot, fe_, oe_) & DMASK
        stop_delta = torch.where(fo_slot <= oo_slot, fo_, oo_) & DMASK
        has_cont = cont_slot < BIGS
        chain_prio = torch.where(
            has_cont, 2 * P - 1 - cont_slot, (2 * P - 1 - (P + stop_slot)).clamp_min(0)
        )
        focode = (chain_prio << DELTA_BITS) | torch.where(has_cont, cont_delta, stop_delta)

        if mode != "nw":
            A = A.masked_fill(lane0, 0)
            hcode = hcode.masked_fill(lane0, HSTOP)
        A0 = A.clamp_min(0) if mode == "sw" else A

        # coupled (E, Q) max-plus doubling scan over b = (A0+g, A0+q)
        l0neg = lane0.to(i32) * NEGV
        Ev = torch.roll(A0 + g, 1, dims=2) + l0neg
        Qv = torch.roll(A0 + q, 1, dims=2) + l0neg
        for s in range(log_w):
            shE = torch.roll(Ev, 1 << s, dims=2)
            shQ = torch.roll(Qv, 1 << s, dims=2)
            (m11, m12), (m21, m22) = MP[s]
            Ev, Qv = (
                torch.maximum(Ev, torch.maximum(shE + m11, shQ + m12).masked_fill_(~scan_ok[s], NEGV)),
                torch.maximum(Qv, torch.maximum(shE + m21, shQ + m22).masked_fill_(~scan_ok[s], NEGV)),
            )
        Ev = Ev.masked_fill(lane0, NEG16)
        Qv = Qv.masked_fill(lane0, NEG16)
        EBe = (Ev == torch.roll(Ev, 1, dims=2) + e) & (jlane >= 2)
        QBq = (Qv == torch.roll(Qv, 1, dims=2) + c) & (jlane >= 2)
        CB = EBe | QBq
        EQ = torch.maximum(Ev, Qv)
        # dispatch order among the seq-gap candidates: E-ext, E-open, Q-ext,
        # Q-open, by a packed max over the two channels
        epack = Ev * (1 << SH) + torch.where(EBe, EEXT, EOPEN)
        qpack = Qv * (1 << SH) + torch.where(QBq, QEXT, QOPEN)
        eqcode = torch.maximum(epack, qpack) & MASKC
        Hfin = torch.maximum(A0, EQ)
        hcode = torch.where(EQ > A0, eqcode, hcode)
        if mode == "sw":
            Hfin = Hfin.clamp_min(0)
            hcode = hcode.masked_fill(Hfin == 0, HSTOP)
        # clamp the poison floor so dead lanes cannot drift past int16
        H[:, r % R] = Hfin.clamp_min(NEG16).to(torch.int16)
        F[:, r % R] = Fr.clamp_min(NEG16).to(torch.int16)
        O[:, r % R] = Or.clamp_min(NEG16).to(torch.int16)
        fo = focode | (CB.to(i32) << CB_BIT)
        dirs[:, hr] = (fo << 16) | hcode
        upd = cell_mask & best_row[:, r, None, None]
        bestc = torch.where(upd, torch.maximum(bestc, Hfin * TIE + (TIE - 1 - hr)), bestc)
    return (dirs, *best_cell(bestc, jlane, mode))


_DP_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 15 + [ctypes.c_void_p, ctypes.c_int,
                                                            ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("poa_convex")
    if lib.poa_dp_convex_launch.argtypes is None:
        lib.poa_dp_convex_launch.argtypes = _DP_ARGS
        lib.poa_dp_convex_launch.restype = ctypes.c_int
        lib.poa_walk_convex_launch.argtypes = poa_gap.WALK3_ARGS
        lib.poa_walk_convex_launch.restype = ctypes.c_int
    return lib


def poa_dp_convex(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e, q, c, R):
    """K6. codes/deg/sink [B, N], aux [B, P, N] (`pack_aux_gap`, P <= P_CAP),
    n_nodes [B], seqp [B, D, W] (lane j = code of sequence position j-1),
    slen [B, D]; all int32 on one device. R: ring rows (every predecessor
    distance <= R).

    Returns dirs [B, N+1, D, W] int32 (rows past a graph's n_nodes are
    undefined on the card), maxi, maxj, score [B, D] int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    B, P, N, D, W = check_dp_inputs(codes, aux, deg, sink, n_nodes, seqp, slen, R)
    _check_p(P)
    MODES[align_type]  # an unknown mode raises on either device
    dev = seqp.device
    if dev.type == "cpu":
        return _dp_convex_plain(
            codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e, q, c, R
        )
    lpt = k6_lanes_per_thread(W)
    dirs, maxi, maxj, score, rings = poa_gap.dp_buffers(B, N, D, W, R, 3, dev, K6_SMEM_RING_MAX)
    if B * D == 0:
        return dirs, maxi, maxj, score
    with torch.cuda.device(dev):
        rc = launch_dp_convex(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e,
                              q, c, R, (dirs, maxi, maxj, score, rings), lpt)
    _build.check(_lib(), rc, "poa_dp_convex")
    _build.LAUNCHES["poa_dp_convex"] += 1
    return dirs, maxi, maxj, score


def launch_dp_convex(codes, aux, deg, sink, n_nodes, seqp, slen, align_type, m, x, g, e, q, c, R,
                     out, lanes_per_thread):
    """K6's C launcher on checked inputs and the buffers `out` (dirs, maxi,
    maxj, score, rings of `poa_gap.dp_buffers` at K6_SMEM_RING_MAX), on the
    current stream, at `lanes_per_thread` (one of K6_LPTS dividing W/32;
    the launcher returns an error for any other); counts nothing and
    returns the cudaError_t. The wrapper calls it at
    `k6_lanes_per_thread(W)`; timing the kernel alone (a CUDA graph of
    launches) and at other lanes a thread calls it directly."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dirs, maxi, maxj, score, rings = out
    lpt = lanes_per_thread if lanes_per_thread in K6_LPTS else 1  # the launcher refuses others
    return _lib().poa_dp_convex_launch(
        codes.data_ptr(), aux.data_ptr(), deg.data_ptr(), sink.data_ptr(),
        n_nodes.data_ptr(), seqp.data_ptr(), slen.data_ptr(),
        dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), score.data_ptr(),
        0 if rings is None else rings.data_ptr(),
        B, N, P, D, W, R, MODES[align_type], m, x, g, e, q, c, int(rings is None),
        sh_bits_cvx(P), _powers_arg(g, e, q, c, lpt), lanes_per_thread,
        torch.cuda.current_stream(seqp.device).cuda_stream,
    )


# -------------------------------------------------------------- K6w: walk


def _walk_convex_plain(dirs, maxi, maxj, mode, L, P, node_id=None):
    """Plain PyTorch version of K6w (H / vertical chain / seq-gap chain)."""
    return poa_gap._walk3_plain(dirs, maxi, maxj, mode, L, P, 2, node_id)


def traceback_walk_convex(dirs, maxi, maxj, align_type, L, P, node_id=None):
    """K6w. dirs [B, N1, D, W] int32 from `poa_dp_convex`, maxi/maxj [B, D]
    int32; node_id [B, N1-1] int32 or None. Returns pn, pp [B, D, L] int32
    (pairs back to front in the last `count` columns, -2 elsewhere; pn
    holds DP ranks, or node ids with `node_id`) and count [B, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_p(P)
    return poa_gap.walk3(dirs, maxi, maxj, align_type, L, P, 2, _lib, "poa_walk_convex",
                         node_id)


# ------------------------------------------------------- public entry point


def poa_align_convex(codes, preds, sink, n_nodes, seqp, seq_len, align_type, m, x, g, e, q, c,
                     ring: int = 0, device="cuda", node_id=None):
    """K6 then K6w on the JAX package's layouts (`poa_align_pallas_convex`):
    codes/sink [B, 1, N], preds [B, P, N] (DP rows, P <= P_CAP), n_nodes
    [B, 1, 1], seqp [B, D, W], seq_len [B, 1, D]; numpy arrays or tensors
    of any integer dtype. ring: ring rows (0 = full history). node_id
    [B, 1, N]: pn holds these node ids (`emit_node_ids=True`), not DP
    ranks (without it, as `emit_node_ids=False`).

    Returns (pn, pp [B, D, L], count [B, 1, D], score [B, 1, D]), int32
    tensors on `device`; L = 2N + W. `device` is the card unless the caller
    asks for "cpu" (the plain versions); without a GPU, "cuda" raises. On
    the card W must be a multiple of 4 (the walk copies its tiles in
    16-byte pieces), else the walk raises."""
    device = _build.resolve_device(device)
    preds = to_i32(preds, device)
    B, P, N = preds.shape
    _check_p(P)
    seqp = to_i32(seqp, device)
    D, W = seqp.shape[1], seqp.shape[2]
    nid = None if node_id is None else to_i32(node_id, device).reshape(B, N)
    R = N if ring <= 0 or ring > N else ring
    aux, deg = pack_aux_gap(preds, R)
    dirs, maxi, maxj, score = poa_dp_convex(
        to_i32(codes, device).reshape(B, N), aux, deg,
        to_i32(sink, device).reshape(B, N), to_i32(n_nodes, device).reshape(B),
        seqp, to_i32(seq_len, device).reshape(B, D),
        align_type, m, x, g, e, q, c, R,
    )
    pn, pp, count = traceback_walk_convex(dirs, maxi, maxj, align_type, 2 * N + W, P, nid)
    return pn, pp, count[:, None, :], score[:, None, :]
