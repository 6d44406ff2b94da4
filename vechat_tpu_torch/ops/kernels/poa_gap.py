"""What the affine (`poa_affine.py`) and convex (`poa_convex.py`) POA
aligners share beyond `poa_linear.py`'s input checks and best-cell pick:
output and ring buffers, and the three-state traceback walk (the plain
PyTorch version here, the kernel `walk3_kernel` in `csrc/poa_gap.cuh`).

The walk's kernel (K5w / K6w) runs one warp a walk: the warp stages a tile
of its walk's direction words (64 rows by 32 columns) in
shared memory with cp.async, steps from it until the walk leaves it through
its top or left edge, keeps the pair of step k in lane k % 32, writes those
pairs 32 columns at a time (node ids in pn when given `node_id`), and then
the -2 columns before them; the wrapper fills nothing.

A direction word is one int32 per DP cell, ``chain << 16 | hcode``:
  hcode  ``prio << DELTA_BITS | delta``, the move that formed H. With K
         gap-channel pairs (affine 1, convex 2) and
         ``idx = (2K+1)(P+1) - 1 - prio`` in the reference dispatch's
         first-true order: idx < P is the diagonal through in-edge slot idx;
         then per slot 2K vertical codes (extend, open per channel); then 2K
         sequence-gap codes (extend, open per channel); last the sw stop.
  chain  bit CHAIN_BIT: the sequence-gap chain continues to the left; bits
         below: the vertical chain's code, ``prio << DELTA_BITS | delta``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .poa_linear import DELTA_BITS, DMASK, MODES, SMEM_RING_MAX, _check_inputs

CHAIN_BIT = 14  # "the sequence-gap chain continues" flag of the chain halfword

# ctypes argtypes of poa_walk_{affine,convex}_launch
WALK3_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def dp_buffers(B, N, D, W, R, n_rings, dev, smem_max=SMEM_RING_MAX):
    """Outputs of a DP kernel (dirs [B, N+1, D, W] int32; maxi, maxj, score
    [B, D] int32) and its ring scratch: None when the `n_rings` int16 rings
    of R+1 rows fit in `smem_max` bytes of shared memory, else
    [B*D, n_rings, R+1, W] int16."""
    dirs = torch.empty((B, N + 1, D, W), dtype=torch.int32, device=dev)
    maxi = torch.empty((B, D), dtype=torch.int32, device=dev)
    maxj = torch.empty_like(maxi)
    score = torch.empty_like(maxi)
    rings = None
    if n_rings * (R + 1) * W * 2 > smem_max:
        rings = torch.empty((B * D, n_rings, R + 1, W), dtype=torch.int16, device=dev)
    return dirs, maxi, maxj, score, rings


def _walk3_plain(dirs, maxi, maxj, mode, L, P, K, node_id=None):
    """Plain PyTorch version of the three-state walk (H / vertical chain /
    sequence-gap chain) for K gap-channel pairs: all B*D walks step
    together, a Python loop over steps. Returns pn, pp [B, D, L] (pairs
    back to front in the last `count` columns, -2 elsewhere; pn holds DP
    ranks, or with node_id [B, N1-1] their node ids; -1 stays -1) and
    count [B, D], all int32.

    One rule differs from the reference walks: an nw walk ends at cell
    (0, 0) in ANY state, where the reference ends there only in state H. A
    start node's lane 0 ties F-extend with F-open (the F boundary pin), the
    H dispatch ranks the extend first, and the walk then stands at (0, 0)
    in the vertical-chain state: the reference goes on from there (affine:
    to the end of its buffer; convex: one pair (-1, -1) more) and disagrees
    with the host engines on every alignment that starts with such a
    deletion. Nothing lies beyond (0, 0), so ending there is exact."""
    B, N1, D, W = dirs.shape
    BD = B * D
    dev = dirs.device
    NPRIO = (2 * K + 1) * (P + 1)
    VEND = (2 * K + 1) * P  # first sequence-gap code
    ST_H, ST_V, ST_S = 0, 1, 2
    cf = dirs.reshape(-1)
    w = torch.arange(BD, device=dev)
    bidx, didx = w // D, w % D
    i = maxi.reshape(BD).to(torch.int64)
    j = maxj.reshape(BD).to(torch.int64)
    started = ~((i == 0) & (j == 0))
    active = started & (i != 0) & (j != 0) if mode == "ov" else started
    state = torch.zeros(BD, dtype=torch.int64, device=dev)
    cnt = torch.zeros(BD, dtype=torch.int32, device=dev)
    pn = torch.full((BD, L), -2, dtype=torch.int32, device=dev)
    pp = torch.full((BD, L), -2, dtype=torch.int32, device=dev)
    step = 0
    while step < L and bool(active.any()):
        word = cf[((bidx * N1 + i) * D + didx) * W + j].to(torch.int64)
        hcode = word & 0xFFFF
        chain = (word >> 16) & 0xFFFF
        hidx = NPRIO - 1 - (hcode >> DELTA_BITS)
        ccode = chain & ((1 << CHAIN_BIT) - 1)
        cidx = (2 * P - 1) - (ccode >> DELTA_BITS)
        in_h, in_v, in_s = state == ST_H, state == ST_V, state == ST_S
        is_diag = in_h & (hidx < P)
        v_enter = in_h & (hidx >= P) & (hidx < VEND)
        v_ext_enter = v_enter & (((hidx - P) & 1) == 0)
        s_move = in_h & (hidx >= VEND) & (hidx < VEND + 2 * K)
        s_ext = s_move & (((hidx - VEND) & 1) == 0)
        is_stop = in_h & (hidx == VEND + 2 * K)
        do = active & ~is_stop if mode == "sw" else active
        # affine chain codes: 2p open, 2p+1 extend; convex: p continue, P+p stop
        v_cont = in_v & (((cidx & 1) == 1) if K == 1 else (cidx < P))
        node = is_diag | v_enter | in_v
        seq = is_diag | s_move | in_s
        delta = torch.where(in_v, ccode & DMASK, hcode & DMASK)
        prev_i = torch.where(node, torch.where(delta == 0, 0, i - delta), i)
        prev_j = torch.where(seq, j - 1, j)
        col = L - 1 - step
        pn[:, col] = torch.where(do, torch.where(node, i - 1, -1), -2).to(torch.int32)
        pp[:, col] = torch.where(do, torch.where(seq, j - 1, -1), -2).to(torch.int32)
        cont_s = s_ext | (in_s & (((chain >> CHAIN_BIT) & 1) == 1))
        nstate = torch.where(v_ext_enter | v_cont, ST_V, torch.where(cont_s, ST_S, ST_H))
        i = torch.where(do, prev_i, i)
        j = torch.where(do, prev_j, j)
        state = torch.where(do, nstate, state)
        cnt = cnt + do.to(torch.int32)
        if mode == "sw":
            active = do
        elif mode == "nw":
            active = do & ~((i == 0) & (j == 0))
        else:
            active = do & ~((i == 0) | (j == 0))
        step += 1
    cnt = torch.where(started, cnt, 0)
    if node_id is not None:
        row = bidx[:, None] * (N1 - 1)
        ids = node_id.reshape(-1)[(row + pn.clamp_min(0)).reshape(-1)].view(BD, L)
        pn = torch.where(pn >= 0, ids, pn)
    return pn.view(B, D, L), pp.view(B, D, L), cnt.view(B, D)


def walk3(dirs, maxi, maxj, align_type, L, P, K, lib, kernel, node_id=None):
    """The three-state walk over dirs [B, N1, D, W] int32 from maxi/maxj
    [B, D] int32; node_id [B, N1-1] int32 or None. CPU tensors take
    `_walk3_plain`; CUDA tensors launch `lib().<kernel>_launch` (counted
    under `kernel`) or raise (and need W % 4 == 0). Returns (pn, pp
    [B, D, L], count [B, D]); pn holds node ids with `node_id`, else DP
    ranks."""
    if dirs.dim() != 4:
        raise ValueError("dirs must be [B, N1, D, W]")
    B, N1, D, W = dirs.shape
    dev = dirs.device
    if dirs.dtype != torch.int32 or not dirs.is_contiguous():
        raise ValueError("dirs must be a contiguous int32 tensor")
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
        return _walk3_plain(dirs, maxi, maxj, align_type, L, P, K, node_id)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if W % 4 or dirs.data_ptr() % 16:
        raise ValueError("dirs rows must start on 16-byte boundaries (W % 4 == 0)")
    # one allocation: pn, pp and count are views of it
    n = B * D * L
    buf = torch.empty(2 * n + B * D, dtype=torch.int32, device=dev)
    pn, pp, count = buf[:n].view(B, D, L), buf[n : 2 * n].view(B, D, L), buf[2 * n :].view(B, D)
    if B * D == 0:
        return pn, pp, count
    with torch.cuda.device(dev):
        rc = launch_walk3(lib, kernel, dirs, maxi, maxj, node_id, (pn, pp, count), align_type,
                          L, P)
    _build.check(lib(), rc, kernel)
    _build.LAUNCHES[kernel] += 1
    return pn, pp, count


def launch_walk3(lib, kernel, dirs, maxi, maxj, node_id, out, align_type, L, P, tiles=None):
    """The walk's C launcher `lib().<kernel>_launch` on checked inputs and
    the buffers `out` = (pn, pp [B, D, L], count [B, D]) int32, on the
    current stream; node_id [B, N1-1] or None; tiles, a [B, D] int32
    buffer for the tiles each walk staged, or None. Counts nothing and
    returns the cudaError_t. The kernel writes every column of pn and pp
    and every count, so a second launch on the same buffers gives the same
    outputs: `walk3` calls it once; timing the kernel alone (a CUDA graph
    of launches) calls it directly."""
    B, N1, D, W = dirs.shape
    pn, pp, count = out
    return getattr(lib(), f"{kernel}_launch")(
        dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(),
        0 if node_id is None else node_id.data_ptr(), pn.data_ptr(), pp.data_ptr(),
        count.data_ptr(), 0 if tiles is None else tiles.data_ptr(),
        B, N1, D, W, L, P, MODES[align_type],
        torch.cuda.current_stream(dirs.device).cuda_stream,
    )
