"""The device prune cycle of round 1: each window's host-built graph crosses
to the device once, as dense edge-list tensors, and the whole prune ->
realign x (num_prune - 1) -> emit cycle (src/window.cpp:300-396) runs there
as `ops/kernels/graph_cycle.haplotype_cycle`, one dispatch a window batch.

Counterpart of `vechat_tpu/pipeline/device_cycle.py` (`run_device_cycle`
and what it needs; the device build and round-2 programs are not ported).
Switched on by VECHAT_DEVICE_CYCLE=1 for a backend that supports it (the
CUDA backend; on `device="cpu"` the cycle runs its plain versions). The
only host route is per window, by capacity, and each is counted on the
backend by reason: a shape past the ladders below, more edges than E = 2N
or nodes than N (`graph_to_edges`), a bucket whose scores leave int16, or
an overflow bit of the cycle (adjacency past A_CAP, in-slots past P_CAP,
new edges past E, a predecessor distance past 511). A failed launch or
fetch raises: nothing falls back.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..ops.encode import phred_weights
from ..ops.kernels.dense import bucket
from ..ops.kernels.graph_cycle import (
    OVF_BITS,
    SW_SCORES,
    dp_width,
    graph_to_edges,
    haplotype_cycle,
)
from ..ops.kernels.poa_linear import fits_int16

# The JAX package's capacity ladders, kept as they are: they decide which
# windows take the host route. There each (B, E, N, D, S) was one XLA
# compile; here B_LADDER[-1] is only the largest window batch a dispatch
# carries (batches are not padded).
N_LADDER = (256, 1152, 2048)
D_LADDER = (8, 32, 64)
S_LADDER = (128, 576)
B_LADDER = (4, 16, 64)
A_CAP = 32
P_CAP = 16


def use_device_cycle(backend) -> bool:
    """The device prune cycle: opt-in via VECHAT_DEVICE_CYCLE=1, for a
    backend with `supports_graph_cycle`."""
    flag = os.environ.get("VECHAT_DEVICE_CYCLE")
    if flag is not None:
        return flag not in ("0", "", "off") and getattr(backend, "supports_graph_cycle", False)
    return False


def _window_avg_weight(w, total: float) -> float:
    """average_weight = 2*total/window_len (uint16 len quirk), x1000 for
    FASTQ-mode windows (reference: src/window.cpp:301-309); the host cycle's
    too."""
    window_len = np.uint16(len(w.backbone_codes))
    avg = 2.0 * total / int(window_len)
    if not w.if_fasta:
        avg *= 1000.0
    return avg


def _pack_window(w, gr, order, total, nb, db, sb):
    """One window's cycle inputs: its edge list at (nb, 2 nb), or None past
    those caps, and its sequences at (db, sb), backbone first."""
    ed = graph_to_edges(gr, nb, 2 * nb)
    if ed is None:
        return None
    blen = len(w.backbone_codes)
    offset = int(0.01 * blen)
    seqs = np.full((db, sb), 0xFF, np.int32)
    seq_w = np.ones((db, sb), np.int32)
    slen = np.ones(db, np.int32)
    is_sw = np.zeros(db, bool)
    seqs[0, :blen] = w.backbone_codes
    seq_w[0, :blen] = phred_weights(w.backbone_quality, blen)
    slen[0] = blen
    for j, oi in enumerate(order, start=1):
        lay = w.layers[oi]
        n = len(lay.codes)
        seqs[j, :n] = lay.codes
        seq_w[j, :n] = phred_weights(lay.quality, n)
        slen[j] = n
        is_sw[j] = not (lay.begin < offset and lay.end > blen - offset)
    return dict(edges=ed, seqs=seqs, seq_w=seq_w, slen=slen, is_sw=is_sw,
                d_real=1 + len(w.layers), avg=_window_avg_weight(w, total))


def run_device_cycle(
    active: List,
    graphs: List,
    totals: List[float],
    orders: List[List[int]],
    backend,
    min_confidence: float,
    min_support: float,
    num_prune: int,
    progress=None,
) -> List[bool]:
    """Run the device cycle for every window that fits, on `backend.device`.
    Sets consensus_codes / polished on the windows it handles; returns a
    handled mask (False: the caller runs the host cycle for that window)."""
    import torch

    handled = [False] * len(active)
    m, x, g = backend.match, backend.mismatch, backend.gap
    dev = backend.device
    host = backend.cycle_host

    t0 = time.perf_counter()
    buckets = {}
    packs: List[Optional[dict]] = [None] * len(active)
    for wi, (w, gr) in enumerate(zip(active, graphs)):
        s_max = max([len(w.backbone_codes)] + [len(lay.codes) for lay in w.layers])
        nb = bucket(gr.num_nodes(), N_LADDER)
        db = bucket(1 + len(w.layers), D_LADDER)
        sb = bucket(s_max, S_LADDER)
        if nb is None or db is None or sb is None:
            host["ladder"] += 1
            continue
        if not (fits_int16(nb, dp_width(sb), m, x, g) and fits_int16(nb, dp_width(sb), *SW_SCORES)):
            host["int16"] += 1
            continue
        packs[wi] = _pack_window(w, gr, orders[wi], totals[wi], nb, db, sb)
        if packs[wi] is None:
            host["edges_cap"] += 1
            continue
        buckets.setdefault((nb, db, sb), []).append(wi)
    t_pack = time.perf_counter() - t0

    t_device = t_fetch = 0.0
    n_dispatches = 0
    stats = {}
    for _, wis in sorted(buckets.items()):
        for off in range(0, len(wis), B_LADDER[-1]):
            chunk = wis[off : off + B_LADDER[-1]]
            t0 = time.perf_counter()
            ps = [packs[wi] for wi in chunk]

            def stack(key, field=None):
                return np.stack([p["edges"][field] if field else p[key] for p in ps])

            arrays = [stack("edges", "tails"), stack("edges", "heads"),
                      stack("edges", "weights"),
                      np.array([p["edges"]["n_edges"] for p in ps], np.int32),
                      stack("edges", "codes"),
                      np.array([p["edges"]["n_nodes"] for p in ps], np.int32),
                      np.array([p["avg"] for p in ps], np.float32),
                      stack("seqs"), stack("slen"), stack("seq_w"), stack("is_sw"),
                      np.array([p["d_real"] for p in ps], np.int32)]
            tensors = [torch.from_numpy(a).to(dev) for a in arrays]
            t_pack += time.perf_counter() - t0

            t0 = time.perf_counter()
            out = haplotype_cycle(*tensors, min_confidence, min_support, num_prune, m, x, g,
                                  a_cap=A_CAP, p_cap=P_CAP, stats=stats)
            t_device += time.perf_counter() - t0
            n_dispatches += 1

            t0 = time.perf_counter()
            corrected, out_len, overflow = (a.cpu().numpy() for a in out[:3])
            t_fetch += time.perf_counter() - t0
            for bi, wi in enumerate(chunk):
                if overflow[bi]:
                    for reason, bit in OVF_BITS.items():
                        host[reason] += bool(overflow[bi] & bit)
                    continue
                w = active[wi]
                w.consensus_codes = corrected[bi, : out_len[bi]].astype(np.uint8)
                w.polished = True
                handled[wi] = True
            if progress is not None:
                progress()

    n_handled = sum(handled)
    backend.t_cycle_pack += t_pack
    backend.t_cycle_device += t_device
    backend.t_cycle_fetch += t_fetch
    backend.n_cycle_windows += n_handled
    backend.n_cycle_host += len(active) - n_handled
    backend.n_cycle_dispatches += n_dispatches
    backend.cycle_cc_rounds += stats.get("cc_rounds", 0)
    if n_dispatches:
        print(
            f"[vechat_tpu::cycle] device prune-cycle: {n_handled}/{len(active)} windows, "
            f"{n_dispatches} dispatches | pack {t_pack:.1f}s | device {t_device:.1f}s | "
            f"fetch {t_fetch:.1f}s",
            file=sys.stderr,
        )
    return handled
