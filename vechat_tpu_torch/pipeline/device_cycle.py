"""Both rounds' window consensus on the device. Round 1, the device prune
cycle: each window's host-built graph crosses to the device once, as dense
edge-list tensors, and the whole prune -> realign x (num_prune - 1) -> emit
cycle (src/window.cpp:300-396) runs there as
`ops/kernels/graph_cycle.haplotype_cycle`, one dispatch a window batch.
Round 1, the device build: the incremental build too
(`ops/kernels/graph_build.device_build`, src/window.cpp:84-136), its graphs
handed to the cycle on the device; they never exist on the host. Round 2:
the build, the heaviest-bundle consensus with branch completion, coverage
and the kTGS trim (`ops/kernels/graph_consensus.device_linear`,
src/window.cpp:74-174), one dispatch a window batch.

Counterpart of `vechat_tpu/pipeline/device_cycle.py` (`run_device_cycle`,
`run_device_polish`, `run_device_linear` and what they need). Switched on
by VECHAT_DEVICE_CYCLE=1, VECHAT_DEVICE_BUILD=1 and VECHAT_DEVICE_LINEAR=1
for a backend that supports them (the CUDA backend; on `device="cpu"` the
programs run their plain versions). The only host route is per window, by
capacity, and each is counted on the backend by reason: a shape past the
ladders below, more edges than E = 2N or nodes than N (`graph_to_edges`), a
bucket whose scores leave int16, an overflow bit of the build (nodes,
edges, rings or in-slots past their caps, a predecessor distance past 511),
of the cycle (adjacency past A_CAP, in-slots past P_CAP, new edges past
E, a predecessor distance past 511) or of the round-2 consensus (in- or
out-slots past P_CAP, branch completion past its 64 passes). A failed
launch or fetch raises: nothing falls back.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..ops.encode import phred_prob_sum, phred_weights
from ..ops.kernels.dense import bucket
from ..ops.kernels.graph_build import BUILD_OVF_BITS, device_build
from ..ops.kernels.graph_consensus import LINEAR_OVF_BITS, device_linear
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
R_CAP = 8  # aligned-ring capacity of the device build


def _switched_on(var: str, backend) -> bool:
    """The environment variable `var` is set (not to "0", "" or "off") and
    the backend has `supports_graph_cycle`."""
    flag = os.environ.get(var)
    return flag not in (None, "0", "", "off") and getattr(backend, "supports_graph_cycle", False)


def use_device_cycle(backend) -> bool:
    """The device prune cycle: opt-in via VECHAT_DEVICE_CYCLE=1."""
    return _switched_on("VECHAT_DEVICE_CYCLE", backend)


def use_device_build(backend) -> bool:
    """The device build and prune cycle: opt-in via VECHAT_DEVICE_BUILD=1."""
    return _switched_on("VECHAT_DEVICE_BUILD", backend)


def use_device_linear(backend) -> bool:
    """The device round-2 consensus: opt-in via VECHAT_DEVICE_LINEAR=1."""
    return _switched_on("VECHAT_DEVICE_LINEAR", backend)


def _window_avg_weight(w, total: float) -> float:
    """average_weight = 2*total/window_len (uint16 len quirk), x1000 for
    FASTQ-mode windows (reference: src/window.cpp:301-309); the host cycle's
    too."""
    window_len = np.uint16(len(w.backbone_codes))
    avg = 2.0 * total / int(window_len)
    if not w.if_fasta:
        avg *= 1000.0
    return avg


def _fits_scores(nb: int, sb: int, m: int, x: int, g: int) -> bool:
    """K1's int16 rows hold both align modes of the cycle at (nb, sb)."""
    return fits_int16(nb, dp_width(sb), m, x, g) and fits_int16(nb, dp_width(sb), *SW_SCORES)


def _pack_seqs(w, order, db, sb):
    """One window's sequences at (db, sb), backbone first, the layers in
    `order`: codes, weights (phred), lengths, spans, full-span flags and
    the cycle's sw flags (the layers that are not full-span)."""
    blen = len(w.backbone_codes)
    offset = int(0.01 * blen)
    seqs = np.full((db, sb), 0xFF, np.int32)
    seq_w = np.ones((db, sb), np.int32)
    slen = np.ones(db, np.int32)
    begin = np.zeros(db, np.int32)
    end = np.zeros(db, np.int32)
    full = np.zeros(db, bool)
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
        begin[j], end[j] = lay.begin, lay.end
        full[j] = lay.begin < offset and lay.end > blen - offset
        is_sw[j] = not full[j]
    return dict(seqs=seqs, seq_w=seq_w, slen=slen, begin=begin, end=end, full=full,
                is_sw=is_sw, d_real=1 + len(w.layers))


def _pack_window(w, gr, order, total, nb, db, sb):
    """One window's cycle inputs: its edge list at (nb, 2 nb), or None past
    those caps, and its sequences at (db, sb), backbone first."""
    ed = graph_to_edges(gr, nb, 2 * nb)
    if ed is None:
        return None
    return dict(_pack_seqs(w, order, db, sb), edges=ed, avg=_window_avg_weight(w, total))


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
        if not _fits_scores(nb, sb, m, x, g):
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


def _pack_polish(w, db, sb):
    """One window's build and cycle inputs at (db, sb): `_pack_seqs` in the
    reference's layer order, the build's weights (`bw`: the backbone's zero
    without qualities) and the average weight."""
    from .windows import _backbone_weights, _layer_order

    order = _layer_order(w)
    p = _pack_seqs(w, order, db, sb)
    blen = len(w.backbone_codes)
    p["bw"] = p["seq_w"].copy()
    p["bw"][0, :blen] = _backbone_weights(w)
    if w.if_fasta:
        total = float(blen)
    else:
        total = phred_prob_sum(w.backbone_quality) if w.backbone_quality is not None else 0.0
    for oi in order:  # the host build's order of the sum
        lay = w.layers[oi]
        total += float(len(lay.codes)) if lay.quality is None else phred_prob_sum(lay.quality)
    p["avg"] = _window_avg_weight(w, total)
    return p


def _bucket_window(w, host, m, x, g):
    """The (nb, db, sb) bucket of a window for the device build, or None
    (counted in `host`) past the ladders or where the bucket's scores leave
    int16. A build graph grows to ~(1 + error rate x depth) x the backbone:
    the node bucket is that ceiling, and a window past it is flagged."""
    blen = len(w.backbone_codes)
    s_max = max([blen] + [len(lay.codes) for lay in w.layers])
    nb = bucket(max(2 * blen, 256), N_LADDER)
    db = bucket(1 + len(w.layers), D_LADDER)
    sb = bucket(s_max, S_LADDER)
    if nb is None or db is None or sb is None:
        host["ladder"] += 1
        return None
    if not _fits_scores(nb, sb, m, x, g):
        host["int16"] += 1
        return None
    return nb, db, sb


def _build_args(ps, dev):
    """The device build's arguments for the packed windows `ps`
    (`_pack_polish`), on `dev`: the backbone (row 0) and the layers (rows 1
    on), n_layers last. Returns (args, seqs, seq_w, slen, stack), the
    sequences' tensors and `stack(key)` for the cycle."""
    import torch

    def stack(key, rows=slice(None)):
        return torch.from_numpy(np.stack([p[key][rows] for p in ps])).to(dev)

    seqs, bw, cw, slen = stack("seqs"), stack("bw"), stack("seq_w"), stack("slen")
    bb_codes = torch.where(seqs[:, 0] == 0xFF, 0, seqs[:, 0])
    n_layers = torch.tensor([p["d_real"] - 1 for p in ps], dtype=torch.int32, device=dev)
    lay = slice(1, None)
    args = (bb_codes, bw[:, 0], slen[:, 0], seqs[:, lay], bw[:, lay], slen[:, lay],
            stack("begin", lay), stack("end", lay), stack("full", lay), n_layers)
    return args, seqs, cw, slen, stack


def run_device_polish(
    active: List,
    backend,
    min_confidence: float,
    min_support: float,
    num_prune: int,
    progress=None,
) -> List[bool]:
    """Round 1's window consensus on `backend.device`: `device_build` builds
    each window batch's graphs and `haplotype_cycle` prunes them, one
    dispatch of each a batch. Sets consensus_codes / polished on the windows
    it handles; returns a handled mask (False: the caller builds that window
    on the host)."""
    import torch

    handled = [False] * len(active)
    m, x, g = backend.match, backend.mismatch, backend.gap
    dev = backend.device
    host = backend.build_host

    t0 = time.perf_counter()
    buckets = {}
    packs: List[Optional[dict]] = [None] * len(active)
    for wi, w in enumerate(active):
        key = _bucket_window(w, host, m, x, g)
        if key is not None:
            packs[wi] = _pack_polish(w, *key[1:])
            buckets.setdefault(key, []).append(wi)
    t_pack = time.perf_counter() - t0

    t_device = t_fetch = 0.0
    n_dispatches = 0
    stats = {}
    for (nb, db, sb), wis in sorted(buckets.items()):
        for off in range(0, len(wis), B_LADDER[-1]):
            chunk = wis[off : off + B_LADDER[-1]]
            t0 = time.perf_counter()
            ps = [packs[wi] for wi in chunk]
            args, seqs, cw, slen, stack = _build_args(ps, dev)
            d_used = args[-1] + 1
            avg = torch.tensor([p["avg"] for p in ps], dtype=torch.float32, device=dev)
            t_pack += time.perf_counter() - t0

            t0 = time.perf_counter()
            built = device_build(*args, nb, 2 * nb, R_CAP, m, x, g, p_cap=P_CAP, stats=stats)
            # a flagged window's graph is thrown away: the cycle sees it
            # without edges, so that nothing of it can trouble the kernels
            bad = built["overflow"]
            out = haplotype_cycle(built["tails"], built["heads"], built["weights"],
                                  torch.where(bad, 0, built["n_edges"]), built["codes"],
                                  built["n_nodes"].clamp_max(nb), avg, seqs, slen, cw,
                                  stack("is_sw"), d_used, min_confidence, min_support,
                                  num_prune, m, x, g, a_cap=A_CAP, p_cap=P_CAP, stats=stats)
            t_device += time.perf_counter() - t0
            n_dispatches += 1

            t0 = time.perf_counter()
            corrected, out_len, cyc_ovf, b_ovf = (
                a.cpu().numpy() for a in (*out[:3], built["overflow_bits"]))
            t_fetch += time.perf_counter() - t0
            for bi, wi in enumerate(chunk):
                # the build's reasons, else the cycle's
                if b_ovf[bi]:
                    for reason, bit in BUILD_OVF_BITS.items():
                        host[reason] += bool(b_ovf[bi] & bit)
                    continue
                if cyc_ovf[bi]:
                    for reason, bit in OVF_BITS.items():
                        host[f"cycle_{reason}"] += bool(cyc_ovf[bi] & bit)
                    continue
                w = active[wi]
                w.consensus_codes = corrected[bi, : out_len[bi]].astype(np.uint8)
                w.polished = True
                handled[wi] = True
            if progress is not None:
                progress()

    n_handled = sum(handled)
    backend.t_build_pack += t_pack
    backend.t_build_device += t_device
    backend.t_build_fetch += t_fetch
    backend.n_build_windows += n_handled
    backend.n_build_host += len(active) - n_handled
    backend.n_build_dispatches += n_dispatches
    backend.build_layer_steps += stats.get("layer_steps", 0)
    backend.cycle_cc_rounds += stats.get("cc_rounds", 0)
    if n_dispatches:
        print(
            f"[vechat_tpu::polish-device] device build and prune cycle: {n_handled}/"
            f"{len(active)} windows, {n_dispatches} dispatches | pack {t_pack:.1f}s | device "
            f"{t_device:.1f}s | fetch {t_fetch:.1f}s",
            file=sys.stderr,
        )
    return handled


def run_device_linear(active: List, backend, trim: bool, progress=None) -> List[bool]:
    """Round 2's window consensus on `backend.device`: `device_linear`
    builds each window batch's graphs with edge labels and takes their
    heaviest-bundle consensus, coverage and kTGS trim, one dispatch a
    batch. Sets consensus_codes / polished on the windows it handles;
    returns a handled mask (False: the caller builds that window on the
    host and takes the host consensus)."""
    import torch

    from .windows import WINDOW_TYPE_TGS

    handled = [False] * len(active)
    m, x, g = backend.match, backend.mismatch, backend.gap
    dev = backend.device
    host = backend.linear_host

    t0 = time.perf_counter()
    buckets = {}
    packs: List[Optional[dict]] = [None] * len(active)
    for wi, w in enumerate(active):
        key = _bucket_window(w, host, m, x, g)
        if key is not None:
            packs[wi] = _pack_polish(w, *key[1:])
            packs[wi]["do_trim"] = trim and w.window_type == WINDOW_TYPE_TGS
            buckets.setdefault(key, []).append(wi)
    t_pack = time.perf_counter() - t0

    t_device = t_fetch = 0.0
    n_dispatches = 0
    for (nb, db, sb), wis in sorted(buckets.items()):
        for off in range(0, len(wis), B_LADDER[-1]):
            chunk = wis[off : off + B_LADDER[-1]]
            t0 = time.perf_counter()
            ps = [packs[wi] for wi in chunk]
            args = _build_args(ps, dev)[0]
            do_trim = torch.tensor([p["do_trim"] for p in ps], dtype=torch.bool, device=dev)
            t_pack += time.perf_counter() - t0

            t0 = time.perf_counter()
            out = device_linear(*args, do_trim, nb, 2 * nb, R_CAP, m, x, g, p_cap=P_CAP)
            t_device += time.perf_counter() - t0
            n_dispatches += 1

            t0 = time.perf_counter()
            codes, out_len, ovf = (a.cpu().numpy() for a in out)
            t_fetch += time.perf_counter() - t0
            for bi, wi in enumerate(chunk):
                if ovf[bi]:
                    for reason, bit in LINEAR_OVF_BITS.items():
                        host[reason] += bool(ovf[bi] & bit)
                    continue
                w = active[wi]
                w.consensus_codes = codes[bi, : out_len[bi]].astype(np.uint8)
                w.polished = True
                handled[wi] = True
            if progress is not None:
                progress()

    n_handled = sum(handled)
    backend.t_linear_pack += t_pack
    backend.t_linear_device += t_device
    backend.t_linear_fetch += t_fetch
    backend.n_linear_windows += n_handled
    backend.n_linear_host += len(active) - n_handled
    backend.n_linear_dispatches += n_dispatches
    if n_dispatches:
        print(
            f"[vechat_tpu::linear-device] device round-2 consensus: {n_handled}/{len(active)} "
            f"windows, {n_dispatches} dispatches | pack {t_pack:.1f}s | device {t_device:.1f}s | "
            f"fetch {t_fetch:.1f}s",
            file=sys.stderr,
        )
    return handled
