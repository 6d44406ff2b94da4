"""Batch aligner backend on the POA kernels (K1 DP + K2 walk) and, for
overlap pairs, the pairwise kernels (K3/K4).

Counterpart of `vechat_tpu/ops/kernels/backend.py:PallasAlignerBackend`.
Groups alignment items by (mode, graph) so that the sequences aligned
against one graph share one batch slot (axis D), then buckets graphs by
(node capacity, in-degree, sequence width). Items that do not fit — scores
outside int16, a predecessor distance over 511 (the 9-bit delta field), or
N/W over the top bucket — go to the host oracle, one by one, and are
counted in `fallbacks`; the host result is byte-identical.

`device` picks where the DP runs: a CUDA device launches the kernels, the
CPU runs their plain PyTorch versions (the tests and `--backend torch`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph_align import LinearAligner
from ..poagraph import Alignment, PoaGraph
from . import _build, dense
from .dense import bucket, graph_to_dense
from .poa_linear import (
    DELTA_BITS,
    fits_int16,
    max_pred_distance,
    poa_align,
    ranks_to_node_ids_np,
    runs_to_pairs_np,
)

D_MAX = 64  # sequences per graph slot in one launch
MAX_RING = (1 << DELTA_BITS) - 1  # largest predecessor distance a code holds
# device bytes of one launch: the int16 dirs tensor plus, for rings that do
# not fit in shared memory, the int16 H ring
LAUNCH_BYTES = 1 << 30


def pack_windows(dense_seqs, nb: int, pb: int, wb: int):
    """JAX-layout inputs of `poa_align` for B graphs packed by
    `graph_to_dense(graph, nb, pb)`, each with the code arrays aligned
    against it: codes/sink/node_id [B, 1, nb], preds [B, pb, nb], n_nodes
    [B, 1, 1], seqp [B, D, wb] (lane j = position j-1), seq_len [B, 1, D]
    (numpy int32). Padding sequences are one 'A'."""
    B = len(dense_seqs)
    D = max(len(seqs) for _, seqs in dense_seqs)
    codes = np.zeros((B, 1, nb), np.int32)
    preds = np.zeros((B, pb, nb), np.int32)
    sink = np.ones((B, 1, nb), np.int32)
    nid = np.zeros((B, 1, nb), np.int32)
    nn = np.ones((B, 1, 1), np.int32)
    seqp = np.full((B, D, wb), 0xFF, np.int32)
    seqp[:, :, 1] = 0
    slen = np.ones((B, 1, D), np.int32)
    for b, (d, seqs) in enumerate(dense_seqs):
        codes[b, 0] = d["codes"]
        preds[b] = d["preds"].T
        sink[b, 0] = d["is_sink"]
        nid[b, 0] = d["node_id"]
        nn[b, 0, 0] = d["n_nodes"]
        for di, q in enumerate(seqs):
            seqp[b, di, 1 : 1 + len(q)] = q
            seqp[b, di, 1 + len(q) :] = 0xFF
            slen[b, 0, di] = len(q)
    return codes, preds, sink, nid, nn, seqp, slen


class TorchAlignerBackend:
    """Drop-in batch aligner running the POA kernels on `device`."""

    def __init__(self, match: int, mismatch: int, gap: int, device="cuda"):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.device = _build.resolve_device(device)
        self._host_nw = LinearAligner("nw", match, mismatch, gap)
        self._host_sw = LinearAligner("sw", 3, -5, -4)  # src/window.cpp:326
        self.fallbacks = 0
        self.device_alignments = 0
        self.cell_updates = 0
        # stage timers (where does align_batch wall go?)
        self.t_pack = 0.0  # dense conversion + batch array fill
        self.t_device = 0.0  # upload + kernels + fetch
        self.t_decode = 0.0  # run headers -> Alignment decode
        self.t_host_fb = 0.0  # host-fallback alignments
        self.n_dispatches = 0
        self.n_calls = 0
        self._dense_cache: Dict[Tuple[int, int, int], Optional[dict]] = {}
        self._pairwise = None

    def counters(self) -> Dict[str, int]:
        """Device and host-route counts of this backend, and the launches
        of every kernel in this process."""
        pw = self._pairwise
        out = dict(
            device_alignments=self.device_alignments,
            fallbacks=self.fallbacks,
            cell_updates=self.cell_updates,
            n_dispatches=self.n_dispatches,
            exact_pairs=pw.exact_pairs if pw else 0,
            exact_rejects=pw.exact_rejects if pw else 0,
            device_tiles=pw.device_tiles if pw else 0,
            pairwise_host_fallbacks=pw.host_fallbacks if pw else 0,
        )
        out.update({f"launches_{k}": v for k, v in _build.LAUNCHES.items()})
        return out

    def edit_align_batch(self, pairs):
        """Overlap alignment on the pairwise kernels; the Polisher and
        refine_identity pick this up via duck typing."""
        if self._pairwise is None:
            from .pairwise_nw import DevicePairwiseAligner

            self._pairwise = DevicePairwiseAligner(device=self.device)
        return self._pairwise.edit_align_batch(pairs)

    def _scores(self, mode: str) -> Tuple[int, int, int]:
        if mode == "nw":
            return self.match, self.mismatch, self.gap
        return 3, -5, -4

    def _host_align(self, codes, graph, mode):
        _t0 = time.perf_counter()
        self.fallbacks += 1
        if hasattr(graph, "align_host"):
            m, x, g = self._scores(mode)
            out = graph.align_host(codes, mode, m, x, g)
        else:
            eng = self._host_nw if mode == "nw" else self._host_sw
            out = eng.align(codes, graph)
        self.t_host_fb += time.perf_counter() - _t0
        return out

    def _dense(self, graph: PoaGraph, nb: int, pb: int) -> Optional[dict]:
        key = (id(graph), nb, pb)
        if key not in self._dense_cache:
            self._dense_cache[key] = graph_to_dense(graph, nb, pb)
        return self._dense_cache[key]

    def align_batch(
        self, items: Sequence[Tuple[np.ndarray, PoaGraph, str]]
    ) -> List[Alignment]:
        self.n_calls += 1
        results: List[Optional[Alignment]] = [None] * len(items)
        # the cache is only safe within one call: graph objects mutate
        # between calls and ids can be recycled by the GC
        self._dense_cache.clear()

        # group by (mode, graph), preserving order within groups
        graph_groups: Dict[Tuple[str, int], List[int]] = {}
        graph_of: Dict[int, PoaGraph] = {}
        for idx, (codes, graph, mode) in enumerate(items):
            if graph.num_nodes() == 0 or len(codes) == 0:
                results[idx] = []
                continue
            graph_groups.setdefault((mode, id(graph)), []).append(idx)
            graph_of[id(graph)] = graph

        # classify each (graph, its item indices) into shape buckets
        _t0 = time.perf_counter()
        buckets: Dict[Tuple[str, int, int, int], list] = {}
        for (mode, gid), idxs in graph_groups.items():
            graph = graph_of[gid]
            if hasattr(graph, "max_in_degree"):
                max_deg = graph.max_in_degree()
            else:
                max_deg = max((len(ins) for ins in graph.inedges), default=0)
            nb = bucket(graph.num_nodes(), dense.N_BUCKETS)
            pb = bucket(max(max_deg, 1), dense.P_BUCKETS)
            wb = bucket(max(len(items[i][0]) for i in idxs) + 1, dense.W_BUCKETS)
            dist = None
            if None not in (nb, pb, wb) and fits_int16(nb, wb, *self._scores(mode)):
                d = self._dense(graph, nb, pb)
                if d is not None:
                    dist = max_pred_distance(d["preds"], d["n_nodes"])
            # the 9-bit delta field of a direction code holds the distance
            if dist is None or dist > MAX_RING:
                for i in idxs:
                    results[i] = self._host_align(items[i][0], graph, mode)
                continue
            buckets.setdefault((mode, nb, pb, wb), []).append((graph, idxs, dist))
        self.t_pack += time.perf_counter() - _t0

        # one H ring per group, as deep as its largest predecessor distance
        for (mode, nb, pb, wb), group in buckets.items():
            ring = max(1, max(dist for _, _, dist in group))
            entries = []
            for graph, idxs, _ in group:
                for off in range(0, len(idxs), D_MAX):
                    entries.append((graph, idxs[off : off + D_MAX]))
            d_used = max(len(idxs) for _, idxs in entries)
            per_slot = (nb + 1) * d_used * wb * 2 + d_used * ((ring + 1) * wb * 2)
            max_b = max(1, LAUNCH_BYTES // per_slot)
            for off in range(0, len(entries), max_b):
                self._run_chunk(
                    items, results, entries[off : off + max_b], mode, nb, pb, wb, ring
                )
        return results  # type: ignore[return-value]

    def _run_chunk(self, items, results, entries, mode, nb, pb, wb, ring):
        _t0 = time.perf_counter()
        codes, preds, sink, nid, nn, seqp, slen = pack_windows(
            [(self._dense(graph, nb, pb), [items[i][0] for i in idxs]) for graph, idxs in entries],
            nb, pb, wb,
        )
        D = seqp.shape[1]
        self.t_pack += time.perf_counter() - _t0

        _t0 = time.perf_counter()
        m, x, g = self._scores(mode)
        runs, steps, count, _ = poa_align(
            codes, preds, sink, nn, seqp, slen, mode, m, x, g,
            ring=ring, device=self.device,
        )
        runs = runs[:steps].cpu().numpy()
        count = count.cpu().numpy()
        self.t_device += time.perf_counter() - _t0
        self.n_dispatches += 1

        _t0 = time.perf_counter()
        for b, (graph, idxs) in enumerate(entries):
            for di, i in enumerate(idxs):
                pn, pp = runs_to_pairs_np(runs[:, b * D + di])
                pn = ranks_to_node_ids_np(pn, nid[b, 0])
                aln = list(zip(pn.tolist(), pp.tolist()))
                c = int(count[b, 0, di])
                if len(aln) != c:
                    # a kernel bug: never fall back, never pass silently
                    raise RuntimeError(
                        f"walk of item {i} (window slot {b}, sequence {di}, "
                        f"mode {mode}) decoded {len(aln)} pairs, count says {c}"
                    )
                results[i] = aln
                self.device_alignments += 1
                self.cell_updates += int(nn[b, 0, 0]) * int(slen[b, 0, di])
        self.t_decode += time.perf_counter() - _t0
