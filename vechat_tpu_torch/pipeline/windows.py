"""Windows: 500 bp tiles of each target with overlapping read segments
("layers"), plus the staged window-consensus drivers.

The drivers are written batch-first: every sequence-to-graph alignment in a
stage is collected across ALL windows and dispatched through a pluggable
aligner backend in one batch, because POA graph construction is sequential
per window but embarrassingly parallel across windows — the device analog of
the reference's thread pool over windows (src/polisher.cpp:496-517).

Semantics mirror src/window.cpp exactly (citations inline).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.encode import encode, phred_prob_sum, phred_weights
from ..ops.graph_align import LinearAligner
from ..ops.poagraph import PoaGraph

WINDOW_TYPE_NGS = 0
WINDOW_TYPE_TGS = 1


def _pmap(fn, items, threads: int):
    """Parallel map over per-window host work (graph build, prune, CC,
    dense export). Windows are disjoint C++ objects and the ctypes calls
    release the GIL, so plain threads give real parallelism — the analog of
    the reference's thread pool over windows (src/polisher.cpp:499-516).
    Order-preserving; falls back to a serial loop for threads<=1."""
    items = list(items)
    if threads <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(threads, len(items))) as ex:
        return list(ex.map(fn, items))


@dataclass
class WindowLayer:
    codes: np.ndarray  # encoded segment
    quality: Optional[str]  # None when the read carries no quality
    begin: int  # position on the window backbone (inclusive)
    end: int  # position of last matched backbone base (inclusive-ish, see
    # src/polisher.cpp:455-458: end = bp[j+1].first - window_start - 1)


@dataclass
class Window:
    target_id: int
    rank: int
    window_type: int
    backbone_codes: np.ndarray
    backbone_quality: Optional[str]  # None for FASTA targets (dummy '!' used)
    if_fasta: bool  # the reference's backbone-quality C-string sniff outcome
    # (src/window.cpp:223; see Polisher for how it is computed)
    layers: List[WindowLayer] = field(default_factory=list)
    consensus_codes: Optional[np.ndarray] = None
    polished: bool = False

    def add_layer(
        self,
        codes: np.ndarray,
        quality: Optional[str],
        begin: int,
        end: int,
    ) -> None:
        """reference: src/window.cpp:47-72."""
        if len(codes) == 0 or begin == end:
            return
        if quality is not None and len(codes) != len(quality):
            raise ValueError("unequal quality size")
        blen = len(self.backbone_codes)
        if begin >= end or begin > blen or end > blen:
            raise ValueError("layer begin and end positions are invalid")
        self.layers.append(WindowLayer(codes, quality, begin, end))

    def n_sequences(self) -> int:
        return 1 + len(self.layers)


class HostAlignerBackend:
    """Batch aligner backend running on the host: native C++ engine when the
    graph is native, numpy oracle otherwise. threads>1 fans the batch over a
    thread pool (the native aligner releases the GIL)."""

    def __init__(self, match: int, mismatch: int, gap: int, threads: int = 1):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.threads = max(1, threads)
        self.nw = LinearAligner("nw", match, mismatch, gap)
        # the local engine is ALWAYS 3/-5/-4 regardless of CLI scores
        # (reference: src/window.cpp:326)
        self.sw = LinearAligner("sw", 3, -5, -4)

    def _align_one(self, item):
        codes, graph, mode = item
        if hasattr(graph, "align_host"):
            if mode == "nw":
                return graph.align_host(
                    codes, "nw", self.match, self.mismatch, self.gap
                )
            return graph.align_host(codes, "sw", 3, -5, -4)
        eng = self.nw if mode == "nw" else self.sw
        return eng.align(codes, graph)

    def _scores(self, mode: str):
        if mode == "nw":
            return self.match, self.mismatch, self.gap
        return 3, -5, -4

    def align_batch(self, items: Sequence[Tuple[np.ndarray, PoaGraph, str]]):
        """Same-(graph, mode) items go through the lane-batched native DP
        (one SIMD lane per sequence, csrc align_linear_batch) — the realign
        phase aligns ~depth sequences against each window's static pruned
        graph, so whole windows batch into single native calls. Distinct
        graphs (the build phase) fall back to per-item alignment. Results
        are byte-identical either way; groups fan out over -t threads."""
        groups: dict = {}
        order = []
        for k, (codes, graph, mode) in enumerate(items):
            key = (id(graph), mode)
            if key not in groups:
                groups[key] = (graph, mode, [])
                order.append(key)
            groups[key][2].append(k)
        results: List = [None] * len(items)

        def run_group(key):
            graph, mode, ks = groups[key]
            if len(ks) >= 2 and hasattr(graph, "align_host_batch"):
                m, x, g = self._scores(mode)
                res = graph.align_host_batch(
                    [items[k][0] for k in ks], mode, m, x, g
                )
            else:
                res = [self._align_one(items[k]) for k in ks]
            for k, r in zip(ks, res):
                results[k] = r

        _pmap(run_group, order, self.threads)
        return results


def _layer_weights(layer_codes: np.ndarray, quality: Optional[str]) -> np.ndarray:
    return phred_weights(quality, len(layer_codes))


def _backbone_weights(w: Window) -> np.ndarray:
    if w.backbone_quality is None:
        # the polisher passes dummy '!' quality; phred weight of '!' is 0
        return np.zeros(len(w.backbone_codes), dtype=np.uint32)
    return phred_weights(w.backbone_quality, len(w.backbone_codes))


def _layer_order(w: Window) -> List[int]:
    """Layers sorted by begin position, replaying the reference's UNSTABLE
    std::sort of rank[1:] by positions_[i].first (src/window.cpp:97,210).
    Equal-begin tie order follows libstdc++ introsort — POA construction is
    order-sensitive, so byte-parity with the reference binary requires the
    exact same permutation (differential test scripts/diff_reference.py)."""
    from ..ops.native_graph import layer_sort_order

    idx = layer_sort_order([l.begin for l in w.layers])
    return [int(i) for i in idx]


def _total_bases_weight_backbone(w: Window) -> float:
    """reference: src/window.cpp:223-237."""
    if w.if_fasta:
        return float(len(w.backbone_codes))
    if w.backbone_quality is None:
        # dummy '!' quality, FASTQ branch: (1 - 10^0) == 0 per base
        return 0.0
    return phred_prob_sum(w.backbone_quality)


def _build_phase(
    windows: List[Window],
    backend,
    collect_weight: bool,
    threads: int = 1,
    progress=None,
) -> Tuple[List[PoaGraph], List[float], List[List[int]]]:
    """Incremental POA build over all windows in lockstep layer steps.
    Returns (graphs, total_bases_weight per window, layer order per window).
    reference: src/window.cpp:84-136 (linear) / :197-298 (haplotype)."""
    from ..ops.native_graph import make_graph

    def init_one(w):
        g = make_graph()
        g.add_alignment([], w.backbone_codes, _backbone_weights(w))
        return (
            g,
            _total_bases_weight_backbone(w) if collect_weight else 0.0,
            _layer_order(w),
        )

    built = _pmap(init_one, windows, threads)
    graphs = [b[0] for b in built]
    totals = [b[1] for b in built]
    orders = [b[2] for b in built]

    max_layers = max((len(w.layers) for w in windows), default=0)
    for step in range(max_layers):
        live = [
            wi for wi, w in enumerate(windows) if step < len(w.layers)
        ]

        def make_item(wi):
            w = windows[wi]
            layer = w.layers[orders[wi][step]]
            blen = len(w.backbone_codes)
            offset = int(0.01 * blen)  # src/window.cpp:99,212
            g = graphs[wi]
            if layer.begin < offset and layer.end > blen - offset:
                return (layer.codes, g, "nw"), (wi, layer, None)
            sub, mapping = g.subgraph(layer.begin, layer.end)
            return (layer.codes, sub, "nw"), (wi, layer, mapping)

        pairs = _pmap(make_item, live, threads)
        items = [p[0] for p in pairs]
        meta = [p[1] for p in pairs]

        alignments = backend.align_batch(items)

        def apply_one(arg):
            (wi, layer, mapping), aln = arg
            if mapping is not None:
                aln = PoaGraph.update_alignment(mapping, aln)
            weights = _layer_weights(layer.codes, layer.quality)
            graphs[wi].add_alignment(aln, layer.codes, weights)
            if not collect_weight:
                return 0.0
            if layer.quality is None:
                return float(len(layer.codes))
            return phred_prob_sum(layer.quality)

        added = _pmap(apply_one, zip(meta, alignments), threads)
        if collect_weight:
            for (wi, _, _), a in zip(meta, added):
                totals[wi] += a
        if progress is not None:
            progress()

    return graphs, totals, orders


def generate_consensus_linear(
    windows: List[Window],
    backend,
    trim: bool,
    threads: int = 1,
    progress=None,
) -> None:
    """Round-2 racon consensus over a batch of windows
    (reference: src/window.cpp:74-174). With VECHAT_DEVICE_LINEAR=1 and a
    backend that supports it, the build, the consensus and the trim run on
    the backend's device (`device_cycle.run_device_linear`); the windows it
    does not take (capacity routes, counted) take the host build and the
    host consensus below."""
    active = []
    for w in windows:
        if w.n_sequences() < 3:
            w.consensus_codes = w.backbone_codes.copy()
            w.polished = False
        else:
            active.append(w)
    if not active:
        return

    from .device_cycle import run_device_linear, use_device_linear

    if use_device_linear(backend):
        handled = run_device_linear(active, backend, trim, progress=progress)
        active = [w for w, h in zip(active, handled) if not h]
        if not active:
            return

    graphs, _, _ = _build_phase(
        active, backend, collect_weight=False, threads=threads,
        progress=progress,
    )

    def consensus_one(arg):
        w, g = arg
        codes, coverages = g.generate_consensus_with_coverage()
        codes = np.asarray(codes, dtype=np.uint8)
        if w.window_type == WINDOW_TYPE_TGS and trim:
            average_coverage = (w.n_sequences() - 1) // 2
            begin, end = 0, len(codes) - 1
            while begin < len(codes) and coverages[begin] < average_coverage:
                begin += 1
            while end >= 0 and coverages[end] < average_coverage:
                end -= 1
            if begin < end:
                codes = codes[begin : end + 1]
            # begin >= end -> possible chimera, keep full consensus
            # (reference: src/window.cpp:161-170)
        w.consensus_codes = codes
        w.polished = True

    _pmap(consensus_one, zip(active, graphs), threads)
    if progress is not None:
        progress()


def generate_consensus_haplotype(
    windows: List[Window],
    backend,
    min_confidence: float,
    min_support: float,
    num_prune: int,
    threads: int = 1,
    progress=None,
) -> None:
    """Round-1 variation-graph correction over a batch of windows
    (reference: src/window.cpp:176-428)."""
    active = []
    for w in windows:
        if w.n_sequences() < 3:
            w.consensus_codes = w.backbone_codes.copy()
            w.polished = False
        else:
            active.append(w)
    if not active:
        return

    # the device build: the incremental build and the prune cycle on the
    # backend's device, the graphs never on the host; the windows it does
    # not take (capacity routes, counted) take the host build below, then
    # the device cycle if it is on, else the host cycle
    from .device_cycle import run_device_polish, use_device_build

    if use_device_build(backend):
        handled = run_device_polish(
            active, backend, min_confidence, min_support, num_prune,
            progress=progress,
        )
        active = [w for w, h in zip(active, handled) if not h]
        if not active:
            return

    graphs, totals, orders = _build_phase(
        active, backend, collect_weight=True, threads=threads,
        progress=progress,
    )

    # the device prune cycle: the whole prune -> realign x2 -> emit cycle on
    # the backend's device, one dispatch a window batch; the windows it does
    # not take (capacity routes, counted) take the host cycle below
    from .device_cycle import _window_avg_weight, run_device_cycle, use_device_cycle

    if use_device_cycle(backend):
        handled = run_device_cycle(
            active, graphs, totals, orders, backend,
            min_confidence, min_support, num_prune, progress=progress,
        )
        remaining = [i for i, h in enumerate(handled) if not h]
        if not remaining:
            return
        active = [active[i] for i in remaining]
        graphs = [graphs[i] for i in remaining]
        totals = [totals[i] for i in remaining]
        orders = [orders[i] for i in remaining]

    # prune the original POA graph (src/window.cpp:300-321)
    def prune_one(arg):
        w, g, total = arg
        average_weight = _window_avg_weight(w, total)
        g.prune_graph(0, min_confidence, min_support, average_weight)
        w._average_weight = average_weight  # reused every re-prune round
        return g.largest_subgraph()

    pruned: List[PoaGraph] = _pmap(
        prune_one, zip(active, graphs, totals), threads
    )
    if progress is not None:
        progress()

    # iterative realign + AddWeights + re-prune (src/window.cpp:329-386).
    # Graph structure is frozen within a round (AddWeights only re-weights
    # existing edges), so every alignment of a round batches together.
    # Per-window realign inputs are round-invariant — precompute once.
    def realign_inputs(wi):
        w = active[wi]
        blen = len(w.backbone_codes)
        offset = int(0.01 * blen)
        seqs = [w.backbone_codes]
        modes = ["nw"]
        weights = [phred_weights(w.backbone_quality, blen)]
        for oi in orders[wi]:
            l = w.layers[oi]
            seqs.append(l.codes)
            modes.append(
                "nw" if (l.begin < offset and l.end > blen - offset) else "sw"
            )
            weights.append(phred_weights(l.quality, len(l.codes)))
        return seqs, modes, weights

    inputs = _pmap(realign_inputs, range(len(active)), threads)
    host_backend = isinstance(backend, HostAlignerBackend)

    for _ in range(num_prune - 1):
        # fully-native windows run the whole round (lane-batched aligns +
        # ordered AddWeights) as ONE native call each — the host twin of
        # the device graph-cycle realign step; others take the generic
        # batched path below
        native_wi = [
            wi
            for wi, g in enumerate(pruned)
            if host_backend and hasattr(g, "realign_round")
        ]
        native_set = set(native_wi)
        generic_wi = [
            wi for wi in range(len(pruned)) if wi not in native_set
        ]

        def native_round(wi):
            seqs, modes, weights = inputs[wi]
            pruned[wi].realign_round(
                seqs, modes, weights,
                (backend.match, backend.mismatch, backend.gap),
                (3, -5, -4),
            )

        _pmap(native_round, native_wi, threads)

        if generic_wi:
            items = []
            meta = []
            for wi in generic_wi:
                g = pruned[wi]
                seqs, modes, weights = inputs[wi]
                for codes, mode, wts in zip(seqs, modes, weights):
                    items.append((codes, g, mode))
                    meta.append((wi, codes, wts))

            alignments = backend.align_batch(items)

            # apply AddWeights parallel ACROSS windows, serial WITHIN a
            # window (backbone first, then layers in order — the
            # reference's call order)
            per_window: dict = {}
            for k, (wi, _, _) in enumerate(meta):
                per_window.setdefault(wi, []).append(k)

            def add_weights_one(wi):
                g = pruned[wi]
                for k in per_window[wi]:
                    _, codes, wts = meta[k]
                    g.add_weights(alignments[k], codes, wts)

            _pmap(add_weights_one, per_window.keys(), threads)

        def reprune_one(arg):
            w, g = arg
            g.prune_graph(0, min_confidence, min_support, w._average_weight)
            return g.largest_subgraph()

        pruned = _pmap(reprune_one, zip(active, pruned), threads)
        if progress is not None:
            progress()

    # final backbone local alignment + corrected emit (src/window.cpp:388-394)
    items = [(w.backbone_codes, g, "sw") for w, g in zip(active, pruned)]
    alignments = backend.align_batch(items)

    def emit_one(arg):
        w, g, aln = arg
        w.consensus_codes = np.asarray(
            g.generate_corrected_sequence(aln), dtype=np.uint8
        )
        w.polished = True

    _pmap(emit_one, zip(active, pruned, alignments), threads)
    if progress is not None:
        progress()
