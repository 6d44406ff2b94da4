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

With more than one entry in `devices` (by default every visible card) a
chunk's window batch is cut into one shard per entry (`parallel/mesh.py`),
each shard runs K1 and the dense walk on its own device and stream, and the
pairs come back as int16 [B, D, L] buffers of node ids: the counterpart of
the JAX backend's multi-device route. With one entry a chunk is one launch
of K1, the run-length walk K2 and the expansion of its headers to node-id
pairs on the device; the host fetches the counts and the flat pairs and
zips every item's tuples from one `tolist()` a field a launch (`pair_lists`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...parallel.mesh import make_mesh, sharded_poa_align_cuda
from ..graph_align import LinearAligner
from ..poagraph import Alignment, PoaGraph
from . import _build, dense
from .dense import bucket, graph_to_dense
from .poa_linear import DELTA_BITS, fits_int16, max_pred_distance, poa_align

D_MAX = 64  # sequences per graph slot in one launch
MAX_RING = (1 << DELTA_BITS) - 1  # largest predecessor distance a code holds

# device bytes of one launch (of one shard's, on the sharded route): the
# int16 dirs tensor, for rings that do not fit in shared memory the int16 H
# ring, and on the sharded route the two int16 [B, D, L] pair buffers
LAUNCH_BYTES = 1 << 30


def pair_lists(pairs: np.ndarray, offsets, counts) -> list:
    """Every walk's alignment, a list of (node id, position) tuples, from
    the expansion's int16 [total, 2] pairs: one tolist() a field, and walk
    w's tuples zipped from their slices at offsets[w] of counts[w].
    `chip_smoke.py` times this beside other ways to build the same lists
    (`decode_lists_row`): on an H100 machine's host it was the fastest."""
    pn, pp = pairs[:, 0].tolist(), pairs[:, 1].tolist()
    return [list(zip(pn[o : o + c], pp[o : o + c])) for o, c in zip(offsets, counts)]


def pack_windows(dense_seqs, nb: int, pb: int, wb: int, B: int = 0):
    """JAX-layout inputs of `poa_align` for the graphs packed by
    `graph_to_dense(graph, nb, pb)`, each with the code arrays aligned
    against it: codes/sink/node_id [B, 1, nb], preds [B, pb, nb], n_nodes
    [B, 1, 1], seqp [B, D, wb] (lane j = position j-1), seq_len [B, 1, D]
    (numpy int32). Padding sequences are one 'A'; with B over the number
    of graphs the slots past them are padding too (one sink node 'A')."""
    B = max(B, len(dense_seqs))
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


class DeviceProgramCounters:
    """The counts and seconds that the device programs of
    `pipeline/device_cycle.py` keep on the backend they run with (one with
    `supports_graph_cycle`): `TorchAlignerBackend` and
    `poa_full.FullAlignerBackend`."""

    def _init_program_counters(self) -> None:
        # the device prune cycle: seconds packing, in the cycle's program and
        # waiting for and fetching its results; windows on the card, windows
        # sent to the host and dispatches; cc_min_labels' rounds; the host
        # routes by reason (a shape past the ladders, the edge or node caps,
        # scores past int16, all three before packing, and the cycle's
        # overflow bits, graph_cycle.OVF_BITS; a
        # window past several of the cycle's capacities counts under each)
        self.t_cycle_pack = self.t_cycle_device = self.t_cycle_fetch = 0.0
        self.n_cycle_windows = self.n_cycle_host = self.n_cycle_dispatches = 0
        self.cycle_cc_rounds = 0
        self.cycle_host = dict.fromkeys(
            ("ladder", "edges_cap", "int16", "a_cap", "p_cap", "new_edges", "ring"), 0)
        # the device build (VECHAT_DEVICE_BUILD=1, build and prune cycle on
        # the device): seconds packing, in the build's and the cycle's
        # programs and fetching; windows on the card, windows sent to the
        # host build and dispatches; layer steps run; the host routes by
        # reason (a shape past the ladders, scores past int16, both before
        # packing; the build's overflow bits, graph_build.BUILD_OVF_BITS;
        # then, for a window the build kept, the cycle's, as cycle_<bit>)
        self.t_build_pack = self.t_build_device = self.t_build_fetch = 0.0
        self.n_build_windows = self.n_build_host = self.n_build_dispatches = 0
        self.build_layer_steps = 0
        self.build_host = dict.fromkeys(
            ("ladder", "int16", "n_cap", "e_cap", "r_cap", "p_cap", "ring", "cycle_a_cap",
             "cycle_p_cap", "cycle_new_edges", "cycle_ring"), 0)
        # the device round-2 consensus (VECHAT_DEVICE_LINEAR=1): seconds
        # packing, in its program and fetching; windows on the card, windows
        # sent to the host build and consensus, and dispatches; the host
        # routes by reason (a shape past the ladders, scores past int16,
        # both before packing; then the program's overflow bits,
        # graph_consensus.LINEAR_OVF_BITS: the build's, the slots', the
        # branch cap's)
        self.t_linear_pack = self.t_linear_device = self.t_linear_fetch = 0.0
        self.n_linear_windows = self.n_linear_host = self.n_linear_dispatches = 0
        self.linear_host = dict.fromkeys(
            ("ladder", "int16", "n_cap", "e_cap", "r_cap", "p_cap", "ring", "slots", "branch"), 0)

    def program_counters(self) -> Dict[str, float]:
        """The device programs' counts and seconds (`t_cycle_*`, `t_build_*`,
        `t_linear_*`) and their host routes by reason."""
        out = dict(
            n_cycle_windows=self.n_cycle_windows,
            n_cycle_host=self.n_cycle_host,
            n_cycle_dispatches=self.n_cycle_dispatches,
            cycle_cc_rounds=self.cycle_cc_rounds,
            t_cycle_pack=round(self.t_cycle_pack, 3),
            t_cycle_device=round(self.t_cycle_device, 3),
            t_cycle_fetch=round(self.t_cycle_fetch, 3),
            n_build_windows=self.n_build_windows,
            n_build_host=self.n_build_host,
            n_build_dispatches=self.n_build_dispatches,
            build_layer_steps=self.build_layer_steps,
            t_build_pack=round(self.t_build_pack, 3),
            t_build_device=round(self.t_build_device, 3),
            t_build_fetch=round(self.t_build_fetch, 3),
            n_linear_windows=self.n_linear_windows,
            n_linear_host=self.n_linear_host,
            n_linear_dispatches=self.n_linear_dispatches,
            t_linear_pack=round(self.t_linear_pack, 3),
            t_linear_device=round(self.t_linear_device, 3),
            t_linear_fetch=round(self.t_linear_fetch, 3),
        )
        out.update({f"cycle_host_{k}": v for k, v in self.cycle_host.items()})
        out.update({f"build_host_{k}": v for k, v in self.build_host.items()})
        out.update({f"linear_host_{k}": v for k, v in self.linear_host.items()})
        return out


class TorchAlignerBackend(DeviceProgramCounters):
    """Drop-in batch aligner running the POA kernels on `device`. With
    VECHAT_DEVICE_CYCLE=1 round 1's prune cycle runs on `self.device` too,
    with VECHAT_DEVICE_BUILD=1 round 1's build and prune cycle, with
    VECHAT_DEVICE_LINEAR=1 round 2's build and consensus
    (`pipeline/device_cycle.py`); their counts are in `counters()`."""

    supports_graph_cycle = True

    def __init__(self, match: int, mismatch: int, gap: int, device="cuda", devices=None):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        if devices is None:
            device = _build.resolve_device(device)
            # "cuda" is every visible card; "cuda:1" or "cpu" is that device
            all_cards = device.type == "cuda" and device.index is None
            devices = None if all_cards else [device]
        # one entry per shard of a window batch; the pairwise kernels and
        # the single-shard route run on the first
        self.devices = make_mesh(devices)
        self.device = self.devices[0]
        self._sharded_fns: Dict[Tuple, object] = {}
        self.n_sharded_dispatches = 0
        self._host_nw = LinearAligner("nw", match, mismatch, gap)
        self._host_sw = LinearAligner("sw", 3, -5, -4)  # src/window.cpp:326
        self.fallbacks = 0
        self.device_alignments = 0
        self.cell_updates = 0
        # stage timers (where does align_batch wall go?)
        self.t_pack = 0.0  # dense conversion + batch array fill
        self.t_device = 0.0  # upload + kernels + the counts' fetch
        self.t_decode = 0.0  # pairs' fetch + Alignment lists
        self.t_decode_fetch = 0.0  # of t_decode: the pairs' fetch
        self.t_host_fb = 0.0  # host-fallback alignments
        self.n_dispatches = 0
        self.n_calls = 0
        self._dense_cache: Dict[Tuple[int, int, int], Optional[dict]] = {}
        self._pairwise = None
        self._init_program_counters()

    def counters(self) -> Dict[str, float]:
        """Device and host-route counts of this backend, the device prune
        cycle's, the device build's and the device round-2 consensus's
        counts and seconds (`t_cycle_*`, `t_build_*`, `t_linear_*`), and the
        launches of every kernel in this process."""
        pw = self._pairwise
        out = dict(
            device_alignments=self.device_alignments,
            fallbacks=self.fallbacks,
            cell_updates=self.cell_updates,
            n_dispatches=self.n_dispatches,
            sharded_dispatches=self.n_sharded_dispatches,
            exact_pairs=pw.exact_pairs if pw else 0,
            exact_rejects=pw.exact_rejects if pw else 0,
            device_tiles=pw.device_tiles if pw else 0,
            pairwise_host_fallbacks=pw.host_fallbacks if pw else 0,
        )
        out.update(self.program_counters())
        out.update({f"launches_{k}": v for k, v in _build.LAUNCHES.items()})
        return out

    def edit_align_batch(self, pairs):
        """Overlap alignment on the pairwise kernels; the Polisher and
        refine_identity pick this up via duck typing."""
        if self._pairwise is None:
            from .pairwise_nw import DevicePairwiseAligner

            self._pairwise = DevicePairwiseAligner(device=self.device)
        return self._pairwise.edit_align_batch(pairs)

    def _sharded_fn(self, mode: str, ring: int):
        key = (mode, ring)
        fn = self._sharded_fns.get(key)
        if fn is None:
            fn = sharded_poa_align_cuda(
                self.devices, mode, *self._scores(mode), ring=ring, emit_node_ids=True
            )
            self._sharded_fns[key] = fn
        return fn

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
            n_shards = len(self.devices)
            if n_shards > 1:
                per_slot += 2 * d_used * (nb + wb) * 2
            max_b = max(1, LAUNCH_BYTES // per_slot) * n_shards
            for off in range(0, len(entries), max_b):
                self._run_chunk(
                    items, results, entries[off : off + max_b], mode, nb, pb, wb, ring
                )
        return results  # type: ignore[return-value]

    def _run_chunk(self, items, results, entries, mode, nb, pb, wb, ring):
        _t0 = time.perf_counter()
        n_shards = len(self.devices)
        # a sharded batch must divide by the shard count: padding slots
        codes, preds, sink, nid, nn, seqp, slen = pack_windows(
            [(self._dense(graph, nb, pb), [items[i][0] for i in idxs]) for graph, idxs in entries],
            nb, pb, wb, B=-(-len(entries) // n_shards) * n_shards,
        )
        D = seqp.shape[1]
        self.t_pack += time.perf_counter() - _t0

        _t0 = time.perf_counter()
        m, x, g = self._scores(mode)
        if n_shards > 1:
            dpn, dpp, count, _ = self._sharded_fn(mode, ring)(
                codes, preds, sink, nid, nn, seqp, slen
            )
            self.n_sharded_dispatches += 1
        else:
            pairs, offsets, count, _ = poa_align(
                codes, preds, sink, nn, seqp, slen, mode, m, x, g,
                ring=ring, device=self.device, emit_pairs=True, node_id=nid,
            )
        count = count.cpu().numpy()
        self.t_device += time.perf_counter() - _t0
        self.n_dispatches += 1

        _t0 = time.perf_counter()
        if n_shards > 1:
            dpn, dpp = dpn.numpy(), dpp.numpy()
            L = dpn.shape[2]
        else:
            offsets = offsets.tolist()
            pairs = pairs.cpu().numpy()
        self.t_decode_fetch += time.perf_counter() - _t0
        if n_shards == 1:
            alns = pair_lists(pairs, offsets, count.reshape(-1).tolist())
        for b, (graph, idxs) in enumerate(entries):
            for di, i in enumerate(idxs):
                c = int(count[b, 0, di])
                if n_shards > 1:
                    # walk (b, di)'s pairs are the last c columns of its row,
                    # every column before them -2
                    row = dpp[b, di]
                    n = c
                    if c > L or (c and row[L - c] == -2) or (c < L and row[L - c - 1] != -2):
                        n = int(np.count_nonzero(row != -2))
                    aln = list(zip(dpn[b, di, L - n :].tolist(), row[L - n :].tolist()))
                else:
                    aln = alns[b * D + di]
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
