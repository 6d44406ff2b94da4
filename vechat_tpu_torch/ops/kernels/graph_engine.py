"""Device drop-in for the host graph-alignment engines.

`TorchGraphEngine` has the `align(codes, graph, return_score)` API of
`ops/graph_align.py`'s Linear/Affine/ConvexAligner but runs the matching
kernel (`poa_linear` K1, K2 and the expansion / `poa_affine` K5 / `poa_convex`
K6), with the
subtype selection of spoa::AlignmentEngine::Create
(vendor/spoa/src/alignment_engine.cpp:57-66). A graph beyond the kernels'
capacity goes to the host oracle and is counted in `fallbacks`: node,
in-degree or width over the top bucket (in-degree over `P_CAP` for the
convex kernel), scores outside int16, a predecessor distance over 511.

Counterpart of `vechat_tpu/ops/kernels/graph_engine.py:PallasGraphEngine`,
for the spoa surface (one growing graph, one sequence at a time, B=1 D=1);
the correction path uses the batched `backend.py`. Three differences:
  - `device` takes the place of `interpret`: a CUDA device launches the
    kernels, "cpu" runs their plain PyTorch versions.
  - the ring is the dense graph's largest predecessor distance (at least
    1), not full history, so graphs past the 256-node bucket stay on the
    device; a distance over 511 (the 9-bit delta field) is a host route.
  - an nw alignment that starts by deleting the start node equals the host
    engine's (the walks end at cell (0, 0) in any state, see `poa_gap.py`);
    the reference's walks run past it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph_align import make_engine
from ..poagraph import PoaGraph
from . import _build
from .backend import MAX_RING, pack_windows, pair_lists
from .dense import N_BUCKETS, P_BUCKETS, W_BUCKETS, bucket, graph_to_dense
from .poa_affine import fits_int16_affine, poa_align_affine
from .poa_convex import P_CAP, fits_int16_convex, poa_align_convex
from .poa_linear import fits_int16, max_pred_distance, poa_align


class TorchGraphEngine:
    def __init__(
        self,
        align_type: str,
        m: int,
        n: int,
        g: int,
        e: Optional[int] = None,
        q: Optional[int] = None,
        c: Optional[int] = None,
        device="cuda",
    ):
        self.type = align_type
        self.m, self.n = int(m), int(n)
        self.g = int(g)
        self.e = int(g if e is None else e)
        self.q = int(g if q is None else q)
        self.c = int(self.e if c is None else c)
        self.device = _build.resolve_device(device)
        self.host = make_engine(align_type, m, n, g, e, q, c)
        if self.g >= self.e:
            self.subtype = "linear"
        elif self.g <= self.q or self.e >= self.c:
            self.subtype = "affine"
        else:
            self.subtype = "convex"
        self.device_alignments = 0
        self.fallbacks = 0

    def _fits(self, nb: int, wb: int) -> bool:
        if self.subtype == "linear":
            return fits_int16(nb, wb, self.m, self.n, self.g)
        if self.subtype == "affine":
            return fits_int16_affine(nb, wb, self.m, self.n, self.g, self.e)
        return fits_int16_convex(nb, wb, self.m, self.n, self.g, self.e, self.q, self.c)

    def pack(self, codes, graph: PoaGraph):
        """One launch's inputs for aligning `codes` to a non-empty `graph`:
        (the arrays of `pack_windows` at B=1, D=1 in the graph's buckets, the
        ring), or None when the graph or sequence is beyond the kernels'
        capacity and the alignment goes to the host."""
        if hasattr(graph, "max_in_degree"):
            max_deg = graph.max_in_degree()
        else:
            max_deg = max((len(ins) for ins in graph.inedges), default=0)
        nb = bucket(graph.num_nodes(), N_BUCKETS)
        pb = bucket(max(max_deg, 1), P_BUCKETS)
        wb = bucket(len(codes) + 1, W_BUCKETS)
        if self.subtype == "convex" and pb is not None and pb > P_CAP:
            pb = None
        if None in (nb, pb, wb) or not self._fits(nb, wb):
            return None
        d = graph_to_dense(graph, nb, pb)
        if d is None:
            return None
        dist = max_pred_distance(d["preds"], d["n_nodes"])
        if dist > MAX_RING:
            return None
        return pack_windows([(d, [codes])], nb, pb, wb), max(1, dist)

    def align(self, seq_codes, graph: PoaGraph, return_score: bool = False):
        codes = np.asarray(seq_codes)
        if graph.num_nodes() == 0 or len(codes) == 0:
            return ([], 0) if return_score else []
        packed = self.pack(codes, graph)
        if packed is None:
            self.fallbacks += 1
            return self.host.align(codes, graph, return_score=return_score)

        (cb, preds, sink, nid, nnb, seqp, slen), ring = packed
        common = dict(ring=ring, device=self.device)
        if self.subtype == "linear":
            # K2's headers expanded to node-id pairs on the device, as in the
            # batched backend
            pairs, _, _, score = poa_align(
                cb, preds, sink, nnb, seqp, slen, self.type, self.m, self.n, self.g,
                emit_pairs=True, node_id=nid, **common,
            )
            aln = pair_lists(pairs.cpu().numpy(), [0], [pairs.shape[0]])[0]
        else:
            # the walk writes node ids; its two rows, count and score come
            # to the host in one copy
            if self.subtype == "affine":
                pn, pp, count, score = poa_align_affine(
                    cb, preds, sink, nnb, seqp, slen, self.type, self.m, self.n,
                    self.g, self.e, node_id=nid, **common,
                )
            else:
                pn, pp, count, score = poa_align_convex(
                    cb, preds, sink, nnb, seqp, slen, self.type, self.m, self.n,
                    self.g, self.e, self.q, self.c, node_id=nid, **common,
                )
            L = pn.shape[2]
            host = torch.cat([pn.view(-1), pp.view(-1), count.view(-1), score.view(-1)])
            host = host.cpu().numpy()
            cnt = int(host[2 * L])
            aln = list(zip(host[L - cnt : L].tolist(), host[2 * L - cnt : 2 * L].tolist()))
            score = host[2 * L + 1]
        self.device_alignments += 1
        if return_score:
            return aln, int(score)
        return aln

    __call__ = align
