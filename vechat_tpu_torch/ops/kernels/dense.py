"""Dense, rank-ordered packing of a POA graph for the device DP, and the
shape buckets the backend groups graphs into (numpy only).

Counterparts: `vechat_tpu/ops/kernels/poa_jax.py:graph_to_dense` and the
`N/W/P_BUCKETS` ladders of `vechat_tpu/ops/kernels/backend.py`. The kernel
takes its H-ring depth at run time, so there is no ring ladder: the backend
sizes each launch's ring to its largest predecessor distance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..poagraph import PoaGraph

# Node-capacity, sequence-width and in-degree buckets. The kernel skips rows
# past a graph's real node count, so N padding costs little; W and P pick
# the block width and the in-edge loop bound.
N_BUCKETS = (256, 640, 1152, 2048)
W_BUCKETS = (128, 320, 576, 768)
P_BUCKETS = (4, 8, 16)


def bucket(v: int, buckets) -> Optional[int]:
    """Smallest bucket >= v, or None when v exceeds the top bucket."""
    for b in buckets:
        if v <= b:
            return b
    return None


def graph_to_dense(graph: PoaGraph, n_cap: int, p_cap: int) -> Optional[dict]:
    """Pack a PoaGraph into rank-ordered dense arrays.

    Returns None when the graph exceeds (n_cap, p_cap) — caller falls back.
    Layout (all rank-ordered):
      codes[n_cap]    uint8   node character codes
      preds[n_cap,p]  int32   predecessor DP-row indices (rank+1), slot order
                              = in-edge insertion order; no-preds -> row 0;
                              padding repeats slot 0
      node_id[n_cap]  int32   rank -> original node id
      is_sink[n_cap]  bool    node has no out-edges
      n_nodes         int32
    """
    if hasattr(graph, "dense"):  # native C++ graph: fast path
        d = graph.dense(n_cap, p_cap)
        if d is None:
            return None
        return dict(
            codes=d["codes"],
            preds=np.ascontiguousarray(d["preds_pn"].T),
            node_id=d["node_id"],
            is_sink=d["is_sink"],
            n_nodes=d["n_nodes"],
        )
    n = graph.num_nodes()
    if n > n_cap:
        return None
    rank_of = graph.node_id_to_rank()
    codes = np.zeros(n_cap, dtype=np.uint8)
    preds = np.zeros((n_cap, p_cap), dtype=np.int32)
    node_id = np.zeros(n_cap, dtype=np.int32)
    is_sink = np.zeros(n_cap, dtype=bool)
    for r, v in enumerate(graph.rank_to_node):
        codes[r] = graph.codes[v]
        node_id[r] = v
        ins = graph.inedges[v]
        if len(ins) > p_cap:
            return None
        if not ins:
            preds[r, :] = 0
        else:
            first = rank_of[ins[0].tail] + 1
            preds[r, :] = first
            for s, e in enumerate(ins):
                preds[r, s] = rank_of[e.tail] + 1
        is_sink[r] = len(graph.outedges[v]) == 0
    return dict(
        codes=codes, preds=preds, node_id=node_id, is_sink=is_sink, n_nodes=n
    )
