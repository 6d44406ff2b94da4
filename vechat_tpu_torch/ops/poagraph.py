"""Partial-order (variation) graph engine — host oracle.

A from-scratch, array-oriented reimplementation of the semantics of the
reference's modified spoa graph (vendor/spoa/src/graph.cpp), used as:

* the golden oracle that device kernels are tested against,
* the host fallback for windows that overflow device capacity limits.

Every behavioural subtlety of the reference is preserved (and cited):
edge-merge order, aligned-node ring construction, DFS topological order with
aligned-node grouping, heaviest-bundle tie-breaks, prune decision
simultaneity, DFS connected-component discovery order and `>=` tie-break,
weight reset in LargestSubgraph, and gap-reset in AddWeights.

An Alignment is a list of (node_id | -1, seq_pos | -1) pairs, exactly like
spoa::Alignment.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Alignment = List[Tuple[int, int]]


class Edge:
    __slots__ = ("tail", "head", "labels", "weight")

    def __init__(self, tail: int, head: int, label: int, weight: int):
        self.tail = tail
        self.head = head
        self.labels = [label]
        self.weight = int(weight)

    def add_sequence(self, label: int, weight: int = 1) -> None:
        # reference: graph.cpp:70-74
        self.labels.append(label)
        self.weight += int(weight)


class PoaGraph:
    """Nodes are integers 0..n-1 (creation order). Edge lists preserve
    insertion order; pruning removes edges from the per-node lists in place
    (the reference nulls the slots and every later traversal skips nulls,
    which is equivalent — graph.cpp:940-972)."""

    def __init__(self):
        self.codes: List[int] = []          # per node character code
        self.inedges: List[List[Edge]] = []   # per node, insertion order
        self.outedges: List[List[Edge]] = []
        self.aligned: List[List[int]] = []  # aligned-node rings, order matters
        self.edges: List[Edge] = []         # creation order
        self.sequences: List[Optional[int]] = []  # begin node per sequence
        self.rank_to_node: List[int] = []
        self.consensus: List[int] = []

    # ------------------------------------------------------------------ build

    def num_nodes(self) -> int:
        return len(self.codes)

    def add_node(self, code: int) -> int:
        # reference: graph.cpp:88-92
        self.codes.append(int(code))
        self.inedges.append([])
        self.outedges.append([])
        self.aligned.append([])
        return len(self.codes) - 1

    def add_edge(self, tail: int, head: int, weight: int) -> None:
        """Merge into an existing (tail->head) edge else append a new one
        (reference: graph.cpp:94-107). Label = current sequence count."""
        for e in self.outedges[tail]:
            if e.head == head:
                e.add_sequence(len(self.sequences), weight)
                return
        e = Edge(tail, head, len(self.sequences), weight)
        self.edges.append(e)
        self.outedges[tail].append(e)
        self.inedges[head].append(e)

    def _add_run(self, codes, weights, begin: int, end: int) -> Optional[int]:
        """Add a simple chain of nodes for codes[begin:end]; returns the FIRST
        node of the run (reference: graph.cpp:109-130)."""
        if begin == end:
            return None
        prev = None
        for i in range(begin, end):
            curr = self.add_node(codes[i])
            if prev is not None:
                self.add_edge(prev, curr, int(weights[i - 1]) + int(weights[i]))
            prev = curr
        return len(self.codes) - (end - begin)

    def add_alignment(self, alignment: Alignment, codes, weights) -> None:
        """Fuse an aligned sequence into the graph
        (reference: graph.cpp:182-299)."""
        codes = np.asarray(codes)
        weights = np.asarray(weights)
        seq_len = len(codes)
        if seq_len == 0:
            return
        if seq_len != len(weights):
            raise ValueError("sequence and weights are of unequal size")

        if not alignment:
            self.sequences.append(self._add_run(codes, weights, 0, seq_len))
            self.topological_sort()
            return

        valid = [p[1] for p in alignment if p[1] != -1]
        if not valid:
            raise ValueError("missing sequence in alignment")
        for v in valid:
            if v < 0 or v >= seq_len:
                raise ValueError("invalid alignment")

        # unaligned prefix/suffix runs (reference: graph.cpp:233-236)
        begin = self._add_run(codes, weights, 0, valid[0])
        prev = len(self.codes) - 1 if begin is not None else None
        last = self._add_run(codes, weights, valid[-1] + 1, seq_len)

        for node_id, seq_pos in alignment:
            if seq_pos == -1:
                continue
            code = int(codes[seq_pos])
            if node_id == -1:
                curr = self.add_node(code)
            else:
                if self.codes[node_id] == code:
                    curr = node_id
                else:
                    curr = None
                    for k in self.aligned[node_id]:
                        if self.codes[k] == code:
                            curr = k
                            break
                    if curr is None:
                        curr = self.add_node(code)
                        for k in self.aligned[node_id]:
                            self.aligned[k].append(curr)
                            self.aligned[curr].append(k)
                        self.aligned[node_id].append(curr)
                        self.aligned[curr].append(node_id)
            if begin is None:
                begin = curr
            if prev is not None:
                self.add_edge(
                    prev, curr, int(weights[seq_pos - 1]) + int(weights[seq_pos])
                )
            prev = curr
        if last is not None:
            self.add_edge(
                prev, last, int(weights[valid[-1]]) + int(weights[valid[-1] + 1])
            )
        self.sequences.append(begin)
        self.topological_sort()

    # ------------------------------------------------------------- topo order

    def topological_sort(self) -> None:
        """Iterative DFS producing the reference's exact rank order, with
        aligned-node bundles kept adjacent (reference: graph.cpp:301-371)."""
        n = self.num_nodes()
        self.rank_to_node = []
        marks = [0] * n
        ignored = [False] * n

        for start in range(n):
            if marks[start] != 0:
                continue
            stack = [start]
            while stack:
                curr = stack[-1]
                is_valid = True
                if marks[curr] != 2:
                    for e in self.inedges[curr]:
                        if e is not None and marks[e.tail] != 2:
                            stack.append(e.tail)
                            is_valid = False
                    if not ignored[curr]:
                        for a in self.aligned[curr]:
                            if marks[a] != 2:
                                stack.append(a)
                                ignored[a] = True
                                is_valid = False
                    if is_valid:
                        marks[curr] = 2
                        if not ignored[curr]:
                            self.rank_to_node.append(curr)
                            for a in self.aligned[curr]:
                                self.rank_to_node.append(a)
                    else:
                        marks[curr] = 1
                if is_valid:
                    stack.pop()

        assert len(self.rank_to_node) == n, "graph is not a DAG"

    def node_id_to_rank(self) -> np.ndarray:
        r = np.zeros(self.num_nodes(), dtype=np.int64)
        for i, v in enumerate(self.rank_to_node):
            r[v] = i
        return r

    # -------------------------------------------------------------- consensus

    def _coverage(self, node: int) -> int:
        """Distinct sequence labels over in+out edges
        (reference: graph.cpp:38-56)."""
        labels = set()
        for e in self.inedges[node]:
            labels.update(e.labels)
        for e in self.outedges[node]:
            labels.update(e.labels)
        return len(labels)

    def _traverse_heaviest_bundle(self) -> None:
        """reference: graph.cpp:534-588."""
        if not self.rank_to_node:
            return
        n = self.num_nodes()
        predecessors: List[Optional[int]] = [None] * n
        scores = [-1] * n
        maxn: Optional[int] = None

        for v in self.rank_to_node:
            for e in self.inedges[v]:
                if (scores[v] < e.weight) or (
                    scores[v] == e.weight
                    and scores[predecessors[v]] <= scores[e.tail]
                ):
                    scores[v] = e.weight
                    predecessors[v] = e.tail
            if predecessors[v] is not None:
                scores[v] += scores[predecessors[v]]
            if maxn is None or scores[maxn] < scores[v]:
                maxn = v

        if self.outedges[maxn]:
            rank_of = {v: i for i, v in enumerate(self.rank_to_node)}
            while self.outedges[maxn]:
                maxn = self._branch_completion(rank_of[maxn], scores, predecessors)

        self.consensus = []
        while predecessors[maxn] is not None:
            self.consensus.append(maxn)
            maxn = predecessors[maxn]
        self.consensus.append(maxn)
        self.consensus.reverse()

    def _branch_completion(self, rank: int, scores, predecessors) -> int:
        """reference: graph.cpp:590-638."""
        start = self.rank_to_node[rank]
        for e in self.outedges[start]:
            for e2 in self.inedges[e.head]:
                if e2.tail != start:
                    scores[e2.tail] = -1

        maxn = None
        for i in range(rank + 1, len(self.rank_to_node)):
            v = self.rank_to_node[i]
            scores[v] = -1
            predecessors[v] = None
            for e in self.inedges[v]:
                if scores[e.tail] == -1:
                    continue
                if (scores[v] < e.weight) or (
                    scores[v] == e.weight
                    and scores[predecessors[v]] <= scores[e.tail]
                ):
                    scores[v] = e.weight
                    predecessors[v] = e.tail
            if predecessors[v] is not None:
                scores[v] += scores[predecessors[v]]
            if maxn is None or scores[maxn] < scores[v]:
                maxn = v
        return maxn

    def generate_consensus(self) -> List[int]:
        """Heaviest-bundle consensus; returns node codes
        (reference: graph.cpp:450-459)."""
        self._traverse_heaviest_bundle()
        return [self.codes[v] for v in self.consensus]

    def generate_consensus_with_coverage(self) -> Tuple[List[int], List[int]]:
        """Consensus plus per-base coverage summary
        (reference: graph.cpp:461-485, non-verbose branch)."""
        codes = self.generate_consensus()
        coverages = []
        for v in self.consensus:
            c = self._coverage(v)
            for a in self.aligned[v]:
                c += self._coverage(a)
            coverages.append(c)
        return codes, coverages

    # ------------------------------------------------------------ checkpoint

    def save(self, path) -> None:
        """Serialize the full graph state (the analog of spoa's cereal
        archive, reference: vendor/spoa/include/spoa/graph.hpp:195-297;
        round-trip exercised like vendor/spoa/test/spoa_test.cpp:129-148)."""
        tails = np.array([e.tail for e in self.edges], dtype=np.int64)
        heads = np.array([e.head for e in self.edges], dtype=np.int64)
        weights = np.array([e.weight for e in self.edges], dtype=np.int64)
        label_flat = np.array(
            [l for e in self.edges for l in e.labels], dtype=np.int64
        )
        label_off = np.cumsum([0] + [len(e.labels) for e in self.edges])
        edge_index = {id(e): i for i, e in enumerate(self.edges)}

        def ragged(lists):
            flat = np.array([v for row in lists for v in row], dtype=np.int64)
            off = np.cumsum([0] + [len(row) for row in lists])
            return flat, off.astype(np.int64)

        in_flat, in_off = ragged(
            [[edge_index[id(e)] for e in row] for row in self.inedges]
        )
        out_flat, out_off = ragged(
            [[edge_index[id(e)] for e in row] for row in self.outedges]
        )
        al_flat, al_off = ragged(self.aligned)
        np.savez_compressed(
            path,
            codes=np.array(self.codes, dtype=np.int64),
            tails=tails,
            heads=heads,
            weights=weights,
            label_flat=label_flat,
            label_off=label_off,
            in_flat=in_flat,
            in_off=in_off,
            out_flat=out_flat,
            out_off=out_off,
            al_flat=al_flat,
            al_off=al_off,
            sequences=np.array(
                [-1 if s is None else s for s in self.sequences], dtype=np.int64
            ),
            rank_to_node=np.array(self.rank_to_node, dtype=np.int64),
            consensus=np.array(self.consensus, dtype=np.int64),
        )

    @classmethod
    def load(cls, path) -> "PoaGraph":
        z = np.load(path)
        g = cls()
        g.codes = [int(c) for c in z["codes"]]
        n = len(g.codes)
        edges = []
        for i in range(len(z["tails"])):
            e = Edge(int(z["tails"][i]), int(z["heads"][i]), 0, int(z["weights"][i]))
            e.labels = [
                int(l)
                for l in z["label_flat"][z["label_off"][i] : z["label_off"][i + 1]]
            ]
            edges.append(e)
        g.edges = edges

        def unragged(flat, off):
            return [
                [int(v) for v in flat[off[i] : off[i + 1]]] for i in range(n)
            ]

        g.inedges = [
            [edges[i] for i in row] for row in unragged(z["in_flat"], z["in_off"])
        ]
        g.outedges = [
            [edges[i] for i in row] for row in unragged(z["out_flat"], z["out_off"])
        ]
        g.aligned = unragged(z["al_flat"], z["al_off"])
        g.sequences = [None if s == -1 else int(s) for s in z["sequences"]]
        g.rank_to_node = [int(v) for v in z["rank_to_node"]]
        g.consensus = [int(v) for v in z["consensus"]]
        return g

    def successor(self, node: int, label: int) -> Optional[int]:
        """Next node of sequence `label` after `node`
        (reference: graph.cpp:25-36)."""
        for e in self.outedges[node]:
            if label in e.labels:
                return e.head
        return None

    def initialize_msa_columns(self) -> Tuple[List[int], int]:
        """node id -> MSA column; aligned bundles share a column
        (reference: graph.cpp:393-413)."""
        col = [0] * self.num_nodes()
        j = 0
        i = 0
        while i < len(self.rank_to_node):
            v = self.rank_to_node[i]
            col[v] = j
            for a in self.aligned[v]:
                i += 1
                col[a] = j
            i += 1
            j += 1
        return col, j

    def generate_msa(self, include_consensus: bool = False) -> List[str]:
        """Multiple sequence alignment rows (reference: graph.cpp:415-448)."""
        from .encode import DECODE

        col, width = self.initialize_msa_columns()
        rows: List[str] = []
        for i, begin in enumerate(self.sequences):
            row = ["-"] * width
            v = begin
            while v is not None:
                row[col[v]] = chr(DECODE[self.codes[v]])
                v = self.successor(v, i)
            rows.append("".join(row))
        if include_consensus:
            self._traverse_heaviest_bundle()
            row = ["-"] * width
            for v in self.consensus:
                row[col[v]] = chr(DECODE[self.codes[v]])
            rows.append("".join(row))
        return rows

    def to_gfa(
        self,
        headers: List[str],
        is_reversed: Optional[List[bool]] = None,
        include_consensus: bool = False,
    ) -> str:
        """GFA 1.0 dump (reference: vendor/spoa/src/main.cpp:120-201)."""
        from .encode import DECODE

        is_cons = [False] * self.num_nodes()
        for v in self.consensus:
            is_cons[v] = True
        lines = ["H\tVN:Z:1.0"]
        for v in range(self.num_nodes()):
            s = f"S\t{v + 1}\t{chr(DECODE[self.codes[v]])}"
            if is_cons[v]:
                s += "\tic:Z:true"
            lines.append(s)
            for e in self.outedges[v]:
                l = f"L\t{v + 1}\t+\t{e.head + 1}\t+\tOM\tew:f:{e.weight}"
                if is_cons[v] and is_cons[e.head]:
                    l += "\tic:Z:true"
                lines.append(l)
        for i, begin in enumerate(self.sequences):
            path = []
            v = begin
            while v is not None:
                path.append(v + 1)
                v = self.successor(v, i)
            ir = bool(is_reversed[i]) if is_reversed else False
            if ir:
                path.reverse()
            sign = "-" if ir else "+"
            lines.append(
                f"P\t{headers[i]}\t" + ",".join(f"{p}{sign}" for p in path) + "\t*"
            )
        if include_consensus:
            lines.append(
                "P\tConsensus\t"
                + ",".join(f"{v + 1}+" for v in self.consensus)
                + "\t*"
            )
        return "\n".join(lines) + "\n"

    def to_dot(self) -> str:
        """Graphviz dump (reference: graph.cpp:747-796)."""
        from .encode import DECODE

        cons_rank = [-1] * self.num_nodes()
        for r, v in enumerate(self.consensus):
            cons_rank[v] = r
        lines = [f"digraph {len(self.sequences)} {{", "  graph [rankdir = LR]"]
        for v in range(self.num_nodes()):
            style = (
                ", style = filled, fillcolor = goldenrod1"
                if cons_rank[v] != -1
                else ""
            )
            lines.append(
                f'  {v}[label = "{v} - {chr(DECODE[self.codes[v]])}"{style}]'
            )
            for e in self.outedges[v]:
                color = (
                    ", color = goldenrod1"
                    if cons_rank[v] + 1 == cons_rank[e.head] and cons_rank[v] != -1
                    else ""
                )
                lines.append(
                    f'  {v} -> {e.head} [label = "{e.weight}"{color}]'
                )
            for a in self.aligned[v]:
                if a > v:
                    lines.append(
                        f"  {v} -> {a} [style = dotted, arrowhead = none]"
                    )
        lines.append("}")
        return "\n".join(lines) + "\n"

    # --------------------------------------------------------------- subgraph

    def extract_subgraph_nodes(self, begin_id: int, end_id: int) -> List[bool]:
        """Backwards reachability from end_id down to ids >= begin_id
        (reference: graph.cpp:640-666)."""
        dst = [False] * self.num_nodes()
        stack = [end_id]
        while stack:
            curr = stack.pop()
            if not dst[curr] and curr >= begin_id:
                for e in self.inedges[curr]:
                    stack.append(e.tail)
                for a in self.aligned[curr]:
                    stack.append(a)
                dst[curr] = True
        return dst

    def subgraph(self, begin: int, end: int) -> Tuple["PoaGraph", List[int]]:
        """Positional subgraph over backbone node id span [begin, end];
        returns (subgraph, subgraph_node_id -> graph_node_id)
        (reference: graph.cpp:668-732)."""
        keep = self.extract_subgraph_nodes(begin, end)

        sub = PoaGraph()
        sub_to_graph: List[int] = []
        graph_to_sub = [None] * self.num_nodes()
        for v in range(self.num_nodes()):
            if not keep[v]:
                continue
            s = sub.add_node(self.codes[v])
            graph_to_sub[v] = s
            sub_to_graph.append(v)

        for v in range(self.num_nodes()):
            if not keep[v]:
                continue
            sv = graph_to_sub[v]
            for e in self.inedges[v]:
                if graph_to_sub[e.tail] is not None:
                    sub.add_edge(graph_to_sub[e.tail], sv, e.weight)
            for a in self.aligned[v]:
                if graph_to_sub[a] is not None:
                    sub.aligned[sv].append(graph_to_sub[a])

        sub.topological_sort()
        return sub, sub_to_graph

    @staticmethod
    def update_alignment(sub_to_graph: List[int], alignment: Alignment) -> Alignment:
        """Map subgraph node ids back to parent ids
        (reference: graph.cpp:734-745)."""
        return [
            (sub_to_graph[i] if i != -1 else -1, j) for (i, j) in alignment
        ]

    # ------------------------------------------------- VeChat graph extensions

    def prune_graph(
        self,
        min_weight: int,
        min_confidence: float,
        min_support: float,
        average_weight: float,
    ) -> None:
        """Drop low-confidence / low-support edges. Decisions are computed for
        all edges against the pre-prune state, then applied
        (reference: graph.cpp:811-982)."""
        prune = []
        for e in self.edges:
            if e.weight < min_weight:
                prune.append(True)
                continue
            # C++ float division: 0/0 -> NaN (comparisons false -> pruned),
            # x/0 -> +inf. np.float64 reproduces IEEE semantics exactly.
            with np.errstate(divide="ignore", invalid="ignore"):
                total_out = np.float64(sum(x.weight for x in self.outedges[e.tail]))
                confidence_uv = np.float64(e.weight) / total_out
                support = np.float64(e.weight) / np.float64(average_weight)
                total_in = np.float64(sum(x.weight for x in self.inedges[e.head]))
                confidence_vu = np.float64(e.weight) / total_in
            prune.append(
                not (
                    confidence_uv >= min_confidence
                    and confidence_vu >= min_confidence
                    and support >= min_support
                )
            )

        kept = []
        for e, p in zip(self.edges, prune):
            if p:
                self.outedges[e.tail].remove(e)
                self.inedges[e.head].remove(e)
            else:
                kept.append(e)
        self.edges = kept

    def _connected_components(self) -> List[List[int]]:
        """DFS connected components over the undirected edge structure, in the
        reference's discovery order: start vertices in id order; neighbours =
        in-edge tails then out-edge heads, each in slot order; preorder
        collection (reference: graph.cpp:984-1057). Implemented iteratively
        but preserving recursive-DFS visit order."""
        n = self.num_nodes()
        visited = [False] * n
        components: List[List[int]] = []
        for v0 in range(n):
            if visited[v0]:
                continue
            comp: List[int] = []
            # emulate recursion: stack of (node, iterator over adjacency)
            visited[v0] = True
            comp.append(v0)
            adj0 = [e.tail for e in self.inedges[v0]] + [
                e.head for e in self.outedges[v0]
            ]
            stack = [(v0, iter(adj0))]
            while stack:
                _, it = stack[-1]
                advanced = False
                for u in it:
                    if not visited[u]:
                        visited[u] = True
                        comp.append(u)
                        adj = [e.tail for e in self.inedges[u]] + [
                            e.head for e in self.outedges[u]
                        ]
                        stack.append((u, iter(adj)))
                        advanced = True
                        break
                if not advanced:
                    stack.pop()
            components.append(comp)
        return components

    def largest_subgraph(self) -> "PoaGraph":
        """Largest connected component as a fresh graph. Ties broken towards
        the LAST discovered component (`>=`, graph.cpp:1049); node order is
        DFS preorder; edge weights are RESET TO 0 and labels dropped
        (reference: graph.cpp:1021-1089)."""
        best: List[int] = []
        for comp in self._connected_components():
            if len(comp) >= len(best):
                best = comp

        sub = PoaGraph()
        v2sub = {}
        for v in best:
            v2sub[v] = sub.add_node(self.codes[v])
        for v in best:
            for e in self.outedges[v]:
                # always a fresh edge, weight 0, label 0 (graph.cpp:1091-1096)
                ne = Edge(v2sub[v], v2sub[e.head], 0, 0)
                sub.edges.append(ne)
                sub.outedges[ne.tail].append(ne)
                sub.inedges[ne.head].append(ne)
        sub.topological_sort()
        return sub

    def add_weights(self, alignment: Alignment, codes, weights) -> bool:
        """Re-weight edges along matched alignment pairs only; gaps reset the
        chain; nodes are never added (reference: graph.cpp:1104-1165).
        Returns False when the read failed to align (empty alignment)."""
        codes = np.asarray(codes)
        weights = np.asarray(weights)
        if len(codes) == 0:
            return True
        if len(codes) != len(weights):
            raise ValueError("sequence and weights are of unequal size")
        if not alignment:
            return False
        prev = None
        for node_id, seq_pos in alignment:
            if node_id == -1 or seq_pos == -1:
                prev = None
                continue
            curr = node_id
            if prev is not None:
                self.add_edge(
                    prev, curr, int(weights[seq_pos - 1]) + int(weights[seq_pos])
                )
            prev = curr
        return True

    def generate_corrected_sequence(self, alignment: Alignment) -> List[int]:
        """Emit codes of every graph node on the alignment path — including
        nodes not matched by the sequence (reference: graph.cpp:1167-1179)."""
        return [self.codes[i] for (i, _) in alignment if i != -1]
