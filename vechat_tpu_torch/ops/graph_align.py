"""Sequence-to-graph alignment — host oracle (linear / affine gap models).

Reimplements the semantics of the reference's scalar DP engine
(vendor/spoa/src/sisd_alignment_engine.cpp) with numpy-vectorised rows and an
exact Python traceback. Device implementations (the CUDA kernels) are verified
against this module.

Alignment types: 'nw' (global), 'sw' (local), 'ov' (semi-global), matching
spoa::AlignmentType kNW/kSW/kOV. The gap model is selected like
spoa::AlignmentEngine::Create (alignment_engine.cpp:57-66): linear iff g >= e.

Tie-break rules preserved exactly (sisd_alignment_engine.cpp:292-459):
* the maximum-score cell is the FIRST maximal cell in (rank, j) order
  (strict '<' update);
* traceback prefers diagonal moves through in-edges in insertion order, then
  vertical (graph-gap) moves in the same order, then the horizontal move.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .poagraph import Alignment, PoaGraph

NEG_INF = np.int32(np.iinfo(np.int32).min + 1024)  # kNegativeInfinity


def worst_case_score(i: int, j: int, m: int, g: int, e: int, q: int, c: int) -> int:
    """reference: alignment_engine.cpp:101-110."""

    def gap_score(length: int) -> int:
        if length == 0:
            return 0
        return min(g + (length - 1) * e, q + (length - 1) * c)

    return min(-1 * (m * min(i, j) + gap_score(abs(i - j))), gap_score(i) + gap_score(j))


class LinearAligner:
    """Linear-gap sequence-to-graph aligner (subtype kLinear)."""

    def __init__(self, align_type: str, m: int, n: int, g: int):
        assert align_type in ("nw", "sw", "ov")
        if g > 0:
            raise ValueError("gap penalty must be non-positive")
        self.type = align_type
        self.m = int(m)
        self.n = int(n)
        self.g = int(g)

    def align(
        self,
        seq_codes: np.ndarray,
        graph: PoaGraph,
        return_score: bool = False,
    ):
        seq_codes = np.asarray(seq_codes)
        self._seq = seq_codes
        W = len(seq_codes) + 1
        nn = graph.num_nodes()
        if nn == 0 or W == 1:
            return ([], 0) if return_score else []
        if (
            worst_case_score(len(seq_codes), nn, self.m, self.g, self.g, self.g, self.g)
            < NEG_INF
        ):
            raise ValueError("possible score overflow")

        g = np.int32(self.g)
        rank_to_node = graph.rank_to_node
        rank_of = graph.node_id_to_rank()

        H = np.zeros((nn + 1, W), dtype=np.int32)
        # row 0 / column 0 init (sisd_alignment_engine.cpp:180-253)
        if self.type == "nw":
            H[0, :] = np.arange(W, dtype=np.int32) * g
            for v in rank_to_node:
                i = rank_of[v] + 1
                ins = graph.inedges[v]
                if not ins:
                    pen = np.int32(0)
                else:
                    pen = NEG_INF
                    for e in ins:
                        pen = max(pen, H[rank_of[e.tail] + 1, 0])
                H[i, 0] = pen + g
        elif self.type == "ov":
            H[0, :] = np.arange(W, dtype=np.int32) * g
            H[1:, 0] = 0
        # sw: all zeros already

        jgrid = np.arange(W, dtype=np.int64) * int(g)
        max_score = np.int32(0) if self.type == "sw" else NEG_INF
        max_i = 0
        max_j = 0

        # profile rows per code, computed lazily
        profile_cache = {}

        def profile(code: int) -> np.ndarray:
            p = profile_cache.get(code)
            if p is None:
                p = np.where(seq_codes == code, np.int32(self.m), np.int32(self.n))
                profile_cache[code] = p
            return p

        for v in rank_to_node:
            i = rank_of[v] + 1
            prof = profile(graph.codes[v])
            ins = graph.inedges[v]
            pred_rows = [0] if not ins else [rank_of[e.tail] + 1 for e in ins]

            row = None
            for p in pred_rows:
                cand = np.maximum(H[p, :-1] + prof, H[p, 1:] + g)
                row = cand if row is None else np.maximum(row, cand)

            # in-row horizontal pass: H[j] = max(H[j-1]+g, H[j]) left to right
            # == running max of (value[k] - k*g) + j*g (g<=0, associative)
            full = np.empty(W, dtype=np.int64)
            full[0] = int(H[i, 0])
            full[1:] = row.astype(np.int64)
            run = np.maximum.accumulate(full - jgrid) + jgrid
            if self.type == "sw":
                run = np.maximum(run, 0)
            H[i, 1:] = run[1:].astype(np.int32)

            # max-score update, first maximal cell in scan order wins
            if self.type == "sw":
                jbest = int(np.argmax(H[i, 1:])) + 1
                if max_score < H[i, jbest]:
                    max_score, max_i, max_j = H[i, jbest], i, jbest
            elif self.type == "nw":
                if not graph.outedges[v] and max_score < H[i, W - 1]:
                    max_score, max_i, max_j = H[i, W - 1], i, W - 1
            else:  # ov
                if not graph.outedges[v]:
                    jbest = int(np.argmax(H[i, 1:])) + 1
                    if max_score < H[i, jbest]:
                        max_score, max_i, max_j = H[i, jbest], i, jbest

        if max_i == 0 and max_j == 0:
            return ([], int(max_score)) if return_score else []

        alignment = self._traceback(H, graph, rank_to_node, rank_of, max_i, max_j)
        if return_score:
            return alignment, int(max_score)
        return alignment

    def _traceback(self, H, graph, rank_to_node, rank_of, i, j) -> Alignment:
        """reference: sisd_alignment_engine.cpp:369-459."""
        g = self.g
        W = H.shape[1]
        alignment: Alignment = []
        prev_i = 0
        prev_j = 0

        def keep_going() -> bool:
            if self.type == "sw":
                return H[i, j] != 0
            if self.type == "nw":
                return not (i == 0 and j == 0)
            return not (i == 0 or j == 0)

        while keep_going():
            h_ij = H[i, j]
            found = False

            if i != 0 and j != 0:
                v = rank_to_node[i - 1]
                code = graph.codes[v]
                match_cost = self.m if code == self._seq_code(j) else self.n
                preds = (
                    [0]
                    if not graph.inedges[v]
                    else [rank_of[e.tail] + 1 for e in graph.inedges[v]]
                )
                for p in preds:
                    if h_ij == H[p, j - 1] + match_cost:
                        prev_i, prev_j, found = p, j - 1, True
                        break

            if not found and i != 0:
                v = rank_to_node[i - 1]
                preds = (
                    [0]
                    if not graph.inedges[v]
                    else [rank_of[e.tail] + 1 for e in graph.inedges[v]]
                )
                for p in preds:
                    if h_ij == H[p, j] + g:
                        prev_i, prev_j, found = p, j, True
                        break

            if not found and h_ij == H[i, j - 1] + g:
                prev_i, prev_j, found = i, j - 1, True

            alignment.append(
                (
                    -1 if i == prev_i else rank_to_node[i - 1],
                    -1 if j == prev_j else j - 1,
                )
            )
            i, j = prev_i, prev_j

        alignment.reverse()
        return alignment

    def _seq_code(self, j: int) -> int:
        return int(self._seq[j - 1])

    __call__ = align


class AffineAligner:
    """Affine-gap sequence-to-graph aligner (subtype kAffine,
    reference: sisd_alignment_engine.cpp:462-676)."""

    def __init__(self, align_type: str, m: int, n: int, g: int, e: int):
        assert align_type in ("nw", "sw", "ov")
        self.type = align_type
        self.m, self.n, self.g, self.e = int(m), int(n), int(g), int(e)

    def align(self, seq_codes, graph: PoaGraph, return_score: bool = False):
        seq_codes = np.asarray(seq_codes)
        W = len(seq_codes) + 1
        nn = graph.num_nodes()
        if nn == 0 or W == 1:
            return ([], 0) if return_score else []
        if (
            worst_case_score(len(seq_codes), nn, self.m, self.g, self.e, self.g, self.e)
            < NEG_INF
        ):
            raise ValueError("possible score overflow")

        m, x, g, e = self.m, self.n, self.g, self.e
        rank_to_node = graph.rank_to_node
        rank_of = graph.node_id_to_rank()

        H = np.zeros((nn + 1, W), dtype=np.int64)
        F = np.zeros((nn + 1, W), dtype=np.int64)
        E = np.zeros((nn + 1, W), dtype=np.int64)
        # row/col init (sisd_alignment_engine.cpp:157-253)
        F[0, 1:] = NEG_INF
        E[0, 1:] = g + (np.arange(1, W) - 1) * e
        for v in rank_to_node:
            i = rank_of[v] + 1
            ins = graph.inedges[v]
            pen = (g - e) if not ins else max(
                int(F[rank_of[p.tail] + 1, 0]) for p in ins
            )
            F[i, 0] = pen + e
            E[i, 0] = NEG_INF
        if self.type == "nw":
            H[0, 1:] = E[0, 1:]
            for v in rank_to_node:
                i = rank_of[v] + 1
                H[i, 0] = F[i, 0]
        elif self.type == "ov":
            H[0, 1:] = E[0, 1:]
            # H[i, 0] stays 0
        # sw: zeros

        jm1 = np.arange(W - 1, dtype=np.int64)
        max_score = 0 if self.type == "sw" else int(NEG_INF)
        max_i = max_j = 0

        for v in rank_to_node:
            i = rank_of[v] + 1
            code = graph.codes[v]
            prof = np.where(seq_codes == code, m, x).astype(np.int64)
            ins = graph.inedges[v]
            pred_rows = [0] if not ins else [rank_of[p.tail] + 1 for p in ins]

            Fr = None
            Hr = None
            for p in pred_rows:
                f_cand = np.maximum(H[p, 1:] + g, F[p, 1:] + e)
                h_cand = H[p, :-1] + prof
                Fr = f_cand if Fr is None else np.maximum(Fr, f_cand)
                Hr = h_cand if Hr is None else np.maximum(Hr, h_cand)

            # in-row E scan: E[j] = max(H[j-1]+g, E[j-1]+e) with final H
            # H_final[j] = max(Hr[j], Fr[j], E[j] [, 0 for SW])
            A = np.maximum(Hr, Fr)
            if self.type == "sw":
                A0 = np.maximum(A, 0)
            else:
                A0 = A
            # E[j] = max(A0_full[j-1] + g, E[j-1] + e) where A0_full[0]=H[i,0]
            seed = np.empty(W, dtype=np.int64)
            seed[0] = E[i, 0]
            hseed = np.empty(W, dtype=np.int64)
            hseed[0] = H[i, 0] if self.type != "sw" else max(int(H[i, 0]), 0)
            hseed[1:] = A0
            # T[j] = E[j] - j*e; T[j] = max(T[j-1], hseed[j-1]+g-j*e)
            jg = np.arange(W, dtype=np.int64) * e
            cand = np.empty(W, dtype=np.int64)
            cand[0] = seed[0]
            cand[1:] = hseed[:-1] + g - jg[1:]
            Erow = np.maximum.accumulate(cand) + jg
            E[i, :] = Erow
            Hrow = np.maximum(A, Erow[1:])
            if self.type == "sw":
                Hrow = np.maximum(Hrow, 0)
            H[i, 1:] = Hrow
            F[i, 1:] = Fr

            if self.type == "sw":
                jb = int(np.argmax(Hrow)) + 1
                if max_score < Hrow[jb - 1]:
                    max_score, max_i, max_j = int(Hrow[jb - 1]), i, jb
            elif self.type == "nw":
                if not graph.outedges[v] and max_score < Hrow[W - 2]:
                    max_score, max_i, max_j = int(Hrow[W - 2]), i, W - 1
            else:
                if not graph.outedges[v]:
                    jb = int(np.argmax(Hrow)) + 1
                    if max_score < Hrow[jb - 1]:
                        max_score, max_i, max_j = int(Hrow[jb - 1]), i, jb

        if max_i == 0 and max_j == 0:
            return ([], int(max_score)) if return_score else []

        aln = self._traceback(
            H, F, E, graph, rank_to_node, rank_of, seq_codes, max_i, max_j
        )
        return (aln, int(max_score)) if return_score else aln

    def _traceback(self, H, F, E, graph, rank_to_node, rank_of, seq, i, j):
        """reference: sisd_alignment_engine.cpp:550-675."""
        m, x, g, e = self.m, self.n, self.g, self.e
        W = H.shape[1]
        aln: Alignment = []
        prev_i = prev_j = 0

        def keep_going():
            if self.type == "sw":
                return H[i, j] != 0
            if self.type == "nw":
                return not (i == 0 and j == 0)
            return not (i == 0 or j == 0)

        while keep_going():
            h_ij = H[i, j]
            found = extend_left = extend_up = False

            if i != 0 and j != 0:
                v = rank_to_node[i - 1]
                mc = m if graph.codes[v] == int(seq[j - 1]) else x
                preds = (
                    [0]
                    if not graph.inedges[v]
                    else [rank_of[p.tail] + 1 for p in graph.inedges[v]]
                )
                for p in preds:
                    if h_ij == H[p, j - 1] + mc:
                        prev_i, prev_j, found = p, j - 1, True
                        break

            if not found and i != 0:
                v = rank_to_node[i - 1]
                preds = (
                    [0]
                    if not graph.inedges[v]
                    else [rank_of[p.tail] + 1 for p in graph.inedges[v]]
                )
                for p in preds:
                    if h_ij == F[p, j] + e:
                        extend_up = True
                        prev_i, prev_j, found = p, j, True
                        break
                    if h_ij == H[p, j] + g:
                        prev_i, prev_j, found = p, j, True
                        break

            if not found and j != 0:
                if h_ij == E[i, j - 1] + e:
                    extend_left = True
                    prev_i, prev_j, found = i, j - 1, True
                elif h_ij == H[i, j - 1] + g:
                    prev_i, prev_j, found = i, j - 1, True

            aln.append(
                (
                    -1 if i == prev_i else rank_to_node[i - 1],
                    -1 if j == prev_j else j - 1,
                )
            )
            i, j = prev_i, prev_j

            if extend_left:
                while True:
                    aln.append((-1, j - 1))
                    j -= 1
                    if E[i, j] + e != E[i, j + 1]:
                        break
            elif extend_up:
                while True:
                    stop = False
                    prev_i = 0
                    v = rank_to_node[i - 1]
                    for pe in graph.inedges[v]:
                        p = rank_of[pe.tail] + 1
                        if F[i, j] == H[p, j] + g:
                            stop = True
                            prev_i = p
                            break
                        if F[i, j] == F[p, j] + e:
                            prev_i = p
                            break
                    aln.append((rank_to_node[i - 1], -1))
                    i = prev_i
                    if stop or i == 0:
                        break

        aln.reverse()
        return aln

    __call__ = align


class ConvexAligner:
    """Convex (dual-affine) aligner (subtype kConvex,
    reference: sisd_alignment_engine.cpp:678-923). Serial rows — used by the
    spoa-CLI parity surface, not the correction hot path."""

    def __init__(self, align_type: str, m: int, n: int, g: int, e: int, q: int, c: int):
        assert align_type in ("nw", "sw", "ov")
        self.type = align_type
        self.m, self.n = int(m), int(n)
        self.g, self.e, self.q, self.c = int(g), int(e), int(q), int(c)

    def align(self, seq_codes, graph: PoaGraph, return_score: bool = False):
        seq_codes = np.asarray(seq_codes)
        W = len(seq_codes) + 1
        nn = graph.num_nodes()
        if nn == 0 or W == 1:
            return ([], 0) if return_score else []
        m, x, g, e, q, c = self.m, self.n, self.g, self.e, self.q, self.c
        if worst_case_score(len(seq_codes), nn, m, g, e, q, c) < NEG_INF:
            raise ValueError("possible score overflow")

        rank_to_node = graph.rank_to_node
        rank_of = graph.node_id_to_rank()
        H = np.zeros((nn + 1, W), dtype=np.int64)
        F = np.zeros((nn + 1, W), dtype=np.int64)
        E = np.zeros((nn + 1, W), dtype=np.int64)
        O = np.zeros((nn + 1, W), dtype=np.int64)
        Q = np.zeros((nn + 1, W), dtype=np.int64)

        # init (sisd_alignment_engine.cpp:140-253)
        O[0, 1:] = NEG_INF
        Q[0, 1:] = q + (np.arange(1, W) - 1) * c
        F[0, 1:] = NEG_INF
        E[0, 1:] = g + (np.arange(1, W) - 1) * e
        for v in rank_to_node:
            i = rank_of[v] + 1
            ins = graph.inedges[v]
            pen_o = (q - c) if not ins else max(
                int(O[rank_of[p.tail] + 1, 0]) for p in ins
            )
            O[i, 0] = pen_o + c
            Q[i, 0] = NEG_INF
            pen_f = (g - e) if not ins else max(
                int(F[rank_of[p.tail] + 1, 0]) for p in ins
            )
            F[i, 0] = pen_f + e
            E[i, 0] = NEG_INF
        if self.type == "nw":
            H[0, 1:] = np.maximum(Q[0, 1:], E[0, 1:])
            for v in rank_to_node:
                i = rank_of[v] + 1
                H[i, 0] = max(O[i, 0], F[i, 0])
        elif self.type == "ov":
            H[0, 1:] = np.maximum(Q[0, 1:], E[0, 1:])

        max_score = 0 if self.type == "sw" else int(NEG_INF)
        max_i = max_j = 0

        for v in rank_to_node:
            i = rank_of[v] + 1
            code = graph.codes[v]
            prof = np.where(seq_codes == code, m, x).astype(np.int64)
            ins = graph.inedges[v]
            pred_rows = [0] if not ins else [rank_of[p.tail] + 1 for p in ins]

            Fr = Or = Hr = None
            for p in pred_rows:
                f_cand = np.maximum(H[p, 1:] + g, F[p, 1:] + e)
                o_cand = np.maximum(H[p, 1:] + q, O[p, 1:] + c)
                h_cand = H[p, :-1] + prof
                Fr = f_cand if Fr is None else np.maximum(Fr, f_cand)
                Or = o_cand if Or is None else np.maximum(Or, o_cand)
                Hr = h_cand if Hr is None else np.maximum(Hr, h_cand)
            F[i, 1:] = Fr
            O[i, 1:] = Or

            # serial in-row E/Q/H (coupled recurrence)
            for jj in range(1, W):
                E[i, jj] = max(H[i, jj - 1] + g, E[i, jj - 1] + e)
                Q[i, jj] = max(H[i, jj - 1] + q, Q[i, jj - 1] + c)
                h = max(
                    int(Hr[jj - 1]),
                    int(F[i, jj]),
                    int(E[i, jj]),
                    int(O[i, jj]),
                    int(Q[i, jj]),
                )
                if self.type == "sw":
                    h = max(h, 0)
                    H[i, jj] = h
                    if max_score < h:
                        max_score, max_i, max_j = h, i, jj
                else:
                    H[i, jj] = h
                    if self.type == "nw":
                        if not graph.outedges[v] and jj == W - 1 and max_score < h:
                            max_score, max_i, max_j = h, i, jj
                    else:
                        if not graph.outedges[v] and max_score < h:
                            max_score, max_i, max_j = h, i, jj

        if max_i == 0 and max_j == 0:
            return ([], int(max_score)) if return_score else []
        aln = self._traceback(
            H, F, E, O, Q, graph, rank_to_node, rank_of, seq_codes, max_i, max_j
        )
        return (aln, int(max_score)) if return_score else aln

    def _traceback(self, H, F, E, O, Q, graph, rank_to_node, rank_of, seq, i, j):
        """reference: sisd_alignment_engine.cpp:778-922."""
        m, x, g, e, q, c = self.m, self.n, self.g, self.e, self.q, self.c
        aln: Alignment = []
        prev_i = prev_j = 0

        def keep_going():
            if self.type == "sw":
                return H[i, j] != 0
            if self.type == "nw":
                return not (i == 0 and j == 0)
            return not (i == 0 or j == 0)

        while keep_going():
            h_ij = H[i, j]
            found = extend_left = extend_up = False

            if i != 0 and j != 0:
                v = rank_to_node[i - 1]
                mc = m if graph.codes[v] == int(seq[j - 1]) else x
                preds = (
                    [0]
                    if not graph.inedges[v]
                    else [rank_of[p.tail] + 1 for p in graph.inedges[v]]
                )
                for p in preds:
                    if h_ij == H[p, j - 1] + mc:
                        prev_i, prev_j, found = p, j - 1, True
                        break

            if not found and i != 0:
                v = rank_to_node[i - 1]
                preds = (
                    [0]
                    if not graph.inedges[v]
                    else [rank_of[p.tail] + 1 for p in graph.inedges[v]]
                )
                for p in preds:
                    if h_ij == F[p, j] + e:
                        extend_up = True
                        prev_i, prev_j, found = p, j, True
                        break
                    if h_ij == H[p, j] + g:
                        prev_i, prev_j, found = p, j, True
                        break
                    if h_ij == O[p, j] + c:
                        extend_up = True
                        prev_i, prev_j, found = p, j, True
                        break
                    if h_ij == H[p, j] + q:
                        prev_i, prev_j, found = p, j, True
                        break

            if not found and j != 0:
                if h_ij == E[i, j - 1] + e:
                    extend_left = True
                    prev_i, prev_j, found = i, j - 1, True
                elif h_ij == H[i, j - 1] + g:
                    prev_i, prev_j, found = i, j - 1, True
                elif h_ij == Q[i, j - 1] + c:
                    extend_left = True
                    prev_i, prev_j, found = i, j - 1, True
                elif h_ij == H[i, j - 1] + q:
                    prev_i, prev_j, found = i, j - 1, True

            aln.append(
                (
                    -1 if i == prev_i else rank_to_node[i - 1],
                    -1 if j == prev_j else j - 1,
                )
            )
            i, j = prev_i, prev_j

            if extend_left:
                while True:
                    aln.append((-1, j - 1))
                    j -= 1
                    if (
                        E[i, j] + e != E[i, j + 1]
                        and Q[i, j] + c != Q[i, j + 1]
                    ):
                        break
            elif extend_up:
                while True:
                    stop = True
                    prev_i = 0
                    v = rank_to_node[i - 1]
                    for pe in graph.inedges[v]:
                        p = rank_of[pe.tail] + 1
                        if F[i, j] == F[p, j] + e or O[i, j] == O[p, j] + c:
                            prev_i = p
                            stop = False
                            break
                    if stop:
                        for pe in graph.inedges[v]:
                            p = rank_of[pe.tail] + 1
                            if F[i, j] == H[p, j] + g or O[i, j] == H[p, j] + q:
                                prev_i = p
                                break
                    aln.append((rank_to_node[i - 1], -1))
                    i = prev_i
                    if stop or i == 0:
                        break

        aln.reverse()
        return aln

    __call__ = align


def make_engine(
    align_type: str,
    m: int,
    n: int,
    g: int,
    e: Optional[int] = None,
    q: Optional[int] = None,
    c: Optional[int] = None,
):
    """Factory mirroring spoa::AlignmentEngine::Create subtype selection
    (alignment_engine.cpp:57-66): linear iff g >= e; affine iff g <= q or
    e >= c; else convex."""
    if e is None:
        e = g
    if q is None:
        q = g
    if c is None:
        c = e
    if g > 0 or q > 0:
        raise ValueError("gap opening penalty must be non-positive")
    if e > 0 or c > 0:
        raise ValueError("gap extension penalty must be non-positive")
    if g >= e:
        return LinearAligner(align_type, m, n, g)
    if g <= q or e >= c:
        return AffineAligner(align_type, m, n, g, e)
    return ConvexAligner(align_type, m, n, g, e, q, c)
