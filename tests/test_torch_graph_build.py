"""The port's device build (`vechat_tpu_torch/ops/kernels/graph_build.py`,
`pipeline/device_cycle.run_device_polish`) against the JAX package's
(`vechat_tpu/ops/kernels/graph_build.py`) on the same numpy inputs, on the
CPU, exact equality (integer arrays): `topo_ranks_bundled`,
`positional_subgraph`, `fuse_alignments` and `device_build`; the built
graphs against the host oracle too; numpy models of the warp steps of G3,
G4 and G5 against the plain machines; and `generate_consensus_haplotype`
with VECHAT_DEVICE_BUILD=1 byte for byte against the JAX package's host
path. The port's alignments run on the plain versions of K1 and the dense
walk, the JAX side on its own int32 DP.

A window flagged for overflow is compared by its flag alone: its graph is
thrown away, and the port freezes it where JAX goes on with clamped writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.graph_build_cases import at_the_edge_cap, with_duplicate_edges
from tests.test_graph_build import _assert_graph_equal, _noisy, _oracle_build
from tests.test_torch_graph_cycle import (
    _ballot,
    _bit,
    _clz,
    _eq,
    _ffs,
    _jax_host,
    _np,
    _pipeline_windows,
    _set,
    _windows_of,
)
from vechat_tpu.ops.encode import encode
from vechat_tpu.ops.kernels import graph_build as jgb
from vechat_tpu_torch.ops.kernels import graph_build as tgb
from vechat_tpu_torch.ops.kernels import graph_cycle as tgc

N, E, R, W = 128, 256, 8, 96
# the JAX parts, each compiled once for the shapes of this file
J_SUBGRAPH = jax.jit(jgb.positional_subgraph)
J_TOPO = jax.jit(jgb.topo_ranks_bundled)
J_FUSE = jax.jit(jgb.fuse_alignments)
BUILD_KEYS = ("codes", "tails", "heads", "weights", "n_nodes", "n_edges", "aligned", "acount",
              "lab_lo", "lab_hi")


def _layers(rng, base, bb, n, partial=True):
    """n layers of `base` as (codes, begin, end, full): spans cut at random
    ends (or the whole backbone), full where they pass the 1% offsets."""
    blen = len(bb)
    offset = int(0.01 * blen)
    out = []
    for _ in range(n):
        b0 = int(rng.integers(0, 10)) if partial else 0
        e0 = blen - 1 - (int(rng.integers(0, 10)) if partial else 0)
        seg = base[int(b0 / blen * len(base)) : int((e0 + 1) / blen * len(base))]
        out.append((encode(_noisy(rng, seg)), b0, e0, b0 < offset and e0 > blen - offset))
    return out


def _cases():
    """tests/test_graph_build.py's three cases (full-span layers, partial
    layers, a perfect duplicate), then windows of 0-7 layers, mixed full and
    partial, with seeded build weights: (backbone, layers, weights)."""
    out = []
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(list("ACGT"), size=50))
    bb = encode(_noisy(rng, base))
    out.append((bb, [(encode(_noisy(rng, base)), 0, len(bb) - 1, True) for _ in range(4)]))
    rng = np.random.default_rng(7)
    base = "".join(rng.choice(list("ACGT"), size=60))
    bb = encode(_noisy(rng, base))
    out.append((bb, _layers(rng, base, bb, 5)))
    rng = np.random.default_rng(11)
    base = "".join(rng.choice(list("ACGT"), size=30))
    bb = encode(base)
    out.append((bb, [(encode(base), 0, len(bb) - 1, True)]))
    rng = np.random.default_rng(19)
    for n in (0, 7, 3, 6, 2):
        base = "".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 75))))
        bb = encode(_noisy(rng, base))
        out.append((bb, _layers(rng, base, bb, n, partial=n % 2 == 1)))
    return out


def _pack(cases, weighted):
    B, SMAX = len(cases), max(1, max(len(ls) for _, ls in cases))
    wrng = np.random.default_rng(5)
    a = dict(bb_codes=np.zeros((B, W), np.int32), bb_w=np.zeros((B, W), np.int32),
             bb_len=np.zeros(B, np.int32), lseqs=np.full((B, SMAX, W), 0xFF, np.int32),
             lw=np.ones((B, SMAX, W), np.int32), llen=np.ones((B, SMAX), np.int32),
             lbegin=np.zeros((B, SMAX), np.int32), lend=np.zeros((B, SMAX), np.int32),
             lfull=np.zeros((B, SMAX), bool), n_layers=np.zeros(B, np.int32))
    if weighted:
        a["bb_w"] = wrng.integers(0, 40, size=(B, W)).astype(np.int32)
        a["lw"] = wrng.integers(0, 40, size=(B, SMAX, W)).astype(np.int32)
    for b, (bb, layers) in enumerate(cases):
        a["bb_codes"][b, : len(bb)] = bb
        a["bb_len"][b] = len(bb)
        a["n_layers"][b] = len(layers)
        for s, (codes, b0, e0, full) in enumerate(layers):
            a["lseqs"][b, s, : len(codes)] = codes
            a["llen"][b, s] = len(codes)
            a["lbegin"][b, s], a["lend"][b, s], a["lfull"][b, s] = b0, e0, full
    return a


BUILD_ARGS = ("bb_codes", "bb_w", "bb_len", "lseqs", "lw", "llen", "lbegin", "lend", "lfull",
              "n_layers")


def _build_both(arrays, track_labels, n_cap=N, e_cap=E):
    j = jgb.device_build(*(jnp.asarray(arrays[k]) for k in BUILD_ARGS), n_cap, e_cap, R, 3, -5,
                         -4, track_labels=track_labels)
    t = tgb.device_build(*(torch.from_numpy(arrays[k]) for k in BUILD_ARGS), n_cap, e_cap, R, 3,
                         -5, -4, track_labels=track_labels)
    return {k: np.asarray(v) for k, v in j.items()}, t


def _assert_built_equal(j, t, keys=BUILD_KEYS):
    """Equal overflow flags; every array of the windows not flagged."""
    _eq(j["overflow"], t["overflow"])
    assert t["overflow"].dtype == torch.bool and j["overflow"].dtype == bool
    ok = ~j["overflow"]
    for k in keys:
        assert _np(t[k]).shape == j[k].shape and _np(t[k]).dtype == j[k].dtype, k
        _eq(j[k][ok], _np(t[k])[ok])


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "labels"])
def built(request):
    """The eight windows through both builds: without labels at unit
    weights, with labels at seeded weights."""
    cases = _cases()
    arrays = _pack(cases, weighted=request.param)
    j, t = _build_both(arrays, request.param)
    return cases, arrays, j, t, request.param


def test_device_build_equals_jax(built):
    _, _, j, t, labels = built
    _assert_built_equal(j, t)
    assert not j["overflow"].any()
    assert (j["acount"] > 0).any(), "no ring was built"
    if labels:
        assert (j["lab_lo"] != 0).any() and (j["lab_lo"] < 0).sum() == 0
    assert (t["overflow_bits"] == 0).all()


def test_device_build_equals_the_host_oracle():
    """The port's graphs against spoa's rules as the host engine builds them
    (tests/test_graph_build.py's oracle), at unit weights."""
    cases = _cases()
    arrays = _pack(cases, weighted=False)
    t = tgb.device_build(*(torch.from_numpy(arrays[k]) for k in BUILD_ARGS), N, E, R, 3, -5, -4)
    out = {k: _np(v) for k, v in t.items()}
    for b, (bb, layers) in enumerate(cases):
        _assert_graph_equal(out, _oracle_build(bb, layers), b)


def test_device_build_flags_capacities_alike():
    """Caps hit at N and E (one backbone past N): equal flags; the windows
    kept are equal; the port's bits name the caps."""
    cases = _cases()
    arrays = _pack(cases, weighted=False)
    j, t = _build_both(arrays, False, n_cap=72, e_cap=96)
    assert arrays["bb_len"].max() > 72
    _assert_built_equal(j, t)
    assert j["overflow"].any() and not j["overflow"].all()
    bits = _np(t["overflow_bits"])
    assert (bits[j["overflow"]] & (tgb.OVF_N_CAP | tgb.OVF_E_CAP)).all()


# ---------------------------------------------------- the parts, one by one


def _subgraph_inputs(built, seed):
    """The built graphs with random spans: begin/end inside the backbone,
    some end < begin, some end past the nodes, mixed use_full."""
    _, arrays, j, _, _ = built
    rng = np.random.default_rng(seed)
    B = len(j["n_nodes"])
    blen = arrays["bb_len"]
    begin = rng.integers(0, np.maximum(blen // 2, 1)).astype(np.int32)
    end = (blen - 1 - rng.integers(0, 8, size=B)).astype(np.int32)
    end[1] = begin[1] - 1
    end[2] = j["n_nodes"][2] + 3
    use_full = rng.random(B) < 0.3
    use_full[1:4] = False
    return [j["codes"], j["tails"], j["heads"], j["weights"], j["n_edges"], j["aligned"],
            j["acount"], begin, end, use_full, j["n_nodes"]]


@pytest.mark.parametrize("seed", range(3))
def test_positional_subgraph_equals_jax(built, seed):
    args = _subgraph_inputs(built, seed)
    want = J_SUBGRAPH(*map(jnp.asarray, args))
    got = tgb.positional_subgraph(*map(torch.from_numpy, args))
    assert set(got) == set(want)
    for k in want:
        _eq(want[k], got[k])
    assert int(_np(got["n_sub"])[1]) == 0 and int(_np(got["n_sub"])[2]) == 0


def _topo_inputs(built, seed, p_cap):
    args = _subgraph_inputs(built, seed)
    sub = tgb.positional_subgraph(*map(torch.from_numpy, args))
    ne = sub["n_edges"].long()
    in_nbr, indeg, _, _ = tgc.build_in_slots(sub["tails"], sub["heads"],
                                             torch.arange(E)[None, :] < ne[:, None], N, p_cap)
    return [_np(a) for a in (in_nbr, indeg, sub["aligned"], sub["acount"], sub["n_sub"])]


@pytest.mark.parametrize("p_cap", [16, 2])
@pytest.mark.parametrize("seed", range(2))
def test_topo_ranks_bundled_equals_jax(built, seed, p_cap):
    """On the positional subgraphs of the built graphs (rings included), with
    the in-slot rows whole and cut short (P = 2)."""
    args = _topo_inputs(built, seed, p_cap)
    want = J_TOPO(*map(jnp.asarray, args))
    got = tgb.topo_ranks_bundled(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        _eq(w, g)


def _random_pairs(rng, n_nodes, slen, L, kind):
    """A pair stream back to front in [L]: (node | -1, position | -1) over
    the sequence's positions in order, with deletions; `kind` "prefix"
    leaves unaligned runs at both ends, "none" has no positions."""
    pairs = np.full((L, 2), -2, np.int32)
    lo, hi = 0, slen
    if kind == "prefix":
        lo, hi = int(rng.integers(1, 6)), slen - int(rng.integers(1, 6))
    rows = []
    for p in range(lo, hi):
        while rng.random() < 0.1:
            rows.append((int(rng.integers(0, n_nodes)), -1))
        rows.append((int(rng.integers(0, n_nodes)) if rng.random() < 0.85 else -1, p))
    if kind == "none":
        rows = [(int(rng.integers(0, n_nodes)), -1) for _ in range(5)]
    rows = rows[: L]
    if rows:
        pairs[L - len(rows) :] = rows
    return pairs, len(rows)


def _fuse_inputs(built, seed, labels, crowd=False, e_cap=E):
    """The built graphs, each with a random pair stream and sequence; one
    window with count 0, one inactive, one whose positions are all -1. With
    `crowd`, every window starts 10 nodes short of N; `e_cap` cuts the edge
    arrays (the edges past it dropped)."""
    _, _, j, _, _ = built
    rng = np.random.default_rng(seed)
    B = len(j["n_nodes"])
    L = N + W + 1
    pairs = np.full((B, L, 2), -2, np.int32)
    count = np.zeros(B, np.int32)
    seq = np.full((B, W), 0xFF, np.int32)
    seq_w = rng.integers(0, 40, size=(B, W)).astype(np.int32)
    seq_len = rng.integers(20, W - 10, size=B).astype(np.int32)
    for b in range(B):
        seq[b, : seq_len[b]] = rng.integers(0, 4, size=seq_len[b])
        kind = "none" if b == 6 else ("prefix" if b % 2 else "whole")
        pairs[b], count[b] = _random_pairs(rng, int(j["n_nodes"][b]), int(seq_len[b]), L, kind)
    count[4] = 0
    active = np.ones(B, bool)
    active[5] = False

    def cut(a):
        return np.ascontiguousarray(a[:, :e_cap])

    n_nodes = np.maximum(j["n_nodes"], N - 10) if crowd else j["n_nodes"]
    g = [j["codes"], cut(j["tails"]), cut(j["heads"]), cut(j["weights"]), n_nodes,
         np.minimum(j["n_edges"], e_cap), j["aligned"], j["acount"]]
    args = g + [pairs, count, seq, seq_w, seq_len, active]
    if labels:
        lab = [rng.integers(-2**31, 2**31, size=(B, e_cap)).astype(np.int32) for _ in range(2)]
        bits = [np.full(B, tgb._bit32(31), np.int32), np.full(B, 1 << 3, np.int32)]
        args += lab + bits
    return args


def _fuse_equal(want, got):
    ovf = np.asarray(want[8])
    _eq(ovf, got[8])
    for k, (w, g) in enumerate(zip(want, got)):
        if k != 8:
            _eq(np.asarray(w)[~ovf], _np(g)[~ovf])
    return ovf


@pytest.mark.parametrize("labels", [False, True], ids=["plain", "labels"])
@pytest.mark.parametrize("seed", range(2))
def test_fuse_alignments_equals_jax(built, seed, labels):
    """Random pair streams over the built graphs (new nodes, matches,
    mismatches that ring-link, deletions), prefix and suffix runs, count 0,
    no positions, an inactive window; with and without labels."""
    args = _fuse_inputs(built, seed, labels)
    want = J_FUSE(*map(jnp.asarray, args))
    got = tgb.fuse_alignments(*map(torch.from_numpy, args))
    ovf = _fuse_equal(want, got)
    assert not ovf[:3].all()
    _eq(np.asarray(want[4])[5], args[4][5])  # the inactive window is unchanged


@pytest.mark.parametrize("caps", [(True, E), (False, 120)], ids=["nodes", "edges"])
def test_fuse_alignments_flags_overflow_alike(built, caps):
    """Nodes past N or edges past E: the same windows flagged, by the same
    bits in the port; the windows kept are equal."""
    args = _fuse_inputs(built, 7, False, *caps)
    want = J_FUSE(*map(jnp.asarray, args))
    got = tgb.fuse_walk(*map(torch.from_numpy, args))
    ovf = _fuse_equal(want, (*got[:8], _np(got[8]) != 0, *got[9:]))
    assert ovf.any()
    bit = tgb.OVF_N_CAP if caps[0] else tgb.OVF_E_CAP
    assert (_np(got[8])[ovf] & bit).all()


def test_fuse_alignments_flags_full_rings_alike(built):
    """Rings past R: a stream of 12 codes against one node links a new node
    to its column for each code it has not seen."""
    args = _fuse_inputs(built, 3, False)
    pairs, count, seq = args[8], args[9], args[10]
    L = pairs.shape[1]
    for b in (0, 2):
        seq[b, :40] = np.arange(40) % 12
        pairs[b, L - 40 :] = [(1, p) for p in range(40)]
        count[b] = 40
    want = J_FUSE(*map(jnp.asarray, args))
    got = tgb.fuse_walk(*map(torch.from_numpy, args))
    ovf = _fuse_equal(want, (*got[:8], _np(got[8]) != 0, *got[9:]))
    assert ovf[0] and ovf[2] and (_np(got[8])[[0, 2]] & tgb.OVF_R_CAP).all()


# ------------------------------------------- numpy models of the warps


def g3_warp(in_nbr, indeg, aligned, acount, n_nodes, staged=True):
    """csrc/graph_build.cu:graph_topo_bundled_kernel for one window, step for
    step: the rows staged as uint16 ids [N, P + R] beside the (indeg, acount)
    pairs (the shared form; `staged` False: read where they lie); the root
    from a cursor that moves forward a word of both bitmaps at a time;
    lanes 0..P-1 the in-slots, P..P+R-1 the ring; the top's row and counts
    carried from the step before; read first, the bits the step tests and
    the node below the top with its row (the next top after a pop); the
    pushed node's row loaded as the step decides; the last unmet by 31 -
    __clz; the claims (none of a node already claimed); a representative's ring emitted, its slots' last
    writes winning where a ring past R or ranks past N make them collide."""
    n, p = in_nbr.shape
    r_cap = aligned.shape[1]
    k_row = p + r_cap
    words = (n + 31) // 32
    emitted, bundled = np.zeros(words, np.uint32), np.zeros(words, np.uint32)
    rank_of, rank_to_node, stack = (np.zeros(n, np.int64) for _ in range(3))
    if staged:
        ids = np.concatenate([in_nbr, aligned], axis=1).astype(np.uint16)
        counts = np.stack([indeg, acount], axis=1).astype(np.int32)

    def load(v):
        if staged:
            return [int(ids[v, k]) if k < k_row else 0 for k in range(32)], tuple(counts[v])
        row = [int(in_nbr[v, k]) if k < p else int(aligned[v, k - p]) if k < k_row else 0
               for k in range(32)]
        return row, (int(indeg[v]), int(acount[v]))

    nn = int(n_nodes)
    last = min(nn, n)
    sp = rcnt = cursor = v = 0
    node, (dv, av) = [0] * 32, (0, 0)
    for _ in range(tgb.topo_steps(n)):
        if not (sp > 0 or rcnt < nn):
            break
        if sp == 0:
            while cursor < last:
                w = cursor >> 5
                avail = ~(int(emitted[w]) | int(bundled[w])) & (0xFFFFFFFF << (cursor & 31))
                avail &= 0xFFFFFFFF
                if avail:
                    cursor = (cursor & ~31) + _ffs(avail) - 1
                    break
                cursor = (cursor & ~31) + 32
            v = cursor if cursor < last else 0
            node, (dv, av) = load(v)
            stack[0], sp = v, 1
            continue
        below = int(stack[min(max(sp - 2, 0), n - 1)])
        below_row = load(below)
        vb = _bit(bundled, v)
        unmet = [False] * 32
        for lane in range(k_row):
            r = lane - p
            live = lane < dv if lane < p else (not vb and r < av)
            unmet[lane] = live and not _bit(emitted, node[lane])
        ball = _ballot(unmet)
        if ball:
            u = node[31 - _clz(ball)]
            nxt = load(u)
            for lane in range(p, 32):
                if unmet[lane]:
                    _set(bundled, node[lane])
            stack[min(sp, n - 1)] = u
            sp, v = sp + 1, u
        else:
            nxt = below_row
            _set(emitted, v)
            if not vb:
                rank_to_node[min(rcnt, n - 1)], rank_of[v] = v, rcnt
                for r in range(min(r_cap, 32 - p)):
                    if r < av:
                        pos = rcnt + 1 + r
                        rank_to_node[min(pos, n - 1)] = node[p + r]
                        rank_of[node[p + r]] = pos
                rcnt += 1 + av
            sp, v = sp - 1, below
        node, (dv, av) = nxt[0], nxt[1]
    return rank_of, rank_to_node


def g5_warp(tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes, order):
    """csrc/graph_build.cu:graph_reach_kernel for one window: the block's
    grouping (the edges with both ends in [max(begin, 0), n_nodes) counted
    by head, the inclusive scan over N + 1 heads, each tail scattered down
    from its group's end; the scatter visits the edges in `order`, as the
    block's atomics land in no fixed order), then the warp's traversal: up
    to 4 nodes popped a step, lanes 8g..8g+7 taking the g-th from the top's
    candidates (its ring, then its in-edges) 8 at a time, each new node
    claimed on the bitmap and pushed at its rank in the ballot."""
    n, r_cap = aligned.shape
    real = min(int(n_nodes), n)
    first = max(int(begin), 0)
    if use_full or not (begin <= end and 0 <= end < real):
        return np.arange(n) < real if use_full else np.zeros(n, bool)
    ne = min(int(n_edges), len(tails))
    ok = [first <= tails[k] < real and first <= heads[k] < real for k in range(ne)]
    pos = np.zeros(n + 1, np.int64)
    for k in range(ne):
        if ok[k]:
            pos[heads[k]] += 1
    pos = np.cumsum(pos)
    csr = np.zeros(max(ne, 1), np.int64)
    for k in order:
        if k < ne and ok[k]:
            pos[heads[k]] -= 1
            csr[pos[heads[k]]] = tails[k]
    kept = np.zeros((n + 31) // 32, np.uint32)
    stack = np.zeros(n, np.int64)
    _set(kept, int(end))
    stack[0], sp = end, 1
    while sp > 0:
        take = min(sp, 4)
        popped = [int(stack[sp - 1 - g]) for g in range(take)]
        sp -= take
        cands = []
        for v in popped:
            av = min(int(acount[v]), r_cap)
            cands.append([int(aligned[v, i]) for i in range(av)]
                         + [int(csr[k]) for k in range(pos[v], pos[v + 1])])
        for base in range(0, max(len(c) for c in cands), 8):
            lanes = [cands[g][base + sub] if g < take and base + sub < len(cands[g]) else None
                     for g in range(4) for sub in range(8)]
            mine = []
            for c in lanes:
                ok = c is not None and first <= c < real and not _bit(kept, c)
                if ok:
                    _set(kept, c)
                mine.append(ok)
            ball = _ballot(mine)
            for lane, c in enumerate(lanes):
                if mine[lane]:
                    stack[sp + bin(ball & ((1 << lane) - 1)).count("1")] = c
            sp += bin(ball).count("1")
    return np.array([_bit(kept, i) for i in range(n)], bool)


class G4Warp:
    """csrc/graph_build.cu:graph_fuse_kernel for one window: the block's
    out-edge lists (the slots below min(n_edges, E - 1) pushed at the head
    of their tail's list in `order`, as the block's atomicExch pushes land
    in no fixed order), then the warp's uniform walk: positions and pairs 32
    at a time, the pairs with a position taken in order (__ffs of the
    ballot), the edge lookup as the least index with the head over the
    tail's whole list and slot E - 1 on its own once n_edges >= E, an
    append listed below E - 1, the ring slots as lanes (__ffs of the
    hits)."""

    def __init__(self, codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, seq,
                 seq_w, order, labels=None, bits=(0, 0)):
        self.codes, self.th = codes.copy(), [list(x) for x in zip(tails, heads)]
        self.weights, self.aligned, self.acount = weights.copy(), aligned.copy(), acount.copy()
        self.lab = None if labels is None else [x.copy() for x in labels]
        self.bits = bits
        self.seq, self.seq_w = seq, seq_w
        self.n_nodes, self.n_edges, self.ovf = int(n_nodes), int(n_edges), 0
        self.N, self.E, self.R, self.W = len(codes), len(tails), aligned.shape[1], len(seq)
        self.first, self.next = [-1] * self.N, [-1] * self.E
        for e in order:
            t = self.th[e][0]
            if e < min(self.n_edges, self.E - 1) and 0 <= t < self.N:
                self.next[e], self.first[t] = self.first[t], e

    def at(self, a, i):
        return int(a[min(max(i, 0), self.W - 1)])

    def add_node(self, code):
        pos = min(self.n_nodes, self.N - 1)
        self.codes[pos] = code
        self.n_nodes += 1
        return pos

    def add_edge(self, t, h, w):
        E, found, e = self.E, self.E, self.first[t]
        while e >= 0:
            if self.th[e][1] == h and e < found:
                found = e
            e = self.next[e]
        if found == E and self.n_edges >= E and self.th[E - 1] == [t, h]:
            found = E - 1
        if found < E:
            self.weights[found] += w
            if self.lab:
                for lw, bit in zip(self.lab, self.bits):
                    lw[found] |= bit
        else:
            pos = min(self.n_edges, E - 1)
            self.th[pos], self.weights[pos] = [t, h], w
            if self.lab:
                for lw, bit in zip(self.lab, self.bits):
                    lw[pos] = bit
            if pos < E - 1:
                self.next[pos], self.first[t] = self.first[t], pos
            if self.n_edges >= E:
                self.ovf |= tgb.OVF_E_CAP
            self.n_edges += 1

    def run(self, lo, hi):
        prev = first = -1
        for base in range(lo, hi, 32):
            lanes = [(self.at(self.seq, i), self.at(self.seq_w, i - 1) + self.at(self.seq_w, i))
                     for i in range(base, base + 32)]
            for j in range(min(32, hi - base)):
                code, w = lanes[j]
                nid = self.add_node(code)
                if prev >= 0 and base + j > lo:
                    self.add_edge(prev, nid, w)
                first = nid if first < 0 else first
                prev = nid
        return prev, first

    def pair(self, a_n, code):
        is_new = a_n < 0
        jt = 0 if is_new else min(a_n, self.N - 1)
        jt_match = not is_new and self.codes[jt] == code
        av = int(self.acount[jt])
        m = [int(self.aligned[jt, r]) for r in range(self.R)]
        members = range(min(av, self.R))
        m_pos = {r: min(int(self.acount[m[r]]), self.R - 1) for r in members}
        hits = _ballot(not is_new and not jt_match and r < av and self.codes[m[r]] == code
                       for r in range(self.R))
        ring_node = m[_ffs(hits) - 1] if hits else m[0]
        need_new = is_new or (not jt_match and not hits)
        new_id = self.add_node(code) if need_new else 0
        curr = jt if jt_match else (ring_node if hits else new_id)
        if need_new and not is_new:
            for r in members:
                self.aligned[m[r], m_pos[r]] = curr
                self.acount[m[r]] += 1
            for r in members:
                self.aligned[curr, r] = m[r]
            slot = min(av, self.R - 1)
            self.aligned[curr, slot], self.acount[curr] = jt, av + 1
            self.aligned[jt, slot] = curr
            self.acount[jt] += 1
            if av + 1 > self.R:
                self.ovf |= tgb.OVF_R_CAP
        return curr

    def walk(self, pairs, count, slen, active):
        L = len(pairs)
        k0 = max(L - int(count), 0)
        ps = [int(p) for p in pairs[k0:, 1] if p >= 0]
        no_aln = count == 0 or not ps
        vfront, vback = (slen, slen - 1) if no_aln else (min(ps), max(ps))
        if active:
            prefix_prev, _ = self.run(0, vfront)
            _, suffix_first = self.run(vback + 1, slen)
            prev = prefix_prev
            if not no_aln:
                for base in range(k0, L, 32):
                    rows = [(int(pairs[k, 0]), int(pairs[k, 1])) if k < L else (0, -1)
                            for k in range(base, base + 32)]
                    for j in (j for j, (_, a_p) in enumerate(rows) if a_p >= 0):
                        a_n, a_p = rows[j]
                        w = self.at(self.seq_w, a_p - 1) + self.at(self.seq_w, a_p)
                        curr = self.pair(a_n, self.at(self.seq, a_p))
                        if prev >= 0:
                            self.add_edge(prev, curr, w)
                        prev = curr
                if suffix_first >= 0 and prev >= 0:
                    self.add_edge(prev, suffix_first,
                                  self.at(self.seq_w, vback) + self.at(self.seq_w, vback + 1))
        if self.n_nodes > self.N:
            self.ovf |= tgb.OVF_N_CAP
        if self.n_edges > self.E:
            self.ovf |= tgb.OVF_E_CAP


def _g3_model_equals_plain(args):
    """The warp model of G3, both forms, against the plain machine, window by
    window; returns the plain machine's outputs."""
    rank_of, r2n = tgb.topo_ranks_bundled(*map(torch.from_numpy, args))
    for b in range(len(args[4])):
        for staged in (True, False):
            ro, rn = g3_warp(*(a[b] for a in args), staged=staged)
            _eq(ro, rank_of[b])
            _eq(rn, r2n[b])
    return rank_of, r2n


@pytest.mark.parametrize("p_cap", [16, 2])
def test_warp_model_of_g3_equals_the_plain_machine(built, p_cap):
    for seed in range(3):
        _g3_model_equals_plain(_topo_inputs(built, 10 + seed, p_cap))


@pytest.mark.parametrize("case", ["cyclic", "counts_past_caps"])
def test_warp_model_of_g3_on_flagged_windows(built, case):
    """Windows only a flagged build gives G3, against JAX and the warp
    model: a cycle (node 0 waits on node 1 and 1 on 0, so the stack grows
    past N and every write clamps until topo_steps(N) stops the machine),
    and in-degrees past P and ring counts past R (the lanes take their
    caps, the ranks count the whole ring, slots of padding collide)."""
    args = _topo_inputs(built, 12, 16)
    in_nbr, indeg, aligned, acount, n_sub = args
    if case == "cyclic":
        for b in (0, 2):
            in_nbr[b, 0, 0], in_nbr[b, 1, 0] = 1, 0
            indeg[b, 0], indeg[b, 1] = max(indeg[b, 0], 1), max(indeg[b, 1], 1)
    else:
        rng = np.random.default_rng(12)
        for b in range(len(n_sub)):
            nodes = rng.integers(0, max(int(n_sub[b]), 1), size=6)
            indeg[b, nodes[:3]] += 16
            acount[b, nodes[3:]] = aligned.shape[2] + rng.integers(1, 4, size=3)
    want = J_TOPO(*map(jnp.asarray, args))
    got = _g3_model_equals_plain(args)
    for w, g in zip(want, got):
        _eq(w, g)


def _reach_cuts(built, seed):
    """_subgraph_inputs with cuts past the middle of every backbone: begin at
    a half to two thirds of it (most edges lie outside the cut), a third of
    the windows use_full, two with end < begin."""
    args = _subgraph_inputs(built, seed)
    rng = np.random.default_rng(seed)
    blen = built[1]["bb_len"]
    begin = (blen * rng.uniform(0.5, 0.67, size=len(blen))).astype(np.int32)
    end = (blen - 1 - rng.integers(0, 4, size=len(blen))).astype(np.int32)
    end[[0, 5]] = begin[[0, 5]] - 1
    use_full = np.zeros(len(blen), bool)
    use_full[[2, 6]] = True
    return args[:7] + [begin, end, use_full, args[10]]


def _g5_model_equals_plain(args, rng):
    (codes, tails, heads, weights, n_edges, aligned, acount, begin, end, use_full,
     n_nodes) = args
    keep = tgb.reach_keep(*map(torch.from_numpy, (tails, heads, n_edges, aligned, acount, begin,
                                                  end, use_full, n_nodes)))
    assert _np(keep).sum() > 0
    for b in range(len(n_nodes)):
        got = g5_warp(tails[b], heads[b], n_edges[b], aligned[b], acount[b], begin[b], end[b],
                      use_full[b], n_nodes[b], rng.permutation(tails.shape[1]))
        _eq(got, keep[b])


def test_warp_model_of_g5_equals_the_plain_machine(built):
    """The model of the kernel's grouping and traversal, the scatter in a
    seeded random order (the result is a set, whatever the order), against
    the plain fixpoint on random spans."""
    rng = np.random.default_rng(40)
    for seed in range(4):
        _g5_model_equals_plain(_subgraph_inputs(built, 20 + seed), rng)


def test_warp_model_of_g5_groups_cut_windows_alike(built):
    """The same on cuts past the middle of the backbones, where the grouping
    drops most edges, with use_full and end < begin windows."""
    rng = np.random.default_rng(42)
    for seed in range(2):
        _g5_model_equals_plain(_reach_cuts(built, 24 + seed), rng)


def _g4_case(built, case, labels):
    """The walk's inputs of a model case: random streams that fit, whose
    nodes pass N, whose edges pass E = 120; duplicate (tail, head) edges
    walked (`graph_build_cases.with_duplicate_edges`); appends at the E - 1
    clamp (`graph_build_cases.at_the_edge_cap`)."""
    caps = dict(fits=(False, E), nodes=(True, E), edges=(False, 120)).get(case, (False, E))
    args = _fuse_inputs(built, 30, labels, *caps)
    if case == "dups":
        args, changed = with_duplicate_edges(args)
        assert len(changed) >= 4
    elif case == "clamp":
        args = at_the_edge_cap(args)
    return args


@pytest.mark.parametrize("caps", ["fits", "nodes", "edges", "dups", "clamp"])
@pytest.mark.parametrize("labels", [False, True], ids=["plain", "labels"])
def test_warp_model_of_g4_equals_the_plain_walk(built, caps, labels):
    """Every window, flagged ones included: the model and the plain walk
    agree word for word, the out-edge lists pushed in a seeded random order
    (the kernel's pushes land in no fixed order)."""
    args = _g4_case(built, caps, labels)
    got = tgb.fuse_walk(*map(torch.from_numpy, args))
    rng = np.random.default_rng(41)
    B = len(args[4])
    for b in range(B):
        g = [a[b] for a in args]
        model = G4Warp(*g[:8], g[10], g[11], rng.permutation(len(g[1])),
                       labels=g[14:16] if labels else None,
                       bits=(int(g[16]), int(g[17])) if labels else (0, 0))
        model.walk(g[8], g[9], int(g[12]), bool(g[13]))
        th = np.array(model.th)
        want = [model.codes, th[:, 0], th[:, 1], model.weights, model.n_nodes, model.n_edges,
                model.aligned, model.acount, model.ovf]
        for k, w in enumerate(want):
            _eq(w, got[k][b])
        if labels:
            _eq(model.lab[0], got[9][b])
            _eq(model.lab[1], got[10][b])
    ovf = _np(got[8])
    if caps == "clamp":
        assert (ovf[:4] & tgb.OVF_E_CAP).all()
    if caps == "dups":
        assert not ovf.any()


# ------------------------------------------------------------ the pipeline


@pytest.fixture(scope="module", params=[False, True], ids=["fasta", "fastq"])
def pipeline(request):
    """The four windows of tests/test_torch_graph_cycle.py's pipeline, and
    the JAX package's host path on them."""
    spec = _pipeline_windows(request.param)
    return spec, request.param, _jax_host(spec, request.param)


def _port_pipeline(spec, fastq, monkeypatch, scores=(3, -5, -4), cycle=False):
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline import windows as tw

    monkeypatch.setenv("VECHAT_DEVICE_BUILD", "1")
    if cycle:
        monkeypatch.setenv("VECHAT_DEVICE_CYCLE", "1")
    wins = _windows_of(tw, spec, fastq)
    be = TorchAlignerBackend(*scores, device="cpu")
    tw.generate_consensus_haplotype(wins, be, 0.2, 0.2, 3)
    return [(list(w.consensus_codes), w.polished) for w in wins], be


def _routes(c):
    return {k[11:]: v for k, v in c.items() if k.startswith("build_host_") and v}


def test_full_pipeline_device_build_equals_the_jax_host_path(pipeline, monkeypatch):
    """`generate_consensus_haplotype` with VECHAT_DEVICE_BUILD=1 and the
    torch backend on the CPU: every window built and pruned by the device
    programs, byte for byte the JAX package's host path."""
    spec, fastq, want = pipeline
    got, be = _port_pipeline(spec, fastq, monkeypatch)
    assert got == want
    c = be.counters()
    assert c["n_build_windows"] == 4 and c["n_build_host"] == 0 and c["n_build_dispatches"] == 1
    assert c["build_layer_steps"] >= 5 and c["n_cycle_windows"] == 0 and not _routes(c)
    assert c["cycle_cc_rounds"] > 0


def test_full_pipeline_routes_flagged_windows_to_the_host(pipeline, monkeypatch):
    """Build bits on three windows (nodes, edges and a predecessor distance;
    rings and in-slots), cycle bits on the fourth: all four take the host
    build, then the device cycle (the last three flagged there too, so
    they take the host cycle), counted by reason; the output does not
    change."""
    from vechat_tpu_torch.pipeline import device_cycle

    spec, fastq, want = pipeline
    real_build, real_cycle = device_cycle.device_build, device_cycle.haplotype_cycle
    calls = []

    def flag_build(*args, **kw):
        out = real_build(*args, **kw)
        bits = torch.tensor([tgb.OVF_N_CAP | tgb.OVF_E_CAP, tgb.OVF_RING,
                             tgb.OVF_R_CAP | tgb.OVF_P_CAP, 0], dtype=torch.int32)
        out["overflow_bits"] = out["overflow_bits"] | bits[: len(out["overflow_bits"])]
        out["overflow"] = out["overflow_bits"] != 0
        return out

    def flag_cycle(*args, **kw):
        calls.append(len(args[0]))
        corrected, out_len, overflow, n_sub = real_cycle(*args, **kw)
        bits = torch.tensor([0, tgc.OVF_A_CAP, tgc.OVF_NEW_EDGES, tgc.OVF_RING][-len(overflow):])
        return corrected, out_len, overflow | bits, n_sub

    monkeypatch.setattr(device_cycle, "device_build", flag_build)
    monkeypatch.setattr(device_cycle, "haplotype_cycle", flag_cycle)
    got, be = _port_pipeline(spec, fastq, monkeypatch, cycle=True)
    assert got == want and calls == [4, 4]
    c = be.counters()
    assert c["n_build_windows"] == 0 and c["n_build_host"] == 4
    assert _routes(c) == dict(n_cap=1, e_cap=1, ring=1, r_cap=1, p_cap=1, cycle_ring=1)
    assert c["n_cycle_windows"] == 1 and c["n_cycle_host"] == 3


def test_full_pipeline_ladder_and_int16_route_to_the_host(pipeline, monkeypatch):
    """Windows past the node ladder, or in a bucket whose scores leave int16,
    never reach the device programs: counted, and the output does not
    change."""
    from vechat_tpu_torch.pipeline import device_cycle

    spec, fastq, want = pipeline
    monkeypatch.setattr(device_cycle, "N_LADDER", (16,))
    got, be = _port_pipeline(spec, fastq, monkeypatch)
    assert got == want and _routes(be.counters()) == dict(ladder=4)
    monkeypatch.undo()
    scores = (60, -60, -60)
    got, be = _port_pipeline(spec, fastq, monkeypatch, scores)
    assert got == _jax_host(spec, fastq, scores)
    assert _routes(be.counters()) == dict(int16=4) and be.counters()["n_build_dispatches"] == 0


def test_host_backend_ignores_the_switch(monkeypatch):
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline.device_cycle import use_device_build
    from vechat_tpu_torch.pipeline.windows import HostAlignerBackend

    monkeypatch.delenv("VECHAT_DEVICE_BUILD", raising=False)
    assert not use_device_build(TorchAlignerBackend(3, -5, -4, device="cpu"))
    monkeypatch.setenv("VECHAT_DEVICE_BUILD", "1")
    assert use_device_build(TorchAlignerBackend(3, -5, -4, device="cpu"))
    assert not use_device_build(HostAlignerBackend(3, -5, -4))
    monkeypatch.setenv("VECHAT_DEVICE_BUILD", "off")
    assert not use_device_build(TorchAlignerBackend(3, -5, -4, device="cpu"))
