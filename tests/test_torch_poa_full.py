"""The port's B10 (`vechat_tpu_torch/ops/kernels/poa_full.py`) on the CPU:
its plain version against the JAX package's `poa_align_batch_device` on the
same numpy inputs, `FullAlignerBackend` against `JaxAlignerBackend`, a
polisher run through `make_backend("full", ..., device="cpu")` against the
host backend, and numpy models of the kernels' layouts: F1's block
(`f1_block`: k columns a thread, the ring of recent rows in shared memory
with its barrier rule, the best cell kept per thread and reduced) against
the plain DP, the plain best cell and the JAX package, and F2's warp
(`f2_warp`: the walk from F1's best cell, each step's choice by ballots,
the next h taken from the chosen lane) against the plain walk. Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vechat_tpu.ops.encode import encode as jax_encode
from vechat_tpu.ops.graph_align import LinearAligner as JaxLinearAligner
from vechat_tpu.ops.kernels.poa_jax import JaxAlignerBackend, poa_align_batch_device
from vechat_tpu.ops.poagraph import PoaGraph as JaxPoaGraph
from vechat_tpu_torch.cli.racon_main import make_backend
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import LinearAligner
from vechat_tpu_torch.ops.kernels import poa_full as pf
from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
from vechat_tpu_torch.ops.poagraph import PoaGraph


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, seq, rate=0.1):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate * 0.5:
            out.append(rng.choice([b for b in "ACGT" if b != c]))
        elif r < rate * 0.7:
            continue
        elif r < rate:
            out.append(c)
            out.append(rng.choice(list("ACGT")))
        else:
            out.append(c)
    return "".join(out)


def build_graph(seqs, graph_cls=PoaGraph, aligner_cls=LinearAligner, enc=encode):
    eng = aligner_cls("nw", 5, -4, -8)
    gr = graph_cls()
    for s in seqs:
        codes = enc(s)
        aln = eng.align(codes, gr) if gr.num_nodes() else []
        gr.add_alignment(aln, codes, np.ones(len(codes), dtype=np.uint32))
    return gr


def batch_inputs(seed, B, N, P, S, depth=4):
    """B window graphs of mixed sizes (each within N nodes and P in-edges)
    packed by the port's `graph_to_dense`, and a query each: the seven
    numpy inputs of B10."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((B, N), np.uint8)
    preds = np.zeros((B, N, P), np.int32)
    nid = np.zeros((B, N), np.int32)
    sink = np.ones((B, N), bool)
    nn = np.ones(B, np.int32)
    seq = np.full((B, S), 0xFF, np.uint8)
    sl = np.ones(B, np.int32)
    b = 0
    while b < B:
        base = rand_seq(rng, int(rng.integers(8, min(N, S) * 2 // 3)))
        d = graph_to_dense(build_graph([mutate(rng, base) for _ in range(depth)]), N, P)
        if d is None:
            continue
        codes[b], preds[b], nid[b], sink[b], nn[b] = (d["codes"], d["preds"], d["node_id"],
                                                      d["is_sink"], d["n_nodes"])
        q = encode(mutate(rng, base, 0.15))[:S]
        seq[b, : len(q)] = q
        sl[b] = len(q)
        b += 1
    return codes, preds, nid, sink, nn, seq, sl


def jax_b10(arrs, mode, m=3, x=-5, g=-4):
    out = poa_align_batch_device(*[jnp.asarray(a) for a in arrs], align_type=mode, m=m, x=x, g=g)
    return [np.asarray(a) for a in out]


def port_b10(arrs, mode, m=3, x=-5, g=-4):
    out = pf.poa_align_batch_full(*arrs, mode, m, x, g, device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.int32 for t in out)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("mode", ["nw", "ov", "sw"])
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("seed", range(3))
def test_plain_b10_equals_jax(mode, P, seed):
    arrs = batch_inputs(seed, B=6, N=64, P=P, S=63)
    assert len(set(arrs[4].tolist())) > 1  # mixed node counts
    for name, a, b in zip(("pairs", "count", "score"), port_b10(arrs, mode), jax_b10(arrs, mode)):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("mode", ["nw", "ov", "sw"])
def test_plain_b10_equals_jax_at_other_scores(mode):
    arrs = batch_inputs(7, B=4, N=64, P=4, S=63)
    for a, b in zip(port_b10(arrs, mode, 5, -4, -8), jax_b10(arrs, mode, 5, -4, -8)):
        np.testing.assert_array_equal(a, b)


def test_plain_b10_sw_without_a_positive_cell():
    """A query that matches no node: every sw cell is 0, so the best score
    is 0, both indices 0, no pairs; the score is returned as computed."""
    arrs = list(batch_inputs(3, B=3, N=64, P=4, S=63))
    d = graph_to_dense(build_graph(["AAAAAAAAAA", "AAAAAAAAA"]), 64, 4)
    arrs[0][1], arrs[1][1], arrs[2][1], arrs[3][1], arrs[4][1] = (
        d["codes"], d["preds"], d["node_id"], d["is_sink"], d["n_nodes"])
    arrs[5][1] = 0xFF
    arrs[5][1, :12] = encode("CCCCCCCCCCCC")
    arrs[6][1] = 12
    got, want = port_b10(arrs, "sw"), jax_b10(arrs, "sw")
    assert want[1][1] == 0 and want[2][1] == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_plain_b10_matches_the_host_aligners():
    """One window a mode against the port's host LinearAligner (the oracle
    of both packages): the alignment and its score."""
    rng = np.random.default_rng(5)
    base = rand_seq(rng, 40)
    graph = build_graph([mutate(rng, base) for _ in range(3)])
    d = graph_to_dense(graph, 64, 4)
    q = encode(mutate(rng, base))
    seq = np.full((1, 63), 0xFF, np.uint8)
    seq[0, : len(q)] = q
    for mode in ("nw", "ov", "sw"):
        pairs, count, score = port_b10(
            (d["codes"][None], d["preds"][None], d["node_id"][None], d["is_sink"][None],
             np.array([d["n_nodes"]], np.int32), seq, np.array([len(q)], np.int32)), mode)
        want, wscore = LinearAligner(mode, 3, -5, -4).align(q, graph, return_score=True)
        c = int(count[0])
        assert [tuple(r) for r in pairs[0, pairs.shape[1] - c :].tolist()] == want
        assert int(score[0]) == wscore


def test_wrappers_default_to_the_card_and_check_shapes(monkeypatch):
    arrs = batch_inputs(0, B=2, N=64, P=4, S=63)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pf.poa_align_batch_full(*arrs, "nw", 3, -5, -4)
    with pytest.raises(RuntimeError, match="CUDA"):
        pf.FullAlignerBackend(3, -5, -4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("full", 3, -5, -4)
    with pytest.raises(ValueError):
        pf.poa_align_batch_full(*arrs, "xx", 3, -5, -4, device="cpu")
    with pytest.raises(ValueError):
        pf.poa_align_batch_full(arrs[0][:1], *arrs[1:], "nw", 3, -5, -4, device="cpu")


# ----------------------------------------------------------------- backend


def backend_items(seed):
    """(port items, JAX items): the same sequences and graphs built by each
    package, in nw and sw, with an empty query, a query past the top
    sequence bucket (767) and graphs of several node buckets."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for n, k, mode in ((30, 3, "nw"), (90, 4, "sw"), (150, 3, "nw"), (40, 2, "sw"),
                       (30, 3, "nw")):
        base = rand_seq(rng, n)
        layers = [mutate(rng, base) for _ in range(k)]
        gp = build_graph(layers)
        gj = build_graph(layers, JaxPoaGraph, JaxLinearAligner, jax_encode)
        for _ in range(2):
            q = mutate(rng, base)
            port.append((encode(q), gp, mode))
            ref.append((jax_encode(q), gj, mode))
    long_q = rand_seq(rng, 800)
    port.append((encode(long_q), port[0][1], "nw"))
    ref.append((jax_encode(long_q), ref[0][1], "nw"))
    port.append((np.array([], np.uint8), port[2][1], "sw"))
    ref.append((np.array([], np.uint8), ref[2][1], "sw"))
    return port, ref


@pytest.mark.parametrize("seed", range(2))
def test_backend_equals_jax_backend(seed):
    port_items, ref_items = backend_items(seed)
    be = pf.FullAlignerBackend(3, -5, -4, device="cpu")
    ref = JaxAlignerBackend(3, -5, -4)
    got = be.align_batch(port_items)
    want = ref.align_batch(ref_items)
    assert got == want
    assert be.fallbacks == ref.fallbacks == 1
    assert be.device_alignments == ref.device_alignments == len(port_items) - 2
    assert be.cell_updates == ref.cell_updates
    assert got[-1] == []
    c = be.counters()
    assert c["fallbacks"] == 1 and c["n_dispatches"] >= 3


def test_backend_splits_groups_by_cells_per_call(monkeypatch):
    """A group past MAX_CELLS_PER_CALL goes in several dispatches, with the
    same alignments."""
    port_items, _ = backend_items(0)
    whole = pf.FullAlignerBackend(3, -5, -4, device="cpu")
    want = whole.align_batch(port_items)
    monkeypatch.setattr(pf, "MAX_CELLS_PER_CALL", 64 * 65)
    cut = pf.FullAlignerBackend(3, -5, -4, device="cpu")
    assert cut.align_batch(port_items) == want
    assert cut.n_dispatches > whole.n_dispatches


def test_make_backend_full_on_cpu():
    be = make_backend("full", 3, -5, -4, device="cpu")
    assert isinstance(be, pf.FullAlignerBackend)
    assert be.device == torch.device("cpu")
    assert be.supports_graph_cycle
    assert not hasattr(be, "edit_align_batch")


def test_polisher_through_full_backend_equals_host():
    """The inputs of tests/test_poa_jax.py::test_end_to_end_with_jax_backend,
    through the port's Polisher: the full backend's reads equal the host
    backend's, and B10 ran."""
    from vechat_tpu_torch.io.fastx import SeqRecord
    from vechat_tpu_torch.io.paf import PafRecord
    from vechat_tpu_torch.pipeline.polisher import Polisher

    rng = np.random.default_rng(21)
    truth = rand_seq(rng, 400)
    reads = []
    for i in range(8):
        d = mutate(rng, truth, 0.08)
        reads.append(SeqRecord(f"r{i}", d, "I" * len(d)))
    overlaps = [
        PafRecord(q_name=q.name, q_length=len(q.data), q_begin=0, q_end=len(q.data),
                  strand=False, t_name=reads[0].name, t_length=len(reads[0].data), t_begin=0,
                  t_end=len(reads[0].data), num_matches=300, alignment_length=400, mapq=60)
        for q in reads[1:]
    ]

    def run(backend):
        p = Polisher(polisher_type="f", haplotype=True, min_confidence=0.2, min_support=0.2,
                     backend=backend)
        p.initialize(reads, reads, overlaps)
        return p.polish()

    host_out = run(make_backend("host", 3, -5, -4))
    full = make_backend("full", 3, -5, -4, device="cpu")
    full_out = run(full)
    assert full.device_alignments > 0
    assert [(r.name, r.data) for r in full_out] == [(r.name, r.data) for r in host_out]


# ------------------------------------------------------- F2's warp, in numpy


def f2_choice(diag_ok, vert_ok, horiz_ok):
    """F2's pick from its lanes' tests: a ballot of the diagonal slots, then
    of the vertical ones (`__ffs` of each), then lane 0's horizontal test;
    with no bit set, diagonal slot 0. Returns (kind, slot)."""
    bd = sum(1 << s for s, ok in enumerate(diag_ok) if ok)
    bv = sum(1 << s for s, ok in enumerate(vert_ok) if ok)
    if bd:
        return "diag", (bd & -bd).bit_length() - 1
    if bv:
        return "vert", (bv & -bv).bit_length() - 1
    if horiz_ok:
        return "horiz", 0
    return "diag", 0


def argmax_choice(diag_ok, vert_ok, horiz_ok):
    """The reference's pick: argmax over [diag slots, vert slots, horiz]."""
    P = len(diag_ok)
    c = int(np.argmax(np.concatenate([diag_ok, vert_ok, [horiz_ok]]).astype(np.uint8)))
    if c < P:
        return "diag", c
    if c < 2 * P:
        return "vert", c - P
    return "horiz", 0


@pytest.mark.parametrize("P", [1, 4, 8, 16, 32])
def test_f2_ballot_choice_is_the_argmax_choice(P):
    rng = np.random.default_rng(P)
    cases = [(np.zeros(P, bool), np.zeros(P, bool), False)]  # none: diagonal slot 0
    for _ in range(500):
        p = rng.choice([0.0, 0.05, 0.3])
        cases.append((rng.random(P) < p, rng.random(P) < p, bool(rng.random() < 0.5)))
    for c in cases:
        assert f2_choice(*c) == argmax_choice(*c)


class RingFault(AssertionError):
    """A read that F1's barrier rule does not allow: a ring slot holding
    another row, or a row stored less than one barrier ago."""


def f1_block(codes, preds, sink, nn, seq, sl, mode, m, x, g, k, R, ring_reach=None,
             before_from_ring=False):
    """F1 on one window as its block runs it: threads of k columns (W / k
    rounded up to a warp), the in-slots staged with each row's distinct
    ones first, a ring of R rows in shared memory. Row n + 1 takes each
    predecessor row p from the registers (p == n), from nothing (p == 0),
    from ring slot p % R if n - p < `ring_reach` (R, as the kernel), or
    else from global memory (`before_from_ring` takes p == n from the
    ring too, a fault); then a thread's serial scan, the warp's shuffle
    scan of thread totals, the barrier, the carry from the totals of the
    warps to the left; after the barrier the row is stored to global
    memory and to ring slot (n + 1) % R. A stored row is readable only
    after the next barrier; a read of a slot that holds another row, or of
    a row not yet readable, and a store into a slot read in the same
    barrier interval (by a thread that may not have read it yet) raise
    RingFault. Each thread keeps the first row where the largest of its
    cells of the mode's cells rose, and at the end finds that row's first
    column at the value (its first strict maximum in flat order); the warps
    reduce by xor butterflies to the largest value at the lowest flat
    index, then thread 0 over the warps. Returns (H [N + 1, S + 1], int64,
    -2^62 where F1 writes nothing; best (score, flat index; -1 for an sw
    window with no positive cell); reads served by the ring; reads from
    global)."""
    N, P = preds.shape
    S = len(seq)
    W = S + 1
    T = -(-W // (32 * k)) * 32
    cols = T * k
    reach = R if ring_reach is None else ring_reach
    UNSET = -(2**62)
    NEG = pf.NEG
    c = np.arange(cols)
    c0 = np.arange(T) * k
    lane, warp = np.arange(T) % 32, np.arange(T) // 32
    live = c <= sl
    jg = c * g
    sq = np.where((c >= 1) & live, np.concatenate([[0], seq.astype(np.int64)])[np.minimum(c, S)],
                  -1)
    scan = (c == sl) if mode == "nw" else ((c >= 1) & live)

    rows = []  # staging: clamped slots, distinct first
    for r in range(nn):
        ps = [min(max(int(p), 0), N) for p in preds[r]]
        rows.append([ps[0]] + [p for p in ps[1:] if p != ps[0]])
    H = np.full((N + 1, W), UNSET, np.int64)
    stamp = np.full(N + 1, -1)  # the barrier count at which a global row was stored
    ring_row = np.full(R, -1)
    ring_stamp = np.full(R, -1)
    ring_read = np.full(R, -1)  # the barrier interval of the slot's last read
    ring = np.zeros((R, cols), np.int64)
    barrier = 1  # after the staging

    def ring_get(p, n):
        slot = p % R
        if ring_row[slot] != p:
            raise RingFault(f"row {n + 1} reads row {p} from slot {slot}, which holds "
                            f"row {ring_row[slot]}")
        if ring_stamp[slot] >= barrier:
            raise RingFault(f"row {n + 1} reads row {p} before a barrier past its store")
        ring_read[slot] = barrier
        v = ring[slot]
        return v, np.where(c0 > 0, v[np.maximum(c0 - 1, 0)], 0)

    cur = np.zeros(cols, np.int64) if mode == "sw" else jg.astype(np.int64)
    left = np.where((c0 == 0) | (mode == "sw"), 0, (c0 - 1) * g).astype(np.int64)
    H[0, : sl + 1] = cur[: sl + 1]
    stamp[0] = 0
    bv = np.full(T, NEG, np.int64)
    brow = np.zeros(T, np.int64)  # the row of each thread's best value
    served = glob = 0
    first = (c % k) == 0
    for n in range(nn):
        prof = np.where(sq == codes[n], m, x)
        cand = np.full(cols, np.iinfo(np.int64).min // 4, np.int64)
        for p in rows[n]:
            if p == n and not before_from_ring:
                v, lf = cur, left
            elif p == 0:
                v = np.zeros(cols, np.int64) if mode == "sw" else jg.astype(np.int64)
                lf = np.where(mode == "sw", 0, (c0 - 1) * g)
            elif n - p < reach:
                served += 1
                v, lf = ring_get(p, n)
            else:
                if stamp[p] < 0 or stamp[p] >= barrier:
                    raise RingFault(f"row {n + 1} reads row {p} from global memory too early")
                glob += 1
                v = np.zeros(cols, np.int64)
                v[: sl + 1] = H[p, : sl + 1]
                lf = np.where(c0 > 0, H[p, np.maximum(c0 - 1, 0)], 0)
            a = np.where(first, np.repeat(lf, k), np.concatenate([[0], v[:-1]]))
            cand = np.maximum(cand, np.where(c > 0, np.maximum(a + prof, v + g), v))
        full = np.where(c > 0, cand, cand + g if mode == "nw" else 0)
        t = np.where(live, full - jg, NEG).reshape(T, k)
        t = np.maximum.accumulate(t, axis=1)  # a thread's serial scan
        tot = t[:, -1].copy()
        for o in (1, 2, 4, 8, 16):  # __shfl_up_sync steps within each warp
            up = np.concatenate([tot[:o], tot[:-o]])
            tot = np.where(lane >= o, np.maximum(tot, up), tot)
        totals = tot[lane == 31]  # published, read after the barrier
        pre = np.where(lane == 0, NEG, np.concatenate([[NEG], tot[:-1]]))
        barrier += 1
        carry = np.array([max([NEG] + list(totals[:w])) for w in range(T // 32)])
        pre = np.maximum(pre, carry[warp])
        cur = (np.maximum(t, pre[:, None]) + jg.reshape(T, k)).reshape(-1)
        left = pre + (c0 - 1) * g
        if mode == "sw":
            cur = np.maximum(cur, 0)
            left = np.maximum(left, 0)
        slot = (n + 1) % R
        if ring_read[slot] == barrier:
            raise RingFault(f"row {n + 1} is stored into slot {slot}, read in the same interval")
        ring[slot], ring_row[slot], ring_stamp[slot] = cur, n + 1, barrier
        H[n + 1, : sl + 1] = cur[: sl + 1]
        stamp[n + 1] = barrier
        if mode == "sw" or sink[n]:  # each thread's largest cell of the row
            mx = np.where(scan, cur, NEG).reshape(T, k).max(axis=1)
            up = mx > bv
            bv, brow = np.where(up, mx, bv), np.where(up, n, brow)
    bi = np.zeros(T, np.int64)
    for t_ in np.nonzero(bv > NEG)[0]:  # its first column at that value, read back from H
        cc = [cl for cl in range(c0[t_], c0[t_] + k) if scan[cl] and H[brow[t_] + 1, cl] == bv[t_]]
        bi[t_] = brow[t_] if mode == "nw" else brow[t_] * S + cc[0] - 1
    for o in (16, 8, 4, 2, 1):  # the warps' xor butterflies
        partner = (lane ^ o) + warp * 32
        ov, oi = bv[partner], bi[partner]
        take = (ov > bv) | ((ov == bv) & (oi < bi))
        bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
    best_v, best_i = int(bv[0]), int(bi[0])
    for w in range(1, T // 32):  # thread 0 over the warps' lane 0s
        v, i = int(bv[32 * w]), int(bi[32 * w])
        if v > best_v or (v == best_v and i < best_i):
            best_v, best_i = v, i
    if mode == "sw" and best_v <= 0:
        best_i = -1
    return H, (best_v, best_i), served, glob


def f2_warp(H, best, codes, preds, nid, nn, seq, sl, mode, m, x, g):
    """F2 on one window as its warp runs it, from F1's best (score, flat
    index): at each step lane s < P reads slot s of the node (staged) and
    loads its two cells, every lane the horizontal cell; the choice by
    `f2_choice` from the lanes' tests, and the next h the chosen lane's
    loaded cell (checked against H), not a reload."""
    N, P = preds.shape
    S = len(seq)
    L = N + S + 1
    val, idx = best
    if mode == "nw":
        mi, mj = idx + 1, sl
    elif idx < 0:
        mi = mj = 0
    else:
        mi, mj = idx // S + 1, idx % S + 1
    pairs = np.full((L, 2), -2, np.int64)
    if mi == 0 and mj == 0:
        return pairs, 0, val

    def alive(i, j, h):
        if mode == "sw":
            return h != 0
        if mode == "nw":
            return not (i == 0 and j == 0)
        return not (i == 0 or j == 0)

    i, j, k = mi, mj, 0
    h = H[i, j]
    while alive(i, j, h):
        node, jm1 = max(i - 1, 0), max(j - 1, 0)
        mc = m if seq[jm1] == codes[node] else x
        p = [min(max(int(q), 0), N) for q in preds[node]]
        dv = [H[q, jm1] for q in p]  # lane s's loads
        vv = [H[q, j] for q in p]
        hz = H[i, jm1]
        diag = [i != 0 and j != 0 and h == dv[s] + mc for s in range(P)]
        vert = [i != 0 and h == vv[s] + g for s in range(P)]
        kind, slot = f2_choice(diag, vert, j != 0 and h == hz + g)
        pi = p[slot] if kind != "horiz" else i
        pj = j if kind == "vert" else j - 1
        nh = vv[slot] if kind == "vert" else hz if kind == "horiz" else dv[slot]
        pairs[L - 1 - k] = (-1 if pi == i else nid[node], -1 if pj == j else j - 1)
        i, j, k = pi, max(pj, 0), k + 1
        assert nh == H[i, j], "the chosen lane's cell is the next step's h"
        h = nh
    return pairs, k, val


def model_b10(arrs, mode, k, R, m=3, x=-5, g=-4):
    """B10 through the two models, window by window: (pairs, count, score)
    as the JAX function returns them, F1's H and best, and the ring's and
    global memory's reads."""
    codes, preds, nid, sink, nn, seq, sl = arrs
    B, N, P = preds.shape
    S = seq.shape[1]
    out = [np.full((B, N + S + 1, 2), -2, np.int64), np.zeros(B, np.int64),
           np.zeros(B, np.int64)]
    Hs, bests, served, glob = [], [], 0, 0
    for b in range(B):
        H, best, sv, gl = f1_block(codes[b], preds[b], sink[b], int(nn[b]), seq[b], int(sl[b]),
                                   mode, m, x, g, k, R)
        served, glob = served + sv, glob + gl
        pairs, cnt, score = f2_warp(H, best, codes[b], preds[b], nid[b], int(nn[b]), seq[b],
                                    int(sl[b]), mode, m, x, g)
        out[0][b], out[1][b], out[2][b] = pairs, cnt, score
        Hs.append(H)
        bests.append(best)
    return out, Hs, np.array(bests), served, glob


def check_f1_model(arrs, mode, k, R, m=3, x=-5, g=-4):
    """The models against the plain DP and best cell (exact, on every cell
    F1 writes) and against the JAX package's outputs. Returns (ring reads,
    global reads)."""
    codes, preds, nid, sink, nn, seq, sl = arrs
    out, Hs, bests, served, glob = model_b10(arrs, mode, k, R, m, x, g)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    Hp = pf._dp_full_plain(t[0], t[1], t[4], t[5], t[6], mode, m, x, g).numpy()
    bp = pf._best_packed_plain(torch.from_numpy(Hp), t[3], t[4], t[6], mode).numpy()
    for b in range(len(nn)):
        w = Hs[b] != -(2**62)
        assert w.sum() == (nn[b] + 1) * (sl[b] + 1)
        np.testing.assert_array_equal(Hs[b][w], Hp[b][w])
    np.testing.assert_array_equal(bests, bp)
    for name, a, b in zip(("pairs", "count", "score"), out, jax_b10(arrs, mode, m, x, g)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    return served, glob


def max_pred_distance(preds, nn):
    return max(n + 1 - int(p) for n in range(nn) for p in preds[n])


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mode", ["nw", "ov", "sw"])
def test_f1_block_model_equals_plain_and_jax(mode, k):
    """k columns a thread at S = 100 (not a multiple of 32k: 4, 2 and 1
    warps), the default ring: every read of the graphs is served by
    registers or ring."""
    arrs = batch_inputs(12, B=3, N=64, P=4, S=100)
    served, glob = check_f1_model(arrs, mode, k, pf.RING)
    assert served > 0 and glob == 0


@pytest.mark.parametrize("R", [1, 2, 4])
def test_f1_block_model_past_the_ring(R):
    """A ring smaller than the largest predecessor distance: those reads go
    to global memory, in every mode, with the same results."""
    arrs = batch_inputs(13, B=3, N=64, P=8, S=63, depth=6)
    far = max(max_pred_distance(arrs[1][b], arrs[4][b]) for b in range(3))
    assert far > R
    for mode in ("nw", "ov", "sw"):
        _, glob = check_f1_model(arrs, mode, 2, R)
        assert glob > 0


def test_f1_block_model_p16():
    arrs = batch_inputs(14, B=2, N=128, P=16, S=127, depth=8)
    for mode in ("nw", "ov", "sw"):
        check_f1_model(arrs, mode, 4, pf.RING)


def tie_inputs():
    """Chains of As against reads of As: sw's and ov's best value recurs
    along a row over many columns and threads (and, at k = 1, warps)."""
    B, N, P, S = 3, 64, 4, 127
    preds = np.tile(np.arange(N, dtype=np.int32)[None, :, None], (B, 1, P))
    return (np.zeros((B, N), np.uint8), preds, np.tile(np.arange(N, dtype=np.int32), (B, 1)),
            np.ones((B, N), bool), np.array([N, 40, 20], np.int32), np.zeros((B, S), np.uint8),
            np.array([S, 100, 90], np.int32))


@pytest.mark.parametrize("k", [1, 4])
def test_f1_block_model_ties_across_threads_and_warps(k):
    arrs = tie_inputs()
    for mode in ("nw", "ov", "sw"):
        check_f1_model(arrs, mode, k, pf.RING)
    codes, preds, _, sink, _, seq, _ = arrs
    H, best, _, _ = f1_block(codes[1], preds[1], sink[1], 40, seq[1], 100, "sw", 3, -5, -4, k,
                             pf.RING)
    tied = np.argwhere(H[1:, 1:] == best[0])
    warps = {(c + 1) // (32 * k) for _, c in tied}
    assert len(tied) > 32 and len(warps) > (2 if k == 1 else 0)
    assert best[1] == tied[0][0] * 127 + tied[0][1]


def test_f1_block_model_sw_without_a_positive_cell():
    arrs = list(batch_inputs(15, B=2, N=64, P=4, S=63))
    arrs[0][:] = 0
    arrs[5][:] = 0xFF
    arrs[5][:, :30] = 1
    arrs[6][:] = 30
    served, _ = check_f1_model(arrs, "sw", 2, pf.RING)
    _, _, bests, _, _ = model_b10(arrs, "sw", 2, pf.RING)
    assert bests.tolist() == [[0, -1], [0, -1]]


def test_f1_block_model_ov_with_sinkless_rows():
    """ov keeps only the sink rows' cells: natural graphs (a few sinks),
    one window whose only sink is its first row, and one with no sink
    among its real rows (the reference's argmax then gives cell (1, 1) at
    -2^30)."""
    arrs = list(batch_inputs(16, B=3, N=64, P=4, S=63))
    arrs[3] = arrs[3].copy()
    arrs[3][1] = False
    arrs[3][1, 0] = True
    arrs[3][2] = False
    check_f1_model(arrs, "ov", 4, pf.RING)
    _, _, bests, _, _ = model_b10(arrs, "ov", 4, pf.RING)
    assert bests[2].tolist() == [pf.NEG, 0]


@pytest.mark.parametrize("fault", ["reach past the ring", "the row before from the ring"])
def test_f1_block_model_catches_a_ring_fault(fault):
    """The model's barrier rule is not vacuous: a ring read one row past
    R finds its slot overwritten, and the row before read from the ring is
    not yet readable."""
    codes, preds, nid, sink, nn, seq, sl = batch_inputs(13, B=1, N=64, P=8, S=63, depth=6)
    R = 2
    assert max_pred_distance(preds[0], nn[0]) > R + 1
    past = fault == "reach past the ring"
    with pytest.raises(RingFault):
        f1_block(codes[0], preds[0], sink[0], int(nn[0]), seq[0], int(sl[0]), "nw", 3, -5, -4,
                 2, R, ring_reach=R + 1 if past else R, before_from_ring=not past)


@pytest.mark.parametrize("mode", ["nw", "ov", "sw"])
def test_f2_warp_model_equals_the_plain_walk(mode):
    arrs = batch_inputs(11, B=4, N=64, P=4, S=63)
    codes, preds, nid, sink, nn, seq, sl = arrs
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    H = pf._dp_full_plain(t[0], t[1], t[4], t[5], t[6], mode, 3, -5, -4)
    pairs, count, score = pf._walk_full_plain(H, *t[:4], t[4], t[5], t[6], mode, 3, -5, -4)
    for b in range(len(nn)):
        _, best, _, _ = f1_block(codes[b], preds[b], sink[b], int(nn[b]), seq[b], int(sl[b]),
                                 mode, 3, -5, -4, pf.f1_columns(63), pf.RING)
        mp, mc, ms = f2_warp(H[b].numpy(), best, codes[b], preds[b], nid[b], int(nn[b]), seq[b],
                             int(sl[b]), mode, 3, -5, -4)
        np.testing.assert_array_equal(mp, pairs[b].numpy())
        assert (mc, ms) == (int(count[b]), int(score[b]))
