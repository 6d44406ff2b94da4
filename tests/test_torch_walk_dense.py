"""The dense traceback walk of the port (plain PyTorch version on the CPU)
against the JAX package's `_traceback_walk` behind `poa_align_pallas(...,
emit_rle=False)` in interpret mode, against the port's run-length walk
expanded, and against the host oracle. Whole pair buffers, the -2 padding
included, counts and scores are compared exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vechat_tpu.ops.kernels import poa_pallas as jpp
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import LinearAligner
from vechat_tpu_torch.ops.kernels import poa_linear as tpl
from vechat_tpu_torch.ops.kernels.backend import pack_windows
from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
from vechat_tpu_torch.ops.poagraph import PoaGraph

N, P, W = 64, 4, 64
SCORES = (3, -5, -4)


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, seq, rate=0.15):
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


def build_graph(seqs):
    eng = LinearAligner("nw", *SCORES)
    gr = PoaGraph()
    for s in seqs:
        codes = encode(s)
        aln = eng.align(codes, gr) if gr.num_nodes() else []
        gr.add_alignment(aln, codes, np.ones(len(codes), dtype=np.uint32))
    return gr


def pack(graphs, seq_lists):
    """The seven JAX-layout arrays of `graphs` with their sequences."""
    dense = [graph_to_dense(g, N, P) for g in graphs]
    assert all(d is not None for d in dense)
    return pack_windows(list(zip(dense, seq_lists)), N, P, W)


def both_dense(arrs, mode, node_ids, ring=0):
    """(pn, pp, count, score) of the JAX package and of the port, numpy."""
    codes, preds, sink, nid, nn, seqp, slen = arrs
    m, x, g = SCORES
    want = jpp.poa_align_pallas(
        *[jnp.asarray(a) for a in arrs], align_type=mode, m=m, x=x, g=g,
        interpret=True, ring=ring, emit_rle=False, emit_node_ids=node_ids,
    )
    got = tpl.poa_align(
        codes, preds, sink, nn, seqp, slen, mode, m, x, g, ring=ring, device="cpu",
        emit_rle=False, emit_node_ids=node_ids, node_id=nid if node_ids else None,
    )
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def assert_same(want, got):
    for name, a, b in zip(("pn", "pp", "count", "score"), want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def alignments(pn, pp, count, nid, seq_lists, ranks):
    """Front-to-back (node id, position) pairs of every real (b, d)."""
    L = pn.shape[2]
    out = []
    for b, seqs in enumerate(seq_lists):
        for di in range(len(seqs)):
            c = int(count[b, 0, di])
            seg = pn[b, di, L - c:].astype(np.int64)
            if ranks:
                seg = tpl.ranks_to_node_ids_np(seg, nid[b, 0])
            out.append(list(zip(seg.tolist(), pp[b, di, L - c:].tolist())))
    return out


def deep_case(seed, D=3):
    """Two graphs of five noisy copies of one 40-base sequence (in-degrees
    over 1), each with D more noisy copies to align."""
    rng = np.random.default_rng(seed)
    base = rand_seq(rng, 40)
    graphs = []
    while len(graphs) < 2:
        gr = build_graph([mutate(rng, base) for _ in range(5)])
        if graph_to_dense(gr, N, P) is not None:  # within 64 nodes, in-degree 4
            graphs.append(gr)
    seq_lists = [[encode(mutate(rng, base)) for _ in range(D)] for _ in graphs]
    return graphs, seq_lists


@pytest.mark.parametrize("node_ids", [False, True])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_dense_walk_matches_jax_and_host(mode, node_ids):
    graphs, seq_lists = deep_case(["nw", "sw", "ov"].index(mode))
    arrs = pack(graphs, seq_lists)
    preds, nid = arrs[1], arrs[3]
    assert (preds[:, 1:] != preds[:, :1]).any()  # a real in-degree over 1
    want, got = both_dense(arrs, mode, node_ids)
    assert_same(want, got)
    pn, pp, count, score = got
    assert pn.dtype == np.int16 and pn.shape == (2, 3, N + W)
    # everything before a walk's pairs is -2, nothing inside it is
    L = N + W
    for b in range(2):
        for d in range(3):
            c = int(count[b, 0, d])
            assert c > 0
            assert (pn[b, d, : L - c] == -2).all() and (pp[b, d, : L - c] == -2).all()
            assert (pn[b, d, L - c:] >= -1).all() and (pp[b, d, L - c:] >= -1).all()
    host = LinearAligner(mode, *SCORES)
    alns = alignments(pn, pp, count, nid, seq_lists, ranks=not node_ids)
    k = 0
    for b, gr in enumerate(graphs):
        for di, q in enumerate(seq_lists[b]):
            aln, s = host.align(q, gr, return_score=True)
            assert alns[k] == aln and int(score[b, 0, di]) == s
            k += 1


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_dense_walk_chain_graph_with_a_ring(mode):
    """In-degree 1 everywhere (one sequence per graph), a ring shorter than
    the graph, and sequences of unequal length in one slot."""
    rng = np.random.default_rng(7)
    bases = [rand_seq(rng, 50), rand_seq(rng, 33)]
    graphs = [build_graph([b]) for b in bases]
    seq_lists = [[encode(mutate(rng, b)), encode(mutate(rng, b[5:30]))] for b in bases]
    arrs = pack(graphs, seq_lists)
    assert (arrs[1][:, 1:] == arrs[1][:, :1]).all()
    want, got = both_dense(arrs, mode, node_ids=False, ring=8)
    assert_same(want, got)


def test_dense_walk_empty_alignment():
    """A local alignment with no positive cell: count 0, the whole buffer -2.
    The slot's padding sequence (one 'A' against a graph without 'A') too."""
    graphs = [build_graph(["CCCCCCCC"]), build_graph(["ACGTACGT"])]
    seq_lists = [[encode("GGGG")], [encode("ACGTACGT"), encode("CGTA")]]
    arrs = pack(graphs, seq_lists)
    want, got = both_dense(arrs, "sw", node_ids=False)
    assert_same(want, got)
    pn, pp, count, score = got
    assert count[0].tolist() == [[0, 0]] and (pn[0] == -2).all() and (pp[0] == -2).all()
    assert count[1].tolist() == [[8, 4]]


@pytest.mark.parametrize("query", ["CCGTACGT", "GTACGT", "TTACCGTACGT", "ACCGTAC"])
def test_dense_walk_leading_deletion_ends_at_the_origin(query):
    """nw alignments that start by deleting one or three start nodes, by an
    insertion, or end in a deletion. The linear walk has one state, so it
    reaches (0, 0) and stops there in the reference too: JAX, the port and
    the host engine agree (the affine and convex reference walks do not)."""
    gr = build_graph(["ACCGTACGT"])
    q = encode(query)
    arrs = pack([gr], [[q]])
    want, got = both_dense(arrs, "nw", node_ids=True)
    assert_same(want, got)
    aln = alignments(got[0], got[1], got[2], arrs[3], [[q]], ranks=False)[0]
    assert aln == LinearAligner("nw", *SCORES).align(q, gr)
    if query == "CCGTACGT":
        assert aln[0] == (0, -1)  # the start node, deleted


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_dense_pairs_equal_rle_pairs_expanded(mode):
    graphs, seq_lists = deep_case(10 + ["nw", "sw", "ov"].index(mode), D=4)
    codes, preds, sink, nid, nn, seqp, slen = pack(graphs, seq_lists)
    args = (codes, preds, sink, nn, seqp, slen, mode, *SCORES)
    runs, steps, r_count, r_score = tpl.poa_align(*args, device="cpu")
    pn, pp, count, score = tpl.poa_align(*args, device="cpu", emit_rle=False)
    assert torch.equal(count, r_count) and torch.equal(score, r_score)
    runs, pn, pp = runs[:steps].numpy(), pn.numpy(), pp.numpy()
    L, D = pn.shape[2], seqp.shape[1]
    for b in range(len(graphs)):
        for d in range(D):
            c = int(count[b, 0, d])
            rn, rp = tpl.runs_to_pairs_np(runs[:, b * D + d])
            np.testing.assert_array_equal(pn[b, d, L - c:], rn)
            np.testing.assert_array_equal(pp[b, d, L - c:], rp)


def test_dense_walk_rejects_bad_inputs():
    dirs = torch.zeros((1, 9, 2, 32), dtype=torch.int16)
    mx = torch.zeros((1, 2), dtype=torch.int32)
    tpl.traceback_walk_dense(dirs, mx, mx, "nw", 40, 4)
    with pytest.raises(ValueError):
        tpl.traceback_walk_dense(dirs.to(torch.int32), mx, mx, "nw", 40, 4)
    with pytest.raises(ValueError):
        tpl.traceback_walk_dense(dirs, mx.to(torch.int64), mx, "nw", 40, 4)
    with pytest.raises(ValueError):
        tpl.traceback_walk_dense(dirs, mx, mx[:, :1], "nw", 40, 4)
    with pytest.raises(ValueError):  # node_id must be [B, N1 - 1]
        tpl.traceback_walk_dense(dirs, mx, mx, "nw", 40, 4, torch.zeros((1, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="int16"):
        tpl.traceback_walk_dense(
            torch.zeros((1, 40000, 1, 1), dtype=torch.int16), mx[:, :1], mx[:, :1], "nw", 40001, 4
        )


def test_emit_node_ids_needs_the_dense_walk_and_node_ids():
    gr = build_graph(["ACGTACGT"])
    codes, preds, sink, nid, nn, seqp, slen = pack([gr], [[encode("ACGT")]])
    args = (codes, preds, sink, nn, seqp, slen, "nw", *SCORES)
    with pytest.raises(ValueError):
        tpl.poa_align(*args, device="cpu", emit_node_ids=True, node_id=nid)
    with pytest.raises(ValueError):
        tpl.poa_align(*args, device="cpu", emit_rle=False, emit_node_ids=True)


def test_dense_walk_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gr = build_graph(["ACGTACGT"])
    codes, preds, sink, nid, nn, seqp, slen = pack([gr], [[encode("ACGT")]])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.poa_align(codes, preds, sink, nn, seqp, slen, "nw", *SCORES, emit_rle=False)


# ------------------------------------------------------------------------
# The premise of the dense walk kernel, on the CPU: K2's plain walk (a
# marked run is one header) with its headers expanded, cut after L pairs and
# laid into the dense rows, is the dense walk of K1's codes. Exact.


def k1_walk_inputs(graphs, seq_lists, n, p, w, mode, ring):
    """K1's direction codes (its plain version) for `graphs` with their
    sequences at N=n, P=p, W=w: (dirs, maxi, maxj, node_id [B, n])."""
    dense = [graph_to_dense(g, n, p) for g in graphs]
    assert all(d is not None for d in dense)
    codes, preds, sink, nid, nn, seqp, slen = pack_windows(list(zip(dense, seq_lists)), n, p, w)
    B, D = len(graphs), seqp.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)  # noqa: E731
    R = n if ring <= 0 or ring > n else ring
    aux, deg = tpl.pack_aux(t(preds), R)
    dirs, maxi, maxj, _ = tpl.poa_dp(t(codes).reshape(B, n), aux, deg, t(sink).reshape(B, n),
                                     t(nn).reshape(B), t(seqp), t(slen).reshape(B, D), mode,
                                     *SCORES, R)
    return dirs, maxi, maxj, t(nid).reshape(B, n)


def dense_from_runs(dirs, maxi, maxj, mode, L, P, node_id=None):
    """What the dense walk kernel computes: K2's plain walk, each walk's
    headers expanded (`runs_to_pairs_np`, `ranks_to_node_ids_np`), its first
    L pairs in walk order (a run cut where the walk reaches L), laid back to
    front into [B, D, L] rows with -2 before them. Also returns K2's headers
    and counts, uncut."""
    B, N1, D, W = dirs.shape
    runs, steps, count = tpl.traceback_walk_rle(dirs, maxi, maxj, mode, N1 - 1 + W, P)
    runs = runs[:steps].numpy()
    pn = np.full((B, D, L), -2, np.int16)
    pp = np.full((B, D, L), -2, np.int16)
    cnt = np.zeros((B, D), np.int32)
    for b in range(B):
        for d in range(D):
            rn, rp = tpl.runs_to_pairs_np(runs[:, b * D + d])  # front to back
            if node_id is not None:
                rn = tpl.ranks_to_node_ids_np(rn, node_id[b].numpy())
            c = min(len(rn), L)  # the walk's first c pairs are the alignment's last c
            pn[b, d, L - c:] = rn[len(rn) - c:]
            pp[b, d, L - c:] = rp[len(rp) - c:]
            cnt[b, d] = c
    return (pn, pp, cnt), runs, count.numpy()


def premise_case(case, mode):
    """(dirs, maxi, maxj, node_id, L, P) of K1 on: `ring5`, two deep graphs
    at N=64 P=4 with ring 5; `p16`, the same packed with 16 in-edge slots
    (other marker codes); `chain`, one 620-node chain graph at N=W=640 with
    ring 511 and an exact copy of it (620 matches: runs clamped at 511, then
    a run of 109) beside a noisy one; `cut`, the chain with L=300, inside the
    copy's first run."""
    if case in ("ring5", "p16"):
        graphs, seq_lists = deep_case(20 + ["nw", "sw", "ov"].index(mode))
        P = 16 if case == "p16" else 4
        dirs, maxi, maxj, nid = k1_walk_inputs(graphs, seq_lists, N, P, W, mode,
                                               5 if case == "ring5" else 0)
        return dirs, maxi, maxj, nid, N + W, P
    rng = np.random.default_rng(30)
    base = rand_seq(rng, 620)
    gr = build_graph([base])
    dirs, maxi, maxj, nid = k1_walk_inputs([gr], [[encode(base), encode(mutate(rng, base))]],
                                           640, 4, 640, mode, 511)
    return dirs, maxi, maxj, nid, 300 if case == "cut" else 640 + 640, 4


@pytest.mark.parametrize("node_ids", [False, True])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("case", ["ring5", "p16", "chain", "cut"])
def test_dense_walk_is_the_rle_walk_expanded_and_cut(case, mode, node_ids):
    """The dense walk kernel's design, modelled in numpy on K1's codes
    against `_walk_dense_plain`, whole buffers, exact: one header a marked
    run, its pairs arithmetic, node ids looked up a pair, the last run cut
    where the walk reaches L (count == L), -2 before the pairs."""
    dirs, maxi, maxj, nid, L, P = premise_case(case, mode)
    node_id = nid if node_ids else None
    (pn, pp, cnt), runs, rle_count = dense_from_runs(dirs, maxi, maxj, mode, L, P, node_id)
    want = tpl._walk_dense_plain(dirs, maxi, maxj, mode, L, P, node_id)
    for name, got, ref in zip(("pn", "pp", "count"), (pn, pp, cnt), want):
        np.testing.assert_array_equal(got, ref.numpy(), err_msg=name)
    r = runs & ((1 << tpl.RUN_R_BITS) - 1)
    if case == "chain":
        assert (r == 511).any() and rle_count[0, 0] == 620  # the copy: runs clamped at 511
    if case == "cut":
        # the copy's walk reaches L inside its first run of 511 pairs
        assert r[0, 0] == 511 and cnt[0, 0] == L < rle_count[0, 0]
