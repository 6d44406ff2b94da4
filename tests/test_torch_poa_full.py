"""The port's B10 (`vechat_tpu_torch/ops/kernels/poa_full.py`) on the CPU:
its plain version against the JAX package's `poa_align_batch_device` on the
same numpy inputs, `FullAlignerBackend` against `JaxAlignerBackend`, a
polisher run through `make_backend("full", ..., device="cpu")` against the
host backend, and a numpy model of F2's warp (its lanes' best-cell scan and
the ballot choice of each step) against the plain walk. Every comparison
is exact."""

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


def f2_warp(H, codes, preds, nid, sink, nn, seq, sl, mode, m, x, g):
    """F2 on one window as its warp runs it: lane l scans the mode's cells
    l, l + 32, ... in flat (rank, column) order keeping its first strict
    maximum, the warp takes the largest value at the lowest index; then the
    walk, each step's choice from the lanes' slot tests by `f2_choice`."""
    N, P = preds.shape
    S = len(seq)
    L = N + S + 1
    NEG = pf.NEG
    if mode == "nw":
        cells = [(r, sl) for r in range(nn) if sink[r]]
        flat = [r for r, _ in cells]
    else:
        cells = [(r, j) for r in range(nn) if mode == "sw" or sink[r] for j in range(1, sl + 1)]
        flat = [r * S + j - 1 for r, j in cells]
    lanes = []
    for lane in range(32):
        best = (NEG, 0)
        for k in range(lane, len(cells), 32):
            r, j = cells[k]
            if H[r + 1, j] > best[0]:
                best = (int(H[r + 1, j]), flat[k])
        lanes.append(best)
    val, idx = max(lanes, key=lambda t: (t[0], -t[1]))
    if mode == "nw":
        mi, mj = idx + 1, sl
    else:
        mi, mj = idx // S + 1, idx % S + 1
    if mode == "sw" and val <= 0:
        mi = mj = 0
    pairs = np.full((L, 2), -2, np.int64)

    def alive(i, j):
        if mode == "sw":
            return H[i, j] != 0
        if mode == "nw":
            return not (i == 0 and j == 0)
        return not (i == 0 or j == 0)

    if mi == 0 and mj == 0:
        return pairs, 0, val
    i, j, k = mi, mj, 0
    while alive(i, j):
        h = H[i, j]
        node, jm1 = max(i - 1, 0), max(j - 1, 0)
        mc = m if seq[jm1] == codes[node] else x
        p = preds[node]
        diag = [i != 0 and j != 0 and h == H[p[s], jm1] + mc for s in range(P)]
        vert = [i != 0 and h == H[p[s], j] + g for s in range(P)]
        kind, slot = f2_choice(diag, vert, j != 0 and h == H[i, jm1] + g)
        pi = p[slot] if kind != "horiz" else i
        pj = j if kind == "vert" else j - 1
        pairs[L - 1 - k] = (-1 if pi == i else nid[node], -1 if pj == j else j - 1)
        i, j, k = pi, pj, k + 1
    return pairs, k, val


@pytest.mark.parametrize("mode", ["nw", "ov", "sw"])
def test_f2_warp_model_equals_the_plain_walk(mode):
    arrs = batch_inputs(11, B=4, N=64, P=4, S=63)
    codes, preds, nid, sink, nn, seq, sl = arrs
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    H = pf._dp_full_plain(t[0], t[1], t[4], t[5], t[6], mode, 3, -5, -4)
    pairs, count, score = pf._walk_full_plain(H, *t[:4], t[4], t[5], t[6], mode, 3, -5, -4)
    for b in range(len(nn)):
        mp, mc, ms = f2_warp(H[b].numpy(), codes[b], preds[b], nid[b], sink[b], int(nn[b]), seq[b],
                             int(sl[b]), mode, 3, -5, -4)
        np.testing.assert_array_equal(mp, pairs[b].numpy())
        assert (mc, ms) == (int(count[b]), int(score[b]))
