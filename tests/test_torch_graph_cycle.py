"""The port's device prune cycle (`vechat_tpu_torch/ops/kernels/graph_cycle.py`,
`pipeline/device_cycle.py`) against the JAX package's
(`vechat_tpu/ops/kernels/graph_cycle.py`) on the same numpy inputs, on the
CPU: every function of the cycle, exact equality; the whole
`generate_consensus_haplotype` with `VECHAT_DEVICE_CYCLE=1` byte for byte
against the JAX package's host path; and a numpy model of the warp steps of
G1 and G2 (ballot, __ffs / __clz, the root cursor) against the plain
machines. The port's alignments run on the plain versions of K1 and the
dense walk; the JAX side on its own int32 DP.

The windows are those of tests/test_graph_cycle.py (N=192, E=384, P=16,
A=32, seeded windows of depth 6), with edge windows beside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vechat_tpu.ops.encode import encode
from vechat_tpu.ops.graph_align import LinearAligner
from vechat_tpu.ops.kernels import graph_cycle as jgc
from vechat_tpu.ops.poagraph import PoaGraph
from vechat_tpu_torch.ops.kernels import graph_cycle as tgc

ENG = LinearAligner("nw", 3, -5, -4)
N, E, P, A = 192, 384, 16, 32


def _noisy(rng, base, sub=0.05, dele=0.03, ins=0.02):
    out = []
    for c in base:
        r = rng.random()
        if r < sub:
            out.append(rng.choice(list("ACGT")))
        elif r < sub + dele:
            continue
        else:
            out.append(c)
        if rng.random() < ins:
            out.append(rng.choice(list("ACGT")))
    return "".join(out)


def _build_window(rng, base_len=50, depth=6, weights=None):
    base = "".join(rng.choice(list("ACGT"), size=base_len))
    strain2 = list(base)
    for i in range(5, base_len, 13):
        strain2[i] = rng.choice(list("ACGT"))
    strain2 = "".join(strain2)
    g = PoaGraph()
    seqs = []
    for k in range(depth):
        src = strain2 if k % 2 == 0 and k else base
        q = encode(_noisy(rng, src))
        aln = ENG.align(q, g) if k else []
        w = np.ones(len(q), np.uint32) if weights is None else weights(len(q))
        g.add_alignment(aln, q, w)
        seqs.append(q)
    return g, seqs


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _t(a):
    return torch.from_numpy(np.array(a))


def _pack(graphs, n_cap=N, e_cap=E):
    packs = [jgc.graph_to_edges(g, n_cap, e_cap) for g in graphs]
    assert all(p is not None for p in packs)
    tp = [tgc.graph_to_edges(g, n_cap, e_cap) for g in graphs]
    for a, b in zip(packs, tp):
        for k in a:
            _eq(a[k], b[k])
    return {k: np.stack([np.asarray(p[k]) for p in packs]).astype(
        np.float32 if k == "avg" else np.int32) for k in packs[0]}


@pytest.fixture(scope="module")
def batch():
    """Three windows of tests/test_graph_cycle.py, then a copy of the first
    whose average weight prunes every edge (its prune leaves one node)."""
    rng = np.random.default_rng(11)
    graphs, seqlists = [], []
    for _ in range(3):
        g, seqs = _build_window(rng)
        graphs.append(g)
        seqlists.append(seqs)
    graphs.append(graphs[0])
    seqlists.append(seqlists[0])
    d = _pack(graphs)
    avg = np.array([2.0 * sum(len(q) for q in sl) / len(sl[0]) for sl in seqlists], np.float32)
    avg[3] *= 1e6
    d.update(graphs=graphs, seqlists=seqlists, avg=avg)
    d["valid"] = np.arange(E)[None, :] < d["n_edges"][:, None]
    d["alive"] = np.arange(N)[None, :] < d["n_nodes"][:, None]
    return d


def _j(d, k):
    return jnp.asarray(d[k])


@pytest.fixture(scope="module")
def chain(batch):
    """Every step of prune_and_rebuild, on both sides, each fed the same
    inputs (the JAX side's outputs of the step before)."""
    b = batch
    out = {}
    jk = jgc.prune_edges(_j(b, "tails"), _j(b, "heads"), _j(b, "weights"), _j(b, "valid"), N,
                         _j(b, "avg"), jnp.float32(0.2), jnp.float32(0.2))
    tk = tgc.prune_edges(_t(b["tails"]), _t(b["heads"]), _t(b["weights"]), _t(b["valid"]), N,
                         _t(b["avg"]), 0.2, 0.2)
    out["keep"] = (jk, tk)
    keep = np.asarray(jk)
    jl = jgc.cc_min_labels(_j(b, "tails"), _j(b, "heads"), jnp.asarray(keep), _j(b, "alive"))
    stats = {}
    tl = tgc.cc_min_labels(_t(b["tails"]), _t(b["heads"]), _t(keep), _t(b["alive"]), stats)
    out["labels"] = (jl, tl)
    out["cc_rounds"] = stats["cc_rounds"]
    labels = np.asarray(jl)
    jc, jr = jgc.select_component(jnp.asarray(labels), _j(b, "alive"))
    tc, tr = tgc.select_component(_t(labels), _t(b["alive"]))
    out["comp"], out["root"] = (jc, tc), (jr, tr)
    ja = jgc.build_undirected_adjacency(_j(b, "tails"), _j(b, "heads"), jnp.asarray(keep), N, A)
    ta = tgc.build_undirected_adjacency(_t(b["tails"]), _t(b["heads"]), _t(keep), N, A)
    out["adj"] = (ja, ta)
    adj, deg = np.asarray(ja[0]), np.asarray(ja[1])
    comp, root = np.asarray(jc), np.asarray(jr)
    jd = jgc.dfs_preorder(jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(comp), jnp.asarray(root))
    td = tgc.dfs_preorder(_t(adj), _t(deg), _t(comp), _t(root))
    out["dfs"] = (jd, td)
    new_id, order = np.asarray(jd[0]), np.asarray(jd[1])
    jrn = jgc.renumber_subgraph(_j(b, "tails"), _j(b, "heads"), jnp.asarray(keep),
                                jnp.asarray(new_id), jnp.asarray(order), _j(b, "codes"))
    trn = tgc.renumber_subgraph(_t(b["tails"]), _t(b["heads"]), _t(keep), _t(new_id),
                                _t(order), _t(b["codes"]))
    out["renumber"] = (jrn, trn)
    t2, h2, _, v2, _, codes2 = (np.asarray(a) for a in jrn)
    ji = jgc.build_in_slots(jnp.asarray(t2), jnp.asarray(h2), jnp.asarray(v2), N, P)
    ti = tgc.build_in_slots(_t(t2), _t(h2), _t(v2), N, P)
    out["in_slots"] = (ji, ti)
    in_nbr, indeg, out_deg = (np.asarray(a) for a in ji[:3])
    n_sub = np.asarray(jd[2])
    jt = jgc.topo_ranks(jnp.asarray(in_nbr), jnp.asarray(indeg), jnp.asarray(n_sub))
    tt = tgc.topo_ranks(_t(in_nbr), _t(indeg), _t(n_sub))
    out["topo"] = (jt, tt)
    rank_of, r2n = np.asarray(jt[0]), np.asarray(jt[1])
    args = (rank_of, r2n, in_nbr, indeg, out_deg, codes2, n_sub)
    jdp = jgc.build_dp_arrays(*(jnp.asarray(a) for a in args))
    tdp = tgc.build_dp_arrays(*(_t(a) for a in args))
    out["dp"] = (jdp, tdp)
    out["np"] = dict(t2=t2, h2=h2, v2=v2, ne2=np.asarray(jrn[4]), w2=np.asarray(jrn[2]),
                     codes2=codes2, n_sub=n_sub, r2n=r2n,
                     **{k: np.asarray(a) for k, a in zip(("codes_dp", "preds_dp", "is_sink"), jdp)})
    return out


def test_graph_to_edges_matches_on_python_and_native_graphs(batch):
    from vechat_tpu_torch.ops.native_graph import make_graph

    g = make_graph()
    for q in batch["seqlists"][0]:
        aln = g.align_host(q, "nw", 3, -5, -4) if g.num_nodes() else []
        g.add_alignment(aln, q, np.ones(len(q), np.uint32))
    d = tgc.graph_to_edges(g, N, E)
    ref = jgc.graph_to_edges(batch["graphs"][0], N, E)
    for k in ref:
        _eq(ref[k], d[k])
    assert tgc.graph_to_edges(g, 8, E) is None and tgc.graph_to_edges(g, N, 8) is None


def test_prune_edges(chain, batch):
    j, t = chain["keep"]
    _eq(j, t)
    keep = _np(t)
    assert keep[:3].any(axis=1).all()  # real pruning, edges kept
    assert not keep[3].any()  # the fourth window's prune drops every edge


@pytest.mark.parametrize("check", [1, 4])
def test_cc_min_labels(chain, batch, check, monkeypatch):
    j, t = chain["labels"]
    _eq(j, t)
    monkeypatch.setattr(tgc, "CC_CHECK", check)
    keep = _np(chain["keep"][0])
    stats = {}
    again = tgc.cc_min_labels(_t(batch["tails"]), _t(batch["heads"]), _t(keep),
                              _t(batch["alive"]), stats)
    _eq(j, again)
    assert stats["cc_rounds"] % check == 0 and stats["cc_rounds"] >= 1


def test_select_component(chain, batch):
    for k in ("comp", "root"):
        _eq(*chain[k])
    n_sub = chain["np"]["n_sub"]
    assert n_sub[3] == 1  # one node left: the last of the largest (size-1) components
    assert _np(chain["root"][1])[3] == batch["n_nodes"][3] - 1


def test_build_undirected_adjacency(chain):
    for a, b in zip(*chain["adj"]):
        _eq(a, b)


def test_dfs_preorder(chain):
    for a, b in zip(*chain["dfs"]):
        _eq(a, b)


def test_renumber_subgraph(chain):
    for a, b in zip(*chain["renumber"]):
        _eq(a, b)


def test_build_in_slots(chain):
    for a, b in zip(*chain["in_slots"]):
        _eq(a, b)


def test_topo_ranks(chain):
    for a, b in zip(*chain["topo"]):
        _eq(a, b)


def test_build_dp_arrays(chain):
    for a, b in zip(*chain["dp"]):
        _eq(a, b)


# ------------------------------------------------------------ alignments


@pytest.fixture(scope="module")
def realign(batch, chain):
    """Every window's sequences, odd ones sw, a second sw sequence of a code
    no node has (its best cell is 0, its walk empty) and padding past d_used."""
    seqlists = batch["seqlists"]
    B = len(seqlists)
    D = max(len(sl) for sl in seqlists) + 2
    S = max(max(len(q) for q in sl) for sl in seqlists) + 8
    seq = np.full((B, D, S), 0xFF, np.int32)
    slen = np.ones((B, D), np.int32)
    is_sw = np.zeros((B, D), bool)
    d_used = np.zeros(B, np.int32)
    for b, sl in enumerate(seqlists):
        sl = list(sl) + ([np.full(7, 4, np.uint8)] if b == 0 else [])
        d_used[b] = len(sl)
        for i, q in enumerate(sl):
            seq[b, i, : len(q)] = q
            slen[b, i] = len(q)
            is_sw[b, i] = i % 2 == 1
    is_sw[0, d_used[0] - 1] = True
    assert (d_used < D).all()
    c = chain["np"]
    args = (c["codes_dp"], c["preds_dp"], c["is_sink"], c["n_sub"], seq, slen, is_sw)
    jp, jc, js = jgc.poa_align_mixed(*(jnp.asarray(a) for a in args), 3, -5, -4)
    tp, tc, ts, over = tgc.poa_align_mixed(*(_t(a) for a in args), 3, -5, -4)
    jids = jgc.ranks_to_ids(jp, jnp.asarray(c["r2n"]))
    tids = tgc.poa_align_mixed(*(_t(a) for a in args), 3, -5, -4, node_id=_t(c["r2n"]))
    return dict(seq=seq, slen=slen, is_sw=is_sw, d_used=d_used, S=S, D=D, j=(jp, jc, js),
                t=(tp, tc, ts), over=over, jids=jids, tids=tids)


def test_poa_align_mixed_on_k1_and_the_dense_walk(realign):
    """The port's K1 and dense walk (plain versions) against the JAX
    program's int32 DP and walk, every (window, sequence), padding
    included: the same L = N + S + 1 columns, -2 before the pairs."""
    for a, b in zip(realign["j"], realign["t"]):
        _eq(a, b)
    assert not _np(realign["over"]).any()
    count = _np(realign["t"][1])
    d0 = realign["d_used"][0]
    assert count[0, d0 - 1] == 0 and realign["is_sw"][0, d0 - 1]  # best cell 0: empty
    assert (count[:, 0] > 0).all()


def test_ranks_to_ids_and_node_id_walk(realign, chain):
    _eq(realign["jids"], realign["tids"][0])
    _eq(realign["jids"], tgc.ranks_to_ids(realign["t"][0], _t(chain["np"]["r2n"])))


def test_poa_align_mixed_active_mask(realign, chain):
    """Inactive sequences are not aligned: -2 pairs, count 0; the rest as
    before."""
    c = chain["np"]
    active = np.arange(realign["D"])[None, :] < realign["d_used"][:, None]
    args = (c["codes_dp"], c["preds_dp"], c["is_sink"], c["n_sub"], realign["seq"],
            realign["slen"], realign["is_sw"])
    p, cnt, _, _ = tgc.poa_align_mixed(*(_t(a) for a in args), 3, -5, -4, active=_t(active))
    want = np.where(active[:, :, None, None], _np(realign["t"][0]), -2)
    _eq(want, p)
    _eq(np.where(active, _np(realign["t"][1]), 0), cnt)


def test_poa_align_mixed_launch_cut_changes_nothing(realign, chain, monkeypatch):
    c = chain["np"]
    args = (c["codes_dp"], c["preds_dp"], c["is_sink"], c["n_sub"], realign["seq"],
            realign["slen"], realign["is_sw"])
    monkeypatch.setattr(tgc, "LAUNCH_BYTES", 1)  # one window a launch
    out = tgc.poa_align_mixed(*(_t(a) for a in args), 3, -5, -4)
    for a, b in zip(realign["t"], out):
        _eq(a, b)


def test_poa_align_mixed_flags_a_predecessor_distance_past_511():
    """A chain of 600 nodes with an edge from its first node to its last:
    row 600's predecessor is row 1, 599 rows up, past K1's 9-bit field. That
    window is flagged and not aligned; the other aligns."""
    n_cap = 640
    codes = np.zeros((2, n_cap), np.int64)
    preds = np.zeros((2, n_cap, 4), np.int64)
    rows = np.arange(1, n_cap + 1)
    preds[:, :, 0] = rows - 1  # row r's predecessor: row r - 1 (row 1: row 0)
    preds[:, :, 1:] = preds[:, :, :1]
    preds[0, 599, 1] = 1
    is_sink = np.zeros((2, n_cap), bool)
    is_sink[:, 599] = True
    n_sub = np.array([600, 600])
    seq = np.zeros((2, 1, 100), np.int64)
    p, cnt, _, over = tgc.poa_align_mixed(_t(codes), _t(preds), _t(is_sink), _t(n_sub), _t(seq),
                                          _t(np.full((2, 1), 100)), _t(np.ones((2, 1), bool)),
                                          3, -5, -4)
    assert _np(over).tolist() == [True, False]
    assert (_np(p)[0] == -2).all() and _np(cnt).tolist() == [[0], [100]]
    assert int(_np(tgc.pred_distance(_t(preds), _t(n_sub)))[0]) == 599


# ------------------------------------------------------------- AddWeights


def test_add_weights_batch(batch, chain, realign):
    c = chain["np"]
    masked = np.where(np.arange(realign["D"])[None, :, None, None]
                      < realign["d_used"][:, None, None, None], _np(realign["jids"]), -2)
    rng = np.random.default_rng(5)
    seq_w = rng.integers(0, 1000, size=(len(c["n_sub"]), realign["D"], realign["S"]))
    args = (c["t2"], c["h2"], c["w2"], c["v2"], c["ne2"], masked, seq_w.astype(np.int32))
    j = jgc.add_weights_batch(*(jnp.asarray(a) for a in args), N)
    t = tgc.add_weights_batch(*(_t(a) for a in args), N)
    for a, b in zip(j, t):
        _eq(a, b)
    assert (_np(t[2]) > 0).any()


def _new_edge_case(e_cap):
    """tests/test_graph_cycle.py::test_add_weights_new_edge_creation: a chain
    0->1->2->3 with a detour 0->4->3; the alignments walk the missing 1->3
    and 4->1."""
    g = PoaGraph()
    for code in [0, 1, 2, 3, 1]:
        g.add_node(code)
    for t, h in [(0, 1), (1, 2), (2, 3), (0, 4), (4, 3)]:
        g.add_edge(t, h, 0)
    ed = jgc.graph_to_edges(g, 8, e_cap)
    L = 6
    pairs = np.full((1, 2, L, 2), -2, np.int32)
    pairs[0, 0, L - 3:] = [[0, 0], [1, 1], [3, 2]]
    pairs[0, 1, L - 4:] = [[0, 0], [4, 1], [1, 2], [3, 3]]
    return (ed["tails"][None], ed["heads"][None], ed["weights"][None],
            (np.arange(e_cap) < ed["n_edges"])[None], np.array([ed["n_edges"]], np.int32), pairs,
            np.ones((1, 2, 8), np.int32))


@pytest.mark.parametrize("e_cap", [16, 6])
def test_add_weights_new_edge_creation_and_its_cap(e_cap):
    """Two new edges appended in first-occurrence order (E = 16), and with
    room for one (E = 6) the overflow flag, as in the JAX program."""
    args = _new_edge_case(e_cap)
    j = jgc.add_weights_batch(*(jnp.asarray(a) for a in args), 8)
    t = tgc.add_weights_batch(*(_t(a) for a in args), 8)
    for a, b in zip(j, t):
        _eq(a, b)
    assert bool(_np(t[5])[0]) == (e_cap == 6)
    assert int(_np(t[4])[0]) == min(7, e_cap)


def test_corrected_emit(chain, realign):
    c = chain["np"]
    B = len(c["n_sub"])
    args = (c["codes_dp"], c["preds_dp"], c["is_sink"], c["n_sub"], realign["seq"][:, :1],
            realign["slen"][:, :1], np.ones((B, 1), bool))
    jp, _, _ = jgc.poa_align_mixed(*(jnp.asarray(a) for a in args), 3, -5, -4)
    jids = np.asarray(jgc.ranks_to_ids(jp, jnp.asarray(c["r2n"])))
    tp = tgc.poa_align_mixed(*(_t(a) for a in args), 3, -5, -4, node_id=_t(c["r2n"]))[0]
    _eq(jids, tp)
    j = jgc.corrected_emit(jnp.asarray(jids[:, 0]), jnp.asarray(c["codes2"]))
    t = tgc.corrected_emit(tp[:, 0], _t(c["codes2"]))
    for a, b in zip(j, t):
        _eq(a, b)


# ------------------------------------------------------------- the cycle


def _cycle_args(batch, realign, seq_w=None, avg=None):
    B = len(batch["seqlists"])
    if seq_w is None:
        seq_w = np.ones((B, realign["D"], realign["S"]), np.int32)
    return (batch["tails"], batch["heads"], batch["weights"], batch["n_edges"], batch["codes"],
            batch["n_nodes"], batch["avg"] if avg is None else avg, realign["seq"],
            realign["slen"], seq_w, realign["is_sw"], realign["d_used"])


def _both_cycles(args, conf=0.2, supp=0.2, m=3, x=-5, g=-4):
    j = jgc.haplotype_cycle(*(jnp.asarray(a) for a in args), jnp.float32(conf),
                            jnp.float32(supp), num_prune=3, m=m, x=x, g=g)
    stats = {}
    t = tgc.haplotype_cycle(*(_t(a) for a in args), conf, supp, 3, m, x, g, stats=stats)
    return j, t, stats


JAX_OVERFLOW = tgc.OVF_A_CAP | tgc.OVF_P_CAP | tgc.OVF_NEW_EDGES


def _check_cycle(j, t):
    """Equal flags; equal results on every window not flagged (a flagged
    window's results are dropped for the host's)."""
    corrected, out_len, overflow, n_sub = (_np(a) for a in j)
    assert np.array_equal(overflow, (_np(t[2]) & JAX_OVERFLOW) != 0)
    ok = _np(t[2]) == 0
    _eq(corrected[ok], _np(t[0])[ok])
    _eq(out_len[ok], _np(t[1])[ok])
    _eq(n_sub[ok], _np(t[3])[ok])


def test_haplotype_cycle(batch, realign):
    """One batch through the whole cycle (num_prune 3), FASTA weights: the
    corrected sequences, their lengths, the overflow flags and n_sub."""
    j, t, stats = _both_cycles(_cycle_args(batch, realign))
    _check_cycle(j, t)
    assert not _np(t[2]).any() and (_np(t[1])[:3] > 40).all()
    assert _np(t[3])[3] == 1  # the window whose prune leaves one node
    assert stats["cc_rounds"] >= 3


def test_g1_caller_passes_its_buffers_as_they_are(batch, realign, monkeypatch):
    """The cycle calls G1 without its checks: adj and deg int32, comp_mask
    bool and root int64, all contiguous, as the kernel takes them."""
    calls = []
    original = tgc.dfs_preorder

    def spy(adj, deg, comp_mask, root, check=True):
        calls.append(check)
        assert [a.dtype for a in (adj, deg, comp_mask, root)] == [torch.int32, torch.int32,
                                                                 torch.bool, torch.int64]
        assert all(a.is_contiguous() for a in (adj, deg, comp_mask, root))
        return original(adj, deg, comp_mask, root, check=check)

    monkeypatch.setattr(tgc, "dfs_preorder", spy)
    tgc.haplotype_cycle(*(_t(a) for a in _cycle_args(batch, realign)), 0.2, 0.2, 3, 3, -5, -4)
    assert calls and not any(calls)


def test_haplotype_cycle_ont_quality_weights(batch, realign):
    """--platform ont: per-base phred weights (seq_w != 1) and the average
    weight x1000, as `run_device_cycle` packs FASTQ windows."""
    rng = np.random.default_rng(7)
    B = len(batch["seqlists"])
    qual = rng.integers(33 + 5, 33 + 40, size=(B, realign["D"], realign["S"]))
    seq_w = ((1.0 - np.power(10.0, (33.0 - qual) / 10.0)) * 1000.0).astype(np.int32)
    avg = (batch["avg"].astype(np.float64) * 1000.0 * 0.9).astype(np.float32)
    j, t, _ = _both_cycles(_cycle_args(batch, realign, seq_w, avg))
    _check_cycle(j, t)
    assert (_np(t[1])[:3] > 0).all()


def _star(n_leaves, into):
    """Node 0 out to n_leaves leaves (into=False), or n_leaves sources into
    one sink (into=True): a node of degree n_leaves."""
    g = PoaGraph()
    for k in range(n_leaves + 1):
        g.add_node(k % 4)
    for k in range(1, n_leaves + 1):
        g.add_edge(k, 0, 1) if into else g.add_edge(0, k, 1)
    return g


def test_haplotype_cycle_flags_a_cap_and_p_cap(batch, realign):
    """With nothing pruned (confidence and support 0), a node of 40
    neighbours passes A = 32 (and P = 16 too where they are in-edges), one
    of 20 in-edges only P = 16: flagged as in the JAX program; the other
    windows are corrected."""
    graphs = [_star(40, False), _star(20, True)] + batch["graphs"][1:3]
    d = _pack(graphs)
    args = list(_cycle_args(batch, realign))
    for k, key in enumerate(("tails", "heads", "weights", "n_edges", "codes", "n_nodes")):
        args[k] = d[key]
    j, t, _ = _both_cycles(args, conf=0.0, supp=0.0)
    _check_cycle(j, t)
    assert _np(t[2]).tolist() == [tgc.OVF_A_CAP, tgc.OVF_P_CAP, 0, 0]


def test_haplotype_cycle_flags_a_predecessor_distance_past_511():
    """A chain of 600 nodes with an edge from the first to the last: its
    ranks are its ids, so the last row's predecessor is 599 rows up."""
    n_cap, e_cap = 640, 1280
    g = PoaGraph()
    for k in range(600):
        g.add_node(k % 4)
    for k in range(599):
        g.add_edge(k, k + 1, 1)
    g.add_edge(0, 599, 1)
    d = _pack([g], n_cap, e_cap)
    seq = np.zeros((1, 2, 600), np.int32)
    seq[0, 0] = np.arange(600) % 4
    out = tgc.haplotype_cycle(*(_t(a) for a in (
        d["tails"], d["heads"], d["weights"], d["n_edges"], d["codes"], d["n_nodes"],
        np.ones(1, np.float32), seq, np.full((1, 2), 600), np.ones((1, 2, 600), np.int32),
        np.zeros((1, 2), bool), np.array([2]))), 0.0, 0.0, 3, 3, -5, -4)
    assert _np(out[2]).tolist() == [tgc.OVF_RING]


def test_haplotype_cycle_flags_scores_past_int16(batch, realign):
    """Scores whose worst case leaves K1's int16 rows at the bucket's (N, W):
    the cycle refuses the batch and runs nothing (`run_device_cycle` sends
    such windows to the host before packing them, see
    test_full_pipeline_ladder_and_int16_route_to_the_host)."""
    with pytest.raises(ValueError, match="int16"):
        tgc.haplotype_cycle(*(_t(a) for a in _cycle_args(batch, realign)), 0.2, 0.2, 3,
                            60, -60, -60)


# -------------------------------------------------------- whole pipeline


def _pipeline_windows(fastq):
    """The four windows of tests/test_graph_cycle.py's whole-pipeline test
    (partial layers, mixed modes), as codes, qualities and spans; with
    `fastq`, seeded qualities on every sequence (the --platform ont route:
    phred weights, the average weight x1000)."""
    rng = np.random.default_rng(23)
    qrng = np.random.default_rng(29)

    def qual(n):
        return "".join(chr(33 + int(q)) for q in qrng.integers(5, 40, size=n)) if fastq else None

    wins = []
    for k in range(4):
        base_len = 60 + 10 * k
        base = "".join(rng.choice(list("ACGT"), size=base_len))
        strain2 = list(base)
        for i in range(5, base_len, 19):
            strain2[i] = rng.choice(list("ACGT"))
        strain2 = "".join(strain2)
        bb = encode(_noisy(rng, base))
        blen = len(bb)
        layers = []
        for j in range(6):
            src = strain2 if j % 2 else base
            b0 = int(rng.integers(0, 5))
            e0 = blen - 1 - int(rng.integers(0, 5))
            seg = src[int(b0 / blen * len(src)) : int((e0 + 1) / blen * len(src))]
            codes = encode(_noisy(rng, seg))
            if len(codes) == 0 or b0 >= e0:
                continue
            layers.append((codes, qual(len(codes)), b0, e0))
        wins.append((bb, qual(blen), layers))
    return wins


def _windows_of(pkg, spec, fastq):
    wins = []
    for k, (bb, bq, layers) in enumerate(spec):
        w = pkg.Window(target_id=0, rank=k, window_type=1, backbone_codes=bb.copy(),
                       backbone_quality=bq, if_fasta=not fastq)
        for codes, q, b0, e0 in layers:
            w.add_layer(codes.copy(), q, b0, e0)
        wins.append(w)
    return wins


def _jax_host(spec, fastq, scores=(3, -5, -4)):
    from vechat_tpu.pipeline import windows as jw

    host = _windows_of(jw, spec, fastq)
    jw.generate_consensus_haplotype(host, jw.HostAlignerBackend(*scores), 0.2, 0.2, 3)
    return [(list(w.consensus_codes), w.polished) for w in host]


@pytest.fixture(scope="module", params=[False, True], ids=["fasta", "fastq"])
def pipeline(request):
    """The four windows, and the JAX package's host path on them."""
    spec = _pipeline_windows(request.param)
    return spec, request.param, _jax_host(spec, request.param)


@pytest.fixture(scope="module")
def pipeline_fasta():
    spec = _pipeline_windows(False)
    return spec, False, _jax_host(spec, False)


def _port_pipeline(spec, fastq, monkeypatch, scores=(3, -5, -4)):
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline import windows as tw

    monkeypatch.setenv("VECHAT_DEVICE_CYCLE", "1")
    wins = _windows_of(tw, spec, fastq)
    be = TorchAlignerBackend(*scores, device="cpu")
    tw.generate_consensus_haplotype(wins, be, 0.2, 0.2, 3)
    return [(list(w.consensus_codes), w.polished) for w in wins], be


def test_full_pipeline_device_cycle_equals_the_jax_host_path(pipeline, monkeypatch):
    """`generate_consensus_haplotype` with VECHAT_DEVICE_CYCLE=1 and the
    torch backend on the CPU: every window through the device cycle, byte
    for byte the JAX package's host path."""
    spec, fastq, want = pipeline
    got, be = _port_pipeline(spec, fastq, monkeypatch)
    assert got == want
    c = be.counters()
    assert c["n_cycle_windows"] == 4 and c["n_cycle_host"] == 0
    assert c["n_cycle_dispatches"] >= 1 and c["cycle_cc_rounds"] > 0


def test_full_pipeline_routes_flagged_windows_to_the_host(pipeline_fasta, monkeypatch):
    """A window past the edge cap never reaches the cycle; the cycle flags
    the other three (past A_CAP; past P_CAP and the new-edge cap; past the
    ring). Each takes the host cycle and is counted under its reasons, and
    the output does not change."""
    from vechat_tpu_torch.pipeline import device_cycle

    spec, fastq, want = pipeline_fasta
    real_cycle, real_edges = device_cycle.haplotype_cycle, device_cycle.graph_to_edges
    calls = []

    def edges_first_refused(g, n, e):
        calls.append(g)
        return None if len(calls) == 1 else real_edges(g, n, e)

    def flag_all(*args, **kw):
        corrected, out_len, overflow, n_sub = real_cycle(*args, **kw)
        bits = [tgc.OVF_A_CAP, tgc.OVF_P_CAP | tgc.OVF_NEW_EDGES, tgc.OVF_RING]
        return corrected, out_len, overflow | torch.tensor(bits[: len(overflow)]), n_sub

    monkeypatch.setattr(device_cycle, "graph_to_edges", edges_first_refused)
    monkeypatch.setattr(device_cycle, "haplotype_cycle", flag_all)
    got, be = _port_pipeline(spec, fastq, monkeypatch)
    assert got == want
    c = be.counters()
    assert c["n_cycle_windows"] == 0 and c["n_cycle_host"] == 4 and c["n_cycle_dispatches"] == 1
    assert {k[11:]: v for k, v in c.items() if k.startswith("cycle_host_") and v} == dict(
        edges_cap=1, a_cap=1, p_cap=1, new_edges=1, ring=1)


def test_full_pipeline_ladder_and_int16_route_to_the_host(pipeline_fasta, monkeypatch):
    """Windows past the node ladder, or in a bucket whose scores leave int16,
    never reach the cycle: counted, and the output does not change."""
    from vechat_tpu_torch.pipeline import device_cycle

    spec, fastq, want = pipeline_fasta
    monkeypatch.setattr(device_cycle, "N_LADDER", (16,))
    got, be = _port_pipeline(spec, fastq, monkeypatch)
    assert got == want and be.counters()["cycle_host_ladder"] == 4
    monkeypatch.undo()
    scores = (60, -60, -60)
    got, be = _port_pipeline(spec, fastq, monkeypatch, scores)
    assert got == _jax_host(spec, fastq, scores)
    assert be.counters()["cycle_host_int16"] == 4 and be.counters()["n_cycle_dispatches"] == 0
def test_host_backend_ignores_the_switch(monkeypatch):
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline.device_cycle import use_device_cycle
    from vechat_tpu_torch.pipeline.windows import HostAlignerBackend

    monkeypatch.delenv("VECHAT_DEVICE_CYCLE", raising=False)
    assert not use_device_cycle(TorchAlignerBackend(3, -5, -4, device="cpu"))
    monkeypatch.setenv("VECHAT_DEVICE_CYCLE", "1")
    assert use_device_cycle(TorchAlignerBackend(3, -5, -4, device="cpu"))
    assert not use_device_cycle(HostAlignerBackend(3, -5, -4))
    monkeypatch.setenv("VECHAT_DEVICE_CYCLE", "0")
    assert not use_device_cycle(TorchAlignerBackend(3, -5, -4, device="cpu"))


# ------------------------------------- numpy models of G1's and G2's warps


def _ballot(pred):
    """__ballot_sync: lane k's predicate in bit k."""
    return sum(1 << k for k, p in enumerate(pred) if p)


def _ffs(x):
    """__ffs: 1 + the index of the lowest set bit (0 for none)."""
    return (x & -x).bit_length()


def _clz(x):
    """__clz of a 32-bit word."""
    return 32 - x.bit_length()


def _bit(words, i):
    return (int(words[i >> 5]) >> (i & 31)) & 1


def _set(words, i):
    words[i >> 5] |= np.uint32(1 << (i & 31))


def g1_warp(adj, deg, comp, root, cap=None):
    """csrc/graph_cycle.cu:graph_dfs_kernel for one window, step for step:
    the block's scan of min(deg, A, 32) into slot offsets and, where the
    total is within `cap` (dfs_slot_cap), its compact copy of the slots
    (else the rows read where they lie); then warp 0's walk over a stack of
    (node, lo, hi, scan pointer) frames, the top frame and the one below it
    in registers: 32 lanes hold slot k of the top node's row, the ballot of
    the unvisited slots at or past the scan pointer, __ffs; a push shuffles
    the new node and its slot bounds from its lane, loads its row, and the
    top becomes the frame below; a pop makes the frame below the top and
    reads the one below that back from the frames (its row at the next
    step's start)."""
    n, a = adj.shape
    lanes = min(a, 32)
    cap = tgc.dfs_slot_cap(n, a) if cap is None else cap
    off = np.concatenate([[0], np.cumsum(np.clip(deg, 0, lanes))]).astype(np.int64)
    compact = off[n] <= cap
    slots = np.zeros(max(cap, 1), np.int64)
    if compact:
        for v in range(n):
            slots[off[v] : off[v + 1]] = adj[v, : off[v + 1] - off[v]]

    def row(v, lo, hi):
        return [(int(slots[lo + k]) if compact else int(adj[v, k])) if k < hi - lo else 0
                for k in range(32)]

    visited = np.zeros((n + 31) // 32, np.uint32)
    new_id, order = np.full(n, -1), np.zeros(n, np.int64)
    frames = [None] * n
    order[0] = root
    has = bool(comp[root])
    sp = cnt = int(has)
    top = (root, int(off[root]), int(off[root + 1]), 0) if has else (root, 0, 0, 0)
    u = row(*top[:3])
    below, pu, stale = (0, 0, 0, 0), [0] * 32, False
    if has:
        _set(visited, root)
        new_id[root], frames[0] = 0, top
    while sp > 0:
        v, lo, hi, p = top
        bounds = [(int(off[x]), int(off[x + 1])) for x in u]
        if stale:
            pu = row(*below[:3])
        ball = _ballot(k < hi - lo and k >= p and not _bit(visited, u[k]) for k in range(32))
        if ball:
            j = _ffs(ball) - 1
            w = u[j]  # __shfl_sync from lane j, with its bounds
            wlo, whi = bounds[j]
            wu = row(w, wlo, whi)
            frames[sp - 1] = (v, lo, hi, j + 1)
            frames[sp] = (w, wlo, whi, 0)
            _set(visited, w)
            new_id[w], order[cnt] = cnt, w
            below, pu, stale = (v, lo, hi, j + 1), u, False
            top, u = (w, wlo, whi, 0), wu
            cnt, sp = cnt + 1, sp + 1
        else:
            sp -= 1
            top, u = below, pu
            stale = sp > 1
            if stale:
                below = frames[sp - 2]
    return new_id, order, cnt


def g2_warp(in_nbr, indeg, n_sub, cap=None):
    """csrc/graph_cycle.cu:graph_topo_kernel for one window, step for step:
    the block stages the rows of the window's n = min(n_sub, N) nodes (the
    tails as uint16, min(indeg, P) as a byte) where n <= cap (topo_row_cap
    by default), and the walk reads them there where every staged tail lies
    below n (a flag of the block's staging), else every row where it lies; the root
    from a cursor that moves forward a word of the bitmap at a time
    (__ffs); warp 0's walk with the top's row and count in registers: the
    bits of its tails, its own word and the node below it with its row
    read at the step's start, the ballot of the unmet slots, the last of
    them by 31 - __clz, with no branch: the row of the node it names (the
    top's on an emit) loaded before the step's stores, an emit taking the
    node below at once and setting its bit by a plain store of the word it
    read; the outputs kept and written back."""
    n_cap, p = in_nbr.shape
    cap = tgc.topo_row_cap(n_cap, p) if cap is None else cap
    n = min(int(n_sub), n_cap)
    rows = n if 0 < n <= cap else 0
    ids = in_nbr[:rows].astype(np.uint16)
    deg = np.clip(indeg[:rows], 0, p).astype(np.uint8)
    staged = rows > 0 and not ((in_nbr[:rows] < 0) | (in_nbr[:rows] >= n)).any()

    def load(v):
        if staged:
            return [int(ids[v, k]) if k < p else 0 for k in range(32)], int(deg[v])
        return [int(in_nbr[v, k]) if k < p else 0 for k in range(32)], min(max(int(indeg[v]), 0), p)

    emitted = np.zeros((n_cap + 31) // 32, np.uint32)
    rank_of, rank_to_node, stack = (np.zeros(n_cap, np.int64) for _ in range(3))
    sp = cnt = cursor = v = d = 0
    t = [0] * 32
    while sp > 0 or cnt < n:
        if sp == 0:
            while cursor < n:
                avail = ~int(emitted[cursor >> 5]) & (0xFFFFFFFF << (cursor & 31)) & 0xFFFFFFFF
                if avail:
                    cursor = (cursor & ~31) + _ffs(avail) - 1
                    break
                cursor = (cursor & ~31) + 32
            v = cursor if cursor < n else 0
            t, d = load(v)
            stack[0], sp = v, 1
            continue
        done = [_bit(emitted, x) for x in t]
        ew = int(emitted[v >> 5])
        below = int(stack[sp - 2 if sp > 1 else 0])
        bt, bd = load(below)
        ball = _ballot(k < d and not done[k] for k in range(32))
        push = ball != 0
        w = t[(31 - _clz(ball)) & 31]  # __shfl_sync from the last unmet lane
        wt, wd = load(w if push else v)
        if push:
            stack[min(sp, n_cap - 1)] = w
            sp, v, t, d = sp + 1, w, wt, wd
        else:
            emitted[v >> 5] = np.uint32(ew | (1 << (v & 31)))
            rank_of[v], rank_to_node[min(cnt, n_cap - 1)] = cnt, v
            cnt, sp = cnt + 1, sp - 1
            v, t, d = below, bt, bd
    return rank_of, rank_to_node


def _random_graphs(rng, B, n_cap, e_cap):
    """B random DAGs (edges forward in a random node order, inserted in a
    random order, some nodes isolated) in the edge-list form."""
    tails = np.zeros((B, e_cap), np.int64)
    heads = np.zeros((B, e_cap), np.int64)
    n_nodes = rng.integers(1, n_cap + 1, size=B)
    n_edges = np.zeros(B, np.int64)
    for b in range(B):
        n = int(n_nodes[b])
        rank = rng.permutation(n)
        pairs = {(int(min(rank[i], rank[j])), int(max(rank[i], rank[j])))
                 for i, j in rng.integers(0, n, size=(int(rng.integers(0, e_cap + 1)), 2)) if i != j}
        pairs = [(int(np.flatnonzero(rank == s)[0]), int(np.flatnonzero(rank == t)[0]))
                 for s, t in sorted(pairs)]
        rng.shuffle(pairs)
        pairs = pairs[:e_cap]
        n_edges[b] = len(pairs)
        for k, (s, t) in enumerate(pairs):
            tails[b, k], heads[b, k] = s, t
    return tails, heads, n_nodes, n_edges


@pytest.mark.parametrize("seed", range(6))
def test_warp_models_of_g1_and_g2_equal_the_plain_machines(seed):
    """On random graphs, with adjacency and in-slot rows cut short (A = 3,
    P = 2) and not (A = P = 32): the warp models of both kernels give the
    plain machines' outputs, window by window; G2's with its rows staged
    and read where they lie."""
    rng = np.random.default_rng(100 + seed)
    B, n_cap, e_cap = 6, 48, 120
    tails, heads, n_nodes, n_edges = _random_graphs(rng, B, n_cap, e_cap)
    valid = torch.from_numpy(np.arange(e_cap)[None, :] < n_edges[:, None])
    alive = torch.from_numpy(np.arange(n_cap)[None, :] < n_nodes[:, None])
    t, h = torch.from_numpy(tails), torch.from_numpy(heads)
    comp, root = tgc.select_component(tgc.cc_min_labels(t, h, valid, alive), alive)
    codes = torch.from_numpy(rng.integers(0, 4, size=(B, n_cap)))
    for a_cap, p_cap in ((3, 2), (32, 32)):
        adj, deg, _ = tgc.build_undirected_adjacency(t, h, valid, n_cap, a_cap)
        new_id, order, n_sub = tgc.dfs_preorder(adj, deg, comp, root)
        t2, h2, _, v2, _, _ = tgc.renumber_subgraph(t, h, valid, new_id, order, codes)
        in_nbr, indeg, _, _ = tgc.build_in_slots(t2, h2, v2, n_cap, p_cap)
        rank_of, r2n = tgc.topo_ranks(in_nbr, indeg, n_sub)
        for b in range(B):
            nid, ordr, cnt = g1_warp(_np(adj[b]), _np(deg[b]), _np(comp[b]), int(root[b]))
            assert cnt == int(n_sub[b])
            _eq(nid, new_id[b])
            _eq(ordr, order[b])
            for cap in (None, 0):  # rows staged, and read where they lie
                ro, rn = g2_warp(_np(in_nbr[b]), _np(indeg[b]), int(n_sub[b]), cap)
                _eq(ro, rank_of[b])
                _eq(rn, r2n[b])


def _g2_case(case, rng, B, n_cap):
    """G2's inputs (in_nbr, indeg, n_sub; P = 2 for "deg_past_p", else 16)
    for B windows of an edge case: "empty" (n_sub 0 in every other
    window), "full" (n_sub = N, a random DAG over every node), "chain" (node
    v's one dependency v + 1: the root's walk fills the stack to N), "many_roots"
    (N / 8 edges, most nodes isolated), "deg_past_p" (in-degrees past P),
    "past_n" (n_sub 8 below the graph's nodes, so that tails lie past it:
    G2 then reads every row where it lies)."""
    p_cap = 2 if case == "deg_past_p" else 16
    tails = np.zeros((B, 4 * n_cap), np.int64)
    heads = np.zeros((B, 4 * n_cap), np.int64)
    n_edges = np.zeros(B, np.int64)
    n_sub = np.full(B, n_cap, np.int64)
    for b in range(B):
        if case == "chain":
            pairs = [(v + 1, v) for v in range(n_cap - 1)]
        else:
            m = {"many_roots": n_cap // 8, "deg_past_p": 4 * n_cap}.get(case, 2 * n_cap)
            order = rng.permutation(n_cap)
            pairs = {(int(order[min(i, j)]), int(order[max(i, j)]))
                     for i, j in rng.integers(0, n_cap, size=(m, 2)) if i != j}
            pairs = sorted(pairs)
            rng.shuffle(pairs)
        n_edges[b] = len(pairs)
        if pairs:
            tails[b, : len(pairs)], heads[b, : len(pairs)] = zip(*pairs)
        if case == "empty" and b % 2 == 0:
            n_sub[b] = 0
        if case == "past_n":
            n_sub[b] = n_cap - 8
    valid = torch.from_numpy(np.arange(4 * n_cap)[None, :] < n_edges[:, None])
    in_nbr, indeg, _, _ = tgc.build_in_slots(torch.from_numpy(tails), torch.from_numpy(heads),
                                             valid, n_cap, p_cap)
    return in_nbr, indeg, torch.from_numpy(n_sub)


@pytest.mark.parametrize("case", ["empty", "full", "chain", "many_roots", "deg_past_p", "past_n"])
def test_warp_model_of_g2_on_edge_windows(case):
    """G2's warp model and plain machine against JAX's `topo_ranks` on edge
    windows (`_g2_case`): the model with the window's rows staged, read
    where they lie (a cap of 0) and with the window just past its cap."""
    rng = np.random.default_rng(300 + len(case))
    B, n_cap = 4, 48
    in_nbr, indeg, n_sub = _g2_case(case, rng, B, n_cap)
    got = tgc.topo_ranks(in_nbr, indeg, n_sub)
    want = jgc.topo_ranks(*(jnp.asarray(_np(a).astype(np.int32)) for a in (in_nbr, indeg, n_sub)))
    for w, g in zip(want, got):
        _eq(w, g)
    if case == "deg_past_p":
        assert (_np(indeg) > 2).sum() > B * n_cap // 2
    if case == "past_n":
        assert (_np(in_nbr)[:, : n_cap - 8] >= n_cap - 8).any()
    for b in range(B):
        n = int(n_sub[b])
        for cap in (None, 0, max(n - 1, 0)):
            ro, rn = g2_warp(_np(in_nbr[b]), _np(indeg[b]), n, cap)
            _eq(ro, got[0][b])
            _eq(rn, got[1][b])


@pytest.mark.parametrize("case", ["deg_past_a", "root_outside", "past_slot_cap"])
def test_warp_model_of_g1_on_edge_windows(case):
    """G1's warp model and plain machine against JAX's `dfs_preorder`:
    adjacency rows cut at A = 3 with most degrees past it (the lanes take
    A, the ballot compares against the true degree); roots outside their
    component (order[0] the root, n_sub 0); and dense windows whose slots
    pass dfs_slot_cap (4N), so that the kernel walks the rows where they
    lie (the batch holds windows within it too)."""
    rng = np.random.default_rng(200 + len(case))
    B, n_cap = 6, 48
    e_cap, a_cap = {"deg_past_a": (160, 3), "root_outside": (120, 32),
                    "past_slot_cap": (8 * n_cap, 32)}[case]
    tails, heads, n_nodes, n_edges = _random_graphs(rng, B, n_cap, e_cap)
    if case == "past_slot_cap":
        n_nodes[:] = n_cap
    valid = torch.from_numpy(np.arange(e_cap)[None, :] < n_edges[:, None])
    alive = torch.from_numpy(np.arange(n_cap)[None, :] < n_nodes[:, None])
    t, h = torch.from_numpy(tails), torch.from_numpy(heads)
    comp, root = tgc.select_component(tgc.cc_min_labels(t, h, valid, alive), alive)
    adj, deg, _ = tgc.build_undirected_adjacency(t, h, valid, n_cap, a_cap)
    if case == "root_outside":
        comp[::2, :] = comp[::2, :] & (torch.arange(n_cap)[None, :] != root[::2, None])
    compact = _np(tgc.dfs_compact(deg, a_cap))
    if case == "deg_past_a":
        assert (_np(deg) > a_cap).sum() > B * 4
    # past the cap, some windows still fit: both of the kernel's forms
    assert compact.all() if case != "past_slot_cap" else compact.any() and not compact.all()
    got = tgc.dfs_preorder(adj, deg, comp, root)
    want = jgc.dfs_preorder(*(jnp.asarray(_np(a)) for a in (adj, deg, comp, root)))
    for w, g in zip(want, got):
        _eq(w, g)
    if case == "root_outside":
        assert (_np(got[2])[::2] == 0).all() and (_np(got[1])[::2, 0] == _np(root)[::2]).all()
    for b in range(B):
        nid, ordr, cnt = g1_warp(_np(adj[b]), _np(deg[b]), _np(comp[b]), int(root[b]))
        assert cnt == int(got[2][b])
        _eq(nid, got[0][b])
        _eq(ordr, got[1][b])
