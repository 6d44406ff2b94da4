"""Linear POA DP + run-length walk of the port (plain PyTorch versions on
the CPU) against the JAX package's Pallas kernel in interpret mode and the
host oracles. Every quantity is an integer DP result: the tolerance is
exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vechat_tpu.ops.encode import encode as jax_encode
from vechat_tpu.ops.graph_align import LinearAligner as JaxLinearAligner
from vechat_tpu.ops.kernels import poa_pallas as jpp
from vechat_tpu.ops.kernels.poa_jax import graph_to_dense as jax_graph_to_dense
from vechat_tpu.ops.poagraph import PoaGraph as JaxPoaGraph
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import LinearAligner
from vechat_tpu_torch.ops.kernels import poa_linear as tpl
from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
from vechat_tpu_torch.ops.poagraph import PoaGraph


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, seq, rate=0.12):
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


def build_graphs(seqs):
    """The same sequences through both packages' graph builders."""
    graphs = []
    for graph_cls, aligner_cls, enc in (
        (JaxPoaGraph, JaxLinearAligner, jax_encode),
        (PoaGraph, LinearAligner, encode),
    ):
        eng = aligner_cls("nw", 3, -5, -4)
        gr = graph_cls()
        for s in seqs:
            codes = enc(s)
            aln = eng.align(codes, gr) if gr.num_nodes() else []
            gr.add_alignment(aln, codes, np.ones(len(codes), dtype=np.uint32))
        graphs.append(gr)
    return graphs


def pack(graphs, seq_lists, N, P, W):
    """JAX-layout arrays for B graphs with their D sequences (numpy)."""
    B = len(graphs)
    D = max(len(s) for s in seq_lists)
    codes = np.zeros((B, 1, N), np.int32)
    preds = np.zeros((B, P, N), np.int32)
    sink = np.zeros((B, 1, N), np.int32)
    nid = np.zeros((B, 1, N), np.int32)
    nn = np.zeros((B, 1, 1), np.int32)
    seqp = np.full((B, D, W), 0xFF, np.int32)
    seqp[:, :, 1] = 0  # trivial pad sequence 'A'
    slen = np.ones((B, 1, D), np.int32)
    for b, (gr, seqs) in enumerate(zip(graphs, seq_lists)):
        d = jax_graph_to_dense(gr, N, P)
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


def decode(runs, count, nid, seq_lists, runs_to_pairs, ranks_to_ids):
    """Per (b, d) alignment as (node id, position) pairs."""
    D = count.shape[2]
    out = []
    for b, seqs in enumerate(seq_lists):
        for di in range(len(seqs)):
            pn, pp = runs_to_pairs(runs[:, b * D + di])
            pn = ranks_to_ids(pn, nid[b, 0])
            assert len(pn) == int(count[b, 0, di])
            out.append(list(zip(pn.tolist(), pp.tolist())))
    return out


def make_case(seed, n_graphs, depth, D, base_len):
    rng = np.random.default_rng(seed)
    base = rand_seq(rng, base_len)
    both = [build_graphs([mutate(rng, base) for _ in range(depth)]) for _ in range(n_graphs)]
    seq_lists = [
        [encode(mutate(rng, base)) for _ in range(D)] for _ in range(n_graphs)
    ]
    return [g[0] for g in both], [g[1] for g in both], seq_lists


# mode x ring x P x D: every mode with both ring sizes, P in {4, 8}, D in {1, 3, 8}
CASES = [
    ("nw", 0, 4, 3),
    ("nw", 64, 8, 8),
    ("sw", 64, 8, 1),
    ("sw", 0, 4, 3),
    ("ov", 0, 8, 8),
    ("ov", 64, 4, 1),
]


@pytest.mark.parametrize("mode,ring,P,D", CASES)
def test_plain_kernels_match_pallas_and_host(mode, ring, P, D):
    N, W = 128, 128
    jgraphs, tgraphs, seq_lists = make_case(
        CASES.index((mode, ring, P, D)), n_graphs=2, depth=4, D=D, base_len=80
    )
    arrs = pack(jgraphs, seq_lists, N, P, W)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    if ring:
        # the ring must cover every predecessor distance, and N > ring so
        # the ring actually wraps
        assert all(
            jpp.max_pred_distance(preds[b].T, nn[b, 0, 0]) <= ring for b in range(2)
        )
        assert nn.max() > ring

    j_runs, j_steps, j_cnt, j_score = jpp.poa_align_pallas(
        *[jnp.asarray(a) for a in arrs], align_type=mode, m=3, x=-5, g=-4,
        interpret=True, ring=ring, emit_node_ids=False, emit_rle=True,
    )
    j_runs, j_cnt, j_score = map(np.asarray, (j_runs, j_cnt, j_score))

    t_runs, t_steps, t_cnt, t_score = tpl.poa_align(
        codes, preds, sink, nn, seqp, slen, mode, 3, -5, -4, ring=ring, device="cpu"
    )
    t_runs, t_cnt, t_score = t_runs.numpy(), t_cnt.numpy(), t_score.numpy()

    np.testing.assert_array_equal(t_cnt, j_cnt)
    np.testing.assert_array_equal(t_score, j_score)
    got = decode(t_runs, t_cnt, nid, seq_lists, tpl.runs_to_pairs_np, tpl.ranks_to_node_ids_np)
    want = decode(j_runs, j_cnt, nid, seq_lists, jpp.runs_to_pairs_np, jpp.ranks_to_node_ids_np)
    assert got == want
    # headers past each walk's end are zero; `steps` counts the used rows
    assert t_steps <= int(j_steps) and (t_runs[t_steps:] == 0).all()
    assert (t_runs[t_steps - 1] != 0).any()

    # the port's own host oracle on the port's own graphs
    host = LinearAligner(mode, 3, -5, -4)
    k = 0
    for b, gr in enumerate(tgraphs):
        for di, q in enumerate(seq_lists[b]):
            aln, score = host.align(q, gr, return_score=True)
            assert got[k] == aln, f"b={b} d={di}"
            assert int(t_score[b, 0, di]) == score
            k += 1


def test_plain_kernels_deep_graph():
    """A deep window graph (12 layers, in-degrees past the first tier) in
    sw mode, the local realignment mode of the prune cycle."""
    N, P, W = 256, 8, 128
    jgraphs, tgraphs, seq_lists = make_case(11, n_graphs=1, depth=12, D=3, base_len=100)
    arrs = pack(jgraphs, seq_lists, N, P, W)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    assert (preds[0, 1:] != preds[0, :1]).any(axis=0).sum() > 10  # real in-degree > 1

    j_runs, _, j_cnt, j_score = jpp.poa_align_pallas(
        *[jnp.asarray(a) for a in arrs], align_type="sw", m=3, x=-5, g=-4,
        interpret=True, emit_node_ids=False, emit_rle=True,
    )
    t_runs, _, t_cnt, t_score = tpl.poa_align(
        codes, preds, sink, nn, seqp, slen, "sw", 3, -5, -4, device="cpu"
    )
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_array_equal(t_score.numpy(), np.asarray(j_score))
    got = decode(t_runs.numpy(), t_cnt.numpy(), nid, seq_lists, tpl.runs_to_pairs_np, tpl.ranks_to_node_ids_np)
    want = decode(np.asarray(j_runs), np.asarray(j_cnt), nid, seq_lists, jpp.runs_to_pairs_np, jpp.ranks_to_node_ids_np)
    assert got == want
    host = LinearAligner("sw", 3, -5, -4)
    for di, q in enumerate(seq_lists[0]):
        assert got[di] == host.align(q, tgraphs[0])


@pytest.mark.parametrize("seed", range(3))
def test_dense_pack_matches_jax(seed):
    """graph_to_dense, max_pred_distance and fits_int16 of the port equal
    the JAX package's on the same graphs."""
    jgraphs, tgraphs, _ = make_case(seed, n_graphs=1, depth=3 + seed, D=1, base_len=40)
    for P in (4, 8):
        dj = jax_graph_to_dense(jgraphs[0], 64, P)
        dt = graph_to_dense(tgraphs[0], 64, P)
        assert dj.keys() == dt.keys()
        for k in dj:
            np.testing.assert_array_equal(np.asarray(dt[k]), np.asarray(dj[k]), err_msg=k)
        assert tpl.max_pred_distance(dt["preds"], dt["n_nodes"]) == jpp.max_pred_distance(
            dj["preds"], dj["n_nodes"]
        )
    for n_cap, w_cap, m, x, g in [(640, 576, 3, -5, -4), (2048, 768, 5, -4, -8), (4095, 8, 1, -1, -1)]:
        assert tpl.fits_int16(n_cap, w_cap, m, x, g) == jpp.fits_int16(n_cap, w_cap, m, x, g)


@pytest.mark.parametrize("P", [2, 4, 8, 16])
def test_code_fields_match_jax(P):
    assert tpl.sh_bits(P) == jpp._sh_bits(P)
    assert tpl.markers(P) == jpp._markers(P)


def test_runs_to_pairs_matches_jax():
    rng = np.random.default_rng(5)
    r = rng.integers(0, 40, size=200)
    pn0 = rng.integers(-1, 1500, size=200)
    pp0 = rng.integers(-1, 700, size=200)
    runs = ((pn0 + 2) << tpl.RUN_PN_SHIFT) | ((pp0 + 2) << tpl.RUN_R_BITS) | r
    runs = runs.astype(np.int32)
    a = tpl.runs_to_pairs_np(runs)
    b = jpp.runs_to_pairs_np(runs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_plain_dp_rejects_bad_inputs():
    aux = torch.zeros((1, 4, 8), dtype=torch.int32)
    ok = dict(
        codes=torch.zeros((1, 8), dtype=torch.int32),
        aux=aux,
        deg=torch.ones((1, 8), dtype=torch.int32),
        sink=torch.ones((1, 8), dtype=torch.int32),
        n_nodes=torch.ones(1, dtype=torch.int32),
        seqp=torch.zeros((1, 2, 32), dtype=torch.int32),
        slen=torch.ones((1, 2), dtype=torch.int32),
    )
    with pytest.raises(ValueError):
        tpl.poa_dp(**{**ok, "seqp": ok["seqp"].to(torch.int64)}, align_type="nw", m=3, x=-5, g=-4, R=8)
    with pytest.raises(ValueError):
        tpl.poa_dp(**{**ok, "slen": torch.ones((1, 3), dtype=torch.int32)}, align_type="nw", m=3, x=-5, g=-4, R=8)
    with pytest.raises(ValueError):
        tpl.poa_dp(**ok, align_type="nw", m=3, x=-5, g=-4, R=512)


def test_poa_align_defaults_to_the_card(monkeypatch):
    """Left without `device`, poa_align runs on the card: without a GPU it
    raises instead of taking the plain CPU version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jgraphs, _, seq_lists = make_case(0, n_graphs=1, depth=2, D=1, base_len=20)
    codes, preds, sink, nid, nn, seqp, slen = pack(jgraphs, seq_lists, 32, 4, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.poa_align(codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4)
