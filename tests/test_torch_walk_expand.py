"""The expansion of the run-length walk's headers to (node id, position)
pairs (`expand_walk_pairs`, plain PyTorch version on the CPU) against the
JAX package's host decode (`runs_to_pairs_np` then `ranks_to_node_ids_np`)
of `poa_align_pallas(..., emit_rle=True)`'s headers in interpret mode, and
on synthetic walks that cross the staged tiles of the CUDA walk every way.
Every quantity is an integer: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_cuda import synthetic_walk_inputs
from test_torch_poa_linear import make_case, pack
from vechat_tpu.ops.kernels import poa_pallas as jpp
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import LinearAligner
from vechat_tpu_torch.ops.kernels import backend as backend_mod
from vechat_tpu_torch.ops.kernels import poa_linear as tpl
from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
from vechat_tpu_torch.ops.poagraph import PoaGraph

MODES = ["nw", "sw", "ov"]


def host_decode(runs, nid, B, D, runs_to_pairs, ranks_to_ids):
    """Per walk, front to back: [(node id, position), ...]."""
    out = []
    for w in range(B * D):
        pn, pp = runs_to_pairs(runs[:, w])
        out.append(list(zip(ranks_to_ids(pn, nid[w // D]).tolist(), pp.tolist())))
    return out


def flat_decode(pairs, offsets, count):
    pairs, offsets, count = pairs.numpy(), offsets.tolist(), count.reshape(-1).tolist()
    return [list(map(tuple, pairs[o : o + c].tolist())) for o, c in zip(offsets, count)]


@pytest.mark.parametrize("ring", [0, 64])
@pytest.mark.parametrize("P", [4, 8, 16])
@pytest.mark.parametrize("mode", MODES)
def test_expand_matches_pallas_host_decode(mode, P, ring):
    """The plain expansion of the port's plain walk equals the JAX host
    decode of the Pallas walk's headers (interpret mode), walk by walk, and
    `poa_align(..., emit_pairs=True)` returns the same pairs."""
    N, W = 128, 128
    D = {4: 3, 8: 1, 16: 8}[P]
    jgraphs, _, seq_lists = make_case(
        100 + 10 * MODES.index(mode) + P + ring, n_graphs=2, depth=4, D=D, base_len=80)
    arrs = pack(jgraphs, seq_lists, N, P, W)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    B = len(jgraphs)
    if ring:
        assert all(jpp.max_pred_distance(preds[b].T, nn[b, 0, 0]) <= ring for b in range(B))
        assert nn.max() > ring
    j_runs, _, j_cnt, _ = jpp.poa_align_pallas(
        *[jnp.asarray(a) for a in arrs], align_type=mode, m=3, x=-5, g=-4,
        interpret=True, ring=ring, emit_node_ids=False, emit_rle=True,
    )
    want = host_decode(np.asarray(j_runs), nid[:, 0], B, D, jpp.runs_to_pairs_np,
                       jpp.ranks_to_node_ids_np)

    args = (codes, preds, sink, nn, seqp, slen, mode, 3, -5, -4)
    runs, steps, count, _ = tpl.poa_align(*args, ring=ring, device="cpu")
    np.testing.assert_array_equal(count.numpy(), np.asarray(j_cnt))
    nid_t = torch.from_numpy(nid.reshape(B, N))
    pairs, offsets = tpl.expand_walk_pairs(runs, steps, count.reshape(B, D), nid_t)
    assert pairs.dtype == torch.int16 and offsets.dtype == torch.int64
    assert pairs.shape == (int(count.sum()), 2)
    assert flat_decode(pairs, offsets, count) == want

    p2, o2, c2, _ = tpl.poa_align(*args, ring=ring, device="cpu", emit_pairs=True, node_id=nid)
    assert torch.equal(p2, pairs) and torch.equal(o2, offsets) and torch.equal(c2, count)


@pytest.mark.parametrize("kind", ["vertical", "horizontal", "diagonal", "random", "runs511"])
@pytest.mark.parametrize("mode", MODES)
def test_expand_synthetic_walks_matches_host_decode(mode, kind):
    """Synthetic walks that leave the CUDA walk's tiles through the top and
    left edges and the corner, take runs of 511 and jump up to 511 rows; walks
    of count 0 (never started, sw stops, ov starts on row or column 0)."""
    B, N1, D, W, P = (2, 600, 3, 576, 8) if kind == "runs511" else (3, 300, 5, 200, 4)
    dirs, maxi, maxj = synthetic_walk_inputs(7 + len(kind), B, N1, D, W, P, kind, mode)
    if kind == "runs511":
        maxi[1:], maxj[1:] = N1 - 1, W - 1
    nid = np.random.default_rng(3).permutation(4095)[: B * (N1 - 1)].reshape(B, N1 - 1)
    nid = nid.astype(np.int32)
    runs, steps, count = tpl.traceback_walk_rle(
        torch.from_numpy(dirs), torch.from_numpy(maxi), torch.from_numpy(maxj), mode,
        N1 - 1 + W, P)
    pairs, offsets = tpl.expand_walk_pairs(runs, steps, count, torch.from_numpy(nid))
    want = host_decode(runs.numpy(), nid, B, D, tpl.runs_to_pairs_np, tpl.ranks_to_node_ids_np)
    assert flat_decode(pairs, offsets, count) == want
    no_pairs = count.reshape(-1)[: 3 if mode == "ov" else 1]
    assert no_pairs.tolist() == [0] * len(no_pairs)
    if kind == "runs511" and mode != "sw":
        assert ((runs.numpy() & 511) == 511).any()


def test_expand_empty_batch_and_walks_without_pairs():
    """B*D = 0, and walks of count 0 beside walks that hold pairs."""
    L = 40
    pairs, offsets = tpl.expand_walk_pairs(
        torch.zeros((L, 0), dtype=torch.int32), 0, torch.zeros((0, 3), dtype=torch.int32),
        torch.zeros((0, 9), dtype=torch.int32))
    assert pairs.shape == (0, 2) and offsets.shape == (0,)
    # walk 1 holds one diagonal run of 3 from (rank 4, position 6) and an
    # insertion at position 3; walks 0 and 2 hold nothing
    runs = torch.zeros((L, 3), dtype=torch.int32)
    runs[0, 1] = ((4 + 2) << tpl.RUN_PN_SHIFT) | ((6 + 2) << tpl.RUN_R_BITS) | 3
    runs[1, 1] = ((-1 + 2) << tpl.RUN_PN_SHIFT) | ((3 + 2) << tpl.RUN_R_BITS) | 1
    nid = torch.arange(100, 109, dtype=torch.int32)[None]
    pairs, offsets = tpl.expand_walk_pairs(runs, 2, torch.tensor([[0, 4, 0]], dtype=torch.int32),
                                           nid)
    assert offsets.tolist() == [0, 0, 4]
    assert pairs.tolist() == [[-1, 3], [102, 4], [103, 5], [104, 6]]


def test_expand_rejects_bad_inputs():
    runs = torch.zeros((10, 4), dtype=torch.int32)
    count = torch.zeros((2, 2), dtype=torch.int32)
    nid = torch.zeros((2, 5), dtype=torch.int32)
    tpl.expand_walk_pairs(runs, 0, count, nid)
    with pytest.raises(ValueError):
        tpl.expand_walk_pairs(runs.to(torch.int64), 0, count, nid)
    with pytest.raises(ValueError):
        tpl.expand_walk_pairs(runs, 0, count.reshape(1, 4), nid)
    with pytest.raises(ValueError):
        tpl.expand_walk_pairs(runs, 11, count, nid)
    with pytest.raises(ValueError):
        tpl.expand_walk_pairs(runs, 0, count, nid[:1])
    runs[0, 3] = (3 << tpl.RUN_PN_SHIFT) | (3 << tpl.RUN_R_BITS) | 2
    with pytest.raises(RuntimeError, match="count"):  # headers hold 2 pairs, count says 0
        tpl.expand_walk_pairs(runs, 1, count, nid)


def disagreeing_headers(case):
    """runs [80, 3] (walk 1: 40 one-pair headers), count [1, 3] and node_id
    [1, 10] whose headers hold as many pairs as `count` ("agree"), more
    (past the count within a chunk of 32 headers, in a later chunk, in a
    walk of count 0) or fewer."""
    runs = torch.zeros((80, 3), dtype=torch.int32)
    runs[:40, 1] = ((3 + 2) << tpl.RUN_PN_SHIFT) | ((5 + 2) << tpl.RUN_R_BITS) | 1
    c = {"agree": 40, "over_in_chunk": 30, "over_after_chunk": 32, "under": 45}.get(case, 40)
    if case == "over_count_0":
        runs[0, 0] = runs[0, 1]
    count = torch.tensor([[0, c, 0]], dtype=torch.int32)
    return runs, count, torch.arange(10, dtype=torch.int32)[None]


@pytest.mark.parametrize("case", ["over_in_chunk", "over_after_chunk", "over_count_0", "under"])
def test_expand_raises_where_headers_and_count_disagree(case):
    runs, count, nid = disagreeing_headers("agree")
    pairs, _ = tpl.expand_walk_pairs(runs, 40, count, nid)
    assert pairs.tolist() == [[3, 5]] * 40
    runs, count, nid = disagreeing_headers(case)
    with pytest.raises(RuntimeError, match="count"):
        tpl.expand_walk_pairs(runs, 40, count, nid)


def test_emit_pairs_needs_the_run_length_walk_and_node_ids():
    jgraphs, _, seq_lists = make_case(0, n_graphs=1, depth=2, D=1, base_len=20)
    codes, preds, sink, nid, nn, seqp, slen = pack(jgraphs, seq_lists, 32, 4, 32)
    args = (codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4)
    with pytest.raises(ValueError, match="emit_pairs"):
        tpl.poa_align(*args, device="cpu", emit_pairs=True)
    with pytest.raises(ValueError, match="emit_pairs"):
        tpl.poa_align(*args, device="cpu", emit_rle=False, emit_pairs=True, node_id=nid)


def test_backend_decodes_without_the_host_decode(monkeypatch):
    """The batched backend's single-shard route takes its pairs from the
    expansion: the host decode helpers are never called, and its alignments
    equal the host oracle's."""

    def refuse(*a, **k):
        raise AssertionError("host decode called")

    for mod in (tpl, backend_mod):
        for name in ("runs_to_pairs_np", "ranks_to_node_ids_np"):
            monkeypatch.setattr(mod, name, refuse, raising=False)
    rng = np.random.default_rng(8)
    base = "".join(rng.choice(list("ACGT"), size=70))
    items = []
    for k in range(2):
        gr = PoaGraph()
        eng = LinearAligner("nw", 3, -5, -4)
        for s in [base, base[:30] + "T" + base[31:], base[:50] + base[52:]]:
            c = encode(s)
            gr.add_alignment(eng.align(c, gr) if gr.num_nodes() else [], c,
                             np.ones(len(c), np.uint32))
        for mode in ("nw", "sw"):
            items.append((encode(base[5 + k : 60]), gr, mode))
    be = TorchAlignerBackend(3, -5, -4, device="cpu")
    got = be.align_batch(items)
    assert be.fallbacks == 0 and be.device_alignments == len(items)
    assert be.t_decode >= be.t_decode_fetch >= 0
    for (codes, gr, mode), aln in zip(items, got):
        assert aln == LinearAligner(mode, 3, -5, -4).align(codes, gr)
