"""The CUDA kernels of the port against their plain PyTorch versions on the
same inputs, on the card. Exact equality: every output is an integer DP
result. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed; tests/conftest.py imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.kernels import _build
from vechat_tpu_torch.ops.kernels import graph_build as gb
from vechat_tpu_torch.ops.kernels import graph_consensus as gcs
from vechat_tpu_torch.ops.kernels import graph_cycle as gc
from vechat_tpu_torch.ops.kernels import pairwise_nw as pw
from vechat_tpu_torch.ops.kernels import poa_affine as pa
from vechat_tpu_torch.ops.kernels import poa_convex as pc
from vechat_tpu_torch.ops.kernels import poa_linear as pl
from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend, pack_windows
from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
from vechat_tpu_torch.ops.native_graph import make_graph

# from the test directory, which pytest puts on sys.path (it holds no
# __init__.py): a `tests` package installed elsewhere may shadow `tests.`
from graph_build_cases import at_the_edge_cap, chain_bundle_windows, with_duplicate_edges

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


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


def windows(seed, B, N, P, W, D, depth=6, base_len=100):
    """B native window graphs with D sequences each, in the JAX layout,
    plus the graphs and sequences themselves."""
    rng = np.random.default_rng(seed)
    packed, graphs = [], []
    while len(packed) < B:
        base = rand_seq(rng, base_len)
        g = make_graph()
        for s in [mutate(rng, base) for _ in range(depth)]:
            c = encode(s)
            aln = g.align_host(c, "nw", 3, -5, -4) if g.num_nodes() else []
            g.add_alignment(aln, c, np.ones(len(c), np.uint32))
        d = graph_to_dense(g, N, P)
        if d is None:
            continue
        seqs = [encode(mutate(rng, base))[: W - 1] for _ in range(D)]
        packed.append((d, seqs))
        graphs.append(g)
    return pack_windows(packed, N, P, W), graphs, [s for _, s in packed]


def _tensors(arrs, device, B, N, D):
    codes, preds, sink, nid, nn, seqp, slen = (torch.from_numpy(a).to(device) for a in arrs)
    return codes.reshape(B, N), preds, sink.reshape(B, N), nn.reshape(B), seqp, slen.reshape(B, D)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("ring", [64, 0])
def test_poa_dp_and_walk_match_plain(cuda, mode, ring):
    B, N, P, W, D = 3, 256, 8, 128, 5
    arrs, _, _ = windows(1, B, N, P, W, D)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    R = ring or N
    aux, deg = pl.pack_aux(preds, R)
    args = (codes, aux, deg, sink, nn, seqp, slen, mode, 3, -5, -4, R)
    before = _build.LAUNCHES["poa_dp"]
    k = pl.poa_dp(*args)
    assert _build.LAUNCHES["poa_dp"] == before + 1
    p = pl._dp_plain(*args)
    real = torch.arange(N + 1, device=cuda)[None, :] <= nn[:, None]
    assert torch.equal(k[0][real], p[0][real])
    for a, b in zip(k[1:], p[1:]):
        assert torch.equal(a, b)
    kr, ks, kc = pl.traceback_walk_rle(k[0], k[1], k[2], mode, N + W, P)
    pr, ps, pc = pl._walk_plain(k[0], k[1], k[2], mode, N + W, P)
    assert ks == ps and torch.equal(kr[:ks], pr[:ps]) and torch.equal(kc, pc)


def dag_windows(seed, B, N, P, W, D, max_dist):
    """K1's inputs for B random rank-ordered DAGs (numpy, from `seed`): up
    to P in-edges a node, each from one of the `max_dist` rows above it,
    n_nodes < N, and D random sequences whose lengths include 1 and W-1."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, N)).astype(np.int32)
    preds = np.zeros((B, P, N), np.int32)
    sink = (rng.random((B, N)) < 0.2).astype(np.int32)
    nn = rng.integers(N // 2, N, B).astype(np.int32)
    for b in range(B):
        for r in range(N):
            cand = np.arange(max(0, r + 1 - max_dist), r + 1)
            ps = rng.choice(cand, size=int(rng.integers(1, min(P, len(cand)) + 1)), replace=False)
            preds[b, :, r] = ps[0]  # padding repeats slot 0
            preds[b, : len(ps), r] = ps
    slen = rng.integers(1, W, (B, D)).astype(np.int32)
    slen.flat[0], slen.flat[-1] = 1, W - 1
    seqp = np.full((B, D, W), 0xFF, np.int32)
    for b in range(B):
        for d in range(D):
            seqp[b, d, 1 : 1 + slen[b, d]] = rng.integers(0, 4, slen[b, d])
    return codes, preds, sink, nn, seqp, slen


def _k1_equals_plain(device, arrays, mode, R, smem):
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(a).to(device) for a in arrays)
    B, P, N = preds.shape
    D, W = seqp.shape[1:]
    assert pl.dp_launch_plan(B, D, W, R, P)["use_smem"] == smem
    aux, deg = pl.pack_aux(preds, R)
    args = (codes, aux, deg, sink, nn, seqp, slen, mode, 3, -5, -4, R)
    before = _build.LAUNCHES["poa_dp"]
    k = pl.poa_dp(*args)
    assert _build.LAUNCHES["poa_dp"] == before + 1
    p = pl._dp_plain(*args)
    real = torch.arange(N + 1, device=device)[None, :] <= nn[:, None]
    assert torch.equal(k[0][real], p[0][real])
    for name, a, b in zip(("maxi", "maxj", "score"), k[1:], p[1:]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("P", [4, 8, 16])
@pytest.mark.parametrize("W", [128, 320, 576, 768])
@pytest.mark.parametrize("smem", [True, False])
def test_poa_dp_buckets_match_plain(cuda, mode, P, W, smem):
    """K1 at every W and P bucket and mode, its ring in shared memory (12
    rows) and in global memory (511), against its plain version: B*D = 15
    and D = 5 are no multiple of a block's 4 warps, n_nodes < N, sequences
    of length 1 and W-1."""
    arrays = dag_windows(W + P + len(mode), 3, 192, P, W, 5, 12 if smem else 200)
    _k1_equals_plain(cuda, arrays, mode, 12 if smem else 511, smem)


@pytest.mark.parametrize("W,R,smem", [(128, 511, True), (576, 511, False), (96, 40, True),
                                      (32, 511, True), (1024, 64, True), (1024, 300, False)])
def test_poa_dp_one_window_one_sequence_matches_plain(cuda, W, R, smem):
    """B = D = 1 (the spoa path's launches), also at widths outside the
    buckets (lane counts not among the kernel's own instantiations), and
    in-degrees past the 16 slots fetched ahead (P = 20)."""
    for mode in ("nw", "sw", "ov"):
        arrays = dag_windows(W + R, 1, 160, 20, W, 1, min(R, 150))
        _k1_equals_plain(cuda, arrays, mode, R, smem)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("node_ids", [False, True])
def test_dense_walk_matches_plain_and_rle(cuda, mode, node_ids):
    """The dense walk kernel against its plain version, whole buffers with
    their -2 padding, and its pairs against the run-length walk's expanded."""
    B, N, P, W, D = 3, 256, 8, 128, 5
    arrs, _, _ = windows(12, B, N, P, W, D)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    nid = torch.from_numpy(arrs[3]).to(cuda).reshape(B, N) if node_ids else None
    aux, deg = pl.pack_aux(preds, 64)
    dirs, maxi, maxj, _ = pl.poa_dp(codes, aux, deg, sink, nn, seqp, slen, mode, 3, -5, -4, 64)
    L = N + W
    before = _build.LAUNCHES["poa_walk_dense"]
    k = pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P, nid)
    assert _build.LAUNCHES["poa_walk_dense"] == before + 1
    p = pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P, nid)
    for name, a, b in zip(("pn", "pp", "count"), k, p):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    runs, steps, r_count = pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P)
    assert torch.equal(k[2], r_count)
    runs, pn, pp, count = runs[:steps].cpu().numpy(), k[0].cpu().numpy(), k[1].cpu().numpy(), k[2].cpu()
    for b in range(B):
        for d in range(D):
            c = int(count[b, d])
            rn, rp = pl.runs_to_pairs_np(runs[:, b * D + d])
            if node_ids:
                rn = pl.ranks_to_node_ids_np(rn, arrs[3][b, 0])
            assert (pn[b, d, L - c:] == rn).all() and (pp[b, d, L - c:] == rp).all()
            assert (pn[b, d, : L - c] == -2).all() and (pp[b, d, : L - c] == -2).all()


def test_dense_walk_empty_and_wrong_inputs(cuda):
    """No walk starts at (0, 0): count 0 and the whole buffer -2."""
    dirs = torch.zeros((2, 9, 3, 32), dtype=torch.int16, device=cuda)
    mx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    pn, pp, count = pl.traceback_walk_dense(dirs, mx, mx, "sw", 40, 4)
    assert int(count.abs().sum()) == 0 and bool((pn == -2).all()) and bool((pp == -2).all())
    with pytest.raises(ValueError):
        pl.traceback_walk_dense(dirs, mx.cpu(), mx, "sw", 40, 4)
    with pytest.raises(ValueError):
        pl.traceback_walk_dense(dirs.to(torch.int32), mx, mx, "sw", 40, 4)


def synthetic_walk_inputs(seed, B, N1, D, W, P, kind, mode):
    """Direction codes [B, N1, D, W] int16 whose walks move as `kind` says,
    and start cells maxi, maxj [B, D] int32 (numpy, from `seed`): vertical
    (up the column: out of a tile through its top edge), horizontal (along
    the row: its left edge), diagonal (its corner), runs511 (diagonal runs of
    511 where they fit), random (every move and run, predecessors up to 511
    rows back). Every move lowers i + j; column 0 moves up; row 0 is the
    boundary (nw: horizontal, sw: stop); sw cells stop at random. One walk
    starts at (0, 0) and, in ov, one on row 0 and one on column 0."""
    rng = np.random.default_rng(seed)
    marker_d, marker_v = pl.markers(P)
    shape = (B, N1, D, W)
    i = np.broadcast_to(np.arange(N1)[None, :, None, None], shape)
    j = np.broadcast_to(np.arange(W)[None, None, None, :], shape)
    reach = np.minimum(i, 511)  # the longest row step from row i
    dprio = P + 2 + rng.integers(0, P, shape)
    vprio = 2 + rng.integers(0, P, shape)
    delta = np.where(rng.random(shape) < 0.7, 1, (rng.random(shape) * (reach + 1)).astype(np.int64))
    if kind == "vertical":
        code = (vprio << 9) | 1
    elif kind == "horizontal":
        code = np.full(shape, 1 << 9)
    elif kind == "diagonal":
        code = (dprio << 9) | 1
    elif kind == "runs511":
        code = np.where(np.minimum(i, j) >= 511, (marker_d << 9) | 511, (dprio << 9) | 1)
    elif kind == "moves":  # random as below, without run markers
        pick = rng.integers(0, 3, shape)
        code = np.select([pick == 0, pick == 1], [(dprio << 9) | delta, (vprio << 9) | delta],
                         np.full(shape, 1 << 9))
    else:
        run_d = 1 + (rng.random(shape) * np.minimum(reach, j)).astype(np.int64)
        run_v = 1 + (rng.random(shape) * reach).astype(np.int64)
        pick = rng.integers(0, 5, shape)
        code = np.select(
            [pick == 0, pick == 1, pick == 2, pick == 3],
            [(dprio << 9) | delta, (vprio << 9) | delta, np.full(shape, 1 << 9),
             (marker_d << 9) | np.minimum(run_d, 511)],
            (marker_v << 9) | np.minimum(run_v, 511))
    code = np.where(j == 0, (vprio << 9) | delta, code)
    if mode == "sw":
        code = np.where(rng.random(shape) < 0.01, 0, code)
    code = np.where(i == 0, 0 if mode == "sw" else 1 << 9, code)
    maxi = rng.integers(0, N1, (B, D))
    maxj = rng.integers(0, W, (B, D))
    maxi.flat[0] = maxj.flat[0] = 0
    if mode == "ov":
        maxi.flat[1] = 0
        maxj.flat[2] = 0
    return code.astype(np.int16), maxi.astype(np.int32), maxj.astype(np.int32)


def k1_marked(code, P):
    """Synthetic direction codes without run markers [B, N1, D, W] with the
    markers K1 writes (`_dp_plain`): a diagonal (vertical) delta-1 move gets
    MARKER_D (MARKER_V) and the length of the chain of such moves ending
    there, clamped at 511, a diagonal chain going on one row up and one lane
    left (the lane wrapping as K1's roll does), a vertical one in the same
    lane. Codes the dense walk may take a marker's whole run from."""
    marker_d, marker_v = pl.markers(P)
    out = code.astype(np.int32)
    B, N1, D, W = code.shape
    rld = np.zeros((B, D, W), np.int32)
    rlv = np.zeros((B, D, W), np.int32)
    for i in range(1, N1):
        c = out[:, i]
        unit = (c & 511) == 1
        isd1 = unit & (c >= (P + 2) << 9)
        isv1 = unit & (c >= 2 << 9) & ~isd1
        rld = np.where(isd1, np.minimum(np.roll(rld, 1, axis=2) + 1, 511), 0)
        rlv = np.where(isv1, np.minimum(rlv + 1, 511), 0)
        out[:, i] = np.where(isd1, (marker_d << 9) | rld, np.where(isv1, (marker_v << 9) | rlv, c))
    return out.astype(np.int16)


def max_row_jump(runs, steps):
    """The longest row step between two consecutive single-pair headers of
    any walk whose pairs both name a row (runs [L, B*D] numpy)."""
    h = runs[:steps].astype(np.int64)
    pn0 = (h >> pl.RUN_PN_SHIFT) - 2
    single = (h & ((1 << pl.RUN_R_BITS) - 1)) == 1
    both = single[:-1] & (pn0[:-1] >= 0) & (pn0[1:] >= 0)
    return int(np.where(both, pn0[:-1] - pn0[1:], 0).max(initial=0))


def _walk_and_expand_equal_plain(dirs, maxi, maxj, nid, mode, P):
    """K2 and the expansion against their plain versions, exact: all of
    runs, steps, count, pairs and offsets. Returns the plain walk."""
    B, N1, D, W = dirs.shape
    L = N1 - 1 + W
    before = dict(_build.LAUNCHES)
    kr, ks, kc = pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P)
    assert _build.LAUNCHES["poa_walk"] == before["poa_walk"] + (B * D > 0)
    pr, ps, pc = pl._walk_plain(dirs, maxi, maxj, mode, L, P)
    assert ks == ps and torch.equal(kr, pr) and torch.equal(kc, pc)
    kp, ko = pl.expand_walk_pairs(kr, ks, kc, nid)
    pp, po = pl._expand_plain(pr, ps, pc, nid)
    assert _build.LAUNCHES["poa_expand"] == before["poa_expand"] + (pp.shape[0] > 0)
    assert kp.dtype == pp.dtype and torch.equal(kp, pp) and torch.equal(ko, po)
    return pr, ps, pc


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("kind", ["vertical", "horizontal", "diagonal", "random", "runs511"])
def test_walk_tiles_and_expansion_match_plain(cuda, mode, kind):
    """Walks that leave the staged tile through its top edge, its left edge
    and its corner, take runs of 511 and jump to predecessors up to 511
    rows back, on synthetic direction codes; B*D = 15 and 6 are no multiple
    of a block's 4 walks; sw walks that stop at random cells, ov walks that
    start on row 0 or column 0."""
    B, N1, D, W, P = (2, 600, 3, 576, 8) if kind == "runs511" else (3, 300, 5, 200, 4)
    dirs, maxi, maxj = synthetic_walk_inputs(
        ["vertical", "horizontal", "diagonal", "random", "runs511"].index(kind), B, N1, D, W,
        P, kind, mode)
    if kind == "runs511":
        maxi[1:], maxj[1:] = N1 - 1, W - 1
    nid = np.random.default_rng(1).permutation(4095)[: N1 - 1].astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    pr, ps, pc = _walk_and_expand_equal_plain(t(dirs), t(maxi), t(maxj), t(np.tile(nid, (B, 1))),
                                              mode, P)
    runs = pr.cpu().numpy()
    if kind == "random" and mode == "nw":
        assert max_row_jump(runs, ps) > 64  # past a tile's 64 rows
    if kind == "runs511" and mode != "sw":
        assert ((runs & 511) == 511).any()


@pytest.mark.parametrize("W", [8, 40, 96])
def test_walk_rows_narrower_than_a_tile_match_plain(cuda, W):
    """Rows of fewer than a tile's 64 columns, and of a width no multiple of
    64: the tile's pieces past the row's end are not copied."""
    for mode in ("nw", "sw", "ov"):
        dirs, maxi, maxj = synthetic_walk_inputs(W, 2, 150, 3, W, 4, "random", mode)
        nid = torch.arange(2 * 149, dtype=torch.int32, device=cuda).reshape(2, 149)
        t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
        _walk_and_expand_equal_plain(t(dirs), t(maxi), t(maxj), nid, mode, 4)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_walk_predecessor_jumps_of_ring_511_graphs_match_plain(cuda, mode):
    """K1 on random DAGs whose in-edges reach 200 rows back (ring 511, in
    global memory), then K2 and the expansion against their plain versions;
    in nw some walk steps more than a tile's 64 rows at once."""
    arrays = dag_windows(40 + len(mode), 3, 300, 8, 128, 5, 200)
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(a).to(cuda) for a in arrays)
    aux, deg = pl.pack_aux(preds, 511)
    dirs, maxi, maxj, _ = pl.poa_dp(codes, aux, deg, sink, nn, seqp, slen, mode, 3, -5, -4, 511)
    nid = torch.from_numpy(np.random.default_rng(2).integers(0, 4000, (3, 300), dtype=np.int32))
    pr, ps, _ = _walk_and_expand_equal_plain(dirs, maxi, maxj, nid.to(cuda), mode, 8)
    if mode == "nw":
        assert max_row_jump(pr.cpu().numpy(), ps) > 64


def test_walk_first_cell_stops_and_empty_batches(cuda):
    """sw walks that stop at their first cell and ov walks that start on row
    0 or column 0 hold no pair; B*D = 0 launches nothing."""
    B, N1, D, W, P = 2, 40, 3, 64, 4
    dirs = torch.zeros((B, N1, D, W), dtype=torch.int16, device=cuda)
    start = torch.tensor([[5, 9, 39], [1, 2, 3]], dtype=torch.int32, device=cuda)
    nid = torch.zeros((B, N1 - 1), dtype=torch.int32, device=cuda)
    _, ps, pc = _walk_and_expand_equal_plain(dirs, start, start + 7, nid, "sw", P)
    assert ps == 0 and int(pc.sum()) == 0
    zero = torch.zeros_like(start)
    for mi, mj in ((zero, start), (start, zero)):
        dirs.fill_((P + 2) << 9 | 1)  # diagonal
        _, ps, pc = _walk_and_expand_equal_plain(dirs, mi, mj, nid, "ov", P)
        assert ps == 0 and int(pc.sum()) == 0
    empty = torch.zeros((0, N1, D, W), dtype=torch.int16, device=cuda)
    mx = torch.zeros((0, D), dtype=torch.int32, device=cuda)
    _walk_and_expand_equal_plain(empty, mx, mx, nid[:0], "nw", P)
    with pytest.raises(ValueError, match="16-byte"):
        pl.traceback_walk_rle(dirs[..., :60].contiguous(), start, start, "nw", N1 + 60, P)


@pytest.mark.parametrize("case", ["agree", "over_in_chunk", "over_after_chunk", "over_count_0",
                                  "under"])
def test_expansion_raises_where_headers_and_count_disagree(cuda, case):
    """Headers that hold more pairs than `count` (past it within a chunk of
    32 headers, in a later chunk, in a walk of count 0) or fewer raise on
    the card as in the plain version; headers that agree expand alike."""
    runs = torch.zeros((80, 3), dtype=torch.int32)
    runs[:40, 1] = ((3 + 2) << pl.RUN_PN_SHIFT) | ((5 + 2) << pl.RUN_R_BITS) | 1
    c = {"agree": 40, "over_in_chunk": 30, "over_after_chunk": 32, "under": 45}.get(case, 40)
    if case == "over_count_0":
        runs[0, 0] = runs[0, 1]
    count = torch.tensor([[0, c, 0]], dtype=torch.int32)
    nid = torch.arange(10, dtype=torch.int32)[None]
    args = [(runs, 40, count, nid), (runs.to(cuda), 40, count.to(cuda), nid.to(cuda))]
    if case == "agree":
        (pp, po), (kp, ko) = (pl.expand_walk_pairs(*a) for a in args)
        assert torch.equal(kp.cpu(), pp) and torch.equal(ko.cpu(), po)
        return
    for a in args:
        with pytest.raises(RuntimeError, match="count"):
            pl.expand_walk_pairs(*a)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_walk_and_expansion_at_phase_1_shape_match_plain(cuda, mode):
    """chip_smoke.py's phase 1 shape: 16 window graphs, N=640, W=576, D=32,
    P=8, the backend's ring (the largest predecessor distance) and 511."""
    B, N, P, W, D = 16, 640, 8, 576, 32
    arrs, _, _ = windows(21, B, N, P, W, D, depth=6, base_len=400)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    nid = torch.from_numpy(arrs[3]).to(cuda).reshape(B, N)
    dist = max(pl.max_pred_distance(arrs[1][b].T, arrs[4][b, 0, 0]) for b in range(B))
    for ring in (max(1, dist), 511):
        aux, deg = pl.pack_aux(preds, ring)
        dirs, maxi, maxj, _ = pl.poa_dp(codes, aux, deg, sink, nn, seqp, slen, mode, 3, -5, -4,
                                        ring)
        _walk_and_expand_equal_plain(dirs, maxi, maxj, nid, mode, P)


def _dense_equal_plain(dirs, maxi, maxj, nid, mode, L, P):
    """The dense walk kernel against its plain version, whole buffers (the
    -2 columns included), exact; one launch unless B*D is 0. Returns the
    plain walk's (pn, pp, count)."""
    B, N1, D, W = dirs.shape
    before = _build.LAUNCHES["poa_walk_dense"]
    k = pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P, nid)
    assert _build.LAUNCHES["poa_walk_dense"] == before + (B * D > 0)
    p = pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P, nid)
    for name, a, b in zip(("pn", "pp", "count"), k, p):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
    return p


DENSE_KINDS = ["vertical", "horizontal", "diagonal", "moves", "runs511"]


@pytest.mark.parametrize("node_ids", [False, True])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("kind", DENSE_KINDS)
def test_dense_walk_kernel_tiles_and_runs_match_plain(cuda, kind, mode, node_ids):
    """The dense walk on synthetic codes marked as K1 marks them: walks out
    of the staged tile through its top edge (vertical runs), its left edge
    (horizontal moves) and its corner (diagonal runs), runs of 511 across
    tiles, jumps to predecessors up to 299 rows back (moves); B*D = 15 and 6
    are no multiple of a block's 4 walks; sw walks that stop at random
    cells, ov walks that start on row 0 or column 0; ranks or node ids."""
    B, N1, D, W, P = (2, 600, 3, 576, 8) if kind == "runs511" else (3, 300, 5, 200, 4)
    dirs, maxi, maxj = synthetic_walk_inputs(
        50 + DENSE_KINDS.index(kind), B, N1, D, W, P,
        "diagonal" if kind == "runs511" else kind, mode)
    if kind == "runs511":
        maxi[1:], maxj[1:] = N1 - 1, W - 1
    dirs = k1_marked(dirs, P)
    nid = np.random.default_rng(3).permutation(4095)[: N1 - 1].astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    dirs, maxi, maxj = t(dirs), t(maxi), t(maxj)
    L = N1 - 1 + W
    _dense_equal_plain(dirs, maxi, maxj, t(np.tile(nid, (B, 1))) if node_ids else None, mode, L, P)
    runs, steps, _ = pl._walk_plain(dirs, maxi, maxj, mode, L, P)
    runs = runs[:steps].cpu().numpy()
    if kind == "runs511" and mode != "sw":
        assert ((runs & 511) == 511).any()
    if kind == "moves" and mode == "nw":
        assert max_row_jump(runs, steps) > 64  # past a tile's 64 rows


@pytest.mark.parametrize("kind", ["diagonal", "vertical"])
@pytest.mark.parametrize("L", [1, 37, 100, 260])
def test_dense_walk_kernel_cut_inside_a_run_matches_plain(cuda, kind, L):
    """L below the walks' lengths: the kernel cuts the run it is in where
    the walk reaches L pairs and reports count L, as the unit walk of the
    plain version stops; some walk's cut falls inside a run."""
    B, N1, D, W, P = 2, 600, 3, 576, 8
    dirs, maxi, maxj = synthetic_walk_inputs(60, B, N1, D, W, P, kind, "nw")
    maxi[:], maxj[:] = N1 - 1, W - 1 - np.arange(B * D).reshape(B, D)
    dirs = torch.from_numpy(k1_marked(dirs, P)).to(cuda)
    maxi, maxj = torch.from_numpy(maxi).to(cuda), torch.from_numpy(maxj).to(cuda)
    pn, pp, count = _dense_equal_plain(dirs, maxi, maxj, None, "nw", L, P)
    assert bool((count == L).all())
    runs, steps, _ = pl._walk_plain(dirs, maxi, maxj, "nw", N1 - 1 + W, P)
    ends = np.cumsum(runs[:steps].cpu().numpy() & 511, axis=0)  # pairs after each header
    assert (~(ends == L).any(axis=0)).any()  # some walk's cut falls inside a run


@pytest.mark.parametrize("B,D", [(0, 3), (1, 1), (1, 5), (2, 5)])
def test_dense_walk_kernel_batch_sizes_match_plain(cuda, B, D):
    """B*D of 0 (nothing launched), 1 (one warp of a block's 4) and 5, 10
    (spare warps that leave)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    for mode in ("nw", "sw", "ov"):
        for node_ids in (False, True):
            # walks 3.. of a larger draw: the first three start on the edges
            dirs, maxi, maxj = synthetic_walk_inputs(B * 10 + D, max(B, 1), 150, D + 3, 64, 4,
                                                     "moves", mode)
            dirs, maxi, maxj = k1_marked(dirs, 4)[:B, :, 3:], maxi[:B, 3:], maxj[:B, 3:]
            nid = t(np.arange(B * 149, dtype=np.int32).reshape(B, 149)) if node_ids else None
            _dense_equal_plain(t(dirs), t(maxi), t(maxj), nid, mode, 149 + 64, 4)


def test_dense_walk_kernel_first_cell_stops_and_edges(cuda):
    """sw walks that stop at their first cell and ov walks that start on
    row 0 or column 0 hold no pair: count 0 and both rows -2 whole."""
    B, N1, D, W, P = 2, 40, 3, 64, 4
    dirs = torch.zeros((B, N1, D, W), dtype=torch.int16, device=cuda)
    start = torch.tensor([[5, 9, 39], [1, 2, 3]], dtype=torch.int32, device=cuda)
    nid = torch.zeros((B, N1 - 1), dtype=torch.int32, device=cuda)
    for L in (N1 - 1 + W, 61):
        pn, pp, count = _dense_equal_plain(dirs, start, start + 7, nid, "sw", L, P)
        assert int(count.sum()) == 0 and bool((pn == -2).all()) and bool((pp == -2).all())
    zero = torch.zeros_like(start)
    dirs.fill_((P + 2) << 9 | 2)  # diagonal, two rows up: no run marker
    for mi, mj in ((zero, start), (start, zero)):
        _, _, count = _dense_equal_plain(dirs, mi, mj, None, "ov", N1 - 1 + W, P)
        assert int(count.sum()) == 0


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_dense_walk_kernel_at_a_5a_shard_matches_plain(cuda, mode):
    """A shard of chip_smoke.py's phase 5a: 28 window graphs, N=640, W=576,
    D=38, P=4, ring 221, K1's codes; node ids as the sharded route asks."""
    B, N, P, W, D = 28, 640, 4, 576, 38
    arrs, _, _ = windows(22, B, N, P, W, D, depth=6, base_len=400)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    nid = torch.from_numpy(arrs[3]).to(cuda).reshape(B, N)
    aux, deg = pl.pack_aux(preds, 221)
    dirs, maxi, maxj, _ = pl.poa_dp(codes, aux, deg, sink, nn, seqp, slen, mode, 3, -5, -4, 221)
    for node_id in (nid, None):
        _, _, count = _dense_equal_plain(dirs, maxi, maxj, node_id, mode, N + W, P)
    assert int(count.min()) > 0


def test_dense_walk_kernel_raises_on_rows_off_16_bytes(cuda):
    """Rows of a width no multiple of 8, or codes not on a 16-byte boundary:
    the wrapper raises, and so does the launcher under it; no kernel runs."""
    B, N1, D, W, P = 1, 20, 2, 64, 4
    mx = torch.ones((B, D), dtype=torch.int32, device=cuda)
    dirs = torch.zeros((B, N1, D, W), dtype=torch.int16, device=cuda)
    buf = torch.zeros(B * N1 * D * W + 8, dtype=torch.int16, device=cuda)
    off = buf[1 : 1 + dirs.numel()].view(B, N1, D, W)
    assert off.is_contiguous() and off.data_ptr() % 16
    before = _build.LAUNCHES["poa_walk_dense"]
    with pytest.raises(ValueError, match="16-byte"):
        pl.traceback_walk_dense(dirs[..., :60].contiguous(), mx, mx, "nw", N1 + 59, P)
    with pytest.raises(ValueError, match="16-byte"):
        pl.traceback_walk_dense(off, mx, mx, "nw", N1 - 1 + W, P)
    pn = torch.empty((B, D, N1 - 1 + W), dtype=torch.int16, device=cuda)
    count = torch.empty((B, D), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        pl.launch_walk_dense(off, mx, mx, None, pn, pn.clone(), count, "nw", N1 - 1 + W, P)
    assert _build.LAUNCHES["poa_walk_dense"] == before


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_callable_on_one_card(cuda, n_shards):
    """Shards of one batch on streams of one card: what the unsharded call
    gives, and both walks launched once a shard."""
    from vechat_tpu_torch.parallel.mesh import make_mesh, sharded_poa_align_cuda

    B, N, P, W, D = 6, 256, 8, 128, 4
    arrs, _, _ = windows(13, B, N, P, W, D)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    fn = sharded_poa_align_cuda(make_mesh(["cuda:0"] * n_shards), "nw", 3, -5, -4, ring=64)
    before = dict(_build.LAUNCHES)
    got = fn(*arrs)
    assert _build.LAUNCHES["poa_dp"] == before["poa_dp"] + n_shards
    assert _build.LAUNCHES["poa_walk_dense"] == before["poa_walk_dense"] + n_shards
    assert _build.LAUNCHES["poa_walk"] == before["poa_walk"]
    one = pl.poa_align(codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4, ring=64,
                       device=cuda, emit_rle=False, emit_node_ids=True, node_id=nid)
    cpu = pl.poa_align(codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4, ring=64,
                       device="cpu", emit_rle=False, emit_node_ids=True, node_id=nid)
    for g, o, c in zip(got, one, cpu):
        assert g.device.type == "cpu" and torch.equal(g, o.cpu()) and torch.equal(g, c)


def test_sharded_backend_matches_host(cuda):
    rng = np.random.default_rng(14)
    base = rand_seq(rng, 120)
    graphs = []
    for _ in range(3):
        g = make_graph()
        for s in [mutate(rng, base) for _ in range(5)]:
            c = encode(s)
            aln = g.align_host(c, "nw", 3, -5, -4) if g.num_nodes() else []
            g.add_alignment(aln, c, np.ones(len(c), np.uint32))
        graphs.append(g)
    items = [(encode(mutate(rng, base)), g, m) for g in graphs for m in ("nw", "sw", "nw")]
    be = TorchAlignerBackend(3, -5, -4, devices=["cuda:0", "cuda:0"])
    before = dict(_build.LAUNCHES)
    got = be.align_batch(items)
    assert be.fallbacks == 0 and be.device_alignments == len(items)
    assert be.n_sharded_dispatches == be.n_dispatches > 0
    assert _build.LAUNCHES["poa_walk_dense"] > before["poa_walk_dense"]
    assert _build.LAUNCHES["poa_walk"] == before["poa_walk"]
    for (codes, g, mode), aln in zip(items, got):
        assert aln == g.align_host(codes, mode, 3, -5, -4)


@pytest.mark.parametrize("iters,seed,tiles", [(0, 0, 1), (1, 0, 2), (7, 3, 5), (64, 1000, 3)])
def test_mix_peak_matches_plain(cuda, iters, seed, tiles):
    """K7 against its plain version: every lane of the four chains and the
    checksum; the wrap of the roll (lane 0 from lane 511) is among them."""
    from vechat_tpu_torch.utils import roofline as rf

    chains = rf.mix_inputs(tiles, seed, cuda)
    before = _build.LAUNCHES["mix_peak"]
    k = rf.mix_peak(*chains, iters, seed)
    assert _build.LAUNCHES["mix_peak"] == before + 1
    p = rf._mix_plain(*chains, iters, seed)
    for name, a, b in zip(("a", "b", "c", "d", "checksum"), k, p):
        assert torch.equal(a, b), name
    cpu = rf.mix_peak(*[t.cpu() for t in chains], iters, seed)
    assert torch.equal(k[4].cpu(), cpu[4])


def test_measure_mix_peak(cuda):
    from vechat_tpu_torch.utils import roofline as rf

    m = rf.measure_mix_peak(iters=200)
    assert m["ms_2iters"] > m["ms_iters"] > 0 and m["tops"] > 0.1
    assert m["tiles"] == torch.cuda.get_device_properties(0).multi_processor_count


def test_poa_global_ring_matches_host(cuda):
    """A ring too large for shared memory (a block's warps' slices of
    (R+1)*W*2 bytes over 227 KB) runs from the global scratch ring;
    alignments equal the host oracle's."""
    B, N, P, W, D, R = 2, 640, 8, 320, 3, 511
    assert not pl.dp_launch_plan(B, D, W, R, P)["use_smem"]
    arrs, graphs, seqs = windows(2, B, N, P, W, D)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    runs, steps, _, _ = pl.poa_align(
        codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4, ring=R, device=cuda
    )
    runs = runs[:steps].cpu().numpy()
    for b, g in enumerate(graphs):
        for di, q in enumerate(seqs[b]):
            pn, pp = pl.runs_to_pairs_np(runs[:, b * D + di])
            aln = list(zip(pl.ranks_to_node_ids_np(pn, nid[b, 0]).tolist(), pp.tolist()))
            assert aln == g.align_host(q, "nw", 3, -5, -4)


def test_backend_matches_host(cuda):
    rng = np.random.default_rng(3)
    base = rand_seq(rng, 120)
    graphs = []
    for _ in range(3):
        g = make_graph()
        for s in [mutate(rng, base) for _ in range(5)]:
            c = encode(s)
            aln = g.align_host(c, "nw", 3, -5, -4) if g.num_nodes() else []
            g.add_alignment(aln, c, np.ones(len(c), np.uint32))
        graphs.append(g)
    items = [(encode(mutate(rng, base)), g, m) for g in graphs for m in ("nw", "sw", "nw")]
    be = TorchAlignerBackend(3, -5, -4, device=cuda)
    got = be.align_batch(items)
    assert be.fallbacks == 0 and be.device_alignments == len(items)
    for (codes, g, mode), aln in zip(items, got):
        assert aln == g.align_host(codes, mode, 3, -5, -4)


GAP_KINDS = {
    # name: rings, scores, DP, plain DP, walk, plain walk
    "affine": (2, (3, -5, -8, -6), pa.poa_dp_affine, pa._dp_affine_plain,
               pa.traceback_walk_affine, pa._walk_affine_plain),
    "convex": (3, (5, -4, -8, -6, -10, -4), pc.poa_dp_convex, pc._dp_convex_plain,
               pc.traceback_walk_convex, pc._walk_convex_plain),
}


@pytest.mark.parametrize("kind", ["affine", "convex"])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("ring", [64, 511])
def test_gap_dp_and_walk_match_plain(cuda, kind, mode, ring):
    """K5/K5w and K6/K6w against their plain versions, with the rings in
    shared memory (64) and in the global scratch ring (511)."""
    n_rings, scores, dp, dp_plain, walk, walk_plain = GAP_KINDS[kind]
    B, N, P, W, D = 3, 640, 8, 128, 5
    assert (n_rings * (ring + 1) * W * 2 > pl.SMEM_RING_MAX) == (ring == 511)
    arrs, _, _ = windows(8, B, N, P, W, D)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    aux, deg = pa.pack_aux_gap(preds, ring)
    args = (codes, aux, deg, sink, nn, seqp, slen, mode, *scores, ring)
    before = dict(_build.LAUNCHES)
    k = dp(*args)
    assert _build.LAUNCHES[f"poa_dp_{kind}"] == before[f"poa_dp_{kind}"] + 1
    p = dp_plain(*args)
    real = torch.arange(N + 1, device=cuda)[None, :] <= nn[:, None]
    assert torch.equal(k[0][real], p[0][real])
    for a, b in zip(k[1:], p[1:]):
        assert torch.equal(a, b)
    L = 2 * N + W
    kw = walk(k[0], k[1], k[2], mode, L, P)
    assert _build.LAUNCHES[f"poa_walk_{kind}"] == before[f"poa_walk_{kind}"] + 1
    for a, b in zip(kw, walk_plain(k[0], k[1], k[2], mode, L, P)):
        assert torch.equal(a, b)


def k5_inputs(seed, B, N, P, W, D, max_dist, slens=None, chain=False, far=0):
    """K5's inputs (JAX layout, numpy, from `seed`): random rank-ordered
    DAGs with up to P in-edges a node from the `max_dist` rows above it, or
    a chain of delta-1 edges (`chain`); with `far`, n_nodes N - 1 and one
    in-edge of that distance; D random sequences of lengths `slens`."""
    codes, preds, sink, nn, seqp, slen = dag_windows(seed, B, N, P, W, D, max_dist)
    if chain:
        preds[:] = np.arange(N, dtype=np.int32)[None, None, :]
    if far:
        nn[:] = N - 1
        preds[:, 1 % P, far] = 1  # DP row far + 1 from row 1
    if slens is not None:
        rng = np.random.default_rng(seed + 1)
        slen = np.resize(np.array(slens, np.int32), B * D).reshape(B, D)
        seqp[:] = 0xFF
        for b in range(B):
            for d in range(D):
                seqp[b, d, 1 : 1 + slen[b, d]] = rng.integers(0, 4, slen[b, d])
    return codes, preds, sink, nn, seqp, slen


def k5_insertion(W, N=64):
    """A chain of N codes and a query of its first half, W - 1 - N random
    bases and its second half: the nw alignment's E chain crosses every
    warp of the row."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, N).astype(np.int32)
    preds = np.arange(N, dtype=np.int32)[None, None, :].repeat(4, axis=1)
    sink = np.zeros((1, N), np.int32)
    sink[0, -1] = 1
    seqp = np.full((1, 1, W), 0xFF, np.int32)
    seqp[0, 0, 1:] = np.concatenate([g[: N // 2], rng.integers(0, 4, W - 1 - N), g[N // 2 :]])
    return g[None], preds, sink, np.array([N], np.int32), seqp, np.array([[W - 1]], np.int32)


def k5_mismatch(W, N=96):
    """A graph of A's against queries of C's: every sw cell clamps to 0."""
    preds = np.arange(N, dtype=np.int32)[None, None, :].repeat(4, axis=1)
    seqp = np.full((1, 2, W), 0xFF, np.int32)
    seqp[0, :, 1:] = 1
    return (np.zeros((1, N), np.int32), preds, np.ones((1, N), np.int32),
            np.array([N - 3], np.int32), seqp, np.array([[W - 1, W // 2]], np.int32))


AFFINE = (3, -5, -8, -6)
K5_SLENS = [31, 32, 33, 191, 192, 193, 383, 384, 385, 575]


def k5_case(name):
    """(arrays, mode, ring, lanes a thread or None for the default,
    scores) of a K5 case."""
    kind, _, rest = name.partition(":")
    if kind == "width":  # W/LPT/mode
        W, lpt, mode = rest.split("/")
        W, lpt = int(W), int(lpt)
        return k5_inputs(W + lpt, 1, 96, 4, W, 3, max_dist=12), mode, 12, lpt, AFFINE
    if kind == "ring":  # R/mode
        R, mode = rest.split("/")
        R = int(R)
        if R == 511:
            arrays = k5_inputs(R, 1, 640, 8, 192, 2, max_dist=8, far=511)
        else:
            arrays = k5_inputs(R, 1, 256, 8, 192, 2, max_dist=R, chain=R == 1)
        return arrays, mode, R, None, AFFINE
    if kind == "slens":
        arrays = k5_inputs(17, 1, 160, 4, 576, len(K5_SLENS), max_dist=6, slens=K5_SLENS)
        return arrays, rest, 6, None, AFFINE
    if kind == "slens1":  # a thread a lane: a warp boundary every 32 lanes
        arrays = k5_inputs(18, 1, 160, 4, 576, len(K5_SLENS), max_dist=6, slens=K5_SLENS)
        return arrays, rest, 6, 1, AFFINE
    if kind == "insertion":  # W/LPT
        W, lpt = (int(v) for v in rest.split("/"))
        return k5_insertion(W), "nw", 1, lpt, AFFINE
    if kind == "sw_zero":
        return k5_mismatch(int(rest)), "sw", 1, None, AFFINE
    if kind == "floor":  # lanes below the rings' int16 floor
        return k5_inputs(41, 1, 256, 4, 576, 2, max_dist=3), rest, 3, None, (3, -5, -40, -30)
    if kind == "p16":  # in-degrees past the slots fetched ahead
        return k5_inputs(77, 2, 256, 16, 128, 2, max_dist=30), rest, 30, None, AFFINE
    if kind == "rows":  # graph rows at the edges of the 32-row batches
        arrays = k5_inputs(int(rest), 1, 96, 8, 192, 2, max_dist=20)
        arrays[3][:] = int(rest)
        return arrays, "nw", 20, 3, AFFINE
    raise KeyError(name)


K5_WIDTHS = [(128, 4), (128, 1), (320, 5), (320, 2), (576, 6), (576, 3), (576, 2), (768, 6),
             (768, 4), (768, 3), (96, 3), (224, 1), (1024, 4), (32, 1)]
K5_CASES = (
    [f"width:{W}/{lpt}/{mode}" for W, lpt in K5_WIDTHS for mode in ("nw", "sw", "ov")]
    + [f"ring:{R}/{mode}" for R in (1, 5, 64, 511) for mode in ("nw", "sw")]
    + [f"slens:{mode}" for mode in ("nw", "sw", "ov")] + ["slens1:nw", "slens1:ov"]
    + [f"insertion:{W}/{lpt}" for W, lpt in ((576, 6), (576, 3), (768, 6), (320, 5))]
    + ["sw_zero:576", "sw_zero:128", "floor:nw", "floor:ov", "p16:nw", "p16:sw"]
    + [f"rows:{n}" for n in (31, 32, 33, 64, 65)]
)


# kind: (rings, DP, plain DP, C launcher, the rings' shared-memory limit)
GAP_DP = {
    "affine": (2, pa.poa_dp_affine, pa._dp_affine_plain, pa.launch_dp_affine, pa.K5_SMEM_RING_MAX),
    "convex": (3, pc.poa_dp_convex, pc._dp_convex_plain, pc.launch_dp_convex, pc.K6_SMEM_RING_MAX),
}


def _gap_dp_equals_plain(device, kind, arrays, mode, R, lpt, scores):
    """K5 or K6 against its plain version: the real rows, every lane, and
    the three best-cell outputs, torch.equal. Through the wrapper (one
    launch, counted), or with `lpt` through the launcher at those lanes a
    thread."""
    n_rings, dp, dp_plain, launch, smem_max = GAP_DP[kind]
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                          for a in arrays)
    B, P, N = preds.shape
    D, W = seqp.shape[1], seqp.shape[2]
    aux, deg = pa.pack_aux_gap(preds, R)
    args = (codes.reshape(B, N), aux, deg, sink.reshape(B, N), nn.reshape(B), seqp,
            slen.reshape(B, D), mode, *scores, R)
    if lpt is None:
        before = _build.LAUNCHES[f"poa_dp_{kind}"]
        k = dp(*args)
        assert _build.LAUNCHES[f"poa_dp_{kind}"] == before + (B * D > 0)
    else:
        k = pa.poa_gap.dp_buffers(B, N, D, W, R, n_rings, device, smem_max)
        _build.check(pa._lib() if kind == "affine" else pc._lib(), launch(*args, k, lpt),
                     f"poa_dp_{kind}")
        k = k[:4]
    p = dp_plain(*args)
    real = torch.arange(N + 1, device=device)[None, :] <= nn.reshape(B)[:, None]
    assert torch.equal(k[0][real], p[0][real])
    for name, a, b in zip(("maxi", "maxj", "score"), k[1:], p[1:]):
        assert torch.equal(a, b), name
    return k


def _k5_equals_plain(device, arrays, mode, R, lpt=None, scores=AFFINE):
    return _gap_dp_equals_plain(device, "affine", arrays, mode, R, lpt, scores)


@pytest.mark.parametrize("case", K5_CASES)
def test_affine_dp_kernel_cases_match_plain(cuda, case):
    """K5 at the widths and lanes a thread it is built for (the buckets'
    defaults and the others measured, odd ones, a thread a lane, one warp),
    nw/sw/ov; rings 1 (every in-edge delta 1), 5, 64 and 511 (one in-edge
    of distance 511); lengths on both sides of every warp boundary; an E
    chain across every warp; sw rows clamped to 0; lanes at the int16
    floor; in-degrees past the slots fetched ahead; row counts at the
    edges of the 32-row batches of graph words."""
    arrays, mode, R, lpt, scores = k5_case(case)
    _k5_equals_plain(cuda, arrays, mode, R, lpt, scores)


@pytest.mark.parametrize("B,D", [(0, 3), (1, 1), (1, 7), (5, 4)])
def test_affine_dp_kernel_batch_sizes_match_plain(cuda, B, D):
    arrays = k5_inputs(B * 10 + D, max(B, 1), 192, 8, 320, D, max_dist=20)
    if B == 0:
        arrays = tuple(a[:0] for a in arrays)
    _k5_equals_plain(cuda, arrays, "nw", 20)


@pytest.mark.parametrize("W,R", [(576, 99), (576, 100), (768, 74), (768, 75), (128, 511)])
@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_affine_dp_kernel_rings_on_both_sides_of_shared_memory(cuda, W, R, mode):
    """The rings in shared memory up to K5's own limit and in the global
    scratch ring past it (W=576: 99 rows | 100; W=768: 74 | 75)."""
    smem = 2 * (R + 1) * W * 2 <= pa.K5_SMEM_RING_MAX
    assert smem == ((W, R) in ((576, 99), (768, 74)))
    arrays = k5_inputs(W + R, 1, 320, 8, W, 2, max_dist=min(R, 40), far=R if R < 319 else 0)
    _k5_equals_plain(cuda, arrays, mode, R)


def test_affine_dp_kernel_raises_on_widths_and_lanes_it_cannot_take(cuda):
    arrays = k5_inputs(3, 1, 64, 4, 576, 1, max_dist=4)
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(a).to(cuda) for a in arrays)
    aux, deg = pa.pack_aux_gap(preds, 4)
    args = (codes, aux, deg, sink, nn, seqp, slen, "nw", *AFFINE, 4)
    out = pa.poa_gap.dp_buffers(1, 64, 1, 576, 4, 2, cuda, pa.K5_SMEM_RING_MAX)
    for lpt in (4, 7, -1):  # 4 does not divide 576/32; 7 and -1 are not built
        with pytest.raises(RuntimeError, match="cudaError"):
            _build.check(pa._lib(), pa.launch_dp_affine(*args, out, lpt), "poa_dp_affine")
    bad = seqp[:, :, :100].contiguous()  # W off 32
    with pytest.raises(ValueError):
        pa.poa_dp_affine(codes, aux, deg, sink, nn, bad, slen, "nw", *AFFINE, 4)


# K6's scores: the spoa command line's, every magnitude within 8, and gap
# lines that fall below the rings' int16 floor from lane ~470
CONVEX = (5, -4, -8, -6, -10, -4)
CONVEX_SMALL = (3, -5, -6, -4, -8, -2)
CONVEX_FLOOR = (3, -5, -40, -35, -50, -34)


def k6_case(name):
    """(arrays, mode, ring, lanes a thread or None for the default,
    scores) of a K6 case, on the inputs of K5's cases (the shapes of
    `tests/test_torch_poa_convex_rows.py`, whose model runs them on the
    CPU)."""
    kind, _, rest = name.partition(":")
    if kind == "width":  # W/LPT/mode
        W, lpt, mode = rest.split("/")
        W, lpt = int(W), int(lpt)
        return k5_inputs(W + lpt, 1, 96, 4, W, 3, max_dist=12), mode, 12, lpt, CONVEX
    if kind == "ring":  # R/mode: 1 every in-edge delta 1; 511 one in-edge of that distance
        R, mode = rest.split("/")
        R = int(R)
        if R == 511:
            arrays = k5_inputs(R, 1, 640, 8, 192, 2, max_dist=8, far=511)
        else:
            arrays = k5_inputs(R, 1, 256, 8, 192, 2, max_dist=R, chain=R == 1)
        return arrays, mode, R, None, CONVEX
    if kind == "slens":  # LPT/mode
        lpt, mode = rest.split("/")
        arrays = k5_inputs(17, 1, 160, 4, 576, len(K5_SLENS), max_dist=6, slens=K5_SLENS)
        return arrays, mode, 6, int(lpt), CONVEX_SMALL
    if kind == "insertion":  # W/LPT/scores: Q overtakes E, the chain crosses every warp
        W, lpt, sc = rest.split("/")
        return k5_insertion(int(W)), "nw", 1, int(lpt), CONVEX if sc == "default" else CONVEX_SMALL
    if kind == "sw_zero":
        return k5_mismatch(int(rest)), "sw", 1, None, CONVEX
    if kind == "floor":  # LPT/mode
        lpt, mode = rest.split("/")
        return k5_inputs(41, 1, 256, 4, 576, 2, max_dist=3), mode, 3, int(lpt), CONVEX_FLOOR
    if kind == "p8":  # in-degrees up to P_CAP, past the slots fetched ahead
        return k5_inputs(77, 2, 256, pc.P_CAP, 128, 2, max_dist=30), rest, 30, None, CONVEX
    if kind == "rows":  # graph rows at the edges of the 32-row batches
        arrays = k5_inputs(int(rest), 1, 96, 8, 192, 2, max_dist=20)
        arrays[3][:] = int(rest)
        return arrays, "nw", 20, 3, CONVEX
    raise KeyError(name)


# every lanes a thread the wrapper picks (k6_lanes_per_thread) and every one
# that divides W/32 at the spoa path's W=576
K6_WIDTHS = [(64, 1), (64, 2), (192, 3), (192, 6), (576, 6), (576, 3), (576, 2), (576, 1),
             (128, 4), (320, 5), (768, 6), (1024, 4), (32, 1), (96, 3)]
K6_CASES = (
    [f"width:{W}/{lpt}/{mode}" for W, lpt in K6_WIDTHS for mode in ("nw", "sw", "ov")]
    + [f"ring:{R}/{mode}" for R in (1, 5, 64, 511) for mode in ("nw", "sw")]
    + [f"slens:{lpt}/{mode}" for lpt in (6, 1) for mode in ("nw", "sw", "ov")]
    + [f"insertion:{W}/{lpt}/{sc}" for W, lpt in ((576, 6), (576, 3), (576, 1), (320, 5))
       for sc in ("default", "small")]
    + ["sw_zero:576", "sw_zero:64"]
    + [f"floor:{lpt}/{mode}" for lpt in (6, 3, 1) for mode in ("nw", "ov")]
    + ["p8:nw", "p8:sw", "p8:ov"] + [f"rows:{n}" for n in (31, 32, 33, 64, 65)]
)


def _k6_equals_plain(device, arrays, mode, R, lpt=None, scores=CONVEX):
    return _gap_dp_equals_plain(device, "convex", arrays, mode, R, lpt, scores)


@pytest.mark.parametrize("case", K6_CASES)
def test_convex_dp_kernel_cases_match_plain(cuda, case):
    """K6 at every lanes a thread it is built for (the wrapper's choices
    and every one at W=576), nw/sw/ov; rings 1 (every in-edge delta 1), 5,
    64 and 511 (one in-edge of distance 511); lengths on both sides of
    every warp boundary; a long insertion where Q overtakes E across every
    warp, at both spoa score sets; sw rows clamped to 0; lanes at the
    int16 floor across warp boundaries; in-degrees up to P_CAP; row counts
    at the edges of the 32-row batches of graph words."""
    arrays, mode, R, lpt, scores = k6_case(case)
    _k6_equals_plain(cuda, arrays, mode, R, lpt, scores)


@pytest.mark.parametrize("B,D", [(0, 3), (1, 1), (1, 7), (5, 4)])
def test_convex_dp_kernel_batch_sizes_match_plain(cuda, B, D):
    arrays = k5_inputs(B * 10 + D + 1, max(B, 1), 192, 8, 320, D, max_dist=20)
    if B == 0:
        arrays = tuple(a[:0] for a in arrays)
    _k6_equals_plain(cuda, arrays, "nw", 20)


@pytest.mark.parametrize("W,R", [(576, 65), (576, 66), (768, 49), (768, 50), (128, 511)])
@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_convex_dp_kernel_rings_on_both_sides_of_shared_memory(cuda, W, R, mode):
    """The rings in shared memory up to K6's own limit and in the global
    scratch ring past it (W=576: 65 rows | 66; W=768: 49 | 50)."""
    smem = 3 * (R + 1) * W * 2 <= pc.K6_SMEM_RING_MAX
    assert smem == ((W, R) in ((576, 65), (768, 49)))
    arrays = k5_inputs(W + R + 1, 1, 320, 8, W, 2, max_dist=min(R, 40), far=R if R < 319 else 0)
    _k6_equals_plain(cuda, arrays, mode, R)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_convex_dp_launcher_equals_the_wrapper(cuda, mode):
    """`launch_dp_convex` at the wrapper's lanes a thread, on buffers made
    apart, writes what the wrapper returns; it counts no launch."""
    arrays = k5_inputs(61, 2, 256, 8, 576, 3, max_dist=20)
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(a).to(cuda) for a in arrays)
    B, P, N = preds.shape
    D, W = seqp.shape[1], seqp.shape[2]
    aux, deg = pa.pack_aux_gap(preds, 20)
    args = (codes, aux, deg, sink, nn, seqp, slen, mode, *CONVEX, 20)
    ref = pc.poa_dp_convex(*args)
    out = pc.poa_gap.dp_buffers(B, N, D, W, 20, 3, cuda, pc.K6_SMEM_RING_MAX)
    before = _build.LAUNCHES["poa_dp_convex"]
    rc = pc.launch_dp_convex(*args, out, pc.k6_lanes_per_thread(W))
    _build.check(pc._lib(), rc, "poa_dp_convex")
    assert _build.LAUNCHES["poa_dp_convex"] == before
    real = torch.arange(N + 1, device=cuda)[None, :] <= nn[:, None]
    assert torch.equal(out[0][real], ref[0][real])
    for a, b in zip(out[1:4], ref[1:]):
        assert torch.equal(a, b)


def test_convex_dp_kernel_raises_on_widths_and_lanes_it_cannot_take(cuda):
    arrays = k5_inputs(3, 1, 64, 4, 576, 1, max_dist=4)
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(a).to(cuda) for a in arrays)
    aux, deg = pa.pack_aux_gap(preds, 4)
    args = (codes, aux, deg, sink, nn, seqp, slen, "nw", *CONVEX, 4)
    out = pc.poa_gap.dp_buffers(1, 64, 1, 576, 4, 3, cuda, pc.K6_SMEM_RING_MAX)
    for lpt in (4, 7, -1):  # 4 does not divide 576/32; 7 and -1 are not built
        with pytest.raises(RuntimeError, match="cudaError"):
            _build.check(pc._lib(), pc.launch_dp_convex(*args, out, lpt), "poa_dp_convex")
    bad = seqp[:, :, :100].contiguous()  # W off 32
    with pytest.raises(ValueError):
        pc.poa_dp_convex(codes, aux, deg, sink, nn, bad, slen, "nw", *CONVEX, 4)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize(
    "scores", [(3, -5, -4, -4, -4, -4), (3, -5, -8, -6, -8, -6), (5, -4, -8, -6, -10, -4)]
)
def test_graph_engine_matches_host(cuda, mode, scores):
    from vechat_tpu_torch.ops.graph_align import make_engine
    from vechat_tpu_torch.ops.kernels.graph_engine import TorchGraphEngine

    from vechat_tpu_torch.ops.poagraph import PoaGraph

    rng = np.random.default_rng(9)
    base = rand_seq(rng, 300)
    dev = TorchGraphEngine(mode, *scores, device=cuda)
    host = make_engine(mode, *scores)
    g = PoaGraph()
    for s in [base] + [mutate(rng, base) for _ in range(6)]:
        c = encode(s)
        aln = []
        if g.num_nodes():
            aln, score = dev.align(c, g, return_score=True)
            assert (aln, score) == host.align(c, g, return_score=True)
        g.add_alignment(aln, c, np.ones(len(c), np.uint32))
    assert (dev.device_alignments, dev.fallbacks) == (6, 0)


@pytest.mark.parametrize("scores", [(3, -5, -8, -6, -8, -6), (3, -5, -8, -6, -10, -2)])
@pytest.mark.parametrize("query", ["CCGTACGT", "GTACGT", "TTACCGTACGT"])
def test_nw_walk_kernel_ends_at_the_origin_like_the_host(cuda, scores, query):
    """nw alignments that start by deleting one or three start nodes, or by
    an insertion: the walk kernel reaches cell (0, 0) in the vertical-chain
    state and must end there, as the host engine's alignment does."""
    from vechat_tpu_torch.ops.graph_align import make_engine
    from vechat_tpu_torch.ops.kernels.graph_engine import TorchGraphEngine
    from vechat_tpu_torch.ops.poagraph import PoaGraph

    g = PoaGraph()
    base = encode("ACCGTACGT")
    g.add_alignment([], base, np.ones(len(base), np.uint32))
    q = encode(query)
    dev = TorchGraphEngine("nw", *scores, device=cuda)
    assert dev.align(q, g, return_score=True) == make_engine("nw", *scores).align(
        q, g, return_score=True
    )
    assert (dev.device_alignments, dev.fallbacks) == (1, 0)


# ------------------------------------------- K5w / K6w: the three-state walk

WALK3_KERNELS = {1: (pa._lib, "poa_walk_affine"), 2: (pc._lib, "poa_walk_convex")}


def _walk3_tensors(device, dirs, maxi, maxj):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (dirs, maxi, maxj))


def _walk3_equals_plain(device, dirs, maxi, maxj, mode, L, P, K):
    """The walk kernel against `_walk3_plain`, ranks and node ids, through
    the wrapper (launch counted) and through `launch_walk3` on buffers made
    once, whose tiles a walk equal the numpy model's.
    Returns the wrapper's (pn, pp, count) in ranks."""
    from test_torch_walk3_tiles import model_walk3, node_ids
    from vechat_tpu_torch.ops.kernels import poa_gap

    lib, kernel = WALK3_KERNELS[K]
    walk = pa.traceback_walk_affine if K == 1 else pc.traceback_walk_convex
    d, mi, mj = _walk3_tensors(device, dirs, maxi, maxj)
    B, N1, D, W = dirs.shape
    ranks = None
    for nid_np in (None, node_ids(5, B, N1)):
        nid = None if nid_np is None else torch.from_numpy(nid_np).to(device)
        before = _build.LAUNCHES[kernel]
        got = walk(d, mi, mj, mode, L, P, nid)
        assert _build.LAUNCHES[kernel] == before + 1
        want = poa_gap._walk3_plain(d.cpu(), mi.cpu(), mj.cpu(), mode, L, P, K,
                                    None if nid is None else nid.cpu())
        for name, a, b in zip(("pn", "pp", "count"), got, want):
            assert torch.equal(a.cpu(), b), f"{name} node_id={nid is not None}"
        if ranks is None:
            ranks = got
        out = tuple(torch.full_like(t, 7) for t in got)
        tiles = torch.full((B, D), -1, dtype=torch.int32, device=device)
        rc = poa_gap.launch_walk3(lib, kernel, d, mi, mj, nid, out, mode, L, P, tiles)
        assert rc == 0
        for a, b in zip(out, got):
            assert torch.equal(a, b)
        stats = model_walk3(dirs, maxi, maxj, mode, L, P, K, nid_np)[3]
        assert tiles.cpu().view(-1).tolist() == [s["tiles"] for s in stats]
    return ranks


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_walk3_kernel_vertical_jumps_match_plain(cuda, K, mode):
    """Jumps of 1, 63, 64, 65, 511 and 0 (to row 0) from H and from the
    vertical chain, sequence-gap chains across a tile's left edge, sw stop
    codes; ranks and node ids."""
    from test_torch_walk3_tiles import synth_walk3

    dirs, maxi, maxj = synth_walk3(1 + K, 2, 1100, 3, 256, 4, K, mode,
                                   jumps=(1, 63, 64, 65, 511, 0), p_vert=0.15, p_seq=0.25,
                                   p_stop=0.002)
    maxi[:, 0] = 1099
    _walk3_equals_plain(cuda, dirs, maxi, maxj, mode, 2 * 1100 + 256, 4, K)


@pytest.mark.parametrize("W", [32, 64, 576, 1024])
@pytest.mark.parametrize("K", [1, 2])
def test_walk3_kernel_widths_match_plain(cuda, W, K):
    from test_torch_walk3_tiles import synth_walk3

    for mode in ("nw", "sw"):
        dirs, maxi, maxj = synth_walk3(W + K, 2, 130, 3, W, 8, K, mode,
                                       jumps=(1, 2, 3, 64, 0), p_stop=0.001)
        _walk3_equals_plain(cuda, dirs, maxi, maxj, mode, 2 * 130 + W, 8, K)


@pytest.mark.parametrize("K", [1, 2])
def test_walk3_kernel_chunks_cuts_and_empty_walks_match_plain(cuda, K):
    """Pair counts of 31, 32, 33, 64 and 65 at the 32-pair chunks, walks
    cut at L = 1, 31, 32, 33, and walks that never start."""
    from test_torch_walk3_tiles import diagonal_walk3, synth_walk3

    for n in (31, 32, 33, 64, 65):
        dirs, maxi, maxj = diagonal_walk3(1, 80, 2, 96, 2, K, n)
        _, _, count = _walk3_equals_plain(cuda, dirs, maxi, maxj, "nw", 200, 2, K)
        assert (count == n).all()
    for L in (1, 31, 32, 33):
        dirs, maxi, maxj = synth_walk3(11, 1, 300, 4, 128, 4, K, "nw", jumps=(1, 2, 5))
        maxi[:] = 299
        maxj[:] = 127
        _, _, count = _walk3_equals_plain(cuda, dirs, maxi, maxj, "nw", L, 4, K)
        assert (count == L).all()
    for mode in ("nw", "sw", "ov"):
        dirs, maxi, maxj = synth_walk3(13, 2, 40, 3, 32, 3, K, mode)
        maxi[0, :], maxj[0, :] = 0, 0
        maxi[1, 0], maxj[1, 0] = 0, 7
        maxi[1, 1], maxj[1, 1] = 9, 0
        pn, pp, count = _walk3_equals_plain(cuda, dirs, maxi, maxj, mode, 2 * 40 + 32, 3, K)
        assert (count[0] == 0).all() and (pn[0] == -2).all() and (pp[0] == -2).all()


@pytest.mark.parametrize("B,D", [(0, 3), (1, 1), (1, 5), (3, 171)])
def test_walk3_kernel_batch_sizes_match_plain(cuda, B, D):
    """B*D of 0, 1, 5 and 513 walks: spare warps in the last block."""
    from test_torch_walk3_tiles import synth_walk3

    for K in (1, 2):
        dirs, maxi, maxj = synth_walk3(21, B, 90, D, 64, 4, K, "nw", jumps=(1, 2, 70, 0))
        if B * D == 0:
            walk = pa.traceback_walk_affine if K == 1 else pc.traceback_walk_convex
            pn, pp, count = walk(*_walk3_tensors(cuda, dirs, maxi, maxj), "nw", 244, 4)
            assert pn.shape == (B, D, 244) and count.shape == (B, D)
            continue
        _walk3_equals_plain(cuda, dirs, maxi, maxj, "nw", 2 * 90 + 64, 4, K)


@pytest.mark.parametrize("kind", ["affine", "convex"])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_walk3_kernel_on_dp_words_with_node_ids_matches_plain(cuda, kind, mode):
    """The DP kernel's own words at the spoa path's width: the walk with
    node ids equals `_walk3_plain(..., node_id)`."""
    n_rings, scores, dp, _, walk, _ = GAP_KINDS[kind]
    B, N, P, W, D = 2, 640, 8, 576, 3
    arrs, _, _ = windows(8, B, N, P, W, D)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    aux, deg = pa.pack_aux_gap(preds, 64)
    dirs, maxi, maxj, _ = dp(codes, aux, deg, sink, nn, seqp, slen, mode, *scores, 64)
    _walk3_equals_plain(cuda, dirs.cpu().numpy(), maxi.cpu().numpy(), maxj.cpu().numpy(), mode,
                        2 * N + W, P, 1 if kind == "affine" else 2)


def test_walk3_kernel_raises_on_rows_off_16_bytes(cuda):
    dirs = torch.zeros((1, 9, 1, 34), dtype=torch.int32, device=cuda)
    mx = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        pa.traceback_walk_affine(dirs, mx, mx, "nw", 50, 4)


@pytest.mark.parametrize("scores", [(3, -5, -8, -6, -8, -6), (5, -4, -8, -6, -10, -4),
                                    (3, -5, -6, -4, -8, -2)])
def test_graph_engine_one_fetch_route_matches_host_over_a_growing_graph(cuda, scores):
    """The affine and convex route (node ids from the walk, one copy to the
    host) over a graph grown read by read: every alignment and score equals
    the host engine's."""
    from vechat_tpu_torch.ops.graph_align import make_engine
    from vechat_tpu_torch.ops.kernels.graph_engine import TorchGraphEngine
    from vechat_tpu_torch.ops.poagraph import PoaGraph

    rng = np.random.default_rng(12)
    base = rand_seq(rng, 260)
    dev = TorchGraphEngine("nw", *scores, device=cuda)
    assert dev.subtype in ("affine", "convex")
    host = make_engine("nw", *scores)
    g = PoaGraph()
    for s in [base] + [mutate(rng, base, 0.08) for _ in range(8)]:
        c = encode(s)
        aln = []
        if g.num_nodes():
            aln, score = dev.align(c, g, return_score=True)
            assert (aln, score) == host.align(c, g, return_score=True)
        g.add_alignment(aln, c, np.ones(len(c), np.uint32))
    assert (dev.device_alignments, dev.fallbacks) == (8, 0)


def test_spoa_cli_cuda_matches_host(cuda, tmp_path, capsys):
    from vechat_tpu_torch.cli.spoa_main import main

    rng = np.random.default_rng(10)
    base = rand_seq(rng, 200)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(f">s{i}\n{mutate(rng, base)}\n" for i in range(8)))
    outs = {}
    for backend in ("cuda", "host"):
        assert main([str(fa), "-l", "1", "-r", "0", "-r", "1", "-r", "4", "--backend", backend]) == 0
        captured = capsys.readouterr()
        outs[backend] = captured.out
        if backend == "cuda":
            assert "device_alignments=7 fallbacks=0" in captured.err
    assert outs["cuda"] == outs["host"] and ">Consensus" in outs["cuda"]


def test_gap_wrappers_raise_on_wrong_inputs(cuda):
    B, N, P, W, D = 1, 256, 8, 128, 2
    arrs, _, _ = windows(11, B, N, P, W, D, depth=3, base_len=60)
    codes, preds, sink, nn, seqp, slen = _tensors(arrs, cuda, B, N, D)
    aux, deg = pa.pack_aux_gap(preds, 64)
    ok = dict(codes=codes, aux=aux, deg=deg, sink=sink, n_nodes=nn, seqp=seqp, slen=slen)
    aff = dict(align_type="nw", m=3, x=-5, g=-8, e=-6)
    cvx = dict(aff, q=-10, c=-2)
    for dp, kw in ((pa.poa_dp_affine, aff), (pc.poa_dp_convex, cvx)):
        dp(**ok, **kw, R=64)  # the inputs are good as they stand
        for change in (
            dict(seqp=seqp.to(torch.int64)),  # dtype
            dict(slen=slen.cpu()),  # device
            dict(codes=codes[:, :-1].contiguous()),  # shape
            dict(seqp=seqp[:, :, :100].contiguous()),  # W not a multiple of 32
        ):
            with pytest.raises(ValueError):
                dp(**{**ok, **change}, **kw, R=64)
        with pytest.raises(ValueError):
            dp(**ok, **kw, R=512)  # past the 9-bit distance field
    aux16 = torch.zeros((B, 16, N), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="P <= 8"):
        pc.poa_dp_convex(**{**ok, "aux": aux16}, **cvx, R=64)
    dirs = torch.zeros((B, N + 1, D, W), dtype=torch.int32, device=cuda)
    mx = torch.zeros((B, D), dtype=torch.int32, device=cuda)
    for walk in (pa.traceback_walk_affine, pc.traceback_walk_convex):
        with pytest.raises(ValueError):
            walk(dirs.to(torch.int16), mx, mx, "nw", 2 * N + W, P)
        with pytest.raises(ValueError):
            walk(dirs, mx.cpu(), mx, "nw", 2 * N + W, P)
    with pytest.raises(ValueError, match="P <= 8"):
        pc.traceback_walk_convex(dirs, mx, mx, "nw", 2 * N + W, 16)


def _pairs(seed, n, lo, hi, rate=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rand_seq(rng, int(rng.integers(lo, hi)))
        out.append((encode(mutate(rng, t, rate))[: hi + 5], encode(t)))
    return out


def test_banded_matches_plain(cuda):
    pairs = _pairs(4, 6, 40, 90)
    rng = np.random.default_rng(5)
    pairs.append((encode(rand_seq(rng, 90)), encode(rand_seq(rng, 88))))  # band overflow
    arrs = pw.pack_banded(pairs, 96, 64)
    cpu = pw.pairwise_banded(*arrs, BW=64, device="cpu")
    before = _build.LAUNCHES["pairwise_banded"]
    gpu = pw.pairwise_banded(*arrs, BW=64, device=cuda)
    assert _build.LAUNCHES["pairwise_banded"] == before + 1
    for c, g in zip(cpu, gpu):
        assert torch.equal(g.cpu(), c)


def _codes(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def _noisy_pairs(rng, n, lo, hi, rate=0.08):
    return [(encode(mutate(rng, t, rate))[:hi], encode(t))
            for t in (rand_seq(rng, int(rng.integers(lo, hi + 1))) for _ in range(n))]


def _shifted(rng, T, BW, sign, k):
    """|lq - lt| = BW - 1 - 2k, so that the band keeps k lanes beside the
    path's first and last diagonals: a block of random bases inserted into
    one side. k = 16 is the edge of the aligner's margin; at k <= 1 the
    path runs along both band edges, the block's row joining them."""
    d = BW - 1 - 2 * k
    lt = T - d
    t = _codes(rng, lt)
    a = int(rng.integers(0, lt + 1))
    q = np.concatenate([t[:a], _codes(rng, d), t[a:]])
    return (q, t) if sign > 0 else (t, q)


def _far(rng, T, BW):
    """Far beyond the band: unrelated sequences, and a length difference
    past the band (the clipped walk)."""
    n = T * 3 // 4
    return [(_codes(rng, n), _codes(rng, min(T, n + BW // 8))), (_codes(rng, T), _codes(rng, T // 3))]


def k3_case(name):
    """(pairs, T, BW) of one K3 case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "bucket 640x384":
        return _noisy_pairs(rng, 6, 300, 640) + _far(rng, 640, 384), 640, 384
    if name == "bucket 2560x896":
        return _noisy_pairs(rng, 4, 1800, 2560) + _far(rng, 2560, 896), 2560, 896
    if name in ("BW 32", "BW 64", "BW 480", "BW 832", "BW 1024"):
        BW = int(name.split()[1])
        T = {32: 100, 64: 150, 480: 200, 832: 200, 1024: 300}[BW]
        return _noisy_pairs(rng, 3, T // 2, T, 0.05) + _far(rng, T, BW)[:1], T, BW
    if name in ("NP 1", "NP 3"):
        return _noisy_pairs(rng, int(name[-1]), 150, 200), 200, 128
    if name == "NP 257":
        return _noisy_pairs(rng, 257, 100, 640), 640, 384
    if name == "empty sequences":
        e = np.zeros(0, np.uint8)
        return [(e, _codes(rng, 40)), (_codes(rng, 40), e), (e, e), (_codes(rng, 50), _codes(rng, 60))], 96, 64
    if name == "identical":
        t = _codes(rng, 637)
        return [(t, t), (t[:100], t[:100]), (t[:1], t[:1])], 640, 384
    if name.startswith(("length difference at the margin", "path hugs a band edge")):
        T, BW = (2560, 896) if name.endswith("2560x896") else (640, 384)
        ks = (16,) if name.startswith("length") else (0, 1)
        return [_shifted(rng, T, BW, s, k) for k in ks for s in (1, -1)], T, BW
    if name == "far beyond the band":
        return _far(rng, 640, 384) * 2, 640, 384
    if name == "ragged target lengths":
        # rows not a multiple of a 16-row chunk, a 64-row walk stage or a
        # 32-row fetch batch, and T itself none of them
        lens = (1, 15, 16, 17, 31, 33, 63, 64, 65, 127, 129, 200, 333)
        return [(encode(mutate(rng, t, 0.1))[:333], encode(t))
                for t in (rand_seq(rng, n) for n in lens)], 333, 128
    raise ValueError(name)


K3_CASES = ("bucket 640x384", "bucket 2560x896", "BW 32", "BW 64", "BW 480", "BW 832", "BW 1024",
            "NP 1", "NP 3", "NP 257", "empty sequences", "identical", "length difference at the margin",
            "length difference at the margin, 2560x896", "path hugs a band edge",
            "path hugs a band edge, 2560x896", "far beyond the band", "ragged target lengths")


def pack_banded_any(pairs, T, BW):
    """`pack_banded`'s layout, also for an empty query (every code 0xFF),
    which `pack_banded` itself does not take."""
    arrs = pw.pack_banded([(q if len(q) else np.zeros(1, np.uint8), t) for q, t in pairs], T, BW)
    _, _, qwin0, qent, qlen, lo = arrs
    for n, (q, t) in enumerate(pairs):
        if len(q) == 0:
            b, d = divmod(n, pw.BSUB)
            qwin0[b, d] = 0xFF
            qent[b, :, 0, d] = 0xFF
            qlen[b, 0, d] = 0
            lo[b, 0, d] = -len(t) - (BW - 1 - len(t)) // 2
    return arrs


@pytest.mark.parametrize("case", K3_CASES)
def test_banded_kernel_cases_match_plain(cuda, case):
    """K3 against its plain version, all four outputs whole: both buckets,
    other band widths (480 and 832 need over 48 KB of shared memory) and
    pair counts, empty and identical sequences,
    length differences at the aligner's margin, paths along a band edge,
    clipped walks and ragged target lengths."""
    pairs, T, BW = k3_case(case)
    args = pw.banded_inputs(*pack_banded_any(pairs, T, BW), BW, cuda)
    want = pw._banded_plain(*args, BW)
    before = _build.LAUNCHES["pairwise_banded"]
    got = pw.banded_nw(*args, BW)
    assert _build.LAUNCHES["pairwise_banded"] == before + 1
    for name, g, w in zip(("pt", "pq", "count", "dist"), got, want):
        assert torch.equal(g, w), name


def test_tiled_matches_plain(cuda):
    tiles = _pairs(6, 11, 5, 28, rate=0.15)
    arrs = pw.pack_tiles(tiles, 32, 32)
    cpu = pw.pairwise_nw(*arrs, device="cpu")
    before = _build.LAUNCHES["pairwise_tiled"]
    gpu = pw.pairwise_nw(*arrs, device=cuda)
    assert _build.LAUNCHES["pairwise_tiled"] == before + 1
    for c, g in zip(cpu, gpu):
        assert torch.equal(g.cpu(), c)


def test_device_aligner_matches_host(cuda):
    from vechat_tpu_torch.ops.pairwise import edit_align

    pairs = _pairs(7, 9, 300, 700, rate=0.08)
    al = pw.DevicePairwiseAligner(device=cuda)
    got = al.edit_align_batch(pairs)
    assert al.exact_pairs == len(pairs)
    assert got == [edit_align(q, t) for q, t in pairs]


def test_wrappers_raise_on_wrong_inputs(cuda):
    t = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    q = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    n = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pw.tiled_nw(t, q, n.cpu(), n)  # mixed devices
    with pytest.raises(ValueError):
        pw.tiled_nw(t, torch.zeros((2, 40), dtype=torch.int32, device=cuda), n, n)  # W % 32


def _sized(rng, codes, n):
    return np.concatenate([codes[:n], _codes(rng, max(0, n - len(codes)))])


def k4_case(name):
    """(query, target) tiles of one K4 case at the aligner's 512x512 bucket
    (as `tests/test_torch_pairwise_tiles.py` models them on the CPU)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "target lengths":
        return [(_sized(rng, encode(mutate(rng, rand_seq(rng, n), 0.08)), min(511, n + 3)),
                 _codes(rng, n)) for n in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 510)]
    if name == "query lengths":
        out = []
        for n in (1, 31, 32, 33, 127, 128, 129, 510, 511):
            t = rand_seq(rng, max(1, min(511, n + int(rng.integers(-5, 6)))))
            out.append((_sized(rng, encode(mutate(rng, t, 0.08)), n), encode(t)))
        return out
    if name == "query much longer":
        return [(_codes(rng, 500), _codes(rng, n)) for n in (1, 5, 40, 130)]
    if name == "target much longer":
        return [(_codes(rng, n), _codes(rng, 505)) for n in (1, 5, 40, 130)]
    if name == "identical":
        t = _codes(rng, 511)
        return [(t, t), (t[:300], t[:300]), (t[:64], t[:64]), (t[:1], t[:1])]
    if name == "unrelated codes":
        return [(_codes(rng, int(rng.integers(1, 512))), _codes(rng, int(rng.integers(1, 512))))
                for _ in range(8)] + [(_codes(rng, 3), _codes(rng, 511))]
    if name in ("NP 1", "NP 64", "NP 512"):
        return [(q[:511], t) for q, t in _noisy_pairs(rng, int(name.split()[1]), 400, 510)]
    raise ValueError(name)


K4_CASES = ("target lengths", "query lengths", "query much longer", "target much longer",
            "identical", "unrelated codes", "NP 1", "NP 64", "NP 512")


@pytest.mark.parametrize("case", K4_CASES)
def test_tiled_kernel_cases_match_plain(cuda, case):
    """K4 against its plain version at T = W = 512, all four outputs whole:
    target lengths on both sides of a chunk, a fetch batch and a walk stage,
    query lengths on both sides of a warp's lanes, one length far beyond the
    other, identical and unrelated sequences, pack_tiles' padding slots, and
    1, 64 and 512 tiles (the aligner's TILES_PER_LAUNCH) a launch."""
    tiles = k4_case(case)
    args = pw.tiled_inputs(*pw.pack_tiles(tiles, 512, 512), cuda)
    if case.startswith("NP"):  # exactly that many tiles: no padding slots
        args = tuple(a[: len(tiles)].contiguous() for a in args)
    want = pw._tiled_plain(*args)
    before = _build.LAUNCHES["pairwise_tiled"]
    got = pw.tiled_nw(*args)
    assert _build.LAUNCHES["pairwise_tiled"] == before + 1
    for name, g, w in zip(("pt", "pq", "count", "dist"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("W", [32, 64, 96, 1024])
def test_tiled_kernel_widths_match_plain(cuda, W):
    """K4 at other tile widths: one warp of 1 or 2 lanes a thread, 3 warps,
    and 8 lanes a thread."""
    rng = np.random.default_rng(W)
    tiles = [(_codes(rng, W - 1), _codes(rng, W // 2 + 1))] + [
        (q[: W - 1], t) for q, t in _noisy_pairs(rng, 5, max(2, W // 3), W - 2)]
    args = pw.tiled_inputs(*pw.pack_tiles(tiles, W + 8, W), cuda)
    for name, g, w in zip(("pt", "pq", "count", "dist"), pw.tiled_nw(*args), pw._tiled_plain(*args)):
        assert torch.equal(g, w), name


def test_device_aligner_tiled_route_matches_cpu(cuda):
    """`DevicePairwiseAligner` on pairs of 3-6 kb, past the banded buckets:
    the anchor-tiled route through K4 gives the CIGARs of the same aligner
    on "cpu" (the plain version)."""
    pairs = _pairs(8, 4, 3000, 6000, rate=0.08)
    gpu, cpu = pw.DevicePairwiseAligner(device=cuda), pw.DevicePairwiseAligner(device="cpu")
    before = _build.LAUNCHES["pairwise_tiled"]
    got = gpu.edit_align_batch(pairs)
    assert _build.LAUNCHES["pairwise_tiled"] == before + 1
    assert gpu.device_tiles > len(pairs) and gpu.exact_pairs == 0
    assert got == cpu.edit_align_batch(pairs)
    assert gpu.device_tiles == cpu.device_tiles


def graph_batch(seed, B, N, per_node=2, a_cap=32, n_lo=None):
    """B random POA-like DAGs of n_lo (N / 2 by default) to N nodes and
    per_node * N edges at most: a chain through every node plus forward
    skip edges of up to 40 nodes, inserted in a random order; the prune
    cycle's inputs of G1 (with every edge kept, adjacency rows of a_cap
    slots) and of G2 (the renumbered component)."""
    rng = np.random.default_rng(seed)
    E = per_node * N
    tails = np.zeros((B, E), np.int64)
    heads = np.zeros((B, E), np.int64)
    n_nodes = rng.integers(N // 2 if n_lo is None else n_lo, N + 1, size=B)
    n_edges = np.zeros(B, np.int64)
    for b in range(B):
        n = int(n_nodes[b])
        s = rng.integers(0, n - 1, size=(per_node - 1) * n)
        t = np.minimum(s + rng.integers(2, 41, size=(per_node - 1) * n), n - 1)
        pairs = sorted({(i, i + 1) for i in range(n - 1)} | {(int(a), int(c)) for a, c in zip(s, t) if a < c})
        pairs = [pairs[k] for k in rng.permutation(len(pairs))][:E]
        n_edges[b] = len(pairs)
        tails[b, : len(pairs)], heads[b, : len(pairs)] = zip(*pairs)
    t, h = torch.from_numpy(tails), torch.from_numpy(heads)
    valid = torch.from_numpy(np.arange(E)[None, :] < n_edges[:, None])
    alive = torch.from_numpy(np.arange(N)[None, :] < n_nodes[:, None])
    comp, root = gc.select_component(gc.cc_min_labels(t, h, valid, alive), alive)
    adj, deg, _ = gc.build_undirected_adjacency(t, h, valid, N, a_cap)
    new_id, order, n_sub = gc.dfs_preorder(adj, deg, comp, root)
    codes = torch.from_numpy(rng.integers(0, 4, size=(B, N)))
    t2, h2, _, v2, _, _ = gc.renumber_subgraph(t, h, valid, new_id, order, codes)
    in_nbr, indeg, _, _ = gc.build_in_slots(t2, h2, v2, N, 16)
    return (adj, deg, comp, root), (in_nbr, indeg, n_sub)


@pytest.mark.parametrize("N", [256, 1152, 2048])
def test_graph_dfs_and_topo_kernels_match_plain(cuda, N):
    """G1 and G2 at the cycle's batch (B = 64) and node ladder: the kernels
    on the card against the plain machines on the same inputs; G1 stages
    every window's slots in shared memory (4N hold a graph of 2N edges)."""
    g1_in, g2_in = graph_batch(N, 64, N)
    assert gc.dfs_compact(g1_in[1], 32).all()
    before = dict(_build.LAUNCHES)
    got = gc.dfs_preorder(*(a.to(cuda) for a in g1_in))
    assert _build.LAUNCHES["graph_dfs"] == before["graph_dfs"] + 1
    for name, g, w in zip(("new_id", "order", "n_sub"), got, gc._dfs_plain(*(a.to(cuda) for a in g1_in))):
        assert torch.equal(g.long(), w.long()), name
    _topo_equals(cuda, g2_in, "shared")
    assert gc.topo_staged(*g2_in[::2]).all()


def _topo_equals(cuda, args, form):
    """G2 on the card against its plain machine on the card, with its
    launch and its form counted."""
    N = args[0].shape[1]
    before = _build.LAUNCHES["graph_topo"]
    forms = _build.BUILD_FORMS[("graph_topo", N, form)]
    got = gc.topo_ranks(*(a.to(cuda) for a in args))
    assert _build.LAUNCHES["graph_topo"] == before + 1
    assert _build.BUILD_FORMS[("graph_topo", N, form)] == forms + 1
    want = gc._topo_plain(*(a.to(cuda) for a in args))
    for name, g, w in zip(("rank_of", "rank_to_node"), got, want):
        assert torch.equal(g.long(), w.long()), name


def test_graph_topo_kernel_rows_past_shared_memory(cuda):
    """G2 at N = 8192 (B = 16, 1024 to 8192 nodes a window), where a
    window of more than topo_row_cap nodes reads its rows where they lie
    and a smaller one stages them: both in one launch, against the plain
    machine; and at P = 2, where every window's rows fit."""
    N = 8192
    _, (in_nbr, indeg, n_sub) = graph_batch(31, 16, N, n_lo=1024)
    staged = gc.topo_staged(in_nbr, n_sub)
    assert gc.topo_row_cap(N, 16) < N and staged.any() and not staged.all()
    _topo_equals(cuda, (in_nbr, indeg, n_sub), "by window")
    assert gc.topo_row_cap(N, 2) == N
    _topo_equals(cuda, (in_nbr[:, :, :2].contiguous(), indeg, n_sub), "shared")


def test_graph_topo_kernel_tails_past_n(cuda):
    """G2 at B = 64 N = 1152 with n_sub cut 8 below the graph in every
    other window, so that tails lie past n there: those windows read their
    rows where they lie, the others stage them, in one launch against the
    plain machine."""
    N = 1152
    _, (in_nbr, indeg, n_sub) = graph_batch(N + 5, 64, N)
    n_sub = n_sub.clone()
    n_sub[::2] -= 8
    staged = gc.topo_staged(in_nbr, n_sub)
    assert staged[1::2].all() and int((~staged[::2]).sum()) >= 16
    _topo_equals(cuda, (in_nbr, indeg, n_sub), "shared")


@pytest.mark.parametrize("case", ["deg_past_a", "root_outside", "past_slot_cap"])
def test_graph_dfs_kernel_on_edge_windows(cuda, case):
    """G1 at B = 64 N = 1152 against its plain machine: adjacency rows cut at
    A = 3 below most degrees; roots outside their component in every other
    window; windows of 6N edges, whose slots pass dfs_slot_cap, so that the
    block walks their rows where they lie."""
    N = 1152
    per_node, a_cap = {"deg_past_a": (2, 3), "root_outside": (2, 32), "past_slot_cap": (6, 32)}[case]
    adj, deg, comp, root = graph_batch(N + 7, 64, N, per_node, a_cap)[0]
    if case == "root_outside":
        comp[::2] &= torch.arange(N)[None, :] != root[::2, None]
    compact = gc.dfs_compact(deg, a_cap)
    if case == "past_slot_cap":
        assert compact.sum() < 16, int(compact.sum())
    else:
        assert compact.all()
    if case == "deg_past_a":
        assert int((deg > a_cap).sum()) > 64 * 100
    args = [a.to(cuda) for a in (adj, deg, comp, root)]
    before = _build.LAUNCHES["graph_dfs"]
    got = gc.dfs_preorder(*args)
    assert _build.LAUNCHES["graph_dfs"] == before + 1
    want = gc._dfs_plain(*args)
    for name, g, w in zip(("new_id", "order", "n_sub"), got, want):
        assert torch.equal(g.long(), w.long()), name
    if case == "root_outside":
        assert (want[2][::2] == 0).all() and torch.equal(want[1][::2, 0], args[3][::2])


def test_cycle_kernels_do_not_spill(cuda):
    """G1 and G2: no local memory (no spills), registers within the block's
    share; G1's slot capacity and shared memory as its Python mirror gives
    them, within the 227 KB a block can opt into."""
    for kernel in ("graph_dfs", "graph_topo"):
        at = gc.kernel_attrs(kernel)
        assert 0 < at["registers"] <= 128 and at["local_bytes"] == 0, (kernel, at)
    for N in (256, 1152, 2048, 8192):
        for A in (3, 32):
            cap = gc.dfs_slot_cap(N, A)
            assert gc.dfs_smem(N, A) == (cap, gc.dfs_fixed_bytes(N) + 4 * cap)
            assert gc.dfs_smem(N, A)[1] <= gc.SMEM_OPTIN
        for P in (2, 16, 32):
            cap = gc.topo_row_cap(N, P)
            assert gc.topo_smem(N, P) == (cap, gc.topo_smem_bytes(N, P, cap))
            assert gc.topo_smem(N, P)[1] <= gc.SMEM_OPTIN
            assert cap == N or N == 8192


def test_graph_kernels_empty_batch_and_wrong_inputs(cuda):
    g1_in, g2_in = graph_batch(1, 2, 64)
    out = gc.dfs_preorder(*(a[:0].to(cuda) for a in g1_in))
    assert [tuple(o.shape) for o in out] == [(0, 64), (0, 64), (0,)]
    adj, deg, comp, root = (a.to(cuda) for a in g1_in)
    with pytest.raises(ValueError):
        gc.dfs_preorder(torch.zeros((2, 64, 33), dtype=torch.int32, device=cuda), deg, comp, root)
    in_nbr, indeg, n_sub = (a.to(cuda) for a in g2_in)
    with pytest.raises(ValueError):
        gc.topo_ranks(torch.zeros((2, 64, 33), dtype=torch.int32, device=cuda), indeg, n_sub)


def test_haplotype_cycle_on_the_card_matches_cpu(cuda):
    """One window batch through the whole prune cycle on the card (G1, G2,
    K1, the dense walk and the torch ops) and on the CPU (the plain
    versions): every output equal."""
    rng = np.random.default_rng(8)
    B, N, D, S = 12, 256, 8, 128
    E = 2 * N
    arrays = dict(tails=np.zeros((B, E), np.int32), heads=np.zeros((B, E), np.int32),
                  weights=np.zeros((B, E), np.int32), n_edges=np.zeros(B, np.int32),
                  codes=np.zeros((B, N), np.int32), n_nodes=np.zeros(B, np.int32))
    seqs = np.full((B, D, S), 0xFF, np.int32)
    slen = np.ones((B, D), np.int32)
    is_sw = np.zeros((B, D), bool)
    d_used = rng.integers(3, D + 1, size=B).astype(np.int32)
    for b in range(B):
        base = rand_seq(rng, 100)
        g = make_graph()
        for k in range(int(d_used[b])):
            c = encode(mutate(rng, base))[: S - 4]
            aln = g.align_host(c, "nw", 3, -5, -4) if g.num_nodes() else []
            g.add_alignment(aln, c, np.ones(len(c), np.uint32))
            seqs[b, k, : len(c)] = c
            slen[b, k] = len(c)
            is_sw[b, k] = k % 3 == 2
        ed = gc.graph_to_edges(g, N, E)
        for key in arrays:
            arrays[key][b] = ed[key]
    avg = (2.0 * slen.sum(1) / slen[:, 0]).astype(np.float32)
    args = [arrays[k] for k in ("tails", "heads", "weights", "n_edges", "codes", "n_nodes")]
    args += [avg, seqs, slen, np.ones((B, D, S), np.int32), is_sw, d_used]
    before = dict(_build.LAUNCHES)
    got = gc.haplotype_cycle(*(torch.from_numpy(a).to(cuda) for a in args), 0.2, 0.2, 3, 3, -5, -4)
    for k in ("graph_dfs", "graph_topo", "poa_dp", "poa_walk_dense"):
        assert _build.LAUNCHES[k] >= before[k] + 3, k
    want = gc.haplotype_cycle(*(torch.from_numpy(a) for a in args), 0.2, 0.2, 3, 3, -5, -4)
    for name, g, w in zip(("corrected", "out_len", "overflow", "n_sub"), got, want):
        assert torch.equal(g.cpu().long(), w.long()), name
    assert (want[1] > 50).all() and not want[2].any()


# ------------------------------------------- the device build: G3, G4, G5


def build_state(seed, B, N, R=8, ring_over=False, n_lo=None):
    """B random graph states as the device build keeps them: a chain through
    every node plus forward skip edges (graph_batch's DAGs, E = 2N), and
    columns of 2-4 nearby nodes aligned to each other (every member's ring
    the other members, in a random order), over n_lo (N / 2 by default) to
    N nodes. With `ring_over`, some ring counts pass R (the rings cut at R
    slots)."""
    rng = np.random.default_rng(seed)
    E = 2 * N
    tails = np.zeros((B, E), np.int32)
    heads = np.zeros((B, E), np.int32)
    n_nodes = rng.integers(N // 2 if n_lo is None else n_lo, N + 1, size=B).astype(np.int32)
    n_edges = np.zeros(B, np.int32)
    aligned = np.zeros((B, N, R), np.int32)
    acount = np.zeros((B, N), np.int32)
    for b in range(B):
        n = int(n_nodes[b])
        s = rng.integers(0, n - 1, size=n)
        t = np.minimum(s + rng.integers(2, 41, size=n), n - 1)
        pairs = sorted({(i, i + 1) for i in range(n - 1)} | {(int(a), int(c)) for a, c in zip(s, t) if a < c})
        pairs = [pairs[k] for k in rng.permutation(len(pairs))][:E]
        n_edges[b] = len(pairs)
        tails[b, : len(pairs)], heads[b, : len(pairs)] = zip(*pairs)
        v = int(rng.integers(0, 4))
        while v < n - 4:
            col = list(range(v, v + int(rng.integers(2, 5)), 1))
            for m in col:
                ring = [x for x in col if x != m]
                rng.shuffle(ring)
                aligned[b, m, : len(ring)] = ring
                acount[b, m] = len(ring)
            v += len(col) + int(rng.integers(3, 12))
        if ring_over:
            acount[b, rng.integers(0, n, size=4)] = R + 2
    codes = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    return dict(codes=codes, tails=tails, heads=heads, weights=rng.integers(1, 9, size=(B, E)).astype(np.int32),
                n_nodes=n_nodes, n_edges=n_edges, aligned=aligned, acount=acount)


def _t(d, keys, device):
    return [torch.from_numpy(np.ascontiguousarray(d[k])).to(device) for k in keys]


def topo_bundled_inputs(N, B, p_cap, ring_over=False):
    """G3's inputs on `build_state`'s graphs: in-slots of p_cap, the rings."""
    st = build_state(N, B, N, ring_over=ring_over)
    t, h, ne = (torch.from_numpy(st[k]) for k in ("tails", "heads", "n_edges"))
    valid = torch.arange(2 * N)[None, :] < ne.long()[:, None]
    in_nbr, indeg, _, _ = gc.build_in_slots(t, h, valid, N, p_cap)
    return [in_nbr, indeg, torch.from_numpy(st["aligned"]), torch.from_numpy(st["acount"]),
            torch.from_numpy(st["n_nodes"])]


def _topo_bundled_equals(cuda, args, want, label):
    """G3 on the card against `want`, with its launch and form counted;
    returns the form."""
    N, P, R = args[0].shape[1], args[0].shape[2], args[2].shape[2]
    form = gb.kernel_form("graph_topo_bundled", N, R=R, P=P)
    before = _build.LAUNCHES["graph_topo_bundled"]
    forms = _build.BUILD_FORMS[("graph_topo_bundled", N, form)]
    got = gb.topo_ranks_bundled(*(a.to(cuda) for a in args))
    assert _build.LAUNCHES["graph_topo_bundled"] == before + 1
    assert _build.BUILD_FORMS[("graph_topo_bundled", N, form)] == forms + 1
    for name, g, w in zip(("rank_of", "rank_to_node"), got, want):
        assert torch.equal(g.cpu().long(), w.cpu().long()), (name, label)
    return form


@pytest.mark.parametrize("N", [256, 1152, 2048, 4096])
def test_graph_topo_bundled_kernel_matches_plain(cuda, N):
    """G3 at the build's batch (B = 64) and node ladder, in-slots whole (P =
    16) and cut short (P = 2), rings within R and past it; at N = 4096
    (B = 16) with P = 16 past a block's shared memory, the global form (P
    = 2 still fits). A ring past R
    scatters several ranks into one slot: the plain machine on the CPU
    keeps the last of them, on the card any, so those windows are held to
    it on the CPU."""
    B = 16 if N > 2048 else 64
    ring_over = N == 1152
    for p_cap in (16, 2):
        args = topo_bundled_inputs(N, B, p_cap, ring_over=ring_over)
        want = gb._topo_bundled_plain(*(a if ring_over else a.to(cuda) for a in args))
        form = _topo_bundled_equals(cuda, args, want, p_cap)
        assert form == ("global" if N > 2048 and p_cap == 16 else "shared")


@pytest.mark.parametrize("N", [1152, 4096])
@pytest.mark.parametrize("case", ["cyclic", "counts_past_caps"])
def test_graph_topo_bundled_kernel_on_flagged_windows(cuda, case, N):
    """G3 in both forms on windows only a flagged build gives it, against
    the plain machine on the CPU, whose scatters keep the last of several
    writes to one slot (on the card their order is not fixed): cycles (the
    stack past N, every write clamped, the machine stopped by
    topo_steps(N)), in-degrees past P and ring counts past R (rings of
    padding, ranks past N)."""
    args = topo_bundled_inputs(N, 8, 16)
    in_nbr, indeg, aligned, acount, n_nodes = args
    if case == "cyclic":
        in_nbr[::2, 0, 0], in_nbr[::2, 1, 0] = 1, 0
        indeg[::2, :2] = indeg[::2, :2].clamp_min(1)
        in_nbr[1::2, 40, 0], indeg[1::2, 40] = 60, indeg[1::2, 40].clamp_min(1)
    else:
        rng = np.random.default_rng(N)
        for b in range(8):
            nodes = torch.from_numpy(rng.integers(0, int(n_nodes[b]), size=40))
            indeg[b, nodes[:20]] += 16
            acount[b, nodes[20:]] = aligned.shape[2] + torch.from_numpy(rng.integers(1, 40, size=20)).int()
    form = _topo_bundled_equals(cuda, args, gb._topo_bundled_plain(*args), case)
    assert form == ("global" if N > 2048 else "shared")


@pytest.mark.parametrize("N", [256, 1152, 2048, 8192])
def test_graph_reach_kernel_matches_plain(cuda, N):
    """G5 at B = 64 (16 at N = 8192, past shared memory: the global form):
    spans inside the graph, end < begin, end past the nodes, full-span
    windows; every fourth window's first 40 edges appended again (duplicate
    in-edges in its groups)."""
    B = 16 if N > 2048 else 64
    st = build_state(N + 1, B, N)
    for b in range(0, B, 4):
        ne = int(st["n_edges"][b])
        k = min(40, 2 * N - ne)
        for key in ("tails", "heads"):
            st[key][b, ne : ne + k] = st[key][b, :k]
        st["n_edges"][b] = ne + k
    rng = np.random.default_rng(N)
    n = st["n_nodes"]
    begin = rng.integers(0, n // 2).astype(np.int32)
    end = (n - 1 - rng.integers(0, 20, size=B)).astype(np.int32)
    end[::9] = begin[::9] - 1
    end[1::9] = n[1::9] + 2
    use_full = rng.random(B) < 0.2
    args = _t(st, ("tails", "heads", "n_edges", "aligned", "acount"), cuda)
    args += [torch.from_numpy(a).to(cuda) for a in (begin, end, use_full)]
    args.append(torch.from_numpy(n).to(cuda))
    form = gb.kernel_form("graph_reach", N, 2 * N, 8)
    assert form == ("global" if N > 4096 else "shared")
    before, forms = _build.LAUNCHES["graph_reach"], _build.BUILD_FORMS[("graph_reach", N, form)]
    got = gb.reach_keep(*args)
    assert _build.LAUNCHES["graph_reach"] == before + 1
    assert _build.BUILD_FORMS[("graph_reach", N, form)] == forms + 1
    want = gb._reach_plain(*args)
    assert torch.equal(got, want) and int(want.sum()) > 0


def fuse_inputs(st, seed, L, W, labels, crowd=False):
    """Random pair streams over the graph states (node ids of the graph or
    -1, positions in order with deletions; unaligned runs at both ends of
    every other window), one window with count 0 and one inactive; with
    `crowd` every window starts 10 nodes short of N (nodes overflow)."""
    rng = np.random.default_rng(seed)
    B, N = st["codes"].shape
    E = st["tails"].shape[1]
    pairs = np.full((B, L, 2), -2, np.int32)
    count = np.zeros(B, np.int32)
    seq = np.full((B, W), 0xFF, np.int32)
    seq_w = rng.integers(0, 40, size=(B, W)).astype(np.int32)
    seq_len = rng.integers(W // 2, W - 8, size=B).astype(np.int32)
    for b in range(B):
        sl = int(seq_len[b])
        seq[b, :sl] = rng.integers(0, 4, size=sl)
        lo, hi = (int(rng.integers(1, 6)), sl - int(rng.integers(1, 6))) if b % 2 else (0, sl)
        rows = []
        for p in range(lo, hi):
            if rng.random() < 0.1:
                rows.append((int(rng.integers(0, st["n_nodes"][b])), -1))
            rows.append((int(rng.integers(0, st["n_nodes"][b])) if rng.random() < 0.85 else -1, p))
        rows = rows[:L]
        pairs[b, L - len(rows) :] = rows
        count[b] = len(rows)
    count[4] = 0
    active = np.ones(B, bool)
    active[5] = False
    n_nodes = np.maximum(st["n_nodes"], N - 10) if crowd else st["n_nodes"]
    g = [st["codes"], st["tails"], st["heads"], st["weights"], n_nodes, st["n_edges"],
         st["aligned"], np.minimum(st["acount"], st["aligned"].shape[2])]
    out = g + [pairs, count, seq, seq_w, seq_len, active]
    if labels:
        out += [rng.integers(-2**31, 2**31, size=(B, E)).astype(np.int32) for _ in range(2)]
        out += [np.full(B, -2**31, np.int32), np.full(B, 1 << 7, np.int32)]
    return out


FUSE_NAMES = ("codes", "tails", "heads", "weights", "n_nodes", "n_edges", "aligned", "acount",
              "overflow", "lab_lo", "lab_hi")


def _fuse_equals_plain(device, args, N):
    """G4 through `fuse_walk` against the plain walk on the same inputs,
    every output of every window; the launch counted in the form its size
    takes. Returns the outputs."""
    dev_args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]
    E, R = args[1].shape[1], args[6].shape[2]
    form = gb.kernel_form("graph_fuse", N, E, R, len(args) > 14)
    before, forms = _build.LAUNCHES["graph_fuse"], _build.BUILD_FORMS[("graph_fuse", N, form)]
    got = gb.fuse_walk(*dev_args)
    assert _build.LAUNCHES["graph_fuse"] == before + 1
    assert _build.BUILD_FORMS[("graph_fuse", N, form)] == forms + 1
    want = gb._fuse_plain(*dev_args)
    for name, g, w in zip(FUSE_NAMES, got, want):
        assert torch.equal(g.long(), w.long()), name
    # the inputs were not written
    assert torch.equal(dev_args[0].cpu(), torch.from_numpy(args[0]))
    return got


@pytest.mark.parametrize("labels", [False, True], ids=["plain", "labels"])
@pytest.mark.parametrize("N", [256, 1152, 2048, 4096])
def test_graph_fuse_kernel_matches_plain(cuda, N, labels):
    """G4 at B = 64 (16 at N = 4096, past shared memory: the global form)
    and the build's shapes (L = N + 577, W = 576): every output of every
    window equal to the plain walk, flagged ones included; at N = 1152 every
    window starts 10 nodes short of N, so nodes overflow, and at N = 256 the
    edge table is nearly full, so edges overflow."""
    B = 16 if N > 2048 else 64
    st = build_state(N + 2, B, N)
    if N == 256:
        st["n_edges"] = np.full(B, 2 * N - 20, np.int32)
    assert gb.kernel_form("graph_fuse", N, 2 * N, 8, labels) == ("global" if N > 2048 else "shared")
    got = _fuse_equals_plain(cuda, fuse_inputs(st, N, N + 577, 576, labels, crowd=N == 1152), N)
    if N in (256, 1152):
        assert (got[8] != 0).any()


@pytest.mark.parametrize("labels", [False, True], ids=["plain", "labels"])
@pytest.mark.parametrize("case", ["dups", "clamp"])
@pytest.mark.parametrize("N", [1152, 4096])
def test_graph_fuse_kernel_edge_lookup_cases_match_plain(cuda, N, case, labels):
    """G4's edge lookup where it is hard, in both forms: duplicate (tail,
    head) edges walked (the lowest slot takes the weight and labels), and
    appends at the E - 1 clamp with lookups of the overwritten edge and of
    the new one (`with_duplicate_edges`, `at_the_edge_cap`)."""
    B = 16 if N > 2048 else 64
    args = fuse_inputs(build_state(N + 3, B, N), N + 1, N + 577, 576, labels)
    if case == "dups":
        args, changed = with_duplicate_edges(args)
        assert len(changed) >= B // 2
    else:
        args = at_the_edge_cap(args)
    got = _fuse_equals_plain(cuda, args, N)
    ovf = got[8].cpu().numpy()
    if case == "clamp":
        assert (ovf[:4] & gb.OVF_E_CAP).all()


def test_build_kernels_do_not_spill(cuda):
    """G3, G4 and G5 in both forms: no local memory (no spills), and
    registers within the block's share."""
    for kernel, forms in (("graph_topo_bundled", ("shared", "global")), ("graph_fuse", ("shared", "global")),
                          ("graph_reach", ("shared", "global"))):
        for form in forms:
            at = gb.kernel_attrs(kernel, form)
            assert 0 < at["registers"] <= 255 and at["local_bytes"] == 0, (kernel, form, at)


def test_build_kernels_empty_batch_and_wrong_inputs(cuda):
    st = build_state(3, 8, 64)
    t, h, ne = (torch.from_numpy(st[k]) for k in ("tails", "heads", "n_edges"))
    in_nbr, indeg, _, _ = gc.build_in_slots(t, h, torch.arange(128)[None, :] < ne.long()[:, None], 64, 16)
    topo = [in_nbr, indeg] + [torch.from_numpy(st[k]) for k in ("aligned", "acount", "n_nodes")]
    out = gb.topo_ranks_bundled(*(a[:0].to(cuda) for a in topo))
    assert [tuple(o.shape) for o in out] == [(0, 64), (0, 64)]
    with pytest.raises(ValueError):  # P + R past a warp
        gb.topo_ranks_bundled(torch.zeros((8, 64, 30), dtype=torch.int32, device=cuda),
                              *(a.to(cuda) for a in topo[1:]))
    reach = _t(st, ("tails", "heads", "n_edges", "aligned", "acount"), cuda)
    reach += [torch.zeros(8, dtype=torch.int32, device=cuda), torch.full((8,), 5, dtype=torch.int32, device=cuda),
              torch.zeros(8, dtype=torch.bool, device=cuda), torch.from_numpy(st["n_nodes"]).to(cuda)]
    assert tuple(gb.reach_keep(*(a[:0] for a in reach)).shape) == (0, 64)
    with pytest.raises(ValueError):  # begin of the wrong shape
        gb.reach_keep(*reach[:5], reach[5][:1], *reach[6:])
    fuse = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in fuse_inputs(st, 1, 96, 32, False)]
    out = gb.fuse_walk(*(a[:0] for a in fuse))
    assert [tuple(o.shape) for o in out[:2]] == [(0, 64), (0, 128)]
    with pytest.raises(ValueError):  # pairs without their two columns
        gb.fuse_walk(*fuse[:8], fuse[8][:, :, :1].contiguous(), *fuse[9:])


def test_device_build_and_cycle_on_the_card_match_cpu(cuda):
    """`run_device_polish` on one window batch on the card (G3, G4, G5, K1,
    the dense walk, then the cycle's G1 and G2) and on the CPU (the plain
    versions): the same windows handled, the same consensus, the same
    counts."""
    from vechat_tpu_torch.pipeline.device_cycle import run_device_polish
    from vechat_tpu_torch.pipeline.windows import Window

    def windows():
        rng = np.random.default_rng(14)
        out = []
        for k in range(12):
            base = rand_seq(rng, 110)
            bb = encode(mutate(rng, base))
            w = Window(target_id=0, rank=k, window_type=1, backbone_codes=bb,
                       backbone_quality=None, if_fasta=True)
            blen = len(bb)
            for j in range(int(rng.integers(4, 9))):
                b0 = int(rng.integers(0, 12)) if j % 3 else 0
                e0 = blen - 1 - (int(rng.integers(0, 12)) if j % 3 else 0)
                codes = encode(mutate(rng, base[b0 : e0 + 1]))
                if len(codes) and b0 < e0:
                    w.add_layer(codes, None, b0, e0)
            out.append(w)
        return out

    results = []
    for device in (cuda, "cpu"):
        be = TorchAlignerBackend(3, -5, -4, device=device)
        wins = windows()
        before = dict(_build.LAUNCHES)
        handled = run_device_polish(wins, be, 0.2, 0.2, 3)
        results.append((handled, [None if w.consensus_codes is None else list(w.consensus_codes)
                                  for w in wins],
                        {k: v for k, v in be.counters().items() if k.startswith(("n_build", "build_"))}))
        if device == cuda:
            for k in ("graph_topo_bundled", "graph_fuse", "graph_reach", "poa_dp", "poa_walk_dense",
                      "graph_dfs", "graph_topo"):
                assert _build.LAUNCHES[k] > before[k], k
    assert results[0] == results[1]
    assert sum(results[1][0]) >= 10


# ------------------------------------- the device round-2 consensus: G6


def bundle_inputs(st, seed, P=16, device="cpu"):
    """The heaviest bundle's inputs on build_state's graphs (ids in
    topological order), weights 1-8 with one in twenty set to 0 (so
    branch completion runs), in-slots of P, ranked without rings by G3 on
    `device` (its plain machine on the CPU); window 3 flagged (no nodes)."""
    rng = np.random.default_rng(seed)
    B, E = st["tails"].shape
    N = st["codes"].shape[1]
    w = (st["weights"] * (rng.random((B, E)) > 0.05)).astype(np.int32)
    t, h, ne = (torch.from_numpy(st[k]) for k in ("tails", "heads", "n_edges"))
    valid = torch.arange(E)[None, :] < ne.long()[:, None]
    in_nbr, in_w, indeg, _ = gcs.build_in_slots_weighted(t, h, torch.from_numpy(w), valid, N, P)
    out_nbr, out_deg, _ = gcs.build_out_slots(t, h, valid, N, P)
    n_nodes = torch.from_numpy(st["n_nodes"]).clone()
    n_nodes[3] = 0
    ranks = gb.topo_ranks_bundled(*(a.to(device) for a in (
        in_nbr, indeg, torch.from_numpy(st["aligned"]), torch.zeros((B, N), dtype=torch.int32),
        n_nodes)))
    return [in_nbr, in_w, indeg, out_nbr, out_deg, *(a.cpu() for a in ranks), n_nodes]


def _bundle_equals(cuda, args, cap, form):
    """G6 on the card against its plain version on the card, with its
    launch and its form counted; returns the plain version's outputs and
    counts."""
    N = args[0].shape[1]
    before = _build.LAUNCHES["graph_bundle"]
    forms = _build.BUILD_FORMS[("graph_bundle", N, form)]
    got = gcs.heaviest_bundle(*args, max_branch_iters=cap)
    assert _build.LAUNCHES["graph_bundle"] == before + 1
    assert _build.BUILD_FORMS[("graph_bundle", N, form)] == forms + 1
    stats = {}
    want = gcs._heaviest_bundle_plain(*args, max_branch_iters=cap, stats=stats)
    for name, g, w in zip(("cons", "cons_len", "overflow"), got, want):
        assert torch.equal(g.long(), w.long()), (name, cap)
    return want, stats


@pytest.mark.parametrize("N", [256, 1152, 2048])
def test_graph_bundle_kernel_matches_plain(cuda, N):
    """G6 at B = 64 and the node ladder, against its plain version on the
    same inputs: the paths, their lengths and the branch-cap flags, at the
    default cap (no window flagged) and at a cap of 2 passes (some
    flagged); the window without nodes gives an empty path."""
    args = [a.to(cuda) for a in bundle_inputs(build_state(N + 9, 64, N), N)]
    assert gcs.bundle_staged(args[7], N, 16).all()
    for cap in (64, 2):
        want, stats = _bundle_equals(cuda, args, cap, "shared")
        assert int(want[1][3]) == 0 and stats["branch_passes"] > 0
        assert bool(want[2].any()) == (cap == 2)
    assert (want[1] > 10).sum() >= 60


def test_graph_bundle_kernel_ranks_past_shared_memory(cuda):
    """G6 at N = 8192 (B = 8, 1024 to 8192 nodes a window), where a window
    of more than bundle_rank_cap ranks reads its rows where they lie and a
    smaller one stages them: both in one launch, against the plain
    version."""
    N = 8192
    args = [a.to(cuda) for a in bundle_inputs(build_state(41, 8, N, n_lo=1024), 41,
                                               device=cuda)]
    staged = gcs.bundle_staged(args[7], N, 16)
    assert gcs.bundle_rank_cap(N, 16) < N and staged.any() and not staged.all()
    want, stats = _bundle_equals(cuda, args, 64, "by window")
    assert stats["branch_passes"] > 0 and (want[1] > 900).sum() >= 4


def test_graph_bundle_kernel_at_the_branch_cap(cuda):
    """G6 on chains whose branch completion runs to the 64-pass cap (B =
    64, N = 256), against the plain version: the flags, the paths and
    their lengths, with ties of weight and score in a quarter of them."""
    args = [torch.from_numpy(a).to(cuda) for a in chain_bundle_windows(64, 256, 5)]
    want, stats = _bundle_equals(cuda, args, 64, "shared")
    assert int(want[2].sum()) >= 48 and stats["branch_passes"] >= 48 * 64


def test_bundle_kernel_does_not_spill(cuda):
    """G6: no local memory (no spills), registers within the block's share;
    its rank capacity and shared memory as its Python mirror gives them,
    within what a block can opt into beside its static word."""
    at = gcs.kernel_attrs()
    assert 0 < at["registers"] <= 128 and at["local_bytes"] == 0, at
    assert at["static_smem_bytes"] <= 232448 - gcs.SMEM_ROOM
    for N in (256, 1152, 2048, 4096, 8192):
        for P in (2, 16, 32):
            cap = gcs.bundle_rank_cap(N, P)
            assert gcs.bundle_smem(N, P) == (cap, gcs.bundle_smem_bytes(N, P, cap))
            assert gcs.bundle_smem(N, P)[1] <= gcs.SMEM_ROOM
            assert cap == N or gcs.bundle_smem_bytes(N, P, N) > gcs.SMEM_ROOM


def test_graph_bundle_kernel_empty_batch_and_wrong_inputs(cuda):
    args = [a.to(cuda) for a in bundle_inputs(build_state(5, 8, 64), 5)]
    out = gcs.heaviest_bundle(*(a[:0] for a in args))
    assert [tuple(o.shape) for o in out] == [(0, 64), (0,), (0,)]
    with pytest.raises(ValueError):  # out-slots past a warp
        gcs.heaviest_bundle(*args[:3], torch.zeros((8, 64, 40), dtype=torch.int32, device=cuda),
                            *args[4:])
    with pytest.raises(ValueError):  # n_nodes of the wrong shape
        gcs.heaviest_bundle(*args[:7], args[7][:1])


def test_device_linear_on_the_card_matches_cpu(cuda):
    """`run_device_linear` on one window batch on the card (G3, G4, G5, K1,
    the dense walk and G6) and on the CPU (the plain versions), kTGS windows
    with the trim and NGS ones: the same windows handled, the same
    consensus, the same counts; and `device_linear` itself on the card
    against its plain version on the card."""
    from vechat_tpu_torch.pipeline.device_cycle import run_device_linear
    from vechat_tpu_torch.pipeline.windows import Window

    def windows():
        rng = np.random.default_rng(15)
        out = []
        for k in range(12):
            base = rand_seq(rng, 110)
            bb = encode(mutate(rng, base))
            w = Window(target_id=0, rank=k, window_type=k % 2, backbone_codes=bb,
                       backbone_quality=None, if_fasta=True)
            blen = len(bb)
            for j in range(int(rng.integers(4, 9))):
                b0 = int(rng.integers(0, 12)) if j % 3 else 0
                e0 = blen - 1 - (int(rng.integers(0, 12)) if j % 3 else 0)
                codes = encode(mutate(rng, base[b0 : e0 + 1]))
                if len(codes) and b0 < e0:
                    w.add_layer(codes, None, b0, e0)
            out.append(w)
        return out

    results = []
    for device in (cuda, "cpu"):
        be = TorchAlignerBackend(3, -5, -4, device=device)
        wins = windows()
        before = dict(_build.LAUNCHES)
        handled = run_device_linear(wins, be, trim=True)
        results.append((handled, [None if w.consensus_codes is None else list(w.consensus_codes)
                                  for w in wins],
                        {k: v for k, v in be.counters().items() if "linear" in k and "t_" not in k}))
        if device == cuda:
            for k in ("graph_topo_bundled", "graph_fuse", "graph_reach", "poa_dp", "poa_walk_dense",
                      "graph_bundle"):
                assert _build.LAUNCHES[k] > before[k], k
    assert results[0] == results[1]
    assert sum(results[1][0]) >= 10

    from vechat_tpu_torch.pipeline.device_cycle import _build_args, _pack_polish

    ps = [_pack_polish(w, 32, 128) for w in windows()]
    args = _build_args(ps, cuda)[0]
    do_trim = torch.ones(len(ps), dtype=torch.bool, device=cuda)
    got = gcs.device_linear(*args, do_trim, 256, 512, 8, 3, -5, -4)
    want = gcs.device_linear(*(a.cpu() for a in args), do_trim.cpu(), 256, 512, 8, 3, -5, -4)
    for name, g, w in zip(("out", "out_len", "overflow"), got, want):
        assert torch.equal(g.cpu(), w), name


# ------------------------------------------------------- B10: F1 and F2


def full_inputs(seed, B, N, P, S, depth=6, base_len=100):
    """B native window graphs of mixed sizes packed in B10's layout
    (`poa_full.poa_align_batch_full`), a query each."""
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
        base = rand_seq(rng, int(rng.integers(base_len // 2, base_len + 1)))
        g = make_graph()
        for s in [mutate(rng, base) for _ in range(depth)]:
            c = encode(s)
            aln = g.align_host(c, "nw", 3, -5, -4) if g.num_nodes() else []
            g.add_alignment(aln, c, np.ones(len(c), np.uint32))
        d = graph_to_dense(g, N, P)
        if d is None:
            continue
        codes[b], preds[b], nid[b], sink[b], nn[b] = (d["codes"], d["preds"], d["node_id"],
                                                      d["is_sink"], d["n_nodes"])
        q = encode(mutate(rng, base, 0.15))[:S]
        seq[b, : len(q)] = q
        sl[b] = len(q)
        b += 1
    return codes, preds, nid, sink, nn, seq, sl


def _full_equal_plain(device, arrs, mode, scores=(3, -5, -4)):
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    t = pf._inputs(*arrs, device)
    codes, preds, nid, sink, nn, seq, sl = t
    before = dict(_build.LAUNCHES)
    H, best = pf.full_dp(codes, preds, sink, nn, seq, sl, mode, *scores)
    got = pf.full_walk(H, best, codes, preds, nid, nn, seq, sl, mode, *scores)
    assert _build.LAUNCHES["poa_full_dp"] == before["poa_full_dp"] + 1
    assert _build.LAUNCHES["poa_full_walk"] == before["poa_full_walk"] + 1
    Hp = pf._dp_full_plain(codes, preds, nn, seq, sl, mode, *scores)
    want = pf._walk_full_plain(Hp, codes, preds, nid, sink, nn, seq, sl, mode, *scores)
    # F1 writes rows 0..n_nodes and columns 0..seq_len, every cell a result reads
    B, N1, W = Hp.shape
    real = ((torch.arange(N1, device=device)[None, :, None] <= nn.long()[:, None, None])
            & (torch.arange(W, device=device)[None, None, :] <= sl.long()[:, None, None]))
    assert torch.equal(H[real], Hp[real])
    assert torch.equal(best, pf._best_packed_plain(Hp, sink, nn, sl, mode))
    for name, a, b in zip(("pairs", "count", "score"), got, want):
        assert torch.equal(a, b), name
    cpu = pf.poa_align_batch_full(*arrs, mode, *scores, device="cpu")
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)
    return best


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("shape", [(5, 256, 4, 127, 120), (3, 1024, 8, 767, 600)])
def test_full_dp_and_walk_match_plain(cuda, mode, shape):
    B, N, P, S, base_len = shape
    _full_equal_plain(cuda, full_inputs(21, B, N, P, S, base_len=base_len), mode)


@pytest.mark.parametrize("S", [63, 95, 1023])
def test_full_dp_widths_and_other_scores_match_plain(cuda, S):
    """Widths off a warp multiple and at F1's top (1024 threads), and the
    CLI's other scores."""
    arrs = full_inputs(22, 4, 256, 4, S, depth=4, base_len=min(S, 100))
    for mode in ("nw", "sw", "ov"):
        _full_equal_plain(cuda, arrs, mode, scores=(5, -4, -8))


@pytest.mark.parametrize("S", [63, 127, 255, 511, 767])
def test_full_kernels_at_each_read_bucket(cuda, S):
    """F1 and F2 at each of B10's read buckets (1 column a thread up to
    S = 255, 4 above), B = 1 and B = 6, in every mode, against the plain
    versions."""
    N = {63: 128, 127: 256, 255: 512, 511: 1024, 767: 1024}[S]
    arrs = full_inputs(26, 6, N, 8, S, base_len=min(S - 8, N // 2))
    for mode in ("nw", "sw", "ov"):
        _full_equal_plain(cuda, [a[:1] for a in arrs], mode)
        _full_equal_plain(cuda, arrs, mode)


def far_preds_inputs(seed, B, N, P, S, far):
    """B synthesized DAGs in B10's layout whose rows take predecessors up to
    `far` rows back (every tenth row one that far), random codes and reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, N)).astype(np.uint8)
    preds = np.zeros((B, N, P), np.int32)
    for b in range(B):
        for n in range(N):
            row = n + 1
            ins = {row - 1}
            if n % 10 == 9 and row - far >= 0:
                ins.add(row - far)
            for _ in range(int(rng.integers(0, P))):
                ins.add(int(rng.integers(max(0, row - 6), row)))
            ins = sorted(ins)[:P]
            preds[b, n] = ins + [ins[0]] * (P - len(ins))
    sink = np.zeros((B, N), bool)
    sink[:, -3:] = True
    sink[:, N // 2] = True
    nid = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    nn = np.full(B, N, np.int32)
    seq = rng.integers(0, 4, (B, S)).astype(np.uint8)
    sl = rng.integers(S // 2, S + 1, B).astype(np.int32)
    return codes, preds, nid, sink, nn, seq, sl


@pytest.mark.parametrize("S", [255, 511])
@pytest.mark.parametrize("far", [16, 17, 40])
def test_full_dp_reads_rows_older_than_the_ring(cuda, far, S):
    """Predecessors `far` rows back, at 1 and 4 columns a thread: 16, the
    oldest row F1's ring of 16 keeps; 17 and 40, past it, which F1 reads
    from global memory inside the kernel. H, best and the walk equal the
    plain ones."""
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    assert pf.RING == 16
    for mode in ("nw", "sw", "ov"):
        _full_equal_plain(cuda, far_preds_inputs(27, 5, 300, 6, S, far=far), mode)


def test_full_best_ties_across_warps(cuda):
    """Equal best values in several threads and warps: a window of one node
    repeated (a chain of As) against a read of As, so that sw's and ov's
    best value recurs along a row over many threads' columns; the lowest
    flat index wins, as the reference's argmax."""
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    B, N, P, S = 3, 512, 4, 511
    codes = np.zeros((B, N), np.uint8)
    preds = np.tile(np.arange(N, dtype=np.int32)[None, :, None], (B, 1, P))
    nid = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    sink = np.ones((B, N), bool)
    nn = np.array([N, 300, 40], np.int32)
    seq = np.zeros((B, S), np.uint8)
    sl = np.array([S, 400, 450], np.int32)
    for mode in ("nw", "sw", "ov"):
        best = _full_equal_plain(cuda, (codes, preds, nid, sink, nn, seq, sl), mode)
        assert best[:, 1].min() >= 0
    # the tie itself: more than one cell of each window holds the best value
    t = pf._inputs(codes, preds, nid, sink, nn, seq, sl, cuda)
    H, best = pf.full_dp(t[0], t[1], t[3], t[4], t[5], t[6], "ov", 3, -5, -4)
    assert int((H[0, 1:, 1:] == best[0, 0]).sum()) > 1


def test_full_sw_with_every_cell_zero(cuda):
    """sw with no positive cell (a read that matches no node): best is
    (0, -1), no walk, count 0, score 0, pairs all -2."""
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    arrs = list(full_inputs(28, 3, 256, 4, 127, base_len=100))
    arrs[0][:] = 0  # every node A
    arrs[5][:] = 0xFF
    arrs[5][:, :100] = 1  # reads of C
    arrs[6][:] = 100
    best = _full_equal_plain(cuda, arrs, "sw")
    assert best.cpu().tolist() == [[0, -1]] * 3
    pairs, count, score = pf.poa_align_batch_full(*arrs, "sw", 3, -5, -4, device=cuda)
    assert count.tolist() == [0, 0, 0] and score.tolist() == [0, 0, 0]
    assert bool((pairs == -2).all())


def test_full_kernels_empty_batch_and_wrong_inputs(cuda):
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    arrs = full_inputs(23, 2, 64, 4, 63, base_len=40)
    empty = [a[:0] for a in arrs]
    pairs, count, score = pf.poa_align_batch_full(*empty, "nw", 3, -5, -4, device=cuda)
    assert pairs.shape == (0, 64 + 63 + 1, 2) and count.shape == (0,)
    wide = list(arrs)
    wide[5] = np.full((2, 1024), 0xFF, np.uint8)
    with pytest.raises(ValueError, match="1024"):
        pf.poa_align_batch_full(*wide, "nw", 3, -5, -4, device=cuda)
    many = list(arrs)
    many[1] = np.repeat(arrs[1][:, :, :1], 33, axis=2)
    with pytest.raises(ValueError, match="P <= 32"):
        pf.poa_align_batch_full(*many, "nw", 3, -5, -4, device=cuda)
    codes, preds, nid, sink, nn, seq, sl = pf._inputs(*arrs, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pf.full_dp(codes.to(torch.int32), preds, sink, nn, seq, sl, "nw", 3, -5, -4)
    with pytest.raises(ValueError, match="contiguous"):
        pf.full_dp(codes, preds, sink.bool(), nn, seq, sl, "nw", 3, -5, -4)
    H, best = pf.full_dp(codes, preds, sink, nn, seq, sl, "nw", 3, -5, -4)
    with pytest.raises(ValueError, match="contiguous"):
        pf.full_walk(H, best.long(), codes, preds, nid, nn, seq, sl, "nw", 3, -5, -4)
    with pytest.raises(ValueError, match="shape"):
        pf.full_walk(H[:, :-1].contiguous(), best, codes, preds, nid, nn, seq, sl, "nw", 3, -5,
                     -4)
    # a table past a block's shared memory: the plans refuse it, the launcher raises
    assert pf.dp_plan(30000, 8, 767)[0] == 0 and pf.walk_plan(30000, 8, 767)[0] == 0
    big = pf._inputs(np.zeros((1, 30000), np.uint8), np.zeros((1, 30000, 8), np.int32),
                     np.zeros((1, 30000), np.int32), np.ones((1, 30000), bool),
                     np.ones(1, np.int32), np.zeros((1, 767), np.uint8), np.ones(1, np.int32),
                     cuda)
    with pytest.raises(RuntimeError, match="poa_full_dp"):
        pf.full_dp(big[0], big[1], big[3], big[4], big[5], big[6], "nw", 3, -5, -4)


def test_full_kernel_attributes(cuda):
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    for mode in ("nw", "sw", "ov"):
        for which, S in (("walk", 767), ("dp", 255), ("dp", 767)):  # F1 at 1 and 4 columns
            at = pf.kernel_attrs(which, mode, S)
            assert 0 < at["registers"] <= 255 and at["local_bytes"] == 0, (which, mode, S, at)


def test_sharded_poa_align_on_one_card(cuda):
    """B10's shards on two streams of one card: the unsharded call's
    outputs, F1 and F2 launched once a shard."""
    from vechat_tpu_torch.ops.kernels import poa_full as pf
    from vechat_tpu_torch.parallel.mesh import make_mesh, sharded_poa_align

    arrs = full_inputs(24, 6, 256, 8, 127, base_len=110)
    fn = sharded_poa_align(make_mesh(["cuda:0", "cuda:0"]), "sw", 3, -5, -4)
    before = dict(_build.LAUNCHES)
    got = fn(*arrs)
    assert _build.LAUNCHES["poa_full_dp"] == before["poa_full_dp"] + 2
    assert _build.LAUNCHES["poa_full_walk"] == before["poa_full_walk"] + 2
    one = pf.poa_align_batch_full(*arrs, "sw", 3, -5, -4, device=cuda)
    for g, o in zip(got, one):
        assert g.device.type == "cpu" and torch.equal(g, o.cpu())


def test_full_backend_on_the_card_matches_cpu(cuda):
    from vechat_tpu_torch.ops.kernels.poa_full import FullAlignerBackend

    rng = np.random.default_rng(25)
    items = []
    for n in (60, 200, 450):
        base = rand_seq(rng, n)
        g = make_graph()
        for s in [mutate(rng, base) for _ in range(5)]:
            c = encode(s)
            aln = g.align_host(c, "nw", 3, -5, -4) if g.num_nodes() else []
            g.add_alignment(aln, c, np.ones(len(c), np.uint32))
        items += [(encode(mutate(rng, base)), g, m) for m in ("nw", "sw", "nw")]
    be = FullAlignerBackend(3, -5, -4)
    assert be.device.type == "cuda"
    got = be.align_batch(items)
    want = FullAlignerBackend(3, -5, -4, device="cpu").align_batch(items)
    assert got == want and be.fallbacks == 0 and be.device_alignments == len(items)
    for (codes, g, mode), aln in zip(items, got):
        assert aln == g.align_host(codes, mode, 3, -5, -4)


def test_make_backend_full_raises_without_a_card(monkeypatch):
    from vechat_tpu_torch.cli.racon_main import make_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("full", 3, -5, -4)
