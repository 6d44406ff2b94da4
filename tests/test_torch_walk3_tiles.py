"""A numpy model of the three-state walk's kernel (K5w / K6w,
`walk3_kernel` in `csrc/poa_gap.cuh`) held to the plain PyTorch version
`poa_gap._walk3_plain`, and to the JAX package's walks
(`_traceback_walk_affine` / `_traceback_walk_convex`, plain XLA on the CPU).
The kernel itself runs only on the card (`tests/test_torch_cuda.py`); the
model checks its design here, step for step:

  - one warp a walk; its tile is rows [i-63, i] by the 32 columns that end
    with the 16-byte piece (4 columns) holding j, both clamped at 0, copied
    in 16-byte pieces (a piece past W is not copied), staged again when the
    walk leaves it through its top or left edge (a vertical jump leaves it
    from its middle);
  - lane k % 32 keeps the pair of step k; every 32 steps, and once at the
    end, the 32 pairs go to columns L-1-s, their node ids loaded then and
    stored with the next chunk;
  - the warp's -2 columns before the pairs.

The direction words are drawn so that every move stays on the grid: the
vertical jumps (delta 1, 63, 64, 65, 511, and 0 to row 0), sequence-gap
chains across a tile's left edge, sw stop codes, walks cut at L, walks that
never start, widths 32 to 1024 and pair counts at the chunk boundary. An
nw walk of the reference runs past the origin where it reaches it outside
state H (ROADMAP.md, section C); such walks are held to the host engine
instead. Every output is an integer: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

from vechat_tpu_torch.ops.kernels import poa_gap
from vechat_tpu_torch.ops.kernels.poa_linear import DELTA_BITS

CHAIN_BIT = poa_gap.CHAIN_BIT
TILE_ROWS = 64
TILE_COLS = 32
UNSET = np.iinfo(np.int32).max  # a column the model has not written


def hword(K, P, hidx, delta):
    """The hcode of dispatch index hidx with `delta`."""
    return (((2 * K + 1) * (P + 1) - 1 - hidx) << DELTA_BITS) | delta


def synth_walk3(seed, B, N1, D, W, P, K, mode, jumps=(1,), p_vert=0.2, p_seq=0.2,
                p_stop=0.0, p_diag_jump=0.1):
    """Direction words [B, N1, D, W] int32 whose every move stays on the
    grid, and start cells maxi, maxj [B, D] int32 (numpy).

    H codes: a diagonal (delta 1, or with p_diag_jump one of `jumps`), a
    vertical code (extend or open of a random channel, delta from `jumps`)
    with p_vert, a sequence-gap code with p_seq (extend only where j >= 2),
    the stop code with p_stop (sw only). Column 0 is vertical (nw) or the
    stop code (sw, ov); row 0 is sequence gaps (nw) or the stop code. Chain
    codes: a vertical chain code (continue or stop, delta from `jumps`; on
    row 0 a stop of delta 0) and the sequence-gap flag where j >= 2. A
    delta past the row is clipped to it (to row 0)."""
    rng = np.random.default_rng(seed)
    VEND = (2 * K + 1) * P
    shape = (B, N1, D, W)
    i = np.broadcast_to(np.arange(N1)[None, :, None, None], shape)
    j = np.broadcast_to(np.arange(W)[None, None, None, :], shape)
    jumps = np.asarray(jumps)

    def pick_delta(p_jump=1.0):
        d = rng.choice(jumps, size=shape)
        d = np.where(rng.random(shape) < p_jump, d, 1)
        return np.minimum(d, i)

    u = rng.random(shape)
    slot = rng.integers(0, P, shape)
    # diagonal through slot, vertical code P + 2K*slot + sub, sequence gap
    # VEND + sub (sub even: extend, odd: open)
    diag = hword(K, P, slot, pick_delta(p_diag_jump))
    vsub = rng.integers(0, 2 * K, shape)
    vert = hword(K, P, P + 2 * K * slot + vsub, pick_delta())
    ssub = rng.integers(0, 2 * K, shape)
    ssub = np.where(j >= 2, ssub, ssub | 1)  # an extension needs j >= 2
    seqg = hword(K, P, VEND + ssub, 0)
    stop = hword(K, P, VEND + 2 * K, 0)
    h = np.where(u < p_vert, vert, np.where(u < p_vert + p_seq, seqg, diag))
    if mode == "sw" and p_stop:
        h = np.where(rng.random(shape) < p_stop, stop, h)
    h = np.where(i == 0, seqg if mode == "nw" else stop, h)
    h = np.where(j == 0, vert if mode == "nw" else stop, h)
    # the chain code: cidx in [0, 2P); affine: odd extends (continues);
    # convex: below P continues
    cidx = rng.integers(0, 2 * P, shape)
    # row 0's chain code stops: a vertical chain there would stay put
    cidx = np.where(i == 0, 2 * P - 2 if K == 1 else 2 * P - 1, cidx)
    cdelta = np.where(i == 0, 0, pick_delta())
    ccode = ((2 * P - 1 - cidx) << DELTA_BITS) | cdelta
    sflag = (rng.random(shape) < 0.5) & (j >= 2)
    dirs = (((sflag.astype(np.int64) << CHAIN_BIT) | ccode) << 16) | h
    maxi = rng.integers(0, N1, (B, D)).astype(np.int32)
    maxj = rng.integers(0, W, (B, D)).astype(np.int32)
    return dirs.astype(np.int32), maxi, maxj


def diagonal_walk3(B, N1, D, W, P, K, n):
    """Words of a pure diagonal: every walk from (n, n) takes n diagonal
    steps to (0, 0) in nw (row 0 and column 0 as `synth_walk3` has them)."""
    dirs, _, _ = synth_walk3(0, B, N1, D, W, P, K, "nw", p_vert=0.0, p_seq=0.0,
                             p_diag_jump=0.0)
    maxi = np.full((B, D), n, np.int32)
    return dirs, maxi, maxi.copy()


def model_walk3(dirs, maxi, maxj, mode, L, P, K, node_id=None):
    """The kernel's walk, step for step, on numpy arrays. Returns pn, pp
    [B, D, L], count [B, D] (int32), and per walk its tiles, the restages
    through each edge ("top", "left", "jump": a vertical move past the
    top from inside the tile), and its last state."""
    B, N1, D, W = dirs.shape
    NPRIO = (2 * K + 1) * (P + 1)
    VEND = (2 * K + 1) * P
    pn = np.full((B * D, L), UNSET, np.int64)
    pp = np.full((B * D, L), UNSET, np.int64)
    count = np.zeros(B * D, np.int32)
    stats = []
    for w in range(B * D):
        b, d = divmod(w, D)
        i, j = int(maxi[b, d]), int(maxj[b, d])
        active = (i != 0 and j != 0) if mode == "ov" else not (i == 0 and j == 0)
        r0, c0 = i + 1, 0
        tile = None
        st = dict(tiles=0, top=0, left=0, jump=0)
        state, cnt = 0, 0
        lanes_n, lanes_p, k = [0] * 32, [0] * 32, 0
        queued = []  # the chunk before: (column, node, position)
        prev = None  # (i, j) of the step before

        def chunk():
            nonlocal queued, k
            for col, n, p in queued:
                pn[w, col], pp[w, col] = n, p
            queued = []
            for lane in range(k):
                n = lanes_n[lane]
                if n >= 0 and node_id is not None:
                    n = int(node_id[b, n])
                queued.append((L - 1 - (cnt - k + lane), n, lanes_p[lane]))
            k = 0

        while active and cnt < L:
            if i < r0 or j < c0:
                if tile is not None:  # where the step before left the tile
                    st["left" if j < c0 else "top" if prev[0] == r0 else "jump"] += 1
                r0 = max(i - TILE_ROWS + 1, 0)
                c0 = max(((j + 4) & ~3) - TILE_COLS, 0)
                tile = np.full((TILE_ROWS, TILE_COLS), UNSET, np.int64)
                for piece in range(TILE_COLS // 4):
                    if piece * 4 < W - c0:
                        cols = slice(c0 + 4 * piece, c0 + 4 * piece + 4)
                        tile[: i - r0 + 1, 4 * piece : 4 * piece + 4] = dirs[b, r0 : i + 1, d, cols]
                st["tiles"] += 1
            word = int(tile[i - r0, j - c0])
            assert word != UNSET, "a word the tile did not stage"
            hcode, chain = word & 0xFFFF, (word >> 16) & 0xFFFF
            hidx = NPRIO - 1 - (hcode >> DELTA_BITS)
            ccode = chain & ((1 << CHAIN_BIT) - 1)
            cidx = (2 * P - 1) - (ccode >> DELTA_BITS)
            in_h, in_v, in_s = state == 0, state == 1, state == 2
            if mode == "sw" and in_h and hidx == VEND + 2 * K:
                break
            is_diag = in_h and hidx < P
            v_enter = in_h and P <= hidx < VEND
            v_ext_enter = v_enter and ((hidx - P) & 1) == 0
            s_move = in_h and VEND <= hidx < VEND + 2 * K
            s_ext = s_move and ((hidx - VEND) & 1) == 0
            v_cont = in_v and ((cidx & 1) == 1 if K == 1 else cidx < P)
            node = is_diag or v_enter or in_v
            seq = is_diag or s_move or in_s
            delta = (ccode if in_v else hcode) & ((1 << DELTA_BITS) - 1)
            lanes_n[k] = i - 1 if node else -1
            lanes_p[k] = j - 1 if seq else -1
            prev = (i, j)
            if node:
                i = 0 if delta == 0 else i - delta
            if seq:
                j -= 1
            assert i >= 0 and j >= 0, "a move off the grid"
            state = (1 if (v_ext_enter or v_cont)
                     else 2 if (s_ext or (in_s and (chain >> CHAIN_BIT) & 1)) else 0)
            cnt += 1
            k += 1
            if k == 32:
                chunk()
            if mode == "nw":
                active = not (i == 0 and j == 0)
            elif mode == "ov":
                active = not (i == 0 or j == 0)
        if k:
            chunk()
        for col, n, p in queued:
            pn[w, col], pp[w, col] = n, p
        pn[w, : L - cnt] = -2
        pp[w, : L - cnt] = -2
        count[w] = cnt
        st.update(steps=cnt, end=(i, j), state=state)
        stats.append(st)
    assert (pn != UNSET).all() and (pp != UNSET).all(), "a column no store wrote"
    return (pn.astype(np.int32).reshape(B, D, L), pp.astype(np.int32).reshape(B, D, L),
            count.reshape(B, D), stats)


def plain(dirs, maxi, maxj, mode, L, P, K, node_id=None):
    t = torch.from_numpy
    out = poa_gap._walk3_plain(t(dirs), t(maxi), t(maxj), mode, L, P, K,
                               None if node_id is None else t(node_id))
    return tuple(o.numpy() for o in out)


def node_ids(seed, B, N1):
    """A permutation of 3 * (N1 - 1) ids a graph: ids differ from ranks."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(3 * (N1 - 1))[: N1 - 1] for _ in range(B)]).astype(np.int32)


def assert_model_equals_plain(dirs, maxi, maxj, mode, L, P, K, with_ids=True):
    B, N1 = dirs.shape[:2]
    out = None
    for nid in (None, node_ids(7, B, N1)) if with_ids else (None,):
        got = model_walk3(dirs, maxi, maxj, mode, L, P, K, nid)
        want = plain(dirs, maxi, maxj, mode, L, P, K, nid)
        for name, a, b in zip(("pn", "pp", "count"), got[:3], want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} node_id={nid is not None}")
        out = out or got
    return out


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
@pytest.mark.parametrize("i0", [1099, 1000])
def test_model_equals_plain_on_vertical_jumps(K, mode, i0):
    """Jumps of 1, 63, 64, 65, 511 and 0 (to row 0), from H and from the
    vertical chain, the first walk from the bottom row or from row 1000;
    every kind of restage happens."""
    P = 4
    dirs, maxi, maxj = synth_walk3(1 + K, 2, 1100, 3, 256, P, K, mode,
                                   jumps=(1, 63, 64, 65, 511, 0), p_vert=0.15, p_seq=0.25,
                                   p_stop=0.002)
    maxi[:, 0] = i0
    *_, stats = assert_model_equals_plain(dirs, maxi, maxj, mode, 2 * 1100 + 256, P, K)
    if mode == "nw":
        assert sum(s["jump"] for s in stats) > 0 and sum(s["top"] + s["left"] for s in stats) > 0


@pytest.mark.parametrize("delta,restages", [(1, 0), (62, 0), (63, 0), (64, 1), (65, 1),
                                            (511, 1), (0, 1)])
def test_model_restages_where_a_jump_leaves_the_tile(delta, restages):
    """From the bottom row of a tile, a vertical jump of 63 lands on its top
    row and stays; 64 and more, or delta 0 (to row 0), leave it (nw)."""
    K, P, N1, W = 1, 2, 600, 32
    dirs, _, _ = synth_walk3(3, 1, N1, 1, W, P, K, "nw", p_vert=0.0, p_seq=0.0,
                             p_diag_jump=0.0)
    i0, j0 = 580, 20
    dirs[0, i0, 0, j0] = (dirs[0, i0, 0, j0] & ~0xFFFF) | hword(K, P, P + 1, delta)  # open
    maxi = np.array([[i0]], np.int32)
    maxj = np.array([[j0]], np.int32)
    pn, pp, count, stats = assert_model_equals_plain(dirs, maxi, maxj, "nw", 2 * N1 + W, P, K)
    assert stats[0]["jump"] == restages
    assert pn[0, 0, -1] == i0 - 1 and pp[0, 0, -1] == -1


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("j0", [575, 572])
def test_model_sequence_gap_chains_cross_the_left_edge(K, j0):
    """Long sequence-gap chains along a row leave the tile through its left
    edge, in the middle of the chain; the walks start on the last or the
    first column of a 16-byte piece."""
    P = 3
    dirs, maxi, maxj = synth_walk3(5, 2, 200, 2, 576, P, K, "nw", p_vert=0.05, p_seq=0.6)
    maxj[:] = j0
    *_, stats = assert_model_equals_plain(dirs, maxi, maxj, "nw", 2 * 200 + 576, P, K)
    assert sum(s["left"] for s in stats) >= 4


@pytest.mark.parametrize("W", [32, 64, 576, 1024])
@pytest.mark.parametrize("K", [1, 2])
def test_model_equals_plain_at_widths(W, K):
    """Rows one tile wide (32), and wider rows."""
    P = 8
    for mode in ("nw", "sw"):
        dirs, maxi, maxj = synth_walk3(W + K, 2, 130, 2, W, P, K, mode,
                                       jumps=(1, 2, 3, 64, 0), p_stop=0.001)
        assert_model_equals_plain(dirs, maxi, maxj, mode, 2 * 130 + W, P, K,
                                  with_ids=mode == "nw")


@pytest.mark.parametrize("n", [31, 32, 33, 64, 65])
def test_model_pair_counts_at_the_chunk_boundary(n):
    """A diagonal of n steps: n pairs, 31 to 65 around the 32-pair chunks."""
    for K in (1, 2):
        dirs, maxi, maxj = diagonal_walk3(1, 80, 2, 96, 2, K, n)
        pn, pp, count, _ = assert_model_equals_plain(dirs, maxi, maxj, "nw", 200, 2, K)
        assert (count == n).all()
        np.testing.assert_array_equal(pp[0, 0, -n:], np.arange(n))


@pytest.mark.parametrize("L", [1, 31, 32, 33, 100])
def test_model_walks_cut_at_L(L):
    for K in (1, 2):
        dirs, maxi, maxj = synth_walk3(11, 1, 300, 4, 128, 4, K, "nw", jumps=(1, 2, 5))
        maxi[:] = 299
        maxj[:] = 127
        _, _, count, _ = assert_model_equals_plain(dirs, maxi, maxj, "nw", L, 4, K)
        assert (count == L).all()


def test_model_walks_that_never_start():
    """maxi = maxj = 0 (every mode), ov from row or column 0, and sw from a
    stop code: no pairs, every column -2."""
    K, P = 2, 3
    for mode in ("nw", "sw", "ov"):
        dirs, maxi, maxj = synth_walk3(13, 2, 40, 3, 32, P, K, mode)
        maxi[0, :], maxj[0, :] = 0, 0
        maxi[1, 0], maxj[1, 0] = 0, 7
        maxi[1, 1], maxj[1, 1] = 9, 0
        pn, pp, count, _ = assert_model_equals_plain(dirs, maxi, maxj, mode, 2 * 40 + 32, P, K)
        assert (count[0] == 0).all() and (pn[0] == -2).all() and (pp[0] == -2).all()
        if mode != "nw":
            assert (count[1, :2] == 0).all()


def _jax_walk(K):
    from vechat_tpu.ops.kernels import poa_pallas_affine as jaff
    from vechat_tpu.ops.kernels import poa_pallas_convex as jcvx

    return jaff._traceback_walk_affine if K == 1 else jcvx._traceback_walk_convex


def assert_model_equals_jax(dirs, maxi, maxj, mode, L, P, K, model):
    """The JAX walk on the same words equals the model's (pn, pp, count,
    stats), walk by walk. Where the model's nw walk ended at (0, 0) outside
    state H, the reference runs past the origin: it has more pairs there,
    and its last count columns are the model's. Returns how many walks
    did so."""
    import jax.numpy as jnp

    pn, pp, count, stats = model
    jpn, jpp, jcount = (np.asarray(a) for a in _jax_walk(K)(
        jnp.asarray(dirs), jnp.asarray(maxi)[:, None, :], jnp.asarray(maxj)[:, None, :],
        mode, L, P))
    past = 0
    for w, st in enumerate(stats):
        b, d = divmod(w, dirs.shape[2])
        if mode == "nw" and st["end"] == (0, 0) and st["state"] != 0 and st["steps"] < L:
            past += 1
            c = count[b, d]
            assert jcount[b, d] > c
            np.testing.assert_array_equal(jpn[b, d, L - c :], pn[b, d, L - c :])
            np.testing.assert_array_equal(jpp[b, d, L - c :], pp[b, d, L - c :])
            continue
        np.testing.assert_array_equal(jpn[b, d], pn[b, d], err_msg=f"pn w={w}")
        np.testing.assert_array_equal(jpp[b, d], pp[b, d], err_msg=f"pp w={w}")
        assert jcount[b, d] == count[b, d]
    return past


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_model_equals_jax_walks(K, mode):
    """The model against the JAX walk on the same words, L a multiple of
    the JAX walk's 8-step unroll (`assert_model_equals_jax`)."""
    P, N1, W = 4, 300, 64
    L = 2 * N1 + W
    dirs, maxi, maxj = synth_walk3(17 + K, 3, N1, 4, W, P, K, mode,
                                   jumps=(1, 2, 63, 64, 65, 511, 0), p_stop=0.002)
    maxj[:, :2] = 0  # up column 0, where an nw walk can reach (0, 0) in the vertical chain
    model = model_walk3(dirs, maxi, maxj, mode, L, P, K)
    past = assert_model_equals_jax(dirs, maxi, maxj, mode, L, P, K, model)
    assert 0 < past < len(model[3]) if mode == "nw" else past == 0


@pytest.mark.parametrize("kind", ["affine", "convex"])
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_model_on_dp_words_equals_jax_and_host(kind, mode):
    """The model on the direction words of the port's DP (plain version),
    equals the plain version and the JAX walk, and with node ids the host
    engine's alignments, graph by graph."""
    from tests.test_torch_poa_affine import AFFINE
    from tests.test_torch_poa_convex import CONVEX
    from tests.test_torch_poa_linear import make_case, pack
    from vechat_tpu_torch.ops.kernels.poa_affine import pack_aux_gap

    k = AFFINE if kind == "affine" else CONVEX
    K = 1 if kind == "affine" else 2
    jg, tg, seqs = make_case(31, n_graphs=2, depth=3, D=3, base_len=40)
    N, P, W = 128, 4, 64
    codes, preds, sink, nid, nn, seqp, slen = pack(jg, seqs, N, P, W)
    B, D = seqp.shape[:2]
    t32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    aux, deg = pack_aux_gap(t32(preds), N)
    dirs, maxi, maxj, _ = k.port_dp(
        t32(codes).reshape(B, N), aux, deg, t32(sink).reshape(B, N), t32(nn).reshape(B),
        t32(seqp), t32(slen).reshape(B, D), mode, *k.scores, N)
    dirs, maxi, maxj = dirs.numpy(), maxi.numpy(), maxj.numpy()
    L = 2 * N + W
    ids = nid[:, 0, :].astype(np.int32)
    model = assert_model_equals_plain(dirs, maxi, maxj, mode, L, P, K, with_ids=False)
    assert_model_equals_jax(dirs, maxi, maxj, mode, L, P, K, model)
    pn_ids, pp, count, _ = model_walk3(dirs, maxi, maxj, mode, L, P, K, ids)
    np.testing.assert_array_equal(pn_ids, plain(dirs, maxi, maxj, mode, L, P, K, ids)[0])
    host = k.host(mode, *k.scores)
    for b, gr in enumerate(tg):
        for d, q in enumerate(seqs[b]):
            c = int(count[b, d])
            aln = list(zip(pn_ids[b, d, L - c :].tolist(), pp[b, d, L - c :].tolist()))
            assert aln == host.align(q, gr), f"b={b} d={d}"


@pytest.mark.parametrize("kind", ["affine", "convex"])
@pytest.mark.parametrize("query", ["CCGTACGT", "GTACGT", "TTACCGTACGT"])
def test_model_nw_walk_past_the_origin_equals_the_host(kind, query):
    """Alignments that start by deleting the start node, where the
    reference's nw walk runs past the origin: the model with node ids
    equals the host engine."""
    from tests.test_torch_poa_affine import AFFINE
    from tests.test_torch_poa_convex import CONVEX
    from tests.test_torch_poa_linear import build_graphs, pack
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels.poa_affine import pack_aux_gap

    k = AFFINE if kind == "affine" else CONVEX
    K = 1 if kind == "affine" else 2
    jgraph, tgraph = build_graphs(["ACCGTACGT"])
    q = encode(query)
    N, P, W = 64, 4, 32
    codes, preds, sink, nid, nn, seqp, slen = pack([jgraph], [[q]], N, P, W)
    t32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    aux, deg = pack_aux_gap(t32(preds), N)
    dirs, maxi, maxj, _ = k.port_dp(
        t32(codes).reshape(1, N), aux, deg, t32(sink).reshape(1, N), t32(nn).reshape(1),
        t32(seqp), t32(slen).reshape(1, 1), "nw", *k.scores, N)
    L = 2 * N + W
    pn, pp, count, _ = model_walk3(dirs.numpy(), maxi.numpy(), maxj.numpy(), "nw", L, P, K,
                                   nid[:, 0, :].astype(np.int32))
    c = int(count[0, 0])
    aln = list(zip(pn[0, 0, L - c :].tolist(), pp[0, 0, L - c :].tolist()))
    assert aln == k.host("nw", *k.scores).align(q, tgraph)
