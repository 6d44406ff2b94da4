"""Pairwise NW of the port (plain PyTorch versions of the banded and tiled
kernels on the CPU, and the DevicePairwiseAligner around them) against the
JAX package's Pallas kernels in interpret mode and the host oracle. Integer
DP results: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vechat_tpu.ops.kernels import pairwise_pallas as jpw
from vechat_tpu.ops.pairwise import edit_align as jax_edit_align
from vechat_tpu_torch.ops.kernels import pairwise_nw as tpw
from vechat_tpu_torch.ops.pairwise import edit_align


def rand_codes(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def noisy(rng, codes, rate=0.1):
    out = []
    for c in codes:
        r = rng.random()
        if r < rate * 0.5:
            out.append((c + rng.integers(1, 4)) % 4)
        elif r < rate * 0.7:
            continue
        else:
            out.append(c)
            if rng.random() < rate * 0.3:
                out.append(rng.integers(0, 4))
    return np.array(out, dtype=np.uint8)


def pack_banded(pairs, T, BW):
    """The JAX layout of DevicePairwiseAligner._run_exact (numpy)."""
    S = jpw.BSUB
    B = (len(pairs) + S - 1) // S
    tcodes = np.zeros((B, T, 1, S), np.int32)
    tlen = np.ones((B, 1, S), np.int32)
    qwin0 = np.full((B, S, BW), 0xFF, np.int32)
    qent = np.full((B, T, 1, S), 0xFF, np.int32)
    qlen = np.zeros((B, 1, S), np.int32)
    lo = np.zeros((B, 1, S), np.int32)
    for n, (q, t) in enumerate(pairs):
        b, d = divmod(n, S)
        lq, lt = len(q), len(t)
        k = (BW - 1 - abs(lq - lt)) // 2
        lod = min(0, lq - lt) - k
        tcodes[b, :lt, 0, d] = t
        tlen[b, 0, d] = lt
        qa = np.asarray(q, dtype=np.int32)
        w_idx = lod + np.arange(BW)
        ok = (w_idx >= 0) & (w_idx < lq)
        qwin0[b, d] = np.where(ok, qa[np.clip(w_idx, 0, lq - 1)], 0xFF)
        e_idx = np.arange(1, T + 1) + lod + BW - 1
        ok = (e_idx >= 0) & (e_idx < lq)
        qent[b, :, 0, d] = np.where(ok, qa[np.clip(e_idx, 0, lq - 1)], 0xFF)
        qlen[b, 0, d] = lq
        lo[b, 0, d] = lod
    return tcodes, tlen, qwin0, qent, qlen, lo


def pack_tiles(tiles, T, W):
    """The JAX layout of DevicePairwiseAligner._run_tiles (numpy)."""
    S = jpw.DSUB
    B = (len(tiles) + S - 1) // S
    tcodes = np.zeros((B, T, 1, S), np.int32)
    tlen = np.ones((B, 1, S), np.int32)
    qcodes = np.full((B, S, W), 0xFF, np.int32)
    qcodes[:, :, 1] = 0
    qlen = np.ones((B, 1, S), np.int32)
    for n, (q, t) in enumerate(tiles):
        b, d = divmod(n, S)
        tcodes[b, : len(t), 0, d] = t
        tlen[b, 0, d] = len(t)
        qcodes[b, d, 1 : 1 + len(q)] = q
        qlen[b, 0, d] = len(q)
    return tcodes, tlen, qcodes, qlen


def assert_outputs_equal(got, want):
    for name, g, w in zip(("pt", "pq", "count", "dist"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def small_pairs(rng, n, lo_len, hi_len, rate=0.1):
    pairs = []
    for _ in range(n):
        t = rand_codes(rng, int(rng.integers(lo_len, hi_len)))
        q = noisy(rng, t, rate)[: hi_len + 5]
        pairs.append((q, t))
    return pairs


def test_plain_banded_matches_pallas_small():
    """Six small pairs and one band-overflow pair (two programs, one partly
    padded) through a (96, 64) bucket."""
    rng = np.random.default_rng(5)
    T, BW = 96, 64
    pairs = small_pairs(rng, 6, 40, 90)
    t = rand_codes(rng, 90)
    pairs.append((noisy(rng, t, 0.9)[:90], t))  # far beyond the band
    arrs = pack_banded(pairs, T, BW)
    want = jpw._pairwise_banded_jit(*map(jnp.asarray, arrs), BW=BW, interpret=True)
    got = tpw.pairwise_banded(*arrs, BW=BW, device="cpu")
    assert_outputs_equal(got, want)
    # the overflow pair is rejected by the acceptance rule dist <= k - 2
    lq, lt = len(pairs[-1][0]), len(pairs[-1][1])
    k = (BW - 1 - abs(lq - lt)) // 2
    assert int(got[3][1, 0, 2]) > k - 2


def test_plain_banded_matches_pallas_2p4kb():
    """A 2.4 kb pair through the production (2560, 896) bucket."""
    rng = np.random.default_rng(6)
    T, BW = 2560, 896
    t = rand_codes(rng, 2450)
    q = noisy(rng, t, 0.08)[:2550]
    arrs = pack_banded([(q, t), (q[:100], t[:100])], T, BW)
    want = jpw._pairwise_banded_jit(*map(jnp.asarray, arrs), BW=BW, interpret=True)
    got = tpw.pairwise_banded(*arrs, BW=BW, device="cpu")
    assert_outputs_equal(got, want)


def pack_banded_any(pairs, T, BW):
    """`pack_banded`, also for an empty query (every code 0xFF)."""
    arrs = pack_banded([(q if len(q) else np.zeros(1, np.uint8), t) for q, t in pairs], T, BW)
    _, _, qwin0, qent, qlen, lo = arrs
    for n, (q, t) in enumerate(pairs):
        if len(q) == 0:
            b, d = divmod(n, jpw.BSUB)
            qwin0[b, d] = 0xFF
            qent[b, :, 0, d] = 0xFF
            qlen[b, 0, d] = 0
            lo[b, 0, d] = -len(t) - (BW - 1 - len(t)) // 2
    return arrs


def shifted_pair(rng, T, BW, sign, k):
    """|lq - lt| = BW - 1 - 2k: the band keeps k lanes beside the path's
    first and last diagonals (k = 16: the aligner's margin; k <= 1: the path
    runs along both band edges)."""
    d = BW - 1 - 2 * k
    t = rand_codes(rng, T - d)
    a = int(rng.integers(0, len(t) + 1))
    q = np.concatenate([t[:a], rand_codes(rng, d), t[a:]])
    return (q, t) if sign > 0 else (t, q)


def overflow_pairs(rng, T, BW, n):
    """Pairs far beyond the band: unrelated sequences, some with a length
    difference past the band (their walks are clipped)."""
    out = []
    for m in range(n):
        lt = int(rng.integers(T // 3, T + 1))
        lq = lt if m % 2 == 0 else min(T, lt + BW // 2 + int(rng.integers(0, BW)))
        out.append((rand_codes(rng, lq), rand_codes(rng, lt)))
    return out


def banded_spec_case(name):
    """(pairs, T, BW) of a case that pins K3's specification down."""
    rng = np.random.default_rng(sum(map(ord, name)))
    e = np.zeros(0, np.uint8)
    if name == "empty sequences":
        return [(e, rand_codes(rng, 40)), (rand_codes(rng, 40), e), (e, e)], 96, 64
    if name == "band edges 96x64":
        return [shifted_pair(rng, 96, 64, s, k) for k in (16, 1, 0) for s in (1, -1)], 96, 64
    if name == "band edges 640x384":
        return [shifted_pair(rng, 640, 384, s, k) for k in (16, 0) for s in (1, -1)], 640, 384
    if name == "overflow pairs 640x384":
        return overflow_pairs(rng, 640, 384, 7) + small_pairs(rng, 1, 500, 600), 640, 384
    raise ValueError(name)


SPEC_CASES = ("empty sequences", "band edges 96x64", "band edges 640x384", "overflow pairs 640x384")


@pytest.mark.parametrize("case", SPEC_CASES)
def test_plain_banded_matches_pallas_cases(case):
    """The plain version against the JAX kernel on the cases that pin its
    output down: empty sequences, length differences that put the path on
    or 16 lanes inside the band edges, and several overflow pairs in one
    program (rejected pairs and clipped walks)."""
    pairs, T, BW = banded_spec_case(case)
    arrs = pack_banded_any(pairs, T, BW)
    want = jpw._pairwise_banded_jit(*map(jnp.asarray, arrs), BW=BW, interpret=True)
    got = tpw.pairwise_banded(*arrs, BW=BW, device="cpu")
    assert_outputs_equal(got, want)


def warp_carry_prefix(x, lpt):
    """The prefix max of one row's x as K3 takes it: a serial max over each
    thread's lpt lanes; across a warp's 32 threads, the left neighbour's
    total plus a carry bit (generated where that total is 1 above the
    thread's own, passed on where they are equal: one add over the two
    ballots' masks); across warps, the exact max of the totals before.
    Equal to the true prefix max on every lane inside the DP matrix."""
    s = np.maximum.accumulate(x.reshape(-1, lpt), axis=1)
    tot = s[:, -1]
    excl = np.full(len(tot), -(1 << 30), np.int64)
    carry = -(1 << 30)
    for w0 in range(0, len(tot), 32):
        tw = tot[w0 : w0 + 32]
        gen = pro = 0
        for k in range(1, len(tw)):
            gen |= int(tw[k - 1] - tw[k] == 1) << k
            pro |= int(tw[k - 1] == tw[k]) << k
        pro |= gen
        cin = ((pro + gen) ^ pro ^ gen) & 0xFFFFFFFF
        for k in range(1, len(tw)):
            excl[w0 + k] = tw[k - 1] + ((cin >> k) & 1)
        excl[w0 : w0 + 32] = np.maximum(excl[w0 : w0 + 32], carry)
        carry = max(carry, int(tw.max()))
    return np.maximum(s, excl[:, None]).reshape(-1)


def packed_walk_model(t, ext, tlen, qlen, lo, BW):
    """numpy model of K3 as the CUDA kernel computes it: the DP rows in the
    x = H + lane domain with the kernel's horizontal chain
    (`warp_carry_prefix`), the 2-bit direction codes packed in the kernel's
    scratch layout ([chunk][thread] 16-byte pieces, LPT lanes a thread, row
    k of a chunk in an 8- or 16-bit slot at bit k * SB), and the walk over
    64-row stages holding only the chunks written, read from the end.
    Returns pt, pq, count, dist as `banded_nw` does."""
    t, ext, tlen, qlen, lo = (a.numpy().astype(np.int64) for a in (t, ext, tlen, qlen, lo))
    NP, T = t.shape
    L = T + BW
    lpt = BW // 128 if BW % 128 == 0 else (2 if BW % 64 == 0 else 1)
    nt = BW // lpt
    cr = 16 if lpt <= 4 else 8  # rows a 16-byte piece holds
    sb = 128 // cr  # bits a row's slot takes
    rpw, stage = 32 // sb, 64
    neg = tpw.NEG
    lane = np.arange(BW)
    pt = np.full((NP, L), -2, np.int64)
    pq = np.full((NP, L), -2, np.int64)
    count = np.zeros(NP, np.int64)
    dist = np.zeros(NP, np.int64)
    for p in range(NP):
        lt, lq, lod = int(tlen[p]), int(qlen[p]), int(lo[p])
        jv0 = lod + lane
        G = np.where((jv0 >= 0) & (jv0 <= lq), -lod, neg + lane)
        codes = np.full((lt + 1, BW), 2, np.uint64)
        for r in range(1, lt + 1):
            jv = r + lod + lane
            prof = np.where(ext[p, r - 1 : r - 1 + BW] == t[p, r - 1], 0, -1)
            dx = np.where(jv >= 1, G + prof, neg + lane)
            vx = np.append(G[1:], neg + BW) - 2
            x = np.where(jv == 0, -r + lane, np.maximum(dx, vx))
            R = np.where((jv >= 0) & (jv <= lq), warp_carry_prefix(x, lpt), neg + lane)
            codes[r] = np.where(R == dx, 0, np.where(R == vx, 1, 2))
            G = R
        ls = lq - lt - lod
        dist[p] = ls - G[ls] if 0 <= ls < BW else -neg
        # the scratch: unwritten words hold ones, which no code is
        used = lt // cr + 1
        words = np.full((used * cr // stage + 2) * (stage // cr) * nt * 4, 0xFFFFFFFF, np.uint64)
        words = words.reshape(-1, nt, 4)
        words[:used] = 0
        for r in range(lt + 1):
            c, k = divmod(r, cr)
            sh = (k % rpw) * sb + 2 * np.arange(lpt, dtype=np.uint64)
            words[c, :, k // rpw] |= (codes[r].reshape(nt, lpt) << sh).sum(axis=1, dtype=np.uint64)
        words[used:] = 0xFFFFFFFF
        # the walk, a stage at a time
        i, ll, k = lt, ls, 0
        ok = not (lt == 0 and lq == 0)
        sg = lt // stage
        while ok and k < L:
            buf = words[sg * stage // cr : (sg + 1) * stage // cr]
            while ok and k < L and i >= sg * stage:
                ll = min(max(ll, 0), BW - 1)
                ri = i - sg * stage
                kk = ri % cr
                word = int(buf[ri // cr, ll // lpt, kk // rpw])
                dv = (word >> ((kk % rpw) * sb + 2 * (ll % lpt))) & 3
                assert dv != 3, "read a word the rows never wrote"
                dg, vt = dv == 0, dv == 1
                pt[p, L - 1 - k] = i - 1 if dg or vt else -1
                pq[p, L - 1 - k] = -1 if vt else i + lod + ll - 1
                i, ll = (i - 1 if dg or vt else i), (ll if dg else (ll + 1 if vt else ll - 1))
                k += 1
                ok = not (i == 0 and i + lod + ll == 0)
            sg -= 1
        count[p] = k
    return pt, pq, count, dist


MODEL_CASES = (
    ("noisy 640x384", 640, 384),
    ("noisy 2560x896", 2560, 896),
    ("LPT 1: BW 32", 100, 32),
    ("LPT 2: BW 64", 150, 64),
    ("ragged target lengths", 333, 128),
    ("edges and overflow", 640, 384),
)


@pytest.mark.parametrize("case,T,BW", MODEL_CASES)
def test_packed_walk_model_matches_plain(case, T, BW):
    """The kernel's 2-bit layout and staged walk, modelled in numpy, give
    the plain version's pt, pq, count and dist: chunk and stage edges at
    target lengths that are multiples of neither, every lane width."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("ragged"):
        lens = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 200, 333)
        pairs = [(noisy(rng, t)[:T], t) for t in (rand_codes(rng, n) for n in lens)]
    elif case.startswith("edges"):
        pairs = ([shifted_pair(rng, T, BW, s, k) for k in (16, 0) for s in (1, -1)]
                 + overflow_pairs(rng, T, BW, 3) + [(np.zeros(0, np.uint8), rand_codes(rng, 50))])
    else:
        pairs = small_pairs(rng, 3 if T > 1000 else 5, T // 2, T - 5)
    args = tpw.banded_inputs(*pack_banded_any(pairs, T, BW), BW, device="cpu")
    want = tpw._banded_plain(*args, BW)
    got = packed_walk_model(*args, BW)
    for name, g, w in zip(("pt", "pq", "count", "dist"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", range(2))
def test_plain_tiled_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    tiles = []
    for _ in range(jpw.DSUB + 1):  # 2 programs, one partially padded
        t = rand_codes(rng, int(rng.integers(5, 28)))
        q = noisy(rng, t, 0.15)
        if len(q) == 0 or len(q) > 31:
            q = rand_codes(rng, 10)
        tiles.append((q, t))
    arrs = pack_tiles(tiles, 32, 32)
    want = jpw.pairwise_nw_pallas(*map(jnp.asarray, arrs), interpret=True)
    got = tpw.pairwise_nw(*arrs, device="cpu")
    assert_outputs_equal(got, want)


def test_aligner_exact_matches_host_and_pallas():
    """Accepted banded CIGARs equal edit_align's (port and JAX) and the JAX
    aligner's; the overflow pair is routed to the host and counted."""
    rng = np.random.default_rng(7)
    pairs = small_pairs(rng, 5, 40, 90)
    t = rand_codes(rng, 90)
    pairs.append((noisy(rng, t, 0.9)[:90], t))
    port = tpw.DevicePairwiseAligner(device="cpu")
    port.EXACT_BUCKETS = ((96, 64),)
    ref = jpw.DevicePairwiseAligner(interpret=True)
    ref.EXACT_BUCKETS = ((96, 64),)
    got = port.edit_align_batch(pairs)
    assert got == ref.edit_align_batch(pairs)
    assert port.exact_pairs == len(pairs) - 1 and port.exact_rejects == 1
    for (q, t), cg in zip(pairs, got):
        assert cg == edit_align(q, t) == jax_edit_align(q, t)


def test_aligner_tiled_matches_pallas():
    """The anchor-tiled path (near-optimal CIGARs) equals the JAX tiled path
    byte for byte, on a pair long enough to cut and on short ones."""
    rng = np.random.default_rng(3)
    t = rand_codes(rng, 150)
    pairs = [(noisy(rng, t, 0.04), t)] + small_pairs(rng, 3, 10, 28)
    port = tpw.DevicePairwiseAligner(device="cpu")
    port.EXACT_BUCKETS = ()  # pin the anchor-tiled path
    port.TILE_T, port.TILE_W = 31, 32
    ref = jpw.DevicePairwiseAligner(interpret=True)
    ref.exact_enabled = False
    ref.TILE_T, ref.TILE_W = 31, 32
    got = port.edit_align_batch(pairs)
    assert got == ref.edit_align_batch(pairs)
    assert port.device_tiles == ref.device_tiles > len(pairs)


def test_anchors_and_cuts_match_jax():
    rng = np.random.default_rng(1)
    t = rand_codes(rng, 800)
    q = noisy(rng, t, 0.05)
    a = tpw._minimizer_anchors(q, t)
    np.testing.assert_array_equal(a, jpw._minimizer_anchors(q, t))
    assert tpw.tile_cut_points(len(q), len(t), a, 256) == jpw.tile_cut_points(
        len(q), len(t), a, 256
    )
    assert tpw.tile_cut_points(1000, 1000, np.empty((0, 2), np.int64), 256) is None


def test_wrappers_reject_bad_inputs():
    t = torch.zeros((2, 8), dtype=torch.int32)
    q = torch.zeros((2, 32), dtype=torch.int32)
    n = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpw.tiled_nw(t, q.to(torch.int64), n, n)
    with pytest.raises(ValueError):
        tpw.banded_nw(t, q, n, n, n, BW=32)  # ext must be [NP, BW + T]


@pytest.mark.parametrize("entry", ["aligner", "banded", "tiled"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Left without `device`, the pairwise entry points run on the card:
    without a GPU they raise instead of taking the plain CPU version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    pairs = small_pairs(rng, 2, 20, 40)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "aligner":
            tpw.DevicePairwiseAligner()
        elif entry == "banded":
            tpw.pairwise_banded(*tpw.pack_banded(pairs, 48, 32), BW=32)
        else:
            tpw.pairwise_nw(*tpw.pack_tiles(pairs, 48, 64))
