"""K4, the tiled edit-distance NW kernel of the port (`csrc/pairwise_nw.cu:
tiled_kernel`), modelled in numpy as the kernel computes it and held
exactly to its plain version `_tiled_plain` (pt, pq, count, dist), which is
held to the JAX kernel `pairwise_nw_pallas` in interpret mode.

The model follows the kernel step for step: the DP rows in the x = H + j
domain with a thread's LPT lanes scanned serially, the carry bit across a
warp's threads and the warps' totals (asserted equal, on every row, to the
exact prefix max: the property the carry rests on); the 2-bit direction
codes in 16-byte pieces of the kernel's [chunk][thread] layout; the walk
over 64-row stages, each step reading its cell's word of the stage,
asserting that it never reads a word the rows did not write; at W = 512,
4 warps of 4 lanes a thread. Integer DP results: the tolerance is exact
equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vechat_tpu.ops.kernels import pairwise_pallas as jpw
from vechat_tpu_torch.ops.kernels import pairwise_nw as tpw

NEG = tpw.NEG
LOW = -(1 << 30)  # nw::kLow
STAGE = 64  # rows a walk stage holds
T, W = 512, 512  # the aligner's tile bucket: TILE_T + 1 rows, TILE_W lanes


def k4_lanes(W):
    """Lanes a thread, K3's choice: 4 warps of W / 128 where W is a multiple
    of 128, else W / 2 or W threads in whole warps."""
    return W // 128 if W % 128 == 0 else (2 if W % 64 == 0 else 1)


def chunk_rows(lpt):
    """Rows a 16-byte piece holds: 2 * lpt bits a row in a slot of 8 or 16
    bits."""
    return 16 if lpt <= 4 else 8


def carry_rows(x, lpt):
    """One row's prefix max as the kernel takes it, for every tile at once:
    x [NP, W]; a serial max over each thread's lpt lanes; across a warp's
    threads, the left neighbour's total plus a carry bit (generated where
    that total is 1 above the thread's own, passed on where they are equal:
    one add over the two ballots' masks); across warps, the exact max of
    the totals of the warps before (none for warp 0). Returns the row and
    the carry into each warp [NP, warps] (the kernel's left value of a
    warp's first lane in the next row), and asserts the row is the exact
    prefix max."""
    NP, Wx = x.shape
    nt = Wx // lpt
    s = np.maximum.accumulate(x.reshape(NP, nt, lpt), axis=2)
    tot = s[:, :, -1].reshape(NP, -1, 32)  # [NP, warps, 32 threads]
    lanes = np.arange(32, dtype=np.uint64)
    tl = np.concatenate([np.full(tot.shape[:2] + (1,), LOW), tot[:, :, :-1]], axis=2)
    inner = np.arange(32) > 0
    gen = ((tl - tot == 1) & inner).astype(np.uint64) << lanes
    pro = ((tl == tot) & inner).astype(np.uint64) << lanes
    gen, pro = gen.sum(axis=2), pro.sum(axis=2) | gen.sum(axis=2)
    cin = ((pro + gen) ^ pro ^ gen) & np.uint64(0xFFFFFFFF)
    bit = ((cin[:, :, None] >> lanes) & np.uint64(1)).astype(np.int64)
    excl = np.where(inner, tl + bit, LOW)
    wtot = tot.max(axis=2)
    carry = np.concatenate([np.full((NP, 1), LOW), np.maximum.accumulate(wtot, axis=1)[:, :-1]],
                           axis=1)
    excl = np.maximum(excl, carry[:, :, None]).reshape(NP, nt)
    R = np.maximum(s, excl[:, :, None]).reshape(NP, Wx)
    np.testing.assert_array_equal(R, np.maximum.accumulate(x, axis=1))
    return R, carry


def k4_model(t, q, tlen, qlen):
    """numpy model of K4 as the CUDA kernel computes it (see the module
    docstring); t [NP, T], q [NP, W], tlen/qlen [NP] tensors. Returns pt,
    pq, count, dist as `tiled_nw` does."""
    t, q, tlen, qlen = (a.numpy().astype(np.int64) for a in (t, q, tlen, qlen))
    NP, Tt = t.shape
    Wq = q.shape[1]
    L = Tt + Wq
    lpt = k4_lanes(Wq)
    nt = Wq // lpt
    cr = chunk_rows(lpt)
    sb, rpw = 128 // cr, 32 // (128 // cr)
    # rows in the x domain: row 0 is 0 on every lane; every code 2
    G = np.zeros((NP, Wq), np.int64)
    codes = np.full((NP, Tt + 1, Wq), 2, np.uint64)
    leftw = np.where(np.arange(nt // 32) == 0, LOW, 0)[None, :].repeat(NP, axis=0)
    first = np.arange(Wq) % (32 * lpt) == 0  # a warp's first lane
    for r in range(1, int(tlen.max(initial=0)) + 1):
        left = np.concatenate([np.zeros((NP, 1), np.int64), G[:, :-1]], axis=1)
        left[:, first] = leftw
        dx = left + (q == t[:, r - 1 : r])
        vx = G - 1
        R, carry = carry_rows(np.maximum(dx, vx), lpt)
        live = (r <= tlen)[:, None]
        codes[:, r] = np.where(live, np.where(R == dx, 0, np.where(R == vx, 1, 2)), 0)
        G = np.where(live, R, G)
        leftw = np.where(live, carry, leftw)
    inb = (qlen >= 0) & (qlen < Wq)
    dist = np.where(inb, qlen - G[np.arange(NP), np.clip(qlen, 0, Wq - 1)], -NEG)

    pt = np.full((NP, L), -2, np.int64)
    pq = np.full((NP, L), -2, np.int64)
    count = np.zeros(NP, np.int64)
    lane_sh = 2 * np.arange(lpt, dtype=np.uint64)
    for p in range(NP):
        lt, lq = int(tlen[p]), int(qlen[p])
        # the scratch: [chunk][thread][word]; unwritten words hold ones,
        # which no code is
        used = lt // cr + 1
        words = np.full(((used * cr) // STAGE + 2) * (STAGE // cr), 0xFFFFFFFF, np.uint64)
        words = np.repeat(words[:, None, None], nt, axis=1).repeat(4, axis=2)
        words[:used] = 0
        for r in range(lt + 1):
            c, k = divmod(r, cr)
            piece = (codes[p, r].reshape(nt, lpt) << (np.uint64((k % rpw) * sb) + lane_sh))
            words[c, :, k // rpw] |= piece.sum(axis=1, dtype=np.uint64)
        # the walk, a stage at a time: a step reads its cell's 32-bit word
        # of the staged pieces
        i, j, k = lt, lq, 0
        ok = not (lt == 0 and lq == 0)
        started = ok
        sg = lt // STAGE
        while ok and k < L:
            base = sg * STAGE
            sp = words[sg * (STAGE // cr) : (sg + 1) * (STAGE // cr)]
            on = ok and k < L
            while on:
                ri, rl = i - base, min(max(j, 0), Wq - 1)  # a j outside the row reads its nearest lane
                word = int(sp[ri // cr, rl // lpt, ri % cr // rpw])
                assert word != 0xFFFFFFFF, "read a word the rows never wrote"
                dv = (word >> (ri % rpw * sb + 2 * (rl % lpt))) & 3
                up, vt = dv < 2, dv == 1
                pt[p, L - 1 - k] = i - 1 if up else -1
                pq[p, L - 1 - k] = -1 if vt else j - 1
                k += 1
                i, j = i - up, j - (not vt)
                ok = not (i == 0 and j == 0)
                on = ok and k < L and i >= base
            sg -= 1
        count[p] = k if started else 0
    return pt, pq, count, dist


def rand_codes(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def noisy(rng, codes, rate=0.08):
    """Substitutions, deletions and insertions at `rate` (8% by default, the
    main path's ONT-profile error)."""
    out = []
    for c in codes:
        r = rng.random()
        if r < rate * 0.35:
            out.append((c + rng.integers(1, 4)) % 4)
        elif r < rate * 0.75:
            continue
        else:
            out.append(c)
            if rng.random() < rate * 0.25:
                out.append(rng.integers(0, 4))
    return np.array(out, dtype=np.uint8)


def sized(rng, codes, n):
    """`codes` cut or extended with random codes to exactly n."""
    return np.concatenate([codes[:n], rand_codes(rng, max(0, n - len(codes)))])


def tile_case(name):
    """(query, target) code tiles of one case, for pack_tiles at T = W = 512."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "target lengths":
        return [(sized(rng, noisy(rng, tg), min(511, len(tg) + 3)), tg)
                for tg in (rand_codes(rng, n) for n in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 510))]
    if name == "query lengths":
        out = []
        for n in (1, 31, 32, 33, 127, 128, 129, 510, 511):
            tg = rand_codes(rng, max(1, min(511, n + int(rng.integers(-5, 6)))))
            out.append((sized(rng, noisy(rng, tg), n), tg))
        return out
    if name == "query much longer":
        return [(rand_codes(rng, 500), rand_codes(rng, n)) for n in (1, 5, 40, 130)]
    if name == "target much longer":
        return [(rand_codes(rng, n), rand_codes(rng, 505)) for n in (1, 5, 40, 130)]
    if name == "identical":
        tg = rand_codes(rng, 511)
        return [(tg, tg), (tg[:300], tg[:300]), (tg[:64], tg[:64]), (tg[:1], tg[:1])]
    if name == "unrelated codes":  # the worst case for the carry
        return [(rand_codes(rng, int(rng.integers(1, 512))), rand_codes(rng, int(rng.integers(1, 512))))
                for _ in range(8)] + [(rand_codes(rng, 3), rand_codes(rng, 511))]
    if name == "padding slots":  # 11 tiles: two programs, the second with 5 padding slots
        return [(noisy(rng, tg), tg) for tg in (rand_codes(rng, int(rng.integers(380, 500)))
                                                for _ in range(11))]
    raise ValueError(name)


CASES = ("target lengths", "query lengths", "query much longer", "target much longer",
         "identical", "unrelated codes", "padding slots")


def inputs(tiles, Tt=T, Wq=W):
    return tpw.tiled_inputs(*tpw.pack_tiles(tiles, Tt, Wq), device="cpu")


def assert_model_equals_plain(args):
    want = tpw._tiled_plain(*args)
    got = k4_model(*args)
    for name, g, w in zip(("pt", "pq", "count", "dist"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_model_equals_plain(case):
    """The kernel's rows, 2-bit pieces and staged walk give the plain version's pt, pq, count and dist on tiles of the
    aligner's 512x512 bucket: target lengths on both sides of a 16-row
    chunk, a 32-row fetch batch and a 64-row stage; query lengths on both
    sides of a warp's lanes; one length far beyond the other; identical
    and unrelated sequences; and pack_tiles' padding slots."""
    assert_model_equals_plain(inputs(tile_case(case)))


@pytest.mark.parametrize("Wq", [32, 64, 96, 192, 1024])
def test_model_equals_plain_at_other_widths(Wq):
    """K4 at other tile widths: one warp of 1 or 2 lanes a
    thread (W = 32, 64), 3 warps (96, 192) and 8 lanes a thread (1024)."""
    rng = np.random.default_rng(Wq)
    tiles = []
    for n in (1, Wq // 3, Wq - 1):
        tg = rand_codes(rng, max(1, n))
        tiles.append((sized(rng, noisy(rng, tg), max(1, min(Wq - 1, n + 2))), tg))
    tiles.append((rand_codes(rng, Wq - 1), rand_codes(rng, Wq // 2 + 1)))
    assert_model_equals_plain(inputs(tiles, Tt=Wq + 8, Wq=Wq))


def test_model_equals_plain_on_queries_outside_the_row():
    """qlen past the row or below 0 (not an input the aligner makes): the
    walk reads the nearest lane, as the plain version does, and dist is
    -NEG."""
    rng = np.random.default_rng(11)
    args = list(inputs([(noisy(rng, tg), tg) for tg in (rand_codes(rng, 40) for _ in range(3))],
                       Tt=64, Wq=64))
    args[3] = args[3].clone()
    args[3][:3] = torch.tensor([70, -3, 63], dtype=torch.int32)
    assert_model_equals_plain(tuple(args))


def test_model_carry_holds_on_every_row_of_unrelated_codes_with_short_queries():
    """The carry bit's premise, a thread's prefix from the left within 1 of
    its left neighbour's total, on the worst inputs: random codes, qlen far
    below W, so most lanes are pads that nothing matches. `carry_rows`
    asserts the chain equal to the exact prefix max on every row."""
    rng = np.random.default_rng(12)
    tiles = [(rand_codes(rng, n), rand_codes(rng, 511)) for n in (1, 2, 7, 31, 33, 100)]
    assert_model_equals_plain(inputs(tiles))


def test_plain_equals_pallas_at_the_tile_bucket():
    """`_tiled_plain` against the JAX kernel in interpret mode at T = W =
    512, one program of 8 tiles of the aligner's bucket."""
    rng = np.random.default_rng(13)
    tiles = [(noisy(rng, tg), tg) for tg in (rand_codes(rng, int(rng.integers(300, 511)))
                                            for _ in range(6))]
    tiles += [(rand_codes(rng, 500), rand_codes(rng, 20)), (rand_codes(rng, 3), rand_codes(rng, 510))]
    tiles = [(q[:511], tg) for q, tg in tiles]
    arrs = tpw.pack_tiles(tiles, T, W)
    want = jpw.pairwise_nw_pallas(*map(jnp.asarray, arrs), interpret=True)
    got = tpw.pairwise_nw(*arrs, device="cpu")
    for name, g, w in zip(("pt", "pq", "count", "dist"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
