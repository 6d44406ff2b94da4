"""A numpy model of K6's row machinery (`csrc/poa_convex.cu`, `gap_rows.cuh`)
held to the plain PyTorch version `_dp_convex_plain`, and in three cases
to the JAX package's Pallas kernel in interpret mode. The kernel itself
runs only on the card (`tests/test_torch_cuda.py`); the model checks its
design here, step for step:

  - W / LPT threads, thread t owning lanes [t*LPT, (t+1)*LPT);
  - the (E, Q) max-plus recurrence u_j = (A0[j] + g, A0[j] + q) (+) M u_(j-1)
    serial over a thread's lanes from nothing, a 5-step shuffle scan of the
    threads' totals applying M^(LPT 2^s) (lanes below the offset masked),
    one carry a warp from a scan over the published totals with
    M^(32 LPT 2^s),
    then each lane from the thread's incoming vector; every power from
    `k6_powers`, the thread's M^(lane LPT) formed before the rows;
  - EBe / QBq from u at lanes j-1 and j-2 (own lanes, the left thread, or
    the left warp's published prefix at its second-to-last lane with the
    carry into it);
  - an in-edge of delta 1 from the previous row held in registers with the
    int16 clamp, its diagonal's left lane from the left thread, at a warp's
    first lane rebuilt from the left warp's published A0 and (E, Q);
  - every other in-edge from the rings, written after the barrier;
  - the chain code from the channel winners, all packed at H's shift, as
    their excess over their channel's value (negative where they do not
    reach it), or for a row of one in-edge from the channels' extend and
    open values;
  - the best cell over a thread's lanes, then over the block.

Every output is an integer DP result: the tolerance is exact equality."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_poa_affine_rows import dag_inputs, insertion_inputs, mismatch_inputs
from vechat_tpu.ops.kernels import poa_pallas_convex as jcvx
from vechat_tpu_torch.ops.kernels import poa_convex as tcvx
from vechat_tpu_torch.ops.kernels.poa_affine import pack_aux_gap
from vechat_tpu_torch.ops.kernels.poa_linear import DELTA_BITS, NEG16, NEGV, TIE

CONVEX = (5, -4, -8, -6, -10, -4)  # m, x, g, e, q, c: the spoa command line's
CONVEX_SMALL = (3, -5, -6, -4, -8, -2)  # every magnitude within 8


def i32(v):
    return np.asarray(v, dtype=np.int32)


def h16(v):
    """A value as an int16 ring holds it: the poison floor, then the cast."""
    return np.maximum(v, NEG16).astype(np.int16).astype(np.int32)


def powers(g, e, q, c, lpt):
    """`k6_powers` as the kernel's MpPowers: seg [6], step [5], xstep [5],
    warp1, each a (m11, m12, m21, m22) tuple of int32."""
    p = np.array(tcvx.k6_powers(g, e, q, c, lpt), np.int32).reshape(-1, 4)
    return p[:6], p[6:11], p[11:16], p[16]


def mp_acc(m, x, y, a, b):
    """(a, b) = max((a, b), m (x) (x, y)), max-plus, elementwise."""
    return (np.maximum(np.maximum(a, y + m[1]), x + m[0]),
            np.maximum(np.maximum(b, y + m[3]), x + m[2]))


def mp_mul(A, B):
    return i32([max(A[0] + B[0], A[1] + B[2]), max(A[0] + B[1], A[1] + B[3]),
                max(A[2] + B[0], A[3] + B[2]), max(A[2] + B[1], A[3] + B[3])])


def model_dp_convex(codes, aux, deg, sink, nn, seqp, slen, mode, m, x, g, e, q, c, R, lpt):
    """K6's rows as the kernel computes them, one block (b, d) at a time;
    numpy int32 (wrapping as the card does). Returns dirs [B, N+1, D, W]
    (rows past a graph's n_nodes left 0), maxi, maxj, score [B, D]."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    assert W % (32 * lpt) == 0
    NT = W // lpt
    NW = NT // 32
    sw, nw = mode == "sw", mode == "nw"
    SH = tcvx.sh_bits_cvx(P)
    NPRIO = 5 * P + 5
    VSH = 1 << SH
    MASK = VSH - 1
    PC = P << DELTA_BITS
    EEXT = (NPRIO - 1 - 5 * P) << DELTA_BITS
    EOPEN = (NPRIO - 1 - (5 * P + 1)) << DELTA_BITS
    QEXT = (NPRIO - 1 - (5 * P + 2)) << DELTA_BITS
    QOPEN = (NPRIO - 1 - (5 * P + 3)) << DELTA_BITS
    seg, step, xstep, mwarp1 = powers(g, e, q, c, lpt)
    # steps of the scan over the warps: 2^S >= the most warps a block has
    S = int(np.ceil(np.log2((1024 // lpt + 31) // 32)))
    lanes = np.arange(W, dtype=np.int32).reshape(NT, lpt)  # [thread, i] -> j
    j0 = lanes[:, 0]
    first = np.zeros((NT, lpt), bool)
    first[0, 0] = True  # lane 0 of the block
    lane_of = np.arange(NT) % 32
    warp_lane0 = lane_of == 0
    w_of = np.arange(NT) // 32
    # M^(lane LPT) of every thread, from the identity (lane 0 keeps it)
    ml = np.tile(i32([0, NEGV, NEGV, 0]), (NT, 1))
    for t in range(NT):
        for s in range(5):
            if (lane_of[t] >> s) & 1:
                ml[t] = mp_mul(ml[t], step[s])
    dirs = np.zeros((B, N + 1, D, W), np.int32)
    maxi, maxj, score = (np.zeros((B, D), np.int32) for _ in range(3))

    def shift_in_warp(v, o=1):
        """v of the thread o to the left within the warp (a thread's own
        below the offset, as __shfl_up_sync gives it)."""
        out = np.roll(v, o, axis=0)
        low = lane_of < o
        out[low] = v[low]
        return out

    for b in range(B):
        for d in range(D):
            sl = int(slen[b, d])
            qc = seqp[b, d].reshape(NT, lpt)
            jj = lanes
            cmask = (jj == sl) if nw else (jj != 0) & (jj <= sl)
            e_init, q_init = g + (jj - 1) * e, q + (jj - 1) * c
            hp = np.zeros((NT, lpt), np.int32)
            if not sw:
                hp = np.where(jj == 0, 0, np.maximum(e_init, q_init)).astype(np.int16)
                hp = hp.astype(np.int32)
            fp = np.where(jj == 0, g - e, NEG16).astype(np.int16).astype(np.int32)
            op = np.where(jj == 0, q - c, NEG16).astype(np.int16).astype(np.int32)
            Hr, Fr, Or = (np.zeros((R + 1, W), np.int32) for _ in range(3))
            Hr[R], Fr[R], Or[R] = hp.reshape(W), fp.reshape(W), op.reshape(W)
            if not sw:
                cb = np.where(jj >= 2, 1 << tcvx.CB_BIT, 0)
                h0 = np.where(jj == 1, EOPEN, np.where(e_init >= q_init, EEXT, QEXT))
                dirs[b, 0, d] = ((cb << 16) | h0).reshape(W)
            best = np.full(NT, 0 if sw else NEG16 * TIE + TIE - 1, np.int64)
            bestj = j0.astype(np.int64).copy()
            hl_warp = np.zeros(NW, np.int32)
            wslot = 0
            for hr in range(1, int(nn[b]) + 1):
                r = hr - 1
                code = int(codes[b, r])
                dg = int(deg[b, r])
                hl1 = shift_in_warp(hp[:, -1])
                hl1[warp_lane0] = hl_warp
                def edge_rows(av):
                    """H, F, O of the in-edge av and the diagonal's left lane."""
                    delta, slot = av & 0xFFFF, av >> 16
                    if delta == 1:  # the registers
                        return hp, fp, op, hl1
                    h, f, o = (ring[slot].reshape(NT, lpt) for ring in (Hr, Fr, Or))
                    hl = np.where(j0 > 0, Hr[slot][np.maximum(j0 - 1, 0)], 0).astype(np.int32)
                    return h, f, o, hl

                if dg == 1:  # no winners' maxes: the channels' values compared
                    av = int(aux[b, 0, r])
                    delta = av & 0xFFFF
                    h, f, o, hl = edge_rows(av)
                    left = np.concatenate([hl[:, None], h[:, :-1]], axis=1)
                    dmax = left * i32(VSH) + i32(((NPRIO - 1) << DELTA_BITS) + delta)
                    hv = h * i32(VSH)
                    acc = np.maximum(
                        np.maximum(f * i32(VSH) + i32(e * VSH + ((NPRIO - 1 - P) << DELTA_BITS) + delta),
                                   hv + i32(g * VSH + ((NPRIO - 2 - P) << DELTA_BITS) + delta)),
                        np.maximum(o * i32(VSH) + i32(c * VSH + ((NPRIO - 3 - P) << DELTA_BITS) + delta),
                                   hv + i32(q * VSH + ((NPRIO - 4 - P) << DELTA_BITS) + delta)))
                    fE, fO = f + e, np.where(first, NEGV, h + g)
                    oE, oO = o + c, np.where(first, NEGV, h + q)
                    stop = ((P - 1) << DELTA_BITS) + delta
                    cc = np.where((fE >= fO) | (oE >= oO), stop + PC, stop)
                    fp, op = h16(np.maximum(fE, fO)), h16(np.maximum(oE, oO))
                else:
                    dmax, acc, fe, fo, oe, oo = (np.full((NT, lpt), NEGV, np.int32) for _ in range(6))
                    for p in range(dg):
                        av = int(aux[b, p, r])
                        delta = av & 0xFFFF
                        u1, u4 = delta - (p << DELTA_BITS), delta - (p << (DELTA_BITS + 2))
                        kd = ((NPRIO - 1) << DELTA_BITS) + u1
                        kfe = e * VSH + ((NPRIO - 1 - P) << DELTA_BITS) + u4
                        kfo = g * VSH + ((NPRIO - 2 - P) << DELTA_BITS) + u4
                        koe = c * VSH + ((NPRIO - 3 - P) << DELTA_BITS) + u4
                        koo = q * VSH + ((NPRIO - 4 - P) << DELTA_BITS) + u4
                        sp = ((P - 1) << DELTA_BITS) + u1
                        h, f, o, hl = edge_rows(av)
                        left = np.concatenate([hl[:, None], h[:, :-1]], axis=1)
                        hv, fv, ov = h * i32(VSH), f * i32(VSH), o * i32(VSH)
                        dmax = np.maximum(left * i32(VSH) + i32(kd), dmax)
                        for v, k in ((fv, kfe), (hv, kfo), (ov, koe), (hv, koo)):
                            acc = np.maximum(v + i32(k), acc)
                        fe = np.maximum(fv + i32(e * VSH + sp), fe)
                        fo = np.maximum(hv + i32(g * VSH + sp), fo)
                        oe = np.maximum(ov + i32(c * VSH + sp), oe)
                        oo = np.maximum(hv + i32(q * VSH + sp), oo)
                    fo[first] = NEGV  # no opens at lane 0
                    oo[first] = NEGV
                    # the channels' values with the code bits cleared; a
                    # winner's excess over its channel's is its code,
                    # negative where it does not reach it
                    mF = np.maximum(fe, fo) & ~i32(MASK)
                    mO = np.maximum(oe, oo) & ~i32(MASK)
                    cont = np.maximum(fe - mF, oe - mO)
                    cc = np.where(cont >= 0, cont + PC, np.maximum(fo - mF, oo - mO))
                    fp, op = h16(mF >> SH), h16(mO >> SH)
                prof = np.where(qc == code, i32(m * VSH), i32(x * VSH))
                v = np.where(first, acc, np.maximum(dmax + prof, acc))
                A, hc = v >> SH, v & MASK
                if not nw:
                    A = np.where(first, 0, A)
                    hc = np.where(first, 0, hc)
                A0 = np.maximum(A, 0) if sw else A
                # the serial pass from nothing
                tE, tQ = np.zeros_like(A0), np.zeros_like(A0)
                tE[:, 0], tQ[:, 0] = A0[:, 0] + g, A0[:, 0] + q
                for i in range(1, lpt):
                    tE[:, i] = np.maximum(tE[:, i - 1] + e, np.maximum(A0[:, i], tQ[:, i - 1]) + g)
                    tQ[:, i] = np.maximum(tQ[:, i - 1] + c, np.maximum(A0[:, i], tE[:, i - 1]) + q)
                # the warp scan, lanes below the offset masked
                se, sq = tE[:, -1].copy(), tQ[:, -1].copy()
                for s in range(5):
                    o = 1 << s
                    xs, ys = shift_in_warp(se, o), shift_in_warp(sq, o)
                    ne, nq = mp_acc(step[s], xs, ys, se, sq)
                    live = lane_of >= o
                    se, sq = np.where(live, ne, se), np.where(live, nq, sq)
                xe, xq = shift_in_warp(se), shift_in_warp(sq)
                # lane 31 of each warp publishes its total, its prefix at the
                # second-to-last lane and its last lane's A0
                last = np.arange(31, NT, 32)
                if lpt >= 2:
                    qe, qq = mp_acc(seg[lpt - 2], xe[last], xq[last], tE[last, lpt - 2],
                                    tQ[last, lpt - 2])
                else:
                    qe, qq = xe[last], xq[last]
                pub = dict(te=se[last], tq=sq[last], qe=qe, qq=qq, a0=A0[last, -1])
                # the carry into each warp and into the warp before it: a
                # scan over the warps' totals, lane v holding warp v's
                te, tq = pub["te"].copy(), pub["tq"].copy()
                for s in range(S):
                    o = 1 << s
                    if o >= NW:
                        break
                    xs, ys = np.roll(te, o), np.roll(tq, o)
                    ne, nq = mp_acc(xstep[s], xs, ys, te, tq)
                    live = np.arange(NW) >= o
                    te, tq = np.where(live, ne, te), np.where(live, nq, tq)
                neg = np.full(1, NEGV, np.int32)
                ce, cq = np.concatenate([neg, te[:-1]]), np.concatenate([neg, tq[:-1]])
                pe, pq = np.concatenate([neg, ce[:-1]]), np.concatenate([neg, cq[:-1]])
                cte, ctq = ce[w_of], cq[w_of]
                ue, uq = mp_acc(ml.T, cte, ctq, xe, xq)
                ue, uq = np.where(warp_lane0, cte, ue), np.where(warp_lane0, ctq, uq)
                uE, uQ = np.zeros_like(tE), np.zeros_like(tQ)
                for i in range(lpt):
                    uE[:, i], uQ[:, i] = mp_acc(seg[i], ue, uq, tE[:, i], tQ[:, i])
                le = shift_in_warp(uE[:, lpt - 2] if lpt >= 2 else ue)
                lq = shift_in_warp(uQ[:, lpt - 2] if lpt >= 2 else uq)
                for w in range(1, NW):
                    t = 32 * w
                    le[t], lq[t] = mp_acc(mwarp1, pe[w], pq[w], pub["qe"][w - 1], pub["qq"][w - 1])
                    hv = max(int(pub["a0"][w - 1]), int(le[t]), int(lq[t]))
                    hl_warp[w] = h16(max(hv, 0) if sw else hv)
                Ev = np.concatenate([ue[:, None], uE[:, :-1]], axis=1)
                Qv = np.concatenate([uq[:, None], uQ[:, :-1]], axis=1)
                le[0] = lq[0] = NEGV  # lane 0 of the block: no lane -1
                pE = np.concatenate([le[:, None], ue[:, None], uE[:, :-2]], axis=1)[:, :lpt]
                pQ = np.concatenate([lq[:, None], uq[:, None], uQ[:, :-2]], axis=1)[:, :lpt]
                Ev = np.where(first, NEG16, Ev)
                Qv = np.where(first, NEG16, Qv)
                EBe = Ev == pE + e
                QBq = Qv == pQ + c
                EQ = np.maximum(Ev, Qv)
                eqcode = np.where(Ev >= Qv, np.where(EBe, EEXT, EOPEN), np.where(QBq, QEXT, QOPEN))
                Hf = np.maximum(A0, EQ)
                hcode = np.where(EQ > A0, eqcode, hc)
                if sw:
                    Hf = np.maximum(Hf, 0)
                    hcode = np.where(Hf == 0, 0, hcode)
                hp = h16(Hf)
                Hr[wslot], Fr[wslot], Or[wslot] = hp.reshape(W), fp.reshape(W), op.reshape(W)
                wslot = wslot + 1 if wslot + 1 < R else 0
                cbit = (EBe | QBq).astype(np.int32) << tcvx.CB_BIT
                dirs[b, hr, d] = (((cc | cbit) << 16) | hcode).reshape(W)
                if cmask.any() and (sw or sink[b, r] != 0):
                    rm = np.where(cmask, Hf, np.iinfo(np.int32).min).max(axis=1).astype(np.int64)
                    pack = rm * TIE + (TIE - 1 - hr)
                    live = cmask.any(axis=1) & (pack > best)
                    low = np.argmax(cmask & (Hf == rm[:, None]), axis=1)
                    best = np.where(live, pack, best)
                    bestj = np.where(live, j0 + low, bestj)
            bmax = best.max()
            jpick = bestj[best == bmax].min()
            s_ = int(bmax) >> 12
            ipick = (TIE - 1) - (int(bmax) & (TIE - 1))
            empty = s_ <= 0 if sw else ipick == 0
            maxi[b, d] = 0 if empty else ipick
            maxj[b, d] = 0 if empty else jpick
            score[b, d] = s_
    return dirs, maxi, maxj, score


# -------------------------------------------------------------- comparison


def check_model(arrays, mode, R, lpt, scores=CONVEX):
    """The model's real rows (every lane) and best cells equal the plain
    version's."""
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    B, P, N = preds.shape
    D = seqp.shape[1]
    aux, deg = pack_aux_gap(preds, R)
    args = (codes.reshape(B, N), aux, deg, sink.reshape(B, N), nn.reshape(B), seqp,
            slen.reshape(B, D))
    p = tcvx._dp_convex_plain(*args, mode, *scores, R)
    k = model_dp_convex(*(a.numpy() for a in args), mode, *scores, R, lpt)
    real = (torch.arange(N + 1)[None, :] <= nn.reshape(B)[:, None]).numpy()
    np.testing.assert_array_equal(k[0][real], p[0].numpy()[real], err_msg="dirs")
    for name, a, b in zip(("maxi", "maxj", "score"), k[1:], p[1:]):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    return k


# ------------------------------------------------------------------- tests


# (W, LPT): every lanes a thread that divides W/32 at W = 64, 192, 576, and
# the two (4, 5) that only other widths take
WIDTHS = [(64, 1), (64, 2), (192, 1), (192, 2), (192, 3), (192, 6), (576, 1), (576, 2),
          (576, 3), (576, 6), (128, 4), (320, 5)]


@pytest.mark.parametrize("W,lpt", WIDTHS)
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_model_widths_and_modes(W, lpt, mode):
    arrays = dag_inputs(W + lpt, 1, 48, 4, W, 2, max_dist=12)
    check_model(arrays, mode, 12, lpt)


@pytest.mark.parametrize("R,kind", [(1, "chain"), (6, "dag"), (96, "full")])
@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_model_rings(R, kind, mode):
    """Ring 1 (every in-edge delta 1), 6, and full history (R = N, every
    distance up to the whole graph), at in-degree up to P_CAP."""
    N = 96
    arrays = dag_inputs(R + 3, 1, N, tcvx.P_CAP, 192, 2, max_dist=R, chain=kind == "chain")
    aux, _ = pack_aux_gap(torch.from_numpy(arrays[1]), R)
    delta = (aux & 0xFFFF).numpy()
    if kind == "chain":
        assert delta.max() == 1
    if kind == "full":
        deg = (arrays[1][:, 1:, :] != arrays[1][:, :1, :]).sum(axis=1) + 1
        assert deg.max() == tcvx.P_CAP
    check_model(arrays, mode, R, 2 if mode == "nw" else 6)


def test_model_all_delta_one_at_the_spoa_width():
    arrays = dag_inputs(3, 1, 64, 4, 576, 2, max_dist=1, chain=True)
    for mode, lpt in (("nw", 6), ("ov", 3)):
        check_model(arrays, mode, 1, lpt)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_model_lengths_at_warp_boundaries(mode):
    """slen at lanes 31, 32, 33 and on both sides of every warp boundary
    (every 192 lanes at W=576, LPT 6; every 32 at LPT 1)."""
    W = 576
    slens = [31, 32, 33, 191, 192, 193, 383, 384, 385, 575]
    arrays = dag_inputs(17, 1, 40, 4, W, len(slens), max_dist=6, slens=slens)
    for lpt in (6, 1):
        check_model(arrays, mode, 6, lpt, scores=CONVEX_SMALL)


@pytest.mark.parametrize("scores", [CONVEX, CONVEX_SMALL], ids=["default", "small"])
@pytest.mark.parametrize("W,lpt", [(576, 6), (576, 3), (576, 1), (320, 5)])
def test_model_long_insertion_crosses_every_warp(W, lpt, scores):
    """One run of W - 1 - N inserted bases (`insertion_inputs`): the (q, c)
    line overtakes the (g, e) one after a few bases, and the Q chain crosses
    every warp."""
    arrays = insertion_inputs(W)
    dirs, maxi, maxj, score = check_model(arrays, "nw", 1, lpt, scores)
    m, x, g, e, q, c = scores
    N = arrays[0].shape[1]
    L = W - 1 - N
    assert q + (L - 1) * c > g + (L - 1) * e  # the Q line wins
    assert score[0, 0] == N * m + q + (L - 1) * c


@pytest.mark.parametrize("W,lpt", [(576, 6), (64, 1)])
def test_model_sw_rows_clamped_to_zero(W, lpt):
    arrays = mismatch_inputs(W, N=48)
    dirs, maxi, maxj, score = check_model(arrays, "sw", 1, lpt)
    assert (score == 0).all() and (maxi == 0).all()
    assert ((dirs[0, 1:40] & 0xFFFF) == 0).all()  # the stop code everywhere


# gap scores whose lines fall below the rings' -16000 floor from lane ~470
FLOOR_SCORES = (3, -5, -40, -35, -50, -34)


@pytest.mark.parametrize("lpt", [6, 3, 1])
@pytest.mark.parametrize("mode", ["nw", "ov"])
def test_model_dead_lanes_at_the_int16_floor(mode, lpt):
    """Gap scores that push the right lanes of every row below the rings'
    -16000 floor, across the warp boundaries at lanes 480 (LPT 3), 480, 512
    and 544 (LPT 1): the registers, and the H rebuilt at a warp's first
    lane, must hold the clamped value the rings hold, or the next rows
    differ."""
    arrays = dag_inputs(41, 1, 48, 4, 576, 2, max_dist=3)
    check_model(arrays, mode, 3, lpt, scores=FLOOR_SCORES)


def test_model_many_sequences_and_graphs():
    arrays = dag_inputs(23, 3, 48, 8, 192, 3, max_dist=20)
    for mode in ("nw", "sw", "ov"):
        check_model(arrays, mode, 20, 3)


@pytest.mark.parametrize("W,lpt,mode", [(64, 2, "nw"), (64, 1, "sw"), (96, 3, "ov")])
def test_model_equals_pallas_interpret(W, lpt, mode):
    """The model against the JAX package's Pallas kernel in interpret mode,
    as `tests/test_torch_poa_affine.py:check_case` runs it: the defined
    direction words (rows <= n_nodes, lanes <= slen) and the best cells."""
    N = 40
    codes, preds, sink, nn, seqp, slen = dag_inputs(31 + W, 1, N, 4, W, 2, max_dist=N)
    m, x, g, e, q, c = CONVEX
    D = seqp.shape[1]
    j_dp = jax.jit(functools.partial(jcvx._poa_dp_pallas_convex, align_type=mode, m=m, x=x, g=g,
                                     e=e, q=q, c=c, interpret=True, ring=0))(
        jnp.asarray(codes[:, None, :]), jnp.asarray(preds), jnp.asarray(sink[:, None, :]),
        jnp.asarray(nn[:, None, None]), jnp.asarray(seqp), jnp.asarray(slen[:, None, :]))
    aux, deg = pack_aux_gap(torch.from_numpy(preds), N)
    k = model_dp_convex(codes, aux.numpy(), deg.numpy(), sink, nn, seqp, slen, mode, *CONVEX, N,
                        lpt)
    for d in range(D):
        rows, lanes = int(nn[0]) + 1, int(slen[0, d]) + 1
        np.testing.assert_array_equal(k[0][0, :rows, d, :lanes],
                                      np.asarray(j_dp[0])[0, :rows, d, :lanes], err_msg=f"d={d}")
    for name, j, t in zip(("maxi", "maxj", "score"), j_dp[1:], k[1:]):
        np.testing.assert_array_equal(t, np.asarray(j)[:, 0, :], err_msg=name)


@pytest.mark.parametrize("scores", [CONVEX[2:], CONVEX_SMALL[2:], (-40, -30, -50, -20)])
@pytest.mark.parametrize("lpt", tcvx.K6_LPTS)
def test_k6_powers_are_the_matrix_powers(scores, lpt):
    """Every power the kernel takes is M^k of the reference's matrix: the
    doubling powers equal `mat_powers` (held to the JAX package's), and
    M^(a+b) = M^a (x) M^b for the ones between."""
    g, e, q, c = scores
    seg, step, xstep, mwarp1 = powers(g, e, q, c, lpt)
    ref = jcvx._mat_powers(g, e, q, c, 8)
    flat = lambda M: i32(M).reshape(4)  # noqa: E731
    M1 = flat(ref[0])
    for k in range(5):
        np.testing.assert_array_equal(seg[k + 1], mp_mul(seg[k], M1))
    for s in range(5):
        if lpt == 1:
            np.testing.assert_array_equal(step[s], flat(ref[s]))
        if s:
            np.testing.assert_array_equal(step[s], mp_mul(step[s - 1], step[s - 1]))
    np.testing.assert_array_equal(step[0], seg[lpt - 1])
    np.testing.assert_array_equal(xstep[0], mp_mul(step[4], step[4]))
    np.testing.assert_array_equal(xstep[0], mp_mul(mwarp1, M1))
    for s in range(1, 5):
        np.testing.assert_array_equal(xstep[s], mp_mul(xstep[s - 1], xstep[s - 1]))
    if lpt in (1, 2):
        np.testing.assert_array_equal(xstep[0], flat(ref[5 + lpt.bit_length() - 1]))


def test_k6_lanes_cover_every_width():
    """Every W the DP wrappers admit on the card (a multiple of 32 up to
    1024) has lanes a thread that the kernel is built for and that make
    whole warps, at least four from W=128 on; the spoa engine's widths 128,
    320, 576, 768 take 1, 2, 3, 6 (4, 5, 6, 4 warps). The rings sit in
    shared memory up to K6's own limit (W=576: 65 rows, not 66; the limit
    shared with K1 took 58), which with the row exchange stays within
    Hopper's 227 KB a block."""
    for W in range(32, 1025, 32):
        lpt = tcvx.k6_lanes_per_thread(W)
        assert lpt in tcvx.K6_LPTS and (W // lpt) % 32 == 0
        assert W // (32 * lpt) >= 4 or lpt == 1
    assert [tcvx.k6_lanes_per_thread(W) for W in (64, 128, 320, 576, 768, 1024)] == [1, 1, 2, 3,
                                                                                     6, 4]
    buffers = [tcvx.poa_gap.dp_buffers(1, 8, 1, 576, R, 3, "cpu", tcvx.K6_SMEM_RING_MAX)[-1]
               for R in (65, 66)]
    assert buffers[0] is None and buffers[1] is not None
    assert tcvx.K6_SMEM_RING_MAX + (2 * 5 * 32 + 32) * 4 == 227 * 1024
    with pytest.raises(ValueError):
        tcvx.k6_lanes_per_thread(100)
    with pytest.raises(ValueError):
        tcvx.mat_power(-8, -6, -10, -4, 0)
