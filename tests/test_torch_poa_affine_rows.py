"""A numpy model of K5's row machinery (`csrc/poa_affine.cu`, `gap_rows.cuh`)
held to the plain PyTorch version `_dp_affine_plain`, and in three cases
to the JAX package's Pallas kernel in interpret mode. The kernel itself
runs only on the card (`tests/test_torch_cuda.py`); the model checks its
design here, step for step:

  - W / LPT threads, thread t owning lanes [t*LPT, (t+1)*LPT);
  - the prefix max of A0[j] - j*e serial over a thread's lanes, then a
    scan across the warp's 32 threads, then one carry a warp from the
    totals the warps publish before the row's barrier;
  - EB from the prefix at lanes j-1 and j-2 (own lanes, the left thread,
    or the left warp's published prefix at its second-to-last lane);
  - an in-edge of delta 1 from the previous row held in registers with
    the int16 clamp, its diagonal's left lane from the left thread, at a
    warp's first lane rebuilt from the left warp's published A0 and prefix;
  - every other in-edge from the rings, written after the barrier;
  - the best cell over a thread's lanes, then over the block;
  - H's candidates and the F chain packed at one shift.

Every output is an integer DP result: the tolerance is exact equality."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vechat_tpu.ops.kernels import poa_pallas_affine as jaff
from vechat_tpu_torch.ops.kernels import poa_affine as taff
from vechat_tpu_torch.ops.kernels.poa_linear import DELTA_BITS, NEG16, NEGV, TIE

SCORES = (3, -5, -8, -6)  # m, x, g, e


def i32(v):
    return np.asarray(v, dtype=np.int32)


def h16(v):
    """A value as an int16 ring holds it: the poison floor, then the cast."""
    return np.maximum(v, NEG16).astype(np.int16).astype(np.int32)


def model_dp_affine(codes, aux, deg, sink, nn, seqp, slen, mode, m, x, g, e, R, lpt):
    """K5's rows as the kernel computes them, one block (b, d) at a time;
    numpy int32 (wrapping as the card does). Returns dirs [B, N+1, D, W]
    (rows past a graph's n_nodes left 0), maxi, maxj, score [B, D]."""
    B, P, N = aux.shape
    D, W = seqp.shape[1], seqp.shape[2]
    assert W % (32 * lpt) == 0
    NT = W // lpt
    NW = NT // 32
    sw, nw = mode == "sw", mode == "nw"
    # H's candidates and the F chain packed at one shift, SH: the F chain's
    # codes are below 2^SH too, so its max and code are the reference's
    SH = taff.sh_bits_aff(P)
    NPRIO = 3 * P + 3
    MASKC = (1 << SH) - 1
    VSH = 1 << SH
    EEXT = (NPRIO - 1 - 3 * P) << DELTA_BITS
    EOPEN = (NPRIO - 1 - (3 * P + 1)) << DELTA_BITS
    GE = g - e
    lanes = np.arange(W, dtype=np.int32).reshape(NT, lpt)  # [thread, i] -> j
    j0 = lanes[:, 0]
    first = np.zeros((NT, lpt), bool)
    first[0, 0] = True  # lane 0 of the block
    warp_lane0 = np.arange(NT) % 32 == 0
    w_of = np.arange(NT) // 32
    dirs = np.zeros((B, N + 1, D, W), np.int32)
    maxi, maxj, score = (np.zeros((B, D), np.int32) for _ in range(3))

    def shift_in_warp(v):
        """v of the thread to the left within the warp (a thread's own at
        lane 0, as __shfl_up_sync gives it)."""
        out = np.roll(v, 1, axis=0)
        out[warp_lane0] = v[warp_lane0]
        return out

    for b in range(B):
        for d in range(D):
            sl = int(slen[b, d])
            qc = seqp[b, d].reshape(NT, lpt)
            jj = lanes
            cmask = (jj == sl) if nw else (jj != 0) & (jj <= sl)
            Hr = np.zeros((R + 1, W), np.int32)
            Fr = np.zeros((R + 1, W), np.int32)
            hp = np.zeros((NT, lpt), np.int32)
            if not sw:
                hp = np.where(jj == 0, 0, g + (jj - 1) * e).astype(np.int16).astype(np.int32)
            fp = np.where(jj == 0, g - e, NEG16).astype(np.int16).astype(np.int32)
            Hr[R], Fr[R] = hp.reshape(W), fp.reshape(W)
            if sw:
                dirs[b, 0, d] = 0
            else:
                fe = np.where(jj >= 2, 1 << taff.EB_BIT, 0)
                dirs[b, 0, d] = ((fe << 16) | np.where(jj == 1, EOPEN, EEXT)).reshape(W)
            best = np.full(NT, 0 if sw else NEG16 * TIE + TIE - 1, np.int64)
            bestj = j0.astype(np.int64).copy()
            hl_warp = np.zeros(NW, np.int32)
            wslot = 0
            for hr in range(1, int(nn[b]) + 1):
                r = hr - 1
                code = int(codes[b, r])
                dg = int(deg[b, r])
                # the previous row's H one lane left of each thread's first
                hl1 = shift_in_warp(hp[:, -1])
                hl1[warp_lane0] = hl_warp
                dmax = np.full((NT, lpt), NEGV, np.int32)
                acc = dmax.copy()
                facc = dmax.copy()
                for p in range(dg):
                    av = int(aux[b, p, r])
                    delta, slot = av & 0xFFFF, av >> 16
                    kd = ((NPRIO - 1 - p) << DELTA_BITS) + delta
                    kfe = e * VSH + ((NPRIO - 1 - (P + 2 * p)) << DELTA_BITS) + delta
                    kfo = g * VSH + ((NPRIO - 1 - (P + 2 * p + 1)) << DELTA_BITS) + delta
                    kge = e * VSH + ((2 * P - 1 - (2 * p + 1)) << DELTA_BITS) + delta
                    kgo = g * VSH + ((2 * P - 1 - 2 * p) << DELTA_BITS) + delta
                    if delta == 1:  # the registers
                        h, f, hl = hp, fp, hl1
                    else:  # the rings
                        h = Hr[slot].reshape(NT, lpt)
                        f = Fr[slot].reshape(NT, lpt)
                        hl = np.where(j0 > 0, Hr[slot][np.maximum(j0 - 1, 0)], 0).astype(np.int32)
                    left = np.concatenate([hl[:, None], h[:, :-1]], axis=1)
                    dmax = np.maximum(left * i32(VSH) + i32(kd), dmax)
                    acc = np.maximum(f * i32(VSH) + i32(kfe), acc)
                    acc = np.maximum(h * i32(VSH) + i32(kfo), acc)
                    facc = np.maximum(f * i32(VSH) + i32(kge), facc)
                    facc = np.maximum(h * i32(VSH) + i32(kgo), facc)
                prof = np.where(qc == code, i32(m * VSH), i32(x * VSH))
                v = np.where(first, acc, np.maximum(dmax + prof, acc))
                A, hcode = v >> SH, v & MASKC
                if not nw:
                    A = np.where(first, 0, A)
                    hcode = np.where(first, 0, hcode)
                A0 = np.maximum(A, 0) if sw else A
                s = np.maximum.accumulate(A0 - jj * i32(e), axis=1)
                # across the warp, then the warps' published values
                incl = np.maximum.accumulate(s[:, -1].reshape(NW, 32), axis=1).reshape(NT)
                wex = shift_in_warp(incl)
                wex[warp_lane0] = NEGV
                q = np.maximum(wex, s[:, -2]) if lpt >= 2 else wex
                ql = shift_in_warp(q)
                tot = incl[31::32]
                qpub = q[31::32]
                apub = A0[31::32, -1]
                carry_w = np.full(NW, NEGV, np.int32)
                for w in range(1, NW):
                    carry_w[w] = max(carry_w[w - 1], tot[w - 1])
                cl_w = np.concatenate([[NEGV], carry_w[:-1]]).astype(np.int32)
                carry = carry_w[w_of]
                excl = np.maximum(carry, wex)
                t2 = np.maximum(carry, ql)
                for w in range(NW):
                    t = 32 * w
                    if w == 0:
                        t2[t] = NEGV
                        continue
                    t2[t] = max(cl_w[w], qpub[w - 1])
                    hv = max(int(apub[w - 1]), int(t2[t]) + GE + (int(j0[t]) - 1) * e)
                    hl_warp[w] = h16(max(hv, 0) if sw else hv)
                tp = np.concatenate([excl[:, None], np.maximum(excl[:, None], s[:, :-1])], axis=1)
                prev2 = [t2[:, None], excl[:, None]] + [np.maximum(excl[:, None], s[:, :-2])]
                tp2 = np.concatenate(prev2, axis=1)[:, :lpt]
                E = np.where(first, NEG16, tp + GE + jj * i32(e))
                EB = (jj >= 2) & (tp == tp2)
                Hf = np.maximum(A0, E)
                hcode = np.where(E > A0, np.where(EB, EEXT, EOPEN), hcode)
                if sw:
                    Hf = np.maximum(Hf, 0)
                    hcode = np.where(Hf == 0, 0, hcode)
                hp, fp = h16(Hf), h16(facc >> SH)
                Hr[wslot], Fr[wslot] = hp.reshape(W), fp.reshape(W)
                wslot = wslot + 1 if wslot + 1 < R else 0
                words = (((facc & MASKC) | (EB.astype(np.int32) << taff.EB_BIT)) << 16) | hcode
                dirs[b, hr, d] = words.reshape(W)
                if cmask.any() and (sw or sink[b, r] != 0):
                    # the best cell over each thread's lanes, as ThreadBest
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


# ------------------------------------------------------------------ inputs


def dag_inputs(seed, B, N, P, W, D, max_dist, slens=None, chain=False, far=0):
    """Random rank-ordered DAGs in the JAX layout (numpy, from `seed`): up
    to P in-edges a node from the `max_dist` rows above it (a chain of
    delta-1 edges with `chain`), n_nodes in [N/2, N) (N - 1 with `far`), a
    node with an in-edge of distance `far` when it is set; D random
    sequences of lengths `slens` (random in [1, W) by default)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, N)).astype(np.int32)
    preds = np.zeros((B, P, N), np.int32)
    sink = (rng.random((B, N)) < 0.2).astype(np.int32)
    nn = rng.integers(N // 2, N, B).astype(np.int32)
    if far:
        nn[:] = N - 1
    for b in range(B):
        for r in range(N):
            if chain:
                preds[b, :, r] = r
                continue
            cand = np.arange(max(0, r + 1 - max_dist), r + 1)
            ps = rng.choice(cand, size=int(rng.integers(1, min(P, len(cand)) + 1)), replace=False)
            preds[b, :, r] = ps[0]  # padding repeats slot 0
            preds[b, : len(ps), r] = ps
        if far:
            r = far  # DP row far + 1 gets an in-edge from row 1
            preds[b, 1 % P, r] = 1
    slen = np.array(slens if slens is not None else rng.integers(1, W, B * D), np.int32)
    slen = np.resize(slen, B * D).reshape(B, D)
    seqp = np.full((B, D, W), 0xFF, np.int32)
    for b in range(B):
        for d in range(D):
            seqp[b, d, 1 : 1 + slen[b, d]] = rng.integers(0, 4, slen[b, d])
    return codes, preds, sink, nn, seqp, slen


def insertion_inputs(W, N=64):
    """One graph, a chain of N random codes, and one query of W - 1 bases:
    the graph's first half, then random bases, then its second half; the
    nw alignment inserts the middle, an E chain across every warp."""
    rng = np.random.default_rng(5)
    g_codes = rng.integers(0, 4, N).astype(np.int32)
    codes = g_codes[None, :]
    preds = np.arange(N, dtype=np.int32)[None, None, :].repeat(4, axis=1)
    sink = np.zeros((1, N), np.int32)
    sink[0, -1] = 1
    nn = np.array([N], np.int32)
    q = np.concatenate([g_codes[: N // 2], rng.integers(0, 4, W - 1 - N), g_codes[N // 2 :]])
    seqp = np.full((1, 1, W), 0xFF, np.int32)
    seqp[0, 0, 1:] = q
    slen = np.array([[W - 1]], np.int32)
    return codes, preds, sink, nn, seqp, slen


def mismatch_inputs(W, N=96):
    """A graph of A's against queries of C's: every sw cell clamps to 0."""
    codes = np.zeros((1, N), np.int32)
    preds = np.arange(N, dtype=np.int32)[None, None, :].repeat(4, axis=1)
    sink = np.ones((1, N), np.int32)
    nn = np.array([N - 3], np.int32)
    seqp = np.full((1, 2, W), 0xFF, np.int32)
    seqp[0, :, 1:] = 1
    slen = np.array([[W - 1, W // 2]], np.int32)
    return codes, preds, sink, nn, seqp, slen


def _plain_and_model(arrays, mode, R, lpt, scores=SCORES):
    codes, preds, sink, nn, seqp, slen = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    B, P, N = preds.shape
    D = seqp.shape[1]
    assert R >= 1
    aux, deg = taff.pack_aux_gap(preds, R)
    args = (codes.reshape(B, N), aux, deg, sink.reshape(B, N), nn.reshape(B), seqp,
            slen.reshape(B, D))
    p = taff._dp_affine_plain(*args, mode, *scores, R)
    k = model_dp_affine(*(a.numpy() for a in args), mode, *scores, R, lpt)
    return p, k, nn.reshape(B)


def check_model(arrays, mode, R, lpt, scores=SCORES):
    """The model's real rows (every lane) and best cells equal the plain
    version's."""
    p, k, nn = _plain_and_model(arrays, mode, R, lpt, scores)
    N = p[0].shape[1] - 1
    real = (torch.arange(N + 1)[None, :] <= nn[:, None]).numpy()
    np.testing.assert_array_equal(k[0][real], p[0].numpy()[real], err_msg="dirs")
    for name, a, b in zip(("maxi", "maxj", "score"), k[1:], p[1:]):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    return k


# ------------------------------------------------------------------- tests


# (W, LPT): the buckets at the default LPT and at the others measured
# (LPT 1: a thread a lane; 3, 5: odd), and widths off the buckets
WIDTHS = [(128, 4), (128, 1), (320, 5), (320, 2), (576, 6), (576, 3), (576, 2), (768, 6),
          (768, 4), (96, 3), (224, 1)]


@pytest.mark.parametrize("W,lpt", WIDTHS)
@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_model_widths_and_modes(W, lpt, mode):
    arrays = dag_inputs(W + lpt, 1, 96, 4, W, 2, max_dist=12)
    check_model(arrays, mode, 12, lpt)


@pytest.mark.parametrize(
    "R,kind", [(1, "chain"), (5, "dag"), (64, "dag"), (511, "far")]
)
@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_model_rings(R, kind, mode):
    """Ring 1 (every in-edge delta 1), 5 and 64 (random DAGs), and 511 with
    one in-edge of distance 511."""
    N = 520 if kind == "far" else 160
    arrays = dag_inputs(R, 1, N, 8, 192, 1, max_dist=min(R, 8) if kind == "far" else R,
                        chain=kind == "chain", far=511 if kind == "far" else 0)
    aux, _ = taff.pack_aux_gap(torch.from_numpy(arrays[1]), R)
    delta = (aux & 0xFFFF).numpy()
    if kind == "chain":
        assert delta.max() == 1
    if kind == "far":
        assert delta.max() == 511
    check_model(arrays, mode, R, 2)


def test_model_all_delta_one_at_the_spoa_width():
    arrays = dag_inputs(3, 1, 128, 4, 576, 2, max_dist=1, chain=True)
    for mode in ("nw", "ov"):
        check_model(arrays, mode, 1, 6)


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_model_lengths_at_warp_boundaries(mode):
    """slen at lanes 31, 32, 33 and on both sides of every warp boundary
    (every 192 lanes at W=576, LPT 6; every 32 at LPT 1)."""
    W = 576
    slens = [31, 32, 33, 191, 192, 193, 383, 384, 385, 575]
    arrays = dag_inputs(17, 1, 80, 4, W, len(slens), max_dist=6, slens=slens)
    for lpt in (6, 1):
        check_model(arrays, mode, 6, lpt)


@pytest.mark.parametrize("W,lpt", [(576, 6), (576, 3), (768, 6), (320, 5)])
def test_model_long_insertion_crosses_every_warp(W, lpt):
    arrays = insertion_inputs(W)
    dirs, maxi, maxj, score = check_model(arrays, "nw", 1, lpt)
    # every graph node matched and the rest one gap: g + (length - 1) * e
    m, x, g, e = SCORES
    N = arrays[0].shape[1]
    assert score[0, 0] == N * m + g + (W - 1 - N - 1) * e


@pytest.mark.parametrize("W,lpt", [(576, 6), (128, 1)])
def test_model_sw_rows_clamped_to_zero(W, lpt):
    arrays = mismatch_inputs(W)
    dirs, maxi, maxj, score = check_model(arrays, "sw", 1, lpt)
    assert (score == 0).all() and (maxi == 0).all()
    assert ((dirs[0, 1:40] & 0xFFFF) == 0).all()  # the stop code everywhere


def test_model_many_sequences_and_graphs():
    arrays = dag_inputs(23, 3, 128, 8, 320, 3, max_dist=40)
    for mode in ("nw", "sw", "ov"):
        check_model(arrays, mode, 40, 2)


@pytest.mark.parametrize(
    "W,lpt,mode", [(128, 1, "nw"), (128, 2, "sw"), (96, 3, "ov")]
)
def test_model_equals_pallas_interpret(W, lpt, mode):
    """The model against the JAX package's Pallas kernel in interpret mode,
    as `tests/test_torch_poa_affine.py:check_case` runs it: the defined
    direction words (rows <= n_nodes, lanes <= slen) and the best cells."""
    N = 48
    codes, preds, sink, nn, seqp, slen = dag_inputs(31 + W, 1, N, 4, W, 2, max_dist=N)
    m, x, g, e = SCORES
    B, D = 1, seqp.shape[1]
    j_dp = jax.jit(functools.partial(jaff._poa_dp_pallas_affine, align_type=mode, m=m, x=x, g=g,
                                     e=e, interpret=True, ring=0))(
        jnp.asarray(codes[:, None, :]), jnp.asarray(preds), jnp.asarray(sink[:, None, :]),
        jnp.asarray(nn[:, None, None]), jnp.asarray(seqp), jnp.asarray(slen[:, None, :]))
    aux, deg = taff.pack_aux_gap(torch.from_numpy(preds), N)
    k = model_dp_affine(codes, aux.numpy(), deg.numpy(), sink, nn, seqp, slen, mode, *SCORES, N,
                        lpt)
    for d in range(D):
        rows, lanes = int(nn[0]) + 1, int(slen[0, d]) + 1
        np.testing.assert_array_equal(k[0][0, :rows, d, :lanes],
                                      np.asarray(j_dp[0])[0, :rows, d, :lanes], err_msg=f"d={d}")
    for name, j, t in zip(("maxi", "maxj", "score"), j_dp[1:], k[1:]):
        np.testing.assert_array_equal(t, np.asarray(j)[:, 0, :], err_msg=name)


def test_k5_lanes_cover_every_width():
    """Every W the DP wrappers admit on the card (a multiple of 32 up to
    1024) has lanes a thread that the kernel is built for and that make
    whole warps; the spoa path's W=576 takes 6 (three warps). The rings sit
    in shared memory up to K5's own limit (W=576: 99 rows, not 100), which
    with the row exchange stays within Hopper's 227 KB a block."""
    for W in range(32, 1025, 32):
        lpt = taff.k5_lanes_per_thread(W)
        assert lpt in taff.K5_LPTS and (W // lpt) % 32 == 0
    assert [taff.k5_lanes_per_thread(W) for W in (128, 320, 576, 768)] == [4, 5, 6, 6]
    buffers = [taff.poa_gap.dp_buffers(1, 8, 1, 576, R, 2, "cpu", taff.K5_SMEM_RING_MAX)[-1]
               for R in (99, 100)]
    assert buffers[0] is None and buffers[1] is not None
    assert taff.K5_SMEM_RING_MAX + 224 * 4 == 227 * 1024
    with pytest.raises(ValueError):
        taff.k5_lanes_per_thread(100)


@pytest.mark.parametrize("mode", ["nw", "ov"])
def test_model_dead_lanes_at_the_int16_floor(mode):
    """Gap scores of -40/-30 push the right lanes of every row below the
    rings' -16000 floor: the registers must hold the clamped value the
    rings hold, or the next rows differ."""
    arrays = dag_inputs(41, 1, 96, 4, 576, 2, max_dist=3)
    check_model(arrays, mode, 3, 6, scores=(3, -5, -40, -30))
