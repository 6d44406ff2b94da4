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
