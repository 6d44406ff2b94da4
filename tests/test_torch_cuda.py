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
from vechat_tpu_torch.ops.kernels import pairwise_nw as pw
from vechat_tpu_torch.ops.kernels import poa_linear as pl
from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend, pack_windows
from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
from vechat_tpu_torch.ops.native_graph import make_graph

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


def test_poa_global_ring_matches_host(cuda):
    """A ring too large for shared memory ((R+1)*W*2 bytes > 200 KB) runs
    from the global scratch ring; alignments equal the host oracle's."""
    B, N, P, W, D, R = 2, 640, 8, 320, 3, 511
    assert (R + 1) * W * 2 > pl.SMEM_RING_MAX
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
