"""TorchAlignerBackend (plain PyTorch versions on the CPU) against the JAX
package's PallasAlignerBackend in interpret mode and the host oracle, with
the small shape buckets of tests/test_pallas_backend.py. Alignments are
compared exactly."""

import numpy as np
import pytest
import torch

import vechat_tpu.ops.kernels.backend as jax_backend_mod
import vechat_tpu_torch.ops.kernels.backend as backend_mod
import vechat_tpu_torch.ops.kernels.dense as dense_mod
from vechat_tpu.ops.encode import encode as jax_encode
from vechat_tpu.ops.graph_align import LinearAligner as JaxLinearAligner
from vechat_tpu.ops.kernels.backend import PallasAlignerBackend
from vechat_tpu.ops.poagraph import PoaGraph as JaxPoaGraph
from vechat_tpu_torch.cli.racon_main import make_backend
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import LinearAligner
from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
from vechat_tpu_torch.ops.poagraph import PoaGraph


def build_graph(seqs, graph_cls=PoaGraph, aligner_cls=LinearAligner, enc=encode):
    eng = aligner_cls("nw", 3, -5, -4)
    gr = graph_cls()
    for s in seqs:
        codes = enc(s)
        aln = eng.align(codes, gr) if gr.num_nodes() else []
        gr.add_alignment(aln, codes, np.ones(len(codes), dtype=np.uint32))
    return gr


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
        else:
            out.append(c)
    return "".join(out)


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    for mod in (dense_mod, jax_backend_mod):
        monkeypatch.setattr(mod, "N_BUCKETS", (32, 64))
        monkeypatch.setattr(mod, "W_BUCKETS", (32,))
        monkeypatch.setattr(mod, "P_BUCKETS", (4, 8))


def twin_items(rng, n_graphs=2, per_graph=3):
    """The same items for both packages: graphs built by each package's own
    classes from the same sequences, several sequences per graph, nw and
    sw."""
    base = rand_seq(rng, 20)
    graph_seqs = [[mutate(rng, base) for _ in range(3)] for _ in range(n_graphs)]
    jg = [build_graph(s, JaxPoaGraph, JaxLinearAligner, jax_encode) for s in graph_seqs]
    tg = [build_graph(s) for s in graph_seqs]
    spec = []
    for gi in range(n_graphs):
        for _ in range(per_graph):
            spec.append((mutate(rng, base), gi, "nw"))
    spec.append((mutate(rng, base), 0, "sw"))
    jitems = [(jax_encode(s), jg[gi], m) for s, gi, m in spec]
    titems = [(encode(s), tg[gi], m) for s, gi, m in spec]
    return jitems, titems


def test_backend_matches_pallas_and_host():
    rng = np.random.default_rng(0)
    jitems, titems = twin_items(rng)
    be = TorchAlignerBackend(3, -5, -4, device="cpu")
    got = be.align_batch(titems)
    assert be.fallbacks == 0
    assert be.device_alignments == len(titems)
    assert be.n_dispatches >= 1

    ref = PallasAlignerBackend(3, -5, -4, interpret=True)
    ref._n_dev = 1  # the single-device rle path
    assert got == ref.align_batch(jitems)

    host = {m: LinearAligner(m, 3, -5, -4) for m in ("nw", "sw")}
    for (codes, graph, mode), aln in zip(titems, got):
        assert aln == host[mode].align(codes, graph)


def test_backend_ring_path(monkeypatch):
    """An H ring shorter than the node bucket: each launch's ring is as deep
    as its graphs' largest predecessor distance, as on the production
    windows."""
    rings = []
    real = backend_mod.poa_align

    def spy(*args, ring, **kw):
        rings.append((ring, args[1].shape[2]))
        return real(*args, ring=ring, **kw)

    monkeypatch.setattr(backend_mod, "poa_align", spy)
    rng = np.random.default_rng(9)
    base = rand_seq(rng, 24)
    graphs = [build_graph([mutate(rng, base) for _ in range(3)]) for _ in range(2)]
    items = [(encode(mutate(rng, base)), g, "nw") for g in graphs for _ in range(3)]
    be = TorchAlignerBackend(3, -5, -4, device="cpu")
    got = be.align_batch(items)
    assert be.n_dispatches >= 1 and be.fallbacks == 0
    assert rings and all(1 <= ring < nb for ring, nb in rings), rings
    host = LinearAligner("nw", 3, -5, -4)
    for (codes, g, _), aln in zip(items, got):
        assert aln == host.align(codes, g)


def test_backend_empty_and_oversize_fallback():
    rng = np.random.default_rng(1)
    big = build_graph([rand_seq(rng, 100)])  # exceeds the shrunken buckets
    small = build_graph(["ACGTACGT"])
    be = TorchAlignerBackend(3, -5, -4, device="cpu")
    items = [
        (np.array([], np.uint8), small, "nw"),
        (encode("ACGT"), big, "nw"),
        (encode("ACGTACGA"), small, "nw"),
    ]
    got = be.align_batch(items)
    assert got[0] == []
    assert be.fallbacks == 1 and be.device_alignments == 1
    host = LinearAligner("nw", 3, -5, -4)
    assert got[1] == host.align(encode("ACGT"), big)
    assert got[2] == host.align(encode("ACGTACGA"), small)
    counters = be.counters()
    assert counters["fallbacks"] == 1 and counters["device_alignments"] == 1


def test_backend_counts_scores_outside_int16():
    """Scores whose worst case overflows the int16 H rows take the host
    route, one counted fallback per item."""
    g = build_graph(["ACGTACGTAC", "ACGTTCGTAC"])
    be = TorchAlignerBackend(300, -500, -400, device="cpu")
    items = [(encode("ACGTACGAAC"), g, "nw")] * 2
    got = be.align_batch(items)
    assert be.fallbacks == 2 and be.device_alignments == 0
    assert got[0] == LinearAligner("nw", 300, -500, -400).align(items[0][0], g)


def test_backend_edit_align_batch():
    rng = np.random.default_rng(4)
    from vechat_tpu_torch.ops.pairwise import edit_align

    t = rng.integers(0, 4, 60).astype(np.uint8)
    q = t.copy()
    q[10] = (q[10] + 1) % 4
    be = TorchAlignerBackend(3, -5, -4, device="cpu")
    assert be.edit_align_batch([(q, t)]) == [edit_align(q, t)]
    assert be.counters()["exact_pairs"] == 1


def test_make_backend_names():
    assert make_backend("torch", 3, -5, -4).device == torch.device("cpu")
    assert type(make_backend("host", 3, -5, -4)).__name__ == "HostAlignerBackend"
    with pytest.raises(ValueError):
        make_backend("auto", 3, -5, -4)


def test_cuda_backend_raises_without_gpu(monkeypatch):
    """`cuda` never drops to the CPU: without a GPU it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("cuda", 3, -5, -4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAlignerBackend(3, -5, -4, device="cuda")
