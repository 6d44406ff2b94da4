"""The spoa surface of the port on the CPU: `TorchGraphEngine` (routing,
counters, equality with the host engines and with the JAX package's
`PallasGraphEngine` in interpret mode) and `vechat_tpu_torch.cli.spoa_main`
against `vechat_tpu.cli.spoa_main`, byte for byte."""

import contextlib
import io

import numpy as np
import pytest
import torch

import vechat_tpu.cli.spoa_main as jax_spoa
import vechat_tpu.ops.kernels.graph_engine as jax_ge
import vechat_tpu_torch.cli.spoa_main as torch_spoa
from tests.test_torch_poa_linear import build_graphs, mutate, rand_seq
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import make_engine
from vechat_tpu_torch.ops.kernels.graph_engine import TorchGraphEngine

LINEAR = (3, -5, -4, -4, -4, -4)
AFFINE = (3, -5, -8, -6, -8, -6)
CONVEX = (3, -5, -8, -6, -10, -2)
CLI_DEFAULT = (5, -4, -8, -6, -10, -4)
SUBTYPES = [(LINEAR, "linear"), (AFFINE, "affine"), (CONVEX, "convex"), (CLI_DEFAULT, "convex")]


@pytest.mark.parametrize("scores,want", SUBTYPES)
def test_subtype_selection_matches_factory(scores, want):
    # alignment_engine.cpp:57-66
    eng = TorchGraphEngine("nw", *scores, device="cpu")
    assert eng.subtype == want
    assert jax_ge.PallasGraphEngine("nw", *scores, interpret=True).subtype == want
    assert type(make_engine("nw", *scores)).__name__.lower().startswith(want[:4])


@pytest.mark.parametrize("scores,subtype", SUBTYPES[:3])
def test_engine_matches_host_and_pallas_engine(scores, subtype):
    """A graph in the 256-node bucket: the port's engine, its host engine and
    the JAX engine (interpret mode) agree on alignment and score."""
    rng = np.random.default_rng(0)
    base = rand_seq(rng, 30)
    jgraph, tgraph = build_graphs([base])
    q = encode(base[:12] + base[18:])  # 6-base deletion
    dev = TorchGraphEngine("nw", *scores, device="cpu")
    got, gs = dev.align(q, tgraph, return_score=True)
    want, ws = make_engine("nw", *scores).align(q, tgraph, return_score=True)
    assert (got, gs) == (want, ws)
    assert (dev.device_alignments, dev.fallbacks) == (1, 0)
    jdev = jax_ge.PallasGraphEngine("nw", *scores, interpret=True)
    assert jdev.align(q, jgraph, return_score=True) == (got, gs)
    assert dev.align(q, tgraph) == got  # without the score


@pytest.mark.parametrize("scores,subtype", SUBTYPES[:3])
def test_engine_aligns_300_nodes_where_the_reference_raises(scores, subtype):
    """A limit of the reference: its engine asks for full history (ring =
    the 640 bucket), which the 9-bit distance field refuses. The port sizes
    the ring to the graph's largest predecessor distance and aligns."""
    rng = np.random.default_rng(7)
    base = rand_seq(rng, 290)
    jgraph, tgraph = build_graphs([base, mutate(rng, base, 0.05)])
    assert 256 < tgraph.num_nodes() <= 640
    q = encode(mutate(rng, base, 0.05)[:100])
    with pytest.raises(ValueError, match="ring 640 exceeds the .*delta field"):
        jax_ge.PallasGraphEngine("sw", *scores, interpret=True).align(q, jgraph)
    dev = TorchGraphEngine("sw", *scores, device="cpu")
    assert dev.align(q, tgraph, return_score=True) == make_engine("sw", *scores).align(
        q, tgraph, return_score=True
    )
    assert (dev.device_alignments, dev.fallbacks) == (1, 0)


@pytest.mark.parametrize("scores", [AFFINE, CONVEX])
@pytest.mark.parametrize("query", ["CCGTACGT", "GTACGT", "TTACCGTACGT"])
def test_nw_walk_ends_at_the_origin_in_any_state(scores, query):
    """A fault of the reference walks: an nw alignment that starts by
    deleting the start node reaches cell (0, 0) in the vertical-chain state,
    where the reference does not stop (it emits (-1, -1) pairs). The port's
    walk ends at (0, 0) in any state and equals the host engine.

    What the reference prints follows from its direction codes. With `lead`
    nodes deleted before the first match of the host alignment:
      - lead == 0: the walk reaches (0, 0) in state H and stops; equal.
      - convex: lane 0 masks the F/O opens, so the chain at row 1 continues
        into (0, 0) in the vertical state: one pair (-1, -1) more.
      - affine, lead == 1: the H code at row 1 ranks F-extend before the
        tying F-open and lands on (0, 0) in the vertical state; row 0's
        chain code never returns to H, so the walk pads with (-1, -1) to
        the end of its buffer, L = 2N + W.
      - affine, lead >= 2: the walk passes the chain code of row 1, which
        ranks the tying F-open first and returns to H at (0, 0); equal."""
    jgraph, tgraph = build_graphs(["ACCGTACGT"])
    q = encode(query)
    want = make_engine("nw", *scores).align(q, tgraph, return_score=True)
    assert TorchGraphEngine("nw", *scores, device="cpu").align(q, tgraph, return_score=True) == want
    jgot = jax_ge.PallasGraphEngine("nw", *scores, interpret=True).align(
        q, jgraph, return_score=True
    )
    lead = next(k for k, (_, pos) in enumerate(want[0]) if pos != -1)
    assert lead == {"CCGTACGT": 1, "GTACGT": 3, "TTACCGTACGT": 0}[query]
    if lead == 0:
        padding = 0
    elif scores == CONVEX:
        padding = 1
    elif lead == 1:
        padding = 2 * 256 + 128 - len(want[0])  # the 256-node, 128-lane buckets
    else:
        padding = 0
    assert jgot == ([(-1, -1)] * padding + want[0], want[1])


def _wide_graph(fan):
    """One node with `fan` in-edges: start-anchored reads that differ in
    their first base and share the rest."""
    from vechat_tpu_torch.ops.poagraph import PoaGraph

    gr = PoaGraph()
    tail = encode("CCGTACGT")
    first = None
    for k in range(fan):
        codes = np.concatenate([np.full(k + 1, k % 4, np.uint8), tail])
        # align the shared tail onto the first read's tail, leave the head new
        aln = [] if first is None else [(-1, i) for i in range(k + 1)] + [
            (first + i, k + 1 + i) for i in range(len(tail))
        ]
        gr.add_alignment(aln, codes, np.ones(len(codes), dtype=np.uint32))
        if first is None:
            first = 1
    return gr


@pytest.mark.parametrize(
    "scores,make,routed",
    [
        # beyond the largest node bucket
        (LINEAR, lambda rng: (build_graphs([rand_seq(rng, 2100)])[1], 100), True),
        # scores outside int16 at this bucket: (640 + 128 + 2) * 40 > 14000
        ((3, -5, -40, -30, -40, -30), lambda rng: (build_graphs([rand_seq(rng, 300)])[1], 60), True),
        # sequence wider than the widest lane bucket
        (AFFINE, lambda rng: (build_graphs([rand_seq(rng, 40)])[1], 800), True),
        # in-degree over the convex kernel's cap, but inside the affine one's
        (CONVEX, lambda rng: (_wide_graph(9), 8), True),
        (AFFINE, lambda rng: (_wide_graph(9), 8), False),
    ],
)
def test_capacity_routes_are_counted(scores, make, routed):
    rng = np.random.default_rng(1)
    graph, qlen = make(rng)
    q = encode(rand_seq(rng, qlen))
    dev = TorchGraphEngine("nw", *scores, device="cpu")
    assert dev.align(q, graph, return_score=True) == make_engine("nw", *scores).align(
        q, graph, return_score=True
    )
    assert (dev.fallbacks, dev.device_alignments) == ((1, 0) if routed else (0, 1))


def test_long_edge_goes_to_the_host():
    """A predecessor distance over 511 does not fit the distance field."""
    rng = np.random.default_rng(2)
    base = rand_seq(rng, 600)
    _, graph = build_graphs([base])
    # a second read that skips 560 bases: one edge spans them
    skip = encode(base[:20] + base[580:])
    aln = [(i, i) for i in range(20)] + [(580 + i, 20 + i) for i in range(20)]
    graph.add_alignment(aln, skip, np.ones(len(skip), dtype=np.uint32))
    q = encode(base[:50])
    for scores in (LINEAR, AFFINE, CONVEX):
        dev = TorchGraphEngine("nw", *scores, device="cpu")
        assert dev.align(q, graph) == make_engine("nw", *scores).align(q, graph)
        assert (dev.fallbacks, dev.device_alignments) == (1, 0)


def test_empty_graph_or_sequence():
    from vechat_tpu_torch.ops.poagraph import PoaGraph

    dev = TorchGraphEngine("nw", *AFFINE, device="cpu")
    assert dev.align(encode("ACGT"), PoaGraph(), return_score=True) == ([], 0)
    _, graph = build_graphs(["ACGT"])
    assert dev.align(np.zeros(0, np.uint8), graph) == []
    assert (dev.fallbacks, dev.device_alignments) == (0, 0)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchGraphEngine("nw", *AFFINE)


# ------------------------------------------------------------------ the CLI

READS = [
    "ACGTACGTAGCTAGCATCGATTGACCA",
    "ACGTACGTAGCTAGCATCGATTGACCA",
    "ACGTTACGTAGCTAGCTCGATTGCCA",
    "ACGTACGAGCTAGCATCGAGGTTGACCA",
]


def _fasta(tmp_path, reads, name="in.fa"):
    fa = tmp_path / name
    fa.write_text("".join(f">r{i} extra\n{s}\n" for i, s in enumerate(reads)))
    return str(fa)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


def _score_args(scores):
    return [a for flag, v in zip("mngeqc", scores) for a in (f"-{flag}", str(v))]


@pytest.mark.parametrize("result", [0, 1, 2, 3, 4])
def test_cli_results_match_jax_host(tmp_path, result):
    fa = _fasta(tmp_path, READS)
    argv = [fa, "-l", "1", "-r", str(result)]
    got, err = _run(torch_spoa.main, argv + ["--backend", "torch"])
    assert got == _run(jax_spoa.main, argv + ["--backend", "host"])[0]
    assert got == _run(torch_spoa.main, argv + ["--backend", "host"])[0]
    assert got
    assert "device_alignments=3 fallbacks=0" in err


@pytest.mark.parametrize("algorithm", [0, 1, 2])
@pytest.mark.parametrize("scores", [LINEAR, AFFINE, CLI_DEFAULT])
def test_cli_modes_and_subtypes_match_jax_host(tmp_path, algorithm, scores):
    fa = _fasta(tmp_path, READS)
    argv = [fa, "-l", str(algorithm), "-r", "0", "-r", "1", *_score_args(scores)]
    got, _ = _run(torch_spoa.main, argv + ["--backend", "torch"])
    assert got == _run(jax_spoa.main, argv + ["--backend", "host"])[0]
    assert ">Consensus" in got


def test_cli_strand_ambiguous_matches_jax_host(tmp_path):
    comp = str.maketrans("ACGT", "TGCA")
    reads = [s if i % 2 == 0 else s.translate(comp)[::-1] for i, s in enumerate(READS)]
    fa = _fasta(tmp_path, reads)
    argv = [fa, "-l", "1", "-s", "-r", "0", "-r", "4", *_score_args(AFFINE)]
    got, err = _run(torch_spoa.main, argv + ["--backend", "torch"])
    assert got == _run(jax_spoa.main, argv + ["--backend", "host"])[0]
    assert READS[0] in got
    assert "device_alignments=6 fallbacks=0" in err  # both strands of three reads


def test_cli_matches_jax_pallas_backend(tmp_path, monkeypatch):
    """The JAX package's device engine in interpret mode, patched in as its
    own CLI test does."""
    orig = jax_ge.PallasGraphEngine.__init__

    def patched(self, *a, **k):
        k["interpret"] = True
        orig(self, *a, **k)

    monkeypatch.setattr(jax_ge.PallasGraphEngine, "__init__", patched)
    fa = _fasta(tmp_path, READS[:3])
    argv = [fa, "-r", "0", "-r", "1"]
    got, _ = _run(torch_spoa.main, argv + ["--backend", "torch"])
    assert got == _run(jax_spoa.main, argv + ["--backend", "pallas"])[0]
    assert ">Consensus" in got


def test_cli_dot_file(tmp_path):
    fa = _fasta(tmp_path, READS)
    dots = []
    for main, backend in ((torch_spoa.main, "torch"), (jax_spoa.main, "host")):
        dot = tmp_path / f"{backend}.dot"
        _run(main, [fa, "-l", "1", "-d", str(dot), "--backend", backend])
        dots.append(dot.read_text())
    assert dots[0] == dots[1] and dots[0].startswith("digraph")


def test_cli_cuda_backend_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = _fasta(tmp_path, READS)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_spoa.main([fa])  # --backend cuda is the default
