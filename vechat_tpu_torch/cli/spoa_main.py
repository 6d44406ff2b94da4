"""`vechat-spoa-torch` — standalone MSA/consensus tool, CLI-compatible with
the vendored spoa binary (reference: vendor/spoa/src/main.cpp).

Counterpart of `vechat_tpu/cli/spoa_main.py`. One growing POA graph; each
sequence is aligned to it by the engine its gap scores select (linear,
affine or convex), on the card by default.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.fastx import read_fastx
from ..ops.encode import decode, encode, phred_weights
from ..ops.graph_align import make_engine
from ..ops.poagraph import PoaGraph

ALGO = {0: "sw", 1: "nw", 2: "ov"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vechat-spoa-torch", description="POA MSA/consensus (spoa-compatible)"
    )
    p.add_argument("sequences")
    p.add_argument("-m", type=int, default=5)
    p.add_argument("-n", type=int, default=-4)
    p.add_argument("-g", type=int, default=-8)
    p.add_argument("-e", type=int, default=-6)
    p.add_argument("-q", type=int, default=-10)
    p.add_argument("-c", type=int, default=-4)
    p.add_argument("-l", "--algorithm", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("-r", "--result", type=int, action="append", default=None)
    p.add_argument("-d", "--dot", default=None)
    p.add_argument("-s", "--strand-ambiguous", action="store_true")
    p.add_argument(
        "--backend",
        choices=["cuda", "torch", "host"],
        default="cuda",
        help="alignment engine: cuda = the CUDA kernels on the GPU (raises "
        "without one), torch = their plain PyTorch versions on the CPU, "
        "host = the host oracle; nothing falls back from one to another",
    )
    return p


def make_aligner(args):
    """The alignment engine `args` asks for. Subtype selection needs all
    four gap parameters (alignment_engine.cpp:57-66)."""
    scores = (ALGO[args.algorithm], args.m, args.n, args.g, args.e, args.q, args.c)
    if args.backend == "host":
        return make_engine(*scores)
    from ..ops.kernels.graph_engine import TorchGraphEngine

    return TorchGraphEngine(*scores, device="cuda" if args.backend == "cuda" else "cpu")


def run(args, out):
    """Build the graph from `args.sequences` and write the results `args`
    asks for to the text stream `out`. Returns the engine (a
    `TorchGraphEngine` carries `device_alignments` and `fallbacks`)."""
    results = args.result if args.result else [0]
    records = read_fastx(args.sequences, shorten_names=True)
    engine = make_aligner(args)

    def align(codes):
        return engine.align(codes, graph, return_score=True) if graph.num_nodes() else ([], 0)

    graph = PoaGraph()
    is_reversed = []
    for rec in records:
        codes = encode(rec.data)
        aln, score = align(codes)
        use_codes, use_qual = codes, rec.quality
        if args.strand_ambiguous:
            rc = encode(rec.reverse_complement)
            aln_rev, score_rev = align(rc)
            if score >= score_rev:
                is_reversed.append(False)
            else:
                aln, use_codes, use_qual = aln_rev, rc, rec.reverse_quality
                is_reversed.append(True)
        weights = phred_weights(use_qual, len(use_codes))
        graph.add_alignment(aln, use_codes, weights)

    for r in results:
        if r == 0:
            consensus = decode(np.asarray(graph.generate_consensus(), np.uint8))
            out.write(f">Consensus LN:i:{len(consensus)}\n{consensus}\n")
        elif r in (1, 2):
            msa = graph.generate_msa(include_consensus=(r == 2))
            for i, row in enumerate(msa):
                name = records[i].name if i < len(records) else "Consensus"
                out.write(f">{name}\n{row}\n")
        elif r in (3, 4):
            graph.generate_consensus()
            out.write(
                graph.to_gfa(
                    [rec.name for rec in records],
                    is_reversed if args.strand_ambiguous else None,
                    include_consensus=(r == 4),
                )
            )

    if args.dot:
        with open(args.dot, "w") as fw:
            fw.write(graph.to_dot())
    return engine


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    engine = run(args, sys.stdout)
    if hasattr(engine, "device_alignments"):
        print(
            f"[vechat-spoa-torch] device_alignments={engine.device_alignments} "
            f"fallbacks={engine.fallbacks}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
