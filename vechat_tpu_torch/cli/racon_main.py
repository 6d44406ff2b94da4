"""`vechat-racon` — CLI compatible with the reference's vechat_racon binary
(reference: src/main.cpp:17-181). Reads sequences/overlaps/targets from
files, polishes, writes FASTA to stdout.
"""

from __future__ import annotations

import argparse
import sys

from ..io.fastx import read_fastx, write_fasta
from ..io.paf import read_paf
from ..pipeline.polisher import POLISHER_CONTIG, POLISHER_FRAGMENT, Polisher
from ..utils.logger import Logger


BACKENDS = ("cuda", "torch", "host", "full")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vechat-racon",
        description="GPU consensus / haplotype-aware error correction "
        "(capability-parity with the reference vechat_racon binary)",
    )
    p.add_argument("sequences", help="FASTA/FASTQ(.gz) sequences used for correction")
    p.add_argument("overlaps", help="PAF/MHAP(.gz) overlaps")
    p.add_argument("targets", help="FASTA/FASTQ(.gz) target sequences")
    p.add_argument("-u", "--include-unpolished", action="store_true")
    p.add_argument("-f", "--fragment-correction", action="store_true")
    p.add_argument("-p", "--haplotype", action="store_true")
    p.add_argument("-d", "--min-confidence", type=float, default=0.22)
    p.add_argument("-s", "--min-support", type=float, default=0.19)
    p.add_argument("-k", "--num-prune", type=int, default=3)
    p.add_argument("-w", "--window-length", type=int, default=500)
    p.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    p.add_argument("-e", "--error-threshold", type=float, default=0.3)
    p.add_argument("-T", "--no-trimming", action="store_true")
    p.add_argument("-m", "--match", type=int, default=3)
    p.add_argument("-x", "--mismatch", type=int, default=-5)
    p.add_argument("-g", "--gap", type=int, default=-4)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument(
        "--backend",
        choices=list(BACKENDS),
        default="cuda",
        help="alignment backend: CUDA kernels on the GPU (default; raises "
        "without one), their plain PyTorch versions on the CPU (torch), the "
        "host C++ engine (host), or the full-matrix DP on the GPU (full; the "
        "reference's --backend jax)",
    )
    return p


def make_backend(name: str, match: int, mismatch: int, gap: int, threads: int = 1,
                 device=None, devices=None):
    """The aligner backend `name`. `cuda` runs the kernels on `device`
    (default "cuda": every visible card, window batches sharded over them
    when there are several) or on the explicit list `devices`, and raises
    when no GPU is present; `torch` runs their plain PyTorch versions on the
    CPU; `host` runs the C++ engine; `full` runs the full-matrix DP (B10,
    the reference's `--backend jax`) on `device` (default "cuda", one card;
    "cpu" its plain versions) with the pairwise alignments on the host.
    There is no silent fallback from one to another."""
    if name == "host":
        from ..pipeline.windows import HostAlignerBackend

        return HostAlignerBackend(match, mismatch, gap, threads=threads)
    from ..ops.kernels.backend import TorchAlignerBackend

    if name == "cuda":
        return TorchAlignerBackend(
            match, mismatch, gap, device=device or "cuda", devices=devices
        )
    if name == "torch":
        return TorchAlignerBackend(match, mismatch, gap, device="cpu")
    if name == "full":
        from ..ops.kernels.poa_full import FullAlignerBackend

        if devices is not None:
            raise ValueError("the full backend runs on one device: give `device`")
        return FullAlignerBackend(match, mismatch, gap, device=device or "cuda")
    raise ValueError(f"unknown backend {name!r}; choose from {BACKENDS}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logger = Logger()
    logger.tick()

    targets = read_fastx(args.targets)
    queries = read_fastx(args.sequences)
    overlaps = read_paf(args.overlaps)
    logger.log("loaded input")

    polisher = Polisher(
        polisher_type=POLISHER_FRAGMENT if args.fragment_correction else POLISHER_CONTIG,
        haplotype=args.haplotype,
        min_confidence=args.min_confidence,
        min_support=args.min_support,
        num_prune=args.num_prune,
        window_length=args.window_length,
        quality_threshold=args.quality_threshold,
        error_threshold=args.error_threshold,
        trim=not args.no_trimming,
        match=args.match,
        mismatch=args.mismatch,
        gap=args.gap,
        backend=make_backend(args.backend, args.match, args.mismatch, args.gap, threads=args.threads),
        logger=logger,
        threads=args.threads,
    )
    polisher.initialize(targets, queries, overlaps)
    out = polisher.polish(drop_unpolished_sequences=not args.include_unpolished)
    write_fasta(out, sys.stdout)
    logger.total("total =")
    return 0


if __name__ == "__main__":
    sys.exit(main())
