"""`vechat` — the two-round correction pipeline CLI
(reference: scripts/vechat:206-397).

Round 1: overlap (native minimizer overlapper or external PAF) -> filter ->
haplotype-aware variation-graph correction.
Round 2: overlap corrected reads at base level -> keep >=1000 bp, >=0.99
identity -> linear racon consensus.

The alignments run on the CUDA kernels (`--backend cuda`, the default),
their plain PyTorch versions on the CPU (`--backend torch`) or the host C++
engine (`--backend host`).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..io.fastx import SeqRecord, read_fastx, write_fasta
from ..io.paf import read_paf, write_paf
from ..pipeline.overlapper import (
    OverlapParams,
    filter_fpa,
    filter_length_identity,
    find_overlaps,
    find_overlaps_auto,
    refine_identity,
    scrub_reads,
)
from ..pipeline.polisher import POLISHER_FRAGMENT, Polisher
from ..utils.logger import Logger
from .racon_main import BACKENDS, make_backend


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vechat",
        description="Haplotype-aware error correction for noisy long reads "
        "using variation graphs (PyTorch + CUDA)",
    )
    p.add_argument("sequences", help="FASTA/FASTQ(.gz) reads to correct")
    p.add_argument("-o", "--outfile", default="reads.corrected.fa")
    p.add_argument("--platform", default="pb", choices=["pb", "ont"])
    p.add_argument(
        "--sensitive", action="store_true",
        help="high-error-rate overlap presets (shorter k, denser "
        "minimizers) for >=15%%-error reads",
    )
    p.add_argument(
        "--no-auto-sensitive", action="store_true",
        help="disable automatic escalation to the sensitive presets when "
        "round-1 overlap health looks degraded (high divergence or thin "
        "per-read coverage)",
    )
    p.add_argument("--scrub", action="store_true", help="scrub chimeric reads")
    p.add_argument("-u", "--include-unpolished", action="store_true")
    p.add_argument("--linear", action="store_true", help="linear correction only")
    p.add_argument("-d", "--min-confidence", type=float, default=0.2)
    p.add_argument("-s", "--min-support", type=float, default=0.2)
    p.add_argument("--min-ovlplen-cns", type=int, default=1000)
    p.add_argument("--min-identity-cns", type=float, default=0.99)
    p.add_argument("-w", "--window-length", type=int, default=500)
    p.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    p.add_argument("-e", "--error-threshold", type=float, default=0.3)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-m", "--match", type=int, default=3)
    p.add_argument("-x", "--mismatch", type=int, default=-5)
    p.add_argument("-g", "--gap", type=int, default=-4)
    p.add_argument(
        "--base",
        action="store_true",
        help="round 1 uses base-level overlaps filtered by --min-identity "
        "(reference: scripts/vechat:246-248, minimap2 -cx + identity>=0.8)",
    )
    p.add_argument(
        "--min-identity",
        type=float,
        default=0.8,
        help="min overlap identity for --base round-1 overlaps "
        "(reference: scripts/vechat:41-45)",
    )
    p.add_argument(
        "--overlaps",
        default=None,
        help="use a precomputed PAF instead of the native overlapper (round 1)",
    )
    p.add_argument(
        "--backend",
        choices=list(BACKENDS),
        default="cuda",
        help="CUDA kernels on the GPU (default; raises without one), their "
        "plain PyTorch versions on the CPU (torch), or the host C++ engine",
    )
    p.add_argument("--keep-paf", default=None, help="write round-1 overlaps here")
    p.add_argument(
        "--consensus-only",
        action="store_true",
        help="run only the >=0.99-identity linear consensus round on the "
        "input (the scripts/vechat.iter2.py standalone driver)",
    )
    p.add_argument(
        "--min-corrected-length",
        type=int,
        default=0,
        help="drop corrected reads shorter than this "
        "(the scripts/filter_fa post-filter; HPC flow used 1000)",
    )
    return p


def _discover_overlaps(reads, args, iteration, logger, target_names=None):
    """Round-aware native overlap discovery. Round 1 auto-escalates to the
    sensitive presets when overlap health is degraded (find_overlaps_auto;
    VERDICT r4 item 8) unless --no-auto-sensitive or --sensitive was given;
    round 2 runs on corrected reads where the default presets are fine."""
    params = OverlapParams.for_platform(
        args.platform, sensitive=getattr(args, "sensitive", False)
    )
    if iteration == 1 and not getattr(args, "no_auto_sensitive", False):
        overlaps, _ = find_overlaps_auto(
            reads, params, target_names=target_names, log=logger.log
        )
        return overlaps
    return find_overlaps(reads, params, target_names=target_names)


def _correction_sane(
    targets: List[SeqRecord],
    corrected: List[SeqRecord],
    logger: Logger,
    sample: int = 8,
    max_norm_dist: float = 0.4,
) -> bool:
    """Cheap output-corruption detector (VERDICT r4 item 10). A corrected
    read is the error-corrected, coverage-trimmed version of its raw self,
    so its infix edit distance to the raw read stays within the raw error
    envelope (error_threshold caps overlaps at 30% divergence,
    src/main.cpp:48), while unrelated/garbage content sits at the random-
    sequence null of ~0.49 normalized — 0.4 splits the two regimes. The r4 worker-instability event produced output so
    corrupted that the round-2 overlapper found 0 of ~362 overlaps — reads
    that would fail this check by a wide margin. Samples evenly spaced
    corrected reads; corrupt = majority insane."""
    if not corrected:
        return True
    from ..ops.encode import encode
    from ..ops.pairwise import edit_distance_infix

    raw_by_name = {t.name: t for t in targets}
    idx = range(0, len(corrected), max(1, len(corrected) // sample))
    checked = insane = 0
    for i in list(idx)[:sample]:
        c = corrected[i]
        base = c.name.split()[0]
        raw = raw_by_name.get(base[:-1] if base.endswith("r") else base)
        if raw is None or len(c.data) == 0:
            continue
        checked += 1
        d = edit_distance_infix(encode(c.data), encode(raw.data))
        if d / max(1, len(c.data)) > max_norm_dist:
            insane += 1
    if checked and insane * 2 > checked:
        logger.log(
            f"correction sanity check FAILED: {insane}/{checked} sampled "
            f"reads do not resemble their raw selves"
        )
        return False
    return True


def _polish(
    targets: List[SeqRecord],
    queries: List[SeqRecord],
    overlaps,
    linear: bool,
    args,
    logger: Logger,
    backend,
) -> List[SeqRecord]:
    """Build the polisher, polish once, and log the output sanity check."""
    polisher = Polisher(
        polisher_type=POLISHER_FRAGMENT,
        haplotype=not linear,
        min_confidence=args.min_confidence,
        min_support=args.min_support,
        num_prune=3,
        window_length=args.window_length,
        quality_threshold=args.quality_threshold,
        error_threshold=args.error_threshold,
        trim=True,
        match=args.match,
        mismatch=args.mismatch,
        gap=args.gap,
        backend=backend,
        logger=logger,
        threads=args.threads,
    )
    polisher.initialize(targets, queries, overlaps)
    corrected = polisher.polish(
        drop_unpolished_sequences=not args.include_unpolished
    )
    _correction_sane(targets, corrected, logger)
    return corrected


def run_round(
    reads: List[SeqRecord],
    iteration: int,
    args,
    logger: Logger,
    backend,
    overlaps_path: Optional[str] = None,
) -> List[SeqRecord]:
    """One correction round (reference: scripts/vechat:17-97)."""
    linear = args.linear or iteration == 2

    if overlaps_path:
        overlaps = read_paf(overlaps_path)
    else:
        overlaps = _discover_overlaps(reads, args, iteration, logger)
        if iteration == 1:
            # minimap2 | awk '$11>=500' | fpa drop (scripts/vechat:37-39)
            overlaps = filter_length_identity(overlaps, min_block=500)
            overlaps = filter_fpa(overlaps)
            if args.base:
                # base-level round 1: minimap2 -cx + identity >= min_identity
                # (scripts/vechat:41-45,246-248)
                overlaps = refine_identity(overlaps, reads, backend)
                overlaps = filter_length_identity(
                    overlaps, min_block=500, min_identity=args.min_identity
                )
        else:
            # >=1000bp, >=0.99 identity consensus round (scripts/vechat:47-49):
            # base-level identity like minimap2 -c, via exact re-alignment
            overlaps = filter_length_identity(
                overlaps, min_block=args.min_ovlplen_cns
            )
            overlaps = filter_fpa(overlaps)
            overlaps = refine_identity(overlaps, reads, backend)
            overlaps = filter_length_identity(
                overlaps,
                min_block=args.min_ovlplen_cns,
                min_identity=args.min_identity_cns,
            )
        if args.keep_paf and iteration == 1:
            write_paf(overlaps, args.keep_paf)
    logger.log(f"round {iteration}: {len(overlaps)} overlaps")

    return _polish(reads, reads, overlaps, linear, args, logger, backend)


def run(args, logger: Logger):
    """The whole correction run on parsed `args`: returns the corrected
    reads and the aligner backend, whose counters cover both rounds."""
    backend = make_backend(
        args.backend, args.match, args.mismatch, args.gap, threads=args.threads
    )
    reads = read_fastx(args.sequences)
    logger.log(f"loaded {len(reads)} reads")

    if args.scrub:
        params = OverlapParams.for_platform(args.platform, sensitive=args.sensitive)
        min_cov = 3 if args.platform == "pb" else 4
        scrub_overlaps = find_overlaps(reads, params)
        reads = scrub_reads(reads, scrub_overlaps, min_coverage=min_cov)
        logger.log(f"scrubbed to {len(reads)} reads")

    if args.consensus_only:
        # standalone consensus round (reference: scripts/vechat.iter2.py)
        rounds = [2]
    elif args.linear:
        rounds = [1]
    else:
        rounds = [1, 2]

    for idx, i in enumerate(rounds, start=1):
        overlaps_path = args.overlaps if idx == 1 else None
        reads = run_round(reads, i, args, logger, backend, overlaps_path)
        # the reference round-trips through FASTA files between rounds, which
        # truncates names at the first whitespace (bioparser Shorten); mirror
        # that so round-2 headers match (e.g. "read0r" + new tags)
        if idx < len(rounds):
            reads = [
                SeqRecord(r.name.split()[0], r.data, r.quality) for r in reads
            ]
        logger.log(f"round {i} complete: {len(reads)} corrected reads")

    if args.min_corrected_length > 0:
        reads = [r for r in reads if len(r.data) >= args.min_corrected_length]
    return reads, backend


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logger = Logger()
    logger.tick()
    reads, _ = run(args, logger)
    write_fasta(reads, args.outfile)
    logger.total("total =")
    return 0


if __name__ == "__main__":
    sys.exit(main())
