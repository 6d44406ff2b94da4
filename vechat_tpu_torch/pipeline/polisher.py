"""Polisher: orchestrates load -> overlap alignment -> windowing -> consensus.

Reimplements the semantics of racon::Polisher (reference: src/polisher.cpp)
with the batch-first window drivers from .windows. Citations inline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastx import SeqRecord
from ..io.paf import PafRecord
from ..ops.encode import decode, encode
from ..ops.pairwise import edit_align
from ..utils.logger import Logger
from .windows import (
    HostAlignerBackend,
    WINDOW_TYPE_NGS,
    WINDOW_TYPE_TGS,
    Window,
    generate_consensus_haplotype,
    generate_consensus_linear,
)

POLISHER_CONTIG = "c"  # PolisherType::kC
POLISHER_FRAGMENT = "f"  # PolisherType::kF


@dataclass
class TransmutedOverlap:
    q_id: int
    t_id: int
    q_begin: int
    q_end: int
    q_length: int
    t_begin: int
    t_end: int
    t_length: int
    strand: bool
    length: int
    error: float
    cigar: str
    breaking_points: Optional[List[Tuple[int, int]]] = None


def find_breaking_points_from_cigar(
    cigar: str,
    window_length: int,
    t_begin: int,
    t_end: int,
    q_begin: int,
    q_end: int,
    q_length: int,
    strand: bool,
) -> List[Tuple[int, int]]:
    """Cut an overlap's alignment into per-window (first_match, last_match)
    pairs in target coordinates (reference: src/overlap.cpp:226-292).

    The reference walks the CIGAR base by base emitting a pair whenever the
    target pointer crosses a window boundary; because alignments are monotone
    this is equivalent to grouping match positions by target window index,
    which is what we vectorise here.
    """
    import re

    runs = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)]
    t_match: List[np.ndarray] = []
    q_match: List[np.ndarray] = []
    q_ptr = (q_length - q_end if strand else q_begin) - 1
    t_ptr = t_begin - 1
    for num, op in runs:
        if op in "M=X":
            t_match.append(np.arange(t_ptr + 1, t_ptr + 1 + num, dtype=np.int64))
            q_match.append(np.arange(q_ptr + 1, q_ptr + 1 + num, dtype=np.int64))
            t_ptr += num
            q_ptr += num
        elif op == "I":
            q_ptr += num
        elif op in "DN":
            t_ptr += num
        # S/H/P consume nothing here (q_begin already accounts for clips)

    if not t_match:
        return []
    t = np.concatenate(t_match)
    q = np.concatenate(q_match)
    win = t // window_length
    pairs: List[Tuple[int, int]] = []
    # first/last match per window group, groups in ascending target order
    change = np.flatnonzero(np.diff(win)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(t)]])
    for s, e in zip(starts, ends):
        pairs.append((int(t[s]), int(q[s])))
        pairs.append((int(t[e - 1]) + 1, int(q[e - 1]) + 1))
    return pairs


class Polisher:
    """reference: src/polisher.cpp:170-562."""

    def __init__(
        self,
        polisher_type: str = POLISHER_FRAGMENT,
        haplotype: bool = False,
        min_confidence: float = 0.22,
        min_support: float = 0.19,
        num_prune: int = 3,
        window_length: int = 500,
        quality_threshold: float = 10.0,
        error_threshold: float = 0.3,
        trim: bool = True,
        match: int = 3,
        mismatch: int = -5,
        gap: int = -4,
        backend=None,
        logger: Optional[Logger] = None,
        threads: int = 1,
    ):
        assert polisher_type in (POLISHER_CONTIG, POLISHER_FRAGMENT)
        self.threads = max(1, threads)
        self.type = polisher_type
        self.haplotype = haplotype
        self.min_confidence = min_confidence
        self.min_support = min_support
        self.num_prune = num_prune
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.trim = trim
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.backend = backend or HostAlignerBackend(match, mismatch, gap)
        self.logger = logger or Logger()

        self.sequences: List[SeqRecord] = []
        self.targets_size = 0
        self.windows: List[Window] = []
        self.targets_coverages: List[int] = []

    # ------------------------------------------------------------ initialize

    def initialize(
        self,
        targets: Sequence[SeqRecord],
        queries: Sequence[SeqRecord],
        overlaps: Sequence[PafRecord],
    ) -> None:
        log = self.logger
        log.tick()
        if len(targets) == 0:
            raise ValueError("empty target sequences set")
        self.sequences = list(targets)
        self.targets_size = len(targets)

        name_to_id: Dict[str, int] = {}
        for i, t in enumerate(targets):
            name_to_id[t.name + "t"] = i

        # query dedup against targets by name (src/polisher.cpp:233-272)
        total_q_len = 0
        n_q = 0
        for q in queries:
            total_q_len += len(q.data)
            n_q += 1
            ti = name_to_id.get(q.name + "t")
            if ti is not None:
                # reference compares lengths only (src/polisher.cpp:251-252)
                if len(q.data) != len(targets[ti].data) or len(
                    q.quality or ""
                ) != len(targets[ti].quality or ""):
                    raise ValueError(
                        f"duplicate sequence {q.name} with unequal data"
                    )
                name_to_id[q.name + "q"] = ti
            else:
                name_to_id[q.name + "q"] = len(self.sequences)
                self.sequences.append(q)
        if n_q == 0:
            raise ValueError("empty sequences set")
        log.log("loaded sequences")
        log.tick()

        window_type = (
            WINDOW_TYPE_NGS if total_q_len / n_q <= 1000 else WINDOW_TYPE_TGS
        )

        # transmute + filter overlaps (src/polisher.cpp:290-352)
        transmuted: List[TransmutedOverlap] = []
        for ov in overlaps:
            qi = name_to_id.get(ov.q_name + "q")
            ti = name_to_id.get(ov.t_name + "t")
            if qi is None or ti is None:
                continue
            if ov.q_length != len(self.sequences[qi].data):
                raise ValueError(
                    f"unequal lengths in sequence and overlap file for {ov.q_name}"
                )
            if ov.t_length != 0 and ov.t_length != len(self.sequences[ti].data):
                raise ValueError(
                    f"unequal lengths in target and overlap file for {ov.t_name}"
                )
            transmuted.append(
                TransmutedOverlap(
                    q_id=qi,
                    t_id=ti,
                    q_begin=ov.q_begin,
                    q_end=ov.q_end,
                    q_length=ov.q_length,
                    t_begin=ov.t_begin,
                    t_end=ov.t_end,
                    t_length=len(self.sequences[ti].data),
                    strand=ov.strand,
                    length=ov.length,
                    error=ov.error,
                    cigar=ov.cigar,
                )
            )

        transmuted = self._remove_invalid_overlaps(transmuted)
        if not transmuted:
            raise ValueError("empty overlap set")
        log.log("loaded overlaps")
        log.tick()

        self._find_breaking_points(transmuted)
        log.log("aligned overlaps")
        log.tick()

        # build windows (src/polisher.cpp:389-404)
        L = self.window_length
        self.windows = []
        id_to_first_window = [0] * (self.targets_size + 1)
        for i in range(self.targets_size):
            tgt = self.sequences[i]
            data = tgt.data
            k = 0
            for j in range(0, len(data), L):
                length = min(j + L, len(data)) - j
                self.windows.append(
                    Window(
                        target_id=i,
                        rank=k,
                        window_type=window_type,
                        backbone_codes=encode(data[j : j + length]),
                        backbone_quality=(
                            None
                            if tgt.quality is None
                            else tgt.quality[j : j + length]
                        ),
                        if_fasta=self._sniff_if_fasta(tgt, j, length),
                    )
                )
                k += 1
            id_to_first_window[i + 1] = id_to_first_window[i] + k

        self.targets_coverages = [0] * self.targets_size

        # route layers (src/polisher.cpp:408-462)
        for ov in transmuted:
            self.targets_coverages[ov.t_id] += 1
            seq = self.sequences[ov.q_id]
            bps = ov.breaking_points or []
            for j in range(0, len(bps), 2):
                first_t, first_q = bps[j]
                last_t, last_q = bps[j + 1]
                if last_q - first_q < 0.02 * L:
                    continue
                if seq.quality is not None:
                    qual = seq.reverse_quality if ov.strand else seq.quality
                    span = qual[first_q:last_q]
                    avg = (
                        sum(span.encode()) / len(span) - 33 if span else 0.0
                    )
                    if avg < self.quality_threshold:
                        continue
                window_id = id_to_first_window[ov.t_id] + first_t // L
                window_start = (first_t // L) * L
                data = seq.reverse_complement if ov.strand else seq.data
                layer_codes = encode(data[first_q:last_q])
                layer_quality = (
                    None
                    if seq.quality is None
                    else (seq.reverse_quality if ov.strand else seq.quality)[
                        first_q:last_q
                    ]
                )
                self.windows[window_id].add_layer(
                    layer_codes,
                    layer_quality,
                    first_t - window_start,
                    last_t - window_start - 1,
                )
        log.log("transformed data into windows")

    def _sniff_if_fasta(self, target: SeqRecord, j: int, length: int) -> bool:
        """Replicates the C-string comparison quirk at src/window.cpp:223:
        the backbone quality pointer compared against std::string(len, '!').

        * FASTA target (dummy '!' buffer of window_length chars): equal iff
          this window is full-length.
        * FASTQ target: equal iff quality[j:] is exactly `length` '!'s, i.e.
          the window is the read's last and its quality is all-'!'.
        """
        if target.quality is None:
            return length == self.window_length
        tail = target.quality[j:]
        return len(tail) == length and set(tail) <= {"!"}

    def _remove_invalid_overlaps(
        self, overlaps: List[TransmutedOverlap]
    ) -> List[TransmutedOverlap]:
        """Error/self filters for all types; best-overlap-per-query for contig
        polishing, grouping consecutive runs of equal q_id
        (reference: src/polisher.cpp:292-316)."""
        kept: List[Optional[TransmutedOverlap]] = []
        for ov in overlaps:
            if ov.error > self.error_threshold or ov.q_id == ov.t_id:
                continue
            kept.append(ov)
        if self.type == POLISHER_CONTIG:
            out: List[TransmutedOverlap] = []
            i = 0
            while i < len(kept):
                j = i
                while j < len(kept) and kept[j].q_id == kept[i].q_id:
                    j += 1
                group = kept[i:j]
                best = 0
                for g in range(1, len(group)):
                    if group[g].length > group[best].length:
                        best = g
                out.append(group[best])
                i = j
            return out
        return kept

    def _find_breaking_points(self, overlaps: List[TransmutedOverlap]) -> None:
        """Align overlaps lacking a CIGAR, then cut into window breakpoints
        (reference: src/overlap.cpp:179-203)."""
        # batch the pairwise alignments (device backend hook)
        need = [ov for ov in overlaps if not ov.cigar]
        pairs = []
        for ov in need:
            seq = self.sequences[ov.q_id]
            if ov.strand:
                q = seq.reverse_complement[
                    ov.q_length - ov.q_end : ov.q_length - ov.q_begin
                ]
            else:
                q = seq.data[ov.q_begin : ov.q_end]
            t = self.sequences[ov.t_id].data[ov.t_begin : ov.t_end]
            pairs.append((encode(q), encode(t)))

        # 20-bin progress over the hot alignment loop, ticked per processed
        # chunk (reference: src/polisher.cpp:477-488 ticks per future)
        from ..utils.logger import PhaseBar

        bar = PhaseBar(
            self.logger,
            "[vechat_tpu::Polisher::initialize] aligning overlaps",
            len(pairs),
        )
        import time as _time

        t_align0 = _time.perf_counter()
        cigars: List[str] = []
        chunk = max(1, (len(pairs) + 19) // 20)
        for off in range(0, len(pairs), chunk):
            cigars.extend(self._align_pairs_batch(pairs[off : off + chunk]))
            bar.step(min(chunk, len(pairs) - off))
        if pairs:
            bar.finish()
        t_align = _time.perf_counter() - t_align0
        for ov, cigar in zip(need, cigars):
            ov.cigar = cigar
        pw = getattr(self.backend, "_pairwise", None)
        if pw is not None and getattr(pw, "n_dispatches", 0):
            print(
                f"[vechat_tpu::align] pairwise stages: tile {pw.t_tile:.1f}s"
                f" | device {pw.t_device:.1f}s ({pw.n_dispatches} dispatches,"
                f" {pw.device_tiles} tiles) | host {pw.t_host:.1f}s "
                f"({pw.host_fallbacks} fb) | asm {pw.t_asm:.1f}s",
                file=self.logger.stream,
            )

        from .windows import _pmap

        t_bp0 = _time.perf_counter()

        def bp_one(ov):
            ov.breaking_points = find_breaking_points_from_cigar(
                ov.cigar,
                self.window_length,
                ov.t_begin,
                ov.t_end,
                ov.q_begin,
                ov.q_end,
                ov.q_length,
                ov.strand,
            )
            ov.cigar = ""

        _pmap(bp_one, overlaps, self.threads)
        if pairs and pw is None:
            # host-path stage split (device prints its own line above)
            print(
                f"[vechat_tpu::align] pairwise stages: align {t_align:.1f}s "
                f"({len(pairs)} overlaps) | breakpoints "
                f"{_time.perf_counter() - t_bp0:.1f}s",
                file=self.logger.stream,
            )

    def _align_pairs_batch(self, pairs) -> List[str]:
        if hasattr(self.backend, "edit_align_batch"):
            return self.backend.edit_align_batch(pairs)
        # host path: the native pairwise DP releases the GIL, so -t threads
        # give real parallelism (reference: src/polisher.cpp:469-483 threads
        # the same loop)
        from .windows import _pmap

        return _pmap(lambda p: edit_align(*p), pairs, self.threads)

    # ----------------------------------------------------------------- polish

    def polish(self, drop_unpolished_sequences: bool = True) -> List[SeqRecord]:
        """reference: src/polisher.cpp:491-562."""
        log = self.logger
        log.tick()
        from ..utils.logger import PhaseBar

        max_layers = max((len(w.layers) for w in self.windows), default=0)
        bar = PhaseBar(
            log,
            "[vechat_tpu::Polisher::polish] generating consensus",
            # units: build layer steps + prune rounds + final emit
            max_layers + (self.num_prune + 1 if self.haplotype else 1),
        )
        if self.haplotype:
            generate_consensus_haplotype(
                self.windows,
                self.backend,
                self.min_confidence,
                self.min_support,
                self.num_prune,
                threads=self.threads,
                progress=bar.step,
            )
        else:
            generate_consensus_linear(
                self.windows,
                self.backend,
                self.trim,
                threads=self.threads,
                progress=bar.step,
            )
        bar.finish()

        dst: List[SeqRecord] = []
        polished_data: List[str] = []
        num_polished_windows = 0
        for i, w in enumerate(self.windows):
            num_polished_windows += 1 if w.polished else 0
            polished_data.append(decode(w.consensus_codes))
            is_last = i == len(self.windows) - 1 or self.windows[i + 1].rank == 0
            if is_last:
                polished_ratio = num_polished_windows / float(w.rank + 1)
                if not drop_unpolished_sequences or polished_ratio > 0:
                    data = "".join(polished_data)
                    tags = "r" if self.type == POLISHER_FRAGMENT else ""
                    tags += f" LN:i:{len(data)}"
                    tags += f" RC:i:{self.targets_coverages[w.target_id]}"
                    tags += f" XC:f:{polished_ratio:.6f}"
                    name = self.sequences[w.target_id].name + tags
                    dst.append(SeqRecord(name=name, data=data))
                num_polished_windows = 0
                polished_data = []
        log.log("generated consensus")
        # throughput counters (the reference has none; SURVEY §5 obs gap)
        elapsed = max(log.time_, 1e-9)
        log.count("windows", len(self.windows))
        log.count("corrected_reads", len(dst))
        be = self.backend
        if hasattr(be, "cell_updates") and be.cell_updates:
            log.count("device_alignments", getattr(be, "device_alignments", 0))
            log.count("dp_cells", be.cell_updates)
            print(
                f"[vechat_tpu::polish] {len(self.windows)} windows, "
                f"{len(dst)} reads, {be.cell_updates / 1e9:.3f} Gcells "
                f"({be.cell_updates / elapsed / 1e9:.3g} GCUPS aggregate)",
                file=log.stream,
            )
            if getattr(be, "n_dispatches", 0):
                print(
                    f"[vechat_tpu::polish] backend stages: "
                    f"pack {be.t_pack:.1f}s | device {be.t_device:.1f}s "
                    f"({be.n_dispatches} dispatches) | decode "
                    f"{be.t_decode:.1f}s | host-fb {be.t_host_fb:.1f}s "
                    f"({be.n_calls} calls)",
                    file=log.stream,
                )
        if hasattr(be, "counters"):
            print(
                "[vechat_tpu::polish] counters: "
                + " ".join(f"{k}={v}" for k, v in be.counters().items()),
                file=log.stream,
            )
        return dst
