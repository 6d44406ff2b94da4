"""PAF / MHAP overlap file reading and writing.

PAF columns (minimap2): qname qlen qstart qend strand tname tlen tstart tend
nmatch alnblocklen mapq [tags...]. Mirrors the reference's overlap record
construction (reference: src/overlap.cpp:29-42 for PAF, :15-27 for MHAP).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

from .fastx import _open_maybe_gz


@dataclass
class PafRecord:
    q_name: str
    q_length: int
    q_begin: int
    q_end: int
    strand: bool  # True when '-' (reverse-complement overlap)
    t_name: str
    t_length: int
    t_begin: int
    t_end: int
    num_matches: int
    alignment_length: int
    mapq: int
    cigar: str = ""

    @property
    def length(self) -> int:
        """max span (reference: src/overlap.cpp:24)."""
        return max(self.q_end - self.q_begin, self.t_end - self.t_begin)

    @property
    def error(self) -> float:
        """1 - min(span)/max(span) (reference: src/overlap.cpp:25-26)."""
        return 1.0 - min(self.q_end - self.q_begin, self.t_end - self.t_begin) / float(
            self.length
        )


def iter_paf(path: Union[str, os.PathLike], parse_cigar: bool = True) -> Iterator[PafRecord]:
    with _open_maybe_gz(path) as fr:
        for line in fr:
            line = line.rstrip("\n")
            if not line:
                continue
            f = line.split("\t")
            if len(f) < 12:
                raise ValueError(f"malformed PAF line: {line[:80]}")
            cigar = ""
            if parse_cigar:
                for tag in f[12:]:
                    if tag.startswith("cg:Z:"):
                        cigar = tag[5:]
                        break
            yield PafRecord(
                q_name=f[0],
                q_length=int(f[1]),
                q_begin=int(f[2]),
                q_end=int(f[3]),
                strand=f[4] == "-",
                t_name=f[5],
                t_length=int(f[6]),
                t_begin=int(f[7]),
                t_end=int(f[8]),
                num_matches=int(f[9]),
                alignment_length=int(f[10]),
                mapq=int(f[11]),
                cigar=cigar,
            )


def iter_mhap(path: Union[str, os.PathLike]) -> Iterator[PafRecord]:
    """MHAP overlaps: ids are 1-based (reference: src/overlap.cpp:15-27).
    Names are stored as the 0-based ids rendered as strings prefixed with '#'
    so callers can distinguish id-keyed records from name-keyed ones."""
    with _open_maybe_gz(path) as fr:
        for line in fr:
            line = line.strip()
            if not line:
                continue
            f = line.split()
            if len(f) < 12:
                raise ValueError(f"malformed MHAP line: {line[:80]}")
            a_id, b_id = int(f[0]) - 1, int(f[1]) - 1
            a_rc, a_begin, a_end, a_length = int(f[4]), int(f[5]), int(f[6]), int(f[7])
            b_rc, b_begin, b_end, b_length = int(f[8]), int(f[9]), int(f[10]), int(f[11])
            yield PafRecord(
                q_name=f"#{a_id}",
                q_length=a_length,
                q_begin=a_begin,
                q_end=a_end,
                strand=bool(a_rc ^ b_rc),
                t_name=f"#{b_id}",
                t_length=b_length,
                t_begin=b_begin,
                t_end=b_end,
                num_matches=0,
                alignment_length=max(a_end - a_begin, b_end - b_begin),
                mapq=255,
            )


def iter_sam(path: Union[str, os.PathLike]) -> Iterator[PafRecord]:
    """SAM alignments as overlap records (reference: src/overlap.cpp:44-108).
    Unmapped records (flag 0x4) are skipped; query begin/end/length come from
    the CIGAR (clips count toward length), and are flipped to forward-strand
    coordinates for reverse-strand alignments."""
    import re

    with _open_maybe_gz(path) as fr:
        for line in fr:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                raise ValueError(f"malformed SAM line: {line[:80]}")
            flag = int(f[1])
            if flag & 0x4:
                continue
            cigar = f[5]
            if len(cigar) < 2:
                raise ValueError("missing alignment from SAM record")
            q_begin = 0
            runs = re.findall(r"(\d+)([MIDNSHP=X])", cigar)
            for num, op in runs:
                if op in "SH":
                    q_begin = int(num)
                    break
                if op in "M=IDNPX":
                    break
            q_aln = q_clip = t_aln = 0
            for num, op in runs:
                num = int(num)
                if op in "M=X":
                    q_aln += num
                    t_aln += num
                elif op == "I":
                    q_aln += num
                elif op in "DN":
                    t_aln += num
                elif op in "SH":
                    q_clip += num
            q_end = q_begin + q_aln
            q_length = q_clip + q_aln
            strand = bool(flag & 0x10)
            if strand:
                q_begin, q_end = q_length - q_end, q_length - q_begin
            t_begin = int(f[3]) - 1
            yield PafRecord(
                q_name=f[0],
                q_length=q_length,
                q_begin=q_begin,
                q_end=q_end,
                strand=strand,
                t_name=f[2],
                t_length=0,  # filled from the target set (overlap.cpp:174)
                t_begin=t_begin,
                t_end=t_begin + t_aln,
                num_matches=min(q_aln, t_aln),
                alignment_length=max(q_aln, t_aln),
                mapq=int(f[4]),
                cigar=cigar,
            )


def read_paf(path: Union[str, os.PathLike], parse_cigar: bool = True) -> List[PafRecord]:
    p = os.fspath(path)
    if p.endswith((".mhap", ".mhap.gz")):
        return list(iter_mhap(path))
    if p.endswith((".sam", ".sam.gz")):
        return list(iter_sam(path))
    return list(iter_paf(path, parse_cigar))


def write_paf(records, path_or_file) -> None:
    own = isinstance(path_or_file, (str, os.PathLike))
    fw = _open_maybe_gz(path_or_file, "wt") if own else path_or_file
    try:
        for r in records:
            fields = [
                r.q_name,
                str(r.q_length),
                str(r.q_begin),
                str(r.q_end),
                "-" if r.strand else "+",
                r.t_name,
                str(r.t_length),
                str(r.t_begin),
                str(r.t_end),
                str(r.num_matches),
                str(r.alignment_length),
                str(r.mapq),
            ]
            if r.cigar:
                fields.append("cg:Z:" + r.cigar)
            fw.write("\t".join(fields) + "\n")
    finally:
        if own:
            fw.close()
