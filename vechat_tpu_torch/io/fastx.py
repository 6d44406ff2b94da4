"""FASTA/FASTQ(.gz) reading and writing.

Mirrors the reference semantics of bioparser + racon::Sequence
(reference: vendor/spoa/vendor/bioparser/include/bioparser/parser.hpp:106-120,
src/sequence.cpp:19-42):

* record names are truncated at the first whitespace,
* sequence data is uppercased,
* a FASTQ quality string whose Phred(+33) values are all zero (all ``'!'``)
  is treated as absent (the record behaves like a FASTA record).
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Union


@dataclass
class SeqRecord:
    """One sequence record. ``data`` is uppercase; ``quality`` is None when the
    record carries no informative quality (reference: src/sequence.cpp:34-42)."""

    name: str
    data: str
    quality: Optional[str] = None
    _reverse_complement: Optional[str] = field(default=None, repr=False)
    _reverse_quality: Optional[str] = field(default=None, repr=False)

    _RC = str.maketrans("ATCG", "TAGC")

    @property
    def reverse_complement(self) -> str:
        """Lazy reverse complement; non-ACGT characters are reversed unchanged
        (reference: src/sequence.cpp:49-77)."""
        if self._reverse_complement is None:
            self._reverse_complement = self.data.translate(self._RC)[::-1]
        return self._reverse_complement

    @property
    def reverse_quality(self) -> Optional[str]:
        if self.quality is None:
            return None
        if self._reverse_quality is None:
            self._reverse_quality = self.quality[::-1]
        return self._reverse_quality

    def __len__(self) -> int:
        return len(self.data)


def _open_maybe_gz(path: Union[str, os.PathLike], mode: str = "rt"):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def sniff_format(path: Union[str, os.PathLike]) -> str:
    """Return 'fa' or 'fq' from the first byte (reference: scripts/vechat:171-185)."""
    with _open_maybe_gz(path) as fr:
        first = fr.read(1)
    if first == ">":
        return "fa"
    if first == "@":
        return "fq"
    raise ValueError(f"invalid input file, must be FASTA/FASTQ format: {path}")


FASTA_SUFFIXES = (".fasta", ".fasta.gz", ".fna", ".fna.gz", ".fa", ".fa.gz")
FASTQ_SUFFIXES = (".fastq", ".fastq.gz", ".fq", ".fq.gz")


def format_from_suffix(path: Union[str, os.PathLike]) -> str:
    """'fa' / 'fq' by extension (reference: src/polisher.cpp:88-104)."""
    p = os.fspath(path)
    if p.endswith(FASTA_SUFFIXES):
        return "fa"
    if p.endswith(FASTQ_SUFFIXES):
        return "fq"
    raise ValueError(f"unsupported format extension: {p}")


def _shorten(name: str) -> str:
    """Truncate at first whitespace (reference: parser.hpp:113-120)."""
    return name.split()[0] if name.split() else ""


def iter_fastx(
    path: Union[str, os.PathLike],
    shorten_names: bool = True,
) -> Iterator[SeqRecord]:
    """Stream records from a FASTA or FASTQ file (gzip-transparent).

    Format is sniffed from the first character, so mislabelled extensions still
    parse. Multi-line FASTA and multi-line FASTQ are supported.
    """
    with _open_maybe_gz(path) as fr:
        first = fr.read(1)
        if first == "":
            return
        if first == ">":
            yield from _iter_fasta(fr, shorten_names)
        elif first == "@":
            yield from _iter_fastq(fr, shorten_names)
        else:
            raise ValueError(f"invalid FASTA/FASTQ file: {path}")


def _make_name(header: str, shorten_names: bool) -> str:
    return _shorten(header) if shorten_names else header.rstrip()


def _finish(name: str, data_parts: List[str], quality_parts: Optional[List[str]]) -> SeqRecord:
    data = "".join(data_parts).upper()
    if not name or not data:
        raise ValueError("invalid FASTA/FASTQ record (empty name or data)")
    quality: Optional[str] = None
    if quality_parts is not None:
        q = "".join(quality_parts)
        if len(q) != len(data):
            raise ValueError(f"quality/data length mismatch for record {name}")
        # all-'!' quality is treated as absent (reference: src/sequence.cpp:34-42)
        if any(c != "!" for c in q):
            quality = q
    return SeqRecord(name=name, data=data, quality=quality)


def _iter_fasta(fr: io.TextIOBase, shorten_names: bool) -> Iterator[SeqRecord]:
    # caller consumed the leading '>'
    name = None
    data_parts: List[str] = []
    for line in fr:
        line = line.rstrip("\r\n")
        if name is None:
            name = _make_name(line, shorten_names)
            continue
        if line.startswith(">"):
            yield _finish(name, data_parts, None)
            name = _make_name(line[1:], shorten_names)
            data_parts = []
        else:
            data_parts.append(line.strip())
    if name is not None:
        yield _finish(name, data_parts, None)


def _iter_fastq(fr: io.TextIOBase, shorten_names: bool) -> Iterator[SeqRecord]:
    # caller consumed the leading '@'
    while True:
        header = fr.readline()
        if header == "":
            return
        name = _make_name(header.rstrip("\r\n"), shorten_names)
        data_parts: List[str] = []
        line = fr.readline()
        while line and not line.startswith("+"):
            data_parts.append(line.strip())
            line = fr.readline()
        if not line:
            raise ValueError(f"truncated FASTQ record {name}")
        data_len = sum(len(p) for p in data_parts)
        quality_parts: List[str] = []
        q_len = 0
        while q_len < data_len:
            line = fr.readline()
            if not line:
                raise ValueError(f"truncated FASTQ quality for record {name}")
            part = line.strip()
            quality_parts.append(part)
            q_len += len(part)
        yield _finish(name, data_parts, quality_parts)
        # consume the '@' of the next record (or EOF)
        nxt = fr.read(1)
        if nxt == "":
            return
        if nxt != "@":
            raise ValueError(f"malformed FASTQ after record {name}")


def fastx_names(
    path: Union[str, os.PathLike], shorten_names: bool = True
) -> List[str]:
    """Record names in file order, streaming (nothing else retained)."""
    return [r.name for r in iter_fastx(path, shorten_names)]


def subset_fastx(
    path: Union[str, os.PathLike],
    names,
    shorten_names: bool = True,
) -> List[SeqRecord]:
    """Load only the named records, streaming the file once; peak memory is
    the subset, not the pool (the extract_sub_sequences role of the
    reference's chunked flow, scripts/vechat:99-169, which likewise
    re-scans the full inputs per chunk)."""
    want = set(names)
    return [r for r in iter_fastx(path, shorten_names) if r.name in want]


def read_fastx(
    path: Union[str, os.PathLike],
    shorten_names: bool = True,
    prefer_native: bool = True,
) -> List[SeqRecord]:
    if prefer_native:
        from .native import read_fastx_native

        out = read_fastx_native(path, shorten_names)
        if out is not None:
            return out
    return list(iter_fastx(path, shorten_names))


def write_fasta(records, path_or_file, line_width: int = 0) -> None:
    """Write FASTA. ``line_width=0`` writes each sequence on a single line,
    matching the reference's output (src/main.cpp:176-178)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    fw = _open_maybe_gz(path_or_file, "wt") if own else path_or_file
    try:
        for rec in records:
            fw.write(f">{rec.name}\n")
            if line_width and line_width > 0:
                for i in range(0, len(rec.data), line_width):
                    fw.write(rec.data[i : i + line_width] + "\n")
            else:
                fw.write(rec.data + "\n")
    finally:
        if own:
            fw.close()


def write_fastx(records, path_or_file, fmt: str = "fa") -> None:
    """Write FASTA ('fa') or FASTQ ('fq'). Records without quality are written
    with dummy '!' quality in FASTQ mode."""
    if fmt == "fa":
        write_fasta(records, path_or_file)
        return
    own = isinstance(path_or_file, (str, os.PathLike))
    fw = _open_maybe_gz(path_or_file, "wt") if own else path_or_file
    try:
        for rec in records:
            q = rec.quality if rec.quality is not None else "!" * len(rec.data)
            fw.write(f"@{rec.name}\n{rec.data}\n+\n{q}\n")
    finally:
        if own:
            fw.close()
