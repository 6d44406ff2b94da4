from .fastx import SeqRecord, read_fastx, write_fasta, write_fastx, sniff_format
from .paf import PafRecord, read_paf, write_paf

__all__ = [
    "SeqRecord",
    "read_fastx",
    "write_fasta",
    "write_fastx",
    "sniff_format",
    "PafRecord",
    "read_paf",
    "write_paf",
]
