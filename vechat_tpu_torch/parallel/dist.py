"""Multi-process distribution: shard targets across processes, merge in order.

Counterpart of `vechat_tpu/parallel/dist.py`, on `torch.distributed`.
Replaces the reference's SGE job scripts (scripts/vechat_hpc.fast.sh:28-60:
`split -l` chunks + one qsub per chunk + `cat` merge):

* every process loads the full query set, takes a contiguous block of TARGET
  reads (the unit of correction),
* within a process, window batches run on the process's card (a group of N
  gives process r card `LOCAL_RANK % device_count`; a single process shards
  its batches over every card through `.mesh`),
* corrected records are merged deterministically by target order, either
  through per-process shard files + rank-0 concatenation (the file-shaped
  analog of the reference's `cat`) or via an all-gather of encoded records.

The process group is named by the variables `torchrun` sets: `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, and for the all-gather `MASTER_ADDR` and
`MASTER_PORT`. The records are host strings, so the group's backend is gloo.
"""

from __future__ import annotations

import datetime
import glob
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.fastx import SeqRecord, write_fasta


@dataclass
class ProcessGroup:
    process_id: int
    num_processes: int
    local_rank: int = 0

    @classmethod
    def from_env(cls) -> "ProcessGroup":
        """torchrun-style env (RANK / WORLD_SIZE / LOCAL_RANK), or
        single-process defaults."""
        pid = int(os.environ.get("RANK", "0"))
        n = int(os.environ.get("WORLD_SIZE", "1"))
        if n < 1 or not (0 <= pid < n):
            raise ValueError(f"invalid process group: RANK={pid} WORLD_SIZE={n}")
        return cls(pid, n, int(os.environ.get("LOCAL_RANK", str(pid))))

    def initialize_torch(self, timeout: float = 3600.0) -> None:
        """Join the gloo group at tcp://MASTER_ADDR:MASTER_PORT. A collective
        whose peer never arrives fails after `timeout` seconds."""
        if self.num_processes <= 1:
            return
        import torch.distributed as dist

        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError(
                "VECHAT_DIST_INIT=1 needs MASTER_ADDR and MASTER_PORT to name "
                "the process group's rendezvous"
            )
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{addr}:{port}",
            world_size=self.num_processes,
            rank=self.process_id,
            timeout=datetime.timedelta(seconds=timeout),
        )

    def device(self) -> str:
        """The CUDA device of this process: every card for a single process
        ("cuda"), card LOCAL_RANK modulo the visible cards in a group."""
        if self.num_processes <= 1 or not torch.cuda.is_available():
            return "cuda"
        return f"cuda:{self.local_rank % torch.cuda.device_count()}"


def shard_bounds(n_items: int, group: ProcessGroup) -> Tuple[int, int]:
    """Contiguous block [begin, end) of items owned by this process.
    Deterministic and load-balanced to within one item."""
    per, rem = divmod(n_items, group.num_processes)
    begin = group.process_id * per + min(group.process_id, rem)
    end = begin + per + (1 if group.process_id < rem else 0)
    return begin, end


def shard_targets(
    targets: Sequence[SeqRecord], group: ProcessGroup
) -> List[SeqRecord]:
    b, e = shard_bounds(len(targets), group)
    return list(targets[b:e])


def shard_output_path(outfile: str, group: ProcessGroup) -> str:
    if group.num_processes == 1:
        return outfile
    return f"{outfile}.shard{group.process_id:05d}"


def merge_shard_files(outfile: str, group: ProcessGroup) -> None:
    """Rank 0 concatenates shard files in rank order (the `cat` merge of
    scripts/vechat_hpc.fast.sh:110-117, but deterministic by construction)."""
    if group.num_processes == 1 or group.process_id != 0:
        return
    with open(outfile, "w") as fw:
        for pid in range(group.num_processes):
            shard = f"{outfile}.shard{pid:05d}"
            with open(shard) as fr:
                fw.write(fr.read())
            os.remove(shard)


def allgather_records(
    records: Sequence[SeqRecord], group: ProcessGroup
) -> List[SeqRecord]:
    """All-gather corrected records across processes (ragged strings ->
    padded uint8 + length vector, reordered by process rank). Used by
    in-memory pipelines instead of shard files."""
    if group.num_processes == 1:
        return list(records)
    import torch.distributed as dist

    P = group.num_processes
    payload = "\x00".join(f"{r.name}\x01{r.data}" for r in records).encode()
    arr = np.frombuffer(payload, dtype=np.uint8)
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    dist.all_gather(lengths, torch.tensor([len(arr)], dtype=torch.int64))
    all_n = [int(t[0]) for t in lengths]
    max_n = max(all_n)
    # gather in bounded slices: padding every rank to the global max and
    # gathering at once makes the transient footprint O(P * max_payload) —
    # at Gbp scale that is the largest allocation of the whole run. Slicing
    # caps the transient at O(P * CHUNK) while the assembled blobs only ever
    # hold real bytes.
    CHUNK = int(os.environ.get("VECHAT_ALLGATHER_CHUNK", 16 << 20))
    blobs = [bytearray() for _ in range(P)]
    for off in range(0, max_n, CHUNK):
        width = min(CHUNK, max_n - off)
        piece = np.zeros(width, dtype=np.uint8)
        if off < len(arr):
            src = arr[off : off + width]
            piece[: len(src)] = src
        gathered = [torch.empty(width, dtype=torch.uint8) for _ in range(P)]
        dist.all_gather(gathered, torch.from_numpy(piece))
        for pid in range(P):
            take = min(max(all_n[pid] - off, 0), width)
            if take:
                blobs[pid] += gathered[pid][:take].numpy().tobytes()
    out: List[SeqRecord] = []
    for pid in range(P):
        blob = blobs[pid].decode()
        if not blob:
            continue
        for item in blob.split("\x00"):
            name, data = item.split("\x01")
            out.append(SeqRecord(name, data))
    return out


def write_records_blob(records: Sequence[SeqRecord], path: str) -> None:
    """Name-preserving record serialization (FASTA round-trips truncate the
    LN/RC/XC tags at the first whitespace). Atomic via rename."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        for r in records:
            f.write(f"{r.name}\t{r.data}\n")
    os.replace(tmp, path)


def read_records_blob(path: str) -> List[SeqRecord]:
    out: List[SeqRecord] = []
    with open(path) as f:
        for line in f:
            name, _, data = line.rstrip("\n").partition("\t")
            out.append(SeqRecord(name, data))
    return out


def _wait_for_file(path: str, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for shard file {path}")
        time.sleep(0.05)


def exchange_records(
    records: Sequence[SeqRecord],
    group: ProcessGroup,
    prefix: str,
    timeout: float = 3600.0,
) -> List[SeqRecord]:
    """Between-round merge of per-process corrected shards.

    With VECHAT_DIST_INIT=1 the records ride the process group's all-gather
    (`allgather_records`); a group that is not initialised, or of another
    size, raises. Otherwise the exchange is the filesystem handoff the
    reference uses between SGE jobs (scripts/vechat_hpc.fast.sh:110-117):
    each process writes `{prefix}.shardNNNNN` + a `.done` marker, then reads
    every shard in rank order — deterministic, coordinator-free; a peer that
    never writes its shard is a TimeoutError after `timeout` seconds. The
    blob format is name-preserving (FASTA round-trips would truncate the
    LN/RC/XC tags at the first whitespace)."""
    if group.num_processes == 1:
        return list(records)
    if os.environ.get("VECHAT_DIST_INIT") == "1":
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != group.num_processes:
            raise RuntimeError(
                "VECHAT_DIST_INIT=1 but no torch.distributed group of "
                f"{group.num_processes} processes is initialised"
            )
        return allgather_records(records, group)

    mypath = f"{prefix}.shard{group.process_id:05d}"
    write_records_blob(records, mypath)
    open(mypath + ".done", "w").close()
    out: List[SeqRecord] = []
    for pid in range(group.num_processes):
        p = f"{prefix}.shard{pid:05d}"
        _wait_for_file(p + ".done", timeout)
        out.extend(read_records_blob(p))
    return out


def finish_exchange(group: ProcessGroup, prefix: str, timeout: float = 3600.0):
    """Barrier + cleanup for the file-shaped exchange: every process drops an
    `.exit` marker; rank 0 waits for all of them then removes every temp file
    under the prefix."""
    if group.num_processes == 1:
        return
    open(f"{prefix}.exit{group.process_id:05d}", "w").close()
    if group.process_id != 0:
        return
    for pid in range(group.num_processes):
        _wait_for_file(f"{prefix}.exit{pid:05d}", timeout)
    for p in glob.glob(f"{prefix}.shard*") + glob.glob(f"{prefix}.exit*"):
        try:
            os.remove(p)
        except OSError:
            pass


def run_sharded_correction(
    reads: List[SeqRecord],
    correct_fn,
    outfile: str,
    group: Optional[ProcessGroup] = None,
) -> None:
    """Full multi-process round: shard targets -> correct -> ordered merge.
    ``correct_fn(targets, queries) -> List[SeqRecord]``. With an initialised
    process group, rank 0 merges after a barrier; without one the caller
    must see to it that every shard file is written before rank 0 merges."""
    group = group or ProcessGroup.from_env()
    my_targets = shard_targets(reads, group)
    corrected = correct_fn(my_targets, reads)
    shard_path = shard_output_path(outfile, group)
    write_fasta(corrected, shard_path)
    if group.num_processes > 1:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier()
    merge_shard_files(outfile, group)
