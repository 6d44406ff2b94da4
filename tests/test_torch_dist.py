"""The port's multi-process layer (`parallel/dist.py` on torch.distributed)
against the JAX package's: the sharding helpers and the record blobs on the
same inputs, the all-gather over a real two-process gloo group, and N
processes of the port's CLI against one process and against the JAX CLI,
byte for byte."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from vechat_tpu.io.fastx import SeqRecord as JaxSeqRecord
from vechat_tpu.parallel import dist as jdist
from vechat_tpu_torch.io.fastx import SeqRecord, write_fastx
from vechat_tpu_torch.parallel import dist as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT = 240


@pytest.mark.parametrize("n_items", [0, 1, 7, 8, 100])
@pytest.mark.parametrize("n_proc", [1, 3, 8])
def test_shard_bounds_match_jax_and_cover_all(n_items, n_proc):
    got = []
    for pid in range(n_proc):
        b, e = tdist.shard_bounds(n_items, tdist.ProcessGroup(pid, n_proc))
        assert (b, e) == jdist.shard_bounds(n_items, jdist.ProcessGroup(pid, n_proc))
        got.extend(range(b, e))
    assert got == list(range(n_items))


def test_shard_targets_and_output_path_match_jax():
    reads = [SeqRecord(f"r{i}", "ACGT") for i in range(10)]
    jreads = [JaxSeqRecord(f"r{i}", "ACGT") for i in range(10)]
    names = []
    for pid in range(3):
        mine = tdist.shard_targets(reads, tdist.ProcessGroup(pid, 3))
        theirs = jdist.shard_targets(jreads, jdist.ProcessGroup(pid, 3))
        assert [r.name for r in mine] == [r.name for r in theirs]
        names += [r.name for r in mine]
        assert tdist.shard_output_path("o.fa", tdist.ProcessGroup(pid, 3)) == (
            jdist.shard_output_path("o.fa", jdist.ProcessGroup(pid, 3))
        )
    assert names == [r.name for r in reads]
    assert tdist.shard_output_path("o.fa", tdist.ProcessGroup(0, 1)) == "o.fa"


def test_merge_shard_files_matches_jax(tmp_path):
    outs = {}
    for label, mod in (("port", tdist), ("jax", jdist)):
        out = str(tmp_path / f"{label}.fa")
        for pid in range(3):
            with open(mod.shard_output_path(out, mod.ProcessGroup(pid, 3)), "w") as fw:
                fw.write(f">r{pid}\nACGT\n")
        mod.merge_shard_files(out, mod.ProcessGroup(1, 3))  # not rank 0: nothing
        assert not os.path.exists(out)
        mod.merge_shard_files(out, mod.ProcessGroup(0, 3))
        outs[label] = open(out).read()
        assert not [f for f in os.listdir(tmp_path) if ".shard" in f]
    assert outs["port"] == outs["jax"] == ">r0\nACGT\n>r1\nACGT\n>r2\nACGT\n"


RECORDS = [("m0r LN:i:12 RC:i:3 XC:f:0.750000", "ACGTACGTACGT"), ("plain", "TTGA"), ("empty", "")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_blob_is_read_by_both_packages(tmp_path, writer):
    """A `.rec` checkpoint written by either package is read by the other:
    same bytes on disk, same records back, tags and all."""
    path = str(tmp_path / "round1.chunk00001.rec")
    if writer == "port":
        tdist.write_records_blob([SeqRecord(n, d) for n, d in RECORDS], path)
    else:
        jdist.write_records_blob([JaxSeqRecord(n, d) for n, d in RECORDS], path)
    assert open(path).read() == "".join(f"{n}\t{d}\n" for n, d in RECORDS)
    assert [(r.name, r.data) for r in tdist.read_records_blob(path)] == RECORDS
    assert [(r.name, r.data) for r in jdist.read_records_blob(path)] == RECORDS
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_process_group_from_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.ProcessGroup.from_env() == tdist.ProcessGroup(0, 1, 0)
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tdist.ProcessGroup.from_env() == tdist.ProcessGroup(2, 4, 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdist.ProcessGroup.from_env().local_rank == 1
    for rank, world in (("4", "4"), ("-1", "2"), ("0", "0")):
        monkeypatch.setenv("RANK", rank)
        monkeypatch.setenv("WORLD_SIZE", world)
        with pytest.raises(ValueError, match="invalid process group"):
            tdist.ProcessGroup.from_env()
        monkeypatch.setenv("JAX_PROCESS_ID", rank)
        monkeypatch.setenv("JAX_NUM_PROCESSES", world)
        with pytest.raises(ValueError, match="invalid process group"):
            jdist.ProcessGroup.from_env()


def test_process_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tdist.ProcessGroup(0, 1).device() == "cuda"  # one process: every card
    assert [tdist.ProcessGroup(r, 4, r).device() for r in range(4)] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"
    ]


def test_single_process_exchange_is_the_identity(tmp_path):
    recs = [SeqRecord(n, d) for n, d in RECORDS]
    g = tdist.ProcessGroup(0, 1)
    assert tdist.exchange_records(recs, g, str(tmp_path / "x")) == recs
    assert tdist.allgather_records(recs, g) == recs
    tdist.finish_exchange(g, str(tmp_path / "x"))
    assert os.listdir(tmp_path) == []


def test_file_exchange_times_out_on_a_missing_peer(tmp_path):
    """A peer that never writes its shard is a TimeoutError, not a hang and
    not a partial result."""
    with pytest.raises(TimeoutError, match="shard00001"):
        tdist.exchange_records(
            [SeqRecord("a", "ACGT")], tdist.ProcessGroup(0, 2), str(tmp_path / "x"), timeout=0.3
        )


def test_dist_init_without_a_group_raises(tmp_path, monkeypatch):
    """VECHAT_DIST_INIT=1 never drops to the file exchange: no rendezvous
    address, or no initialised group, raises."""
    monkeypatch.setenv("VECHAT_DIST_INIT", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    g = tdist.ProcessGroup(0, 2)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        g.initialize_torch()
    with pytest.raises(RuntimeError, match="VECHAT_DIST_INIT"):
        tdist.exchange_records([SeqRecord("a", "ACGT")], g, str(tmp_path / "x"))
    assert os.listdir(tmp_path) == []
    tdist.ProcessGroup(0, 1).initialize_torch()  # one process: nothing to join


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _env(**extra):
    # two threads a process: several run side by side
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "VECHAT_DIST_INIT", "XLA_FLAGS"):
        env.pop(k, None)
    env.update(extra)
    return env


# the ragged payload of tests/test_multihost_cli.py: rank 1 alone spans
# several 64-byte gather slices
ALLGATHER_WORKER = r"""
import json, os, sys
os.environ["VECHAT_ALLGATHER_CHUNK"] = "64"  # force the multi-slice path
from vechat_tpu_torch.io.fastx import SeqRecord
from vechat_tpu_torch.parallel.dist import ProcessGroup, allgather_records, exchange_records
group = ProcessGroup.from_env()
group.initialize_torch(timeout=120)
pid = group.process_id
mine = [SeqRecord(f"p{pid}r{i} LN:i:{i}", "ACGT" * (pid + i + 1)) for i in range(2)]
if pid == 1:
    mine.append(SeqRecord("p1big LN:i:9", "TGCA" * 100))
out = allgather_records(mine, group)
again = exchange_records(mine, group, sys.argv[1])  # VECHAT_DIST_INIT=1: the same route
assert [(r.name, r.data) for r in again] == [(r.name, r.data) for r in out]
none = allgather_records([] if pid == 0 else mine[:1], group)  # an empty rank
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
print(json.dumps([[[r.name, r.data] for r in out], [r.name for r in none]]))
"""


def test_allgather_records_two_process_gloo(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(ALLGATHER_WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(tmp_path / "x")],
            env=_env(RANK=str(pid), WORLD_SIZE="2", MASTER_ADDR="localhost",
                     MASTER_PORT=port, VECHAT_DIST_INIT="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SUBPROCESS_TIMEOUT)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert outs[0] == outs[1]  # both processes see the same merged, rank-ordered set
    merged, with_empty_rank = outs[0]
    assert [n for n, _ in merged] == [
        "p0r0 LN:i:0", "p0r1 LN:i:1", "p1r0 LN:i:0", "p1r1 LN:i:1", "p1big LN:i:9",
    ]
    assert dict(merged)["p1big LN:i:9"] == "TGCA" * 100  # multi-slice reassembly
    assert with_empty_rank == ["p1r0 LN:i:0"]
    assert os.listdir(tmp_path) == ["worker.py"]  # the all-gather leaves no file


# ------------------------------------------------- N processes of the CLI


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def noisy(rng, s, rate=0.06):
    out = []
    for c in s:
        r = rng.random()
        if r < rate * 0.5:
            out.append(rng.choice([b for b in "ACGT" if b != c]))
        elif r < rate * 0.75:
            continue
        else:
            out.append(c)
    return "".join(out)


@pytest.fixture
def dataset(tmp_path):
    """The 12-read data set of tests/test_multihost_cli.py."""
    rng = np.random.default_rng(7)
    genome = rand_seq(rng, 2000)
    reads = []
    for i in range(12):
        start = int(rng.integers(0, 700))
        d = noisy(rng, genome[start : start + 1300])
        reads.append(SeqRecord(f"m{i}", d, "I" * len(d)))
    p = tmp_path / "reads.fq"
    write_fastx(reads, p, fmt="fq")
    return p


def _cli(package, reads, out, flags, **env):
    cmd = [sys.executable, "-m", f"{package}.cli.vechat_main", str(reads), "-o", str(out),
           "--platform", "ont", *flags]
    return subprocess.Popen(cmd, env=_env(**env), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, cwd=REPO)


def _wait_all(procs):
    try:
        for p in procs:
            _, err = p.communicate(timeout=SUBPROCESS_TIMEOUT)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            p.kill()


def test_three_processes_equal_one_and_the_jax_cli(dataset, tmp_path):
    host = ["--backend", "host"]
    single, multi, jax_out = (tmp_path / n for n in ("single.fa", "multi.fa", "jax.fa"))
    _wait_all([
        _cli("vechat_tpu_torch", dataset, single, host),
        _cli("vechat_tpu", dataset, jax_out, host),
        *[_cli("vechat_tpu_torch", dataset, multi, host, RANK=str(r), WORLD_SIZE="3")
          for r in range(3)],
    ])
    assert single.read_bytes() == multi.read_bytes() == jax_out.read_bytes()
    assert single.read_bytes().count(b">") > 0
    # exchange temp files cleaned up by rank 0
    assert [f for f in os.listdir(tmp_path) if ".shard" in f or ".exit" in f] == []


def test_two_processes_all_gather_torch_backend(dataset, tmp_path):
    """Two processes merging through the gloo all-gather, alignments on the
    plain PyTorch versions of the kernels: rank 0's file equals one
    process's, and no exchange file is left."""
    flags = ["--backend", "torch", "--linear"]
    single, multi = tmp_path / "single.fa", tmp_path / "multi.fa"
    port = _free_port()
    _wait_all([
        _cli("vechat_tpu_torch", dataset, single, flags),
        *[_cli("vechat_tpu_torch", dataset, multi, flags, RANK=str(r), WORLD_SIZE="2",
               VECHAT_DIST_INIT="1", MASTER_ADDR="localhost", MASTER_PORT=port)
          for r in range(2)],
    ])
    assert single.read_bytes() == multi.read_bytes()
    assert single.read_bytes().count(b">") > 0
    assert [f for f in os.listdir(tmp_path) if ".shard" in f or ".exit" in f] == []


def test_run_sharded_correction_merges_in_rank_order(tmp_path):
    """Ranks run one after another (no group initialised): rank 0 last, so
    every shard file is there when it merges."""
    reads = [SeqRecord(f"r{i}", "ACGT" * (i + 1)) for i in range(5)]
    out = str(tmp_path / "out.fa")

    def correct(targets, queries):
        assert len(queries) == 5
        return [SeqRecord(t.name + "c", t.data.lower()) for t in targets]

    for pid in (2, 1, 0):
        tdist.run_sharded_correction(reads, correct, out, tdist.ProcessGroup(pid, 3))
    assert open(out).read() == "".join(f">r{i}c\n{'acgt' * (i + 1)}\n" for i in range(5))
    assert os.listdir(tmp_path) == ["out.fa"]
