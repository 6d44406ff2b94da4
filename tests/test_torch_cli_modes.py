"""The scale-out options of the port's `vechat` command line (`--split`,
`--stream`, `--resume-dir`, `--profile`) against the JAX package's command
line with the same flags, byte for byte, on the 10-read data set of
tests/test_mesh_and_modes.py; resume directories written by one package are
resumed by the other."""

import json
import os

import numpy as np
import pytest

from vechat_tpu.cli.vechat_main import main as jax_main
from vechat_tpu_torch.cli.vechat_main import build_parser, main
from vechat_tpu_torch.io.fastx import SeqRecord, read_fastx, write_fastx
from vechat_tpu_torch.parallel.dist import read_records_blob


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


@pytest.fixture(scope="module")
def reads_fq(tmp_path_factory):
    rng = np.random.default_rng(3)
    genome = rand_seq(rng, 1800)
    reads = []
    for i in range(10):
        start = int(rng.integers(0, 600))
        d = noisy(rng, genome[start : start + 1200])
        reads.append(SeqRecord(f"m{i}", d, "I" * len(d)))
    p = tmp_path_factory.mktemp("modes") / "reads.fq"
    write_fastx(reads, p, fmt="fq")
    return str(p)


HOST = ["--platform", "ont", "--backend", "host"]
# 16 FASTQ lines: 4 reads a chunk, 3 chunks; round 2 halves the line count
CHUNKED = ["--split-size", "16"]

# the reads overlap by some 600-1200 bases: let round 2 keep such overlaps,
# so that a two-round run has something to print
ROUND2 = ["--min-ovlplen-cns", "300", "--min-identity-cns", "0.90"]

MODES = {
    "split": ["--split", *CHUNKED, *ROUND2],
    "split_linear": ["--split", *CHUNKED, "--linear"],
    "stream": ["--stream", *CHUNKED, *ROUND2],
    "stream_linear_unpolished": ["--stream", *CHUNKED, "--linear", "-u"],
    "stream_one_chunk": ["--stream", *ROUND2],
    "split_consensus_only": ["--split", *CHUNKED, "--consensus-only",
                             "--min-ovlplen-cns", "300", "--min-identity-cns", "0.80"],
}


def run_cli(entry, reads, out, flags):
    assert entry([reads, "-o", str(out), *flags]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_the_jax_cli(reads_fq, tmp_path, mode):
    flags = HOST + MODES[mode]
    got = run_cli(main, reads_fq, tmp_path / "port.fa", flags)
    want = run_cli(jax_main, reads_fq, tmp_path / "jax.fa", flags)
    assert got == want
    assert got.count(b">") > 0
    assert sorted(os.listdir(tmp_path)) == ["jax.fa", "port.fa"]


def test_stream_through_the_plain_kernels(reads_fq, tmp_path):
    """`--stream` with the alignments on the plain PyTorch versions of the
    kernels prints what the host engine prints."""
    flags = ["--platform", "ont", "--stream", *CHUNKED, "--linear"]
    got = run_cli(main, reads_fq, tmp_path / "torch.fa", [*flags, "--backend", "torch"])
    want = run_cli(main, reads_fq, tmp_path / "host.fa", [*flags, "--backend", "host"])
    assert got == want and got.count(b">") > 0


@pytest.mark.parametrize("mode", ["split", "stream"])
def test_resume_recomputes_only_the_missing_chunk(reads_fq, tmp_path, mode):
    """--resume-dir: checkpoints of both rounds; with one of each round
    deleted the rerun gives the same bytes and the JAX command line's."""
    flags = HOST + [f"--{mode}", *CHUNKED, *ROUND2]
    fresh = run_cli(main, reads_fq, tmp_path / "fresh.fa", flags)
    assert fresh.count(b">") > 0
    rdir = tmp_path / "ckpt"
    resume = [*flags, "--resume-dir", str(rdir)]
    assert run_cli(main, reads_fq, tmp_path / "first.fa", resume) == fresh
    ckpts = sorted(p.name for p in rdir.iterdir())
    assert ckpts == [f"round{r}.chunk{c:05d}.rec" for r in (1, 2) for c in (1, 2, 3)]
    (rdir / "round1.chunk00002.rec").unlink()
    (rdir / "round2.chunk00001.rec").unlink()
    assert run_cli(main, reads_fq, tmp_path / "resumed.fa", resume) == fresh
    assert sorted(p.name for p in rdir.iterdir()) == ckpts
    assert run_cli(jax_main, reads_fq, tmp_path / "jax.fa", flags) == fresh


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_resume_dir_crosses_packages(reads_fq, tmp_path, writer, reader):
    """A resume directory written by one package's command line is resumed by
    the other's to the same bytes. One checkpoint is replaced by a marked
    copy, so the resumed output shows that it was read, not recomputed."""
    entry = {"jax": jax_main, "port": main}
    flags = HOST + ["--split", *CHUNKED, "--linear"]
    rdir = tmp_path / "ckpt"
    resume = [*flags, "--resume-dir", str(rdir)]
    written = run_cli(entry[writer], reads_fq, tmp_path / "w.fa", resume)
    assert len(list(rdir.iterdir())) == 3
    (rdir / "round1.chunk00003.rec").unlink()
    assert run_cli(entry[reader], reads_fq, tmp_path / "r.fa", resume) == written
    # mark chunk 1's first record: a resumed run must carry the mark through
    ck = rdir / "round1.chunk00001.rec"
    recs = read_records_blob(str(ck))
    ck.write_text("".join(f"{r.name}\t{r.data}\n" for r in recs).replace("\t", "\tNNNN", 1))
    marked = run_cli(entry[reader], reads_fq, tmp_path / "m.fa", resume)
    assert marked != written and marked.replace(b"\nNNNN", b"\n", 1) == written


def test_profile_writes_a_loadable_trace(reads_fq, tmp_path):
    pdir = tmp_path / "prof"
    flags = HOST + ["--linear", "--profile", str(pdir)]
    got = run_cli(main, reads_fq, tmp_path / "out.fa", flags)
    assert got == run_cli(main, reads_fq, tmp_path / "plain.fa", HOST + ["--linear"])
    traces = list(pdir.iterdir())
    assert [t.name for t in traces] == ["vechat.rank0.trace.json"]
    with open(traces[0]) as fh:
        trace = json.load(fh)
    assert isinstance(trace["traceEvents"], list)


def test_parser_defaults_match_the_jax_cli():
    from vechat_tpu.cli.vechat_main import build_parser as jax_parser

    port, ref = vars(build_parser().parse_args(["x.fq"])), vars(jax_parser().parse_args(["x.fq"]))
    assert set(port) == set(ref)
    for k in ("split", "split_size", "stream", "resume_dir", "profile"):
        assert port[k] == ref[k], k
    assert port["backend"] == "cuda" and ref["backend"] == "auto"


def test_split_output_is_read_back(reads_fq, tmp_path):
    run_cli(main, reads_fq, tmp_path / "o.fa", HOST + MODES["split"])
    recs = read_fastx(str(tmp_path / "o.fa"))
    assert recs and all(r.name.endswith("r") for r in recs)
