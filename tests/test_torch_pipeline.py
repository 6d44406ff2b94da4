"""The port's whole default pipeline on the CPU: the committed ont golden
(the JAX package's host output) reproduced byte for byte by `--backend
torch` (plain PyTorch versions of the kernels) and `--backend host`, and
the pb golden's reads, cut, by `--backend torch`; the port
never loads jax or the JAX package; `--backend cuda` raises without a GPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
PKG = os.path.join(REPO, "vechat_tpu_torch")

slow = pytest.mark.skipif(
    os.environ.get("VECHAT_SKIP_SLOW_TESTS") == "1",
    reason="skipped by VECHAT_SKIP_SLOW_TESTS=1",
)

# runs the port's CLI, then reports every loaded module of jax or of the
# JAX package (the prefix "vechat_tpu." does not match "vechat_tpu_torch")
_CLI_AND_MODULES = """
import sys
from vechat_tpu_torch.cli.vechat_main import main
rc = main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "vechat_tpu"
             or m.startswith("vechat_tpu."))
print("FOREIGN_MODULES=" + ",".join(bad))
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def ont_torch_run(tmp_path_factory):
    """One subprocess run of the port's CLI on the ont golden reads with
    --backend torch: (output FASTA text, foreign modules it loaded)."""
    out = tmp_path_factory.mktemp("ont_torch") / "out.fa"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _CLI_AND_MODULES,
         os.path.join(DATA, "golden_reads.fq"), "-o", str(out),
         "--platform", "ont", "--backend", "torch"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("FOREIGN_MODULES=")]
    return out.read_text(), line[-1].split("=", 1)[1]


def test_golden_ont_torch_backend(ont_torch_run):
    expected = open(os.path.join(DATA, "golden_expected.fa")).read()
    assert ont_torch_run[0] == expected


def test_cli_run_loads_no_jax_and_no_jax_package(ont_torch_run):
    assert ont_torch_run[1] == ""


def test_golden_ont_host_backend(tmp_path):
    from vechat_tpu_torch.cli.vechat_main import main

    out = tmp_path / "out.fa"
    rc = main([os.path.join(DATA, "golden_reads.fq"), "-o", str(out),
               "--platform", "ont", "--backend", "host"])
    assert rc == 0
    assert out.read_text() == open(os.path.join(DATA, "golden_expected.fa")).read()


# The plain PyTorch DP takes over ten minutes of CPU on all 60 pb golden
# reads, so the CPU test cuts them to the first PB_READS and holds the port
# to the JAX package's host run on the same reads. On the card,
# chip_smoke.py reproduces the whole pb golden with --backend cuda.
PB_READS = 20


@slow
def test_golden_pb_torch_backend(tmp_path):
    from vechat_tpu.cli.vechat_main import main as jax_main
    from vechat_tpu_torch.cli.vechat_main import main
    from vechat_tpu_torch.io.fastx import read_fastx, write_fastx

    reads = tmp_path / "pb.fq"
    write_fastx(read_fastx(os.path.join(DATA, "golden2_reads.fq"))[:PB_READS], str(reads), fmt="fq")
    flags = ["--platform", "pb", "--backend", "host", "--no-auto-sensitive"]
    want, got = tmp_path / "jax.fa", tmp_path / "port.fa"
    assert jax_main([str(reads), "-o", str(want), *flags]) == 0
    flags[3] = "torch"
    assert main([str(reads), "-o", str(got), *flags]) == 0
    assert got.read_text() == want.read_text()
    assert got.read_text().count(">") >= 1


_FOREIGN_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+vechat_tpu(\.|\s|$)|from\s+vechat_tpu(\.|\s))",
    re.M,
)


def test_sources_import_no_jax_and_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as fh:
            for m in _FOREIGN_IMPORT.finditer(fh.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert offenders == []


def test_import_pattern_catches_foreign_imports():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                "from vechat_tpu.ops import encode", "import vechat_tpu.io",
                "from vechat_tpu import io", "    import jax"):
        assert _FOREIGN_IMPORT.search(bad), bad
    for ok in ("from vechat_tpu_torch.ops import encode", "import vechat_tpu_torch",
               "import jaxlib_like_name_is_fine_if_not_jax"):
        assert not _FOREIGN_IMPORT.search(ok), ok


def test_cli_cuda_backend_raises_without_gpu(tmp_path, monkeypatch):
    from vechat_tpu_torch.cli.vechat_main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([os.path.join(DATA, "golden_reads.fq"), "-o", str(tmp_path / "o.fa"),
              "--platform", "ont"])
