"""The port stands on its own: no file of topsicle_tpu_torch nor
chip_smoke.py imports topsicle_tpu or jax, and the port's CLI runs in a
child process where both are blocked in sys.modules (k = 5, a mixed
table at k = 7, k = 16 on the host, --engine oracle, --rawcountpattern,
two files-mode processes) and writes CSV, subset and rawcount bytes
identical to JaxEngine's and OracleEngine's on the same input."""

import os
import random
import re
import subprocess
import sys

import pytest
import torch

from tests.test_pipeline import _write_synthetic_fastq
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.oracle import OracleEngine
from topsicle_tpu.pipeline import JaxEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's CLI with every import of jax and of the JAX package failing.
_CHILD = (
    "import sys; sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
    "from topsicle_tpu_torch.cli import main\n"
    "rc = main({argv!r})\n"
    "assert not [m for m in sys.modules if m.startswith(('jax.', 'topsicle_tpu.'))]\n"
    "sys.exit(rc)\n")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _children(argvs, timeout=300):
    """One blocked child per argv, all at once; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD.format(argv=list(a))], cwd=REPO,
                              env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for a in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def _port(data, out, *extra):
    return ["--inputDir", str(data), "--outputDir", str(out), "--batchSize", "8",
            "--device", "cpu", *extra]


def _outputs(out, rawcounts=False):
    """A run directory's CSV and subset files (and rawcount CSVs), by name."""
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())
            if p.name == "telolengths_all.csv" or p.name.endswith(".fastq")
            or (rawcounts and p.name.startswith("rawcount_"))}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """24 CCCTAAA reads (tests/test_pipeline.py's generator) in one file,
    and the same reads' generator split over two files for files mode."""
    d = tmp_path_factory.mktemp("standalone")
    _write_synthetic_fastq(str(d / "s.fastq.gz"), random.Random(11), n_reads=24)
    (d / "two").mkdir()
    rng = random.Random(12)
    for name in ("a.fastq.gz", "b.fastq.gz"):
        _write_synthetic_fastq(str(d / "two" / name), rng, n_reads=12)
    return d


@pytest.mark.parametrize("extra,cfg", [
    (["--pattern", "CCCTAAA", "--slide", "6"], dict(pattern="CCCTAAA", slide=6)),
    (["--pattern", "CCCTAAA", "--slide", "6", "--telophrase", "7"],
     dict(pattern="CCCTAAA", slide=6, telophrase=[7])),
], ids=["k5", "k7-mixed-table"])
def test_blocked_cli_matches_jax_and_oracle(reads, tmp_path, extra, cfg):
    data = reads / "s.fastq.gz"
    out = _children([_port(data, tmp_path / "t", *extra)])[0]
    assert "All telomere found, have a nice day." in out
    assert "reader: " in out
    JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                             batch_size=8, **cfg)).run()
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                                **cfg)).run()
    got = _outputs(tmp_path / "t")
    assert len(got) == 2 and got["telolengths_all.csv"].count(b"\n") > 4
    assert got == _outputs(tmp_path / "j")
    assert got == _outputs(tmp_path / "o")


def test_blocked_cli_k16_on_the_host(tmp_path):
    """k = 16 runs on the port's own host model; equal to JaxEngine's and
    the oracle's (16-mers of a noisy 9-bp repeat keep TRC near 0.25)."""
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(5), n_reads=8, pattern="CCCTAAACC")
    cfg = dict(input_dir=str(data), pattern="CCCTAAACC", telophrase=[16], cutoff=[0.1])
    out = _children([_port(data, tmp_path / "t", "--pattern", "CCCTAAACC", "--telophrase",
                           "16", "--cutoff", "0.1")])[0]
    assert "WARNING: telophrase 16 exceeds the device k-mer capacity (15)" in out
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=8, **cfg)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **cfg)).run()
    got = _outputs(tmp_path / "t")
    assert got["telolengths_all.csv"].count(b",16,") >= 2
    assert got == _outputs(tmp_path / "j") == _outputs(tmp_path / "o")


def test_blocked_cli_engine_oracle(reads, tmp_path):
    """--engine oracle is the port's own OracleEngine: the JAX package's
    bytes, with the JAX package blocked."""
    data = reads / "s.fastq.gz"
    _children([_port(data, tmp_path / "t", "--pattern", "CCCTAAA", "--slide", "6",
                     "--engine", "oracle")])
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                                pattern="CCCTAAA", slide=6)).run()
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "o")


def test_blocked_cli_rawcountpattern(reads, tmp_path):
    pytest.importorskip("pandas")
    data = reads / "s.fastq.gz"
    _children([_port(data, tmp_path / "t", "--pattern", "CCCTAAA", "--slide", "6",
                     "--rawcountpattern")])
    JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                             pattern="CCCTAAA", slide=6, batch_size=8,
                             rawcountpattern=True)).run()
    got = _outputs(tmp_path / "t", rawcounts=True)
    assert sum(n.startswith("rawcount_5_") for n in got) >= 4
    assert got == _outputs(tmp_path / "j", rawcounts=True)


def test_blocked_cli_two_files_mode_processes(reads, tmp_path):
    """Two blocked processes in files mode (file markers only): the merged
    outputs equal one JaxEngine run's on the same directory."""
    common = ["--pattern", "CCCTAAA", "--slide", "6", "--processCount", "2"]
    outs = _children([_port(reads / "two", tmp_path / "t", *common, "--processId", str(pid))
                      for pid in (0, 1)])
    assert "All telomere found" in outs[0]
    JaxEngine(TopsicleConfig(input_dir=str(reads / "two"), output_dir=str(tmp_path / "j"),
                             pattern="CCCTAAA", slide=6, batch_size=8)).run()
    got = _outputs(tmp_path / "t")
    assert len(got) == 3 and got == _outputs(tmp_path / "j")
    assert not (tmp_path / "t" / ".parts").exists()


# An import statement at the start of a line, or at the start of a string
# or of a line inside one (the code of a child process).
_IMPORT = re.compile(r"""(?:^|["';]|\\n)\s*(?:from|import)\s+(?:topsicle_tpu|jax)(?![\w])""",
                     re.MULTILINE)


def _port_sources():
    pkg = os.path.join(REPO, "topsicle_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_no_port_file_imports_the_jax_package_or_jax():
    assert _IMPORT.search('code = ("from topsicle_tpu.config import X\\n"')
    assert _IMPORT.search("    import jax\n") and _IMPORT.search("x = 1; import jax.numpy")
    assert not _IMPORT.search("from topsicle_tpu_torch.config import X  # not from jax\n")
    files = _port_sources()
    assert len(files) > 30
    for path in files:
        text = open(path).read()
        hits = [m.group(0).strip() for m in _IMPORT.finditer(text)]
        assert not hits, f"{os.path.relpath(path, REPO)}: {hits}"
    assert not os.path.exists(os.path.join(REPO, "topsicle_tpu_torch", "_host.py"))


def test_engine_subclasses_nothing_of_the_jax_package():
    from topsicle_tpu_torch.pipeline import TorchEngine

    assert [c.__module__ for c in TorchEngine.__mro__] == ["topsicle_tpu_torch.pipeline",
                                                           "builtins"]
