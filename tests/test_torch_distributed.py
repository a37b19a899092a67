"""Files mode over processes and the k > 15 host fallback in the port.

Files mode: the part files, done markers and merge are the port's copy of
the JAX package's, so two processes, simulated in one or run
as concurrent CLIs with or without --coordinator, give a CSV and subset
files byte-identical to a single-process run.  k > 15: the port's
OracleScanModel equals the JAX package's, and a sweep with such a phrase
equals JaxEngine's byte for byte.  Every child process runs with jax
and topsicle_tpu blocked and a time limit."""

import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_distributed import _write_file
from tests.test_pipeline import _write_synthetic_fastq
from tests.test_torch_pipeline import _cli_with_jax_blocked
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import patterns_to_search
from topsicle_tpu.models.oracle_model import OracleScanModel as JaxOracleScanModel
from topsicle_tpu.oracle import OracleEngine
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu_torch.models.oracle_model import OracleScanModel
from topsicle_tpu_torch.parallel import distributed
from topsicle_tpu_torch.pipeline import TorchEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A child process: the port's CLI with every import of jax and of the JAX
# package failing; it must load nothing of either.
_CHILD = (
    "import sys; sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
    "from topsicle_tpu_torch.cli import main\n"
    "rc = main({argv!r})\n"
    "assert not [m for m in sys.modules if m.startswith('jax') and m != 'jax']\n"
    "assert not [m for m in sys.modules if m.startswith('topsicle_tpu.')]\n"
    "sys.exit(rc)\n")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(scripts, timeout=240):
    """Run each script in its own python process, all at once; every
    one must exit 0 within `timeout` s.  A child still running when
    this returns or raises is killed.  Returns their stdouts."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", s], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for s in scripts]
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


def cli_children(argvs, timeout=240):
    return run_children([_CHILD.format(argv=list(a)) for a in argvs], timeout)


@pytest.fixture(scope="module")
def four_files(tmp_path_factory):
    """tests/test_distributed.py's inputs: 4 files of 4 reads, and the
    single-process port run on them (which must equal JaxEngine's)."""
    d = tmp_path_factory.mktemp("files")
    rng = random.Random(41)
    (d / "in").mkdir()
    for name in ["a.fastq.gz", "b.fastq.gz", "c.fastq.gz", "d.fastq.gz"]:
        _write_file(str(d / "in" / name), rng, 4)
    kw = dict(input_dir=str(d / "in"), pattern="CCCTAAA", slide=6, batch_size=8)
    TorchEngine(TopsicleConfig(output_dir=str(d / "single"), **kw), device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(d / "jax"), **kw)).run()
    return d


def _outputs(out):
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())
            if p.name == "telolengths_all.csv" or p.name.endswith(".fastq")}


def test_single_process_matches_jax(four_files):
    single = _outputs(four_files / "single")
    assert len(single) == 5 and single == _outputs(four_files / "jax")
    assert single["telolengths_all.csv"].count(b"\n") > 8


def test_files_mode_simulated_in_one_process(four_files, tmp_path):
    """tests/test_distributed.py's pattern: pid 1 writes its parts, then
    pid 0 writes its own, waits for pid 1's marker and merges."""
    for pid in (1, 0):
        TorchEngine(TopsicleConfig(
            input_dir=str(four_files / "in"), output_dir=str(tmp_path), pattern="CCCTAAA",
            slide=6, batch_size=8, process_id=pid, process_count=2), device="cpu").run()
    assert _outputs(tmp_path) == _outputs(four_files / "single")
    assert not (tmp_path / ".parts").exists()
    log = (tmp_path / "topsicle_run.log").read_text()
    assert log.count("All telomere found") == 1     # only process 0 merges


@pytest.mark.parametrize("coordinator", [False, True])
def test_two_cli_processes_files_mode(four_files, tmp_path, coordinator):
    """Two concurrent CLI processes, with file markers only or joined by
    --coordinator (gloo): byte-identical to the single-process run."""
    out = tmp_path / "multi"
    port = free_port()
    argvs = [["--inputDir", str(four_files / "in"), "--outputDir", str(out),
              "--pattern", "CCCTAAA", "--slide", "6", "--batchSize", "8",
              "--device", "cpu", "--processId", str(pid), "--processCount", "2",
              *(["--coordinator", f"127.0.0.1:{port}"] if coordinator else [])]
             for pid in (0, 1)]
    stdouts = cli_children(argvs)
    assert "All telomere found" in stdouts[0]
    assert _outputs(out) == _outputs(four_files / "single")
    assert not (out / ".parts").exists()


@pytest.mark.parametrize("kw", [dict(resume=True), dict(read_check="r0")])
def test_distributed_refuses_resume_and_read_check(tmp_path, kw):
    cfg = TopsicleConfig(input_dir="x", output_dir=str(tmp_path), pattern="CCCTAAA",
                         process_id=0, process_count=2, **kw)
    with pytest.raises(ValueError, match="distributed runs do not support"):
        TorchEngine(cfg, device="cpu").run()


def test_process_identity():
    assert distributed.process_identity(1, 3) == (1, 3)
    assert distributed.process_identity(None, 2) == (0, 2)
    assert distributed.process_identity(None, None) == (0, 1)    # no process group
    distributed.barrier()                                        # a no-op without one


def test_oracle_model_is_jaxs():
    """The port's OracleScanModel is its own module and computes what the
    JAX package's does: the same counts, changepoints and rawcounts at
    k = 16."""
    kmers = patterns_to_search("CCCTAAACC", 16)
    port = OracleScanModel(kmers, window_size=100, slide=9)
    ref = JaxOracleScanModel(kmers, window_size=100, slide=9)
    assert OracleScanModel.__module__ == "topsicle_tpu_torch.models.oracle_model"
    rng = np.random.default_rng(16)
    pat = np.resize(np.array(["ACGT".index(c) for c in "CCCTAAACC"], np.uint8), 1200)
    codes = rng.integers(0, 4, (3, 1200)).astype(np.uint8)
    codes[:2, :700] = pat[:700]
    codes[1, 900:] = 0xFF
    codes[2, 5] = 4
    lens = np.array([1200, 900, 1200], np.int32)
    nw = batching.window_counts_for_lengths(lens, 100, 9)
    ends = codes[:, :1000].reshape(3, 2, 500)
    got = port.step1_counts_launch(ends)
    np.testing.assert_array_equal(got, ref.step1_counts_launch(ends))
    t, has = port.step2_boundary_launch(codes, nw, lens)
    tr, hr = ref.step2_boundary_launch(codes, nw, lens)
    np.testing.assert_array_equal(t, tr)
    np.testing.assert_array_equal(has, hr)
    raw = port.rawcounts(codes)
    np.testing.assert_array_equal(raw, ref.rawcounts(codes))
    assert got.max() > 5 and has[:2].all() and raw.max() > 1


@pytest.fixture(scope="module")
def k16_input(tmp_path_factory):
    """tests/test_pipeline.py's k=16 input: 8 CCCTAAACC reads."""
    d = tmp_path_factory.mktemp("k16")
    _write_synthetic_fastq(str(d / "s.fastq.gz"), random.Random(5), n_reads=8,
                           pattern="CCCTAAACC")
    return d / "s.fastq.gz"


def test_k16_sweep_matches_jax(k16_input, tmp_path):
    """--telophrase 5 16: k=5 on the device model, k=16 on the host oracle
    model with JaxEngine's WARNING line; CSV and subset equal JaxEngine's.
    (16-mers of a 9-bp repeat count at most every 18 bp and 7% noise spoils
    most of them: their TRC stays near 0.25, so the cutoff is 0.1.)"""
    kw = dict(input_dir=str(k16_input), pattern="CCCTAAACC", telophrase=[5, 16],
              batch_size=4, cutoff=[0.1])
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw), device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "j")
    got = (tmp_path / "t" / "telolengths_all.csv").read_bytes()
    assert b",5," in got and b",16," in got
    log = (tmp_path / "t" / "topsicle_run.log").read_text()
    assert "WARNING: telophrase 16 exceeds the device k-mer capacity (15)" in log


def test_precompile_skips_the_host_phrase(k16_input, tmp_path):
    cfg = TopsicleConfig(input_dir=str(k16_input), output_dir=str(tmp_path),
                         pattern="CCCTAAACC", telophrase=[5, 16])
    eng = TorchEngine(cfg, device="cpu")
    assert eng.precompile() == 0
    log = (tmp_path / "topsicle_run.log").read_text()
    assert "precompile: k=5 ready on cpu" in log and "precompile: k=16" not in log
    assert isinstance(eng._models[16], OracleScanModel)


def test_cli_k16_with_jax_blocked(k16_input, tmp_path):
    """The k=16 host phrase needs no jax either; CSV equal to the oracle's."""
    _cli_with_jax_blocked(["--pattern", "CCCTAAACC", "--telophrase", "16", "--cutoff",
                           "0.1"], k16_input, tmp_path / "t")
    OracleEngine(TopsicleConfig(input_dir=str(k16_input), output_dir=str(tmp_path / "o"),
                                pattern="CCCTAAACC", telophrase=[16], cutoff=[0.1])).run()
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "o")
    assert (tmp_path / "t" / "telolengths_all.csv").read_bytes().count(b",16,") >= 2
