"""TorchEngine and the `topsicle-torch` CLI end to end on the CPU: the
CSV and subset FASTQ must be byte-identical to JaxEngine's and
OracleEngine's (multi-k, --threads, --resume included), the CLI must run
with jax blocked (the machine with the card has none), --kernel xla must
run the auto route and say so, and an unknown kernel must be refused with
a clear error."""

import gzip
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_integration_matrix import _cohort
from tests.test_pipeline import _write_synthetic_fastq
from tests.test_reader_envelope import _good_fastq
from tests.test_resume import _write_file
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.oracle import OracleEngine
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu.utils import RunManifest
from topsicle_tpu_torch import cli
from topsicle_tpu_torch.kmers import patterns_to_search
from topsicle_tpu_torch.pipeline import XLA_KERNEL_LINE, TorchEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBSET = "synthetic.fastq_trc_over_0.7.fastq"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """tests/test_pipeline.py's 40-read input (rng 99) and the oracle's
    outputs on it."""
    d = tmp_path_factory.mktemp("synthetic")
    data = d / "synthetic.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(99))
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(d / "oracle"),
                                pattern="CCCTAAA", slide=6)).run()
    return data, d / "oracle"


def _bytes(out, name="telolengths_all.csv"):
    return (out / name).read_bytes()


def test_torch_engine_matches_jax_and_oracle(synthetic, tmp_path):
    data, oracle = synthetic
    kw = dict(input_dir=str(data), pattern="CCCTAAA", slide=6, batch_size=8)
    res = TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw),
                      device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    got = _bytes(tmp_path / "t")
    assert got == _bytes(oracle) == _bytes(tmp_path / "j")
    assert got.count(b"\r\n") == len(res) + 1 > 2
    assert _bytes(tmp_path / "t", SUBSET) == _bytes(oracle, SUBSET) == \
        _bytes(tmp_path / "j", SUBSET)
    log = (tmp_path / "t" / "topsicle_run.log").read_text()
    assert "device: cpu" in log and "All telomere found" in log


def test_torch_engine_multi_k(tmp_path):
    """CCCTAAA at k = 4 and 5 (both tables aperiodic), batch 5."""
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(7), n_reads=16)
    kw = dict(input_dir=str(data), pattern="CCCTAAA", telophrase=[4, 5], slide=6)
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), batch_size=5, **kw),
                device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=8, **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    got = _bytes(tmp_path / "t")
    assert got == _bytes(tmp_path / "o") == _bytes(tmp_path / "j")
    assert b",4," in got and b",5," in got


def test_torch_engine_threads_byte_identity(tmp_path):
    """--threads 1 and 2 read files concurrently but consume them in
    order: the same bytes, and the oracle's."""
    rng = random.Random(31)
    d = tmp_path / "in"
    d.mkdir()
    for f in range(4):
        _write_synthetic_fastq(str(d / f"f{f}.fastq.gz"), rng, n_reads=6)
    outs = []
    for th in (1, 2):
        cfg = TopsicleConfig(input_dir=str(d), output_dir=str(tmp_path / f"t{th}"),
                             pattern="CCCTAAA", slide=6, batch_size=4, threads=th)
        TorchEngine(cfg, device="cpu").run()
        outs.append(_bytes(tmp_path / f"t{th}"))
    OracleEngine(TopsicleConfig(input_dir=str(d), output_dir=str(tmp_path / "o"),
                                pattern="CCCTAAA", slide=6)).run()
    assert outs[0] == outs[1] == _bytes(tmp_path / "o")
    assert outs[0].count(b"\n") > 2


def test_torch_engine_resume_after_interrupt(tmp_path):
    """tests/test_resume.py's pattern: drop the (b, k=5) unit of a 2-k
    sweep from the manifest; the resumed CSV is byte-identical to the
    uninterrupted run's, with full-precision TRCs from the manifest."""
    rng = random.Random(11)
    d = tmp_path / "in"
    d.mkdir()
    _write_file(str(d / "a.fastq.gz"), rng, 6)
    _write_file(str(d / "b.fastq.gz"), rng, 6)
    out = tmp_path / "out"
    kw = dict(input_dir=str(d), output_dir=str(out), pattern="CCCTAAA",
              telophrase=[4, 5], slide=6, batch_size=8)
    res1 = TorchEngine(TopsicleConfig(**kw), device="cpu").run()
    csv1 = _bytes(out)
    m = RunManifest(str(out))
    key_b5 = [k for k in m._done if "b.fastq" in k and k.endswith("::5")]
    assert key_b5
    del m._done[key_b5[0]]
    m.mark_done(str(d / "a.fastq.gz"), 4, m.rows_for(str(d / "a.fastq.gz"), 4),
                trcs=m.trcs_for(str(d / "a.fastq.gz"), 4))
    res2 = TorchEngine(TopsicleConfig(resume=True, **kw), device="cpu").run()
    assert _bytes(out) == csv1
    assert sorted(r.trc for r in res1) == sorted(r.trc for r in res2)
    assert "resume: skipping completed unit" in (out / "topsicle_run.log").read_text()


def test_torch_engine_bucket_scan_length(synthetic, tmp_path):
    """--scanLengthMode bucket pads each step-2 batch to its own length,
    so the kernel sees several L; the bytes stay the oracle's."""
    data, oracle = synthetic
    TorchEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path),
                               pattern="CCCTAAA", slide=6, batch_size=3,
                               scan_length_mode="bucket"), device="cpu").run()
    assert _bytes(tmp_path) == _bytes(oracle)


def test_torch_engine_read_check(synthetic, tmp_path):
    data, oracle = synthetic
    rows = _bytes(oracle).decode().splitlines()[1:]
    rid = rows[0].split(",")[3]
    TorchEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path),
                               pattern="CCCTAAA", slide=6, batch_size=8,
                               read_check=rid), device="cpu").run()
    lines = _bytes(tmp_path).decode().splitlines()
    assert lines[1:] == [rows[0]]


def _cli_with_jax_blocked(args, data, out):
    """Run the port's CLI in a subprocess where every import of jax and
    of the JAX package fails; assert it ran and loaded nothing of either."""
    code = ("import sys; sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
            "from topsicle_tpu_torch.cli import main\n"
            f"rc = main(['--inputDir', {str(data)!r}, '--outputDir', {str(out)!r},"
            f" '--batchSize', '8', '--device', 'cpu', *{args!r}])\n"
            "assert not [m for m in sys.modules if m.startswith('jax') and m != 'jax']\n"
            "assert not [m for m in sys.modules if m.startswith('topsicle_tpu.')]\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "All telomere found, have a nice day." in proc.stdout


def test_cli_with_jax_blocked(synthetic, tmp_path):
    """The machine with the card has no jax: the port's CLI must run with
    every jax import failing, and write the oracle's CSV."""
    data, oracle = synthetic
    _cli_with_jax_blocked(["--pattern", "CCCTAAA", "--slide", "6"], data, tmp_path)
    assert _bytes(tmp_path) == _bytes(oracle)
    assert _bytes(tmp_path, SUBSET) == _bytes(oracle, SUBSET)


def test_cli_with_jax_blocked_mixed_table(synthetic, tmp_path):
    """The same at --telophrase 7, a mixed table (8 of 14 entries
    periodic): the greedy kernel's path needs no jax either."""
    data, _ = synthetic
    _cli_with_jax_blocked(["--pattern", "CCCTAAA", "--slide", "6", "--telophrase", "7"],
                          data, tmp_path / "t")
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                                pattern="CCCTAAA", slide=6, telophrase=[7])).run()
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "o")
    assert _bytes(tmp_path / "t", SUBSET) == _bytes(tmp_path / "o", SUBSET)
    assert b",7," in _bytes(tmp_path / "t")


def _outputs(out, glob):
    return {p.name: p.read_bytes() for p in sorted(out.glob(glob))}


@pytest.mark.parametrize("pattern,kw", [
    ("CCCTAAA", dict(telophrase=[6, 7])),    # mixed: 4 and 8 of 14 periodic
    ("CCCTAA", dict(telophrase=[5])),        # human, mixed: 2 of 12 periodic
    ("CCCTAAA", dict(use_pallas="greedy")),  # --kernel greedy, aperiodic k=5
    ("CCCTAA", dict(use_pallas="sum")),      # --kernel sum falls back to greedy
])
def test_torch_engine_greedy_tables_match_jax_and_oracle(pattern, kw, tmp_path):
    """Tables and kernels the greedy kernel serves: CSV and subset files
    byte-identical to JaxEngine's and OracleEngine's."""
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(len(pattern)), n_reads=24,
                           pattern=pattern)
    base = dict(input_dir=str(data), pattern=pattern, slide=6, **kw)
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), batch_size=8, **base),
                device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=8, **base)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **base)).run()
    got = _bytes(tmp_path / "t")
    assert got == _bytes(tmp_path / "j") == _bytes(tmp_path / "o")
    assert got.count(b"\n") > 4
    subsets = _outputs(tmp_path / "t", "*.fastq")
    assert subsets and subsets == _outputs(tmp_path / "j", "*.fastq") == \
        _outputs(tmp_path / "o", "*.fastq")


@pytest.mark.parametrize("phrase", [5, 7])
def test_torch_engine_rawcountpattern(synthetic, tmp_path, phrase):
    """--rawcountpattern: every rawcount_{k}_{n}.csv byte-identical to
    JaxEngine's, for the aperiodic k=5 table and the mixed k=7 one."""
    data, _ = synthetic
    kw = dict(input_dir=str(data), pattern="CCCTAAA", slide=6, batch_size=8,
              telophrase=[phrase], rawcountpattern=True)
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw), device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    raw = _outputs(tmp_path / "t", "rawcount_*.csv")
    assert len(raw) >= 3 and raw == _outputs(tmp_path / "j", "rawcount_*.csv")
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j")


def test_torch_engine_plot(tmp_path):
    """--plot: the same PNG names as JaxEngine, and the same CSV."""
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(3), n_reads=8)
    kw = dict(input_dir=str(data), pattern="CCCTAAA", slide=6, batch_size=8, plot=True)
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw), device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    names = set(_outputs(tmp_path / "t", "plot_*.png"))
    assert names and names == set(_outputs(tmp_path / "j", "plot_*.png"))
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j")


def test_torch_engine_truncated_file_removes_partial_extras(tmp_path):
    """tests/test_reader_envelope.py's case: --rawcountpattern files that a
    unit's early batches wrote are removed when the unit later fails
    mid-stream, and the unit contributes no row."""
    rng = np.random.default_rng(11)
    indir = tmp_path / "in"
    indir.mkdir()
    buf = []
    for i in range(12):
        seq = ("CCCTAAA" * 220)[:1500] + "".join(rng.choice(list("ACGT"), 9100))
        buf.append(f"@t{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    payload = gzip.compress("".join(buf).encode())
    (indir / "trunc.fastq.gz").write_bytes(payload[: len(payload) // 2])
    out = tmp_path / "o"
    cfg = TopsicleConfig(input_dir=str(indir), output_dir=str(out), pattern="CCCTAAA",
                         slide=6, batch_size=4, maxlengthtelo=2048, rawcountpattern=True,
                         native_io=False)
    assert TorchEngine(cfg, device="cpu").run() == []
    assert "skipping this file" in (out / "topsicle_run.log").read_text()
    assert not list(out.glob("rawcount_*.csv"))


@pytest.mark.parametrize("kw,match", [
    (dict(use_pallas=False), None),      # --kernel xla: accepted, the auto route
    (dict(use_pallas="bogus"), "unknown kernel"),
])
def test_torch_engine_refuses(kw, match, tmp_path):
    """An unknown kernel is refused; use_pallas=False (--kernel xla) is
    not: the engine builds, says so in the run log, and its model is the
    auto one (fused, the sum kernel for this table)."""
    cfg = dict(input_dir="x", output_dir=str(tmp_path), pattern="CCCTAAA", slide=6)
    cfg.update(kw)
    if match is not None:
        with pytest.raises(ValueError, match=match):
            TorchEngine(TopsicleConfig(**cfg), device="cpu")
        return
    engine = TorchEngine(TopsicleConfig(**cfg), device="cpu")
    assert XLA_KERNEL_LINE in (tmp_path / "topsicle_run.log").read_text()
    model = engine._model(5, patterns_to_search("CCCTAAA", 5))
    assert model.fused and model.kernel == "sum"


@pytest.mark.parametrize("extra", [["--kernel", "xla"]])
def test_cli_refuses(synthetic, tmp_path, extra):
    """--kernel xla is no longer refused: the flag runs the auto route,
    logs one line saying so, and gives the bytes of JaxEngine on its XLA
    programs (use_pallas=False) and of the oracle."""
    data, oracle = synthetic
    rc = cli.main(["--inputDir", str(data), "--outputDir", str(tmp_path / "t"),
                   "--pattern", "CCCTAAA", "--slide", "6", "--batchSize", "8",
                   "--device", "cpu", *extra])
    assert rc == 0
    log = (tmp_path / "t" / "topsicle_run.log").read_text()
    assert log.count(XLA_KERNEL_LINE) == 1 and "All telomere found" in log
    JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                             pattern="CCCTAAA", slide=6, batch_size=8,
                             use_pallas=False)).run()
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j") == _bytes(oracle)
    assert _bytes(tmp_path / "t", SUBSET) == _bytes(tmp_path / "j", SUBSET) == \
        _bytes(oracle, SUBSET)


def test_cli_cuda_without_card_raises(synthetic, tmp_path, monkeypatch):
    data, _ = synthetic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--inputDir", str(data), "--outputDir", str(tmp_path),
                  "--pattern", "CCCTAAA", "--device", "cuda"])


def test_cli_override_guard_precompile_and_trace(synthetic, tmp_path):
    data, oracle = synthetic
    args = ["--inputDir", str(data), "--outputDir", str(tmp_path), "--pattern",
            "CCCTAAA", "--slide", "6", "--batchSize", "8", "--device", "cpu"]
    assert cli.main(args + ["--traceDir", str(tmp_path / "trace")]) == 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert cli.main(args) == 1                 # refuses without --override
    assert cli.main(args + ["--override"]) == 0
    assert _bytes(tmp_path) == _bytes(oracle)
    assert cli.main(args + ["--precompile"]) == 0


# ---- the JAX suite's envelope and integration cases on the torch engine ---------

@pytest.mark.parametrize("use_native", [False, None])
def test_midfile_truncation_contributes_nothing(tmp_path, use_native):
    """tests/test_reader_envelope.py's case, both readers: a gzip that dies
    mid-stream after full blocks contributes no row and stays un-done; the
    CSV equals JaxEngine's on the same directory and the oracle's on the
    good file alone."""
    from topsicle_tpu_torch.utils.manifest import RunManifest as TorchManifest

    indir = tmp_path / "in"
    indir.mkdir()
    _good_fastq(indir / "agood.fastq")
    rng = np.random.default_rng(9)
    buf = []
    for i in range(12):
        seq = ("CCCTAAA" * 220)[:1500] + "".join(rng.choice(list("ACGT"), 9100))
        buf.append(f"@t{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    payload = gzip.compress("".join(buf).encode())
    (indir / "btrunc.fastq.gz").write_bytes(payload[: len(payload) // 2])
    kw = dict(input_dir=str(indir), pattern="CCCTAAA", slide=6, batch_size=4,
              native_io=use_native)
    results = TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw),
                          device="cpu").run()
    assert len(results) == 2 and all(r.read_id.startswith("read") for r in results)
    log_text = (tmp_path / "t" / "topsicle_run.log").read_text()
    assert "skipping this file" in log_text and "btrunc" in log_text
    m = TorchManifest(str(tmp_path / "t"))
    assert m.is_done(str(indir / "agood.fastq"), 5)
    assert not m.is_done(str(indir / "btrunc.fastq.gz"), 5)
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    OracleEngine(TopsicleConfig(input_dir=str(indir / "agood.fastq"),
                                output_dir=str(tmp_path / "o"), pattern="CCCTAAA",
                                slide=6)).run()
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j") == _bytes(tmp_path / "o")
    assert _bytes(tmp_path / "t").count(b"\n") == 3


@pytest.mark.parametrize("use_native", [False, None])
def test_engine_skips_stray_file_identically(tmp_path, use_native):
    """tests/test_reader_envelope.py's case, both readers: a stray text file
    in --inputDir is a logged skip, and the CSV equals JaxEngine's on the
    same directory and the oracle's without the stray file."""
    indir = tmp_path / "in"
    indir.mkdir()
    _good_fastq(indir / "good.fastq")
    (indir / "stray.txt").write_text("not sequence data\n")
    kw = dict(input_dir=str(indir), pattern="CCCTAAA", slide=6, batch_size=8,
              native_io=use_native)
    results = TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw),
                          device="cpu").run()
    assert len(results) == 2
    log_text = (tmp_path / "t" / "topsicle_run.log").read_text()
    assert "skipping this file" in log_text and "stray.txt" in log_text
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    OracleEngine(TopsicleConfig(input_dir=str(indir / "good.fastq"),
                                output_dir=str(tmp_path / "o"), pattern="CCCTAAA",
                                slide=6)).run()
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j") == _bytes(tmp_path / "o")


def test_all_features_vs_jax_and_oracle(tmp_path, monkeypatch):
    """tests/test_integration_matrix.py's cohort with every subsystem at
    once: two files, --telophrase 4 5 on CCCTAA (k=5 mixed: the greedy
    kernel), the encoded-block cache (TOPSICLE_BLOCK_CACHE_MB), three
    reader threads, batches of 8, maxlengthtelo 2048, N-bearing reads.
    CSV and subsets equal JaxEngine's and the oracle's, and the block
    cache is gone at the end."""
    indir = _cohort(tmp_path)
    monkeypatch.setenv("TOPSICLE_BLOCK_CACHE_MB", "64")
    kw = dict(input_dir=str(indir), pattern="CCCTAA", telophrase=[4, 5],
              maxlengthtelo=2048, batch_size=8)
    eng = TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), threads=3, **kw),
                      device="cpu")
    assert eng._bc_enabled
    eng.run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), threads=3, **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j") == _bytes(tmp_path / "o")
    subs = _outputs(tmp_path / "t", "*_trc_over_*")
    assert subs and subs == _outputs(tmp_path / "j", "*_trc_over_*") == \
        _outputs(tmp_path / "o", "*_trc_over_*")
    assert not os.path.isdir(str(tmp_path / "t" / ".blockcache"))
    assert b",4," in _bytes(tmp_path / "t") and b",5," in _bytes(tmp_path / "t")
