"""--shardMode global in the port: GlobalScanModel against JAX's on one
process, the lockstep control word and the gathers across two gloo
processes, and global runs (one process, and two CLI processes on skewed
inputs with jax blocked) byte-identical to JaxEngine's; --resume, the
--rawcountpattern/--plot extras, a stray file and a mixed table in global
mode against JaxEngine and OracleEngine.  Integer device path: tolerance
0."""

import inspect
import json
import random

import numpy as np
import pytest
import torch

from tests.test_multihost import _write_file
from tests.test_pipeline import _write_synthetic_fastq
from tests.test_reader_envelope import _good_fastq
from tests.test_resume import _write_file as _write_resume_file
from tests.test_torch_distributed import _outputs, cli_children, free_port, run_children
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
from topsicle_tpu.oracle import OracleEngine
from topsicle_tpu.parallel.multihost import GlobalScanModel as JaxGlobalScanModel
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu.utils import RunManifest
from topsicle_tpu_torch.models import TorchScanModel
from topsicle_tpu_torch.parallel.multihost import (GlobalScanModel, any_process_has_data,
                                                   or_across_processes)
from topsicle_tpu_torch.pipeline import TorchEngine


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(seed, B, dirty):
    """Seeded step-1 ends [B, 2, 1000] and step-2 tails [B, 2048] with
    lengths (the last row a pad row); N's when `dirty`."""
    rng = np.random.default_rng(seed)
    pat = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), 2048)
    tails = rng.integers(0, 4, (B, 2048)).astype(np.uint8)
    telo = rng.integers(200, 2048, B)
    tails = np.where(np.arange(2048)[None, :] < telo[:, None], pat[None, :], tails)
    if dirty:
        tails[rng.random(tails.shape) < 0.01] = 4
    tails = tails.astype(np.uint8)
    ends = tails[:, :2000].reshape(B, 2, 1000).copy()
    ends_len = np.full(B, 1000, np.int32)
    lens = rng.integers(600, 2049, B).astype(np.int32)
    ends_len[-1] = lens[-1] = 0
    ends[-1] = 0xFF
    tails[np.arange(2048)[None, :] >= lens[:, None]] = 0xFF
    return ends, ends_len, tails, lens


@pytest.mark.parametrize("dense", [False, True])
def test_global_model_matches_jax(dense):
    """One process: the port's global results and my_rows equal JAX's
    GlobalScanModel (GSPMD over the 8 CPU devices), on both wires."""
    jm = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6)
    jg = JaxGlobalScanModel(jm)
    tg = GlobalScanModel(TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu",
                                        window_size=100, slide=6))
    assert (tg.pid, tg.n_proc) == (0, 1)
    ends, ends_len, tails, lens = _batches(5, 8, dense)
    counts = tg.step1_counts_global(ends, ends_len, dense=dense)
    np.testing.assert_array_equal(counts, jg.step1_counts_global(ends, ends_len, dense=dense))
    np.testing.assert_array_equal(tg.my_rows(counts, 8), counts)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = tg.step2_boundary_global(tails, nw, lens, dense=dense)
    tj, hj = jg.step2_boundary_global(tails, nw, lens, dense=dense)
    np.testing.assert_array_equal(t, np.asarray(tj))
    np.testing.assert_array_equal(has, np.asarray(hj))
    assert counts.sum() > 0 and has.sum() > 3 and not has[-1]


def test_control_word_one_process():
    word = or_across_processes([True, False, True])
    assert word.dtype == np.bool_ and word.tolist() == [True, False, True]
    assert any_process_has_data(True) and not any_process_has_data(False)


# A child process of the gloo test, jax and the JAX package blocked;
# _batches is pasted in.
_GATHER = (
    "import json, sys; sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
    "import numpy as np\n"
    "{batches}\n"
    "from topsicle_tpu_torch.io import batch as batching\n"
    "from topsicle_tpu_torch.kmers import telophrase_kmers\n"
    "from topsicle_tpu_torch.models import TorchScanModel\n"
    "from topsicle_tpu_torch.parallel import mesh, multihost\n"
    "pid = {pid}\n"
    "assert mesh.initialize_distributed('127.0.0.1:{port}', 2, pid)\n"
    "out = dict(word=multihost.or_across_processes([pid == 0, pid == 1, False]).tolist(),\n"
    "           any1=multihost.any_process_has_data(pid == 1),\n"
    "           none=multihost.any_process_has_data(False))\n"
    "g = multihost.GlobalScanModel(TorchScanModel(telophrase_kmers('CCCTAAA', 7),\n"
    "                              device='cpu', window_size=100, slide=6))\n"
    "ends, ends_len, tails, lens = _batches(9, 8, pid == 1)\n"
    "mine = slice(4 * pid, 4 * pid + 4)\n"
    "nw = batching.window_counts_for_lengths(lens, 100, 6)\n"
    "c = g.step1_counts_global_launch(ends[mine], ends_len[mine], dense=True)\n"
    "t, has = g.step2_boundary_global_launch(tails[mine], nw[mine], lens[mine], dense=True)\n"
    "c, t, has = np.asarray(c), np.asarray(t), np.asarray(has)\n"
    "out.update(counts=c.tolist(), t=t.tolist(), has=has.tolist(),\n"
    "           mine=g.my_rows(t, 4).tolist())\n"
    "mesh.shutdown_distributed()\n"
    "print(json.dumps(out))\n")


def test_control_word_and_gathers_across_two_processes():
    """Two gloo processes: the OR of the control word, and step-1 counts
    and step-2 (t, has) gathered in rank order, equal to one model's
    result on the whole batch (process 1's half has N's: dense wire)."""
    port = free_port()
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in run_children([_GATHER.format(pid=p, port=port,
                                                  batches=inspect.getsource(_batches))
                                   for p in (0, 1)])]
    model = TorchScanModel(telophrase_kmers("CCCTAAA", 7), device="cpu", window_size=100,
                           slide=6)
    ends, ends_len, tails, lens = _batches(9, 8, False)
    ends1, ends_len1, tails1, lens1 = _batches(9, 8, True)
    ends[4:], ends_len[4:], tails[4:], lens[4:] = ends1[4:], ends_len1[4:], tails1[4:], \
        lens1[4:]
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = model.step2_boundary(tails, nw, lens)
    for pid, out in enumerate(outs):
        assert out["word"] == [True, True, False]
        assert out["any1"] is True and out["none"] is False
        assert out["counts"] == model.step1_counts(ends, ends_len).tolist()
        assert out["t"] == t.tolist() and out["has"] == has.tolist()
        assert out["mine"] == t[4 * pid:4 * pid + 4].tolist()
    assert sum(has) > 2


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    """tests/test_multihost.py's skewed inputs (9 reads and 3 reads) and
    JaxEngine's files-mode outputs on them."""
    d = tmp_path_factory.mktemp("skewed")
    rng = random.Random(61)
    (d / "in").mkdir()
    _write_file(str(d / "in" / "big.fastq.gz"), rng, 9)
    _write_file(str(d / "in" / "small.fastq.gz"), rng, 3)
    JaxEngine(TopsicleConfig(input_dir=str(d / "in"), output_dir=str(d / "jax"),
                             pattern="CCCTAAA", slide=6, batch_size=8)).run()
    return d


def test_one_process_global_matches_jax_global(skewed, tmp_path):
    """One process, --shardMode global: the CSV and subsets equal
    JaxEngine's global run and its files-mode run."""
    kw = dict(input_dir=str(skewed / "in"), pattern="CCCTAAA", slide=6, batch_size=8,
              shard_mode="global")
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw), device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    got = _outputs(tmp_path / "t")
    assert got == _outputs(tmp_path / "j") == _outputs(skewed / "jax")
    assert got["telolengths_all.csv"].count(b"\n") > 5
    assert "global mesh" in (tmp_path / "t" / "topsicle_run.log").read_text()


def test_two_process_global_cli(skewed, tmp_path):
    """Two CLI processes joined by --coordinator, jax blocked in both:
    process 0 holds 9 reads and process 1 only 3, yet they run the same
    lockstep batches; the merged CSV and subsets equal JaxEngine's."""
    out = tmp_path / "multi"
    port = free_port()
    stdouts = cli_children([
        ["--inputDir", str(skewed / "in"), "--outputDir", str(out), "--pattern", "CCCTAAA",
         "--slide", "6", "--batchSize", "4", "--device", "cpu", "--shardMode", "global",
         "--coordinator", f"127.0.0.1:{port}", "--processId", str(pid),
         "--processCount", "2"] for pid in (0, 1)])
    assert "All telomere found" in stdouts[0]
    assert _outputs(out) == _outputs(skewed / "jax")
    assert not (out / ".parts").exists()


def test_global_refusals(tmp_path):
    """k past the device capacity is refused by the inherited validate
    (global lockstep has no host path); two processes without a process
    group are told to pass --coordinator."""
    with pytest.raises(ValueError, match="shardMode=global cannot fall back"):
        TorchEngine(TopsicleConfig(input_dir="x", output_dir=str(tmp_path),
                                   pattern="CCCTAAACC", telophrase=[16],
                                   shard_mode="global"), device="cpu")
    eng = TorchEngine(TopsicleConfig(input_dir="x", output_dir=str(tmp_path),
                                     pattern="CCCTAAA", shard_mode="global", process_id=0,
                                     process_count=2), device="cpu")
    with pytest.raises(ValueError, match="pass --coordinator"):
        eng.run()


# ---- global mode through the JAX suite's own cases ----------------------------

def _aggregate_lines(out):
    return [ln.split("]")[1] for ln in (out / "topsicle_run.log").read_text().splitlines()
            if "median telomere" in ln or "recommended" in ln]


def test_global_mode_resume_byte_identical(tmp_path):
    """tests/test_resume.py::test_global_mode_resume_byte_identical on the
    torch engine: drop file b's unit from the manifest of a global run;
    the resumed CSV and aggregate lines equal the uninterrupted run's,
    which equal JaxEngine's global run and the oracle."""
    rng = random.Random(11)
    d = tmp_path / "in"
    d.mkdir()
    _write_resume_file(str(d / "a.fastq.gz"), rng, 6)
    _write_resume_file(str(d / "b.fastq.gz"), rng, 6)
    out = tmp_path / "out"
    kw = dict(input_dir=str(d), pattern="CCCTAAA", slide=6, batch_size=8)
    glob = dict(kw, output_dir=str(out), shard_mode="global")
    TorchEngine(TopsicleConfig(**glob), device="cpu").run()
    csv1 = (out / "telolengths_all.csv").read_bytes()
    lines1 = _aggregate_lines(out)
    m = RunManifest(str(out))
    key_b = [k for k in m._done if "b.fastq" in k]
    assert key_b, "global mode must mark units done for resume"
    del m._done[key_b[0]]
    m.mark_done(str(d / "a.fastq.gz"), 5, m.rows_for(str(d / "a.fastq.gz"), 5))
    TorchEngine(TopsicleConfig(resume=True, **glob), device="cpu").run()
    assert (out / "telolengths_all.csv").read_bytes() == csv1
    assert "resume: skipping completed unit" in (out / "topsicle_run.log").read_text()
    assert lines1 and _aggregate_lines(out)[-len(lines1):] == lines1
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), shard_mode="global", **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    assert csv1 == (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
        (tmp_path / "o" / "telolengths_all.csv").read_bytes()
    assert csv1.count(b"\n") > 6


def test_global_mode_extras_match_files_mode(tmp_path):
    """tests/test_pipeline.py::test_global_mode_extras_match_files_mode on
    the torch engine (synthetic input: the demo file is not in the
    repository): --rawcountpattern and --plot in --shardMode global give
    the files-mode artifacts, rawcount CSVs byte for byte, and JaxEngine's
    global ones."""
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(13), n_reads=12)
    kw = dict(input_dir=str(data), pattern="CCCTAAA", slide=6, batch_size=8,
              rawcountpattern=True, plot=True)
    def csvs(out):
        return {p.name: p.read_bytes() for p in sorted(out.glob("*.csv"))}

    outs = {}
    for mode in ("files", "global"):
        TorchEngine(TopsicleConfig(output_dir=str(tmp_path / mode), shard_mode=mode, **kw),
                    device="cpu").run()
        outs[mode] = csvs(tmp_path / mode)
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), shard_mode="global", **kw)).run()
    outs["jax"] = csvs(tmp_path / "j")
    raw = [n for n in outs["files"] if n.startswith("rawcount_")]
    assert len(raw) >= 2
    assert outs["files"] == outs["global"] == outs["jax"]
    plots = sorted(p.name for p in (tmp_path / "files").glob("plot_*.png"))
    assert plots and plots == sorted(p.name for p in (tmp_path / "global").glob("plot_*.png")) \
        == sorted(p.name for p in (tmp_path / "j").glob("plot_*.png"))


def test_global_mode_skips_stray_file(tmp_path):
    """tests/test_reader_envelope.py::test_global_mode_skips_stray_file on
    the torch engine: the same logged skip, the good file's two rows, and
    the CSV of JaxEngine's global run and of the oracle on the good file
    alone."""
    indir = tmp_path / "in"
    indir.mkdir()
    _good_fastq(indir / "good.fastq")
    (indir / "stray.txt").write_text("not sequence data\n")
    kw = dict(input_dir=str(indir), pattern="CCCTAAA", slide=6, batch_size=8,
              shard_mode="global", native_io=False)
    results = TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw),
                          device="cpu").run()
    assert len(results) == 2
    log_text = (tmp_path / "t" / "topsicle_run.log").read_text()
    assert "skipping this file" in log_text and "stray.txt" in log_text
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    OracleEngine(TopsicleConfig(input_dir=str(indir / "good.fastq"),
                                output_dir=str(tmp_path / "o"), pattern="CCCTAAA",
                                slide=6)).run()
    got = (tmp_path / "t" / "telolengths_all.csv").read_bytes()
    assert got == (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
        (tmp_path / "o" / "telolengths_all.csv").read_bytes()


def test_global_mode_mixed_table(tmp_path):
    """--shardMode global on CCCTAA k=5 (2 of 12 entries periodic): every
    process's model takes the greedy kernel; the CSV and subsets equal
    JaxEngine's global run and the oracle."""
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(6), n_reads=24, pattern="CCCTAA")
    kw = dict(input_dir=str(data), pattern="CCCTAA", slide=6, telophrase=[5])
    TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), batch_size=8,
                               shard_mode="global", **kw), device="cpu").run()
    assert TorchScanModel(telophrase_kmers("CCCTAA", 5), device="cpu").kernel == "greedy"
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=8,
                             shard_mode="global", **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    got = _outputs(tmp_path / "t")
    assert got == _outputs(tmp_path / "j") == _outputs(tmp_path / "o")
    assert got["telolengths_all.csv"].count(b"\n") > 4 and len(got) == 2
