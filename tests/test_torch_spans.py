"""The port's spans and counters (utils/profiling.py): the CLI's `spans:` and
`counters:` lines after the closing line, the `stages:` line's three stages,
phases that are disjoint and lie inside the job, the span tree in a CPU
torch.profiler trace, no record_function entered without a profiler, the
reader counters against the input file and the CSV for both readers, a
sweep's block-cache counters and replay wait, and the benchmark's readers of
the two lines (portbench/metrics/)."""

import gzip
import json
import math
import os
import random
import struct

import pytest
import torch

from portbench import run as portbench_run
from portbench import spans as portbench_spans
from tests.test_pipeline import _write_synthetic_fastq
from topsicle_tpu_torch import cli
from topsicle_tpu_torch.config import TopsicleConfig
from topsicle_tpu_torch.pipeline import TorchEngine
from topsicle_tpu_torch.utils import profiling
from topsicle_tpu_torch.utils.profiling import StageTimers

PHASES = portbench_spans.PHASES
# every span of a files-mode job and the span it opens inside
PARENT = {"job": None, "setup": "job", "model": "job", "unit": "job", "emit": "job",
          "aggregate": "job", "aggregate.plot": "aggregate",
          "reader_wait": "unit", "step1": "unit", "step2": "unit", "rows": "unit",
          "subset": "unit",
          "step1.launch": "step1", "step1.wait": "step1", "step1.select": "step1",
          "step2.pack": "step2", "step2.launch": "step2", "step2.wait": "step2"}
READERS = ["span_share.reader_wait", "span_share.setup", "span_share.output",
           "span_share.unspanned", "span_share.device_wait", "reader.mbp_per_busy_s",
           "step2.useful_share", "subset.reread_share", "subset.kept_share",
           "reader.inflate_mb_per_s", "reader.inflate_share"]
MIN_LEN = 9000


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """tests/test_pipeline.py's 40-read input (rng 99): 5 reads at or
    under minSeqLength, telomeric reads on both ends."""
    data = tmp_path_factory.mktemp("spans") / "synthetic.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(99))
    return data


def _file_counts(path):
    """(records, bases, records at or under MIN_LEN) of a 4-line FASTQ."""
    with (gzip.open if str(path).endswith(".gz") else open)(path, "rt") as fh:
        seqs = [ln.strip() for i, ln in enumerate(fh) if i % 4 == 1]
    return len(seqs), sum(map(len, seqs)), sum(len(s) <= MIN_LEN for s in seqs)


def _csv_rows(out):
    with open(os.path.join(out, "telolengths_all.csv")) as fh:
        return len(fh.read().splitlines()) - 1


def _line(log, tag):
    return [ln for ln in log.splitlines() if f"] {tag}: " in ln][-1].split(f"{tag}: ", 1)[1]


def _named(part_list):
    return {p.split("=", 1)[0]: p.split("=", 1)[1] for p in part_list.split(", ")}


@pytest.fixture(scope="module")
def cli_runs(synthetic, tmp_path_factory):
    """The CLI on the CPU, once with no profiler and once under a CPU
    torch.profiler, each with record_function wrapped to count its entries
    and cli's recorder kept: {mode: (out dir, recorder, entries, trace)}."""
    base = tmp_path_factory.mktemp("cli")
    real = torch.autograd.profiler.record_function
    made = []
    entered = []

    def counting(*a, **k):
        entered.append(a[0] if a else k.get("name"))
        return real(*a, **k)

    class Kept(StageTimers):
        def __init__(self):
            super().__init__()
            made.append(self)

    runs = {}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.autograd.profiler.record_function = counting
    cli.StageTimers = Kept
    try:
        for mode in ("plain", "profiled"):
            out = str(base / mode)
            argv = ["--inputDir", str(synthetic), "--outputDir", out, "--pattern", "CCCTAAA",
                    "--slide", "6", "--batchSize", "8", "--device", "cpu"]
            entered.clear()
            trace = None
            if mode == "plain":
                assert cli.main(argv) == 0
            else:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    assert cli.main(argv) == 0
                path = str(base / "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as fh:
                    trace = json.load(fh)["traceEvents"]
            runs[mode] = (out, made[-1], list(entered), trace)
    finally:
        torch.autograd.profiler.record_function = real
        cli.StageTimers = StageTimers
        torch.set_num_threads(prev)
    return runs


@pytest.mark.parametrize("mode", ["plain", "profiled"])
def test_cli_spans_and_counters_lines(cli_runs, synthetic, mode):
    out, rec, entered, _ = cli_runs[mode]
    with open(os.path.join(out, "topsicle_run.log")) as fh:
        log = fh.read()
    tail = [ln.split("] ", 1)[1] for ln in log.splitlines()[-3:]]
    assert tail[0] == "All telomere found, have a nice day."
    assert tail[1].startswith("spans: ") and tail[2].startswith("counters: ")
    stages = _line(log, "stages").split(";")[0]
    assert [p.split("=")[0] for p in stages.split(", ")] == ["step1", "step2", "subset"]
    # the stages line counts the input (every record), as mbp_per_s does
    records, bases, short = _file_counts(synthetic)
    assert f"; {records} reads, {bases / 1e6:.1f} Mbp, " in _line(log, "stages")
    spans = {n: float(v.split("s/")[0]) for n, v in _named(_line(log, "spans")).items()}
    assert set(spans) == set(PARENT)
    assert sum(spans[n] for n in PHASES) <= spans["job"] + 1e-3
    assert spans["job"] == pytest.approx(rec.seconds["job"], abs=1e-3)
    counters = _named(_line(log, "counters"))
    assert int(counters["reads.in"]) == records and int(counters["reads.short"]) == short
    assert int(counters["reads.passed"]) == _csv_rows(out) > 0
    # record_function only under a profiler, and then once a span
    if mode == "plain":
        assert entered == [] and rec.records == []
    else:
        assert sorted(entered) == sorted(f"stage.{r.name}" for r in rec.records)
        assert len(rec.records) == sum(rec.calls.values())


def test_spans_nest_in_the_trace(cli_runs):
    """Every span is in the profiler's trace as stage.<name>, inside a
    stage.<parent> of the tree; the recorder's records agree, and the
    phases are disjoint and inside the job."""
    _, rec, _, trace = cli_runs["profiled"]
    ev = [(e["name"][6:], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in trace if e.get("ph") == "X" and e.get("cat") == "user_annotation"
          and e.get("name", "").startswith("stage.")]
    assert {n for n, _, _ in ev} == set(PARENT)
    for name, a, b in ev:
        if PARENT[name] is not None:
            assert any(n == PARENT[name] and pa <= a and b <= pb for n, pa, pb in ev), name
    for r in rec.records:
        assert (r.parent.name if r.parent else None) == PARENT[r.name]
        assert r.start <= r.end
    phases = sorted((r.start, r.end) for r in rec.records if r.name in PHASES)
    assert all(a1 >= b0 for (_, b0), (a1, _) in zip(phases, phases[1:]))
    job = [r for r in rec.records if r.name == "job"][0]
    assert job.start <= phases[0][0] and phases[-1][1] <= job.end


@pytest.mark.parametrize("phrases,cache_mb,repeated,plain",
                         [([5], None, False, False), ([4, 5], None, False, False),
                          ([4, 5], "0", False, False), ([5], None, True, False),
                          ([5], None, False, True)],
                         ids=["k5", "k4-5-cached", "k4-5-parsed-again", "k5-repeated-id",
                              "k5-plain"])
@pytest.mark.parametrize("native_io", [False, True], ids=["python", "native"])
def test_reader_counters_match_input_and_csv(synthetic, tmp_path, monkeypatch, native_io,
                                             phrases, cache_mb, repeated, plain):
    """The input is counted once a run, whether a later phrase replays it
    from the block cache or, with the cache off, parses it again.  The
    C++ reader's subset comes from the first parse; a short record that
    repeats a passing read's id (`repeated`) makes the writer read the
    input again.  The C++ reader's inflate makes every byte of the text
    (the input's ISIZE) inside the reader's busy time, and nothing from
    plain input; the Python reader counts no inflate."""
    if cache_mb is not None:
        monkeypatch.setenv("TOPSICLE_BLOCK_CACHE_MB", cache_mb)
    if repeated or plain:
        data = tmp_path / "in" / ("synthetic.fastq" if plain else "synthetic.fastq.gz")
        data.parent.mkdir()
        with gzip.open(synthetic, "rb") as src:
            text = src.read()
        if repeated:
            text += b"@read0 short, same id\nACGT\n+\nIIII\n"
        data.write_bytes(text if plain else gzip.compress(text))
        synthetic = data
    timers = StageTimers()
    cfg = TopsicleConfig(input_dir=str(synthetic), output_dir=str(tmp_path / "out"),
                         pattern="CCCTAAA",
                         slide=6, batch_size=8, native_io=native_io, min_seq_length=MIN_LEN,
                         telophrase=phrases)
    engine = TorchEngine(cfg, device="cpu", timers=timers)
    assert engine._bc_enabled == (len(phrases) > 1 and cache_mb is None)
    engine.run()
    records, bases, short = _file_counts(synthetic)
    c = timers.counters
    if not native_io:
        assert "reader.inflate_s" not in c and "reader.inflated_bytes" not in c
    elif plain:
        assert c["reader.inflated_bytes"] == 0
    else:
        with open(synthetic, "rb") as fh:
            isize = struct.unpack("<I", fh.read()[-4:])[0]
        assert c["reader.inflated_bytes"] == isize
        assert 0 < c["reader.inflate_s"] <= c["reader.busy_s"]
    assert timers.calls["unit"] == len(phrases)
    assert (c["reads.in"], c["bases.in"], c["reads.short"]) == (records, bases, short)
    assert c["reads.passed"] == _csv_rows(str(tmp_path / "out")) > 0
    assert 0 < c["step2.bases_work"] <= c["step2.bases_launched"]
    assert c["step2.bases_launched"] % (8 * cfg.static_scan_length()) == 0
    assert c["reader.busy_s"] > 0
    # one file: its subset is written in the first phrase, found in the second
    kept = native_io and not repeated
    assert (c.get("subset.kept_files", 0), c.get("subset.reread_files", 0)) == \
        ((1, 0) if kept else (0, 1))
    # the C++ writer's clock, where it re-reads
    assert ("subset.reread_s" in c) == (native_io and repeated)
    if native_io and repeated:
        assert 0 < c["subset.reread_s"] <= timers.seconds["subset"]


@pytest.mark.parametrize("name", READERS)
def test_metric_reader_on_a_run_log(cli_runs, tmp_path, name):
    """Each new per-layer reader gives a number on a run log with the two
    lines, and nothing on one without them (a program that predates
    them)."""
    out, rec, _, _ = cli_runs["plain"]
    read = portbench_run.load_reader(name)

    class Ctx:
        jobs = [{"out": out, "wall_s": rec.seconds["job"]}]
    v = read(Ctx)
    assert isinstance(v, float) and math.isfinite(v) and v >= 0
    if name.startswith("span_share.") or name.endswith("_share"):
        assert v <= 100
    with open(os.path.join(out, "topsicle_run.log")) as fh:
        old = [ln for ln in fh if "] spans: " not in ln and "] counters: " not in ln]
    (tmp_path / "topsicle_run.log").write_text("".join(old))
    Ctx.jobs = [{"out": str(tmp_path), "wall_s": 1.0}]
    assert read(Ctx) is None


def _eligible_bases(path):
    with gzip.open(path, "rt") as fh:
        return sum(len(s) for s in (ln.strip() for i, ln in enumerate(fh) if i % 4 == 1)
                   if len(s) > MIN_LEN)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The CLI on the CPU on a human-repeat input, one job a phrase list,
    under a CPU torch.profiler so that each span is recorded with its
    parent: {phrases: (out dir, the job's recorder)}."""
    from torch.profiler import ProfilerActivity, profile

    base = tmp_path_factory.mktemp("sweeps")
    data = base / "human.fastq.gz"
    _write_synthetic_fastq(str(data), random.Random(7), n_reads=160, pattern="CCCTAA")
    made = []

    class Kept(StageTimers):
        def __init__(self):
            super().__init__()
            made.append(self)

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    cli.StageTimers = Kept
    runs = {"input": data}
    try:
        for phrases in ((5,), (4, 5), (4, 5, 6)):
            out = str(base / "-".join(map(str, phrases)))
            argv = ["--inputDir", str(data), "--outputDir", out, "--pattern", "CCCTAA",
                    "--slide", "6", "--batchSize", "8", "--device", "cpu",
                    "--telophrase", *map(str, phrases)]
            with profile(activities=[ProfilerActivity.CPU]):
                assert cli.main(argv) == 0
            runs[phrases] = (out, made[-1])
    finally:
        cli.StageTimers = StageTimers
        torch.set_num_threads(prev)
    return runs


BLOCKCACHE = ("blockcache.write_s", "blockcache.bytes_written", "blockcache.replay_s",
              "blockcache.bases_replayed", "blockcache.bytes_replayed")


@pytest.mark.parametrize("phrases", [(5,), (4, 5), (4, 5, 6)],
                         ids=["one-phrase", "two-phrases", "three-phrases"])
def test_block_cache_counters_and_replay_wait(sweeps, phrases):
    """A sweep's first phrase writes the block cache and every later phrase
    replays all of it: as many bytes back as went in (two and three phrases
    write the same first phrase), and the file's eligible bases each time.
    The main thread's wait on a replaying source is replay_wait, and only
    there; a one-phrase job has no block-cache counter and no replay_wait."""
    out, timers = sweeps[phrases]
    c = timers.counters
    units = sorted((r for r in timers.records if r.name == "unit"), key=lambda r: r.start)
    assert len(units) == len(phrases)
    waits = [{r.name for r in timers.records if r.parent is u and r.name.endswith("_wait")}
             for u in units]
    assert waits == [{"reader_wait"}] + [{"replay_wait"}] * (len(phrases) - 1)
    if len(phrases) == 1:
        assert not set(BLOCKCACHE) & set(c) and "replay_wait" not in timers.calls
        return
    later = len(phrases) - 1
    written = sweeps[(4, 5)][1].counters["blockcache.bytes_written"]
    assert c["blockcache.bytes_written"] == written > 0
    assert c["blockcache.bytes_replayed"] == later * written
    assert c["blockcache.bases_replayed"] == later * _eligible_bases(sweeps["input"]) > 0
    assert c["blockcache.write_s"] > 0 and c["blockcache.replay_s"] > 0
    with open(os.path.join(out, "topsicle_run.log")) as fh:
        log = fh.read()
    counters = _named(_line(log, "counters"))
    assert int(counters["blockcache.bytes_replayed"]) == later * written
    assert "replay_wait" in _named(_line(log, "spans"))
    # the engine deletes the cache at the job's end
    assert not os.path.exists(os.path.join(out, ".blockcache"))


@pytest.mark.parametrize("mem_bytes,on_disk", [(None, False), (0, True), (100, True)],
                         ids=["memory", "disk", "spilled"])
def test_block_cache_tiers_replay_the_same_blocks(sweeps, tmp_path, monkeypatch, mem_bytes,
                                                  on_disk):
    """A three-phrase job's CSV is the same whether its block cache is held
    in memory, kept on disk, or spills to disk part way through the file
    (a memory budget of 100 bytes), and the same as parsing every phrase
    again; only the last two write a disk entry, and every tier hands back
    what went in."""
    from topsicle_tpu_torch.io import blockcache

    if mem_bytes is not None:
        monkeypatch.setattr(blockcache, "MEMORY_BUDGET_BYTES", mem_bytes)
    opened = []
    monkeypatch.setattr(blockcache.BlockCacheWriter, "_open",
                        lambda self, _open=blockcache.BlockCacheWriter._open:
                        (opened.append(self._input_path), _open(self))[1])

    def csv(name, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        timers = StageTimers()
        cfg = TopsicleConfig(input_dir=str(sweeps["input"]), output_dir=str(tmp_path / name),
                             pattern="CCCTAA", slide=6, batch_size=8, telophrase=[4, 5, 6])
        TorchEngine(cfg, device="cpu", timers=timers).run()
        assert not os.path.exists(os.path.join(str(tmp_path / name), ".blockcache"))
        with open(os.path.join(str(tmp_path / name), "telolengths_all.csv"), "rb") as fh:
            return fh.read(), timers.counters

    got, c = csv("tier")
    assert opened == ([str(sweeps["input"])] if on_disk else [])
    assert c["blockcache.bytes_replayed"] == 2 * c["blockcache.bytes_written"] > 0
    assert c["blockcache.bases_replayed"] == 2 * _eligible_bases(sweeps["input"])
    want, c = csv("parsed", TOPSICLE_BLOCK_CACHE_MB="0")
    assert got == want and not any(k.startswith("blockcache.") for k in c)


@pytest.mark.parametrize("name", ["span_share.replay_wait", "blockcache.write_share",
                                  "blockcache.mbp_per_busy_s"])
def test_block_cache_readers(sweeps, name):
    """The sweep's readers give a number on a three-phrase job's run log
    and nothing on a one-phrase job's.  The replays' wait may round to
    0.000 s in the spans line: the main thread rarely waits on them."""
    read = portbench_run.load_reader(name)

    def ctx(phrases):
        out, timers = sweeps[phrases]

        class Ctx:
            jobs = [{"out": out, "wall_s": timers.seconds["job"] or 1.0}]
        return Ctx
    v = read(ctx((4, 5, 6)))
    assert isinstance(v, float) and math.isfinite(v)
    assert v >= 0 if name == "span_share.replay_wait" else v > 0
    assert read(ctx((5,))) is None


def test_recorder_totals_lines_and_counts():
    t = StageTimers()
    for _ in range(2):
        with t.span("unit"):
            with t.stage("step1"):
                pass
    t.add("reads.in", 3)
    t.add("bases.in", 2_000_000)
    t.add("reads.short", 1)
    t.add("reader.busy_s", 0.25)
    assert (t.calls["unit"], t.calls["step1"]) == (2, 2)
    assert t.summary().startswith("stages: step1=0.00s/2x; wall ")
    assert "3 reads, 2.0 Mbp" in t.summary()
    assert t.spans_line().startswith("spans: step1=0.000s/2x, unit=0.000s/2x")
    assert t.counters_line() == ("counters: bases.in=2000000, reader.busy_s=0.250000, "
                                 "reads.in=3, reads.short=1")
    assert t.records == [] and profiling.STAGES == ("step1", "step2", "subset")


def test_counters_from_threads_lose_no_update():
    """The readers add counters from their own threads: under a short
    switch interval, 16 threads' adds and counts all land."""
    import sys
    import threading

    t = StageTimers()

    def work():
        for _ in range(2000):
            t.add("reads.short")
            t.add("reads.in")
            t.add("bases.in", 3)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    assert (t.counters["reads.short"], t.counters["reads.in"], t.counters["bases.in"]) == \
        (32000, 32000, 96000)
