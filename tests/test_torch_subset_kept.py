"""The subset file written from the first parse (TorchEngine with the C++
reader: the reader keeps each eligible read's header and quality beside its
codes, and the unit appends each block's passing records to <subset>.tmp).
It must equal, byte for byte, the re-read's (write_subset_native) and
JaxEngine's, on FASTQ and FASTA inputs under either extension, gzipped or
plain, with CRLF line ends, sequences over several lines, bases that are not
plain ACGT, headers with spaces and tabs and a read exactly at minSeqLength,
at batch sizes whose block edges fall inside and outside runs of passing
reads.  Where a passing id names more than one record the writer reads the
input again; a truncated gzip leaves neither a subset nor a .tmp; an
existing subset is left as it is, with the same log lines; a second phrase
finds the first one's subset."""

import gzip
import os
import random
import re

import numpy as np
import pytest
import torch

from topsicle_tpu.config import TopsicleConfig as JaxConfig
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu_torch import native as t_native
from topsicle_tpu_torch.config import TopsicleConfig
from topsicle_tpu_torch.io import reader, writer
from topsicle_tpu_torch.pipeline import TorchEngine
from topsicle_tpu_torch.utils.profiling import StageTimers

MIN_LEN = 1000
KW = dict(pattern="CCCTAAA", slide=6, min_seq_length=MIN_LEN, maxlengthtelo=4000)
# reads 0..29: 1 = a telomere at its start (passes step 1); runs of 1-4
PASSES = [1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 0,
          1, 1, 1, 0, 1, 0, 0, 0, 1, 1]
IUPAC = "RYKMSWBDHV"


@pytest.fixture(autouse=True)
def _native_and_one_thread():
    if not t_native.native_available():
        pytest.skip("no C++ toolchain or zlib: the C++ reader cannot be built")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _records(seed=7):
    """[(header, seq, qual)]: PASSES' reads, every fifth lowercase, with N's
    or with IUPAC letters (not plain) in turn, headers with spaces and tabs
    or none; after read 12 one telomeric read exactly MIN_LEN long (short);
    qualities that may open with '@' or '+'."""
    rng = random.Random(seed)
    out = []
    for i, telo in enumerate(PASSES):
        n = rng.randrange(MIN_LEN + 1, 3000)
        seq = [rng.choice("ACGT") for _ in range(n)]
        if telo:
            seq[:1000] = ("CCCTAAA" * 143)[:1000]
        kind = i % 5
        if kind == 2:
            for j in rng.sample(range(n), 12):
                seq[j] = "N"
        elif kind == 3:
            for j in rng.sample(range(n), 12):
                seq[j] = rng.choice(IUPAC)
        seq = "".join(seq)
        if kind == 1:
            seq = seq.lower()
        header = (f"r{i}", f"r{i} len={n} run=A", f"r{i}\tsample 7\tflow cell")[i % 3]
        out.append((header, seq, "".join(chr(rng.randrange(33, 75)) for _ in range(n))))
        if i == 12:
            s = ("CCCTAAA" * 143)[:MIN_LEN]
            out.append(("r12x at min length", s, "5" * MIN_LEN))
    return out


def _fastq(recs, wrap=None, eol="\n"):
    def lines(s):
        w = wrap or max(1, len(s))
        return [s[i:i + w] for i in range(0, len(s), w)] or [""]
    return "".join(eol.join([f"@{h}", *lines(s), "+", *lines(q)]) + eol for h, s, q in recs)


def _fasta(recs, wrap=50, eol="\n"):
    return "".join(eol.join([f">{h}"] + [s[i:i + wrap] for i in range(0, len(s), wrap)]) + eol
                   for h, s, _ in recs)


# name -> (file name, text): the output's format follows the file name
CASES = {
    "fastq_gz": ("reads.fastq.gz", lambda r: _fastq(r)),
    "fastq_plain": ("reads.fq", lambda r: _fastq(r)),
    "fastq_wrapped_crlf": ("reads.fastq", lambda r: _fastq(r, wrap=70, eol="\r\n")),
    "fasta_gz_wrapped": ("reads.fa.gz", lambda r: _fasta(r, wrap=50)),
    "fasta_as_fastq": ("reads.fastq", lambda r: _fasta(r, wrap=80, eol="\r\n")),
    "fastq_as_fasta": ("reads.fasta", lambda r: _fastq(r, wrap=100)),
}


def _write(path, text):
    data = text.encode()
    if str(path).endswith(".gz"):
        data = gzip.compress(data)
    path.write_bytes(data)
    return path


def _run(inp, out, batch_size=8, **kw):
    """TorchEngine on the CPU with the C++ reader: (its recorder, the
    subset bytes or None)."""
    timers = StageTimers()
    cfg = TopsicleConfig(input_dir=str(inp), output_dir=str(out), batch_size=batch_size,
                         native_io=True, **{**KW, **kw})
    TorchEngine(cfg, device="cpu", timers=timers).run()
    return timers, _subset(out, inp)


def _subset(out, inp):
    path = writer.subset_path(str(out), str(inp), 0.7)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()


def _passing_ids(out):
    with open(os.path.join(out, "telolengths_all.csv")) as fh:
        return [ln.split(",")[3] for ln in fh.read().splitlines()[1:]]


def _reread(inp, out, tmp_path):
    """write_subset_native's bytes for the run's passing ids."""
    dest = str(tmp_path / "reread.out")
    fastq_out = writer.subset_path("", str(inp), 0.7).endswith(".fastq")
    t_native.write_subset_native(str(inp), dest, sorted(set(_passing_ids(out))), fastq_out)
    with open(dest, "rb") as fh:
        return fh.read()


_JAX = {}


def _jax_subset(inp, out):
    """JaxEngine's subset of `inp` (batch 8), once a distinct input."""
    key = (os.path.basename(str(inp)), open(inp, "rb").read())
    if key not in _JAX:
        JaxEngine(JaxConfig(input_dir=str(inp), output_dir=str(out), batch_size=8,
                            **KW)).run()
        _JAX[key] = _subset(out, inp)
    return _JAX[key]


@pytest.mark.parametrize("batch_size", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_subset_equals_reread_and_jax(case, batch_size, tmp_path):
    name, text = CASES[case]
    recs = _records()
    inp = _write(tmp_path / name, text(recs))
    timers, got = _run(inp, tmp_path / "t", batch_size)
    c = timers.counters
    assert (c.get("subset.kept_files"), c.get("subset.reread_files")) == (1, None)
    assert "subset.reread_s" not in c
    ids = _passing_ids(tmp_path / "t")
    assert len(ids) == sum(PASSES)      # the read at minSeqLength is not eligible
    # passing reads that are not plain: lowercase, N and IUPAC letters
    assert {i % 5 for i in range(len(PASSES)) if PASSES[i] and f"r{i}" in ids} >= {1, 2, 3}
    assert got == _reread(inp, tmp_path / "t", tmp_path)
    assert got == _jax_subset(inp, tmp_path / "j")
    text_out = got.decode()
    assert "\r" not in text_out and "\tsample 7\tflow cell\n" in text_out
    if name.endswith((".fa.gz", ".fasta")):
        assert max(len(ln) for ln in text_out.splitlines() if not ln.startswith(">")) == 60
    elif case == "fasta_as_fastq":
        assert "\n+\n" + "I" * 50 in text_out


@pytest.mark.parametrize("extra", ["short", "eligible"])
def test_repeated_id_reads_the_input_again(extra, tmp_path):
    """A passing read's id on a short record, or on a second eligible
    record that fails step 1: the re-read writes both records, and so does
    the writer, which reads the input again."""
    recs = _records()
    if extra == "short":
        recs.append(("r1 again, short", "ACGT", "IIII"))
    else:
        rng = random.Random(3)
        n = MIN_LEN + 500
        recs.insert(5, ("r2 again", "".join(rng.choice("ACGT") for _ in range(n)), "#" * n))
    inp = _write(tmp_path / "reads.fastq.gz", _fastq(recs))
    timers, got = _run(inp, tmp_path / "t", 3)
    c = timers.counters
    assert (c.get("subset.kept_files"), c["subset.reread_files"]) == (None, 1)
    assert 0 < c["subset.reread_s"] <= timers.seconds["subset"]
    assert got == _reread(inp, tmp_path / "t", tmp_path) == _jax_subset(inp, tmp_path / "j")
    assert got.count(b" again") == 1


def test_truncated_gzip_leaves_no_subset_and_no_tmp(tmp_path):
    data = gzip.compress(_fastq(_records()).encode())
    inp = tmp_path / "reads.fastq.gz"
    inp.write_bytes(data[: len(data) * 2 // 3])
    out = tmp_path / "t"
    timers, got = _run(inp, out, 1)
    assert got is None
    assert not [f for f in os.listdir(out) if "_trc_over_" in f]
    with open(out / "topsicle_run.log") as fh:
        assert "skipping this file" in fh.read()


def _log(out):
    """The run log without timestamps, the output directory's name and
    the lines that hold times."""
    with open(os.path.join(out, "topsicle_run.log")) as fh:
        lines = [re.sub(r"^\[[^]]*\] ", "", ln.rstrip("\n")) for ln in fh]
    return [ln.replace(str(out), "<out>") for ln in lines
            if not ln.startswith(("stages: ", "spans: ", "counters: "))]


@pytest.mark.parametrize("existing", [False, True], ids=["new", "existing"])
def test_log_lines_as_the_reread_gives_them(existing, tmp_path, monkeypatch):
    """The run log's lines, in order, are the re-read's; an existing subset
    is left byte for byte."""
    inp = _write(tmp_path / "reads.fastq.gz", _fastq(_records()))
    logs, subsets = [], []
    for reread in (False, True):
        out = tmp_path / ("reread" if reread else "kept")
        out.mkdir()
        if existing:
            with open(writer.subset_path(str(out), str(inp), 0.7), "wb") as fh:
                fh.write(b"@kept\nACGT\n+\nIIII\n")
        if reread:      # the unit writes no subset as it goes
            monkeypatch.setattr(TorchEngine, "_unit_source",
                                lambda self, path: (self._read_source(path), None))
        timers, got = _run(inp, out, 3)
        c = timers.counters
        assert c.get("subset.kept_files", 0) == (0 if existing or reread else 1)
        assert c.get("subset.reread_files", 0) == (1 if reread and not existing else 0)
        assert not os.path.exists(writer.subset_path(str(out), str(inp), 0.7) + ".tmp")
        logs.append(_log(out))
        subsets.append(got)
    assert logs[0] == logs[1]
    assert subsets[0] == subsets[1]
    if existing:
        assert subsets[0] == b"@kept\nACGT\n+\nIIII\n"
        assert any("already exists" in ln and "Using existing file" in ln for ln in logs[0])


def test_second_phrase_finds_the_subset(tmp_path):
    """Two phrases with the block cache: the first writes the subset from
    its parse, the second replays the cache and finds the subset there."""
    inp = _write(tmp_path / "reads.fastq.gz", _fastq(_records()))
    timers, got = _run(inp, tmp_path / "t", 8, telophrase=[4, 5])
    c = timers.counters
    assert (c.get("subset.kept_files"), c.get("subset.reread_files")) == (1, None)
    log = _log(tmp_path / "t")
    assert sum("Temporary fasta file with TRC more than" in ln for ln in log) == 1
    assert sum("Using existing file" in ln for ln in log) == 1
    assert got == _reread(inp, tmp_path / "t", tmp_path)


def test_kept_files_count_every_file(tmp_path):
    """Three files of a directory, two of them read ahead: each subset is
    written from its first parse."""
    d = tmp_path / "in"
    d.mkdir()
    recs = _records()
    for case in ("fastq_gz", "fasta_gz_wrapped", "fastq_plain"):
        name, text = CASES[case]
        _write(d / f"{case}.{name.split('.', 1)[1]}", text(recs))
    timers, _ = _run(d, tmp_path / "t", 8, threads=3)
    c = timers.counters
    assert (c.get("subset.kept_files"), c.get("subset.reread_files")) == (3, None)
    for f in os.listdir(d):
        assert _subset(tmp_path / "t", d / f) == _reread(d / f, tmp_path / "t", tmp_path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_blocks_hold_the_same_codes_and_the_records(case, tmp_path):
    """keep_records changes no block's ids, codes or offsets, and its
    Records hold each eligible read's header, quality (FASTQ input),
    whether it is plain and, where it is not, its bases."""
    name, text = CASES[case]
    inp = str(_write(tmp_path / name, text(_records())))

    def blocks(keep):
        rd = t_native.NativeReader(inp, MIN_LEN, batch_reads=3, keep_records=keep)
        try:
            return list(rd.iter_blocks())
        finally:
            rd.close()

    plain, kept = blocks(False), blocks(True)
    assert all(b.records is None for b in plain)
    want = [r for r in reader.parse_records(inp) if len(r.seq) > MIN_LEN]
    fastq_in = reader.sniff_format(inp) == "fastq"
    got = []
    for a, b in zip(plain, kept, strict=True):
        assert a.ids == b.ids
        assert np.array_equal(a.codes, b.codes) and np.array_equal(a.offs, b.offs)
        rec = b.records
        assert (rec.quals is not None) == fastq_in
        for i in range(len(b)):
            lo, hi = b.offs[i], b.offs[i + 1]
            header = bytes(rec.headers[rec.header_offs[i]:rec.header_offs[i + 1]]).decode()
            raw = bytes(rec.raw[rec.raw_offs[i]:rec.raw_offs[i + 1]]).decode()
            seq = "".join("ACGT"[c] for c in b.codes[lo:hi]) if rec.plain[i] else raw
            qual = None if rec.quals is None else bytes(rec.quals[lo:hi]).decode()
            assert bool(rec.plain[i]) == (raw == "")
            got.append((header, seq, qual, bool(rec.plain[i])))
    assert got == [(r.header, r.seq, r.qual, set(r.seq) <= set("ACGT")) for r in want]
    assert {p for *_, p in got} == {True, False}


def _smaps():
    """/proc/self/smaps's mappings: [(start, end, set of VmFlags)]."""
    out = []
    with open("/proc/self/smaps") as fh:
        for ln in fh:
            m = re.match(r"([0-9a-f]+)-([0-9a-f]+) ", ln)
            if m:
                span = (int(m.group(1), 16), int(m.group(2), 16))
            elif ln.startswith("VmFlags:"):
                out.append((*span, set(ln.split()[1:])))
    return out


def _no_huge_bytes():
    """The bytes of this process's mappings that take no huge pages."""
    return sum(hi - lo for lo, hi, flags in _smaps() if "nh" in flags)


@pytest.mark.parametrize("case", ["fastq_gz", "fasta_gz_wrapped"])
def test_block_arrays_are_private_mappings_of_small_pages(case, tmp_path):
    """A block's codes and qualities lie in private mappings (pages a
    block does not fill are freed for real, and VmRSS counts each
    resident page) that take no huge pages (which would hold up to 2 MB
    past the block's bytes), a mapping of its own each."""
    if not os.path.exists("/proc/self/smaps"):
        pytest.skip("no /proc/self/smaps to read a mapping's flags from")
    name, text = CASES[case]
    inp = str(_write(tmp_path / name, text(_records())))
    before = _no_huge_bytes()
    rd = t_native.NativeReader(inp, MIN_LEN, batch_reads=3, keep_records=True)
    try:
        blocks = list(rd.iter_blocks())
    finally:
        rd.close()
    arrays = [b.codes for b in blocks] + [b.records.quals for b in blocks
                                          if b.records.quals is not None]
    fastq_in = reader.sniff_format(inp) == "fastq"
    assert len(arrays) == len(blocks) * (2 if fastq_in else 1) > 2
    maps = _smaps()
    for a in arrays:
        at = a.ctypes.data
        flags = [f for lo, hi, f in maps if lo <= at < hi]
        assert len(flags) == 1 and "sh" not in flags[0] and "nh" in flags[0]
    assert _no_huge_bytes() - before == len(arrays) * t_native.loader._BLOCK_BYTES


def test_a_freed_block_unmaps_its_arrays(tmp_path):
    """A block's mappings live as long as the block or a view of it, and
    not longer: the reader keeps none once its blocks are freed."""
    if not os.path.exists("/proc/self/smaps"):
        pytest.skip("no /proc/self/smaps to read the mappings from")
    size = t_native.loader._BLOCK_BYTES
    name, text = CASES["fastq_gz"]
    inp = str(_write(tmp_path / name, text(_records())))
    before = _no_huge_bytes()
    rd = t_native.NativeReader(inp, MIN_LEN, batch_reads=3, keep_records=True)
    try:
        blocks = list(rd.iter_blocks())
    finally:
        rd.close()
    assert _no_huge_bytes() == before + 2 * len(blocks) * size
    view = blocks[0].codes[:10]
    del blocks
    assert _no_huge_bytes() == before + size
    del view
    assert _no_huge_bytes() == before

