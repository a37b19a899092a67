"""The port's own copies of the framework-free host modules against the
JAX package's originals, on the same seeded inputs: config, k-mer
tables, batch assembly, aggregates, writers, the native and Python
readers, the block cache, the run manifest, part files, the oracle and
the CLI parsers.  A copy is a copy: same values, same bytes."""

import dataclasses
import difflib
import gzip
import inspect
import os
import random
import re

import numpy as np
import pytest

import topsicle_tpu.aggregate as j_aggregate
import topsicle_tpu.cli as j_cli
import topsicle_tpu.io.batch as j_batch
import topsicle_tpu.io.blockcache as j_blockcache
import topsicle_tpu.io.reader as j_reader
import topsicle_tpu.io.writer as j_writer
import topsicle_tpu.kmers as j_kmers
import topsicle_tpu.native as j_native
import topsicle_tpu.oracle.reference as j_oracle
import topsicle_tpu.parallel.distributed as j_distributed
import topsicle_tpu.plot_cli as j_plot_cli
import topsicle_tpu.utils.manifest as j_manifest
import topsicle_tpu.utils.prefetch as j_prefetch
import topsicle_tpu.utils.profiling as j_profiling
import topsicle_tpu_torch.aggregate as t_aggregate
import topsicle_tpu_torch.cli as t_cli
import topsicle_tpu_torch.io.batch as t_batch
import topsicle_tpu_torch.io.blockcache as t_blockcache
import topsicle_tpu_torch.io.reader as t_reader
import topsicle_tpu_torch.io.writer as t_writer
import topsicle_tpu_torch.kmers as t_kmers
import topsicle_tpu_torch.native as t_native
import topsicle_tpu_torch.native.loader as t_loader
import topsicle_tpu_torch.oracle.reference as t_oracle
import topsicle_tpu_torch.parallel.distributed as t_distributed
import topsicle_tpu_torch.plot_cli as t_plot_cli
import topsicle_tpu_torch.utils.manifest as t_manifest
import topsicle_tpu_torch.utils.prefetch as t_prefetch
import topsicle_tpu_torch.utils.profiling as t_profiling
from tests.test_pipeline import _write_synthetic_fastq
from topsicle_tpu.config import TopsicleConfig as JConfig
from topsicle_tpu_torch.config import TopsicleConfig as TConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(x, y):
    if isinstance(x, (tuple, list)):
        assert type(x) is type(y) and len(x) == len(y)
        for a, b in zip(x, y):
            _same(a, b)
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    else:
        assert x == y


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """12 synthetic CCCTAAA reads, gzipped FASTQ, and a FASTA of four."""
    d = tmp_path_factory.mktemp("hostcopies")
    _write_synthetic_fastq(str(d / "s.fastq.gz"), random.Random(3), n_reads=12)
    rng = random.Random(4)
    with gzip.open(d / "f.fasta.gz", "wt") as fh:
        for i in range(4):
            seq = "".join(rng.choice("ACGTN") for _ in range(rng.randrange(9100, 9900)))
            fh.write(f">fa{i} x\n" + "\n".join(seq[j:j + 60] for j in range(0, len(seq), 60))
                     + "\n")
    return d


# ---- config ----------------------------------------------------------------

_CONFIGS = [
    dict(pattern="CCCTAAA"),
    dict(pattern="CCCTAA", telophrase=[4, 5, 6], slide=3, cutoff=[0.8, 0.6], threads=3),
    dict(pattern="CCCTAAACC", telophrase=[16], maxlengthtelo=5000, trimfirst=50,
         scan_length_mode="bucket", batch_size=32, window_size=80),
]


@pytest.mark.parametrize("kw", _CONFIGS, ids=["default", "human-sweep", "k16-bucket"])
def test_config_fields_and_derived_values(kw):
    base = dict(input_dir="in", output_dir="out")
    j, t = JConfig(**base, **kw), TConfig(**base, **kw)
    assert [(f.name, f.default) for f in dataclasses.fields(j) if f.default is not
            dataclasses.MISSING] == [(f.name, f.default) for f in dataclasses.fields(t)
                                     if f.default is not dataclasses.MISSING]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in ("telophrases", "slide_value", "threads_value", "min_cutoff", "input_trc",
                 "static_scan_length"):
        assert getattr(j, name)() == getattr(t, name)(), name
    j.validate()
    t.validate()


@pytest.mark.parametrize("kw", [dict(pattern="AACC|ACCG"), dict(pattern="CCCTAAA",
                                                                telophrase=[15]),
                                dict(pattern="CCCTAAA", window_size=4)],
                         ids=["alternation", "k-past-2len", "tiny-window"])
def test_config_validate_refuses_the_same(kw):
    errs = []
    for cls in (JConfig, TConfig):
        with pytest.raises(ValueError) as e:
            cls(input_dir="in", output_dir="out", **kw).validate()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_config_input_paths(reads):
    assert JConfig(input_dir=str(reads), output_dir="o", pattern="CCCTAAA").input_paths() == \
        TConfig(input_dir=str(reads), output_dir="o", pattern="CCCTAAA").input_paths()


# ---- kmers -----------------------------------------------------------------

_TABLES = [("CCCTAAA", 5), ("CCCTAAA", 7), ("CCCTAA", 4), ("ATAT", 4), ("CCCTAAACC", 16),
           ("TTAGGG", 9)]


@pytest.mark.parametrize("fn", ["telophrase_kmers", "patterns_to_search"])
@pytest.mark.parametrize("pattern,k", _TABLES)
def test_kmer_sets(fn, pattern, k):
    _same(getattr(j_kmers, fn)(pattern, k), getattr(t_kmers, fn)(pattern, k))


@pytest.mark.parametrize("fn", ["aperiodic_mask", "all_aperiodic", "encode_kmer_codes",
                                "pack_kmer_table"])
@pytest.mark.parametrize("pattern,k", _TABLES[:4] + [("TTAGGG", 9)])
def test_kmer_tables(fn, pattern, k):
    kmers = j_kmers.telophrase_kmers(pattern, k) + ["ACGTN"[:k].ljust(k, "N")]
    _same(getattr(j_kmers, fn)(kmers), getattr(t_kmers, fn)(kmers))


def test_kmer_base_codes():
    seq = bytes(random.Random(1).choice(b"ACGTNacgtnRYK-") for _ in range(500))
    _same(j_kmers.encode_ascii(seq), t_kmers.encode_ascii(seq))
    assert j_kmers.PAD_BYTE == t_kmers.PAD_BYTE
    _same(np.asarray(j_kmers.COMPLEMENT_TABLE), np.asarray(t_kmers.COMPLEMENT_TABLE))
    assert [j_kmers.smallest_period(s) for s in ("AAAA", "ACAC", "ACGT")] == \
        [t_kmers.smallest_period(s) for s in ("AAAA", "ACAC", "ACGT")]


# ---- io.batch ----------------------------------------------------------------

def _codes(seed, B=6, L=1000):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (B, L)).astype(np.uint8)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


@pytest.mark.parametrize("fn,args", [
    ("pack_codes", lambda: (_codes(0)[0] & 3,)),
    ("pack_batch", lambda: (_codes(1)[0],)),
    ("pack_batch", lambda: (_codes(2, 3, 1003)[0],)),
    ("window_counts_for_lengths", lambda: (_codes(3)[1], 100, 6)),
    ("encode_read", lambda: ("ACGTNNacgtRYACGT" * 20,)),
    ("extract_ends", lambda: (_codes(4, 1, 700)[0][0], 500)),
    ("extract_ends", lambda: (_codes(4, 1, 300)[0][0], 500)),
    ("ends_batch", lambda: ([r[:n] for r, n in zip(*_codes(5, 4, 900))], 500)),
    ("extract_tail", lambda: (_codes(6, 1, 3000)[0][0], "forward", 100, 2000)),
    ("extract_tail", lambda: (_codes(6, 1, 3000)[0][0], "reverse", 100, 2000)),
    ("tails_batch", lambda: ([r[:n] for r, n in zip(*_codes(7, 5, 1500))], 2048, 512)),
    ("tails_batch", lambda: ([r[:n] for r, n in zip(*_codes(8, 5, 700))], 700, 512)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_batch_functions(fn, args):
    _same(getattr(j_batch, fn)(*args()), getattr(t_batch, fn)(*args()))


def test_ends_batch_flat():
    codes, lens = _codes(9, 7, 1200)
    flat = np.concatenate([r[:n] for r, n in zip(codes, lens)])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    _same(j_batch.ends_batch_flat(flat, offs, 500), t_batch.ends_batch_flat(flat, offs, 500))


def test_planar_packers_are_not_carried():
    """The phase-planar wire exists for the TPU kernel only."""
    for name in ("pack_batch_planar", "pack_tails_phase_planar",
                 "pack_tails_phase_planar_lean"):
        assert hasattr(j_batch, name) and not hasattr(t_batch, name)
    rest = sorted(n for n, f in vars(j_batch).items()
                  if inspect.isfunction(f) and f.__module__ == j_batch.__name__
                  and "planar" not in n)
    assert rest == sorted(n for n, f in vars(t_batch).items()
                          if inspect.isfunction(f) and f.__module__ == t_batch.__name__)


# ---- aggregate ---------------------------------------------------------------

@pytest.mark.parametrize("seed,n,input_trc", [(0, 40, 0.7), (1, 2, 0.7), (2, 25, 0.3),
                                              (3, 12, 0.95)])
def test_aggregate_outputs_and_log_lines(seed, n, input_trc):
    rng = np.random.default_rng(seed)
    trc = {5: list(rng.uniform(0.3, 1.0, n)), 6: list(rng.uniform(0.6, 0.8, n))}
    telo = {5: [float(x) for x in rng.integers(0, 6000, n)],
            6: [float(x) for x in rng.integers(1000, 3000, n)]}
    outs = []
    for mod in (j_aggregate, t_aggregate):
        lines, plots = [], []
        res = mod.summarize_all(trc, telo, input_trc,
                                log=lambda *a: lines.append(" ".join(map(str, a))),
                                plot_fn_for_phrase=lambda ph: lambda *a: plots.append(
                                    (ph, [np.asarray(x).tolist() for x in a])))
        outs.append(([dataclasses.asdict(r) for r in res], lines, plots))
    assert repr(outs[0]) == repr(outs[1]) and outs[0][1]
    v = (list(rng.uniform(0.5, 1, 9)), list(rng.uniform(0, 5000, 9)), input_trc, 0.8)
    assert repr(j_aggregate.quad_vertex(*v)) == repr(t_aggregate.quad_vertex(*v))


# ---- writers and readers -------------------------------------------------------

def test_writer_bytes(reads, tmp_path):
    recs = list(j_reader.parse_records(str(reads / "s.fastq.gz")))[:3]
    outs = []
    for name, mod, rd in (("j", j_writer, j_reader), ("t", t_writer, t_reader)):
        d = tmp_path / name
        d.mkdir()
        csv = str(d / "telolengths_all.csv")
        mod.write_csv_header(csv)
        mod.append_csv_row(csv, "lbl", 5, 0.71234, "read, with comma", 2050)
        mod.append_csv_row_raw(csv, ["lbl", 5, "0.900", "r2", 0])
        mod.write_subset(str(d / "sub.fastq"), [rd.SeqRecord(**dataclasses.asdict(r))
                                                for r in recs], "fastq")
        mod.write_subset(str(d / "sub.fasta"), [rd.SeqRecord(**dataclasses.asdict(r))
                                                for r in recs], "fasta")
        assert mod.CSV_HEADER == j_writer.CSV_HEADER
        outs.append({p.name: p.read_bytes() for p in sorted(d.iterdir())})
        assert mod.file_label("/x/y/reads.fastq.gz") == j_writer.file_label("/x/y/reads.fastq.gz")
        assert mod.subset_path("o", "/x/reads.fastq.gz", 0.7) == \
            j_writer.subset_path("o", "/x/reads.fastq.gz", 0.7)
    assert outs[0] == outs[1] and len(outs[0]) == 3


def test_runlog_lines(tmp_path, capsys):
    for name, mod in (("j", j_writer), ("t", t_writer)):
        log = mod.RunLog(str(tmp_path / name), echo=True)
        log("a", 1, [2])
        log.plain("-----")
    out = capsys.readouterr().out.splitlines()
    assert out[0][21:] == out[2][21:] == " a 1 [2]" and out[1] == out[3] == "-----"
    assert (tmp_path / "j" / "topsicle_run.log").read_text()[21:] == \
        (tmp_path / "t" / "topsicle_run.log").read_text()[21:]


@pytest.mark.parametrize("name", ["s.fastq.gz", "f.fasta.gz"])
def test_python_reader_records(reads, name):
    path = str(reads / name)
    assert j_reader.sniff_format(path) == t_reader.sniff_format(path)
    assert j_reader.extension_format(path) == t_reader.extension_format(path)
    j = [dataclasses.astuple(r) for r in j_reader.parse_records(path)]
    t = [dataclasses.astuple(r) for r in t_reader.parse_records(path)]
    assert j == t and len(j) in (12, 4)


def test_reader_errors_are_the_same(tmp_path):
    bad = tmp_path / "bad.fastq"
    bad.write_text("@r1\nACGT\n+\nII\n")
    msgs = []
    for rd in (j_reader, t_reader):
        with pytest.raises(ValueError) as e:
            list(rd.parse_records(str(bad)))
        msgs.append(str(e.value))
        assert issubclass(rd.InputFileError, RuntimeError)
    assert msgs[0] == msgs[1]
    assert str(j_reader.InputFileError("p", OSError("x"))) == \
        str(t_reader.InputFileError("p", OSError("x")))


def _blocks(native, path, min_len, batch_reads):
    rd = native.NativeReader(path, min_len, batch_reads=batch_reads)
    try:
        return [(b.ids, b.codes, b.offs) for b in rd.iter_blocks()]
    finally:
        rd.close()


@pytest.mark.parametrize("name,min_len", [("s.fastq.gz", 9000), ("f.fasta.gz", 100)])
def test_native_reader_block_for_block(reads, name, min_len):
    """The port builds its own copy of native/tsio.cc into its _build/
    directory; its blocks equal the JAX package's reader's and the Python
    reader's, on inputs with records at or under min_len (the FASTQ's
    two), and its counts of the records, their bases and the short ones
    equal the Python reader's."""
    if not (j_native.native_available() and t_native.native_available()):
        pytest.skip("no C++ toolchain or zlib: the native reader is unavailable")
    assert os.path.dirname(t_loader._SO) == os.path.join(REPO, "topsicle_tpu_torch", "_build")
    assert t_loader._SRC == os.path.join(REPO, "topsicle_tpu_torch", "native", "tsio.cc")
    path = str(reads / name)
    j = _blocks(j_native, path, min_len, 5)
    t = _blocks(t_native, path, min_len, 5)
    _same(j, t)
    assert len(t) >= 1
    py = [(r.id, t_batch.encode_read(r.seq)) for r in t_reader.parse_records(path)
          if len(r.seq) > min_len]
    flat = [(rid, codes[offs[i]:offs[i + 1]]) for ids, codes, offs in t
            for i, rid in enumerate(ids)]
    assert [r for r, _ in py] == [r for r, _ in flat]
    for (_, a), (_, b) in zip(py, flat):
        assert np.array_equal(a, b)
    seqs = [r.seq for r in t_reader.parse_records(path)]
    rd = t_native.NativeReader(path, min_len, batch_reads=5)
    try:
        assert rd.stats() == (0, 0, 0)
        for _ in rd.iter_blocks():
            pass
        assert rd.stats() == (len(seqs), sum(map(len, seqs)),
                              sum(len(q) <= min_len for q in seqs))
    finally:
        rd.close()
    assert name != "s.fastq.gz" or sum(len(q) <= min_len for q in seqs) == 2


def test_native_source_is_a_copy():
    """The port's C++ reader is the original with counters added, which
    the run log's reader and subset counters need (the input's records,
    bases and short records; the subset writer's seconds re-reading the
    input; the inflate's seconds and bytes), with what a subset file needs
    kept from the first parse (keep_records: qualities written beside the
    codes, headers, plain flags, raw bases and first-token hashes;
    tsio_kept, tsio_take, tsio_repeated, tsio_token_hash and tsio_emit),
    and with its own gzip inflate (inflate.h's gunzip::Stream) in place of
    zlib's gzFile: every line of the original is there, in order, but the
    three the counters replace and the seven of LineReader that name the
    gzFile (its declaration, and each line that calls gzopen, gzbuffer,
    gzread, gzerror, gzeof or gzclose), each of which now names the Stream;
    and the lines it adds hold no control flow but those additions' own.
    test_native_reader_block_for_block and tests/test_torch_inflate.py hold
    its blocks to the original's."""
    replaced = {"    if (static_cast<int64_t>(rec.seq.size()) <= r->min_len) continue;",
                "                    const char* ids_joined, int fastq_out) {",
                "  while (rr.next(rec)) {",
                # LineReader's gzFile
                '  explicit LineReader(const char* path) : gz_(gzopen(path, "rb")) {',
                "    if (gz_) gzbuffer(gz_, kBufSize);",
                "    if (gz_) gzclose(gz_);",
                "        len_ = gzread(gz_, buf_, kBufSize);",
                "          gzerror(gz_, &errnum);",
                "          if (len_ < 0 || errnum != Z_OK || (len_ == 0 && !gzeof(gz_)))",
                "  gzFile gz_ = nullptr;"}
    flow = [  # LineReader: its end read as gzread's
            "          if (len_ < 0 || errnum != Z_OK || (len_ == 0 && !gz_->eof()))",
            # fnv1a, token_hash, keep_record
            "  for (size_t i = 0; i < n; ++i) h = (h ^ static_cast<unsigned char>(s[i])) "
            "* 1099511628211ull;",
            "  return h;",
            '  return fnv1a(header.data(), std::min(header.find_first_of(" \\t"), '
            "header.size()));",
            "  for (size_t i = 0; i < rec.seq.size(); ++i) bad |= (codes[i] & 0xFC) | "
            "(rec.seq[i] & 0x20);",
            # tsio_next
            "    } else {",
            "      if (r->keep) r->token_hashes.push_back(token_hash(rec.header));",
            "      if (static_cast<int64_t>(rec.seq.size()) <= r->min_len) {",
            "        continue;",
            "    if (r->keep) keep_record(r, rec, codes + code_pos - rec.seq.size(),",
            # tsio_kept, tsio_take
            "  for (const std::string& raw : r->raws) out[1] += "
            "static_cast<int64_t>(raw.size());",
            "  return static_cast<int64_t>(r->plain.size());",
            "  for (size_t i = 0; i < r->plain.size(); ++i) {",
            # tsio_repeated, tsio_token_hash
            "  if (!r->hashes_sorted) std::sort(h.begin(), h.end());",
            "  for (size_t i = 1; i < h.size(); ++i) {",
            "    if (h[i] != h[i - 1] || (i > 1 && h[i - 1] == h[i - 2])) continue;",
            "    if (n < cap) out[n] = h[i];",
            "  return n;",
            "  return fnv1a(token, static_cast<size_t>(n));",
            # tsio_emit
            "  for (int64_t k = 0; k < n; ++k) {",
            "    if ((p - out) + hlen + 2 * len + 6 > out_cap) return -1;",
            "      if (!plain[i]) {",
            "        return;",
            "      for (int64_t j = at + from; j < at + from + count; ++j) *p++ = "
            "kBases[codes[j]];",
            "    if (fastq_out) {",
            "      if (quals) memcpy(p, quals + at, len);",
            "      else memset(p, 'I', len);",
            "      continue;",
            "    for (int64_t j = 0; j < len; j += 60) {",
            "  return p - out;",
            # tsio_subset's clock
            "  while (true) {",
            "    if (!more) break;",
            "  if (stats) stats[0] = std::chrono::duration<double>(reading).count();"]
    with open(os.path.join(REPO, "native", "tsio.cc")) as fh:
        original = fh.read().splitlines()
    with open(t_loader._SRC) as fh:
        port = fh.read().splitlines()
    it = iter(port)
    assert replaced <= set(original)
    assert all(any(ln == p for p in it) for ln in original if ln not in replaced)
    ops = difflib.SequenceMatcher(None, original, port, autojunk=False).get_opcodes()
    removed = [ln for op, i1, i2, _, _ in ops if op != "equal" for ln in original[i1:i2]]
    added = [ln for op, _, _, j1, j2 in ops if op != "equal" for ln in port[j1:j2]]
    assert set(removed) == replaced and len(removed) == 10
    keyword = re.compile(r"\b(if|else|for|while|do|switch|case|continue|break|return|goto)\b")
    assert [ln for ln in added
            if not ln.lstrip().startswith("//") and keyword.search(ln)] == flow


def test_native_subset_bytes(reads, tmp_path):
    if not (j_native.native_available() and t_native.native_available()):
        pytest.skip("no C++ toolchain or zlib: the native reader is unavailable")
    path = str(reads / "s.fastq.gz")
    ids = sorted(r.id for r in t_reader.parse_records(path))[::2]
    nj = j_native.write_subset_native(path, str(tmp_path / "j.fastq"), ids, True)
    nt = t_native.write_subset_native(path, str(tmp_path / "t.fastq"), ids, True)
    assert nj == nt == len(ids)
    assert (tmp_path / "j.fastq").read_bytes() == (tmp_path / "t.fastq").read_bytes()


# ---- block cache, manifest, prefetch, timers -------------------------------------

def test_blockcache_entries_are_interchangeable(reads, tmp_path):
    """An entry written by one package replays, block for block, through
    the other: same header, same records."""
    path = str(reads / "s.fastq.gz")
    recs = [(r.id, t_batch.encode_read(r.seq)) for r in t_reader.parse_records(path)]
    blocks = []
    for s in range(0, len(recs), 5):
        chunk = recs[s:s + 5]
        offs = np.concatenate([[0], np.cumsum([len(c) for _, c in chunk])]).astype(np.int64)
        blocks.append(([r for r, _ in chunk], np.concatenate([c for _, c in chunk]), offs))
    for name, wmod, rmod in (("jt", j_blockcache, t_blockcache),
                             ("tj", t_blockcache, j_blockcache)):
        out = str(tmp_path / name)
        os.makedirs(out)
        w = wmod.BlockCacheWriter(out, path, 9000, 5, lambda n: True, lambda n: None)
        for b in blocks:
            assert w.add(*b)
        assert w.commit() > 0
        got = list(rmod.open_cached_blocks(out, path, 9000, 5))
        _same([tuple(b) for b in blocks], [tuple(b) for b in got])
        assert rmod.open_cached_blocks(out, path, 9001, 5) is None
        assert wmod.drop_entry(out, path) > 0
        rmod.clear(out)
    assert j_blockcache.cache_budget_bytes() == t_blockcache.cache_budget_bytes()


def test_manifest_round_trip(tmp_path):
    """A manifest written by one package is read by the other."""
    for wcls, rcls, name in ((j_manifest.RunManifest, t_manifest.RunManifest, "jt"),
                             (t_manifest.RunManifest, j_manifest.RunManifest, "tj")):
        out = str(tmp_path / name)
        os.makedirs(out)
        m = wcls(out)
        m.reset()
        m.mark_done("/in/a.fastq.gz", 5, 3, trcs=[0.71, 0.9, 1.0 / 3.0])
        m.mark_done("/in/b.fastq.gz", 5, 0, trcs=[])
        r = rcls(out)
        assert r.is_done("/in/a.fastq.gz", 5) and not r.is_done("/in/a.fastq.gz", 6)
        assert r.rows_for("/in/a.fastq.gz", 5) == 3
        assert r.trcs_for("/in/a.fastq.gz", 5) == [0.71, 0.9, 1.0 / 3.0]
        assert r.rows_for("/in/b.fastq.gz", 5) == 0
    assert sorted(os.listdir(tmp_path / "jt")) == sorted(os.listdir(tmp_path / "tj"))


def test_part_files_write_and_merge_bytes(tmp_path):
    rows = [["lbl", 5, "0.712", "r,1", 2050], ["lbl", 5, "0.900", "r2", 0]]
    outs = []
    for name, mod, wr in (("j", j_distributed, j_writer), ("t", t_distributed, t_writer)):
        out = str(tmp_path / name)
        csv = os.path.join(out, "telolengths_all.csv")
        os.makedirs(out)
        wr.write_csv_header(csv)
        mod.reset_mine(out, 0, 2)
        mod.write_part(out, 5, 0, rows, [0.7123, 0.9], [2050.0, 0.0])
        mod.write_part(out, 5, 1, rows[:1], [1.0 / 3.0], [7.0])
        parts = {n: open(os.path.join(out, ".parts", n), "rb").read()
                 for n in sorted(os.listdir(os.path.join(out, ".parts")))}
        mod.mark_done(out, 0, 2)
        mod.mark_done(out, 1, 2)
        merged = mod.merge(out, csv, mod.wait_all(out, 2, timeout_s=5))
        mod.cleanup_parts(out)
        assert not os.path.exists(os.path.join(out, ".parts"))
        outs.append((parts, open(csv, "rb").read(), merged))
        assert mod.my_files(list("abcde"), 1, 2) == [(1, "b"), (3, "d")]
        assert mod.process_identity(1, 3) == (1, 3)
    assert outs[0] == outs[1] and outs[0][1].count(b"\n") == 4


def test_prefetcher_and_timers():
    for pf in (j_prefetch, t_prefetch):
        src = pf.Prefetcher(iter(range(50)), depth=2)
        assert list(src) == list(range(50))
        src.close()
        with pytest.raises(ZeroDivisionError):
            list(pf.prefetch((1 // (3 - i) for i in range(5)), depth=1))
    for prof in (j_profiling, t_profiling):
        t = prof.StageTimers()
        with t.stage("step1"):
            pass
        if prof is t_profiling:     # the port's recorder counts by name
            t.add("reads.in", 2)
            t.add("bases.in", 3_000_000)
        else:
            t.count(reads=2, bases=3_000_000)
        s = t.summary()
        assert s.startswith("stages: step1=0.00s/1x; wall ") and "2 reads, 3.0 Mbp" in s
        with prof.trace_context(None):
            pass


# ---- oracle ------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(pattern="CCCTAAA", slide=6),
                                 dict(pattern="CCCTAAA", slide=6, telophrase=[4, 7],
                                      cutoff=[0.6])], ids=["k5", "sweep-4-7"])
def test_oracle_engine_csv_bytes(reads, tmp_path, cfg):
    path = str(reads / "s.fastq.gz")
    rj = j_oracle.OracleEngine(JConfig(input_dir=path, output_dir=str(tmp_path / "j"),
                                       **cfg)).run()
    rt = t_oracle.OracleEngine(TConfig(input_dir=path, output_dir=str(tmp_path / "t"),
                                       **cfg)).run()
    assert [dataclasses.astuple(r) for r in rj] == [dataclasses.astuple(r) for r in rt]
    outs = [{p.name: p.read_bytes() for p in sorted((tmp_path / n).iterdir())
             if p.name != "topsicle_run.log"} for n in "jt"]
    assert outs[0] == outs[1] and outs[0]["telolengths_all.csv"].count(b"\n") > 2
    logs = [[ln[21:] for ln in (tmp_path / n / "topsicle_run.log").read_text().splitlines()
             if "Output will be here" not in ln and "fasta file" not in ln] for n in "jt"]
    assert logs[0] == logs[1]


@pytest.mark.parametrize("fn,args", [
    ("count_nonoverlapping", ("AAAAAACCCTAAACCCTAAA", "AAA")),
    ("count_nonoverlapping", ("ACACACACAC", "ACAC")),
    ("binseg_l2_single", ([9.0] * 30 + [1.0] * 45, 2, 5)),
    ("binseg_l2_single", ([1.0, 2.0, 1.0], 2, 5)),
    ("window_signal", ("CCCTAAA" * 60 + "ACGT" * 100, "forward",
                       j_kmers.telophrase_kmers("CCCTAAA", 5), 100, 6, 0, 20000)),
    ("boundary_detect", ("CCCTAAA" * 90 + "ACGGT" * 200, "forward",
                         j_kmers.telophrase_kmers("CCCTAAA", 5), 100, 6, 100, 20000)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_oracle_functions(fn, args):
    _same(getattr(j_oracle, fn)(*args), getattr(t_oracle, fn)(*args))


def test_oracle_step1_trc():
    rng = random.Random(8)
    kmers = j_kmers.telophrase_kmers("CCCTAAA", 5)
    for seq in ("CCCTAAA" * 200 + "".join(rng.choice("ACGT") for _ in range(9000)),
                "".join(rng.choice("ACGT") for _ in range(9000)) + "TTTAGGG" * 150):
        j = j_oracle.step1_trc(seq, kmers, 7, 1000)
        t = t_oracle.step1_trc(seq, kmers, 7, 1000)
        assert j == t and j is not None
    junk = "".join(rng.choice("ACGT") for _ in range(9000))
    assert j_oracle.step1_trc(junk, kmers, 7, 1000) is t_oracle.step1_trc(junk, kmers, 7, 1000)


# ---- the CLI parsers ---------------------------------------------------------

def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type,
                     tuple(a.choices) if a.choices else None, a.required)
            for a in parser._actions if a.dest != "help"}


def test_cli_parser_options_and_defaults():
    """The reference CLI's flags, with the same spellings, defaults and
    types, plus --device."""
    j, t = _options(j_cli.build_parser()), _options(t_cli.build_parser())
    device = t.pop("device")
    assert device == (("--device",), "cuda", None, None, ("cuda", "cpu"), False)
    assert j == t and len(j) == 27


def test_cli_help_text_differs_only_where_the_runtime_does():
    j = {a.dest: a.help for a in j_cli.build_parser()._actions}
    t = {a.dest: a.help for a in t_cli.build_parser()._actions}
    changed = {d for d in j if j[d] != t[d]}
    assert changed == {"engine", "traceDir", "precompile", "scanLengthMode", "kernel",
                       "coordinator", "processId", "shardMode"}


@pytest.mark.parametrize("argv", [
    ["-i", "in", "-o", "out", "--pattern", "CCCTAAA"],
    ["-i", "in", "-o", "out", "--pattern", "CCCTAA", "--telophrase", "4", "5", "--cutoff",
     "0.8", "0.6", "--slide", "3", "--kernel", "greedy", "--threads", "2", "--resume",
     "--batchSize", "64", "--scanLengthMode", "bucket", "--processId", "1",
     "--processCount", "2", "--shardMode", "global", "--rawcountpattern", "--plot",
     "--rangecp", "9000", "--read_check", "r7", "-ov", "--traceDir", "tr",
     "--minSeqLength", "100", "--windowSize", "90", "--trimfirst", "10", "--maxlengthtelo",
     "7000", "--engine", "oracle"],
], ids=["minimal", "every-flag"])
def test_cli_config_from_args(argv):
    j = j_cli.config_from_args(j_cli.build_parser().parse_args(argv))
    t = t_cli.config_from_args(t_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_overview_cli_parser_and_console_scripts():
    j, t = _options(j_plot_cli.build_parser()), _options(t_plot_cli.build_parser())
    assert j == t and len(t) == 7
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'topsicle-torch-overview = "topsicle_tpu_torch.plot_cli:main"' in text
    assert '"csrc/*.cuh"' in text and '"native/tsio.cc"' in text


def test_make_engine_counterpart(tmp_path):
    from topsicle_tpu_torch.pipeline import TorchEngine, make_engine

    kw = dict(input_dir="in", output_dir=str(tmp_path), pattern="CCCTAAA")
    assert isinstance(make_engine(TConfig(engine="oracle", **kw)), t_oracle.OracleEngine)
    assert isinstance(make_engine(TConfig(**kw), device="cpu"), TorchEngine)
