"""The port's gzip inflate (topsicle_tpu_torch/native/inflate.h), which its C++
reader uses in place of zlib's gzread: the port's NativeReader, block for
block (ids, codes, offsets and the Records a subset file is written from),
against the JAX package's reader (native/tsio.cc on zlib) and the Python
reader, over gzip levels and zlib strategies, content that stresses the
decoder (distance-1 matches, the longest distances, output that wraps
inside a match), member layouts (concatenated members, BGZF-style FEXTRA,
FNAME + FCOMMENT + FHCRC, an empty member, trailing zero bytes) and plain
FASTQ and FASTA; the inflate's counters; and broken input (truncations,
a flipped CRC-32 or ISIZE byte), which must end as the reference's does."""

import random
import struct
import zlib

import numpy as np
import pytest

import topsicle_tpu.native as j_native
import topsicle_tpu_torch.io.batch as t_batch
import topsicle_tpu_torch.io.reader as t_reader
import topsicle_tpu_torch.native as t_native

MIN_LEN = 100
BATCH = 7


def _native_or_skip():
    if not (j_native.native_available() and t_native.native_available()):
        pytest.skip("no C++ toolchain or zlib: the native reader is unavailable")


def _seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _fastq_text(records):
    return "".join(f"@{h}\n{s}\n+\n{q}\n" for h, s, q in records).encode()


def _records(seed=1, n=40):
    """Reads of 20-3,000 bases (some at or under MIN_LEN), a few with an N
    or lowercase bases, Phred qualities."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        s = _seq(rng, rng.randrange(20, 3000))
        if i % 9 == 4:
            s = s[:10] + "N" + s[11:].lower()
        q = "".join(chr(33 + min(40, max(2, int(rng.gauss(14, 7))))) for _ in s)
        out.append((f"r{i} ch={i % 3} len={len(s)}", s, q))
    return out


def _homopolymers():
    rng = random.Random(2)
    return [(f"h{i}", "".join(b * rng.randrange(1, 400) for b in rng.choices("ACGT", k=40)),
             None) for i in range(20)]


def _repeats_30k():
    """One read and its copies about 30 KiB later, so matches reach back
    nearly the whole window."""
    rng = random.Random(3)
    unit = [("u0", _seq(rng, 1500), None), ("u1", _seq(rng, 900), None)]
    out = []
    for k in range(4):
        out += [(f"{h}.{k}", s, None) for h, s, _ in unit]
        out.append((f"gap{k}", _seq(rng, 30 * 1024 - 2600), None))
    return out


def _long_read():
    """A read of more than 2 MiB whose repeats straddle the decoder's 1 MiB
    output boundaries, so the output wraps inside a match."""
    rng = random.Random(4)
    s = _seq(rng, (1 << 20) - 700) + "ACGTTGCA" * 40000 + _seq(rng, 700_000) + "A" * 300_000
    return [("big", s, None), ("after", _seq(rng, 500), None)]


def _with_quals(recs):
    return [(h, s, q if q is not None else "I" * len(s)) for h, s, q in recs]


def _fasta_text(recs):
    return "".join(f">{h}\n" + "\n".join(s[j:j + 60] for j in range(0, len(s), 60)) + "\n"
                   for h, s, _ in recs).encode()


def _gzip(text, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, 31, 8, strategy)
    return c.compress(text) + c.flush()


def _member(text, extra=None, name=None, comment=None, hcrc=False, level=6):
    """A gzip member with the optional header fields of RFC 1952."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(text) + c.flush()
    flags = ((4 if extra is not None else 0) | (8 if name is not None else 0)
             | (16 if comment is not None else 0) | (2 if hcrc else 0))
    head = b"\x1f\x8b\x08" + bytes([flags]) + b"\x00\x00\x00\x00\x00\x03"
    if extra is not None:
        head += struct.pack("<H", len(extra)) + extra
    if name is not None:
        head += name + b"\x00"
    if comment is not None:
        head += comment + b"\x00"
    if hcrc:
        head += struct.pack("<H", zlib.crc32(head) & 0xFFFF)
    return head + body + struct.pack("<II", zlib.crc32(text), len(text) & 0xFFFFFFFF)


def _bgzf(text, block=65280):
    """BGZF: members of at most 64 KiB of text, each with a BC subfield
    giving its size less 1, and the empty end-of-file member."""
    out = b""
    for i in range(0, len(text), block):
        m = _member(text[i:i + block], extra=b"BC\x02\x00\x00\x00")
        out += m[:16] + struct.pack("<H", len(m) - 1) + m[18:]
    return out + bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def _split(text, parts):
    cut = [len(text) * k // parts for k in range(parts + 1)]
    return [text[a:b] for a, b in zip(cut, cut[1:])]


FASTQ = _fastq_text(_records())
# case: (file name, its bytes, the text it holds)
CASES = {
    **{f"level{lv}": ("r.fastq.gz", _gzip(FASTQ, level=lv), FASTQ) for lv in (0, 1, 6, 9)},
    "fixed": ("r.fastq.gz", _gzip(FASTQ, strategy=zlib.Z_FIXED), FASTQ),
    "huffman_only": ("r.fastq.gz", _gzip(FASTQ, strategy=zlib.Z_HUFFMAN_ONLY), FASTQ),
    "rle": ("r.fastq.gz", _gzip(FASTQ, strategy=zlib.Z_RLE), FASTQ),
    "homopolymers": ("h.fastq.gz", _gzip(_fastq_text(_with_quals(_homopolymers()))),
                     _fastq_text(_with_quals(_homopolymers()))),
    "repeats_30k": ("p.fastq.gz", _gzip(_fastq_text(_with_quals(_repeats_30k())), level=9),
                    _fastq_text(_with_quals(_repeats_30k()))),
    "read_over_2mib": ("b.fasta.gz", _gzip(_fasta_text(_long_read()), level=1),
                       _fasta_text(_long_read())),
    # members cut mid-record, as a chunked ONT run's are
    "members": ("m.fastq.gz", b"".join(_gzip(t, level=lv) for t, lv in
                                       zip(_split(FASTQ, 3), (1, 6, 9))), FASTQ),
    "bgzf": ("z.fastq.gz", _bgzf(FASTQ), FASTQ),
    "fname_fcomment_fhcrc": ("n.fastq.gz", _member(FASTQ, name=b"reads.fastq",
                                                   comment=b"run 7, flow cell A", hcrc=True)
                             + _member(b"", extra=b"xy\x01\x00z", hcrc=True), FASTQ),
    "empty_member": ("e.fastq.gz", _gzip(_split(FASTQ, 2)[0]) + _gzip(b"")
                     + _gzip(_split(FASTQ, 2)[1]), FASTQ),
    "trailing_zeros": ("t.fastq.gz", _gzip(FASTQ) + b"\x00" * 37, FASTQ),
    "plain_fastq": ("r.fastq", FASTQ, None),
    "plain_fasta": ("r.fasta", _fasta_text(_records(5)), None),
}


def _port(path):
    """The port's blocks, with their Records, and its inflate counters."""
    rd = t_native.NativeReader(path, MIN_LEN, batch_reads=BATCH, keep_records=True)
    try:
        return list(rd.iter_blocks()), rd.inflate_stats()
    finally:
        rd.close()


def _iter(native, path):
    """A package's reader's blocks of path, as they come."""
    rd = native.NativeReader(path, MIN_LEN, batch_reads=BATCH)
    try:
        yield from rd.iter_blocks()
    finally:
        rd.close()


def _reference(path):
    return list(_iter(j_native, path))


def _same_blocks(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.ids == b.ids
        assert np.array_equal(a.codes, b.codes) and np.array_equal(a.offs, b.offs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_reader_holds_to_zlib_and_python(case, tmp_path):
    """Block for block the JAX package's zlib reader's ids, codes and
    offsets; read for read the Python reader's eligible reads, their
    headers, qualities and bases; and the inflate's counters: every byte
    of the text (the members' ISIZE summed), 0 for plain input."""
    _native_or_skip()
    name, data, text = CASES[case]
    path = tmp_path / name
    path.write_bytes(data)
    blocks, (inflate_s, inflated) = _port(str(path))
    _same_blocks(blocks, _reference(str(path)))
    want = [r for r in t_reader.parse_records(str(path)) if len(r.seq) > MIN_LEN]
    assert want
    fastq = t_reader.sniff_format(str(path)) == "fastq"
    got, codes = [], []
    for b in blocks:
        rec = b.records
        assert (rec.quals is not None) == fastq
        for i, rid in enumerate(b.ids):
            lo, hi = b.offs[i], b.offs[i + 1]
            raw = bytes(rec.raw[rec.raw_offs[i]:rec.raw_offs[i + 1]]).decode()
            got.append((rid, bytes(rec.headers[rec.header_offs[i]:rec.header_offs[i + 1]]).decode(),
                        "".join("ACGT"[c] for c in b.codes[lo:hi]) if rec.plain[i] else raw,
                        None if rec.quals is None else bytes(rec.quals[lo:hi]).decode()))
            codes.append(b.codes[lo:hi])
    assert got == [(r.id, r.header, r.seq, r.qual) for r in want]
    assert all(np.array_equal(c, t_batch.encode_read(r.seq)) for c, r in zip(codes, want))
    if text is None:
        assert (inflate_s, inflated) == (0.0, 0)
    else:
        assert inflated == len(text) and inflate_s > 0


def _two_members():
    """A FASTQ in two gzip members, and the first member's length."""
    first, second = _split(FASTQ, 2)
    a = _gzip(first, level=6)
    return a + _gzip(second, level=1), len(a)


def _broken():
    data, m1 = _two_members()
    n = len(data)
    cuts = {  # offset: where it falls
        5: "first header", 10: "first block's start", m1 // 3: "first member's blocks",
        m1 // 2: "first member's blocks", m1 - 6: "first trailer", m1 - 1: "first trailer",
        m1 + 5: "second header", (m1 + n) // 2: "second member's blocks",
        n - 5: "last trailer", n - 1: "last trailer"}
    out = {f"cut{at}-{where.replace(' ', '_')}": data[:at] for at, where in cuts.items()}
    for field, at in (("crc", n - 8), ("isize", n - 4)):
        flipped = bytearray(data)
        flipped[at] ^= 0x10
        out[f"flipped-{field}"] = bytes(flipped)
    return out


BROKEN = _broken()


def _outcome(native, path):
    """(the blocks a package's reader hands on, the error that ends it)."""
    got = []
    try:
        for b in _iter(native, path):
            got.append(b)
    except OSError as e:
        return got, e
    return got, None


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_input_ends_as_the_reference(case, tmp_path):
    """A truncated file or a flipped CRC-32 or ISIZE byte ends the port's
    reading with the reference's error (tsio_next's -3, or no format where
    the first header is cut); the blocks it hands on before that are the
    whole file's first blocks."""
    _native_or_skip()
    whole, _ = _two_members()
    (tmp_path / "whole.fastq.gz").write_bytes(whole)
    intact = _reference(str(tmp_path / "whole.fastq.gz"))
    path = tmp_path / "broken.fastq.gz"
    path.write_bytes(BROKEN[case])
    ref, ref_err = _outcome(j_native, str(path))
    got, err = _outcome(t_native, str(path))
    assert ref_err is not None and err is not None
    assert (type(err), str(err)) == (type(ref_err), str(ref_err))
    _same_blocks(got, intact[:len(got)])
    _same_blocks(ref, intact[:len(ref)])
