"""Streaming FASTA/FASTQ reader (plain or gzip), no third-party deps.

Replicates the observable behavior of the reference's I/O layer
(the reference tool's allsteps.py:36-50,127-149, which delegates to
Bio.SeqIO):

- format is sniffed from the first character: '@' -> fastq, '>' -> fasta
  (allsteps.py:41-47); an unrecognizable file raises ValueError from
  parse_records — the reference crashes on such inputs (allsteps.py
  returns None and callers iterate it); the engine catches this and
  skips the file loudly, identically for this reader and the native
  C++ one;
- record id = first whitespace-delimited token of the header (Biopython
  convention);
- FASTA sequences may wrap over multiple lines; FASTQ accepts both the
  standard 4-line form (what ONT/PacBio emit) and wrapped/multi-line
  records (sequence lines until the '+' separator, then quality lines
  until the lengths match — Bio.SeqIO's envelope).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, Optional


class InputFileError(RuntimeError):
    """A single input file could not be read to the end (truncated gzip,
    malformed record, IO failure).  The engine logs it and continues
    with the remaining files — in the reference, the same condition
    kills the whole fork-pool run after hours (a deliberate robustness
    deviation, documented in PARITY.md)."""

    def __init__(self, path: str, cause: BaseException):
        super().__init__(f"cannot read input file {path}: {cause}")
        self.path = path
        self.cause = cause


@dataclasses.dataclass
class SeqRecord:
    """One read. `header` is the full header line without the '>'/'@'
    marker; `id` is its first token.  `qual` is None for FASTA."""

    id: str
    header: str
    seq: str
    qual: Optional[str] = None

    def __len__(self) -> int:
        return len(self.seq)


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "rt", encoding="utf-8")


def sniff_format(path: str) -> Optional[str]:
    """'fastq' | 'fasta' | None by first non-empty character."""
    try:
        with _open_text(path) as fh:
            first = fh.readline().strip()
    except (OSError, UnicodeDecodeError):
        return None
    if first.startswith("@"):
        return "fastq"
    if first.startswith(">"):
        return "fasta"
    return None


def extension_format(path: str) -> str:
    """Format implied by the file extension.

    The reference uses this (not content sniffing) to pick the subset
    file's format and name (main.py:68-81): fastq only for
    .fastq/.fq(.gz); anything else is treated as fasta."""
    base = path[:-3] if path.endswith(".gz") else path
    return "fastq" if base.endswith((".fastq", ".fq")) else "fasta"


def parse_records(path: str, fmt: Optional[str] = None) -> Iterator[SeqRecord]:
    """Yield SeqRecords; `fmt` overrides sniffing.

    Raises ValueError when the format cannot be sniffed: silently
    yielding nothing would let a stray non-FASTA/Q file (or a mistyped
    --inputDir) be marked complete with zero rows, and would diverge
    from the native reader, which errors on the same input."""
    fmt = fmt or sniff_format(path)
    if fmt is None:
        raise ValueError(
            f"cannot determine input format of {path}: first character "
            "is neither '@' (FASTQ) nor '>' (FASTA)")
    with _open_text(path) as fh:
        if fmt == "fastq":
            yield from _parse_fastq(fh)
        else:
            yield from _parse_fasta(fh)


def _parse_fastq(fh: io.TextIOBase) -> Iterator[SeqRecord]:
    """4-line and wrapped FASTQ: sequence lines accumulate until the
    '+' separator; quality lines accumulate until their length reaches
    the sequence's (they may legally start with '@', so quality is
    length-delimited, never marker-delimited — Bio.SeqIO semantics)."""
    line = fh.readline()
    while True:
        if not line:
            return
        header = line.rstrip("\n")
        if not header:
            line = fh.readline()
            continue
        if not header.startswith("@"):
            raise ValueError(f"malformed FASTQ header: {header[:80]!r}")
        seq_parts = []
        line = fh.readline()
        while line and not line.startswith("+"):
            seq_parts.append(line.rstrip("\n"))
            line = fh.readline()
        if not line.startswith("+"):
            raise ValueError("malformed FASTQ record: missing '+' line")
        seq = "".join(seq_parts)
        qual_parts: list = []
        qlen = 0
        while qlen < len(seq):
            line = fh.readline()
            if not line:
                raise ValueError("truncated FASTQ record: quality shorter "
                                 "than sequence")
            q = line.rstrip("\n")
            qual_parts.append(q)
            qlen += len(q)
        if qlen > len(seq):
            raise ValueError("malformed FASTQ record: quality longer than "
                             "sequence")
        h = header[1:]
        yield SeqRecord(id=h.split()[0] if h else "", header=h, seq=seq,
                        qual="".join(qual_parts))
        line = fh.readline()


def _parse_fasta(fh: io.TextIOBase) -> Iterator[SeqRecord]:
    header: Optional[str] = None
    chunks: list = []
    for line in fh:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if header is not None:
                h = header
                yield SeqRecord(id=h.split()[0] if h else "", header=h, seq="".join(chunks))
            header = line[1:]
            chunks = []
        elif line:
            chunks.append(line)
    if header is not None:
        h = header
        yield SeqRecord(id=h.split()[0] if h else "", header=h, seq="".join(chunks))
