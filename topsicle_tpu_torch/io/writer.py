"""Reference-compatible output sinks: results CSV, subset FASTQ/FASTA,
and the timestamped run log.

CSV contract (verified bit-exact, SURVEY.md §8 items 10):
    header  file_number,phrase,trc,readID,telo_length
    row     basename-minus-last-extension, k, f"{trc:.3f}", readID, boundary
(the reference tool's main.py:107-109,135-138,198-200.)

Subset-file contract (main.py:64-87): named
`{file_name}_trc_over_{min_cutoff}.{ext}`, format/extension decided by the
*input extension* (fastq only for .fastq/.fq(.gz)); records are rewritten
Biopython-style: FASTQ as 4 lines with a bare '+', FASTA wrapped at 60
columns.  An existing subset file is reused, which is the reference's
de-facto resume mechanism (main.py:65-66, README.md:169).
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Iterable, Optional, TextIO

from topsicle_tpu_torch.io.reader import SeqRecord, extension_format


class RunLog:
    """tprint-compatible logger: `[YYYY-mm-dd HH:MM:SS] msg` to stdout and
    appended to {output_dir}/topsicle_run.log (main.py:31-46)."""

    def __init__(self, output_dir: Optional[str] = None, echo: bool = True):
        self.path: Optional[str] = None
        self.echo = echo
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, "topsicle_run.log")

    def __call__(self, *args) -> None:
        msg = " ".join(str(a) for a in args)
        now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{now}] {msg}"
        if self.echo:
            print(line)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(line + "\n")

    def plain(self, msg: str) -> None:
        """Un-timestamped separator lines (reference uses bare print)."""
        if self.echo:
            print(msg)


CSV_HEADER = ["file_number", "phrase", "trc", "readID", "telo_length"]


def file_label(path: str) -> str:
    """CSV `file_number` column: basename minus its last extension only,
    so `X.fastq.gz` -> `X.fastq` (main.py:54-55)."""
    return os.path.splitext(os.path.basename(path))[0]


def write_csv_header(path: str) -> None:
    with open(path, "w", newline="") as fh:
        csv.writer(fh).writerow(CSV_HEADER)


def append_csv_row(path: str, file_lbl: str, phrase: int, trc: float,
                   read_id: str, telo_length: int) -> None:
    with open(path, "a", newline="") as fh:
        csv.writer(fh).writerow([file_lbl, phrase, f"{trc:.3f}", read_id, telo_length])


def append_csv_row_raw(path: str, row: list) -> None:
    """Append an already-formatted row (resume re-emits kept rows with
    their original trc strings so a resumed run's CSV is byte-identical
    to an uninterrupted one)."""
    with open(path, "a", newline="") as fh:
        csv.writer(fh).writerow(row)


def write_record(fh: TextIO, rec: SeqRecord, fmt: str) -> None:
    if fmt == "fastq":
        qual = rec.qual if rec.qual is not None else "I" * len(rec.seq)
        fh.write(f"@{rec.header}\n{rec.seq}\n+\n{qual}\n")
    else:
        fh.write(f">{rec.header}\n")
        s = rec.seq
        for i in range(0, len(s), 60):
            fh.write(s[i : i + 60] + "\n")


def subset_path(output_dir: str, input_path: str, min_cutoff: float) -> str:
    """Subset-file path per main.py:64-81 (extension-driven format)."""
    ext = extension_format(input_path)
    return os.path.join(output_dir, f"{file_label(input_path)}_trc_over_{min_cutoff}.{ext}")


def write_subset(path: str, records: Iterable[SeqRecord], fmt: str) -> None:
    with open(path, "w") as fh:
        for rec in records:
            write_record(fh, rec, fmt)
