"""Host input/output layer: streaming FASTA/FASTQ(.gz) parsing, base
encoding, batch assembly, and reference-compatible output sinks."""

from topsicle_tpu_torch.io.reader import SeqRecord, parse_records, sniff_format  # noqa: F401
