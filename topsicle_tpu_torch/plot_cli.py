"""`topsicle-overview` — the overview/plot pipeline CLI (reference:
overview_plot.py:38-138).

Per input file: step-1 filter at the reference's hard-coded cutoff 0.7
(overview_plot.py:63), write a temp filtered file, draw the descriptive
plot, optionally the k-mer/match heatmap (+ raw-count CSV), clean up.
"""

from __future__ import annotations

import argparse
import os
import sys

from topsicle_tpu_torch.io import reader, writer
from topsicle_tpu_torch.kmers import patterns_to_search
from topsicle_tpu_torch.oracle.reference import step1_trc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="topsicle-overview",
        description="Draw exploratory plots (read-level match scatter, and "
                    "optionally a k-mer-vs-following-bases heatmap) for reads "
                    "that pass the step-1 telomere filter at TRC 0.7.",
    )
    p.add_argument("--inputDir", type=str,
                   help="FASTA/FASTQ file, or a directory that is walked for them")
    p.add_argument("--outputDir", type=str,
                   help="Directory where the PNGs (and optional CSVs) are written")
    p.add_argument("--pattern", metavar="CHAR", type=str, required=True,
                   help="Telomere repeat unit, 5'->3' (e.g. CCCTAAA for "
                        "A. thaliana; CCCTAA for human)")
    p.add_argument("--minSeqLength", type=int, default=9000,
                   help="Reads at or below this length (bp) are ignored "
                        "(default 9000)")
    p.add_argument("--telophrase", nargs="+", type=int,
                   help="k-mer length(s) for the filter/heatmap; defaults to "
                        "len(pattern)-2 when omitted")
    p.add_argument("--recfindingpattern", action="store_true",
                   help="Also draw the rotation-vs-following-bases heatmap "
                        "(useful for discovering/verifying the repeat unit)")
    p.add_argument("--rawcount", action="store_true",
                   help="Write each heatmap's underlying count table as "
                        "heatmap_rawcount_{i}.csv next to the PNG")
    return p


def _filter_file(seq_loc: str, out_path: str, pattern: str, phrase: int,
                 min_seq_length: int) -> bool:
    """Step-1 filter at cutoff 0.7; returns True if any read passed."""
    kmers = patterns_to_search(pattern, phrase)
    keep = set()
    for rec in reader.parse_records(seq_loc):
        if len(rec.seq) > min_seq_length:
            if step1_trc(rec.seq, kmers, len(pattern), 1000, 0.7) is not None:
                keep.add(rec.id)
    if not keep:
        return False
    # format by extension, reference rule (overview_plot.py:72-75:
    # .fastq/.fastq.gz only — note: .fq is NOT fastq here)
    fmt = "fastq" if seq_loc.endswith((".fastq", ".fastq.gz")) else "fasta"
    with open(out_path, "w") as fh:
        for rec in reader.parse_records(seq_loc):
            if rec.id in keep:
                writer.write_record(fh, rec, fmt)
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.outputDir, exist_ok=True)

    if os.path.isdir(args.inputDir):
        filenames = []
        for root, _dirs, files in os.walk(args.inputDir):
            for name in files:
                filenames.append(os.path.join(root, name))
    else:
        filenames = [args.inputDir]

    if args.telophrase is None:
        telo_phrases = [len(args.pattern) - 2]
        print(f"No telophrase provided, use kmer: {telo_phrases}")
    else:
        telo_phrases = list(args.telophrase)

    filtered_files = []
    for idx, seq_loc in enumerate(filenames, start=1):
        tmp = os.path.join(args.outputDir, f"temp_reads_in_heatmap_{idx}.fasta")
        if _filter_file(seq_loc, tmp, args.pattern, telo_phrases[0], args.minSeqLength):
            filtered_files.append(tmp)

    print(f"Step-1 filtering done: {len(filtered_files)} file(s) kept; drawing plots")

    from topsicle_tpu_torch.plots.overview import descriptive_plot, patterns_vs_match_heatmap

    for i, seq_loc in enumerate(filtered_files, start=1):
        print(f"Drawing descriptive plot for {seq_loc}")
        fig = descriptive_plot(seq_loc, pattern=args.pattern,
                               min_seq_length=args.minSeqLength)
        fig.savefig(f"{args.outputDir}/descriptive_plot_{i}.png", format="png", dpi=300)
        import matplotlib.pyplot as plt

        plt.close(fig)
    print(f"Descriptive plot PNG(s) written to {args.outputDir}")

    if args.recfindingpattern:
        for i, seq_loc in enumerate(filtered_files, start=1):
            for phrase in telo_phrases:
                print(f"Drawing heatmap for {seq_loc} (k={phrase})")
                fig, df = patterns_vs_match_heatmap(
                    seq_loc, args.pattern, phrase, args.minSeqLength
                )
                fig.savefig(f"{args.outputDir}/heatmap_{i}.png", format="png", dpi=300)
                import matplotlib.pyplot as plt

                plt.close(fig)
                if args.rawcount:
                    csv_path = f"{args.outputDir}/heatmap_rawcount_{i}.csv"
                    print(f"Writing heatmap count table to {csv_path}")
                    df.to_csv(csv_path, index=False)
        print(f"Heatmap PNG(s) written to {args.outputDir}")

    for f in filtered_files:
        if os.path.exists(f):
            os.remove(f)
            print(f"Removed temp filtered file {f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
