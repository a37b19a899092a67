"""`topsicle-torch` console entry point: the reference-compatible CLI of
topsicle_tpu (same flags, same run-log lines, same outputs) on the
torch engine, plus --device {cuda,cpu}.

Every k-mer table is served (aperiodic, periodic and mixed, any number
of entries; k > 15 on the host for that phrase), with --telophrase
sweeps, --kernel auto|sum|greedy|xla (xla takes the auto route: the port
has no XLA programs, and the bytes are the same), --rawcountpattern,
--plot, any --maxlengthtelo (a scan too long for one thread block runs on
the kernels' window-block grid), every card the process sees, files mode
over processes (--processId/--processCount, with or without
--coordinator) and --shardMode global.

Run from a checkout with `python -m topsicle_tpu_torch.cli ...`, e.g. a
mixed-table sweep on the card:

    python -m topsicle_tpu_torch.cli --inputDir reads.fastq.gz \\
        --outputDir out --pattern CCCTAA --telophrase 5 6 --device cuda

or two processes in global mode, each on its own card:

    for i in 0 1; do CUDA_VISIBLE_DEVICES=$i python -m topsicle_tpu_torch.cli \\
        --inputDir reads/ --outputDir out --pattern CCCTAAA --device cuda \\
        --shardMode global --coordinator 127.0.0.1:29500 \\
        --processId $i --processCount 2 & done; wait

On a read-only install, point the compile cache at a writable volume and
build the kernels and the C++ reader there once; later jobs load both:

    TOPSICLE_COMPILE_CACHE=/scratch/topsicle topsicle-torch --precompile \
        --inputDir x --outputDir warm --pattern CCCTAAA --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

from topsicle_tpu_torch.config import TopsicleConfig
from topsicle_tpu_torch.io.writer import RunLog
from topsicle_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed
from topsicle_tpu_torch.pipeline import make_engine
from topsicle_tpu_torch.utils import compile_cache
from topsicle_tpu_torch.utils.profiling import StageTimers, trace_context


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="topsicle-torch",
        description="Topsicle on PyTorch/CUDA - Telomere length estimation from long reads",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--inputDir", "-i", type=str, metavar="FILE/FOLDER", required=True,
                   help="FASTA/FASTQ input: one file or a directory tree (gzip OK)")
    p.add_argument("--outputDir", "-o", type=str, metavar="FOLDER", required=True,
                   help="Directory where the CSV, log, subset files, and plots go")
    p.add_argument("--pattern", metavar="CHAR", type=str, required=True,
                   help="Telomere repeat unit, written 5'->3' (A. thaliana: CCCTAAA; human: CCCTAA)")
    p.add_argument("--minSeqLength", metavar="INT", type=int, default=9000,
                   help="Skip reads whose length is not strictly greater than this")
    p.add_argument("--rawcountpattern", action="store_true",
                   help="Also emit per-window, per-k-mer count tables (rawcount_{k}_{n}.csv)")
    p.add_argument("--telophrase", nargs="+", metavar="INT", type=int,
                   help="k-mer size(s) to scan with; omitted => len(pattern) - 2")
    p.add_argument("--cutoff", nargs="+", metavar="FLOAT", type=float, default=0.7,
                   help="TRC threshold(s); the minimum filters reads, the first anchors the quadratic fit")
    p.add_argument("--windowSize", metavar="INT", type=int, default=100,
                   help="Width (bp) of the step-2 scan window")
    p.add_argument("--slide", metavar="INT", type=int,
                   help="Distance between window starts; omitted => len(pattern)")
    p.add_argument("--trimfirst", metavar="INT", type=int, default=100,
                   help="Bases to drop from the telomeric end before the window scan")
    p.add_argument("--maxlengthtelo", metavar="INT", type=int, default=20000,
                   help="Cap (bp) on how far into each read the boundary search goes")
    p.add_argument("--plot", action="store_true",
                   help="Save a window-signal + changepoint figure for every passing read")
    p.add_argument("--rangecp", metavar="INT", type=int,
                   help="x-axis limit of the per-read changepoint figure (defaults to maxlengthtelo)")
    p.add_argument("--read_check", metavar="STR", type=str,
                   help="Restrict step 2 to a single read ID (debugging aid)")
    p.add_argument("--override", "-ov", action="store_true",
                   help="Replace an existing non-empty telolengths_all.csv; subset files are reused")
    p.add_argument("--threads", "-t", metavar="INT", type=int, default=None,
                   help="Host parse/encode workers: up to N input files are read "
                        "concurrently (the current one plus N-1 ahead of the device). "
                        "Default: all available cores; 1 = fully serial")
    # --- device runtime (no reference analog) ---
    p.add_argument("--engine", choices=["jax", "oracle"], default="jax",
                   help="Compute engine: 'jax' (the reference CLI's name for the device "
                        "engine: here the torch engine on --device) or 'oracle' "
                        "(pure-CPU reference semantics)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Torch device: 'cuda' runs the hand-written kernels on "
                        "the card (and fails without one); 'cpu' runs their "
                        "plain torch versions")
    p.add_argument("--batchSize", metavar="INT", type=int, default=128,
                   help="Reads per device batch")
    p.add_argument("--resume", action="store_true",
                   help="Continue an interrupted run: keep completed (file, k) units from the existing CSV/manifest and recompute only the rest")
    p.add_argument("--traceDir", metavar="FOLDER", type=str, default=None,
                   help="Write a torch.profiler trace of the run to this directory")
    p.add_argument("--precompile", action="store_true",
                   help="Build and load the CUDA kernels' library (on a card) "
                        "and the C++ reader into the compile cache "
                        "(TOPSICLE_COMPILE_CACHE, else the package's _build/) "
                        "and check every telophrase's table, then exit without "
                        "reading input (run once per machine/cache volume so "
                        "later jobs start without building)")
    p.add_argument("--scanLengthMode", choices=["static", "bucket"], default="static",
                   help="Step-2 padding: 'static' = one scan length for the whole "
                        "run; 'bucket' = pad per batch (less compute on "
                        "short-read data)")
    p.add_argument("--kernel", choices=["auto", "xla", "greedy", "sum"],
                   default="auto",
                   help="Step-2 window-signal kernel: 'auto' (default) and 'sum' take the "
                        "CUDA sum kernel when every k-mer of the table is aperiodic and it "
                        "has at most 31 entries, else the CUDA greedy kernel ('sum' warns "
                        "then); 'auto' runs the sum kernel fused with the changepoint in "
                        "one launch, 'sum' runs the two one after the other (the same "
                        "bytes out); 'greedy' always takes the greedy kernel, exact for "
                        "every table; 'xla' takes the auto route with one log line (the "
                        "port has no XLA programs; the bytes are the same)")
    # --- multi-host (reference analog: manual SLURM job splitting,
    # README.md:261-270 — here it is automatic and deterministic) ---
    p.add_argument("--coordinator", metavar="HOST:PORT", type=str, default=None,
                   help="torch.distributed (gloo) rendezvous address for multi-process runs")
    p.add_argument("--processId", metavar="INT", type=int, default=None,
                   help="This process's index (with --processCount; inferred from the process group otherwise)")
    p.add_argument("--processCount", metavar="INT", type=int, default=None,
                   help="Total processes sharing the run (input files are sharded round-robin; process 0 merges)")
    p.add_argument("--shardMode", choices=["files", "global"], default="files",
                   help="Multi-host layout: 'files' = each process computes its own files; "
                        "'global' = lockstep global batches, one shard per process (needs --coordinator)")
    return p


def config_from_args(args: argparse.Namespace) -> TopsicleConfig:
    return TopsicleConfig(
        input_dir=args.inputDir,
        output_dir=args.outputDir,
        pattern=args.pattern,
        min_seq_length=args.minSeqLength,
        rawcountpattern=args.rawcountpattern,
        telophrase=args.telophrase,
        cutoff=args.cutoff,
        window_size=args.windowSize,
        slide=args.slide,
        trimfirst=args.trimfirst,
        maxlengthtelo=args.maxlengthtelo,
        plot=args.plot,
        rangecp=args.rangecp,
        read_check=args.read_check,
        override=args.override,
        threads=args.threads,
        engine=args.engine,
        batch_size=args.batchSize,
        resume=args.resume,
        trace_dir=args.traceDir,
        scan_length_mode=args.scanLengthMode,
        use_pallas={"auto": None, "xla": False,
                    "greedy": "greedy", "sum": "sum"}[args.kernel],
        process_id=args.processId,
        process_count=args.processCount,
        shard_mode=args.shardMode,
    )


def main(argv=None) -> int:
    """One job.  Its recorder (utils/profiling.py) spans the job from the
    parsed arguments until the engine's run returns (`job`), with the
    set-up (`setup`) and what the engine's run records inside; after the
    run's closing line the run log gets the `spans:` and `counters:`
    lines.  --traceDir traces the whole job, the spans with it."""
    start_time = time.time()
    args = build_parser().parse_args(argv)
    timers = StageTimers()
    with trace_context(args.traceDir, cuda=args.device == "cuda"), timers.span("job"):
        log = RunLog(args.outputDir)
        rc = _job(args, log, timers)
    if rc != 0:
        return rc
    if not args.precompile:
        log(timers.spans_line())
        log(timers.counters_line())
    print(f"Elapsed time(s): {time.time() - start_time:.2f} seconds")
    return 0


def _job(args: argparse.Namespace, log: RunLog, timers: StageTimers) -> int:
    with timers.span("setup"):
        log.plain("---- Topsicle run parameters ---")
        for k, v in vars(args).items():
            log(f"{k}: {v}")
        log.plain("---------------------")
        log("Starting Topsicle analysis")

        cfg = config_from_args(args)
        try:
            cfg.validate()
        except ValueError as e:
            log(str(e))
            return 2
        if args.telophrase is None:
            log(f"No telophrase provided, use kmer: {cfg.telophrases()}")
        log.plain("---------------------")

        if args.coordinator:
            initialize_distributed(args.coordinator, args.processCount, args.processId)
    try:
        with timers.span("setup"):
            engine = make_engine(cfg, log=log, device=args.device, timers=timers)
        if args.precompile:
            if cfg.engine == "oracle":
                log("--precompile only applies to the device engine")
                return 2
            n = engine.precompile()
            log(f"precompile: {n} kernel libraries in {compile_cache.default_cache_dir()}; "
                "ready")
        else:
            engine.run()
    except FileExistsError as e:
        log(str(e))
        return 1
    except ValueError as e:
        log(str(e))
        return 2
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
