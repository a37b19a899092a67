"""`topsicle-torch` console entry point: the reference-compatible CLI of
topsicle_tpu (same flags, same run-log lines, same outputs) on the
torch engine, plus --device {cuda,cpu}.

Every k-mer table is served (aperiodic, periodic and mixed, any number
of entries; k > 15 on the host for that phrase), with --telophrase
sweeps, --kernel auto|sum|greedy, --rawcountpattern, --plot, every card
the process sees, files mode over processes (--processId/--processCount,
with or without --coordinator) and --shardMode global.  Refused:
--kernel xla (the port has no XLA path).

Run from a checkout with `python -m topsicle_tpu_torch.cli ...`, e.g. a
mixed-table sweep on the card:

    python -m topsicle_tpu_torch.cli --inputDir reads.fastq.gz \\
        --outputDir out --pattern CCCTAA --telophrase 5 6 --device cuda

or two processes in global mode, each on its own card:

    for i in 0 1; do CUDA_VISIBLE_DEVICES=$i python -m topsicle_tpu_torch.cli \\
        --inputDir reads/ --outputDir out --pattern CCCTAAA --device cuda \\
        --shardMode global --coordinator 127.0.0.1:29500 \\
        --processId $i --processCount 2 & done; wait
"""

from __future__ import annotations

import sys
import time

from topsicle_tpu.cli import build_parser as build_reference_parser
from topsicle_tpu.cli import config_from_args
from topsicle_tpu.io.writer import RunLog
from topsicle_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed


def build_parser():
    p = build_reference_parser()
    p.prog = "topsicle-torch"
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Torch device: 'cuda' runs the hand-written kernels on "
                        "the card (and fails without one); 'cpu' runs their "
                        "plain torch versions")
    p._option_string_actions["--kernel"].help = (
        "Step-2 window-signal kernel: 'auto' (default) and 'sum' take the "
        "CUDA sum kernel when every k-mer of the table is aperiodic and it "
        "has at most 31 entries, else the CUDA greedy kernel ('sum' warns "
        "then); 'greedy' always takes the greedy kernel, exact for every "
        "table; 'xla' is refused (the port has no XLA path)")
    return p


def main(argv=None) -> int:
    start_time = time.time()
    args = build_parser().parse_args(argv)
    log = RunLog(args.outputDir)

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
        if cfg.engine == "oracle":
            from topsicle_tpu.oracle import OracleEngine

            engine = OracleEngine(cfg, log=log)
        else:
            from topsicle_tpu_torch.pipeline import TorchEngine

            engine = TorchEngine(cfg, log=log, device=args.device)
        if args.precompile:
            if cfg.engine == "oracle":
                log("--precompile only applies to the device engine")
                return 2
            n = engine.precompile()
            log(f"built {n} kernel libraries; ready")
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

    print(f"Elapsed time(s): {time.time() - start_time:.2f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
