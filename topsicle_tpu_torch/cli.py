"""`topsicle-torch` console entry point: the reference-compatible CLI of
topsicle_tpu (same flags, same run-log lines, same outputs) on the
torch engine, plus --device {cuda,cpu}.

Run from a checkout with `python -m topsicle_tpu_torch.cli ...`.
"""

from __future__ import annotations

import sys
import time

from topsicle_tpu.cli import build_parser as build_reference_parser
from topsicle_tpu.cli import config_from_args
from topsicle_tpu.io.writer import RunLog


def build_parser():
    p = build_reference_parser()
    p.prog = "topsicle-torch"
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Torch device: 'cuda' runs the hand-written kernels on "
                        "the card (and fails without one); 'cpu' runs their "
                        "plain torch versions")
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
    if args.coordinator:
        log("--coordinator is not ported to the torch engine yet "
            "(ROADMAP.md queue 1 item 9, multi-GPU)")
        return 2
    log.plain("---------------------")

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

    print(f"Elapsed time(s): {time.time() - start_time:.2f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
