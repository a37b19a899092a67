"""TorchEngine: the topsicle_tpu streaming engine on a torch device.

It inherits the host pipeline of topsicle_tpu.pipeline.JaxEngine, which
is framework-free: block parsing and the encoded-block cache, the
step-1 stream with host f64 TRC selection, step-2 batching with two
batches in flight, subset emission, resume.  It replaces what touches
JAX: the model (TorchScanModel), warmup, precompile, and `run`, whose
JAX version imports the jax-backed `parallel` package.  This `run` is
the single-process, files-mode loop of the reference engine; its CSV,
subset files and aggregate lines are byte-identical to JaxEngine's, and
so are the --rawcountpattern CSVs and the names of the --plot PNGs.

Cases the port refuses (each is a ROADMAP item): k > 15, --kernel xla,
--shardMode global and more than one process.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence

import torch

from topsicle_tpu import aggregate
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import blockcache, reader, writer
from topsicle_tpu.kmers import patterns_to_search
from topsicle_tpu.oracle.reference import ReadResult
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu.utils.manifest import RunManifest
from topsicle_tpu.utils.profiling import StageTimers
from topsicle_tpu_torch.device import describe, resolve_device
from topsicle_tpu_torch.models.telomere import (TorchScanModel, check_table,
                                                resolve_kernel, unsupported)
from topsicle_tpu_torch.ops import cuda_kernels


def refuse_unported(cfg: TopsicleConfig) -> None:
    """Raise ValueError for configurations the port does not serve."""
    if cfg.use_pallas is False:
        raise unsupported("--kernel xla (the port has no XLA path)",
                          "queue 1 item 5")
    resolve_kernel(cfg.use_pallas)
    if cfg.shard_mode != "files":
        raise unsupported(f"--shardMode {cfg.shard_mode}", "queue 1 item 9, multi-GPU")
    if (cfg.process_count or 1) > 1:
        raise unsupported("--processCount > 1", "queue 1 item 9, multi-GPU")
    for phrase in cfg.telophrases():
        check_table(patterns_to_search(cfg.pattern, phrase))


@contextlib.contextmanager
def torch_trace(trace_dir: Optional[str], device: torch.device):
    """--traceDir: a torch.profiler trace of the run (CPU and, on a card,
    CUDA activity) written as <trace_dir>/trace.json."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class TorchEngine(JaxEngine):
    """Single-process engine on one torch device ('cuda' or 'cpu')."""

    def __init__(self, cfg: TopsicleConfig, log: Optional[writer.RunLog] = None,
                 device: str | torch.device = "cuda"):
        super().__init__(cfg, log)
        refuse_unported(cfg)
        self.device = device if isinstance(device, torch.device) else resolve_device(device)

    # -- models ------------------------------------------------------------
    def _model(self, phrase: int, kmers: Sequence[str]):
        if phrase not in self._models:
            model = TorchScanModel(kmers, device=self.device,
                                   window_size=self.cfg.window_size,
                                   slide=self.cfg.slide_value(),
                                   kernel=self.cfg.use_pallas)
            self._warmup(model)
            self._models[phrase] = model
        return self._models[phrase]

    def _warmup(self, model) -> None:
        """Build the CUDA kernels before the first batch, so the build
        shows as set-up time; a failed build raises here."""
        if model.device.type == "cuda":
            cuda_kernels.load_library()

    def precompile(self) -> int:
        """Build and load the kernels' library (on a card) and check every
        phrase's table; returns the number of libraries loaded."""
        for phrase in self.cfg.telophrases():
            model = self._model(phrase, patterns_to_search(self.cfg.pattern, phrase))
            self.log(f"precompile: k={phrase} ready on {describe(model.device)}")
        return 1 if self.device.type == "cuda" else 0

    # -- one (file, phrase) unit ---------------------------------------------
    def _run_unit(self, path: str, phrase: int, kmers: Sequence[str], model, src,
                  timers):
        """Step 1 -> subset file -> step 2 (and the per-read extras of
        --rawcountpattern/--plot) for one unit.  Returns its rows
        (read_id, trc, kmer, tail, bound) in input order, or None when the
        input is unreadable: the unit then stays un-done for --resume, and
        the extras files its early batches wrote are removed."""
        cfg = self.cfg
        self.log("subsetting raw dataset based on TRC cutoff")
        hit_ids: List[str] = []
        unit_rows: List[tuple] = []
        image_num = 1
        try:
            if cfg.read_check is not None:
                passers = self._step1_file(path, kmers, model, source=src)
                with timers.stage("subset"):
                    self._write_subset(path, {p.read_id for p in passers})
                self.log("checking specific read:", cfg.read_check)
                stream = [p for p in passers if p.read_id == cfg.read_check]
                if not stream:
                    raise ValueError(
                        f"read {cfg.read_check!r} did not pass the step-1 TRC filter "
                        "(the reference crashes on this combination; refusing clearly)")
                self.log("step 2 on:", cfg.read_check)
            else:
                def tracked():
                    for p in self._step1_stream(path, kmers, model, source=src,
                                                timers=timers):
                        hit_ids.append(p.read_id)
                        yield p
                stream = tracked()
            for group, bounds, extras in self._step2_batches(stream, model, timers=timers):
                self._per_read_extras(group, model, phrase, bounds, image_num, extras)
                image_num += len(group)
                for p, b in zip(group, bounds):
                    unit_rows.append((p.read_id, p.trc, p.kmer, p.tail, b))
                    timers.count(reads=1, bases=p.seq_len)
                    p.tail_codes = None     # keep peak host memory O(batch)
            if cfg.read_check is None:
                with timers.stage("subset"):
                    self._write_subset(path, set(hit_ids))
        except reader.InputFileError as e:
            self.log(f"ERROR: {e}; skipping this file")
            self._remove_unit_extras(phrase, image_num)
            return None
        finally:
            src.close()
        return unit_rows

    def _quadfit_plot(self, phrase: int):
        """The reference saves the quadfit plot whenever >= 3 points
        exist (main.py:270-273); a plotting failure never kills a run."""
        cfg = self.cfg

        def fn(trc, telo, vx, vy, coeffs):
            try:
                from topsicle_tpu.plots import quadfit_plot

                out = os.path.join(cfg.output_dir, f"quadfit_{phrase}mer_{cfg.pattern}.png")
                quadfit_plot(trc, telo, vx, vy, coeffs, out)
            except Exception as e:
                self.log(f"quadfit plot failed: {e}")
        return fn

    # -- full run ------------------------------------------------------------
    def run(self) -> List[ReadResult]:
        cfg = self.cfg
        timers = StageTimers()
        os.makedirs(cfg.output_dir, exist_ok=True)
        csv_path = os.path.join(cfg.output_dir, "telolengths_all.csv")
        self.log(f"Output will be here: {csv_path}")
        self.log(f"device: {describe(self.device)}")

        kept_rows: Dict[tuple, List[tuple]] = {}
        if cfg.resume:
            manifest, kept_rows = self._prepare_resume(csv_path)
        else:
            if os.path.exists(csv_path) and os.path.getsize(csv_path) > 0:
                if not cfg.override:
                    raise FileExistsError(
                        f"Output file {csv_path} already exists and is not empty. "
                        "Use --override to force overwrite.")
                self.log(f"Output file {csv_path} already exists; overwriting it "
                         "(--override given).")
                os.remove(csv_path)
            writer.write_csv_header(csv_path)
            manifest = RunManifest(cfg.output_dir)
            manifest.reset()

        results: List[ReadResult] = []
        phrase_to_telo: Dict[int, List[float]] = {}
        phrase_to_trc: Dict[int, List[float]] = {}
        paths = cfg.input_paths()
        if self._bc_enabled:
            # fresh budget per run; a fresh run never replays an old cache
            self._bc_left = blockcache.cache_budget_bytes()
            self._bc_skip.clear()
            if not cfg.resume:
                blockcache.clear(cfg.output_dir)
        phrases = cfg.telophrases()
        with torch_trace(cfg.trace_dir, self.device):
            for phrase_i, phrase in enumerate(phrases):
                # the last phrase's parse is never replayed: no cache writes
                self._bc_write = self._bc_enabled and phrase_i != len(phrases) - 1
                kmers = patterns_to_search(cfg.pattern, phrase)
                self.log("patterns to search:", kmers)
                model = self._model(phrase, kmers)
                self.log("begin processing reads")
                # read ahead: up to threads-1 later files parse while this
                # one drives the device; files are consumed in order, so the
                # CSV is the same at any thread count
                ahead = max(0, cfg.threads_value() - 1)
                todo = [p for p in paths
                        if not (cfg.resume and manifest.is_done(p, phrase))]
                todo_pos = {p: i for i, p in enumerate(todo)}
                sources: Dict[str, object] = {}
                try:
                    for path in paths:
                        lbl = writer.file_label(path)
                        if cfg.resume and manifest.is_done(path, phrase):
                            self.log(f"resume: skipping completed unit {path} (k={phrase})")
                            self._emit_kept_unit(csv_path, lbl, phrase, path, manifest,
                                                 kept_rows, results, phrase_to_telo,
                                                 phrase_to_trc)
                            continue
                        src = sources.pop(path, None) or self._read_source(path)
                        j = todo_pos[path]
                        for q in todo[j + 1:j + 1 + ahead]:
                            if q not in sources:
                                sources[q] = self._read_source(q)
                        rows = self._run_unit(path, phrase, kmers, model, src, timers)
                        if rows is None:
                            continue
                        unit_trcs: List[float] = []
                        for rid, trc, kmer, tail, b in rows:
                            writer.append_csv_row(csv_path, lbl, phrase, trc, rid, b)
                            results.append(ReadResult(lbl, phrase, rid, trc, b, kmer, tail))
                            phrase_to_telo.setdefault(phrase, []).append(float(b))
                            phrase_to_trc.setdefault(phrase, []).append(float(trc))
                            unit_trcs.append(float(trc))
                        if cfg.read_check is None:
                            manifest.mark_done(path, phrase, len(rows), trcs=unit_trcs)
                finally:
                    # abandoned read-ahead sources must not leave reader
                    # threads blocked on full queues holding file handles
                    for s in sources.values():
                        s.close()
                self.log("finished processing all reads")
        if self._bc_enabled:
            blockcache.clear(cfg.output_dir)
        self.log(timers.summary())
        aggregate.summarize_all(phrase_to_trc, phrase_to_telo, cfg.input_trc(),
                                log=self.log, plot_fn_for_phrase=self._quadfit_plot)
        self.log("All telomere found, have a nice day.")
        return results
