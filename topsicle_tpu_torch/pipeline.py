"""TorchEngine: the topsicle_tpu streaming engine on torch devices.

It inherits the host pipeline of topsicle_tpu.pipeline.JaxEngine, which
is framework-free: block parsing and the encoded-block cache, the
step-1 stream with host f64 TRC selection, step-2 batching with two
batches in flight, subset emission, resume.  It replaces what touches
JAX: the models, warmup, precompile, global mode's lockstep loop and
`run`, whose JAX version imports the jax-backed `parallel` package.  Its
CSV, subset files and aggregate lines are byte-identical to JaxEngine's,
and so are the --rawcountpattern CSVs and the names of the --plot PNGs,
in every mode:

  one process on one device, or its batches split by rows over every
      visible card (parallel.sharding.ShardedScanModel)
  files mode over processes (--processId/--processCount, with or without
      --coordinator): files dealt round-robin, part files merged by
      process 0 (parallel.distributed)
  --shardMode global: lockstep global batches over a gloo process group
      (parallel.multihost)
  a telophrase past the device k-mer capacity (k > 15) is computed on the
      host for that phrase only (models.oracle_model), as JaxEngine does

The one case the port refuses is --kernel xla: it has no XLA path.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from topsicle_tpu import aggregate
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import batch as batching
from topsicle_tpu.io import blockcache, reader, writer
from topsicle_tpu.kmers import patterns_to_search
from topsicle_tpu.oracle.reference import ReadResult
from topsicle_tpu.pipeline import JaxEngine, _Passer
from topsicle_tpu.utils.manifest import RunManifest
from topsicle_tpu.utils.profiling import StageTimers
from topsicle_tpu_torch import ops
from topsicle_tpu_torch.device import describe
from topsicle_tpu_torch.models.oracle_model import OracleScanModel
from topsicle_tpu_torch.models.telomere import (TorchScanModel, _batch_is_clean,
                                                resolve_kernel)
from topsicle_tpu_torch.ops import cuda_kernels
from topsicle_tpu_torch.parallel import distributed
from topsicle_tpu_torch.parallel.mesh import local_devices
from topsicle_tpu_torch.parallel.multihost import GlobalScanModel, or_across_processes
from topsicle_tpu_torch.parallel.sharding import ShardedScanModel


def refuse_unported(cfg: TopsicleConfig) -> None:
    """Raise ValueError for configurations the port does not serve."""
    if cfg.use_pallas is False:
        raise ValueError("--kernel xla is not served by the torch engine: it has no XLA "
                         "path (ROADMAP.md queue 1 item 5); use topsicle_tpu for it")
    resolve_kernel(cfg.use_pallas)


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
    """The engine on torch devices: 'cuda' computes on every card this
    process sees (batches split by rows when there are several), 'cpu'
    on the CPU, a torch.device on that device alone."""

    def __init__(self, cfg: TopsicleConfig, log: Optional[writer.RunLog] = None,
                 device: str | torch.device = "cuda"):
        super().__init__(cfg, log)
        refuse_unported(cfg)
        self.devices = [device] if isinstance(device, torch.device) else local_devices(device)
        self.device = self.devices[0]

    # -- models ------------------------------------------------------------
    def _model(self, phrase: int, kmers: Sequence[str]):
        if phrase not in self._models:
            cfg = self.cfg
            if phrase > ops.MAX_ROLLING_K:
                self.log(f"WARNING: telophrase {phrase} exceeds the device k-mer capacity "
                         f"({ops.MAX_ROLLING_K}); computing this phrase on the host oracle "
                         "path (slower)")
                self._models[phrase] = OracleScanModel(
                    kmers, window_size=cfg.window_size, slide=cfg.slide_value())
                return self._models[phrase]
            model = TorchScanModel(kmers, device=self.device, window_size=cfg.window_size,
                                   slide=cfg.slide_value(), kernel=cfg.use_pallas)
            n_dev = len(self.devices)
            if n_dev > 1:
                # equal shards: the device batch is the batch size rounded
                # up to a multiple of the device count
                self._device_batch = -(-cfg.batch_size // n_dev) * n_dev
                model = ShardedScanModel(model, self.devices)
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
            if isinstance(model, OracleScanModel):
                continue
            self.log(f"precompile: k={phrase} ready on {describe(model.device)}")
        return 1 if self.device.type == "cuda" else 0

    # -- one (file, phrase) unit ---------------------------------------------
    def _run_unit(self, path: str, phrase: int, kmers: Sequence[str], model, src,
                  timers):
        """Step 1 -> subset file -> step 2 (and the per-read extras of
        --rawcountpattern/--plot) for one unit.  Returns its reads'
        results in input order, or None when the input is unreadable:
        the unit then stays un-done for --resume, and the extras files
        its early batches wrote are removed."""
        cfg = self.cfg
        self.log("subsetting raw dataset based on TRC cutoff")
        lbl = writer.file_label(path)
        hit_ids: List[str] = []
        unit_rows: List[ReadResult] = []
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
                    unit_rows.append(ReadResult(lbl, phrase, p.read_id, p.trc, b, p.kmer,
                                                p.tail))
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

    # -- --shardMode global --------------------------------------------------
    def _run_phrase_global(self, phrase: int, kmers: Sequence[str],
                           local_files, timers):
        """One telophrase in global-batch mode: JaxEngine's unified
        lockstep scheduler, unchanged but for its models.  Every process
        contributes a B_local shard of each global batch, computed on its
        own devices with the auto kernel choice (JaxEngine's global mode
        also ignores --kernel); the per-read records are all-gathered and
        each process keeps the rows of reads it contributed.  Lockstep is
        held by a per-iteration OR-allgathered control word; processes
        whose streams run dry keep feeding empty shards until every stream
        and buffer is dry.  Returns ({file_idx: (label, [row, ...],
        [trc, ...], [telo, ...])}, failed_file_idxs) for this process."""
        cfg = self.cfg
        cutoff = cfg.min_cutoff()
        n_local_dev = len(self.devices)
        B_local = -(-cfg.batch_size // n_local_dev) * n_local_dev
        local = TorchScanModel(kmers, device=self.device, window_size=cfg.window_size,
                               slide=cfg.slide_value())
        if n_local_dev > 1:
            local = ShardedScanModel(local, self.devices)
        self._warmup(local)
        gmodel = GlobalScanModel(local)

        # lockstep needs one global shape: always the static scan length
        L_static = cfg.static_scan_length()
        if L_static is None:
            self.log("shardMode=global requires one static scan length; "
                     "--scanLengthMode bucket is not honored in this mode")
            q = cfg.length_bucket_quantum
            span = max(1, cfg.maxlengthtelo - cfg.trimfirst)
            L_static = max(q, -(-span // q) * q)

        failed: set = set()

        def stream_blocks():
            for file_idx, path in local_files:
                try:
                    src = self._read_source(path)
                    try:
                        order = 0
                        for blk in src:
                            ends, elen = batching.ends_batch_flat(
                                blk.codes, blk.offs, cfg.no_bp)
                            yield (file_idx, path, order, blk, ends, elen)
                            order += len(blk)
                    finally:
                        src.close()
                except reader.InputFileError as e:
                    failed.add(file_idx)
                    self.log(f"ERROR: {e}; skipping this file")

        # Each iteration every process computes the same 5-bit control word
        #     [s1_has, s1_dense, s2_full, s2_live, s2_dense]
        # and derives the same schedule: a step-1 batch if any process has
        # reads; a step-2 batch if any process has a full passer batch, or
        # if no step-1 data is left anywhere and passers or in-flight work
        # remain somewhere.  So every process issues the same sequence of
        # launches and gathers.
        it = stream_blocks()
        pbuf: List[Tuple[int, str, _Passer]] = []
        exhausted = False
        cur = None      # partially consumed block: [meta..., ends, elen, pos]
        hit_ids: Dict[int, set] = {}
        rows: Dict[int, tuple] = {}
        extras: Dict[int, list] = {}
        want_extras = cfg.plot or cfg.rawcountpattern

        def drain_step1(buf, fut):
            mine = gmodel.my_rows(np.asarray(fut), B_local)[: len(buf)]
            if not len(buf):
                return
            keep, sel_j, fwd, trc = self._select_hits(mine, cutoff)
            for i in np.nonzero(keep)[0]:
                i = int(i)
                file_idx, path, order, rid, blk, bi = buf[i]
                codes = blk.codes[blk.offs[bi]:blk.offs[bi + 1]]
                tail = "forward" if fwd[i] else "reverse"
                tail_codes = batching.extract_tail(
                    codes, tail, cfg.trimfirst, cfg.maxlengthtelo).copy()
                hit_ids.setdefault(file_idx, set()).add(rid)
                pbuf.append((file_idx, path, _Passer(
                    order, rid, kmers[int(sel_j[i])], tail, float(trc[i]),
                    tail_codes, len(codes), clean=bool((tail_codes < 4).all()))))

        extras_done: Dict[int, int] = {}   # file_idx -> next image number

        def flush_extras(f):
            pairs = extras.pop(f, [])
            if not pairs:
                return
            if f in failed:
                for p, _ in pairs:
                    p.tail_codes = None
                return
            Bc = cfg.batch_size
            image_num = extras_done.get(f, 1)
            for s in range(0, len(pairs), Bc):
                chunk = pairs[s:s + Bc]
                self._per_read_extras([p for p, _ in chunk], local, phrase,
                                      [b for _, b in chunk], image_num)
                image_num += len(chunk)
            extras_done[f] = image_num
            for p, _ in pairs:
                p.tail_codes = None

        def drain_step2(group, fut):
            t, has = (np.asarray(x) for x in fut)
            t_mine = gmodel.my_rows(t, B_local)
            has_mine = gmodel.my_rows(has, B_local)
            for j, (file_idx, path, p) in enumerate(group):
                maxc = min(cfg.maxlengthtelo, p.seq_len)
                b = int(cfg.trimfirst + cfg.slide_value() * int(t_mine[j])) \
                    if has_mine[j] else 0
                if b == 0 or b > maxc:
                    b = 0
                lbl = writer.file_label(path)
                entry = rows.setdefault(file_idx, (lbl, [], [], []))
                entry[1].append([lbl, phrase, f"{p.trc:.3f}", p.read_id, b])
                entry[2].append(float(p.trc))      # full precision for quadfit
                entry[3].append(float(b))
                if want_extras:
                    extras.setdefault(file_idx, []).append((p, b))
                else:
                    p.tail_codes = None
                timers.count(reads=1, bases=p.seq_len)
            if want_extras and group:
                # passers drain in stream order: files below the newest
                # one seen are complete
                maxf = max(fi for fi, _, _ in group)
                for f in [f for f in list(extras) if f < maxf]:
                    flush_extras(f)

        def assemble_step1():
            nonlocal cur, exhausted
            buf = []
            pieces_e: List[np.ndarray] = []
            pieces_l: List[np.ndarray] = []
            while len(buf) < B_local and not exhausted:
                if cur is None:
                    try:
                        file_idx, path, order, blk, ends_blk, elen_blk = next(it)
                        cur = [file_idx, path, order, blk, ends_blk, elen_blk, 0]
                    except StopIteration:
                        exhausted = True
                        break
                file_idx, path, order, blk, ends_blk, elen_blk, pos = cur
                take = min(B_local - len(buf), len(blk) - pos)
                pieces_e.append(ends_blk[pos:pos + take])
                pieces_l.append(elen_blk[pos:pos + take])
                for j in range(pos, pos + take):
                    buf.append((file_idx, path, order + j, blk.ids[j], blk, j))
                cur[6] = pos + take
                if cur[6] >= len(blk):
                    cur = None
            n = len(buf)
            ends = np.full((B_local, 2, cfg.no_bp), 0xFF, np.uint8)
            ends_len = np.zeros(B_local, np.int32)
            if n:
                ends[:n] = np.concatenate(pieces_e, axis=0)
                ends_len[:n] = np.concatenate(pieces_l)
            return buf, ends, ends_len

        def launch_step2(group, dense):
            codes = np.full((B_local, L_static), 0xFF, np.uint8)
            lens = np.zeros(B_local, np.int32)
            if group:
                c, ln = batching.tails_batch([p.tail_codes for _, _, p in group],
                                             L_static, cfg.length_bucket_quantum)
                codes[:len(group), :c.shape[1]] = c
                lens[:len(group)] = ln
            n_windows = batching.window_counts_for_lengths(
                lens, cfg.window_size, cfg.slide_value())
            return gmodel.step2_boundary_global_launch(codes, n_windows, lens, dense=dense)

        prev1 = None    # (buf, in-flight counts)
        prev2 = None    # (group, in-flight (t, has))
        while True:
            buf, ends, ends_len = assemble_step1()
            n1 = len(buf)
            if n1 == 0 and prev1 is not None:
                # my stream just dried: drain the in-flight batch before
                # the control word, so s2_live is exact
                drain_step1(*prev1)
                prev1 = None
            s1_clean = _batch_is_clean(
                ends.reshape(B_local * 2, -1), np.repeat(ends_len, 2))
            group = pbuf[:B_local]
            s2_clean = all(p.clean for _, _, p in group)
            word = or_across_processes(np.array([
                n1 > 0, not s1_clean,
                len(pbuf) >= B_local, bool(pbuf), not s2_clean,
            ]))
            s1_go = bool(word[0])
            s2_go = bool(word[2]) or (not s1_go and bool(word[3]))
            fut1 = gmodel.step1_counts_global_launch(
                ends, ends_len, dense=bool(word[1])) if s1_go else None
            fut2 = None
            if s2_go:
                del pbuf[: len(group)]
                fut2 = launch_step2(group, dense=bool(word[4]))
            if prev1 is not None:
                drain_step1(*prev1)
            prev1 = (buf, fut1) if fut1 is not None else None
            if prev2 is not None:
                drain_step2(*prev2)
            prev2 = (group, fut2) if fut2 is not None else None
            if not s1_go and not s2_go and prev1 is None and prev2 is None:
                break

        # extras of the final files, before the subsets, so a subset
        # failure can still remove the unit's flushed extras
        if want_extras:
            for file_idx in sorted(list(extras)):
                flush_extras(file_idx)
        for file_idx, path in local_files:
            if file_idx in failed:
                continue
            try:
                self._write_subset(path, hit_ids.get(file_idx, set()))
            except reader.InputFileError as e:
                failed.add(file_idx)
                self.log(f"ERROR: {e}; subset not written")
                self._remove_unit_extras(phrase, extras_done.get(file_idx, 1))
        return rows, failed

    # -- full run ------------------------------------------------------------
    def run(self) -> List[ReadResult]:
        cfg = self.cfg
        timers = StageTimers()
        os.makedirs(cfg.output_dir, exist_ok=True)
        csv_path = os.path.join(cfg.output_dir, "telolengths_all.csv")
        self.log(f"Output will be here: {csv_path}")
        self.log(f"device: {', '.join(describe(d) for d in self.devices)}")

        pid, nproc = distributed.process_identity(cfg.process_id, cfg.process_count)
        dist = nproc > 1
        if dist and (cfg.resume or cfg.read_check is not None):
            raise ValueError("distributed runs do not support resume or read_check")
        if cfg.shard_mode == "global":
            if cfg.read_check is not None:
                raise ValueError("shardMode=global does not support read_check "
                                 "(use shardMode=files)")
            world = distributed.world()[1]
            if dist and world != nproc:
                raise ValueError(
                    "shardMode=global needs a torch.distributed process group across "
                    f"all processes (it has {world} process(es), --processCount says "
                    f"{nproc}); pass --coordinator")
        if dist:
            # drop this process's stale marker and parts of a crashed run
            distributed.reset_mine(cfg.output_dir, pid, nproc)

        manifest = None
        kept_rows: Dict[tuple, List[tuple]] = {}
        if cfg.resume:
            manifest, kept_rows = self._prepare_resume(csv_path)
        elif not dist or pid == 0:
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
        local_files = distributed.my_files(paths, pid, nproc)
        if self._bc_enabled:
            # fresh budget per run; a fresh run never replays an old cache.
            # Processes of a distributed run start unsynchronised, so they
            # leave the clear to process 0 after the merge.
            self._bc_left = blockcache.cache_budget_bytes()
            self._bc_skip.clear()
            if not cfg.resume and not dist:
                blockcache.clear(cfg.output_dir)

        def emit(path, file_idx, phrase, unit: List[ReadResult]):
            """A computed unit: its CSV rows (a part file when distributed),
            results, full-precision aggregates and manifest entry."""
            rows = [[r.file_label, phrase, f"{r.trc:.3f}", r.read_id, r.telo_length]
                    for r in unit]
            trcs = [r.trc for r in unit]
            telos = [float(r.telo_length) for r in unit]
            if dist:
                distributed.write_part(cfg.output_dir, phrase, file_idx, rows, trcs, telos)
            else:
                for row in rows:
                    writer.append_csv_row_raw(csv_path, row)
            results.extend(unit)
            phrase_to_trc.setdefault(phrase, []).extend(trcs)
            phrase_to_telo.setdefault(phrase, []).extend(telos)
            if not dist and cfg.read_check is None:
                manifest.mark_done(path, phrase, len(unit), trcs=trcs)

        def kept(path, phrase):
            """Re-emit a unit --resume found done; False if it is not."""
            if not (cfg.resume and manifest.is_done(path, phrase)):
                return False
            self.log(f"resume: skipping completed unit {path} (k={phrase})")
            self._emit_kept_unit(csv_path, writer.file_label(path), phrase, path, manifest,
                                 kept_rows, results, phrase_to_telo, phrase_to_trc)
            return True

        phrases = cfg.telophrases()
        with torch_trace(cfg.trace_dir, self.device):
            for phrase_i, phrase in enumerate(phrases):
                # the last phrase's parse is never replayed: no cache writes
                self._bc_write = self._bc_enabled and phrase_i != len(phrases) - 1
                kmers = patterns_to_search(cfg.pattern, phrase)
                self.log("patterns to search:", kmers)
                if cfg.shard_mode == "global":
                    self.log("begin processing reads (global mesh)")
                    todo = [(i, p) for i, p in local_files
                            if not (cfg.resume and manifest.is_done(p, phrase))]
                    rows_by_file, failed = self._run_phrase_global(phrase, kmers, todo,
                                                                   timers)
                    for file_idx, path in local_files:
                        if kept(path, phrase) or file_idx in failed:
                            continue
                        lbl = writer.file_label(path)
                        _, rows, trcs, _ = rows_by_file.get(file_idx, (lbl, [], [], []))
                        emit(path, file_idx, phrase,
                             [ReadResult(lbl, phrase, r[3], trc, r[4])
                              for r, trc in zip(rows, trcs)])
                    continue

                model = self._model(phrase, kmers)
                self.log("begin processing reads")
                # read ahead: up to threads-1 later files parse while this
                # one drives the device; files are consumed in order, so the
                # CSV is the same at any thread count
                ahead = max(0, cfg.threads_value() - 1)
                todo = [p for _, p in local_files
                        if not (cfg.resume and manifest.is_done(p, phrase))]
                todo_pos = {p: i for i, p in enumerate(todo)}
                sources: Dict[str, object] = {}
                try:
                    for file_idx, path in local_files:
                        if kept(path, phrase):
                            continue
                        src = sources.pop(path, None) or self._read_source(path)
                        j = todo_pos[path]
                        for q in todo[j + 1:j + 1 + ahead]:
                            if q not in sources:
                                sources[q] = self._read_source(q)
                        unit = self._run_unit(path, phrase, kmers, model, src, timers)
                        if unit is not None:
                            emit(path, file_idx, phrase, unit)
                finally:
                    # abandoned read-ahead sources must not leave reader
                    # threads blocked on full queues holding file handles
                    for s in sources.values():
                        s.close()
                self.log("finished processing all reads")
        if self._bc_enabled and not dist:
            blockcache.clear(cfg.output_dir)
        self.log(timers.summary())

        if dist:
            distributed.mark_done(cfg.output_dir, pid, nproc)
            distributed.barrier()
            if pid != 0:
                return results
            run_parts = distributed.wait_all(cfg.output_dir, nproc)
            phrase_to_trc, phrase_to_telo = distributed.merge(cfg.output_dir, csv_path,
                                                              run_parts)
            distributed.cleanup_parts(cfg.output_dir)
            if self._bc_enabled:
                blockcache.clear(cfg.output_dir)
        aggregate.summarize_all(phrase_to_trc, phrase_to_telo, cfg.input_trc(),
                                log=self.log, plot_fn_for_phrase=self._quadfit_plot)
        self.log("All telomere found, have a nice day.")
        return results
