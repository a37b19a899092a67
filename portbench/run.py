"""The port's benchmark: one cell of BENCHMARK.json.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (configs/<name>.json: the upstream deployment's
CLI settings) under a traffic mix (mixes/<name>.json).  The command first
makes the cell's input files and a small warm-up input from --seed
(gen/fastq.py, a child process a file), then starts the measured process:
this file again, handed the inputs with --inputs.  Its set-up (setup_s,
from its own start) loads the port and runs one warm-up job.  The window
then runs `topsicle_tpu_torch.cli.main` in that process, one call a job
over the same input directory with a fresh output directory each, back to
back, and closes at the end of the first job that ends at or after
--seconds.  After it the reference (reference/) works out what every job
should have written and check.py compares, every job (the subset files'
bytes in a sample of the jobs drawn from the seed and in the last job;
the others' are deleted in the window, once the next job has ended); the
last line of standard output is the result as JSON.  With --trace 1 the window runs under
torch.profiler and the line carries the per-layer metrics
(metrics/<name>.py) instead of the end-to-end ones.

--smoke runs the same on the CPU at a tiny size (the port's plain torch
versions; no device metric) to check the harness; without it, a run that
finds no CUDA card, or fewer than the cell asks for, exits 3 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import platform
import random
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "topsicle_tpu")
# the share of a window's jobs whose subset files are kept and compared
SUBSET_SAMPLE = 0.25


def since_process_start() -> float:
    """Seconds since this process started (/proc/self/stat, /proc/uptime)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(name: str):
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(cells)})")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return cell, ROOT / cfg_entry["file"], HERE / "mixes" / f"{cell['traffic']}.json", e2e, \
        per_layer


def cli_argv(cli: dict, input_dir: str, out_dir: str, device: str) -> list:
    argv = ["--inputDir", input_dir, "--outputDir", out_dir, "--pattern", cli["pattern"],
            "--windowSize", str(cli["windowSize"]), "--slide", str(cli["slide"]),
            "--trimfirst", str(cli["trimfirst"]), "--maxlengthtelo", str(cli["maxlengthtelo"]),
            "--minSeqLength", str(cli["minSeqLength"]), "--batchSize", str(cli["batchSize"]),
            "--device", device, "--cutoff", *map(str, cli["cutoff"])]
    if cli["telophrase"]:
        argv += ["--telophrase", *map(str, cli["telophrase"])]
    return argv


def stages_of(run_log: str) -> dict:
    """{stage: seconds} from the run log's `stages:` line."""
    with open(run_log) as fh:
        line = [ln for ln in fh if "] stages: " in ln][-1]
    out = {}
    for part in line.split("stages: ", 1)[1].split(";", 1)[0].split(", "):
        if "=" in part:
            name, rest = part.split("=", 1)
            out[name] = float(rest.split("s/", 1)[0])
    return out


class RssPeak:
    """The process's resident high-water mark over a window: VmHWM after
    resetting it (5 into /proc/self/clear_refs), or VmRSS sampled every
    20 ms where the reset is refused."""

    def __init__(self):
        self.how = "VmHWM"
        self._peak = 0
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _status(key: str) -> int:
        with open("/proc/self/status") as fh:
            for ln in fh:
                if ln.startswith(key + ":"):
                    return int(ln.split()[1]) * 1024
        return 0

    def start(self) -> None:
        try:
            with open("/proc/self/clear_refs", "w") as fh:
                fh.write("5")
        except OSError:
            self.how = "VmRSS sampled every 20 ms"
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()

    def _sample(self) -> None:
        while not self._stop.wait(0.02):
            self._peak = max(self._peak, self._status("VmRSS"))

    def stop(self) -> int:
        if self._thread is None:
            return self._status("VmHWM")
        self._stop.set()
        self._thread.join()
        return max(self._peak, self._status("VmRSS"))


class SmiSampler:
    """nvidia-smi's SM clock, power draw and temperature every second
    beside the window."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self, path: str):
        self.path = path
        self.proc = None

    def start(self) -> None:
        try:
            self.fh = open(self.path, "w")
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                 "-lms", "1000"], stdout=self.fh, stderr=subprocess.DEVNULL)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.fh.close()
        cols = {k: [] for k in ("sm_mhz", "power_w", "temp_c")}
        with open(self.path) as fh:
            for ln in fh:
                parts = [p.strip() for p in ln.split(",")]
                try:
                    vals = [float(p) for p in parts]
                except ValueError:
                    continue
                if len(vals) == 3:
                    for k, v in zip(cols, vals):
                        cols[k].append(v)
        return {k: [min(v), statistics.median(v), max(v)] for k, v in cols.items() if v}


def smi(query: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def nvcc_version() -> str:
    for nvcc in ("nvcc", "/usr/local/cuda/bin/nvcc"):
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=30).stdout
            return out.strip().splitlines()[-1]
        except (OSError, subprocess.SubprocessError, IndexError):
            continue
    return "nvcc not found"


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def drop_subsets(out_dir: Path) -> tuple:
    """Deletes a finished job's subset files: (their names, their bytes)."""
    from portbench import check

    if not out_dir.is_dir():
        return [], 0
    names, size = check.subset_names(str(out_dir)), 0
    for n in names:
        size += os.stat(out_dir / n).st_size
        os.unlink(out_dir / n)
    return names, size


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def make_inputs(cfg_path: Path, mix_path: Path, seed: int, work: Path, smoke: bool) -> None:
    """The cell's input directory (work/inputs) and the warm-up input
    (work/warmup) from the seed: a generator process a file, all at once."""
    files = load_json(mix_path)["files"]
    gen = [sys.executable, str(HERE / "gen" / "fastq.py"), "--config", str(cfg_path),
           "--mix", str(mix_path), "--seed", str(seed)] + (["--smoke"] if smoke else [])
    children = [subprocess.Popen(gen + ["--warmup", str(work / "warmup")])]
    try:
        children += [subprocess.Popen(gen + ["--out", str(work / "inputs"), "--only", str(f)])
                     for f in range(files)]
        if any(c.wait() != 0 for c in children):
            raise RuntimeError("an input generator failed")
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description="The port's benchmark: one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--smoke", action="store_true",
                   help="CPU check of the harness at a tiny size; no device metric")
    p.add_argument("--inputs", default=None,
                   help="the measured process: the directory make_inputs filled")
    a = p.parse_args(argv)
    if sys.path and sys.path[0] and Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = str(ROOT)     # import portbench and the port from the checkout
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cell, cfg_path, mix_path, e2e, per_layer = find_cell(a.workload)
    if a.inputs is not None:
        return measure(a, cell, cfg_path, mix_path, e2e, per_layer, Path(a.inputs))
    # the inputs are the harness's: made before the measured process starts,
    # so that its set-up (setup_s) holds only the program's start
    work = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    try:
        t = time.perf_counter()
        make_inputs(cfg_path, mix_path, a.seed, work, a.smoke)
        print("[portbench] inputs " + json.dumps({"made_s": time.perf_counter() - t,
                                                  "done_at": time.time()}), flush=True)
        return subprocess.run([sys.executable, str(HERE / "run.py"), *argv,
                               "--inputs", str(work)]).returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)


def measure(a, cell: dict, cfg_path: Path, mix_path: Path, e2e: list, per_layer: list,
            work: Path) -> int:
    """The measured process: set-up, the window, the check and the result
    line, on the inputs in `work`; every job writes its outputs there too."""
    cfg = load_json(cfg_path)
    cli = cfg["cli"]
    split = {"started_at": time.time() - since_process_start()}
    inputs, warm = work / "inputs", work / "warmup"

    # every cache of the program inside the checkout, at fixed paths
    os.environ["TOPSICLE_COMPILE_CACHE"] = str(CACHE / "compile")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    # the job's cores, as a batch scheduler allots them: the CLI's --threads
    # default and torch's threads resolve from the affinity
    if cfg.get("cores"):
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:int(cfg["cores"])])
    sampler = None
    try:
        t = time.perf_counter()
        import torch
        split["import_torch_s"] = time.perf_counter() - t
        if not a.smoke:
            if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
                print(f"portbench: needs {cell['chips']} CUDA card(s); torch sees "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                      file=sys.stderr)
                return 3
        t = time.perf_counter()
        if not a.smoke:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        split["context_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from topsicle_tpu_torch import cli as port_cli
        from topsicle_tpu_torch import pipeline
        split["port_import_s"] = time.perf_counter() - t

        from portbench import check, devtrace, roofline
        from portbench.reference.topsicle_ref import Job

        # what the engine's run returns is a job's per-read results
        captured = []
        engine_run = pipeline.TorchEngine.run

        def run_and_keep(self):
            out = engine_run(self)
            captured.append(out)
            return out
        pipeline.TorchEngine.run = run_and_keep

        device = "cpu" if a.smoke else "cuda"

        def job(input_dir: Path, out_dir: Path) -> tuple:
            """One CLI job; (exit code, wall s, its results)."""
            captured.clear()
            with open(str(out_dir) + ".stdout", "w") as fh, contextlib.redirect_stdout(fh):
                t0 = time.perf_counter()
                try:
                    rc = port_cli.main(cli_argv(cli, str(input_dir), str(out_dir), device))
                except Exception as e:     # a job that raises is a failed job
                    print(f"portbench: job {out_dir.name} raised {e!r}", file=sys.stderr)
                    rc = -1
                wall = time.perf_counter() - t0
            return rc, wall, captured[-1] if captured else None

        t = time.perf_counter()
        rc, _, _ = job(warm, work / "warmup_out")
        if rc != 0:
            raise RuntimeError(f"the warm-up job exited {rc}")
        split["warmup_job_s"] = time.perf_counter() - t
        gc.collect()

        # ---- the measured window ------------------------------------------
        rss = RssPeak()
        sampler = SmiSampler(str(work / "smi.csv")) if not a.smoke else None
        if not a.smoke:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sampler.start()
        prof = None
        if a.trace and not a.smoke:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            span = record_function
        else:
            span = lambda name: contextlib.nullcontext()   # noqa: E731
        # a job's subset files (47 MB a telo_rich job) are deleted once the
        # next job has ended, seconds after they were written and before the
        # page cache writes them out, except in a sample of the jobs drawn
        # from the seed and in the last job; the others are compared by name
        sample = random.Random(a.seed)
        deleted_bytes, cleanup_s = 0, 0.0
        setup_s = since_process_start()
        rss.start()
        cpu0 = resource.getrusage(resource.RUSAGE_SELF)
        jobs = []
        t_open = time.perf_counter()
        with span(devtrace.WINDOW):
            while True:
                n = len(jobs)
                with span("portbench.job"):
                    rc, wall, results = job(inputs, work / f"job{n}")
                jobs.append({"rc": rc, "wall_s": wall, "results": results,
                             "out": work / f"job{n}",
                             "kept": sample.random() < SUBSET_SAMPLE, "deleted": None})
                if n and not jobs[n - 1]["kept"]:
                    t = time.perf_counter()
                    jobs[n - 1]["deleted"], size = drop_subsets(jobs[n - 1]["out"])
                    deleted_bytes += size
                    cleanup_s += time.perf_counter() - t
                if rc != 0 or time.perf_counter() - t_open >= a.seconds:
                    break
        if not a.smoke:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_open
        cpu1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu_s = (cpu1.ru_utime + cpu1.ru_stime) - (cpu0.ru_utime + cpu0.ru_stime)
        peak_rss = rss.stop()
        # ---- the window has closed ----------------------------------------
        trace = None
        if prof is not None:
            prof.__exit__(None, None, None)
            trace_path = str(work / "trace.json")
            prof.export_chrome_trace(trace_path)
            del prof
            trace = devtrace.load(trace_path, str(HERE / "kernels.json"))
        smi_window = sampler.stop() if sampler is not None else {}
        sampler = None
        mem_peak = torch.cuda.max_memory_allocated() if not a.smoke else 0
        pipeline.TorchEngine.run = engine_run
        gc.collect()
        if not a.smoke:
            torch.cuda.empty_cache()

        failed = sum(j["rc"] != 0 or j["results"] is None for j in jobs)
        for j in jobs:
            if j["rc"] == 0:
                j["stages"] = stages_of(str(j["out"] / "topsicle_run.log"))
        t = time.perf_counter()
        ref = Job(cli, str(inputs), device=device)
        want = ref.run()
        ref_s = time.perf_counter() - t
        t = time.perf_counter()
        per_job, first = [], None
        for j in jobs:
            if j["rc"] == 0 and j["results"] is not None:
                got = check.job_outputs(str(j["out"]), j["results"], j["deleted"])
                per_job.append(check.compare(want, got))
                if first is None and not check.verdict(per_job[-1]):
                    first = f"{j['out'].name}: {check.first_difference(want, got)}"
        counts = check.total(per_job)
        compare_s = time.perf_counter() - t
        correct = failed == 0 and bool(per_job) and check.verdict(counts)

        bases = ref.bases
        metrics = {}
        ok_jobs = [j for j in jobs if j["rc"] == 0]
        if not a.trace:
            values = {
                "mbp_per_s": bases * len(jobs) / window_s / 1e6,
                "peak_rss_mb": peak_rss / 1e6,
                "setup_s": setup_s,
            }
            units = {m["name"]: m["unit"] for m in e2e}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": units[m["name"]]}
                       for m in e2e}
        else:
            ctx = types.SimpleNamespace(jobs=ok_jobs, window_s=window_s, start=split,
                                        cpu_s=cpu_s,
                                        trace=trace, work=ref.work, roofline=roofline,
                                        smoke=a.smoke)
            for m in per_layer:
                v = load_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        walls = [j["wall_s"] for j in jobs]
        stage_names = sorted({n for j in ok_jobs for n in j["stages"]})
        print("[portbench] set-up split " + json.dumps({**split, "setup_s": setup_s}))
        print("[portbench] env " + json.dumps({
            "torch": torch.__version__, "cuda": getattr(torch.version, "cuda", None),
            "nvcc": nvcc_version() if not a.smoke else None,
            "card": smi("name,power.limit") if not a.smoke else None,
            "smi_in_window_min_median_max": smi_window,
            "cpus": os.cpu_count(), "affinity": sorted(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "python": platform.python_version(), "rss_peak_by": rss.how}))
        print("[portbench] jobs " + json.dumps({
            "n": len(jobs), "window_s": window_s, "input_bases": bases,
            "job_s": walls, "job_s_min_median_max": [min(walls), statistics.median(walls),
                                                      max(walls)],
            "reference_s": ref_s, "compare_s": compare_s, "process_cpu_s": cpu_s,
            "subsets_compared": [i for i, j in enumerate(jobs) if j["deleted"] is None],
            "subset_mb_deleted": deleted_bytes / 1e6, "cleanup_s": cleanup_s,
            "stage_s_a_job": {n: [j["stages"].get(n, 0.0) for j in ok_jobs]
                              for n in stage_names}}))
        if trace is not None:
            print("[portbench] trace " + json.dumps({
                "busy_s": trace.busy_s(), "step1_s": trace.step_s("step1"),
                "step2_s": trace.step_s("step2"),
                "bound_s_a_job": {s: roofline.bound_of_job(ref.work, s)
                                  for s in ("step1", "step2")}}))
        print("[portbench] work " + json.dumps(ref.work))

        found = forbidden_modules()
        if found:
            print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
            return 4
        result = {"correct": correct, "attempted": len(jobs), "failed": failed,
                  "metrics": metrics}
        if a.smoke:
            result["device"] = {"platform": "cpu", "kind": platform.processor() or "cpu",
                                "count": 0, "memory_peak_bytes": 0}
        else:
            result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": cell["chips"], "memory_peak_bytes": int(mem_peak)}
        if trace is not None:
            result["device"]["busy_s"] = trace.busy_s()
            result["device"]["window_s"] = window_s
            result["breakdown"] = {"device_ops": trace.device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
        result["checks"] = {name: {"value": counts[name], "limit": limit}
                            for name, (_, limit) in check.CHECKS.items()}
        if first is not None:
            print(f"portbench: first disagreement, {first}"[:1500], file=sys.stderr)
        for ln in check.lines(counts):
            print(ln, file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result))
        return 0
    finally:
        if sampler is not None:
            sampler.stop()


if __name__ == "__main__":
    sys.exit(main())
