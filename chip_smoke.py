#!/usr/bin/env python3
"""Smoke test of the torch port (topsicle_tpu_torch) on one CUDA card.

Run from the root of a checkout, with nothing installed or pre-built:

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero, and no result
line is printed):

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit
  2. build: the CUDA kernels from topsicle_tpu_torch/csrc/, timed
  3. kernel vs its plain torch version on the card, at the main path's
     shapes (B = 128 and 1024 reads x L = 19968, k = 5, window 100, slide 6,
     CCCTAAA) on the lean and dense wires, a K = 31 / k = 13 table and a
     small geometry (slide 1, window 20, k 7): y_int and the changepoint's
     (t, has) must be bit-identical
  4. end to end: a seeded 4,096-read gzipped FASTQ (~64 Mbp) through the
     port's CLI on the card; telolengths_all.csv and the subset FASTQ must
     match the pure-Python OracleEngine byte for byte, and the main path
     must have launched the kernel
  5. times, from the card: kernel vs plain (CUDA events, median of 50),
     the whole step-2 launch path, and the end-to-end wall time

The last three lines are the kernels' JSON record, the card's
`nvidia-smi --query-gpu=name,power.limit` line, and the result line
{"ok": true, "device": {...}}.
"""

import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import time


def _reads(rng, B, L, pattern="CCCTAAA", noise=0.05):
    """[B, L] uint8 telomere-like reads: a 500..5000 bp noisy repeat at the
    start, random ACGT after it."""
    import numpy as np

    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    pat = np.array(["ACGT".index(c) for c in pattern], np.uint8)
    telo = rng.integers(500, min(5000, max(502, L // 2)), B)
    keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) >= noise)
    return np.where(keep, np.resize(pat, L)[None, :], codes).astype(np.uint8)


def _cuda_ms(torch, fn, reps):
    """Per-run device times (ms) of fn() by CUDA events."""
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def _write_fastq(path, rng, n_reads=4096, pattern="CCCTAAA"):
    """Seeded reads of 9.5-22 kbp, in four kinds by index: forward
    telomeric (a 200-5000 bp repeat with ~7% noise at the start), reverse
    telomeric (the complementary repeat at the end), junk, and short or
    N-rich.  Telomeric reads of the second half also carry N's in their
    noise, so their step-2 batches travel on the dense wire.  Returns the
    total bases written."""
    import numpy as np

    alpha = np.frombuffer(b"ACGTN", np.uint8)
    fwd = np.frombuffer(pattern.encode(), np.uint8)
    rev = np.frombuffer(pattern[::-1].translate(str.maketrans("ACGT", "TGCA")).encode(),
                        np.uint8)
    total_bp = 0
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for i in range(n_reads):
            kind = i % 4
            n = int(rng.integers(9500, 22000))
            seq = alpha[rng.integers(0, 4, n)]
            if kind in (0, 1):
                tl = int(rng.integers(200, 5000))
                rep = np.resize(fwd if kind == 0 else rev, tl)
                noisy = rng.random(tl) < 0.07
                rep[noisy] = alpha[rng.integers(0, 5 if i >= n_reads // 2 else 4,
                                                int(noisy.sum()))]
                if kind == 0:
                    seq[:tl] = rep
                else:
                    seq[n - tl:] = rep
            elif kind == 3:
                if i % 8 == 3:
                    seq = seq[: int(rng.integers(100, 8000))]
                else:
                    seq[rng.random(n) < 0.02] = ord("N")
            total_bp += len(seq)
            fh.write(b"@read%d synthetic\n%s\n+\n%s\n"
                     % (i, seq.tobytes(), b"I" * len(seq)))
    return total_bp


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np

    from topsicle_tpu.config import TopsicleConfig
    from topsicle_tpu.io import batch as batching
    from topsicle_tpu.io import writer
    from topsicle_tpu.kmers import pack_kmer_table, telophrase_kmers
    from topsicle_tpu.oracle import OracleEngine
    from topsicle_tpu_torch import cli, ops
    from topsicle_tpu_torch.models import TorchScanModel
    from topsicle_tpu_torch.ops import cuda_kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # ---- 1. environment ---------------------------------------------------
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {name}, count {torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda_kernels.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] nvcc: {nvcc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_kernels.build_library()
    cuda_kernels.load_library()
    print(f"[build] {so.relative_to(repo)} in {time.perf_counter() - t0:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. kernel vs plain ------------------------------------------------
    rng = np.random.default_rng(2024)
    L = 19968                                   # static_scan_length(), 20 kbp reads
    demo = pack_kmer_table(telophrase_kmers("CCCTAAA", 5))
    max_err = 0

    def wire(codes, lens, lean):
        if lean:
            return (torch.from_numpy(batching.pack_codes(codes)).to(dev),
                    torch.from_numpy(lens.astype(np.int32)).to(dev))
        p, m = batching.pack_batch(codes)
        return torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)

    def case(label, codes, lens, table, k, w, slide, lean, cpu_check=False):
        nonlocal max_err
        tab = torch.from_numpy(table).to(dev)
        a, b = wire(codes, lens, lean)
        kw = dict(k=k, window_size=w, slide=slide, L=a.shape[1] * 4, lean=lean)
        y_k = cuda_kernels.sum_signal(a, b, tab, **kw)
        y_p = cuda_kernels.sum_signal_plain(a, b, tab, **kw)
        torch.cuda.synchronize()
        err = int((y_k - y_p).abs().max()) if y_k.numel() else 0
        max_err = max(max_err, err)
        assert torch.equal(y_k, y_p), f"{label}: kernel y_int differs from plain (max {err})"
        nw = torch.from_numpy(batching.window_counts_for_lengths(lens, w, slide)).to(dev)
        t_k, h_k = ops.binseg_l2_device(y_k, nw)
        t_p, h_p = ops.binseg_l2_device(y_p, nw)
        assert torch.equal(t_k, t_p) and torch.equal(h_k, h_p), f"{label}: (t, has) differ"
        if cpu_check:
            y_c = cuda_kernels.sum_signal_plain(a.cpu(), b.cpu(), tab.cpu(), **kw)
            assert torch.equal(y_k.cpu(), y_c), f"{label}: card differs from the CPU"
        print(f"[kernel] {label}: y_int {tuple(y_k.shape)} bit-identical, "
              f"(t, has) identical, {int(h_k.sum())} reads with a boundary")

    def ragged(codes):
        lens = rng.integers(L // 2, L + 1, codes.shape[0]).astype(np.int32)
        codes[np.arange(codes.shape[1])[None, :] >= lens[:, None]] = 0xFF
        return codes, lens

    for B in (128, 1024):
        codes, lens = ragged(_reads(rng, B, L))
        case(f"B={B} lean ragged", codes, lens, demo, 5, 100, 6, True, cpu_check=B == 128)
        codes, lens = ragged(_reads(rng, B, L))
        dirty = (rng.random(codes.shape) < 0.02) & (codes < 4)
        codes[dirty] = 4
        case(f"B={B} dense 2% invalid", codes, lens, demo, 5, 100, 6, False,
             cpu_check=B == 128)
    codes, lens = ragged(_reads(rng, 128, L))
    k13 = sorted({bytes(codes[0, p:p + 13]) for p in range(0, 4000, 97)})[:31]
    assert len(k13) == 31 and all(max(km) < 4 for km in k13)
    t31 = np.array([sum(int(c) << (2 * j) for j, c in enumerate(km)) for km in k13], np.int32)
    case("K=31 k=13 dense", codes, lens, t31, 13, 100, 6, False)
    codes, lens = ragged(_reads(rng, 128, L))
    case("slide=1 w=20 k=7 lean", codes, lens, pack_kmer_table(telophrase_kmers("CCCTAAA", 7)),
         7, 20, 1, True)

    # ---- 4. end to end ----------------------------------------------------
    work = os.path.join(repo, "_smoke_run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fq = os.path.join(work, "reads.fastq.gz")
    bp = _write_fastq(fq, np.random.default_rng(7))
    print(f"[e2e] wrote 4096 reads, {bp / 1e6:.1f} Mbp")
    t0 = time.perf_counter()
    OracleEngine(TopsicleConfig(input_dir=fq, output_dir=os.path.join(work, "oracle"),
                                pattern="CCCTAAA", slide=6)).run()
    print(f"[e2e] OracleEngine: {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "port")
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--inputDir", fq, "--outputDir", out, "--pattern", "CCCTAAA",
                   "--slide", "6", "--batchSize", "128", "--device", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    assert rc == 0, f"port CLI exited {rc}"
    assert all(n > 0 for n in launches.values()), f"kernels not launched: {launches}"
    log_text = open(os.path.join(out, "topsicle_run.log")).read()
    assert f"device: cuda:0 ({name})" in log_text, "the port did not run on the card"
    got = open(os.path.join(out, "telolengths_all.csv"), "rb").read()
    want = open(os.path.join(work, "oracle", "telolengths_all.csv"), "rb").read()
    assert got == want, "telolengths_all.csv differs from the oracle's"
    sub = os.path.basename(writer.subset_path(out, fq, 0.7))
    assert open(os.path.join(out, sub), "rb").read() == \
        open(os.path.join(work, "oracle", sub), "rb").read(), "subset FASTQ differs"
    rows = got.count(b"\n") - 1
    assert rows > 100, f"only {rows} rows"
    print(f"[e2e] port CLI on {name}: {rows} rows, CSV and subset byte-identical to the "
          f"oracle; kernel launches {launches}; wall {e2e_s:.2f} s = "
          f"{4096 / e2e_s:.0f} reads/s, {bp / 1e6 / e2e_s:.2f} Mbp/s")

    # ---- 5. times ---------------------------------------------------------
    B = 128
    codes, lens = ragged(_reads(rng, B, L))
    a, b = wire(codes, lens, True)
    tab = torch.from_numpy(demo).to(dev)
    kw = dict(k=5, window_size=100, slide=6, L=L, lean=True)
    kern = lambda: cuda_kernels.sum_signal(a, b, tab, **kw)      # noqa: E731
    plain = lambda: cuda_kernels.sum_signal_plain(a, b, tab, **kw)  # noqa: E731
    for fn in (plain, kern):
        _cuda_ms(torch, fn, 3)
    tp = _cuda_ms(torch, plain, 25)
    tk = _cuda_ms(torch, kern, 25) + _cuda_ms(torch, kern, 25)
    tp += _cuda_ms(torch, plain, 25)
    ms, plain_ms = statistics.median(tk), statistics.median(tp)
    print(f"[time] sum_signal B=128 L=19968 lean: kernel {ms:.4f} ms, plain torch "
          f"{plain_ms:.4f} ms (CUDA events, median of 50 each; {smi})")
    model = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device=dev,
                           window_size=100, slide=6)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    for _ in range(3):
        model.step2_boundary(codes, nw, lens)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.step2_boundary(codes, nw, lens)
        host.append((time.perf_counter() - t0) * 1e3)
    dev_ms = _cuda_ms(torch, lambda: model.step2_boundary(codes, nw, lens), 20)
    print(f"[time] step-2 launch path B=128 (pack, H2D, kernel, changepoint, D2H): "
          f"{statistics.median(host):.3f} ms host clock, {statistics.median(dev_ms):.3f} ms "
          f"CUDA events, median of 20 ({smi})")
    pack = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.pack_scan_batch(codes, lens)
        pack.append((time.perf_counter() - t0) * 1e3)
    y, nw_dev = kern(), torch.from_numpy(nw).to(dev)
    cp_ms = _cuda_ms(torch, lambda: ops.binseg_l2_device(y, nw_dev), 20)
    print(f"[time] of which: host pack (clean check + 2-bit pack) "
          f"{statistics.median(pack):.3f} ms host clock; changepoint "
          f"{statistics.median(cp_ms):.3f} ms CUDA events; kernel {ms:.4f} ms ({smi})")
    print(f"[time] end to end: {e2e_s:.2f} s wall for 4096 reads = {4096 / e2e_s:.1f} "
          f"reads/s, {bp / 1e6 / e2e_s:.3f} Mbp/s ({smi})")
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "sum_signal", "route": "cuda",
        "source": "topsicle_tpu_torch/csrc/sum_signal.cu",
        "replaces": "topsicle_tpu/ops/pallas_kernels.py:224",
        "launches": launches["sum_signal"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
