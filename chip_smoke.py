#!/usr/bin/env python3
"""Smoke test of the torch port (topsicle_tpu_torch) on one CUDA card.

Run from the root of a checkout, with nothing installed or pre-built:

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero, and no result
line is printed):

  1. environment: torch/CUDA versions, nvcc, the card's name and power
     limit, and which optional host modules (matplotlib, pandas) exist
  2. build: every CUDA kernel from topsicle_tpu_torch/csrc/, one nvcc per
     source started together, timed; and the port's C++ reader (g++)
  3. each kernel vs its plain torch version on the card, at the main
     paths' shapes (B = 128 and 1024 reads x L = 19968, window 100,
     slide 6), bit-identical (integers: the tolerance is 0), with a
     synchronize after each launch:
       sum_signal and sum_boundary (the same body with the changepoint
                      fused behind it): CCCTAAA k = 5 on the lean and
                      dense (2% invalid) wires, a K = 31 / k = 13 table,
                      slide 1 / window 20 / k 7, a read too short for
                      a candidate (W < jump); y_int and (t, has), with
                      ragged window counts that include 0, 3 and W;
                      sum_boundary also forced onto clusters of 2, 4 and
                      8 blocks a read
       binseg_l2:     on every y above and below, and alone on a constant
                      y (every candidate ties: the smallest t), a
                      [4, 131080] y (the plain version's two-limb range)
                      and y up to 2**30 (A**2 past 64 bits), each at the
                      plan's tiles and forced to tiles of 32, 100 and
                      2,048 windows (a row in tiles of windows, a block a
                      tile; several tiles a row are two passes)
       greedy_signal, greedy_counts and greedy_boundary (one body: match
                      planes, find-first-set, the changepoint behind it):
                      CCCTAAA k = 7 (8 of 14 entries self-overlapping) on
                      the lean and dense (2% invalid) wires, CCCTAA k = 5,
                      CCCTAAA k = 3, a K = 40 table with duplicates and a
                      K = 120 one (the table in two groups of planes),
                      slide 1 / window 20 / k 7, AAAAAAA on reads that
                      are one run of A's, window 72 / slide 31 (a window's
                      bits straddle three plane words), window 200
                      (J > 96); y_int, [B, K, W] counts and (t, has);
                      greedy_boundary also forced onto clusters of 2, 4
                      and 8 blocks a read
       the window-block grid of sum_signal, greedy_signal and
                      greedy_counts (blocks of a read's windows, each staging
                      only the bases its windows read), binseg_l2 behind it:
                      reads of L = 1,048,576, past every one-block layout, so
                      the wrappers take the grid themselves (2,048 windows a
                      block), on the lean and dense wires, at slide 6 and at
                      slide 1 / window 20, with ragged window counts (0, 3 and
                      W among them); and the grid forced at L = 19,968 with
                      1,000 windows a block (does not divide W) and 333 at
                      slide 7 (blocks start at bases that are no multiple of 4
                      or 8); each also against one block a read
       the fused entries on a cluster: y [8, 59805] (L = 59,904 at slide 1,
                      past one block), k = 5 lean and k = 7 dense, on the
                      picker's cluster of 2 blocks a read and forced onto
                      2, 4 and 8, n - 1 on a block's last window
       step1_counts:  [256, 1000] ends (rows of 1000, 0, 3 and k bases and
                      a run of A's among them) on both wires at CCCTAAA
                      k = 7 and k = 5, AAAAAAA, K = 33 (a second round of
                      entries) and K = 40
     and the sharded caller: ShardedScanModel over [cuda:0, cuda:0] (two
     shards on the one card, the only split it allows) against one
     TorchScanModel, bit for bit, at k = 5 and 7: step 1 (step1_counts
     through two shards), step 2 on the lean and dense wires at B = 128 x
     L = 19968, the packed API and rawcounts, each shard launching its
     kernel (the counts double); and a handle that syncs on its own
     card's stream
     and global mode's launches at one process (GlobalScanModel at k = 5
     and 7, B = 128 x L = 19968 and step 1): each made behind ~36 ms of
     matrix products on the stream must return while its result's event
     is pending, and drain to the model's own result bit for bit
  4. end to end: a seeded 4,096-read gzipped FASTQ (~58 Mbp) through the
     port's CLI on the card, five paths, each with the launch counts set
     to 0 just before it and read just after:
       k = 5 (auto: step1_counts and the fused sum kernel, sum_boundary),
       --telophrase 7 (a mixed table: step1_counts and the fused greedy
       kernel, greedy_boundary), --kernel greedy at k = 5 (greedy_signal,
       then binseg_l2), --kernel sum at k = 5 (sum_signal, then
       binseg_l2), and --telophrase 7 --rawcountpattern on the 256-read
       file of the multi-process inputs (greedy_counts too); each run's
       CSVs (and subset FASTQ) must match the port's pure-Python
       OracleEngine at that k byte for byte, each path must have launched
       exactly the kernels it runs, and the plain torch changepoint and
       the plain step 1 must have run 0 times on the card
     then long scans, held the same way: --maxlengthtelo 60000 --slide 1
       on 32 reads of 60-70 kbp at k = 5 and --telophrase 7 (y [W] alone
       passes a block's shared memory: sum_boundary or greedy_boundary on
       a cluster of 2 blocks a read, one launch a batch), and
       --maxlengthtelo 1000000 --telophrase 5 7 --rawcountpattern on 8
       reads of 0.5-1 Mbp (the window-block grid of all three entries,
       then binseg_l2); each run's log must name the route it took
     then processes, each a CLI started with --device cuda that prints
     its launch counts (which must not be 0): on four seeded files of
     1,024 / 512 / 256 / 256 reads, one process (outputs byte-identical
     to the oracle's), and two processes in files mode without and with
     --coordinator and in --shardMode global (each byte-identical to the
     one-process run, no .parts left); and a --pattern CCCTAAACC
     --telophrase 9 16 sweep (k = 16 on the host) equal to the oracle's
     then the compile cache: --precompile with TOPSICLE_COMPILE_CACHE set
     to a fresh directory builds the kernels' library and the C++ reader
     there (nothing new in topsicle_tpu_torch/_build/), a fresh CLI
     process on the e2e file with that cache builds nothing and writes
     the oracle's bytes, and a fresh process's start is split (import
     torch, CUDA context, the port's import, the kernel library and the
     C++ reader with the cache warm and cold, a first batch)
  5. times, from the card: each kernel vs its plain version (CUDA events,
     medians: the time of one launch paced by the host, as every run of
     this script has read it, and beside it the time with the launches
     queued behind a matrix product so that they run back to back), each
     kernel's bound (bytes over the card's memory rate or the integer
     operations its function needs over the card's INT32 rate, whichever
     is larger, from this run's inputs; a kernel faster than its bound
     fails the run: the count would be wrong), the window-block grid at
     B = 4 x L = 1,048,576 and, forced, at the default shape beside one
     block a read, binseg_l2 held to its plain version at y [128, 3312]
     and [4, 174747] and timed there at tiles of 1,024, 2,048 and 4,096
     windows in turns (the sweep that sets ops/geometry.py's tiles), the
     fused changepoint's share (each fused entry less its signal entry),
     the fused entries at the default shape on clusters of 1, 2 and 4
     blocks a read in turns, on the cluster route at y [8, 59805] beside
     the two launches it replaces (signal, then binseg_l2), and forced onto
     a cluster at B = 4 x 1,048,576 beside the grid the picker takes there,
     the
     step-2 launch paths (one
     model and two shards), and the end-to-end wall times, the
     multi-process ones included (on one card: process overhead)

`python3 chip_smoke.py --times-of DIR` runs none of this: it times the
sum_signal, greedy_signal, sum_boundary and greedy_boundary entries (the
last two also forced onto clusters of 1, 2 and 4 blocks a read where DIR's
wrappers take cluster_windows), step 2 of a batch of 8 reads at
--maxlengthtelo 60000 --slide 1 on the route DIR's picker takes, the
step-1 count and binseg_l2 (at y [128, 3312] and [4, 174747]) of the
checkout at DIR, through DIR's own wrappers, by phase 5's two methods and
prints a line each, so that two commits' kernels can be read in one call.
`python3 chip_smoke.py --global-of DIR` runs only phase 4's two-process
--shardMode global run, through DIR's CLI, five times (DIR's kernel
library built first), and prints the walls, so that two commits' global
runs can be read in turns in one call.

The last three lines are the kernels' JSON record, the card's
`nvidia-smi --query-gpu=name,power.limit` line, and the result line
{"ok": true, "device": {...}}.
"""

import functools
import gzip
import importlib.util
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


FILE_READS = (1024, 512, 256, 256)     # phase 4's skewed four-file directory
RAW_FILE, RAW_READS = "part2.fastq.gz", FILE_READS[2]   # the --rawcountpattern path's input
K16_PATTERN, K16_PHRASES, K16_READS = "CCCTAAACC", [9, 16], 256
K16_CUTOFF = 0.15      # 16-mers of a noisy 9-bp repeat keep TRC near 0.25
MP_TIMEOUT = 300       # seconds a multi-process run may take
# long scans: reads, read lengths and telomere lengths of the two inputs
LONG_READS, LONG_LENGTH, LONG_TELO = 32, (60000, 70000), (2000, 40000)
MEGA_READS, MEGA_LENGTH, MEGA_TELO = 8, (500000, 1000000), (5000, 300000)
LONG_ARGS = ["--maxlengthtelo", "60000"]             # at --slide 1: 59,805 windows a read
MEGA_ARGS = ["--maxlengthtelo", "1000000", "--telophrase", "5", "7", "--rawcountpattern"]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# 132 SMs x 64 INT32 lanes x 1.98 GHz: a quarter of the data sheet's 67
# TFLOP/s of float32 (128 lanes, a fused multiply-add counted as two)
INT32_OPS_PER_S = 67e12 / 4
DELAY_N = 4096      # a float32 product of this order keeps the card busy ~3 ms
BINSEG_SWEEP = (1024, 2048, 4096)      # binseg_l2's tiles timed: V = 4, 8, 16
CLUSTER_SWEEP = (1, 2, 4)      # blocks a read of the fused entries timed at the default shape
NOWAIT_PRODUCTS = 12   # products of DELAY_N queued before a global launch: ~36 ms of the card
GLOBAL_RUNS = 5        # two-process --shardMode global runs of a checkout, --global-of


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


def _queued_ms(torch, fn, reps=20, rounds=7):
    """Device time (ms) of one fn() launch: `reps` launches queued behind
    a matrix product that keeps the card busy while the host enqueues
    them, so they run back to back and the host's enqueue time (which
    exceeds a short kernel's) stays out of it.  CUDA events, median of
    `rounds`."""
    for _ in range(3):
        fn()
    m = torch.ones(DELAY_N, DELAY_N, device="cuda")
    busy = torch.empty_like(m)
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.mm(m, m, out=busy)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def _bound(n_bytes, n_ops):
    """(bound_ms, bound_by, bytes, operations): the least time the card
    could take, the larger of the bytes over its memory rate and the
    integer operations the function needs over its INT32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            int(n_bytes), int(n_ops))


def _write_fastq(path, rng, n_reads=4096, pattern="CCCTAAA", length=(9500, 22000),
                 telo=(200, 5000)):
    """Seeded reads of 9.5-22 kbp (or `length`), in four kinds by index:
    forward telomeric (a 200-5000 bp repeat, or `telo`, with ~7% noise at
    the start), reverse telomeric (the complementary repeat at the end),
    junk, and short or N-rich.  Telomeric reads of the second half also
    carry N's in their noise, so their step-2 batches travel on the dense
    wire.  Returns the total bases written."""
    import numpy as np

    alpha = np.frombuffer(b"ACGTN", np.uint8)
    fwd = np.frombuffer(pattern.encode(), np.uint8)
    rev = np.frombuffer(pattern[::-1].translate(str.maketrans("ACGT", "TGCA")).encode(),
                        np.uint8)
    total_bp = 0
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for i in range(n_reads):
            kind = i % 4
            n = int(rng.integers(*length))
            seq = alpha[rng.integers(0, 4, n)]
            if kind in (0, 1):
                tl = int(rng.integers(*telo))
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


def _start_oracle(repo, out, **cfg):
    """OracleEngine in a child process (pure Python, CPU only) with the
    TopsicleConfig fields `cfg`, so the reference CSVs are written while
    the card checks the kernels."""
    cfg.setdefault("pattern", "CCCTAAA")
    code = ("from topsicle_tpu_torch.config import TopsicleConfig\n"
            "from topsicle_tpu_torch.oracle import OracleEngine\n"
            f"OracleEngine(TopsicleConfig(output_dir={out!r}, **{cfg!r})).run()\n")
    with open(out + ".log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                                stdout=log, stderr=subprocess.STDOUT)


def _times_of(torch, root):
    """`python3 chip_smoke.py --times-of DIR`: only the times of the
    sum_signal, greedy_signal, sum_boundary and greedy_boundary entries,
    the step-1 count and binseg_l2 of the checkout at DIR (this one, or
    another commit's unpacked beside it), so that two bodies of a kernel
    are read by the same two methods in one call.  Phase 5's batches: B =
    128 x L = 19968, CCCTAAA k = 5 (sum) and k = 7 (greedy), lean wire,
    [256, 1000] ends at k = 7 and k = 5, and binseg_l2 on DIR's sum_signal
    y of that batch and of 4 reads of 1,048,576 bases (y [4, 174747]),
    built here with numpy alone so that nothing but the kernels' wrappers
    comes from DIR (binseg_l2 at each one's own tiles).  The step-1 count
    is DIR's step1_counts, or where DIR has none its greedy_counts with
    one window over every offset.  Each kernel is held against DIR's plain
    version first.  Prints a line a kernel; no result line."""
    import numpy as np

    sys.path.insert(0, os.path.abspath(root))
    from topsicle_tpu_torch.ops import cuda_kernels

    def pack(codes, lens):
        bits = np.where(np.arange(codes.shape[1])[None, :] < lens[:, None], codes, 0) & 3
        return (bits[:, 0::4] | bits[:, 1::4] << 2 | bits[:, 2::4] << 4
                | bits[:, 3::4] << 6).astype(np.uint8)

    def table(k):
        doubled = "CCCTAAA" * 2
        origin = sorted({doubled[i:i + k] for i in range(len(doubled) - k + 1)})
        kmers = origin + [s.translate(str.maketrans("ACGT", "TGCA")) for s in origin]
        return torch.tensor([sum("ACGT".index(c) << (2 * j) for j, c in enumerate(s))
                             for s in kmers], dtype=torch.int32, device="cuda")

    B, L = 128, 19968
    rng = np.random.default_rng(2024)
    codes = _reads(rng, B, L)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    a, b = torch.from_numpy(pack(codes, lens)).cuda(), torch.from_numpy(lens).cuda()
    ends = _reads(rng, 256, 1000)
    ends_len = np.full(256, 1000, np.int32)
    ea, eb = torch.from_numpy(pack(ends, ends_len)).cuda(), torch.from_numpy(ends_len).cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]

    def report(name, label, kern, plain):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(map(torch.equal, got, want)), \
            f"{name} of {root} differs from its plain version"
        queued, paced, _ = _median_ms(torch, kern, lambda: None)
        print(f"[time] {name} of {root} {label}: {paced:.4f} ms a launch paced by the host, "
              f"{queued:.4f} ms queued back to back, bit-identical to its plain version "
              f"(CUDA events, medians; {smi})")

    for name, k in (("sum_signal", 5), ("greedy_signal", 7)):
        tab = table(k)
        kw = dict(k=k, window_size=100, slide=6, L=L, lean=True)
        report(name, f"B=128 L=19968 k={k} lean",
               lambda: getattr(cuda_kernels, name)(a, b, tab, **kw),
               lambda: getattr(cuda_kernels, name + "_plain")(a, b, tab, **kw))
    nw = torch.from_numpy(np.maximum((lens - 100) // 6 + 1, 0).astype(np.int32)).cuda()
    for name, k in (("sum_boundary", 5), ("greedy_boundary", 7)):
        tab = table(k)
        kw = dict(k=k, window_size=100, slide=6, L=L, lean=True)
        report(name, f"B=128 L=19968 k={k} lean",
               lambda: getattr(cuda_kernels, name)(a, b, tab, nw, **kw),
               lambda: getattr(cuda_kernels, name + "_plain")(a, b, tab, nw, **kw))
    # the fused changepoint's share, each fused entry less its signal entry
    # in turns: at the default table, at its first entry alone (the signal
    # phase small), and with every read's n = 0 (no candidate: the scans and
    # the reductions alone)
    for body, k in (("sum", 5), ("greedy", 7)):
        kw = dict(k=k, window_size=100, slide=6, L=L, lean=True)
        fused_fn = getattr(cuda_kernels, body + "_boundary")
        signal_fn = getattr(cuda_kernels, body + "_signal")
        for label, tab, n in (("K=14", table(k), nw), ("K=1", table(k)[:1], nw),
                              ("K=14, every n = 0", table(k), torch.zeros_like(nw))):
            q = {"fused": [], "signal": []}
            for which in ("signal", "fused", "fused", "signal"):
                q[which].append(_queued_ms(torch, (lambda: fused_fn(a, b, tab, n, **kw))
                                           if which == "fused" else
                                           (lambda: signal_fn(a, b, tab, **kw)), rounds=5))
            f, g = statistics.median(q["fused"]), statistics.median(q["signal"])
            print(f"[time] changepoint share of {body}_boundary of {root} B=128 L=19968 k={k} "
                  f"{label}: {body}_boundary {f:.4f} - {body}_signal {g:.4f} = {f - g:.4f} ms, "
                  f"queued back to back, in turns (CUDA events, medians; {smi})")
    # the fused entries forced onto clusters of C blocks a read (C = 1: one
    # block), where DIR's wrappers take the argument
    W = (L - 100) // 6 + 1
    for name, k in (("sum_boundary", 5), ("greedy_boundary", 7)):
        fn = getattr(cuda_kernels, name)
        if "cluster_windows" not in fn.__code__.co_varnames:
            continue
        tab = table(k)
        kw = dict(k=k, window_size=100, slide=6, L=L, lean=True)
        for C in CLUSTER_SWEEP:
            cw = -(-W // C) if C > 1 else W
            report(name, f"B=128 L=19968 k={k} lean, cluster of {C} (forced)",
                   lambda: fn(a, b, tab, nw, cluster_windows=cw, **kw),
                   lambda: getattr(cuda_kernels, name + "_plain")(a, b, tab, nw, **kw))
    # --maxlengthtelo 60000 --slide 1: the step-2 launches of the route DIR's
    # picker takes (a fused entry, or a signal entry then binseg_l2)
    from topsicle_tpu_torch.ops import geometry

    L60, B60 = 59904, 8
    codes60 = _reads(rng, B60, L60)
    lens60 = rng.integers(L60 // 2, L60 + 1, B60).astype(np.int32)
    a60 = torch.from_numpy(pack(codes60, lens60)).cuda()
    b60 = torch.from_numpy(lens60).cuda()
    nw60 = torch.from_numpy(np.maximum(lens60 - 100 + 1, 0).astype(np.int32)).cuda()
    W60 = L60 - 100 + 1
    for body, k in (("sum", 5), ("greedy", 7)):
        tab = table(k)
        kw = dict(k=k, window_size=100, slide=1, L=L60, lean=True)
        route = geometry.find_route(body, L=L60, W=W60, K=int(tab.shape[0]), k=k,
                                    window_size=100, slide=1, dense=False)
        if route.fused:
            def kern(fn=getattr(cuda_kernels, body + "_boundary"), tab=tab, kw=kw):
                return fn(a60, b60, tab, nw60, **kw)
            label = f"{body}_boundary ({route.kind}, {route.blocks(W60)} blocks a read)"
        else:
            def kern(fn=getattr(cuda_kernels, body + "_signal"), tab=tab, kw=kw, route=route):
                y = fn(a60, b60, tab, block_windows=route.block_windows, **kw)
                return cuda_kernels.binseg_l2(y, nw60)
            label = f"{body}_signal ({route.kind}) then binseg_l2"
        report(f"step 2 at --maxlengthtelo 60000 --slide 1 k={k}", f"B={B60}: {label}", kern,
               lambda tab=tab, kw=kw: getattr(cuda_kernels, body + "_boundary_plain")(
                   a60, b60, tab, nw60, **kw))
    del codes60, a60
    mega = 1 << 20
    codes4 = _reads(rng, 4, mega)
    lens4 = np.full(4, mega, np.int32)
    a4, b4 = torch.from_numpy(pack(codes4, lens4)).cuda(), torch.from_numpy(lens4).cuda()
    for label, y, n in (
            ("y [128, 3312]", cuda_kernels.sum_signal(a, b, table(5), k=5, window_size=100,
                                                      slide=6, L=L, lean=True), nw),
            ("y [4, 174747]", cuda_kernels.sum_signal(a4, b4, table(5), k=5, window_size=100,
                                                      slide=6, L=mega, lean=True),
             torch.from_numpy((lens4 - 100) // 6 + 1).cuda())):
        report("binseg_l2", label, lambda: cuda_kernels.binseg_l2(y, n),
               lambda: cuda_kernels.binseg_l2_device(y, n))
    for k in (7, 5):
        tab = table(k)
        if hasattr(cuda_kernels, "step1_counts"):
            kw = dict(k=k, L=1000, lean=True)
            report("step1_counts", f"[256, 1000] k={k} lean",
                   lambda: cuda_kernels.step1_counts(ea, eb, tab, **kw),
                   lambda: cuda_kernels.step1_counts_plain(ea, eb, tab, **kw))
        else:
            kw = dict(k=k, J=1000 - k + 1, W=1, slide=1, L=1000, lean=True)
            report("greedy_counts (W = 1: the step-1 count)", f"[256, 1000] k={k} lean",
                   lambda: cuda_kernels.greedy_counts(ea, eb, tab, **kw),
                   lambda: cuda_kernels.greedy_counts_plain(ea, eb, tab, **kw))
    return 0


def _median_ms(torch, kern, plain, reps=25):
    """(kernel queued back to back, kernel paced by the host, plain)
    medians of CUDA-event times, in turns: plain, kernel, kernel, plain,
    after 3 warm-up runs of each."""
    for fn in (plain, kern):
        _cuda_ms(torch, fn, 3)
    tp = _cuda_ms(torch, plain, reps)
    tq = [_queued_ms(torch, kern, rounds=3)]
    tk = _cuda_ms(torch, kern, reps) + _cuda_ms(torch, kern, reps)
    tq.append(_queued_ms(torch, kern, rounds=3))
    tp += _cuda_ms(torch, plain, reps)
    return statistics.median(tq), statistics.median(tk), statistics.median(tp)


def _sharded_phase(torch, dev, batches, ends):
    """Phase 3's sharded caller: ShardedScanModel over [dev, dev] (two
    shards on one card, the only split one card allows) against one
    TorchScanModel, bit for bit, at k=5 (sum kernel) and k=7 (greedy
    kernel): step 1 (step1_counts), step 2 on every (label, codes, lens) of `batches`,
    the packed API and rawcounts.  Every shard launches its kernel: the
    counts double.  Returns the lines to print."""
    import numpy as np

    from topsicle_tpu_torch.io import batch as batching
    from topsicle_tpu_torch.kmers import telophrase_kmers
    from topsicle_tpu_torch.models import TorchScanModel
    from topsicle_tpu_torch.ops import cuda_kernels
    from topsicle_tpu_torch.parallel import ShardedScanModel

    lines = []
    counts = cuda_kernels.LAUNCHES

    def twice(label, kernel, single_fn, sharded_fn):
        """Run both; each shard launches `kernel` once, the single model
        once in all; the results must be identical."""
        n0 = counts.get(kernel, 0)
        want = single_fn()
        n1 = counts.get(kernel, 0)
        got = sharded_fn()
        n2 = counts.get(kernel, 0)
        if kernel is not None and dev.type == "cuda":
            assert (n1 - n0, n2 - n1) == (1, 2), f"{label}: {kernel} launches " \
                f"{n1 - n0} single, {n2 - n1} sharded (expected 1 and 2)"
        for x, y in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f"{label}: differs"
        return want

    ends_len = np.full(ends.shape[0], ends.shape[2], np.int32)
    for phrase in (5, 7):
        single = TorchScanModel(telophrase_kmers("CCCTAAA", phrase), device=dev,
                                window_size=100, slide=6)
        sharded = ShardedScanModel(single, [dev, dev])
        assert single.fused
        kern = f"{single.kernel}_boundary"
        twice(f"k={phrase} step 1", "step1_counts",
              lambda: single.step1_counts(ends, ends_len),
              lambda: sharded.step1_counts(ends, ends_len))
        for label, codes, lens in batches:
            nw = batching.window_counts_for_lengths(lens, 100, 6)
            packed = sharded.pack_scan_batch(codes, lens)
            assert packed[0] == label, f"{label} batch packed {packed[0]}"
            want = twice(f"k={phrase} {label} step 2", kern,
                         lambda: single.step2_boundary(codes, nw, lens),
                         lambda: sharded.step2_boundary(codes, nw, lens))
            twice(f"k={phrase} {label} packed", kern,
                  lambda: tuple(np.asarray(x)
                                for x in single.step2_boundary_launch_packed(packed, nw)),
                  lambda: tuple(np.asarray(x)
                                for x in sharded.step2_boundary_launch_packed(packed, nw)))
            raw = np.asarray(sharded.rawcounts_launch_packed(packed))
            assert np.array_equal(raw, single.rawcounts(codes, lens)), f"{label}: rawcounts"
            lines.append(f"[shard] k={phrase} {label} B={codes.shape[0]} L={codes.shape[1]}: "
                         f"two shards on {dev} (one card: the only split it allows) == one "
                         f"model bit for bit in (t, has), packed API and rawcounts; {kern} "
                         f"launched once per shard; {int(want[1].sum())} boundaries")
        lines.append(f"[shard] k={phrase} step 1 (step1_counts, launched once per shard) "
                     f"[{ends.shape[0]}, 2, {ends.shape[2]}]: two shards == one model bit "
                     f"for bit")
    # a handle syncs on its own card's stream whichever card is current
    # (with one card, current and own are the same card)
    label, codes, lens = batches[0]
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    with torch.cuda.device(torch.cuda.device_count() - 1):
        t, has = single.step2_boundary_launch(codes, nw, lens)
    assert np.array_equal(np.asarray(t), single.step2_boundary(codes, nw, lens)[0])
    lines.append(f"[shard] a {dev} handle launched under cuda:"
                 f"{torch.cuda.device_count() - 1} current syncs on its own stream")
    return lines


def _nowait_phase(torch, codes, lens, ends, ends_len):
    """Phase 3's global launches at one process: GlobalScanModel over a
    TorchScanModel on the card at k = 5 (sum_boundary) and k = 7
    (greedy_boundary), B = 128 x L = 19968 and [128, 2, 1000] ends.
    Each launch is made behind NOWAIT_PRODUCTS matrix products on the
    stream and must return while its result's event is still pending (a
    launch that waits for the card fails); drained, the result must equal
    the model's own bit for bit.  Returns the lines to print."""
    import numpy as np

    from topsicle_tpu_torch.io import batch as batching
    from topsicle_tpu_torch.kmers import telophrase_kmers
    from topsicle_tpu_torch.models import TorchScanModel
    from topsicle_tpu_torch.parallel.multihost import GlobalScanModel

    m = torch.ones(DELAY_N, DELAY_N, device="cuda")
    busy = torch.mm(m, m)           # the first product also sets the library up
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    lines = []
    for k in (5, 7):
        model = TorchScanModel(telophrase_kmers("CCCTAAA", k), device="cuda", window_size=100,
                               slide=6)
        g = GlobalScanModel(model)
        assert g.n_proc == 1
        launches = (("step2_boundary_global_launch", model.step2_boundary(codes, nw, lens),
                     lambda: g.step2_boundary_global_launch(codes, nw, lens)),
                    ("step1_counts_global_launch", (model.step1_counts(ends, ends_len),),
                     lambda: (g.step1_counts_global_launch(ends, ends_len),)))
        for what, want, launch in launches:
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(NOWAIT_PRODUCTS):
                torch.mm(m, m, out=busy)
            e.record()
            t0 = time.perf_counter()
            handles = launch()
            host_ms = (time.perf_counter() - t0) * 1e3
            pending = [not h.local.ready() for h in handles]
            got = [np.asarray(h) for h in handles]
            busy_ms = s.elapsed_time(e)
            assert all(pending), (f"k={k} {what} returned after its result was on the host "
                                  f"({host_ms:.2f} ms host, behind {busy_ms:.1f} ms of "
                                  f"products): the launch waited for the card")
            assert all(np.array_equal(x, w) for x, w in zip(got, want)), \
                f"k={k} {what}: drained result differs from the model's own"
            lines.append(f"[global] k={k} {what} at one process, behind {NOWAIT_PRODUCTS} "
                         f"products ({busy_ms:.1f} ms of the card): returned in {host_ms:.3f} "
                         f"ms host time with its result's event pending; drained, "
                         f"bit-identical to the model's own")
    return lines


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a child of phase 4: the port's CLI, then its kernel launch counts and its
# calls of the plain torch changepoint and of the plain step 1 by device type
_CHILD = ("import json, sys\n"
          "sys.path.insert(0, {repo!r})\n"
          "from topsicle_tpu_torch import cli\n"
          "from topsicle_tpu_torch.ops import changepoint, cuda_kernels\n"
          "rc = cli.main({argv!r})\n"
          "print('LAUNCHES ' + json.dumps(cuda_kernels.LAUNCHES))\n"
          "print('PLAIN_CALLS ' + json.dumps(changepoint.PLAIN_CALLS))\n"
          "print('STEP1_PLAIN_CALLS ' + json.dumps(cuda_kernels.STEP1_PLAIN_CALLS))\n"
          "sys.exit(rc)\n")


def _run_processes(repo, argvs, device_line, card=True, env=None, elapsed=None):
    """Start one CLI process per argv, all at once (with `env` added to
    the environment); each must exit 0 within MP_TIMEOUT s, name its
    device in its log and, on a `card`, launch kernels.  Kills any
    process left.  Returns (wall seconds, [launch counts]); appends each
    process's own `Elapsed time(s)` (from its CLI's start, after its
    imports) to the list `elapsed`, when given."""
    import json

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD.format(repo=repo, argv=a)],
                              cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=None if env is None else {**os.environ, **env})
             for a in argvs]
    try:
        outs = [p.communicate(timeout=MP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    launches = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{err[-3000:]}"
        assert device_line in out, f"process {i}: no '{device_line}' in its log"
        got = [json.loads(x[len("LAUNCHES "):]) for x in out.splitlines()
               if x.startswith("LAUNCHES ")]
        assert got and (sum(got[0].values()) > 0 or not card), \
            f"process {i} launched no kernel: {got}"
        for what in ("PLAIN_CALLS ", "STEP1_PLAIN_CALLS "):
            plain = [json.loads(x[len(what):]) for x in out.splitlines()
                     if x.startswith(what)]
            assert plain and plain[0]["cuda"] == 0, \
                f"process {i} ran a plain torch version on the card: {what}{plain}"
        launches.append(got[0])
        if elapsed is not None:
            elapsed += [float(x.split()[2]) for x in out.splitlines()
                        if x.startswith("Elapsed time(s): ")]
    return wall, launches


# a fresh process's start on the card, each step timed by the process
# itself: import torch, the CUDA context, the port's import, the kernels'
# library (loaded, or built where the compile cache is cold), the C++
# reader (the same), and a first batch of both steps at k = 5
_START = ("import time\n"
          "t = [time.perf_counter()]\n"
          "import json, sys\n"
          "import torch\n"
          "t.append(time.perf_counter())\n"
          "torch.zeros(1, device='cuda')\n"
          "torch.cuda.synchronize()\n"
          "t.append(time.perf_counter())\n"
          "sys.path.insert(0, {repo!r})\n"
          "import numpy as np\n"
          "from topsicle_tpu_torch.io import batch as batching\n"
          "from topsicle_tpu_torch.kmers import telophrase_kmers\n"
          "from topsicle_tpu_torch.models import TorchScanModel\n"
          "from topsicle_tpu_torch.native import loader\n"
          "from topsicle_tpu_torch.ops import cuda_kernels\n"
          "t.append(time.perf_counter())\n"
          "built = not cuda_kernels.library_path().exists()\n"
          "cuda_kernels.load_library()\n"
          "t.append(time.perf_counter())\n"
          "reader = loader.status()\n"
          "t.append(time.perf_counter())\n"
          "rng = np.random.default_rng(5)\n"
          "codes = rng.integers(0, 4, (128, 19968)).astype(np.uint8)\n"
          "lens = np.full(128, 19968, np.int32)\n"
          "model = TorchScanModel(telophrase_kmers('CCCTAAA', 5), device='cuda',\n"
          "                       window_size=100, slide=6)\n"
          "np.asarray(model.step1_counts_launch(codes[:, :2000].reshape(128, 2, 1000),\n"
          "                                     np.full(128, 1000, np.int32)))\n"
          "th = model.step2_boundary_launch(codes, batching.window_counts_for_lengths(\n"
          "    lens, 100, 6), lens)\n"
          "[np.asarray(x) for x in th]\n"
          "t.append(time.perf_counter())\n"
          "names = ['import torch', 'CUDA context', 'import the port', 'kernel library',\n"
          "         'C++ reader', 'first batch (B=128, step 1 and step 2, k=5)']\n"
          "print(json.dumps(dict(built=built, reader=reader,\n"
          "                      s={{n: b - a for n, a, b in zip(names, t, t[1:])}})))\n")


def _cache_phase(repo, work, fq, oracle, device_line, smi):
    """Phase 4's compile cache: `--precompile` with TOPSICLE_COMPILE_CACHE
    set to a fresh directory builds the kernels' library and the C++
    reader there and nothing in the package's _build/; a fresh CLI
    process on the e2e file with the same cache builds nothing, launches
    its kernels and writes the oracle's bytes; then a fresh process's
    start, split, with that cache warm and with an empty one.  Returns
    the lines to print."""
    import json

    from topsicle_tpu_torch.native import loader

    pkg_build = os.path.join(repo, "topsicle_tpu_torch", "_build")

    def listing():
        return sorted(os.listdir(pkg_build)) if os.path.isdir(pkg_build) else []

    before = listing()
    cache = os.path.join(work, "compile_cache")
    env = {"TOPSICLE_COMPILE_CACHE": cache}
    common = ["--inputDir", fq, "--pattern", "CCCTAAA", "--slide", "6", "--device", "cuda"]
    out = os.path.join(work, "precompile")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "topsicle_tpu_torch.cli", "--precompile",
                        "--outputDir", out, *common], cwd=repo, capture_output=True,
                       text=True, timeout=MP_TIMEOUT, env={**os.environ, **env})
    wall = time.perf_counter() - t0
    assert r.returncode == 0, f"--precompile exited {r.returncode}:\n{r.stderr[-3000:]}"
    log = open(os.path.join(out, "topsicle_run.log")).read()
    libs = sorted(os.listdir(cache))
    kernels = [n for n in libs if n.startswith("libtopsicle_kernels_") and n.endswith(".so")]
    reader = os.path.join(cache, os.path.basename(loader._SO))
    assert len(kernels) == 1 and os.path.exists(reader), f"compile cache holds {libs}"
    so = os.path.join(cache, kernels[0])
    assert f"kernels: built {so}" in log, "--precompile: no 'kernels: built' line"
    assert f"precompile: reader native C++ (native/tsio.cc), built {reader}" in log, \
        "--precompile: the C++ reader was not built into the cache"
    assert listing() == before, "--precompile wrote into the package"
    lines = [f"[cache] --precompile with TOPSICLE_COMPILE_CACHE={cache}: built {kernels[0]} "
             f"and {os.path.basename(reader)} there, nothing new in topsicle_tpu_torch/_build/; wall "
             f"{wall:.2f} s from process start"]
    out = os.path.join(work, "port5cache")
    wall, launches = _run_processes(repo, [common + ["--outputDir", out, "--batchSize", "128"]],
                                    device_line, env=env)
    log = open(os.path.join(out, "topsicle_run.log")).read()
    said = [ln.split("] ", 1)[-1] for ln in log.splitlines() if "kernels: " in ln
            or "reader: " in ln]
    assert said == [f"reader: native C++ (native/tsio.cc), loaded {reader}",
                    f"kernels: loaded {so}"], f"warm cache: the run log says {said}"
    assert _outputs(out) == _outputs(oracle), "warm cache: outputs differ from the oracle's"
    lines.append(f"[cache] a fresh CLI process on the e2e file with that cache: {said}; "
                 f"outputs byte-identical to the oracle; launches {launches[0]}; wall "
                 f"{wall:.2f} s from process start ({smi})")
    for label, where in (("warm", cache), ("cold", os.path.join(work, "cold_cache"))):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _START.format(repo=repo)], cwd=repo,
                           capture_output=True, text=True, timeout=MP_TIMEOUT,
                           env={**os.environ, "TOPSICLE_COMPILE_CACHE": where})
        wall = time.perf_counter() - t0
        assert r.returncode == 0, f"start split ({label}):\n{r.stderr[-3000:]}"
        got = json.loads(r.stdout.strip().splitlines()[-1])
        assert got["built"] == (label == "cold") and \
            got["reader"].startswith("built" if label == "cold" else "loaded"), got
        rest = wall - sum(got["s"].values())
        lines.append(f"[start] a fresh process, compile cache {label}: " + ", ".join(
            f"{n} {v:.3f} s" for n, v in got["s"].items()) + f"; the interpreter's start "
            f"and exit {rest:.3f} s; wall {wall:.3f} s (host clock; {smi})")
    return lines


def _outputs(out):
    """The CSVs (rawcount ones included) and subset files of a run
    directory, by name."""
    return {n: open(os.path.join(out, n), "rb").read() for n in sorted(os.listdir(out))
            if n.endswith((".csv", ".fastq"))}


def _multiprocess_phase(repo, work, files, device, device_line):
    """Phase 4's multi-process runs on the four-file directory: one
    process (byte-identical to the oracle's outputs), then two processes
    in files mode without and with --coordinator, and in --shardMode
    global; each byte-identical to the single run, no .parts left.
    Returns {label: (wall, [launch counts per process])}."""
    common = ["--inputDir", files, "--pattern", "CCCTAAA", "--slide", "6",
              "--batchSize", "128", "--device", device]
    runs = {}
    out = os.path.join(work, "mp_single")
    card = device == "cuda"
    runs["1 process"] = _run_processes(repo, [common + ["--outputDir", out]], device_line,
                                       card)
    want = _outputs(out)
    oracle = _outputs(os.path.join(work, "oraclefiles"))
    assert want == oracle, "one-process run differs from the oracle"
    assert len(want) == 1 + len(FILE_READS), sorted(want)
    for label, extra in (("2 processes, files", []),
                         ("2 processes, files, --coordinator", ["--coordinator", None]),
                         ("2 processes, --shardMode global",
                          ["--shardMode", "global", "--coordinator", None])):
        out = os.path.join(work, "mp_" + label.replace(" ", "_").replace(",", ""))
        port = f"127.0.0.1:{_free_port()}"
        argvs = [common + ["--outputDir", out, "--processId", str(pid), "--processCount",
                           "2", *[port if x is None else x for x in extra]]
                 for pid in (0, 1)]
        runs[label] = _run_processes(repo, argvs, device_line, card)
        assert _outputs(out) == want, f"{label}: outputs differ from the one-process run"
        assert not os.path.exists(os.path.join(out, ".parts")), f"{label}: .parts left"
    return runs


def _k16_phase(work, k16, device, device_line):
    """Phase 4's k>15 sweep through the CLI: k=9 on the card, k=16 on the
    host oracle model with its WARNING line; outputs byte-identical to
    the oracle's.  Returns the line to print."""
    from topsicle_tpu_torch import cli
    from topsicle_tpu_torch.ops import cuda_kernels

    out = os.path.join(work, "port_k16")
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--inputDir", k16, "--outputDir", out, "--pattern", K16_PATTERN,
                   "--telophrase", *map(str, K16_PHRASES), "--cutoff", str(K16_CUTOFF),
                   "--batchSize", "128", "--device", device])
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    assert rc == 0, f"k>15 sweep: port CLI exited {rc}"
    log = open(os.path.join(out, "topsicle_run.log")).read()
    assert device_line in log, "k>15 sweep: not run on the card"
    assert "WARNING: telophrase 16 exceeds the device k-mer capacity (15)" in log
    got = _outputs(out)
    assert got == _outputs(os.path.join(work, "oraclek16")), "k>15 sweep differs from the oracle"
    csv = got["telolengths_all.csv"]
    rows = {k: csv.count(b",%d," % k) for k in K16_PHRASES}
    assert rows[9] > 0, f"k>15 sweep: rows per k {rows}"
    if device != "cpu":
        assert sum(launches.values()) > 0, "k>15 sweep: k=9 launched no kernel"
    return (f"[k16] --pattern {K16_PATTERN} --telophrase 9 16 --cutoff {K16_CUTOFF} on "
            f"{K16_READS} reads: rows per k {rows}, CSV and subset byte-identical to the "
            f"oracle; k=16 on the host with the WARNING line; launches {launches}; "
            f"wall {wall:.2f} s")


def _global_of(torch, root):
    """`python3 chip_smoke.py --global-of DIR`: only phase 4's two-process
    --shardMode global run on the four seeded files, through the CLI of
    the checkout at DIR, GLOBAL_RUNS times on the card after building or
    loading DIR's kernel library in a process of its own; prints the walls
    from process start and each process's own elapsed time (from its
    CLI's start, after its imports), so that two commits' global runs
    can be read in turns in one call.  Every run must write the same
    bytes (their hash is printed).  No result line."""
    import hashlib

    import numpy as np

    root = os.path.abspath(root)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_run", "global_of")
    files = os.path.join(work, "files")
    if not os.path.exists(os.path.join(work, "written")):     # the turns share the inputs
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(files)
        rng = np.random.default_rng(8)
        for i, n in enumerate(FILE_READS):
            _write_fastq(os.path.join(files, f"part{i}.fastq.gz"), rng, n)
        open(os.path.join(work, "written"), "w").close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    device_line = f"device: cuda:0 ({torch.cuda.get_device_name(0)})"
    # DIR's kernel library first, so that no timed run builds it
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from topsicle_tpu_torch.ops import cuda_kernels; "
                    "cuda_kernels.load_library()", root], check=True, timeout=MP_TIMEOUT)
    ready = time.perf_counter() - t0
    common = ["--inputDir", files, "--pattern", "CCCTAAA", "--slide", "6", "--batchSize",
              "128", "--device", "cuda", "--shardMode", "global", "--processCount", "2"]
    walls, elapsed, digests = [], [], set()
    for run in range(GLOBAL_RUNS):
        out = os.path.join(work, f"run{run}")
        shutil.rmtree(out, ignore_errors=True)
        port = f"127.0.0.1:{_free_port()}"
        mine = []
        wall, _ = _run_processes(root, [common + ["--outputDir", out, "--coordinator", port,
                                                  "--processId", str(pid)] for pid in (0, 1)],
                                 device_line, elapsed=mine)
        walls.append(wall)
        elapsed.append(mine)
        got = _outputs(out)
        assert len(got) == 1 + len(FILE_READS), sorted(got)
        digests.add(hashlib.sha256(b"".join(got[n] for n in sorted(got))).hexdigest()[:16])
        shutil.rmtree(out)
    assert len(digests) == 1, f"{root}: the runs wrote different bytes {digests}"
    print(f"[global] {root}: two processes, --shardMode global, {sum(FILE_READS)} reads in "
          f"{len(FILE_READS)} files, {GLOBAL_RUNS} runs: walls from process start "
          f"{[round(w, 3) for w in walls]} s (median {statistics.median(walls):.3f}); each "
          f"process's own elapsed {elapsed} s (median "
          f"{statistics.median(sum(elapsed, [])):.2f}); outputs {digests.pop()} in every run; "
          f"DIR's kernel library built or loaded first in {ready:.2f} s ({smi})")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--times-of"]:
        return _times_of(torch, sys.argv[2])
    if sys.argv[1:2] == ["--global-of"]:
        return _global_of(torch, sys.argv[2])
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np

    from topsicle_tpu_torch.ops import cuda_kernels

    # ---- 1. environment ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {name}, count {torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda_kernels.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] nvcc: {nvcc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")
    mods = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "pandas")}
    print(f"[env] host modules: {mods} (matplotlib draws --plot and the quadfit "
          f"plot; pandas writes --rawcountpattern's CSVs)")

    # the reference runs: the oracle writes its CSVs on the CPU meanwhile
    work = os.path.join(repo, "_smoke_run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fq = os.path.join(work, "reads.fastq.gz")
    bp = _write_fastq(fq, np.random.default_rng(7))
    print(f"[e2e] wrote 4096 reads, {bp / 1e6:.1f} Mbp")
    files = os.path.join(work, "files")
    os.makedirs(files)
    rng = np.random.default_rng(8)
    file_bp = [_write_fastq(os.path.join(files, f"part{i}.fastq.gz"), rng, n)
               for i, n in enumerate(FILE_READS)]
    files_bp = sum(file_bp)
    print(f"[mp] wrote {len(FILE_READS)} files of {FILE_READS} reads, "
          f"{files_bp / 1e6:.1f} Mbp")
    k16 = os.path.join(work, "k16.fastq.gz")
    _write_fastq(k16, np.random.default_rng(16), K16_READS, pattern=K16_PATTERN)
    print(f"[k16] wrote {K16_READS} reads of {K16_PATTERN}")
    long_fq = os.path.join(work, "long.fastq.gz")
    long_bp = _write_fastq(long_fq, np.random.default_rng(60), LONG_READS, length=LONG_LENGTH,
                           telo=LONG_TELO)
    mega_fq = os.path.join(work, "mega.fastq.gz")
    mega_bp = _write_fastq(mega_fq, np.random.default_rng(61), MEGA_READS, length=MEGA_LENGTH,
                           telo=MEGA_TELO)
    print(f"[long] wrote {LONG_READS} reads of 60-70 kbp ({long_bp / 1e6:.1f} Mbp) and "
          f"{MEGA_READS} of 0.5-1 Mbp ({mega_bp / 1e6:.1f} Mbp)")
    # the longest oracles first: they walk every window of every passing read
    oracles = {"mega": _start_oracle(repo, os.path.join(work, "oraclemega"), input_dir=mega_fq,
                                     slide=6, maxlengthtelo=1000000, telophrase=[5, 7],
                                     rawcountpattern=True),
               "long5": _start_oracle(repo, os.path.join(work, "oraclelong5"),
                                      input_dir=long_fq, slide=1, maxlengthtelo=60000),
               "long7": _start_oracle(repo, os.path.join(work, "oraclelong7"),
                                      input_dir=long_fq, slide=1, maxlengthtelo=60000,
                                      telophrase=[7]),
               5: _start_oracle(repo, os.path.join(work, "oracle5"), input_dir=fq, slide=6),
               7: _start_oracle(repo, os.path.join(work, "oracle7"), input_dir=fq, slide=6,
                                telophrase=[7]),
               "files": _start_oracle(repo, os.path.join(work, "oraclefiles"),
                                      input_dir=files, slide=6),
               "raw": _start_oracle(repo, os.path.join(work, "oracleraw"),
                                    input_dir=os.path.join(files, RAW_FILE), slide=6,
                                    telophrase=[7], rawcountpattern=True),
               "k16": _start_oracle(repo, os.path.join(work, "oraclek16"), input_dir=k16,
                                    pattern=K16_PATTERN, telophrase=K16_PHRASES,
                                    cutoff=[K16_CUTOFF])}
    try:
        return _phases(torch, name, smi, repo, work, fq, bp, oracles,
                       (files, files_bp, k16, file_bp[2]),
                       (long_fq, long_bp, mega_fq, mega_bp))
    finally:
        for p in oracles.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def _phases(torch, name, smi, repo, work, fq, bp, oracles, mp_inputs, long_inputs) -> int:
    """Phases 2-5; `oracles` are the running OracleEngine processes,
    `mp_inputs` the four-file directory, its bases and the k>15 input,
    `long_inputs` the long-scan files and their bases."""
    import numpy as np

    from topsicle_tpu_torch import cli, ops
    from topsicle_tpu_torch.io import batch as batching
    from topsicle_tpu_torch.io import writer
    from topsicle_tpu_torch.kmers import pack_kmer_table, telophrase_kmers
    from topsicle_tpu_torch.models import TorchScanModel
    from topsicle_tpu_torch.ops import changepoint, cuda_kernels, geometry

    dev = torch.device("cuda", 0)
    t_oracle = time.perf_counter()

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_kernels.build_library()
    cuda_kernels.load_library()
    print(f"[build] {so.relative_to(repo)} from "
          f"{[str(s.relative_to(repo)) for s in cuda_kernels.sources()]} (+ "
          f"{[h.name for h in cuda_kernels.headers()]}) in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    t0 = time.perf_counter()
    from topsicle_tpu_torch.native import native_available

    print(f"[build] native reader (topsicle_tpu_torch/native/tsio.cc, g++ and zlib): "
          f"{'built and loaded' if native_available() else 'unavailable, the Python reader runs'}"
          f" in {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels vs plain -------------------------------------------------
    rng = np.random.default_rng(2024)
    L = 19968                                   # static_scan_length(), 20 kbp reads
    demo = pack_kmer_table(telophrase_kmers("CCCTAAA", 5))
    k7 = pack_kmer_table(telophrase_kmers("CCCTAAA", 7))
    max_err = {n: 0 for n in cuda_kernels.LAUNCHES}
    GRID = ("sum_signal", "greedy_signal", "greedy_counts")     # entries with a grid
    CLUSTER = ("sum_boundary", "greedy_boundary")              # entries with a cluster
    max_err.update({n + "[grid]": 0 for n in GRID})
    max_err.update({n + "[cluster]": 0 for n in CLUSTER})

    def wire(codes, lens, lean):
        if lean:
            return (torch.from_numpy(batching.pack_codes(codes)).to(dev),
                    torch.from_numpy(lens.astype(np.int32)).to(dev))
        p, m = batching.pack_batch(codes)
        return torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)

    def agree(kernel, label, got, want):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want).abs().max()) if got.numel() else 0
        max_err[kernel] = max(max_err[kernel], err)
        assert torch.equal(got, want), f"{kernel} {label}: kernel differs from plain (max {err})"

    def agree_boundary(kernel, label, got, want):
        """(t, has) of a kernel against its plain version's, exactly."""
        agree(kernel, label + " t", got[0], want[0])
        agree(kernel, label + " has", got[1].to(torch.uint8), want[1].to(torch.uint8))
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool, f"{label}: dtypes"

    def ragged_windows(lens, w, slide, W):
        """The reads' own window counts, with rows of 0 (an empty shard's
        row), 3 (no valid candidate) and W (every window) among them."""
        nw = batching.window_counts_for_lengths(lens, w, slide)
        nw[:3] = np.minimum((0, 3, W), W)[:len(nw)]
        return nw

    def changepoints(label, y_k, y_p, nw):
        """binseg_l2 on the kernel's y against the plain changepoint on
        the plain y; returns the plain (t, has)."""
        got = cuda_kernels.binseg_l2(y_k, nw)
        want = ops.binseg_l2_device(y_p, nw)
        agree_boundary("binseg_l2", label, got, want)
        return want

    def forced_clusters(kname, label, a, b, tab, nw, kw, want):
        """A fused entry with each read forced onto a cluster of C = 2, 4
        and 8 blocks (where W has that many windows), against the plain
        (t, has)."""
        W = ops.num_windows(kw["L"], kw["window_size"], kw["slide"])
        for C in (2, 4, 8):
            if W >= C:
                cw = -(-W // C)
                agree_boundary(kname + "[cluster]", f"{label} C={-(-W // cw)} (forced)",
                               getattr(cuda_kernels, kname)(a, b, tab, nw, cluster_windows=cw,
                                                            **kw), want)

    def case(label, codes, lens, table, k, w, slide, lean, cpu_check=False):
        tab = torch.from_numpy(table).to(dev)
        a, b = wire(codes, lens, lean)
        kw = dict(k=k, window_size=w, slide=slide, L=a.shape[1] * 4, lean=lean)
        y_k = cuda_kernels.sum_signal(a, b, tab, **kw)
        y_p = cuda_kernels.sum_signal_plain(a, b, tab, **kw)
        agree("sum_signal", label, y_k, y_p)
        nw = torch.from_numpy(ragged_windows(lens, w, slide, y_p.shape[1])).to(dev)
        want = changepoints(label, y_k, y_p, nw)
        agree_boundary("sum_boundary", label, cuda_kernels.sum_boundary(a, b, tab, nw, **kw),
                       cuda_kernels.sum_boundary_plain(a, b, tab, nw, **kw))
        forced_clusters("sum_boundary", label, a, b, tab, nw, kw, want)
        if cpu_check:
            y_c = cuda_kernels.sum_signal_plain(a.cpu(), b.cpu(), tab.cpu(), **kw)
            assert torch.equal(y_k.cpu(), y_c), f"{label}: card differs from the CPU"
            t_c, h_c = cuda_kernels.sum_boundary(a.cpu(), b.cpu(), tab.cpu(), nw.cpu(), **kw)
            assert torch.equal(want[0].cpu(), t_c) and torch.equal(want[1].cpu(), h_c), \
                f"{label}: (t, has) on the card differ from the CPU's"
        print(f"[kernel] sum_signal, sum_boundary (one block and forced clusters of 2, 4 "
              f"and 8 blocks a read), binseg_l2 {label}: y_int {tuple(y_k.shape)} and "
              f"(t, has) bit-identical to plain torch (n_windows {nw[:4].tolist()}..), "
              f"{int(want[1].sum())} reads with a boundary")

    def greedy_case(label, codes, lens, table, k, w, slide, lean, cpu_check=False):
        tab = torch.from_numpy(table).to(dev)
        a, b = wire(codes, lens, lean)
        Lw = a.shape[1] * 4
        skw = dict(k=k, window_size=w, slide=slide, L=Lw, lean=lean)
        ckw = dict(k=k, J=w - k, W=ops.num_windows(Lw, w, slide), slide=slide, L=Lw,
                   lean=lean)
        y_k = cuda_kernels.greedy_signal(a, b, tab, **skw)
        y_p = cuda_kernels.greedy_signal_plain(a, b, tab, **skw)
        agree("greedy_signal", label, y_k, y_p)
        c_k = cuda_kernels.greedy_counts(a, b, tab, **ckw)
        c_p = cuda_kernels.greedy_counts_plain(a, b, tab, **ckw)
        agree("greedy_counts", label, c_k, c_p)
        del c_p
        assert torch.equal(ops.window_signal(c_k), y_k), f"{label}: counts and signal differ"
        nw = torch.from_numpy(ragged_windows(lens, w, slide, y_p.shape[1])).to(dev)
        want = changepoints(label, y_k, y_p, nw)
        agree_boundary("greedy_boundary", label,
                       cuda_kernels.greedy_boundary(a, b, tab, nw, **skw), want)
        forced_clusters("greedy_boundary", label, a, b, tab, nw, skw, want)
        if cpu_check:
            y_c = cuda_kernels.greedy_signal_plain(a.cpu(), b.cpu(), tab.cpu(), **skw)
            assert torch.equal(y_k.cpu(), y_c), f"{label}: card differs from the CPU"
            t_c, h_c = cuda_kernels.greedy_boundary(a.cpu(), b.cpu(), tab.cpu(), nw.cpu(), **skw)
            assert torch.equal(want[0].cpu(), t_c) and torch.equal(want[1].cpu(), h_c), \
                f"{label}: (t, has) on the card differ from the CPU's"
        print(f"[kernel] greedy_signal, greedy_counts, greedy_boundary (one block and "
              f"forced clusters of 2, 4 and 8 blocks a read) {label}: y_int "
              f"{tuple(y_k.shape)}, counts {tuple(c_k.shape)} (max {int(c_k.max())}) and "
              f"(t, has) bit-identical to plain torch, binseg_l2's too, "
              f"{int(want[1].sum())} reads with a boundary")

    def ragged(codes):
        lens = rng.integers(L // 2, L + 1, codes.shape[0]).astype(np.int32)
        codes[np.arange(codes.shape[1])[None, :] >= lens[:, None]] = 0xFF
        return codes, lens

    def dirty(codes):
        codes[(rng.random(codes.shape) < 0.02) & (codes < 4)] = 4
        return codes

    for B in (128, 1024):
        codes, lens = ragged(_reads(rng, B, L))
        case(f"B={B} lean ragged", codes, lens, demo, 5, 100, 6, True, cpu_check=B == 128)
        greedy_case(f"B={B} k=7 lean ragged", codes, lens, k7, 7, 100, 6, True,
                    cpu_check=B == 128)
        codes, lens = ragged(_reads(rng, B, L))
        codes = dirty(codes)
        case(f"B={B} dense 2% invalid", codes, lens, demo, 5, 100, 6, False,
             cpu_check=B == 128)
        greedy_case(f"B={B} k=7 dense 2% invalid", codes, lens, k7, 7, 100, 6, False,
                    cpu_check=B == 128)
    codes, lens = ragged(_reads(rng, 128, L))
    k13 = sorted({bytes(codes[0, p:p + 13]) for p in range(0, 4000, 97)})[:31]
    assert len(k13) == 31 and all(max(km) < 4 for km in k13)
    t31 = np.array([sum(int(c) << (2 * j) for j, c in enumerate(km)) for km in k13], np.int32)
    case("K=31 k=13 dense", codes, lens, t31, 13, 100, 6, False)
    codes, lens = ragged(_reads(rng, 128, L))
    case("slide=1 w=20 k=7 lean", codes, lens, k7, 7, 20, 1, True)
    greedy_case("slide=1 w=20 k=7 lean", codes, lens, k7, 7, 20, 1, True)
    # 104 bases hold one window: W = 1 < jump, no candidate at all
    short = _reads(rng, 8, 104)
    case("W=1 < jump lean", short, np.full(8, 104, np.int32), demo, 5, 100, 6, True)
    # binseg_l2 alone: all ties; the two-limb range; A**2 past 64 bits
    for label, y, nw in (
            ("constant y [8, 3312]", np.full((8, 3312), 7, np.int32),
             np.array([3312, 0, 3, 4, 7, 100, 3311, 2000], np.int32)),
            ("[4, 131080] y < 43", rng.integers(0, 40, (4, 131080)).astype(np.int32)
             + 3 * (np.arange(131080)[None, :] < 60000),
             np.array([131080, 131079, 70000, 12], np.int32)),
            ("y < 2**30 [8, 3000]", rng.integers(0, 1 << 30, (8, 3000)).astype(np.int32),
             np.array([3000, 2999, 17, 4, 0, 1500, 3, 9], np.int32))):
        y_d, nw_d = torch.from_numpy(y.astype(np.int32)).to(dev), torch.from_numpy(nw).to(dev)
        want = changepoints(label, y_d, y_d, nw_d)
        assert torch.equal(want[0].cpu(), ops.binseg_l2(y_d.cpu(), nw_d.cpu())[0]), label
        for tw in (32, 100, 2048):
            agree_boundary("binseg_l2", f"{label} tiles of {tw}",
                           cuda_kernels.binseg_l2(y_d, nw_d, tile_windows=tw), want)
        print(f"[kernel] binseg_l2 {label}: (t, has) bit-identical to plain torch at the "
              f"plan's tiles {geometry.binseg_tiles(*y.shape)} and at tiles of 32, 100 and "
              f"2,048 windows, t {want[0].tolist()}, has {want[1].to(torch.uint8).tolist()}")
    codes, lens = ragged(_reads(rng, 128, L, pattern="CCCTAA"))
    greedy_case("CCCTAA k=5 dense 2% invalid", dirty(codes), lens,
                pack_kmer_table(telophrase_kmers("CCCTAA", 5)), 5, 100, 6, False)
    codes, lens = ragged(_reads(rng, 128, L))
    greedy_case("CCCTAAA k=3 lean", codes, lens,
                pack_kmer_table(telophrase_kmers("CCCTAAA", 3)), 3, 100, 6, True)
    # K = 40: two mixed tables, one whose entries repeat theirs (TTAGGG is
    # CCCTAA's reverse complement) and two periodic 7-mers
    k40 = (telophrase_kmers("CCCTAAA", 7) + telophrase_kmers("CCCTAA", 7)
           + telophrase_kmers("TTAGGG", 7) + ["AAAAAAA", "CACACAC"])
    codes, lens = ragged(_reads(rng, 128, L, pattern="CCCTAA"))
    greedy_case(f"K={len(k40)} k=7 dense", dirty(codes), lens, pack_kmer_table(k40),
                7, 100, 6, False)
    # K = 120: the planes of a read pass a block's shared memory, so the
    # table goes in two groups of entries
    codes, lens = ragged(_reads(rng, 16, L, pattern="CCCTAA"))
    greedy_case(f"K={3 * len(k40)} k=7 lean", codes, lens, pack_kmer_table(k40 * 3),
                7, 100, 6, True)
    # a homopolymer entry on reads that are one run of A's: the longest
    # chains a window can hold, J // k + 1 takes of J occurrences
    codes, lens = ragged(np.zeros((16, L), np.uint8))
    greedy_case("AAAAAAA on runs of A lean", codes, lens,
                pack_kmer_table(["AAAAAAA", "CCCTAAA", "TTTTTTT"]), 7, 100, 6, True)
    for w, slide, what in ((72, 31, "J=65, a window's bits straddle three plane words"),
                           (200, 6, "J=193 > 96")):
        codes, lens = ragged(_reads(rng, 16, L))
        greedy_case(f"w={w} slide={slide} k=7 dense ({what})", dirty(codes), lens, k7, 7,
                    w, slide, False)
    # ---- 3. the window-block grid ---------------------------------------------
    def grid_case(label, codes, lens, table, k, w, slide, lean, block_windows=None):
        """sum_signal, greedy_signal and greedy_counts on the window-block
        grid (the picker's own choice, or `block_windows` forced) against
        their plain versions and one block a read (where a read fits one),
        and binseg_l2 on each y against the plain changepoint."""
        tab = torch.from_numpy(table).to(dev)
        a, b = wire(codes, lens, lean)
        Lw = a.shape[1] * 4
        W = ops.num_windows(Lw, w, slide)
        skw = dict(k=k, window_size=w, slide=slide, L=Lw, lean=lean)
        ckw = dict(k=k, J=w - k, W=W, slide=slide, L=Lw, lean=lean)
        nw = torch.from_numpy(ragged_windows(lens, w, slide, W)).to(dev)
        found = 0
        for kname, kw in (("sum_signal", skw), ("greedy_signal", skw), ("greedy_counts", ckw)):
            entry = {"sum_signal": "sum", "greedy_signal": "greedy",
                     "greedy_counts": "counts"}[kname]
            route = geometry.pick_route(entry, L=Lw, W=W, K=len(table), k=k, window_size=w,
                                        slide=slide, dense=not lean, fused=False)
            wb = route.block_windows if block_windows is None else block_windows
            assert 0 < wb < W, f"{label}: {kname} would not take the grid ({route})"
            plan = cuda_kernels.launcher_plan(
                "sum" if entry == "sum" else "greedy", L=Lw, W=W, K=len(table), k=k, J=w - k,
                slide=slide, dense=not lean, boundary=False, block_windows=wb)
            assert plan is not None and plan.n_blocks == -(-W // wb) > 1, (label, kname, plan)
            kern = getattr(cuda_kernels, kname)
            n0 = cuda_kernels.LAUNCHES[kname]
            got = kern(a, b, tab, block_windows=block_windows, **kw)
            want = getattr(cuda_kernels, kname + "_plain")(a, b, tab, **kw)
            agree(kname + "[grid]", label, got, want)
            assert cuda_kernels.LAUNCHES[kname] == n0 + 1
            if route.kind != "grid":        # the read fits one block: the same bits there
                agree(kname, label + " one block a read", kern(a, b, tab, block_windows=0, **kw),
                      want)
            if got.dim() == 2:
                found = int(changepoints(f"{label} {kname}", got, want, nw)[1].sum())
            del got, want
        print(f"[kernel] window-block grid {label}: sum_signal, greedy_signal (y_int "
              f"[{codes.shape[0]}, {W}]) and greedy_counts ([.., {len(table)}, {W}]) on "
              f"{plan.n_blocks} blocks a read of {plan.block_windows} windows "
              f"({'the picker' if block_windows is None else 'forced'}) bit-identical to "
              f"plain torch, binseg_l2 behind them too (n_windows {nw[:4].tolist()}..), "
              f"{found} reads with a boundary")

    def long_reads(B, L, seed_pattern="CCCTAAA"):
        """[B, L] reads with repeats of up to L / 2 bases and lengths from
        L / 2 to L (the last row all of L)."""
        codes = _reads(rng, B, L, pattern=seed_pattern)
        telo = rng.integers(L // 8, L // 2, B)
        pat = np.array(["ACGT".index(c) for c in seed_pattern], np.uint8)
        keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) >= 0.05)
        codes = np.where(keep, np.resize(pat, L)[None, :], codes).astype(np.uint8)
        lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
        lens[-1] = L
        codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
        return codes, lens

    MEGA = 1 << 20            # 1,048,576 bases: the lean wire alone passes a block
    codes, lens = long_reads(4, MEGA)
    grid_case("L=1048576 slide=6 k=5 lean", codes, lens, demo, 5, 100, 6, True)
    grid_case("L=1048576 slide=6 k=7 dense 2% invalid", dirty(codes), lens, k7, 7, 100, 6,
              False)
    codes, lens = long_reads(2, MEGA)
    grid_case("L=1048576 slide=1 w=20 k=7 lean", codes, lens, k7, 7, 20, 1, True)
    grid_case("L=1048576 slide=1 w=20 k=5 dense 2% invalid", dirty(codes), lens, demo, 5, 20,
              1, False)
    del codes
    codes, lens = ragged(_reads(rng, 16, L))
    grid_case("L=19968 slide=6 k=5 lean, 1,000 windows a block (3,312 = 3 x 1,000 + 312)",
              codes, lens, demo, 5, 100, 6, True, block_windows=1000)
    grid_case("L=19968 slide=7 k=7 dense, 333 windows a block (blocks start at bases "
              "2,331, 4,662, ..: no multiple of 4 or 8)", dirty(codes), lens, k7, 7, 100, 7,
              False, block_windows=333)

    # ---- 3. the fused entries on a cluster: a read past one block ----------------
    def cluster_case(label, codes, lens, table, k, w, slide, lean):
        """sum_boundary and greedy_boundary where one block cannot hold a
        read's y: on the picker's cluster, and forced onto clusters of 2, 4
        and 8 blocks a read, against their plain versions."""
        tab = torch.from_numpy(table).to(dev)
        a, b = wire(codes, lens, lean)
        Lw = a.shape[1] * 4
        W = ops.num_windows(Lw, w, slide)
        kw = dict(k=k, window_size=w, slide=slide, L=Lw, lean=lean)
        nw = torch.from_numpy(ragged_windows(lens, w, slide, W)).to(dev)
        nw[3] = -(-W // 2)                    # n - 1 on the first block's last window
        routes = []
        for body in ("sum", "greedy"):
            route = geometry.pick_route(body, L=Lw, W=W, K=len(table), k=k, window_size=w,
                                        slide=slide, dense=not lean)
            assert route.kind == "cluster", (label, body, route)
            kname = body + "_boundary"
            want = getattr(cuda_kernels, kname + "_plain")(a, b, tab, nw, **kw)
            agree_boundary(kname + "[cluster]", f"{label} C={route.blocks(W)} (the picker)",
                           getattr(cuda_kernels, kname)(a, b, tab, nw, **kw), want)
            forced_clusters(kname, label, a, b, tab, nw, kw, want)
            routes.append(f"{kname} on {route.blocks(W)} blocks of {route.block_windows}")
        print(f"[kernel] fused cluster {label} (y [{codes.shape[0]}, {W}] passes one block): "
              f"{', '.join(routes)} windows (the picker) and forced onto 2, 4 and 8 blocks a "
              f"read, (t, has) bit-identical to plain torch, {int(want[1].sum())} boundaries")

    L60 = 59904               # --maxlengthtelo 60000: y [59,805] at slide 1
    codes, lens = long_reads(8, L60)
    cluster_case("L=59904 slide=1 k=5 lean", codes, lens, demo, 5, 100, 1, True)
    cluster_case("L=59904 slide=1 k=7 dense 2% invalid", dirty(codes), lens, k7, 7, 100, 1,
                 False)
    del codes

    # step 1: [B * 2 ends, no_bp]; rows of 1000, 0, 3 and k bases, a run of A's
    ends = _reads(rng, 256, 1000)
    ends[0, :400] = 0
    ends_len = np.full(256, 1000, np.int32)
    k33 = (telophrase_kmers("CCCTAAA", 5) + telophrase_kmers("CCCTAA", 5)
           + ["AAAAA", "CACAC", "ACACA", "TTTTT", "GGGGG", "ATATA", "CCCTA"])
    for label, kmers in (("CCCTAAA k=7", telophrase_kmers("CCCTAAA", 7)),
                         ("CCCTAAA k=5", telophrase_kmers("CCCTAAA", 5)),
                         ("AAAAAAA", ["AAAAAAA", "CCCTAAA"]),
                         (f"K={len(k33)} k=5 (a second round of entries)", k33),
                         (f"K={len(k40)} k=7", k40)):
        k = len(kmers[0])
        tab = torch.from_numpy(pack_kmer_table(kmers)).to(dev)
        for lean in (True, False):
            e, el = (ends.copy() if lean else dirty(ends.copy())), ends_len.copy()
            el[1:4] = (0, 3, k)
            e[np.arange(1000)[None, :] >= el[:, None]] = 0xFF
            ea, eb = wire(e, el, lean)
            kw = dict(k=k, L=1000, lean=lean)
            c_k = cuda_kernels.step1_counts(ea, eb, tab, **kw)
            agree("step1_counts", label, c_k, cuda_kernels.step1_counts_plain(ea, eb, tab, **kw))
            assert c_k.shape == (256, len(kmers)) and not c_k[1:3].any(), label
            print(f"[kernel] step1_counts {label} [256, 1000] {'lean' if lean else 'dense'}: "
                  f"counts {tuple(c_k.shape)} bit-identical to plain torch (max "
                  f"{int(c_k.max())}; rows of 0 and 3 bases count 0)")
    assert cuda_kernels.STEP1_PLAIN_CALLS["cuda"] == 10, cuda_kernels.STEP1_PLAIN_CALLS

    # ---- 3. the sharded caller, two shards on the one card ------------------
    batches = []
    for label in ("lean", "dense"):
        codes, lens = ragged(_reads(rng, 128, L))
        batches.append((label, codes if label == "lean" else dirty(codes), lens))
    for line in _sharded_phase(torch, dev, batches,
                               _reads(rng, 128, 2000).reshape(128, 2, 1000)):
        print(line)
    del batches

    # ---- 3. global launches that do not wait for the card -----------------
    rng_g = np.random.default_rng(12)      # apart from rng: later phases' inputs stay
    codes_g = _reads(rng_g, 128, L)
    lens_g = rng_g.integers(L // 2, L + 1, 128).astype(np.int32)
    codes_g[np.arange(L)[None, :] >= lens_g[:, None]] = 0xFF
    for line in _nowait_phase(torch, codes_g, lens_g,
                              _reads(rng_g, 128, 2000).reshape(128, 2, 1000),
                              np.full(128, 1000, np.int32)):
        print(line)
    del codes_g

    # ---- 4. end to end ----------------------------------------------------
    for k, p in oracles.items():
        rc = p.wait(timeout=900)
        log = open(os.path.join(work, f"oracle{k}.log")).read()
        assert rc == 0, f"OracleEngine {k} exited {rc}:\n{log[-2000:]}"
    print(f"[e2e] OracleEngine on its {len(oracles)} inputs (as many processes, beside phases "
          f"2-3) done {time.perf_counter() - t_oracle:.1f} s after the build began")
    files, files_bp, k16, raw_bp = mp_inputs
    e2e = {}

    def drive(label, out, oracle, launched, *extra, inp=fq, n_reads=4096, bases=bp,
              slide=6, batch=128, logged=()):
        """One CLI path on the card, with the launch counts set to 0 just
        before it and read just after; `logged`: what its run log must say."""
        cuda_kernels.reset_launch_counts()
        changepoint.PLAIN_CALLS["cuda"] = cuda_kernels.STEP1_PLAIN_CALLS["cuda"] = 0
        t0 = time.perf_counter()
        rc = cli.main(["--inputDir", inp, "--outputDir", os.path.join(work, out), "--pattern",
                       "CCCTAAA", "--slide", str(slide), "--batchSize", str(batch),
                       "--device", "cuda", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        assert rc == 0, f"{label}: port CLI exited {rc}"
        ran = {n for n, c in launches.items() if c > 0}
        assert ran == set(launched), f"{label}: launched {launches}, expected {launched}"
        assert changepoint.PLAIN_CALLS["cuda"] == 0, \
            f"{label}: the plain torch changepoint ran on the card {changepoint.PLAIN_CALLS}"
        assert cuda_kernels.STEP1_PLAIN_CALLS["cuda"] == 0, \
            f"{label}: the plain torch step 1 ran on the card {cuda_kernels.STEP1_PLAIN_CALLS}"
        log_text = open(os.path.join(work, out, "topsicle_run.log")).read()
        assert f"device: cuda:0 ({name})" in log_text, f"{label}: not run on the card"
        reader_line = [ln for ln in log_text.splitlines() if "reader: " in ln][0]
        for text in logged:
            assert text in log_text, f"{label}: no '{text}' in the run log"
        got, want = _outputs(os.path.join(work, out)), _outputs(os.path.join(work, oracle))
        assert sorted(got) == sorted(want), f"{label}: files {sorted(got)} vs {sorted(want)}"
        for fname in want:
            assert got[fname] == want[fname], f"{label}: {fname} differs from the oracle's"
        assert os.path.basename(writer.subset_path(work, inp, 0.7)) in want, sorted(want)
        rows = got["telolengths_all.csv"].count(b"\n") - 1
        assert rows > n_reads // 40, f"{label}: only {rows} rows"
        print(f"[e2e] {label} on {name}: {rows} rows, {len(want)} files (CSVs and subset) "
              f"byte-identical to the oracle; kernel launches {launches}, plain changepoint "
              f"and plain step 1 on the card 0 times; {reader_line.split('] ')[-1]}; wall "
              f"{wall:.2f} s = {n_reads / wall:.0f} reads/s, {bases / 1e6 / wall:.2f} Mbp/s")
        e2e[label] = (wall, launches, n_reads, bases)
        return want

    drive("k=5 auto", "port5", "oracle5", ["sum_boundary", "step1_counts"])
    drive("--telophrase 7", "port7", "oracle7", ["greedy_boundary", "step1_counts"],
          "--telophrase", "7")
    drive("--kernel greedy k=5", "port5g", "oracle5",
          ["greedy_signal", "binseg_l2", "step1_counts"], "--kernel", "greedy")
    drive("--kernel sum k=5", "port5s", "oracle5", ["sum_signal", "binseg_l2", "step1_counts"],
          "--kernel", "sum")
    raw = drive("--telophrase 7 --rawcountpattern", "port7raw", "oracleraw",
                ["greedy_boundary", "greedy_counts", "step1_counts"], "--telophrase", "7",
                "--rawcountpattern", inp=os.path.join(files, RAW_FILE), n_reads=RAW_READS,
                bases=raw_bp)
    n_raw = sum(n.startswith("rawcount_7_") for n in raw)
    assert n_raw > RAW_READS // 40, f"--rawcountpattern: {n_raw} rawcount CSVs"
    print(f"[e2e] --rawcountpattern: {n_raw} rawcount CSVs among them")
    # long scans: past one fused block (y [W] alone passes a block: the fused
    # entries on a cluster of a read's blocks), then past every one-block
    # layout (the window-block grid of all three entries, then binseg_l2)
    long_fq, long_bp, mega_fq, mega_bp = long_inputs
    cluster60 = ("is past one block's shared memory: {}, on a cluster of 2 blocks a read "
                 "(29903 windows a block)")
    drive("--maxlengthtelo 60000 --slide 1 k=5", "portlong5", "oraclelong5",
          ["sum_boundary", "step1_counts"], *LONG_ARGS, inp=long_fq,
          n_reads=LONG_READS, bases=long_bp, slide=1, batch=8,
          logged=["INFO: scan length 59904", cluster60.format("sum_boundary")])
    drive("--maxlengthtelo 60000 --slide 1 --telophrase 7", "portlong7", "oraclelong7",
          ["greedy_boundary", "step1_counts"], *LONG_ARGS, "--telophrase", "7",
          inp=long_fq, n_reads=LONG_READS, bases=long_bp, slide=1, batch=8,
          logged=[cluster60.format("greedy_boundary")])
    past = "is past the fused kernel's shared memory: "
    on_grid = f"on the window-block grid ({geometry.BLOCK_WINDOWS} windows a block)"
    mega = drive("--maxlengthtelo 1000000 --telophrase 5 7 --rawcountpattern", "portmega",
                 "oraclemega",
                 ["sum_signal", "greedy_signal", "greedy_counts", "binseg_l2", "step1_counts"],
                 *MEGA_ARGS, inp=mega_fq, n_reads=MEGA_READS, bases=mega_bp, batch=2,
                 logged=["INFO: scan length 999936", past + "sum_signal then binseg_l2, "
                         + on_grid, past + "greedy_signal then binseg_l2, " + on_grid,
                         "takes greedy_counts, " + on_grid])
    n_raw = sum(n.startswith("rawcount_") for n in mega)
    assert n_raw >= 4, f"--maxlengthtelo 1000000 --rawcountpattern: {n_raw} rawcount CSVs"
    print(f"[e2e] long scans: {n_raw} rawcount CSVs of 166,640 windows among the last run's")
    device_line = f"device: cuda:0 ({name})"
    mp = _multiprocess_phase(repo, work, files, "cuda", device_line)
    for label, (wall, launches) in mp.items():
        print(f"[mp] {label} on {name}: CSV and {len(FILE_READS)} subsets byte-identical to "
              f"{'the oracle' if label == '1 process' else 'the one-process run'}, no .parts "
              f"left; kernel launches per process {launches}; wall {wall:.2f} s")
    print(_k16_phase(work, k16, "cuda", device_line))
    for line in _cache_phase(repo, work, fq, os.path.join(work, "oracle5"), device_line, smi):
        print(line)

    # ---- 5. times ---------------------------------------------------------
    B = 128
    codes, lens = ragged(_reads(rng, B, L))
    a, b = wire(codes, lens, True)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    nw_dev = torch.from_numpy(nw).to(dev)
    W = ops.num_windows(L, 100, 6)
    n_cand = W // 5
    times, bounds = {}, {}

    def timed(kname, label, kern, plain, reps=25):
        times[kname] = _median_ms(torch, kern, plain, reps)
        q, paced, pl = times[kname]
        bd, by, n_bytes, n_ops = bounds[kname]
        print(f"[time] {kname} {label}: kernel {paced:.4f} ms a launch paced by the host, "
              f"{q:.4f} ms queued back to back, plain torch {pl:.4f} ms, bound {bd:.5f} ms "
              f"by {by} ({n_bytes} bytes, {n_ops} operations; {bd / q:.1%} of the queued "
              f"time), no library call computes it (CUDA events, medians; {smi})")
        assert bd <= q, f"{kname}: {q} ms is under its bound of {bd} ms: the count is wrong"

    def sweep_tiles(label, y_, nw_):
        """binseg_l2 at tiles of 256 * V windows, V = 4, 8, 16, in turns
        (there and back), queued; {tile: median ms}.  Each tile is held to
        the plain version first."""
        want = ops.binseg_l2_device(y_, nw_)
        q = {tw: [] for tw in BINSEG_SWEEP}
        for tw in BINSEG_SWEEP + BINSEG_SWEEP[::-1]:
            agree_boundary("binseg_l2", f"{label} tiles of {tw}",
                           cuda_kernels.binseg_l2(y_, nw_, tile_windows=tw), want)
            q[tw].append(_queued_ms(torch, lambda: cuda_kernels.binseg_l2(
                y_, nw_, tile_windows=tw), rounds=5))
        med = {tw: statistics.median(v) for tw, v in q.items()}
        plan = geometry.binseg_tiles(*y_.shape)
        print(f"[time] binseg_l2 {label} at forced tiles: " + ", ".join(
            f"{tw} windows ({geometry.binseg_tiles(*y_.shape, tw)[1]} a row) {ms:.4f} ms"
            for tw, ms in med.items()) + f"; the plan takes {plan[0]} ({plan[1]} a row); "
            f"queued back to back, in turns (CUDA events, medians; {smi})")
        return med

    # Bounds, from this run's inputs.  Bytes: each input once, each output
    # once.  Operations: the 32-bit integer operations the function needs,
    # whatever the kernel's body spends.  A position whose k-mer lies
    # inside the read's length: the rolling code (shift, insert, mask), its
    # validity and the table lookup, 5.  The sum signal adds 3 a position
    # (popcount, add into and OR into its group of `slide` positions: every
    # window starts on a group), 3 a group (a prefix add and two segment
    # ORs) and 4 a window (difference, OR, popcount, add).  The changepoint:
    # 2 a window (the int64 prefix) and 40 a candidate (A and D in int64
    # and the exact 192-bit compare of A*A*D, in 32-bit operations).
    # The greedy counts, whatever computes them: a position inside the read
    # needs its code and validity (4) and one match bit an entry (K); a
    # (window, entry) whose window starts inside the read the extraction of
    # its bits, their count, the floor and the add (4; the raw counts a
    # store for the last two); every window its sum's store (1); and a
    # self-overlapping entry one step for each match its chain TAKES (clear
    # below the next free offset, find the lowest, count, advance: 4), from
    # this run's plain counts.  No walk over offsets is among the needs.
    # Step 1 is the same with one window a row.
    from topsicle_tpu_torch.kmers import aperiodic_mask

    def positions_inside(lengths, k, n_positions):
        return np.clip(lengths.astype(np.int64) - k + 1, 0, n_positions)

    def greedy_ops(lengths, kmers, k, J, W, slide, counts):
        """Operations the greedy counts of `kmers` need on reads of these
        lengths: W windows of J offsets, `slide` apart; `counts` [B, K, W]
        are this run's plain counts, whose self-overlapping entries' sum
        is the number of matches taken."""
        inside = positions_inside(lengths, k, (W - 1) * slide + J)
        started = np.minimum(-(-inside // slide), W)
        overlapping = [i for i, ap in enumerate(aperiodic_mask(kmers)) if not ap]
        takes = int(counts[:, overlapping].sum())
        K = len(kmers)
        return int(((4 + K) * inside).sum() + 4 * K * started.sum() + len(lengths) * W
                   + 4 * takes)

    wire_bytes = a.numel() + b.numel() * 4
    inside = int(positions_inside(lens, 5, (W - 1) * 6 + 95).sum())
    sum_ops = 8 * inside + 3 * -(-inside // 6) + 4 * B * W
    binseg_ops = B * (2 * W + 40 * n_cand)
    kmers7 = telophrase_kmers("CCCTAAA", 7)
    bounds["sum_boundary"] = _bound(wire_bytes + B * 4 + B * 9, sum_ops + binseg_ops)
    bounds["sum_signal"] = _bound(wire_bytes + B * W * 4, sum_ops)
    bounds["binseg_l2"] = _bound(B * W * 4 + B * 4 + B * 9, binseg_ops)
    tab5, tab7 = torch.from_numpy(demo).to(dev), torch.from_numpy(k7).to(dev)
    kw5 = dict(k=5, window_size=100, slide=6, L=L, lean=True)
    kw7 = dict(kw5, k=7)
    ckw = dict(k=7, J=93, W=W, slide=6, L=L, lean=True)
    g_ops = greedy_ops(lens, kmers7, 7, 93, W, 6,
                       cuda_kernels.greedy_counts_plain(a, b, tab7, **ckw))
    bounds["greedy_boundary"] = _bound(wire_bytes + B * 4 + B * 9, g_ops + binseg_ops)
    bounds["greedy_signal"] = _bound(wire_bytes + B * W * 4, g_ops)
    bounds["greedy_counts"] = _bound(wire_bytes + B * len(k7) * W * 4, g_ops)
    timed("sum_boundary", "B=128 L=19968 k=5 lean",
          lambda: cuda_kernels.sum_boundary(a, b, tab5, nw_dev, **kw5),
          lambda: cuda_kernels.sum_boundary_plain(a, b, tab5, nw_dev, **kw5), reps=10)
    timed("sum_signal", "B=128 L=19968 k=5 lean",
          lambda: cuda_kernels.sum_signal(a, b, tab5, **kw5),
          lambda: cuda_kernels.sum_signal_plain(a, b, tab5, **kw5))
    y = cuda_kernels.sum_signal(a, b, tab5, **kw5)
    agree_boundary("binseg_l2", "y [128, 3312]", cuda_kernels.binseg_l2(y, nw_dev),
                   ops.binseg_l2_device(y, nw_dev))
    timed("binseg_l2", "y [128, 3312]", lambda: cuda_kernels.binseg_l2(y, nw_dev),
          lambda: ops.binseg_l2_device(y, nw_dev), reps=10)
    tile_sweep = {"binseg_l2": sweep_tiles("y [128, 3312]", y, nw_dev)}
    timed("greedy_boundary", "B=128 L=19968 k=7 lean",
          lambda: cuda_kernels.greedy_boundary(a, b, tab7, nw_dev, **kw7),
          lambda: cuda_kernels.greedy_boundary_plain(a, b, tab7, nw_dev, **kw7), reps=10)
    timed("greedy_signal", "B=128 L=19968 k=7 lean",
          lambda: cuda_kernels.greedy_signal(a, b, tab7, **kw7),
          lambda: cuda_kernels.greedy_signal_plain(a, b, tab7, **kw7))
    timed("greedy_counts", "rawcounts [128, 14, 3312] k=7 lean",
          lambda: cuda_kernels.greedy_counts(a, b, tab7, **ckw),
          lambda: cuda_kernels.greedy_counts_plain(a, b, tab7, **ckw), reps=10)
    # The fused changepoint's share: each fused entry less its signal entry
    # (y written out) in the same run, against the changepoint's own bound
    # (2 operations a window, 40 a candidate)
    cp_share = {}
    for kname, signal in (("sum_boundary", "sum_signal"), ("greedy_boundary", "greedy_signal")):
        cp_share[kname] = times[kname][0] - times[signal][0]
        print(f"[time] the changepoint fused in {kname}: {kname} {times[kname][0]:.4f} - "
              f"{signal} {times[signal][0]:.4f} = {cp_share[kname]:.4f} ms queued, against its "
              f"bound {binseg_ops / INT32_OPS_PER_S * 1e3:.5f} ms ({binseg_ops} operations; "
              f"CUDA events, medians; {smi})")
    # the fused entries on clusters of C blocks a read at the default shape,
    # in turns (the sweep that sets ops/geometry.py's choice of one block)
    cluster_sweep = {}
    for kname, kern in (
            ("sum_boundary", lambda cw: cuda_kernels.sum_boundary(a, b, tab5, nw_dev,
                                                                   cluster_windows=cw, **kw5)),
            ("greedy_boundary", lambda cw: cuda_kernels.greedy_boundary(
                a, b, tab7, nw_dev, cluster_windows=cw, **kw7))):
        q = {C: [] for C in CLUSTER_SWEEP}
        for C in CLUSTER_SWEEP + CLUSTER_SWEEP[::-1]:
            cw = -(-W // C) if C > 1 else W
            q[C].append(_queued_ms(torch, lambda: kern(cw), rounds=5))
        cluster_sweep[kname] = {C: statistics.median(v) for C, v in q.items()}
        print(f"[time] {kname} B=128 L=19968 on clusters of C blocks a read (forced): " + ", ".join(
            f"C={C} {ms:.4f} ms" for C, ms in cluster_sweep[kname].items())
            + f"; queued back to back, in turns (CUDA events, medians; {smi})")
    # The cluster route where the picker takes it: --maxlengthtelo 60000
    # --slide 1, one batch of 8 reads (y [8, 59805]), beside the two launches
    # a read past one block took before (the signal entry one block a read,
    # then binseg_l2), in turns
    B60, L60 = 8, 59904
    codes60, lens60 = long_reads(B60, L60)
    a60, b60 = wire(codes60, lens60, True)
    W60 = ops.num_windows(L60, 100, 1)
    nw60 = torch.from_numpy(batching.window_counts_for_lengths(lens60, 100, 1)).to(dev)
    kw60 = {5: dict(kw5, slide=1, L=L60), 7: dict(kw7, slide=1, L=L60)}
    inside60 = int(positions_inside(lens60, 5, (W60 - 1) + 95).sum())
    ops60 = {"sum_boundary": 8 * inside60 + 3 * inside60 + 4 * B60 * W60}
    ops60["greedy_boundary"] = greedy_ops(
        lens60, kmers7, 7, 93, W60, 1,
        cuda_kernels.greedy_counts_plain(a60, b60, tab7, k=7, J=93, W=W60, slide=1, L=L60,
                                         lean=True))
    binseg60 = B60 * (2 * W60 + 40 * (W60 // 5))
    cluster60 = {}
    for kname, body, k, tab in (("sum_boundary", "sum", 5, tab5),
                                ("greedy_boundary", "greedy", 7, tab7)):
        route = geometry.pick_route(body, L=L60, W=W60, K=14, k=k, window_size=100, slide=1,
                                    dense=False)
        assert route.kind == "cluster", route
        cname = kname + "[cluster]"
        bounds[cname] = _bound(a60.numel() + b60.numel() * 4 + B60 * 4 + B60 * 9,
                              ops60[kname] + binseg60)
        kw = kw60[k]
        fused = getattr(cuda_kernels, kname)
        signal = getattr(cuda_kernels, body + "_signal")
        want = getattr(cuda_kernels, kname + "_plain")(a60, b60, tab, nw60, **kw)
        agree_boundary(cname, f"B={B60} L={L60} slide=1", fused(a60, b60, tab, nw60, **kw), want)
        timed(cname, f"B={B60} L={L60} slide=1 k={k} lean, {route.blocks(W60)} blocks a read",
              lambda: fused(a60, b60, tab, nw60, **kw),
              lambda: getattr(cuda_kernels, kname + "_plain")(a60, b60, tab, nw60, **kw),
              reps=5)

        def two():
            return cuda_kernels.binseg_l2(signal(a60, b60, tab, block_windows=0, **kw), nw60)
        agree_boundary("binseg_l2", f"B={B60} L={L60} slide=1 after {body}_signal", two(), want)
        q = {"fused": [], "two": []}
        for which in ("two", "fused", "fused", "two"):
            q[which].append(_queued_ms(torch, (lambda: fused(a60, b60, tab, nw60, **kw))
                                       if which == "fused" else two, rounds=5))
        cluster60[cname] = {"blocks_a_read": route.blocks(W60),
                           "cluster_windows": route.block_windows,
                           "in_turns_queued_ms": statistics.median(q["fused"]),
                           "two_launch_queued_ms": statistics.median(q["two"])}
        print(f"[time] {cname} B={B60} L={L60} slide 1: one fused launch on "
              f"{route.blocks(W60)} blocks a read {cluster60[cname]['in_turns_queued_ms']:.4f} ms; "
              f"{body}_signal (one block a read) then binseg_l2, the two launches before, "
              f"{cluster60[cname]['two_launch_queued_ms']:.4f} ms; queued back to back, in "
              f"turns (CUDA events, medians; {smi})")
    del codes60, a60
    # The window-block grid.  First forced at the default shape, where no
    # path of the engine takes it (256 blocks of at most 2,048 windows for
    # 128 of 3,312), in turns with one block a read; then where the picker
    # takes it, B = 4 reads of 1,048,576 bases, with binseg_l2 on that y.
    grid_default = {}
    for kname, kern in (
            ("sum_signal", lambda wb: cuda_kernels.sum_signal(a, b, tab5, block_windows=wb,
                                                               **kw5)),
            ("greedy_signal", lambda wb: cuda_kernels.greedy_signal(a, b, tab7,
                                                                     block_windows=wb, **kw7)),
            ("greedy_counts", lambda wb: cuda_kernels.greedy_counts(a, b, tab7,
                                                                     block_windows=wb, **ckw))):
        q = {wb: [] for wb in (0, geometry.BLOCK_WINDOWS)}
        for wb in (0, geometry.BLOCK_WINDOWS, geometry.BLOCK_WINDOWS, 0):
            q[wb].append(_queued_ms(torch, lambda: kern(wb), rounds=5))
        grid_default[kname] = (statistics.median(q[geometry.BLOCK_WINDOWS]),
                               statistics.median(q[0]))
        print(f"[time] {kname} B=128 L=19968 forced onto the window-block grid "
              f"({geometry.BLOCK_WINDOWS} windows a block, 2 blocks a read): "
              f"{grid_default[kname][0]:.4f} ms; one block a read in the same turns "
              f"{grid_default[kname][1]:.4f} ms, queued back to back (CUDA events, medians; "
              f"{smi})")
    B4 = 4
    codes4, lens4 = long_reads(B4, MEGA)
    a4, b4 = wire(codes4, lens4, True)
    W4 = ops.num_windows(MEGA, 100, 6)
    nw4 = torch.from_numpy(batching.window_counts_for_lengths(lens4, 100, 6)).to(dev)
    kw5g, kw7g = dict(kw5, L=MEGA), dict(kw7, L=MEGA)
    ckwg = dict(ckw, W=W4, L=MEGA)
    wire_bytes4 = a4.numel() + b4.numel() * 4
    inside4 = int(positions_inside(lens4, 5, (W4 - 1) * 6 + 95).sum())
    sum_ops4 = 8 * inside4 + 3 * -(-inside4 // 6) + 4 * B4 * W4
    g_ops4 = greedy_ops(lens4, kmers7, 7, 93, W4, 6,
                        cuda_kernels.greedy_counts_plain(a4, b4, tab7, **ckwg))
    bounds["sum_signal[grid]"] = _bound(wire_bytes4 + B4 * W4 * 4, sum_ops4)
    bounds["greedy_signal[grid]"] = _bound(wire_bytes4 + B4 * W4 * 4, g_ops4)
    bounds["greedy_counts[grid]"] = _bound(wire_bytes4 + B4 * len(k7) * W4 * 4, g_ops4)
    bounds["binseg_l2[grid]"] = _bound(B4 * W4 * 4 + B4 * 4 + B4 * 9,
                                       B4 * (2 * W4 + 40 * (W4 // 5)))
    shape4 = f"B={B4} L={MEGA}, {-(-W4 // geometry.BLOCK_WINDOWS)} blocks a read"
    timed("sum_signal[grid]", f"{shape4} k=5 lean",
          lambda: cuda_kernels.sum_signal(a4, b4, tab5, **kw5g),
          lambda: cuda_kernels.sum_signal_plain(a4, b4, tab5, **kw5g), reps=5)
    timed("greedy_signal[grid]", f"{shape4} k=7 lean",
          lambda: cuda_kernels.greedy_signal(a4, b4, tab7, **kw7g),
          lambda: cuda_kernels.greedy_signal_plain(a4, b4, tab7, **kw7g), reps=5)
    timed("greedy_counts[grid]", f"rawcounts [{B4}, 14, {W4}] k=7 lean",
          lambda: cuda_kernels.greedy_counts(a4, b4, tab7, **ckwg),
          lambda: cuda_kernels.greedy_counts_plain(a4, b4, tab7, **ckwg), reps=5)
    y4 = cuda_kernels.sum_signal(a4, b4, tab5, **kw5g)
    agree_boundary("binseg_l2", f"y [{B4}, {W4}]", cuda_kernels.binseg_l2(y4, nw4),
                   ops.binseg_l2_device(y4, nw4))
    timed("binseg_l2[grid]", f"y [{B4}, {W4}]", lambda: cuda_kernels.binseg_l2(y4, nw4),
          lambda: ops.binseg_l2_device(y4, nw4), reps=5)
    tile_sweep["binseg_l2[grid]"] = sweep_tiles(f"y [{B4}, {W4}]", y4, nw4)
    # why the picker leaves a read that needs the grid on the grid: the fused
    # entries forced onto the fewest cluster blocks that fit here, beside the
    # grid signal then binseg_l2, in turns
    mega_cluster = {}
    for kname, body, tab, kwg in (("sum_boundary", "sum", tab5, kw5g),
                                  ("greedy_boundary", "greedy", tab7, kw7g)):
        assert geometry.pick_route(body, L=MEGA, W=W4, K=14, k=kwg["k"], window_size=100,
                                   slide=6, dense=False).kind == "grid"
        cw = next(-(-W4 // C) for C in range(2, geometry.MAX_CLUSTER + 1)
                  if geometry._plan(body, MEGA, W4, 14, kwg["k"], 100 - kwg["k"], 6, False,
                                    True, -(-W4 // C)))
        route = geometry.Route("cluster", cw)
        fused = functools.partial(getattr(cuda_kernels, kname), cluster_windows=cw)
        signal = getattr(cuda_kernels, body + "_signal")
        want = ops.binseg_l2_device(
            getattr(cuda_kernels, body + "_signal_plain")(a4, b4, tab, **kwg), nw4)
        agree_boundary(kname + "[cluster]", f"B={B4} L={MEGA}", fused(a4, b4, tab, nw4, **kwg),
                       want)
        q = {"fused": [], "two": []}
        for which in ("two", "fused", "fused", "two"):
            q[which].append(_queued_ms(
                torch, (lambda: fused(a4, b4, tab, nw4, **kwg)) if which == "fused" else
                (lambda: cuda_kernels.binseg_l2(signal(a4, b4, tab, **kwg), nw4)), rounds=5))
        mega_cluster[kname + "[cluster]"] = {
            "megabase_blocks_a_read": route.blocks(W4),
            "megabase_queued_ms": statistics.median(q["fused"]),
            "megabase_grid_two_launch_queued_ms": statistics.median(q["two"])}
        print(f"[time] {kname}[cluster] B={B4} L={MEGA} slide 6, forced: one fused launch "
              f"on {route.blocks(W4)} blocks a read {statistics.median(q['fused']):.4f} ms; "
              f"{body}_signal on the grid then binseg_l2 (the picker's route) "
              f"{statistics.median(q['two']):.4f} ms; queued back to back, in turns (CUDA "
              f"events, medians; {smi})")
    del codes4, a4, y4
    ends = _reads(rng, 256, 1000)
    ends_len = np.full(256, 1000, np.int32)
    ea, eb = wire(ends, ends_len, True)
    for kname, kmers, tab in (("step1_counts", kmers7, tab7),
                              ("step1_counts k=5", telophrase_kmers("CCCTAAA", 5), tab5)):
        k = len(kmers[0])
        skw = dict(k=k, L=1000, lean=True)
        c1 = cuda_kernels.step1_counts_plain(ea, eb, tab, **skw)
        inside1 = positions_inside(ends_len, k, 1000 - k + 1)
        overlapping = [i for i, ap in enumerate(aperiodic_mask(kmers)) if not ap]
        s1_ops = int(((4 + len(kmers)) * inside1).sum() + 2 * c1.numel()
                     + 4 * int(c1[:, overlapping].sum()))
        bounds[kname] = _bound(ea.numel() + eb.numel() * 4 + c1.numel() * 4, s1_ops)
        timed(kname, f"[256, 1000] k={k} lean",
              lambda: cuda_kernels.step1_counts(ea, eb, tab, **skw),
              lambda: cuda_kernels.step1_counts_plain(ea, eb, tab, **skw), reps=10)
    da, db = wire(dirty(codes.copy()), lens, False)
    kwd = dict(kw5, lean=False)
    print(f"[time] dense wire (2% invalid) B=128 L=19968 k=5: sum_boundary "
          f"{_queued_ms(torch, lambda: cuda_kernels.sum_boundary(da, db, tab5, nw_dev, **kwd)):.4f}"
          f" ms, sum_signal "
          f"{_queued_ms(torch, lambda: cuda_kernels.sum_signal(da, db, tab5, **kwd)):.4f} ms "
          f"queued back to back (CUDA events, medians; {smi})")
    codes8, lens8 = ragged(_reads(rng, 1024, L))
    a8, b8 = wire(codes8, lens8, True)
    nw8 = torch.from_numpy(batching.window_counts_for_lengths(lens8, 100, 6)).to(dev)
    print(f"[time] B=1024 L=19968 k=5 lean: sum_boundary "
          f"{_queued_ms(torch, lambda: cuda_kernels.sum_boundary(a8, b8, tab5, nw8, **kw5)):.4f}"
          f" ms, sum_signal "
          f"{_queued_ms(torch, lambda: cuda_kernels.sum_signal(a8, b8, tab5, **kw5)):.4f} ms "
          f"queued back to back (CUDA events, medians; {smi})")
    del codes8, a8, b8
    for phrase in (5, 7):
        model = TorchScanModel(telophrase_kmers("CCCTAAA", phrase), device=dev,
                               window_size=100, slide=6)
        for _ in range(3):
            model.step2_boundary(codes, nw, lens)
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            model.step2_boundary(codes, nw, lens)
            host.append((time.perf_counter() - t0) * 1e3)
        dev_ms = _cuda_ms(torch, lambda: model.step2_boundary(codes, nw, lens), 20)
        route = f"{model.kernel}_boundary"
        print(f"[time] step-2 launch path k={phrase} ({route}) B=128 (pack, "
              f"H2D, kernel, changepoint, D2H): {statistics.median(host):.3f} ms host clock, "
              f"{statistics.median(dev_ms):.3f} ms CUDA events, median of 20 ({smi})")
    from topsicle_tpu_torch.parallel import ShardedScanModel

    single = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device=dev, window_size=100,
                            slide=6)
    sharded = ShardedScanModel(single, [dev, dev])
    shard_ms = {"1 model": [], "2 shards": []}
    for label, m in (("1 model", single), ("2 shards", sharded)) * 2:
        m.step2_boundary(codes, nw, lens)
        for _ in range(10):
            t0 = time.perf_counter()
            m.step2_boundary(codes, nw, lens)
            shard_ms[label].append((time.perf_counter() - t0) * 1e3)
    print(f"[time] sharded caller, step-2 launch path k=5 B=128: 2 shards on {dev} "
          f"{statistics.median(shard_ms['2 shards']):.3f} ms, 1 model "
          f"{statistics.median(shard_ms['1 model']):.3f} ms host clock, median of 20 each, "
          f"in turns ({smi})")
    pack = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.pack_scan_batch(codes, lens)
        pack.append((time.perf_counter() - t0) * 1e3)
    print(f"[time] of which: host pack (clean check + 2-bit pack) "
          f"{statistics.median(pack):.3f} ms host clock ({smi})")
    for label, (wall, _, n_reads, bases) in e2e.items():
        print(f"[time] end to end {label}: {wall:.2f} s wall for {n_reads} reads = "
              f"{n_reads / wall:.1f} reads/s, {bases / 1e6 / wall:.3f} Mbp/s ({smi})")
    n_files = sum(FILE_READS)
    for label, (wall, _) in mp.items():
        print(f"[time] {label}, {len(FILE_READS)} files: {wall:.2f} s wall from process start "
              f"for {n_files} reads = {n_files / wall:.1f} reads/s, "
              f"{files_bp / 1e6 / wall:.3f} Mbp/s; every process on the one card, so this "
              f"measures process overhead, not scaling ({smi})")
    shutil.rmtree(work, ignore_errors=True)

    src = "topsicle_tpu_torch/csrc/"
    sum_kernel = "topsicle_tpu/ops/pallas_kernels.py:224"
    greedy_kernel = "topsicle_tpu/ops/pallas_kernels.py:148"
    step1 = "topsicle_tpu/models/telomere.py:185"
    rec = [("sum_boundary", "sum_signal.cu", sum_kernel, "k=5 auto"),
           ("sum_signal", "sum_signal.cu", sum_kernel, "--kernel sum k=5"),
           ("binseg_l2", "binseg.cu", "topsicle_tpu/ops/changepoint.py:124",
            "--kernel greedy k=5"),
           ("greedy_boundary", "greedy_signal.cu", greedy_kernel, "--telophrase 7"),
           ("greedy_signal", "greedy_signal.cu", greedy_kernel, "--kernel greedy k=5"),
           ("greedy_counts", "greedy_signal.cu", greedy_kernel,
            "--telophrase 7 --rawcountpattern"),
           ("step1_counts", "step1_counts.cu", step1, "--telophrase 7")]
    # the window-block grid of the three entries that have one, and the
    # changepoint behind it: launches on the long-scan path that takes it;
    # the fused entries' cluster: launches on the 60 kbp paths
    mega_run = "--maxlengthtelo 1000000 --telophrase 5 7 --rawcountpattern"
    rec += [("sum_signal[grid]", "sum_signal.cu", sum_kernel, mega_run),
            ("greedy_signal[grid]", "greedy_signal.cu", greedy_kernel, mega_run),
            ("greedy_counts[grid]", "greedy_signal.cu", greedy_kernel, mega_run),
            ("binseg_l2[grid]", "binseg.cu", "topsicle_tpu/ops/changepoint.py:124", mega_run),
            ("sum_boundary[cluster]", "sum_signal.cu", sum_kernel,
             "--maxlengthtelo 60000 --slide 1 k=5"),
            ("greedy_boundary[cluster]", "greedy_signal.cu", greedy_kernel,
             "--maxlengthtelo 60000 --slide 1 --telophrase 7")]
    max_err["binseg_l2[grid]"] = max_err["binseg_l2"]

    def base(n):
        return n.split("[")[0]

    assert {base(n) for n, *_ in rec} == set(cuda_kernels.LAUNCHES)
    for n, _, _, run in rec:
        assert e2e[run][1][base(n)] > 0, f"{n} was not launched on the {run} path"
    grid_keys = {n + "[grid]": {"block_windows": geometry.BLOCK_WINDOWS,
                                "default_shape_grid_queued_ms": grid_default[n][0],
                                "default_shape_queued_ms": grid_default[n][1]} for n in GRID}
    for n in CLUSTER:
        grid_keys[n] = {
            "changepoint_share_queued_ms": cp_share[n],
            "changepoint_bound_ms": binseg_ops / INT32_OPS_PER_S * 1e3,
            "cluster_sweep_queued_ms": {str(C): ms for C, ms in cluster_sweep[n].items()}}
        grid_keys[n + "[cluster]"] = {**cluster60[n + "[cluster]"],
                                      **mega_cluster[n + "[cluster]"]}
    for n in ("binseg_l2", "binseg_l2[grid]"):
        shape = (B, W) if n == "binseg_l2" else (B4, W4)
        tw, n_tiles = geometry.binseg_tiles(*shape)
        grid_keys[n] = {"tile_windows": tw, "tiles_a_row": n_tiles,
                        "tile_sweep_queued_ms": {str(t): ms for t, ms in tile_sweep[n].items()}}
    # step 1 at the main path's own table (k = 5) rides the step1_counts row
    k5 = {"k5_launches": e2e["k=5 auto"][1]["step1_counts"],
          "k5_ms": times["step1_counts k=5"][1], "k5_queued_ms": times["step1_counts k=5"][0],
          "k5_plain_ms": times["step1_counts k=5"][2],
          "k5_bound_ms": bounds["step1_counts k=5"][0],
          "k5_bound_by": bounds["step1_counts k=5"][1]}
    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda", "source": src + f, "replaces": r, "path": run,
        "launches": e2e[run][1][base(n)], "max_abs_err": max_err[n],
        "ms": times[n][1], "plain_ms": times[n][2], "bound_ms": bounds[n][0],
        "bound_by": bounds[n][1], "bound_bytes": bounds[n][2], "bound_operations": bounds[n][3],
        "library_ms": None, "queued_ms": times[n][0],
        **(k5 if n == "step1_counts" else {}), **grid_keys.get(n, {})}
        for n, f, r, run in rec]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
