"""Hand-written CUDA kernels and their wrappers.

  sum_boundary   csrc/sum_signal.cu     step 2 for aperiodic tables in one
                 launch: the window signal (replaces the TPU kernel
                 topsicle_tpu/ops/pallas_kernels.py::_sum_signal_kernel)
                 with the exact changepoint (csrc/binseg.cuh) behind it in
                 the same block, or across the thread-block cluster of a
                 long read's blocks, so only (t, has) leave the chip
  sum_signal     csrc/sum_signal.cu     the same body with y [B, W] written
                 to device memory instead
  binseg_l2      csrc/binseg.cu         the exact changepoint alone on a y
                 in device memory, each row in tiles of windows, a block a
                 tile (csrc/binseg.cuh's tile functions; replaces the
                 program topsicle_tpu/ops/changepoint.py::binseg_l2_device);
                 follows sum_signal or greedy_signal
  greedy_boundary  csrc/greedy_signal.cu  step 2 for every other table in
                 one launch: the greedy window signal (replaces
                 pallas_kernels.py::_signal_kernel) from match planes, with
                 the changepoint behind it in the same block or cluster
  greedy_signal  csrc/greedy_signal.cu  the same body with y [B, W] written
                 to device memory instead
  greedy_counts  csrc/greedy_signal.cu  the same body without the floor:
                 [B, K, W] per-entry counts for rawcounts
  step1_counts   csrc/step1_counts.cu   step 1 for every table: the greedy
                 count of each entry over a whole read end, a block a row
                 (replaces the programs models/telomere.py::_step1_counts
                 and _step1_counts_lean of the JAX package)

The three sources that read the wire share csrc/wire.cuh (staging a row,
the rolling code and validity of a position, whether an entry's matches
can overlap, the find-first-set take, the window-block grid).

sum_signal, greedy_signal and greedy_counts run one block a read where the
read's rows fit a block's shared memory, and on the window-block grid
(blocks of `block_windows` windows, each staging only the bases its
windows read) where they do not: ops.geometry picks, before the launch, so
that no length is refused.  The fused entries keep a read's whole y on the
chip: in one block, or in the slices of a cluster of up to 8 blocks (a
window block each, launched with a cluster dimension); past that the model
runs a signal entry and binseg_l2.

Every csrc/*.cu is compiled with nvcc (one process per source, started
together, then one link) into a single shared library with a plain C
interface at first use, keyed on a hash of all the sources, the headers
they include (csrc/*.cuh) and the flags, and loaded with ctypes.  The
library lives in the compile cache (utils/compile_cache.py:
TOPSICLE_COMPILE_CACHE, else the package's _build/); one that cannot be
written raises, and no other place is tried.  Nothing
is built or imported from CUDA when this module is imported.

A wrapper takes its kernel's plain torch version only for tensors on
the CPU.  For a CUDA tensor it launches the kernel or raises: a failed
build or launch is never replaced by the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from topsicle_tpu_torch.ops import geometry
from topsicle_tpu_torch.ops.changepoint import binseg_l2_device
from topsicle_tpu_torch.ops.match import (MAX_ROLLING_K, boundary_sum_signal,
                                          greedy_count, match_positions,
                                          num_windows, unpack_wire, window_counts,
                                          window_signal)
from topsicle_tpu_torch.utils import compile_cache

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = compile_cache.default_cache_dir()
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

MAX_ENTRIES = 31            # sum_signal's presence word bits

# Launches of each kernel made by its wrapper (and only there).
LAUNCHES = {"sum_boundary": 0, "sum_signal": 0, "binseg_l2": 0, "greedy_boundary": 0,
            "greedy_signal": 0, "greedy_counts": 0, "step1_counts": 0}

# Calls of step 1's plain version, by device type: 0 on "cuda" for every
# path on a card, as ops.changepoint.PLAIN_CALLS is for the changepoint.
STEP1_PLAIN_CALLS = {"cpu": 0, "cuda": 0}


# The C signature of each entry topsicle_<name>, a letter an argument: p a
# pointer (or the stream), i an int.  ctypes passes an undeclared pointer as
# a 32-bit int and cuts it, so every entry is declared from this table.
_WIRE = "pippipiiiiiii"       # packed, stride, lengths, invalid, stride, table, K, k .. W, B
ENTRY_ARGS = {"sum_boundary": _WIRE + "ipiippp", "sum_signal": _WIRE + "ipp",
              "binseg_l2": "piipiiiipppp", "greedy_boundary": _WIRE + "ipiippp",
              "greedy_signal": _WIRE + "ipp", "greedy_counts": _WIRE + "ipp",
              "step1_counts": "pippipiiiipp"}
# topsicle_<name>_plan: what a launcher would do, without a launch (ints, then
# an int[5] for the answer); topsicle_<name>_max_clusters: how many of a fused
# launch's clusters the card keeps resident (ints, then an int for it)
PLAN_ARGS = {"sum": 8, "greedy": 9}
MAX_CLUSTERS_ARGS = {"sum": 7, "greedy": 8}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- build and load --------------------------------------------------------

_LOCK = threading.Lock()
_LIB = None


def sources() -> list:
    """Every kernel source, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    exe = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built from csrc/ at first use")
    return exe


def headers() -> list:
    """Every header the sources may include, in a fixed order."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the built library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libtopsicle_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile every csrc/*.cu with nvcc, one process per source started
    together, and link them into one library, unless this source set's
    library exists.  The compiler's report (registers, shared memory,
    spills) is kept beside the library as <name>.log.  Raises on
    failure, and leaves no compiler running."""
    so = library_path()
    if so.exists():
        return so
    compile_cache.writable_dir(BUILD_DIR)
    nvcc = find_nvcc()
    work = Path(tempfile.mkdtemp(prefix=f"{so.stem}.", dir=BUILD_DIR))
    procs = []
    try:
        objs = [work / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, o in zip(sources(), objs)]
        outs = [p.communicate(timeout=900) for p in procs]
        log = "".join(out + err for out, err in outs)
        errors = [err for p, (_, err) in zip(procs, outs) if p.returncode != 0]
        if not errors:
            tmp = work / so.name
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True, timeout=300)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                errors.append(link.stderr)
        so.with_suffix(".log").write_text(log)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        os.replace(tmp, so)     # atomic: a concurrent process never loads half a file
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return so


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, args in ENTRY_ARGS.items():
                fn = getattr(lib, f"topsicle_{name}")
                fn.argtypes = [ctypes.c_void_p if a == "p" else ctypes.c_int for a in args]
                fn.restype = ctypes.c_int
            for suffix, table in (("plan", PLAN_ARGS), ("max_clusters", MAX_CLUSTERS_ARGS)):
                for name, n_ints in table.items():
                    fn = getattr(lib, f"topsicle_{name}_{suffix}")
                    fn.argtypes = [ctypes.c_int] * n_ints + [ctypes.POINTER(ctypes.c_int)]
                    fn.restype = ctypes.c_int
            lib.topsicle_cuda_error_string.argtypes = [ctypes.c_int]
            lib.topsicle_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


# ---- shared by the wrappers --------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_wire(name: str, codes_wire: torch.Tensor, aux: torch.Tensor,
                table: torch.Tensor, L: int, lean: bool) -> torch.device:
    """Device, dtype, shape and contiguity checks shared by the kernels'
    wrappers; returns the card the launch goes to."""
    if codes_wire.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {codes_wire.device}")
    dev = codes_wire.device
    _check(codes_wire, "codes_wire", torch.uint8, 2, dev)
    _check(table, "table", torch.int32, 1, dev)
    B = codes_wire.shape[0]
    if codes_wire.shape[1] * 4 < L:
        raise ValueError(f"codes_wire {tuple(codes_wire.shape)} holds fewer than L={L} bases")
    if lean:
        _check(aux, "lengths", torch.int32, 1, dev)
        if aux.shape[0] != B:
            raise ValueError(f"lengths {tuple(aux.shape)} do not match batch {B}")
    else:
        _check(aux, "invalid_bits", torch.uint8, 2, dev)
        if aux.shape[0] != B or aux.shape[1] * 8 < L:
            raise ValueError(f"invalid_bits {tuple(aux.shape)} do not cover [{B}, {L}]")
    return dev


def _check_boundary_args(name: str, n_windows: torch.Tensor, B: int, jump: int,
                         min_size: int) -> None:
    if n_windows.shape[0] != B:
        raise ValueError(f"n_windows {tuple(n_windows.shape)} does not match batch {B}")
    if jump < 1 or min_size < 1:
        raise ValueError(f"{name} takes jump >= 1 and min_size >= 1, got {jump}, {min_size}")


def _wire_args(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor, *,
               k: int, slide: int, J: int, W: int, L: int, lean: bool) -> list:
    """The arguments every wire-reading kernel starts with: packed .. B."""
    return [codes_wire.data_ptr(), codes_wire.shape[1],
            aux.data_ptr() if lean else None,
            None if lean else aux.data_ptr(), 0 if lean else aux.shape[1],
            table.data_ptr(), int(table.shape[0]), k, slide, J, L, W, codes_wire.shape[0]]


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch topsicle_<name>(*args, stream) on `dev`'s current stream;
    raises on a non-zero launch code, counts the launch otherwise.  A
    launcher's own refusal (-2: a block past shared memory) is a fault of
    the caller, which picks a route that fits before it launches."""
    lib = load_library()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"topsicle_{name}")(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.topsicle_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: "
                           + (msg if rc == -2 else f"CUDA error {rc} ({msg})"))
    LAUNCHES[name] += 1


def launcher_plan(entry: str, *, L: int, W: int, K: int, k: int, J: int, slide: int,
                  dense: bool, boundary: bool, block_windows: int = 0):
    """What the built library's launcher of the sum or greedy body would
    do with this geometry, without a launch: ops.geometry's SumPlan or
    GreedyPlan, or None where it would refuse.  Holds ops.geometry, the
    launchers' mirror, against the launchers."""
    lib = load_library()
    out = (ctypes.c_int * 5)()
    tail = (J, slide, int(dense), int(boundary), block_windows, out)
    if entry == "sum":
        rc = lib.topsicle_sum_plan(L, W, k, *tail)
    else:
        rc = lib.topsicle_greedy_plan(L, W, K, k, *tail)
    if rc != 0:
        return None
    if entry == "sum":
        return geometry.SumPlan(out[0], out[1], out[2], out[3], bool(out[4]))
    return geometry.GreedyPlan(*out)


def max_active_clusters(entry: str, *, L: int, W: int, K: int, k: int, J: int, slide: int,
                        dense: bool, block_windows: int = 0) -> int:
    """How many clusters of a fused launch of the sum or greedy body, with
    `block_windows` windows a block, the card keeps resident at once
    (cudaOccupancyMaxActiveClusters); one block a read counts blocks.
    Raises where the launcher would refuse the geometry or CUDA fails."""
    lib = load_library()
    out = ctypes.c_int(0)
    tail = (J, slide, int(dense), block_windows, ctypes.byref(out))
    if entry == "sum":
        rc = lib.topsicle_sum_max_clusters(L, W, k, *tail)
    else:
        rc = lib.topsicle_greedy_max_clusters(L, W, K, k, *tail)
    if rc != 0:
        raise RuntimeError(f"{entry} max_clusters: {lib.topsicle_cuda_error_string(rc).decode()}")
    return out.value


def _cluster_windows(entry: str, cluster_windows: int, *, L: int, W: int, K: int, k: int,
                     J: int, slide: int, lean: bool) -> int:
    """The fused launch's windows a block: the caller's (n < W: a cluster
    of ceil(W / n) blocks; W and more: one block a read), or, for 0, the
    picker's (the cluster route's, else 0: one block a read, which the
    launcher refuses where it does not fit)."""
    if (W - 1) * slide + J + k >= 2 ** 31:
        raise ValueError(f"{W} windows at slide {slide} pass the kernels' 32-bit positions")
    if cluster_windows < 0:
        raise ValueError(f"cluster_windows must be >= 0, got {cluster_windows}")
    if cluster_windows > 0:
        return int(cluster_windows)
    route = geometry.find_route(entry, L=L, W=W, K=K, k=k, window_size=J + k, slide=slide,
                                dense=not lean)
    return route.block_windows if route is not None and route.kind == "cluster" else 0


def _block_windows(entry: str, block_windows, *, L: int, W: int, K: int, k: int, J: int,
                   slide: int, lean: bool) -> int:
    """The launch's windows a block: the caller's (0: one block a read; n:
    the window-block grid at n windows a block, for checks and timings of
    a route the geometry would not take), or the picker's."""
    if (W - 1) * slide + J + k >= 2 ** 31:
        raise ValueError(f"{W} windows at slide {slide} pass the kernels' 32-bit positions")
    if block_windows is not None:
        if block_windows < 0:
            raise ValueError(f"block_windows must be >= 0, got {block_windows}")
        return int(block_windows)
    return geometry.pick_route(entry, L=L, W=W, K=K, k=k, window_size=J + k, slide=slide,
                               dense=not lean, fused=False).block_windows


# ---- sum_signal, sum_boundary and binseg_l2 ----------------------------------

def sum_signal_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                     *, k: int, window_size: int, slide: int, L: int,
                     lean: bool) -> torch.Tensor:
    """The kernel's plain torch version: unpack the wire, then
    ops.match.boundary_sum_signal.  Runs on any device."""
    codes = unpack_wire(codes_wire, aux, L, lean=lean)
    return boundary_sum_signal(codes, table, k, window_size, slide,
                               num_windows(L, window_size, slide))


def sum_signal(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
               *, k: int, window_size: int, slide: int, L: int,
               lean: bool, block_windows: int | None = None) -> torch.Tensor:
    """Step-2 window signal y_int [B, W] int32 from the plain wire.

    codes_wire: [B, >= L/4] uint8 packed bases (io.batch.pack_codes or
                pack_batch: base 4q+s at bits 2s of byte q)
    aux:        lean: [B] int32 valid lengths; dense: [B, >= L/8] uint8
                invalid bit-plane (bit s of byte q marks position 8q+s)
    table:      [K] int32 base-4 rolling codes (-1 never matches)
    Bit-identical to sum_signal_plain.  K <= 31 and k <= 15; equal to
    greedy_signal only for aperiodic tables (the model checks).  Any L:
    one block a read where that fits, else the window-block grid
    (ops.geometry); `block_windows` forces either (0, or the windows a
    block), for checks and timings only."""
    _check_sum_table("sum_signal", table, k)
    if codes_wire.device.type == "cpu":
        return sum_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                                slide=slide, L=L, lean=lean)
    dev = _check_wire("sum_signal", codes_wire, aux, table, L, lean)
    B = codes_wire.shape[0]
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0:
        return torch.zeros((B, W), dtype=torch.int32, device=dev)
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    wb = _block_windows("sum", block_windows, L=L, W=W, K=int(table.shape[0]), k=k, J=J,
                        slide=slide, lean=lean)
    _launch("sum_signal", dev,
            *_wire_args(codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L, lean=lean),
            wb, out.data_ptr())
    return out


def _check_sum_table(name: str, table: torch.Tensor, k: int) -> None:
    if int(table.shape[0]) > MAX_ENTRIES:
        raise ValueError(f"{name} holds at most {MAX_ENTRIES} table entries, "
                         f"got {int(table.shape[0])}")
    if k > MAX_ROLLING_K:
        raise ValueError(f"{name} takes k <= {MAX_ROLLING_K}, got {k}")


def binseg_l2(y_int: torch.Tensor, n_windows: torch.Tensor, jump: int = 5,
              min_size: int = 2, tile_windows: int = 0):
    """Exact argmax changepoint per row of y_int [B, W] int32 with the
    valid-window counts n_windows [B] int32: (t [B] int64, has [B] bool).
    Bit-identical to ops.changepoint.binseg_l2_device, its plain version,
    over that function's whole range (|A| < 2**63, D < 2**62), any W.
    Each row goes in tiles of windows, a block a tile
    (ops.geometry.binseg_tiles); `tile_windows` > 0 forces the tile, for
    checks and timings only.  One launch counted a call, whatever its
    passes."""
    if y_int.device.type == "cpu":
        geometry.binseg_tiles(*y_int.shape, tile_windows)
        return binseg_l2_device(y_int, n_windows, jump=jump, min_size=min_size)
    if y_int.device.type != "cuda":
        raise ValueError(f"binseg_l2 runs on cuda or cpu tensors, got {y_int.device}")
    dev = y_int.device
    _check(y_int, "y_int", torch.int32, 2, dev)
    _check(n_windows, "n_windows", torch.int32, 1, dev)
    B, W = y_int.shape
    _check_boundary_args("binseg_l2", n_windows, B, jump, min_size)
    tw, n_tiles = geometry.binseg_tiles(B, W, tile_windows)
    if B == 0 or W == 0:
        return (torch.zeros(B, dtype=torch.int64, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))
    t = torch.empty(B, dtype=torch.int64, device=dev)
    has = torch.empty(B, dtype=torch.bool, device=dev)
    # tile sums, the tiles' bests (|A|, D, t), partial sums, tickets: the
    # launch writes all of it before it reads it
    scratch = (torch.empty(B * (4 * n_tiles + 2), dtype=torch.int64, device=dev)
               if n_tiles > 1 else None)
    _launch("binseg_l2", dev, y_int.data_ptr(), W, B, n_windows.data_ptr(), jump, min_size,
            tw, n_tiles, None if scratch is None else scratch.data_ptr(), t.data_ptr(),
            has.data_ptr())
    return t, has


def sum_boundary_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                       n_windows: torch.Tensor, *, k: int, window_size: int, slide: int,
                       L: int, lean: bool, jump: int = 5, min_size: int = 2):
    """sum_boundary's plain torch version: sum_signal_plain, then
    ops.changepoint.binseg_l2_device.  Runs on any device."""
    y = sum_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                         slide=slide, L=L, lean=lean)
    return binseg_l2_device(y, n_windows, jump=jump, min_size=min_size)


def sum_boundary(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                 n_windows: torch.Tensor, *, k: int, window_size: int, slide: int,
                 L: int, lean: bool, jump: int = 5, min_size: int = 2,
                 cluster_windows: int = 0):
    """Step 2 for aperiodic tables in one launch: the window signal of
    sum_signal and, in the same block (or across the thread-block cluster
    of a read's blocks), its exact changepoint, so only (t [B] int64, has
    [B] bool) reach device memory.  Wire and table as for sum_signal;
    n_windows [B] int32 valid-window counts.  Bit-identical to
    sum_boundary_plain.  Only for a geometry whose ops.geometry.pick_route
    is fused or a cluster: past it, sum_signal then binseg_l2.
    `cluster_windows` forces the windows a block (n < W: a cluster of
    ceil(W / n) <= 8 blocks a read; W and more: one block), for checks and
    timings only; 0 takes the plan."""
    _check_sum_table("sum_boundary", table, k)
    if codes_wire.device.type == "cpu":
        return sum_boundary_plain(codes_wire, aux, table, n_windows, k=k,
                                  window_size=window_size, slide=slide, L=L, lean=lean,
                                  jump=jump, min_size=min_size)
    dev = _check_wire("sum_boundary", codes_wire, aux, table, L, lean)
    _check(n_windows, "n_windows", torch.int32, 1, dev)
    B = codes_wire.shape[0]
    _check_boundary_args("sum_boundary", n_windows, B, jump, min_size)
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0:
        # no k-mer fits a window: the signal is all zeros
        return binseg_l2(torch.zeros((B, W), dtype=torch.int32, device=dev), n_windows,
                         jump, min_size)
    wb = _cluster_windows("sum", cluster_windows, L=L, W=W, K=int(table.shape[0]), k=k, J=J,
                          slide=slide, lean=lean)
    t = torch.empty(B, dtype=torch.int64, device=dev)
    has = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("sum_boundary", dev,
            *_wire_args(codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L, lean=lean),
            wb, n_windows.data_ptr(), jump, min_size, t.data_ptr(), has.data_ptr())
    return t, has


# ---- greedy_boundary, greedy_signal and greedy_counts -------------------------

def greedy_counts_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                        *, k: int, J: int, W: int, slide: int, L: int,
                        lean: bool) -> torch.Tensor:
    """greedy_counts' plain torch version: unpack the wire, match, then
    ops.match.window_counts.  Runs on any device."""
    codes = unpack_wire(codes_wire, aux, L, lean=lean)
    return window_counts(match_positions(codes, table, k), k, J, W, slide)


def greedy_signal_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                        *, k: int, window_size: int, slide: int, L: int,
                        lean: bool) -> torch.Tensor:
    """greedy_signal's plain torch version: the floored sum of
    greedy_counts_plain over the table.  Runs on any device."""
    return window_signal(greedy_counts_plain(
        codes_wire, aux, table, k=k, J=window_size - k,
        W=num_windows(L, window_size, slide), slide=slide, L=L, lean=lean))


def greedy_boundary_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                          n_windows: torch.Tensor, *, k: int, window_size: int, slide: int,
                          L: int, lean: bool, jump: int = 5, min_size: int = 2):
    """greedy_boundary's plain torch version: greedy_signal_plain, then
    ops.changepoint.binseg_l2_device.  Runs on any device."""
    y = greedy_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                            slide=slide, L=L, lean=lean)
    return binseg_l2_device(y, n_windows, jump=jump, min_size=min_size)


def _check_greedy(name: str, codes_wire: torch.Tensor, aux: torch.Tensor,
                  table: torch.Tensor, k: int, L: int, lean: bool):
    """The greedy wrappers' checks; the card of a CUDA wire, None for a
    CPU one (which takes the plain version)."""
    if k > MAX_ROLLING_K:
        raise ValueError(f"{name} takes k <= {MAX_ROLLING_K}, got {k}")
    if codes_wire.device.type == "cpu":
        return None
    return _check_wire(name, codes_wire, aux, table, L, lean)


def greedy_counts(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                  *, k: int, J: int, W: int, slide: int, L: int,
                  lean: bool, block_windows: int | None = None) -> torch.Tensor:
    """Greedy non-overlapping counts [B, K, W] int32, no floor: window w
    reads offsets w*slide + j, j < J, of the first L bases (offsets
    past them never match).  Step 2's rawcounts take
    J = window_size - k and W = num_windows(L, window_size, slide).
    Wire and table as for sum_signal; any K, duplicates each counted,
    k <= 15.  Bit-identical to greedy_counts_plain.  Any L and W;
    `block_windows` as for sum_signal."""
    dev = _check_greedy("greedy_counts", codes_wire, aux, table, k, L, lean)
    if dev is None:
        return greedy_counts_plain(codes_wire, aux, table, k=k, J=J, W=W, slide=slide,
                                   L=L, lean=lean)
    B, K = codes_wire.shape[0], int(table.shape[0])
    W = max(W, 0)
    if J <= 0 or W == 0 or B == 0 or K == 0:
        return torch.zeros((B, K, W), dtype=torch.int32, device=dev)
    out = torch.empty((B, K, W), dtype=torch.int32, device=dev)
    wb = _block_windows("counts", block_windows, L=L, W=W, K=K, k=k, J=J, slide=slide,
                        lean=lean)
    _launch("greedy_counts", dev,
            *_wire_args(codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L, lean=lean),
            wb, out.data_ptr())
    return out


def greedy_signal(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                  *, k: int, window_size: int, slide: int, L: int,
                  lean: bool, block_windows: int | None = None) -> torch.Tensor:
    """Step-2 window signal y_int [B, W] int32 = sum over the table of
    max(greedy count, 1), exact for every table (periodic, mixed,
    duplicates, any K; k <= 15).  Arguments as for sum_signal, any L.
    Bit-identical to greedy_signal_plain."""
    dev = _check_greedy("greedy_signal", codes_wire, aux, table, k, L, lean)
    if dev is None:
        return greedy_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                                   slide=slide, L=L, lean=lean)
    B, K = codes_wire.shape[0], int(table.shape[0])
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0 or K == 0:
        return torch.full((B, W), K, dtype=torch.int32, device=dev)
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    wb = _block_windows("greedy", block_windows, L=L, W=W, K=K, k=k, J=J, slide=slide,
                        lean=lean)
    _launch("greedy_signal", dev,
            *_wire_args(codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L, lean=lean),
            wb, out.data_ptr())
    return out


def greedy_boundary(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                    n_windows: torch.Tensor, *, k: int, window_size: int, slide: int,
                    L: int, lean: bool, jump: int = 5, min_size: int = 2,
                    cluster_windows: int = 0):
    """Step 2 for every table in one launch: the window signal of
    greedy_signal and, in the same block (or across the thread-block
    cluster of a read's blocks), its exact changepoint, so only (t [B]
    int64, has [B] bool) reach device memory.  Wire and table as for
    greedy_signal; n_windows [B] int32 valid-window counts.
    Bit-identical to greedy_boundary_plain.  Only for a geometry whose
    ops.geometry.pick_route is fused or a cluster: past it, greedy_signal
    then binseg_l2.  `cluster_windows` as for sum_boundary."""
    dev = _check_greedy("greedy_boundary", codes_wire, aux, table, k, L, lean)
    B, K = codes_wire.shape[0], int(table.shape[0])
    _check_boundary_args("greedy_boundary", n_windows, B, jump, min_size)
    if dev is None:
        return greedy_boundary_plain(codes_wire, aux, table, n_windows, k=k,
                                     window_size=window_size, slide=slide, L=L, lean=lean,
                                     jump=jump, min_size=min_size)
    _check(n_windows, "n_windows", torch.int32, 1, dev)
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0 or K == 0:
        # no k-mer fits a window: the signal is K in every window
        return binseg_l2(torch.full((B, W), K, dtype=torch.int32, device=dev), n_windows,
                         jump, min_size)
    wb = _cluster_windows("greedy", cluster_windows, L=L, W=W, K=K, k=k, J=J, slide=slide,
                          lean=lean)
    t = torch.empty(B, dtype=torch.int64, device=dev)
    has = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("greedy_boundary", dev,
            *_wire_args(codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L, lean=lean),
            wb, n_windows.data_ptr(), jump, min_size, t.data_ptr(), has.data_ptr())
    return t, has


# ---- step1_counts --------------------------------------------------------------

def step1_counts_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                       *, k: int, L: int, lean: bool) -> torch.Tensor:
    """step1_counts' plain torch version: unpack the wire, match, then
    ops.match.greedy_count (one carry step per position, exact for every
    table).  Runs on any device, and counts its calls by device type."""
    dev = codes_wire.device
    STEP1_PLAIN_CALLS[dev.type] = STEP1_PLAIN_CALLS.get(dev.type, 0) + 1
    R, K = codes_wire.shape[0], int(table.shape[0])
    if L < k or R == 0 or K == 0:
        return torch.zeros((R, K), dtype=torch.int32, device=dev)
    codes = unpack_wire(codes_wire, aux, L, lean=lean)
    return greedy_count(match_positions(codes, table, k), k)


def step1_counts(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                 *, k: int, L: int, lean: bool) -> torch.Tensor:
    """Step 1's greedy non-overlapping count [R, K] int32 of each table
    entry over the first L bases of each row (R = 2 ends a read), for
    every table: periodic, mixed, duplicates each counted, a -1 entry
    matching nothing, any K, k <= 15.  Wire and table as for sum_signal.
    Bit-identical to step1_counts_plain.  A row and its match planes
    must fit a block's shared memory (L up to ~150 k bases; the engine's
    rows are the 1,000 bases of a read end): a longer row raises."""
    dev = _check_greedy("step1_counts", codes_wire, aux, table, k, L, lean)
    if dev is None:
        return step1_counts_plain(codes_wire, aux, table, k=k, L=L, lean=lean)
    R, K = codes_wire.shape[0], int(table.shape[0])
    if L < k or R == 0 or K == 0:
        return torch.zeros((R, K), dtype=torch.int32, device=dev)
    if not geometry.step1_fits(L, k, dense=not lean):
        raise ValueError(f"step1_counts: a row of {L} bases does not fit a block's "
                         "shared memory")
    out = torch.empty((R, K), dtype=torch.int32, device=dev)
    _launch("step1_counts", dev, codes_wire.data_ptr(), codes_wire.shape[1],
            aux.data_ptr() if lean else None,
            None if lean else aux.data_ptr(), 0 if lean else aux.shape[1],
            table.data_ptr(), K, k, L, R, out.data_ptr())
    return out
