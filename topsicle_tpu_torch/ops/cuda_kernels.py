"""Hand-written CUDA kernels and their wrappers.

  sum_signal     csrc/sum_signal.cu     the step-2 window signal for
                 aperiodic tables (replaces the TPU kernel
                 topsicle_tpu/ops/pallas_kernels.py::_sum_signal_kernel)
  greedy_signal  csrc/greedy_signal.cu  the step-2 window signal for every
                 table (replaces pallas_kernels.py::_signal_kernel)
  greedy_counts  csrc/greedy_signal.cu  the same kernel without the floor:
                 [B, K, W] per-entry counts for rawcounts, and step 1's
                 greedy count with one window over every offset

Every csrc/*.cu is compiled with nvcc (one process per source, started
together, then one link) into a single shared library with a plain C
interface at first use, keyed on a hash of all the sources and flags,
and loaded with ctypes.  Nothing is built or imported from CUDA when this
module is imported.

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

from topsicle_tpu_torch.ops.match import (MAX_ROLLING_K, boundary_sum_signal,
                                          match_positions, num_windows,
                                          unpack_wire, window_counts,
                                          window_signal)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

MAX_ENTRIES = 31            # sum_signal's presence word bits
_TILE_WINDOWS = 256        # windows per block, before the shared-memory clamp
_SMEM_LIMIT = 232448 - 1024  # Hopper's per-block maximum, less the static table

# Launches of each kernel made by its wrapper (and only there).
LAUNCHES = {"sum_signal": 0, "greedy_signal": 0, "greedy_counts": 0}


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


def library_path() -> Path:
    """Where the built library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in sources():
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
            p, i = ctypes.c_void_p, ctypes.c_int
            for fn in ("topsicle_sum_signal", "topsicle_greedy_signal",
                       "topsicle_greedy_counts"):
                getattr(lib, fn).argtypes = [p, i, p, p, i, p, i, i, i, i, i, i, i, i, i, p, p]
                getattr(lib, fn).restype = ctypes.c_int
            lib.topsicle_cuda_error_string.argtypes = [ctypes.c_int]
            lib.topsicle_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


# ---- sum_signal ------------------------------------------------------------

def tile_geometry(k: int, slide: int, J: int, W: int, *, pos_bytes: int = 6,
                  win_bytes: int = 0):
    """(windows per block, dynamic shared-memory bytes) for a kernel whose
    tile of T windows stages P = (T-1)*slide + J positions at `pos_bytes`
    each, T windows at `win_bytes` each, and k - 1 more base codes.
    sum_signal: a uint32 word, a uint8 total and a base per position.
    greedy: an int32 rolling code and a base per position, an int32 sum
    per window."""
    tile = max(1, min(_TILE_WINDOWS, W))
    while True:
        pos = (tile - 1) * slide + J
        smem = pos_bytes * pos + win_bytes * tile + k - 1
        if smem <= _SMEM_LIMIT:
            return tile, smem
        if tile == 1:
            raise ValueError(
                f"{J} offsets per window need {smem} bytes of shared memory, "
                f"more than a Hopper block holds ({_SMEM_LIMIT})")
        tile //= 2


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
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit (65535)")
    return dev


def _launch(name: str, out: torch.Tensor, codes_wire: torch.Tensor, aux: torch.Tensor,
            table: torch.Tensor, *, k: int, slide: int, J: int, W: int, L: int,
            lean: bool, tile: int, smem: int) -> torch.Tensor:
    """Launch topsicle_<name> on the current stream into `out`; raises
    on a non-zero launch code, counts the launch otherwise."""
    lib = load_library()
    dev = codes_wire.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"topsicle_{name}")(
            codes_wire.data_ptr(), codes_wire.shape[1],
            aux.data_ptr() if lean else None,
            None if lean else aux.data_ptr(), 0 if lean else aux.shape[1],
            table.data_ptr(), int(table.shape[0]), k, slide, J, L, W,
            codes_wire.shape[0], tile, smem, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.topsicle_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1
    return out


# ---- sum_signal ------------------------------------------------------------

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
               lean: bool) -> torch.Tensor:
    """Step-2 window signal y_int [B, W] int32 from the plain wire.

    codes_wire: [B, >= L/4] uint8 packed bases (io.batch.pack_codes or
                pack_batch: base 4q+s at bits 2s of byte q)
    aux:        lean: [B] int32 valid lengths; dense: [B, >= L/8] uint8
                invalid bit-plane (bit s of byte q marks position 8q+s)
    table:      [K] int32 base-4 rolling codes (-1 never matches)
    Bit-identical to sum_signal_plain.  K <= 31 and k <= 15; equal to
    greedy_signal only for aperiodic tables (the model checks)."""
    K = int(table.shape[0])
    if K > MAX_ENTRIES:
        raise ValueError(f"sum_signal holds at most {MAX_ENTRIES} table entries, got {K}")
    if k > MAX_ROLLING_K:
        raise ValueError(f"sum_signal takes k <= {MAX_ROLLING_K}, got {k}")
    if codes_wire.device.type == "cpu":
        return sum_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                                slide=slide, L=L, lean=lean)
    dev = _check_wire("sum_signal", codes_wire, aux, table, L, lean)
    B = codes_wire.shape[0]
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0:
        return torch.zeros((B, W), dtype=torch.int32, device=dev)
    tile, smem = tile_geometry(k, slide, J, W)
    return _launch("sum_signal", torch.empty((B, W), dtype=torch.int32, device=dev),
                   codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L,
                   lean=lean, tile=tile, smem=smem)


# ---- greedy_signal and greedy_counts ---------------------------------------

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


def greedy_counts(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                  *, k: int, J: int, W: int, slide: int, L: int,
                  lean: bool) -> torch.Tensor:
    """Greedy non-overlapping counts [B, K, W] int32, no floor: window w
    reads offsets w*slide + j, j < J, of the first L bases (offsets
    past them never match).  Step 2's rawcounts take
    J = window_size - k and W = num_windows(L, window_size, slide);
    step 1 takes one window over every offset, J = L - k + 1, W = 1.
    Wire and table as for sum_signal; any K, duplicates each counted,
    k <= 15.  Bit-identical to greedy_counts_plain."""
    if k > MAX_ROLLING_K:
        raise ValueError(f"greedy_counts takes k <= {MAX_ROLLING_K}, got {k}")
    if codes_wire.device.type == "cpu":
        return greedy_counts_plain(codes_wire, aux, table, k=k, J=J, W=W, slide=slide,
                                   L=L, lean=lean)
    dev = _check_wire("greedy_counts", codes_wire, aux, table, L, lean)
    B, K = codes_wire.shape[0], int(table.shape[0])
    W = max(W, 0)
    if J <= 0 or W == 0 or B == 0 or K == 0:
        return torch.zeros((B, K, W), dtype=torch.int32, device=dev)
    tile, smem = tile_geometry(k, slide, J, W, pos_bytes=5, win_bytes=4)
    return _launch("greedy_counts", torch.empty((B, K, W), dtype=torch.int32, device=dev),
                   codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L,
                   lean=lean, tile=tile, smem=smem)


def greedy_signal(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                  *, k: int, window_size: int, slide: int, L: int,
                  lean: bool) -> torch.Tensor:
    """Step-2 window signal y_int [B, W] int32 = sum over the table of
    max(greedy count, 1), exact for every table (periodic, mixed,
    duplicates, any K; k <= 15).  Arguments as for sum_signal.
    Bit-identical to greedy_signal_plain."""
    if k > MAX_ROLLING_K:
        raise ValueError(f"greedy_signal takes k <= {MAX_ROLLING_K}, got {k}")
    if codes_wire.device.type == "cpu":
        return greedy_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                                   slide=slide, L=L, lean=lean)
    dev = _check_wire("greedy_signal", codes_wire, aux, table, L, lean)
    B, K = codes_wire.shape[0], int(table.shape[0])
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0 or K == 0:
        return torch.full((B, W), K, dtype=torch.int32, device=dev)
    tile, smem = tile_geometry(k, slide, J, W, pos_bytes=5, win_bytes=4)
    return _launch("greedy_signal", torch.empty((B, W), dtype=torch.int32, device=dev),
                   codes_wire, aux, table, k=k, slide=slide, J=J, W=W, L=L,
                   lean=lean, tile=tile, smem=smem)
