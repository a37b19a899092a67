"""Hand-written CUDA kernels and their wrappers.

`sum_signal` is the step-2 window signal of the main path
(csrc/sum_signal.cu, replacing the TPU kernel
topsicle_tpu/ops/pallas_kernels.py::_sum_signal_kernel).  The source is
compiled with nvcc into a shared library with a plain C interface at
first use, keyed on a hash of the source and flags, and loaded with
ctypes.  Nothing is built or imported from CUDA when this module is
imported.

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
import threading
from pathlib import Path

import torch

from topsicle_tpu_torch.ops.match import (MAX_ROLLING_K, boundary_sum_signal,
                                          num_windows, unpack_wire)

_PKG = Path(__file__).resolve().parent.parent
SUM_SIGNAL_SOURCE = _PKG / "csrc" / "sum_signal.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_ENTRIES = 31            # presence word bits
_TILE_WINDOWS = 256        # windows per block, before the shared-memory clamp
_SMEM_LIMIT = 232448 - 1024  # Hopper's per-block maximum, less the static table

# Launches of each kernel made by its wrapper (and only there).
LAUNCHES = {"sum_signal": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- build and load --------------------------------------------------------

_LOCK = threading.Lock()
_LIB = None


def find_nvcc() -> str:
    exe = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built from csrc/ at first use")
    return exe


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    h = hashlib.sha256(SUM_SIGNAL_SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtopsicle_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile csrc/ with nvcc unless this source's library exists.
    The compiler's report (registers, shared memory, spills) is kept
    beside the library as <name>.log.  Raises on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SUM_SIGNAL_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)     # atomic: a concurrent process never loads half a file
    return so


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.topsicle_sum_signal.argtypes = [
                p, i, p, p, i, p, i, i, i, i, i, i, i, i, i, p, p]
            lib.topsicle_sum_signal.restype = ctypes.c_int
            lib.topsicle_cuda_error_string.argtypes = [ctypes.c_int]
            lib.topsicle_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


# ---- sum_signal ------------------------------------------------------------

def tile_geometry(k: int, slide: int, J: int, W: int):
    """(windows per block, dynamic shared-memory bytes) for the kernel:
    a tile of T windows stages P = (T-1)*slide + J positions as a uint32
    word and a uint8 total each, plus P + k - 1 base codes."""
    tile = max(1, min(_TILE_WINDOWS, W))
    while True:
        pos = (tile - 1) * slide + J
        smem = 6 * pos + k - 1
        if smem <= _SMEM_LIMIT:
            return tile, smem
        if tile == 1:
            raise ValueError(
                f"window_size {J + k} needs {smem} bytes of shared memory per "
                f"window, more than a Hopper block holds ({_SMEM_LIMIT})")
        tile //= 2


def sum_signal_plain(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
                     *, k: int, window_size: int, slide: int, L: int,
                     lean: bool) -> torch.Tensor:
    """The kernel's plain torch version: unpack the wire, then
    ops.match.boundary_sum_signal.  Runs on any device."""
    codes = unpack_wire(codes_wire, aux, L, lean=lean)
    return boundary_sum_signal(codes, table, k, window_size, slide,
                               num_windows(L, window_size, slide))


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sum_signal(codes_wire: torch.Tensor, aux: torch.Tensor, table: torch.Tensor,
               *, k: int, window_size: int, slide: int, L: int,
               lean: bool) -> torch.Tensor:
    """Step-2 window signal y_int [B, W] int32 from the plain wire.

    codes_wire: [B, >= L/4] uint8 packed bases (io.batch.pack_codes or
                pack_batch: base 4q+s at bits 2s of byte q)
    aux:        lean: [B] int32 valid lengths; dense: [B, >= L/8] uint8
                invalid bit-plane (bit s of byte q marks position 8q+s)
    table:      [K] int32 base-4 rolling codes (-1 never matches)
    Bit-identical to sum_signal_plain.  K <= 31 and k <= 15."""
    K = int(table.shape[0])
    if K > MAX_ENTRIES:
        raise ValueError(f"sum_signal holds at most {MAX_ENTRIES} table entries, got {K}")
    if k > MAX_ROLLING_K:
        raise ValueError(f"sum_signal takes k <= {MAX_ROLLING_K}, got {k}")
    if codes_wire.device.type == "cpu":
        return sum_signal_plain(codes_wire, aux, table, k=k, window_size=window_size,
                                slide=slide, L=L, lean=lean)
    if codes_wire.device.type != "cuda":
        raise ValueError(f"sum_signal runs on cuda or cpu tensors, got {codes_wire.device}")
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
    J = window_size - k
    W = num_windows(L, window_size, slide)
    if J <= 0 or W == 0 or B == 0:
        return torch.zeros((B, W), dtype=torch.int32, device=dev)
    tile, smem = tile_geometry(k, slide, J, W)
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.topsicle_sum_signal(
            codes_wire.data_ptr(), codes_wire.shape[1],
            aux.data_ptr() if lean else None,
            None if lean else aux.data_ptr(), 0 if lean else aux.shape[1],
            table.data_ptr(), K, k, slide, J, L, W, B, tile, smem,
            out.data_ptr(), stream)
    if rc != 0:
        msg = lib.topsicle_cuda_error_string(rc).decode()
        raise RuntimeError(f"sum_signal kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["sum_signal"] += 1
    return out
