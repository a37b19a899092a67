"""ctypes bindings for the native host IO library (native/tsio.cc, inside the package).

The library is compiled on demand with the system toolchain (g++ + zlib)
and cached in the compile cache (utils/compile_cache.py: TOPSICLE_COMPILE_CACHE,
else the package's _build/); when the toolchain or zlib is missing, or the
cache cannot be written, callers fall back to the pure-Python reader and the
run log's `reader:` line says why (pipeline honors TopsicleConfig.native_io)."""

from topsicle_tpu_torch.native.loader import (  # noqa: F401
    Block,
    NativeReader,
    native_available,
    status,
    write_subset_native,
)
