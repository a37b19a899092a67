"""ctypes bindings for the native host IO library (native/tsio.cc, inside the package).

The library is compiled on demand with the system toolchain (g++ + zlib)
and cached under the package's _build/; when the toolchain or zlib is missing,
callers fall back to the pure-Python reader transparently
(pipeline honors TopsicleConfig.native_io)."""

from topsicle_tpu_torch.native.loader import (  # noqa: F401
    Block,
    NativeReader,
    native_available,
    write_subset_native,
)
