"""The step-2 sum-signal kernel's wrapper and plain version
(topsicle_tpu_torch.ops.cuda_kernels) vs the JAX boundary_sum_signal and
the Pallas kernel it replaces (step2_sum_signal_pallas(_lean), run in
interpret mode on its phase-planar wire, as tests/test_pallas.py runs it).

On the CPU the wrapper takes the plain version; the CUDA kernel itself
is compiled and compared only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  Integer outputs: exact equality."""

import os
import re
import stat

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsicle_tpu import ops as jops
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import pack_kmer_table, telophrase_kmers
from topsicle_tpu.ops.pallas_kernels import (step2_sum_signal_pallas,
                                             step2_sum_signal_pallas_lean)
from topsicle_tpu_torch.ops import cuda_kernels


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(seed, B, L, lean):
    """[B, L] tails with ragged suffix padding; dense batches also carry
    ~5% invalid bases inside the reads."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 4, L + 1, B).astype(np.int32)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    if not lean:
        codes[rng.random((B, L)) < 0.05] = 4
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


def _wire(codes, lens, lean):
    if lean:
        return batching.pack_codes(codes), lens
    return batching.pack_batch(codes)


def _port(codes, lens, table, k, w, slide, lean):
    a, b = _wire(codes, lens, lean)
    return cuda_kernels.sum_signal(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(table),
        k=k, window_size=w, slide=slide, L=a.shape[1] * 4, lean=lean).numpy()


def _jax_xla(codes, table, k, w, slide):
    p, m = batching.pack_batch(codes)
    L = p.shape[1] * 4
    c = jops.unpack_codes(jnp.asarray(p), jnp.asarray(m), L)
    return np.asarray(jops.boundary_sum_signal(c, jnp.asarray(table), k, w, slide,
                                               (L - w) // slide + 1))


def _pallas(codes, lens, table, k, w, slide, lean):
    L = codes.shape[1]
    kw = dict(k=k, K=len(table), window_size=w, slide=slide, L=L, interpret=True)
    if lean:
        p = batching.pack_tails_phase_planar_lean(codes, k, w, slide)
        return np.asarray(step2_sum_signal_pallas_lean(
            jnp.asarray(p), jnp.asarray(lens.reshape(-1, 1)), jnp.asarray(table), **kw))
    p, m = batching.pack_tails_phase_planar(codes, k, w, slide)
    return np.asarray(step2_sum_signal_pallas(jnp.asarray(p), jnp.asarray(m),
                                              jnp.asarray(table), **kw))


@pytest.mark.parametrize("seed,L,lean", [(0, 2048, True), (1, 2048, False),
                                         (2, 4096, True), (3, 4096, False)])
def test_sum_signal_matches_jax_and_pallas(seed, L, lean):
    """The demo geometry (k=5, w=100, slide 6, CCCTAAA), ragged lengths,
    both wires: the port == XLA boundary_sum_signal == the Pallas kernel."""
    codes, lens = _batch(seed, 8, L, lean)
    table = pack_kmer_table(telophrase_kmers("CCCTAAA", 5))
    got = _port(codes, lens, table, 5, 100, 6, lean)
    assert got.dtype == np.int32 and got.shape == (8, (L - 100) // 6 + 1)
    np.testing.assert_array_equal(got, _jax_xla(codes, table, 5, 100, 6))
    np.testing.assert_array_equal(got, _pallas(codes, lens, table, 5, 100, 6, lean))


@pytest.mark.parametrize("k,w,slide", [
    (4, 64, 3),     # small window, slide < k
    (5, 100, 1),    # slide = 1
    (6, 80, 7),     # slide > k
    (7, 120, 7),    # k = 7
])
def test_sum_signal_geometry_sweep(k, w, slide):
    """tests/test_pallas.py's geometry sweep: random distinct k-mer
    tables on dirty batches."""
    rng = np.random.default_rng(k * 100 + slide)
    codes, lens = _batch(k * 100 + slide, 8, 1536, lean=False)
    kmers = set()
    while len(kmers) < 10:
        kmers.add("".join(rng.choice(list("ACGT"), k)))
    table = pack_kmer_table(sorted(kmers))
    got = _port(codes, lens, table, k, w, slide, False)
    np.testing.assert_array_equal(got, _jax_xla(codes, table, k, w, slide))
    np.testing.assert_array_equal(got, _pallas(codes, lens, table, k, w, slide, False))


def test_sum_signal_k31_table():
    """K = 31, the presence word's limit: entries taken from the reads so
    most of them match somewhere."""
    codes, lens = _batch(31, 8, 2048, lean=False)
    k = 7
    clean = codes[0, :lens[0]]
    kmers = []
    for p in range(0, len(clean) - k, 13):
        km = clean[p:p + k]
        if (km < 4).all() and km.tobytes() not in kmers:
            kmers.append(km.tobytes())
    table = np.array([sum(int(c) << (2 * j) for j, c in enumerate(km))
                      for km in kmers[:31]], np.int32)
    assert len(table) == 31
    got = _port(codes, lens, table, k, 100, 6, False)
    np.testing.assert_array_equal(got, _jax_xla(codes, table, k, 100, 6))
    np.testing.assert_array_equal(got, _pallas(codes, lens, table, k, 100, 6, False))


@pytest.mark.parametrize("kmers", [
    telophrase_kmers("ATAT", 2),        # {AT, TA} twice: duplicate entries
    telophrase_kmers("CCCTAAA", 14),    # k = 14 and k = 15: past the Pallas
    telophrase_kmers("CCCTAAAC", 15),   # kernel's k <= 13 envelope
])
def test_sum_signal_beyond_pallas_envelope(kmers):
    """Duplicate entries each count, and k runs to 15 (base-4 codes with
    a separate invalid flag): the port's envelope is the XLA path's."""
    k = len(kmers[0])
    codes, lens = _batch(k, 4, 1024, lean=True)
    codes[:, :200] = np.resize(np.array(["ACGT".index(c) for c in kmers[0]], np.uint8), 200)
    table = pack_kmer_table(kmers)
    got = _port(codes, lens, table, k, 40, 3, True)
    np.testing.assert_array_equal(got, _jax_xla(codes, table, k, 40, 3))
    assert (got > len(kmers)).any()          # some window holds matches


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    codes, lens = _batch(9, 4, 1024, lean=True)
    table = pack_kmer_table(telophrase_kmers("CCCTAAA", 5))
    a, b = _wire(codes, lens, True)
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(table))
    kw = dict(k=5, window_size=100, slide=6, L=1024, lean=True)
    ckw = dict(k=5, J=95, W=(1024 - 100) // 6 + 1, slide=6, L=1024, lean=True)
    before = dict(cuda_kernels.LAUNCHES)
    y = cuda_kernels.sum_signal(*args, **kw)
    assert torch.equal(y, cuda_kernels.sum_signal_plain(*args, **kw))
    assert torch.equal(cuda_kernels.greedy_signal(*args, **kw),
                       cuda_kernels.greedy_signal_plain(*args, **kw))
    assert torch.equal(cuda_kernels.greedy_counts(*args, **ckw),
                       cuda_kernels.greedy_counts_plain(*args, **ckw))
    assert cuda_kernels.LAUNCHES == before
    cuda_kernels.reset_launch_counts()
    assert cuda_kernels.LAUNCHES == {"sum_boundary": 0, "sum_signal": 0, "binseg_l2": 0,
                                     "greedy_boundary": 0, "greedy_signal": 0,
                                     "greedy_counts": 0, "step1_counts": 0}


def test_sum_signal_envelope_raises():
    wire = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.full((2,), 256, dtype=torch.int32)
    with pytest.raises(ValueError, match="31"):
        cuda_kernels.sum_signal(wire, lens, torch.zeros(32, dtype=torch.int32),
                                k=5, window_size=100, slide=6, L=256, lean=True)
    with pytest.raises(ValueError, match="15"):
        cuda_kernels.sum_signal(wire, lens, torch.zeros(4, dtype=torch.int32),
                                k=16, window_size=100, slide=6, L=256, lean=True)


@pytest.mark.parametrize("name", sorted(cuda_kernels.ENTRY_ARGS))
def test_entry_args_match_the_c_signatures(name):
    """Every kernel sizes its own shared memory in its launcher, so what
    the wrappers hand over is the C signature alone: the ctypes
    declaration of each entry has a pointer where the extern "C" function
    in csrc/ takes a pointer and an int where it takes an int, in order,
    and every entry counts its launches."""
    text = "".join(src.read_text() for src in cuda_kernels.sources())
    found = re.findall(r'extern "C" int topsicle_%s\(([^)]*)\)' % name, text)
    assert len(found) == 1, f"topsicle_{name} is defined {len(found)} times in csrc/"
    params = [" ".join(a.split()) for a in found[0].split(",")]
    kinds = "".join("p" if "*" in a else "i" for a in params)
    assert all(a.startswith(("const void*", "void*", "int ")) for a in params), params
    assert kinds == cuda_kernels.ENTRY_ARGS[name]
    assert params[-1] == "void* stream" and name in cuda_kernels.LAUNCHES


def test_every_header_is_included_and_hashed():
    """The sources that read the wire share csrc/wire.cuh, and the fused
    entries csrc/binseg.cuh; both are part of the library's name."""
    heads = [h.name for h in cuda_kernels.headers()]
    assert heads == ["binseg.cuh", "wire.cuh"]
    includes = {src.name: set(re.findall(r'#include "(\w+\.cuh)"', src.read_text()))
                for src in cuda_kernels.sources()}
    assert includes == {"binseg.cu": {"binseg.cuh"},
                        "greedy_signal.cu": {"binseg.cuh", "wire.cuh"},
                        "step1_counts.cu": {"wire.cuh"},
                        "sum_signal.cu": {"binseg.cuh", "wire.cuh"}}


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error surfaces as RuntimeError with its output; no
    half-written library is left behind."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: simulated' >&2\nexit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(nvcc.parent) + os.pathsep + os.environ["PATH"])
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_kernels.build_library()
    assert not list((tmp_path / "build").glob("*.so*"))
    assert cuda_kernels.library_path().parent == tmp_path / "build"


def test_library_path_covers_every_source(tmp_path, monkeypatch):
    """Editing any csrc/*.cu, not only the first, names a new library,
    so a stale one is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(cuda_kernels, "CSRC", csrc)
    first = cuda_kernels.library_path()
    (csrc / "b.cu").write_text("// b, edited\n")
    assert cuda_kernels.library_path() != first
    assert [p.name for p in cuda_kernels.sources()] == ["a.cu", "b.cu"]


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """A csrc/*.cuh is compiled into the sources that include it, so its
    edit names a new library too; it is not itself a compile unit."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// h\n")
    monkeypatch.setattr(cuda_kernels, "CSRC", csrc)
    first = cuda_kernels.library_path()
    (csrc / "h.cuh").write_text("// h, edited\n")
    assert cuda_kernels.library_path() != first
    assert [p.name for p in cuda_kernels.sources()] == ["a.cu"]
    assert [p.name for p in cuda_kernels.headers()] == ["h.cuh"]


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc -c per source, then one link into the library; the
    compilers' output lands in the log beside it, the objects do not
    stay."""
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {calls}\necho "ptxas info: $#"\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(nvcc.parent) + os.pathsep + os.environ["PATH"])
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path / "build")
    so = cuda_kernels.build_library()
    assert so.exists() and so.parent == tmp_path / "build"
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    assert sorted(ln.split()[-1] for ln in compiles) == \
        sorted(str(p) for p in cuda_kernels.sources())
    assert len(cuda_kernels.sources()) == 4 and len(lines) == 5
    assert "-shared" in lines[-1]
    assert sum(tok.endswith(".o") for tok in lines[-1].split()) == 4
    assert so.with_suffix(".log").read_text().count("ptxas info") == 5
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [so.with_suffix(".log").name,
                                                                       so.name]
    assert cuda_kernels.build_library() == so and len(calls.read_text().splitlines()) == 5


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_kernels.find_nvcc()
