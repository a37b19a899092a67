"""Long scans in the port: the route picker against hand-reckoned
thresholds of the CUDA kernels' shared-memory layouts (one fused block, a
fused cluster of up to 8, one block a read, the grid), the window-block
grid's geometry against a brute-force walk of the bases each window reads
(and against the plain signal computed from a block's staged bases alone),
and one engine run at --maxlengthtelo 60000 --slide 1 against JaxEngine and
OracleEngine byte for byte.  CPU only: the kernels themselves are held to
these geometries on the card (tests/test_torch_cuda.py).  Integer device
path: tolerance 0."""

import gzip

import numpy as np
import pytest
import torch

from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.ops import pallas_kernels
from topsicle_tpu.oracle import OracleEngine
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu_torch import ops
from topsicle_tpu_torch.io import batch as batching
from topsicle_tpu_torch.kmers import pack_kmer_table, telophrase_kmers
from topsicle_tpu_torch.models import TorchScanModel
from topsicle_tpu_torch.ops import cuda_kernels, geometry
from topsicle_tpu_torch.pipeline import TorchEngine

LIMIT = 232448 - 2048       # a block's shared memory, less the kernels' static part


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _route(entry, L, slide, k=5, K=14, w=100, dense=False, fused=True):
    return geometry.pick_route(entry, L=L, W=ops.num_windows(L, w, slide), K=K, k=k,
                               window_size=w, slide=slide, dense=dense, fused=fused)


# ---- the picker against hand-reckoned thresholds -------------------------------

def test_default_geometry_stays_fused():
    """19,968 bases at slide 6 (and at slide 1, in tiles): every entry
    fused, both wires; rawcounts one block a read."""
    for slide in (6, 1):
        for dense in (False, True):
            assert _route("sum", 19968, slide, dense=dense) == ("fused", 0)
            assert _route("greedy", 19968, slide, k=7, dense=dense) == ("fused", 0)
            assert _route("counts", 19968, slide, k=7, dense=dense) == ("read", 0)
    # a kernel asked for by name never takes the fused entry
    assert _route("sum", 19968, 6, fused=False) == ("read", 0)


def test_maxlengthtelo_60000_slide_1_leaves_the_fused_route():
    """static_scan_length() of --maxlengthtelo 60000 --trimfirst 100 is
    59,904; at slide 1 that is 59,805 windows, and y [W] alone is 239,220
    bytes of a block's 230,400: no fused block, but a cluster of two blocks
    of 29,903 windows each, each with its half of y (123,360 bytes at
    tile_slot positions) beside its window block's rows, fits both bodies:
    one fused launch a batch, y never in device memory."""
    cfg = TopsicleConfig(input_dir="x", output_dir="", pattern="CCCTAAA", slide=1,
                         maxlengthtelo=60000, trimfirst=100)
    L = cfg.static_scan_length()
    assert L == 59904 and ops.num_windows(L, 100, 1) == 59805
    assert 4 * 59805 == 239220 > LIMIT
    assert geometry.slice_bytes(29903) == geometry.round16(4 * (29903 + 934)) == 123360
    for dense in (False, True):
        assert _route("sum", L, 1, dense=dense) == ("cluster", 29903)
        assert _route("greedy", L, 1, k=7, dense=dense) == ("cluster", 29903)
        assert _route("sum", L, 1, dense=dense).blocks(59805) == 2
        # asked for by name, the signal kernels still take one block a read
        assert _route("sum", L, 1, dense=dense, fused=False) == ("read", 0)
    # the same length at slide 6 is 9,968 windows: one fused block
    assert _route("sum", L, 6) == ("fused", 0) and _route("greedy", L, 6, k=7) == ("fused", 0)


@pytest.mark.parametrize("entry,k", [("sum", 5), ("greedy", 7), ("counts", 7)])
@pytest.mark.parametrize("dense", [False, True])
def test_megabase_fused_entries_stay_on_the_grid(entry, k, dense):
    """--maxlengthtelo 1000000 at slide 6: 999,936 bases, 166,640 windows.
    A fused cluster would fit (5 blocks of 33,328 windows), but a read that
    needs the grid gets 82 blocks from it: measured on the card the cluster
    was 3.7x (sum) and 25x (greedy) slower than the grid and binseg_l2, so
    the picker takes a cluster only in place of one block a read."""
    L, W = 999936, 166640
    assert ops.num_windows(L, 100, 6) == W
    assert _route(entry, L, 6, k=k, dense=dense) == ("grid", geometry.BLOCK_WINDOWS)
    assert geometry._plan(entry, L, W, 14, k, 100 - k, 6, dense, False) is None
    if entry == "sum":
        assert geometry.sum_plan(L, W, k, 100 - k, 6, dense, True, -(-W // 5)) is not None


def test_past_eight_cluster_blocks_takes_one_block_a_read():
    """A read that one block a read holds but whose y passes 8 fused blocks
    (420,000 bases at slide 1: 52,488 windows a block, y alone 216 KB)
    takes one block a read and binseg_l2; a fused plan of 9 blocks is
    refused like one past shared memory."""
    L = 420_000
    W = ops.num_windows(L, 100, 1)
    assert _route("sum", L, 1) == ("read", 0)
    assert geometry.sum_plan(L, W, 5, 95, 1, False, True, -(-W // 8)) is None
    assert geometry.sum_plan(19968, 3312, 5, 95, 6, False, True, 368) is None      # 9 blocks
    assert geometry.sum_plan(19968, 3312, 5, 95, 6, False, True, 414).n_blocks == 8
    assert geometry.sum_plan(19968, 3312, 5, 95, 6, False, False, 368).n_blocks == 9


def test_dense_wire_leaves_the_fused_route_before_the_lean_one():
    """The greedy body at L = 215,040, slide 6, K = 14, k = 7, by hand:
    W = 35,824; wire round16(53,760 + 8) = 53,776; table round16(4 * 22) =
    96; flags 16; y at tile_slot positions round16(4 * (35,824 + 1,119)) =
    147,776; one plane of 6,721 words = 26,884: 228,548 bytes, inside
    230,400.  The invalid plane adds round16(26,880 + 8) = 26,896:
    255,444, outside one block, so the dense wire takes a cluster of two
    blocks first.  Without y both fit one block a read."""
    L, W = 215040, 35824
    assert ops.num_windows(L, 100, 6) == W
    assert geometry.slice_bytes(W) == 147776
    lean = geometry.greedy_plan(L, W, 14, 7, 93, 6, False, True)
    assert lean.smem_bytes == 53776 + 96 + 16 + 147776 + 26884 == 228548 <= LIMIT
    assert (lean.plane_words, lean.group_entries) == (6721, 1)
    assert geometry.greedy_plan(L, W, 14, 7, 93, 6, True, True) is None
    assert 228548 + 26896 > LIMIT
    assert _route("greedy", L, 6, k=7) == ("fused", 0)
    assert _route("greedy", L, 6, k=7, dense=True) == ("cluster", 17912)
    assert _route("greedy", L, 6, k=7, dense=True, fused=False) == ("read", 0)
    read = geometry.greedy_plan(L, W, 14, 7, 93, 6, True, False)
    # five planes fit beside the rows; 14 entries go in three groups of five
    assert (LIMIT - (53776 + 26896 + 96 + 16)) // 26884 == 5
    assert read.smem_bytes == 53776 + 26896 + 96 + 16 + 5 * 26884 and read.group_entries == 5


def test_sum_body_k7_table_and_31_entries():
    """K = 31 entries at k = 7: the sum body's presence table is 4^7 words
    = 65,536 bytes.  At the default geometry it rides along: wire 5,008,
    y at tile_slot positions round16(4 * (3,312 + 103)) = 13,664, six group
    arrays of round16(4 * (3,312 + 15)) = 13,312, the table: 164,080
    bytes, fused.  At 59,904 / slide 1 the table still leaves a tile of
    6,144 windows (>= 1,024), unfused; one fused block is out (y alone
    passes a block), a cluster of two blocks keeps the table."""
    plan = geometry.sum_plan(19968, 3312, 7, 93, 6, False, True)
    assert plan == (5008 + 13664 + 6 * 13312 + 65536, 3312, 1, 3312, True)
    assert plan.smem_bytes == 164080
    assert _route("sum", 19968, 6, k=7, K=31) == ("fused", 0)
    long = geometry.sum_plan(59904, 59805, 7, 93, 1, False, False)
    assert long.use_lut and long.tile_windows == 6144 and long.smem_bytes <= LIMIT
    assert geometry.sum_plan(59904, 59805, 7, 93, 1, False, True) is None
    assert _route("sum", 59904, 1, k=7, K=31) == ("cluster", 29903)
    half = geometry.sum_plan(59904, 59805, 7, 93, 1, False, True, 29903)
    assert half.use_lut and half.n_blocks == 2 and half.tile_windows == 1312
    # the greedy body holds 31 planes of 1,873 words in two groups there
    assert geometry.greedy_plan(59904, 59805, 31, 7, 93, 1, False, False).group_entries == 16


@pytest.mark.parametrize("slide", [1, 6, 7])
def test_length_past_every_whole_read_layout_takes_the_grid(slide):
    """A megabase: the lean wire alone is 262,144 bytes, past a block.
    Every entry takes the grid at BLOCK_WINDOWS windows a block, whose
    shared memory does not depend on L."""
    L = 1048576
    assert geometry.wire_row_bytes(L) > LIMIT
    for entry, k in (("sum", 5), ("greedy", 7), ("counts", 7)):
        for dense in (False, True):
            assert _route(entry, L, slide, k=k, dense=dense) == \
                ("grid", geometry.BLOCK_WINDOWS)
    W = ops.num_windows(L, 100, slide)
    a = geometry.sum_plan(L, W, 5, 95, slide, True, False, geometry.BLOCK_WINDOWS)
    b = geometry.sum_plan(4 * L, ops.num_windows(4 * L, 100, slide), 5, 95, slide, True,
                          False, geometry.BLOCK_WINDOWS)
    assert a.smem_bytes == b.smem_bytes < LIMIT // 2 and a.n_blocks == -(-W // 2048)


def test_block_windows_halve_until_a_block_fits():
    """A slide of 1,000 bases: 2,048 windows span 2 Mbases, no block; the
    picker halves to the largest count that fits.  One window past a
    block is the only refusal left."""
    L = 8 * 1048576
    route = _route("greedy", L, 1000, k=7, w=2000)
    assert route.kind == "grid" and route.block_windows == 512
    W = ops.num_windows(L, 2000, 1000)
    assert geometry.greedy_plan(L, W, 14, 7, 1993, 1000, False, False, 1024) is None
    assert geometry.greedy_plan(L, W, 14, 7, 1993, 1000, False, False, 512) is not None
    with pytest.raises(ValueError, match="one window"):
        _route("sum", L, 6, w=2_000_000)
    with pytest.raises(ValueError, match="unknown entry"):
        _route("binseg", L, 6)


def test_window_past_the_sum_body_takes_the_greedy_body():
    """The sum body keeps six words a group of `slide` positions of a
    window: at slide 1 a window of 12,000 bases is 11,995 groups, 287,880
    bytes, past a block whatever the read's length, so the picker finds no
    route for it.  The greedy body keeps a bit a position and entry and
    serves it; the model takes that body (exact for every table) and says
    so.  One window past the greedy body too is the only refusal left."""
    geo = dict(L=19968, W=ops.num_windows(19968, 12000, 1), K=14, k=5, window_size=12000,
               slide=1, dense=False)
    assert 6 * 4 * 11995 == 287880 > LIMIT
    assert geometry.find_route("sum", **geo) is None
    assert geometry.find_route("greedy", **geo) == ("fused", 0)
    with pytest.raises(ValueError, match="sum: one window of 12000 bases at slide 1"):
        geometry.pick_route("sum", **geo)
    lines = []
    model = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", window_size=12000,
                           slide=1, log=lines.append)
    assert model.kernel == "sum"
    assert model.route("sum", 19968, True, fused=True) == ("greedy", ("fused", 0))
    model.device = torch.device("cuda", 0)      # the log line is a card's
    assert model.route("sum", 19968, True, fused=True) == ("greedy", ("fused", 0))
    assert model.route("sum", 19968, True, fused=False) == ("greedy", ("read", 0))
    assert "window past the sum kernel's shared memory: greedy_boundary" in lines[0]
    assert "takes greedy_signal then binseg_l2, one block a read" in lines[1]
    huge = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", window_size=700_000,
                          slide=1)
    with pytest.raises(ValueError, match="greedy: one window of 700000 bases"):
        huge.route("sum", 1 << 21, True, fused=True)


def test_model_long_window_on_the_cpu_matches_jax():
    """A window the sum body cannot hold, through both models on the CPU:
    window 3,000 at slide 1 on reads of 8,192 (t, has) bit for bit."""
    from topsicle_tpu.models import TelomereScanModel

    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, (4, 8192)).astype(np.uint8)
    codes[:, :3000] = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), 3000)
    lens = np.array([8192, 8000, 5000, 3100], np.int32)
    codes[np.arange(8192)[None, :] >= lens[:, None]] = 0xFF
    nw = batching.window_counts_for_lengths(lens, 3000, 1)
    kmers = telophrase_kmers("CCCTAAA", 5)
    tm = TorchScanModel(kmers, device="cpu", window_size=3000, slide=1)
    jm = TelomereScanModel(kmers, window_size=3000, slide=1)
    t, has = tm.step2_boundary(codes, nw, lens)
    tj, hj = jm.step2_boundary(codes, nw, lens)
    assert np.array_equal(t, np.asarray(tj)) and np.array_equal(has, np.asarray(hj))
    assert has[:3].all()


# ---- the grid's geometry against a brute-force walk --------------------------------

@pytest.mark.parametrize("L,w,slide,WB", [
    (19968, 100, 6, 2048), (19968, 100, 6, 1000), (8192, 100, 7, 333), (4096, 20, 1, 2048),
    (5000, 100, 6, 37), (1048576, 100, 6, 2048), (3003, 50, 31, 8), (2048, 100, 1, 64)])
def test_window_block_covers_what_its_windows_read(L, w, slide, WB):
    """For every block: its windows partition [0, W); the bases they read
    (window v: v*slide .. v*slide + w - 2, walked one by one) lie inside
    the staged range; the staged wire and invalid-plane bytes are those
    bases' bytes from a 16-byte boundary of the row, inside the row; the
    first window starts `off` < 128 bases in; the halo is the w - 1 bases
    a window reads from its start."""
    W = ops.num_windows(L, w, slide)
    n_blocks = -(-W // WB)
    span = geometry.block_span(L, W, WB, w, slide)
    seen = []
    for wb in range(n_blocks):
        blk = geometry.window_block(wb, WB, W, L, w, slide)
        windows = range(blk.w0, blk.w0 + blk.n_win)
        seen.extend(windows)
        bases = {p for v in (windows[0], windows[-1]) for p in range(v * slide,
                                                                     v * slide + w - 1)}
        lo, hi = min(bases), max(bases)
        assert hi < L and hi - windows[-1] * slide + 1 == blk.halo == w - 1
        assert blk.pa % geometry.STAGE_ALIGN == 0 and blk.pa <= lo < blk.pa + 128
        assert blk.off == lo - blk.pa and hi < blk.pa + blk.n_bases <= L
        assert blk.n_bases <= span
        assert blk.wire_bytes.start % 16 == 0 and blk.invalid_bytes.start % 16 == 0
        assert blk.wire_bytes.start <= lo // 4 and hi // 4 < blk.wire_bytes.stop <= (L + 3) // 4
        assert blk.invalid_bytes.start <= lo // 8 and \
            hi // 8 < blk.invalid_bytes.stop <= (L + 7) // 8
        assert len(blk.wire_bytes) <= geometry.wire_row_bytes(span) - 8
    assert seen == list(range(W))
    if n_blocks == 1:
        assert geometry.window_block(0, WB, W, L, w, slide)[:5] == (0, W, 0, 0, L)


@pytest.mark.parametrize("k,w,slide,WB,lean", [(5, 100, 6, 100, True), (5, 100, 7, 33, False),
                                               (7, 20, 1, 256, True), (7, 100, 6, 17, False)])
def test_staged_bytes_alone_give_the_blocks_windows(k, w, slide, WB, lean):
    """What a block stages is enough: the plain signal and counts computed
    from the staged bytes of the wire alone, at the block's own offset,
    equal the whole read's at the block's windows, for both bodies."""
    rng = np.random.default_rng(k + slide)
    B, L = 3, 2048
    lens = np.array([L, 900, 0], np.int32)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[:, :700] = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), 700)
    if not lean:
        codes[rng.random((B, L)) < 0.02] = 4
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    a, b = (batching.pack_codes(codes), lens) if lean else batching.pack_batch(codes)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", k)))
    W = ops.num_windows(L, w, slide)
    skw = dict(k=k, window_size=w, slide=slide, lean=lean)
    y_sum = cuda_kernels.sum_signal_plain(a, b, table, L=L, **skw)
    y_greedy = cuda_kernels.greedy_signal_plain(a, b, table, L=L, **skw)
    counts = cuda_kernels.greedy_counts_plain(a, b, table, k=k, J=w - k, W=W, slide=slide,
                                              L=L, lean=lean)
    for wb in range(-(-W // WB)):
        blk = geometry.window_block(wb, WB, W, L, w, slide)
        sa = a[:, blk.wire_bytes.start:blk.wire_bytes.stop].contiguous()
        sb = (b - blk.pa).clamp(0, blk.n_bases).to(torch.int32) if lean else \
            b[:, blk.invalid_bytes.start:blk.invalid_bytes.stop].contiguous()
        n = sa.shape[1] * 4
        staged = ops.unpack_wire(sa, sb, n, lean=lean)[:, blk.off:]
        got = ops.boundary_sum_signal(staged, table, k, w, slide, blk.n_win)
        assert torch.equal(got, y_sum[:, blk.w0:blk.w0 + blk.n_win]), wb
        c = ops.window_counts(ops.match_positions(staged, table, k), k, w - k, blk.n_win,
                              slide)
        assert torch.equal(c, counts[:, :, blk.w0:blk.w0 + blk.n_win]), wb
        assert torch.equal(ops.window_signal(c), y_greedy[:, blk.w0:blk.w0 + blk.n_win]), wb


def test_grid_is_the_tpu_launchers_window_axis():
    """The TPU launcher's grid has the same second axis: ceil(W / WB)
    window blocks with a halo (phase_plane_geometry), WB = 1,920 there and
    2,048 here; W and J agree."""
    for L, slide in ((59904, 1), (1048576, 6)):
        J, W, WB, nWB, _, _ = pallas_kernels.phase_plane_geometry(L, 5, 100, slide)
        assert (J, W) == (95, ops.num_windows(L, 100, slide)) and nWB == -(-W // WB)
        plan = geometry.sum_plan(L, W, 5, J, slide, False, False, geometry.BLOCK_WINDOWS)
        assert plan.n_blocks == -(-W // geometry.BLOCK_WINDOWS) > 1


# ---- the model and the engine ----------------------------------------------------------

def test_model_routes_before_it_launches(monkeypatch):
    """TorchScanModel asks the picker with the batch's own length and wire
    and hands the wrappers the route: one fused block; past it the fused
    entry on a cluster (the wrapper gets the cluster's windows a block)
    where one block a read would fit; past that the signal wrapper with
    the picker's block_windows, then binseg_l2; rawcounts likewise.  On the CPU nothing
    is logged (the plain versions have no cap); the log line is for a
    card."""
    calls, lines = [], []

    def spy(name):
        real = getattr(ops, name)

        def fn(*args, **kw):
            calls.append((name, kw.get("block_windows", kw.get("cluster_windows"))))
            return real(*args, **kw)
        monkeypatch.setattr(ops, name, fn)

    for name in ("sum_boundary", "sum_signal", "greedy_signal", "greedy_counts", "binseg_l2"):
        spy(name)
    monkeypatch.setattr(geometry, "BLOCK_WINDOWS", 128)
    monkeypatch.setattr(geometry, "SMEM_LIMIT", 4096)      # a toy card: 4 KB a block
    model = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", window_size=100,
                           slide=6, log=lines.append)
    rng = np.random.default_rng(3)
    for L, want in ((512, [("sum_boundary", 0)]),
                    (4096, [("sum_boundary", 334)]),
                    (65536, [("sum_signal", 128), ("binseg_l2", None)])):
        codes = rng.integers(0, 4, (2, L)).astype(np.uint8)
        codes[:, :L // 2] = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), L // 2)
        lens = np.full(2, L, np.int32)
        nw = batching.window_counts_for_lengths(lens, 100, 6)
        calls.clear()
        t, has = model.step2_boundary(codes, nw, lens)
        assert calls == want, (L, calls)
        tp, hp = cuda_kernels.sum_boundary_plain(
            torch.from_numpy(batching.pack_codes(codes)), torch.from_numpy(lens), model.table,
            torch.from_numpy(nw), k=5, window_size=100, slide=6, L=L, lean=True)
        assert np.array_equal(t, tp.numpy()) and np.array_equal(has, hp.numpy()) and has.all()
    calls.clear()
    model.rawcounts(codes, lens)
    assert calls == [("greedy_counts", 128)]
    assert lines == []
    # on a card the same routes are named once each
    monkeypatch.setattr(model, "device", torch.device("cuda", 0))
    for _ in range(2):
        assert model.route("sum", 65536, True, fused=True) == ("sum", ("grid", 128))
        assert model.route("sum", 8192, False, fused=True) == ("sum", ("cluster", 450))
        assert model.route("sum", 512, True, fused=True) == ("sum", ("fused", 0))
    assert len(lines) == 2 and all(ln.startswith("INFO: scan length ") for ln in lines)
    assert "sum_signal then binseg_l2, on the window-block grid (128 windows a block)" in lines[0]
    assert "is past one block's shared memory: sum_boundary, on a cluster of 3 blocks a read " \
        "(450 windows a block)" in lines[1] and "dense wire" in lines[1]


def test_engine_maxlengthtelo_60000_slide_1(tmp_path):
    """--maxlengthtelo 60000 --slide 1 on two reads of 61 and 66 kbp (one
    telomeric, one not; a third too short to pass): the torch engine's CSV
    and subset equal JaxEngine's and OracleEngine's.  On a card this
    geometry takes the fused entries on a cluster of two blocks a read
    (the second test above); the CPU takes the plain versions whatever the
    route."""
    rng = np.random.default_rng(60)
    data = tmp_path / "long.fastq.gz"
    alpha = np.frombuffer(b"ACGT", np.uint8)
    with gzip.open(data, "wb", compresslevel=1) as fh:
        for i, (n, telo) in enumerate(((61000, 7400), (66000, 0), (9100, 900))):
            seq = alpha[rng.integers(0, 4, n)]
            rep = np.resize(np.frombuffer(b"CCCTAAA", np.uint8), telo)
            noisy = rng.random(telo) < 0.05
            rep[noisy] = alpha[rng.integers(0, 4, int(noisy.sum()))]
            seq[:telo] = rep
            fh.write(b"@long%d\n%s\n+\n%s\n" % (i, seq.tobytes(), b"I" * n))
    kw = dict(input_dir=str(data), pattern="CCCTAAA", slide=1, maxlengthtelo=60000)
    assert TopsicleConfig(output_dir="", **kw).static_scan_length() == 59904
    res = TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), batch_size=2, **kw),
                      device="cpu").run()
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=8, **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    got = (tmp_path / "t" / "telolengths_all.csv").read_bytes()
    assert got == (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
        (tmp_path / "o" / "telolengths_all.csv").read_bytes()
    assert len(res) >= 1 and 7000 < res[0].telo_length < 7800
    subset = "long.fastq_trc_over_0.7.fastq"
    assert (tmp_path / "t" / subset).read_bytes() == (tmp_path / "j" / subset).read_bytes() == \
        (tmp_path / "o" / subset).read_bytes()
