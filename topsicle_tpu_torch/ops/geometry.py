"""The geometry of a step-2 launch: which route it takes and, on the
window-block grid, what each block stages.

Counterpart of topsicle_tpu/ops/pallas_kernels.py::phase_plane_geometry
and the grid of ::_signal_pallas_call (`grid=(B // R, nWB)`, window blocks
with a halo), without the phase-planar wire, which only the TPU needed.

A block of the CUDA signal kernels keeps what it reads in shared memory,
at most 227 KB.  Four routes follow, in the order the picker tries them:

  fused   one block a read, the changepoint in the same block
          (sum_boundary, greedy_boundary): the read's rows, its tables
          and y [W] (at csrc/binseg.cuh's tile_slot positions) must fit a
          block
  cluster the same entries on a thread-block cluster of C = 2 .. 8 blocks
          a read (the smallest C whose blocks fit), each block a window
          block of `block_windows` = ceil(W / C) windows with its bases,
          its tables and its slice of y; the changepoint runs across the
          cluster through distributed shared memory, so y still never
          leaves the chip.  Taken only in place of `read`: a read that
          needs the grid gets more blocks from it than 8
  read    one block a read writes y [B, W] (or counts [B, K, W]) to
          device memory (sum_signal, greedy_signal, greedy_counts), and
          binseg_l2 follows: the rows and tables must fit
  grid    blocks (read, window block) of `block_windows` windows, each
          staging only the bases its windows read; shared memory is
          constant in the read's length, so every length fits

`sum_plan`, `greedy_plan` and `step1_fits` mirror the launchers of
csrc/sum_signal.cu, csrc/greedy_signal.cu and csrc/step1_counts.cu byte
for byte (the launchers stay the truth: tests on the card sweep
geometries and hold each plan against topsicle_sum_plan and
topsicle_greedy_plan of the built library).  The model picks the route
before it launches, so a launcher never has to refuse; where the sum body
cannot hold even one window it takes the greedy body.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

SMEM_LIMIT = 232448 - 2048      # a block's maximum, less the kernels' static part
STEP1_SMEM_LIMIT = 232448 - 1024
STAGE_ALIGN = 128               # bases: 32 bytes of wire, 16 of invalid plane
MAX_GRID_Y = 65535              # blocks a read: a launch's second grid axis
MAX_CLUSTER = 8                 # blocks a read on the cluster route: the portable cluster size
LUT_MAX_K = 7                   # the sum body's 4^k-word presence table: 64 KB at k = 7
GROUP_ARRAYS = 6                # the sum body's arrays of a word a group
GREEDY_UNROLL = 8               # entries of -1 behind the greedy body's table

# Windows a block serves on the grid.  The sum body keeps 24 bytes a window
# (six group arrays), the greedy body K * slide / 8 (its match planes): at
# 2,048 windows that is 48 KB and, for 14 entries at slide 6, 22 KB, so two
# to four blocks share an SM's 227 KB and a read of a megabase at slide 6
# gives 85 blocks to the card's 132 SMs.  The halo a block stages twice
# (window_size - 1 bases) is 5% of its bases at slide 1 / window 100 and
# under 1% at slide 6.  Where a block of this many windows does not fit
# (a large slide or window), the picker halves it until it does.
BLOCK_WINDOWS = 2048


def round16(x: int) -> int:
    return (x + 15) & ~15


def wire_row_bytes(L: int) -> int:
    """Shared-memory bytes of a staged wire row of L bases, padded so that a
    position may read the word holding its first bit and the next one."""
    return round16((L + 3) // 4 + 8)


def invalid_row_bytes(L: int) -> int:
    return round16((L + 7) // 8 + 8)


def slice_bytes(W: int) -> int:
    """Shared-memory bytes of a fused entry's y over W windows at
    csrc/binseg.cuh's tile_slot positions (a word of padding every 32)."""
    return round16(4 * (W + (W >> 5)))


# ---- the window-block grid ------------------------------------------------------

def block_span(L: int, W: int, WB: int, window_size: int, slide: int) -> int:
    """Bases a block of WB windows stages at most: the whole row with one
    block a read, else the worst misalignment of its first window, its
    windows' starts and the halo (a window reads window_size - 1 bases)."""
    if WB >= W:
        return L
    return min(L, STAGE_ALIGN - 1 + (WB - 1) * slide + window_size - 1)


class WindowBlock(NamedTuple):
    w0: int          # the block's first window
    n_win: int       # its windows: WB, fewer in a read's last block
    pa: int          # the first staged base, a multiple of STAGE_ALIGN
    off: int         # window w0's first base, counted from pa
    n_bases: int     # staged bases
    halo: int        # bases past the last window's start that the block reads
    wire_bytes: range       # bytes of the read's wire row the block stages
    invalid_bytes: range    # bytes of its invalid-plane row (dense wire)


def window_block(wb: int, WB: int, W: int, L: int, window_size: int,
                 slide: int) -> WindowBlock:
    """What block `wb` of a read of L bases and W windows stages
    (csrc/wire.cuh::window_block).  Windows w0 .. w0 + n_win - 1 read bases
    w0 * slide through (w0 + n_win - 1) * slide + window_size - 2; the
    staged range starts at the multiple of STAGE_ALIGN below, so that both
    rows start on a 16-byte boundary, and ends with the span or the row."""
    span = block_span(L, W, WB, window_size, slide)
    w0 = wb * WB
    n_win = min(WB, W - w0)
    first = w0 * slide
    pa = min(first & ~(STAGE_ALIGN - 1), L & ~(STAGE_ALIGN - 1))
    n_bases = min(L - pa, span)
    return WindowBlock(w0, n_win, pa, first - pa, n_bases, window_size - 1,
                       range(pa // 4, pa // 4 + (n_bases + 3) // 4),
                       range(pa // 8, pa // 8 + (n_bases + 7) // 8))


# ---- the launchers' plans ---------------------------------------------------------

class SumPlan(NamedTuple):
    smem_bytes: int
    block_windows: int      # windows a block serves (W with one block a read)
    n_blocks: int
    tile_windows: int       # windows a block holds at a time
    use_lut: bool


def _sum_layout_total(L: int, W: int, k: int, Q: int, dense: bool, use_lut: bool,
                      tile_w: int, boundary: bool) -> int:
    total = wire_row_bytes(L) + (invalid_row_bytes(L) if dense else 0)
    total += slice_bytes(W) if boundary else 0
    total += GROUP_ARRAYS * round16(4 * (tile_w + Q))
    return total + ((4 << (2 * k)) if use_lut else 0)


def _sum_tile_windows(L: int, W: int, k: int, Q: int, dense: bool, use_lut: bool,
                      boundary: bool) -> int:
    if _sum_layout_total(L, W, k, Q, dense, use_lut, W, boundary) <= SMEM_LIMIT:
        return W
    fixed = _sum_layout_total(L, W, k, Q, dense, use_lut, 0, boundary)
    room = SMEM_LIMIT - fixed - 16 * GROUP_ARRAYS
    return (room // (4 * GROUP_ARRAYS)) & ~3 if room > 0 else 0


def sum_plan(L: int, W: int, k: int, J: int, slide: int, dense: bool, boundary: bool,
             block_windows: int = 0) -> Optional[SumPlan]:
    """csrc/sum_signal.cu::plan: what a launch with `block_windows` windows a
    block (0: one block a read) is made of, or None where it does not fit.
    A fused launch (`boundary`) takes at most MAX_CLUSTER blocks a read."""
    WB = block_windows if 0 < block_windows < W else W
    n_blocks = -(-W // WB)
    if n_blocks > MAX_GRID_Y or (boundary and n_blocks > MAX_CLUSTER):
        return None
    span = block_span(L, W, WB, J + k, slide)
    Q = J // slide
    use_lut = k <= LUT_MAX_K
    tile_w = _sum_tile_windows(span, WB, k, Q, dense, True, boundary) if use_lut else 0
    if tile_w < WB and tile_w < 1024:
        use_lut = False
        tile_w = _sum_tile_windows(span, WB, k, Q, dense, False, boundary)
    if tile_w < 1:
        return None
    smem = _sum_layout_total(span, WB, k, Q, dense, use_lut, tile_w, boundary)
    return SumPlan(smem, WB, n_blocks, tile_w, use_lut) if smem <= SMEM_LIMIT else None


class GreedyPlan(NamedTuple):
    smem_bytes: int
    block_windows: int
    n_blocks: int
    group_entries: int      # entries whose planes a block holds at a time
    plane_words: int


def greedy_plan(L: int, W: int, K: int, k: int, J: int, slide: int, dense: bool,
                boundary: bool, block_windows: int = 0) -> Optional[GreedyPlan]:
    """csrc/greedy_signal.cu::plan, as sum_plan."""
    WB = block_windows if 0 < block_windows < W else W
    n_blocks = -(-W // WB)
    if n_blocks > MAX_GRID_Y or (boundary and n_blocks > MAX_CLUSTER):
        return None
    span = block_span(L, W, WB, J + k, slide)
    first_max = STAGE_ALIGN - 1 if n_blocks > 1 else 0
    pw = (((first_max + (WB - 1) * slide) >> 5) + ((J + 31) >> 5) + 1) | 1
    fixed = wire_row_bytes(span) + (invalid_row_bytes(span) if dense else 0)
    fixed += round16(4 * (K + GREEDY_UNROLL)) + round16(K)
    fixed += slice_bytes(WB) if boundary else 0
    if fixed + 4 * pw > SMEM_LIMIT:
        return None
    fit = (SMEM_LIMIT - fixed) // (4 * pw)
    n_groups = -(-K // fit)
    Kg = -(-K // n_groups)
    return GreedyPlan(fixed + 4 * pw * Kg, WB, n_blocks, Kg, pw)


def step1_fits(L: int, k: int, dense: bool) -> bool:
    """csrc/step1_counts.cu's launcher: a row of L bases and its 32 match
    planes fit a block.  The engine's rows are no_bp = 1000 bases."""
    pw = ((L - k + 1 + 31) >> 5) | 1
    rows = wire_row_bytes(L) + (invalid_row_bytes(L) if dense else 0)
    return rows + 32 * 4 * pw <= STEP1_SMEM_LIMIT


# ---- the picker ----------------------------------------------------------------------

class Route(NamedTuple):
    """`kind`: "fused", "cluster", "read" or "grid"; `block_windows`: the
    windows a block serves on the cluster and the grid, 0 on the other
    routes."""
    kind: str
    block_windows: int = 0

    @property
    def fused(self) -> bool:
        """The changepoint runs in the signal's launch (one block a read or
        a cluster)."""
        return self.kind in ("fused", "cluster")

    def blocks(self, W: int) -> int:
        """Blocks a read of W windows takes: C on the cluster route."""
        return -(-W // self.block_windows) if self.block_windows else 1


def _plan(entry: str, L: int, W: int, K: int, k: int, J: int, slide: int, dense: bool,
          boundary: bool, block_windows: int = 0):
    if entry == "sum":
        return sum_plan(L, W, k, J, slide, dense, boundary, block_windows)
    return greedy_plan(L, W, K, k, J, slide, dense, boundary, block_windows)


def find_route(entry: str, *, L: int, W: int, K: int, k: int, window_size: int, slide: int,
               dense: bool, fused: bool = True) -> Optional[Route]:
    """The route of a launch of `entry` ("sum", "greedy", or "counts" for
    greedy_counts) on reads of L bases and W windows: fused where the
    caller allows it and one block fits; else, where one block a read fits
    without y, fused on a cluster of the fewest blocks (2 .. MAX_CLUSTER,
    ceil(W / C) windows each) that fit, or one block a read; else the
    window-block grid, at BLOCK_WINDOWS windows a block or the largest
    halving of it that fits.
    None only where one window of this body alone passes a block's shared
    memory (the sum body keeps 24 bytes a group of `slide` positions of a
    window, the greedy body a bit a position and entry: a window of some
    9,000 bases at slide 1 passes the first, one of 460,000 the second)."""
    if entry not in ("sum", "greedy", "counts"):
        raise ValueError(f"unknown entry {entry!r}")
    J = window_size - k
    args = (entry, L, W, K, k, J, slide, dense)
    if fused and entry != "counts" and _plan(*args, True) is not None:
        return Route("fused")
    if _plan(*args, False) is not None:
        if fused and entry != "counts":
            # a cluster in place of one block a read, never of the grid: on a
            # read that needs the grid its many blocks beat 8 (PERF.md)
            for C in range(2, MAX_CLUSTER + 1):
                WB = -(-W // C)
                if WB < W and _plan(*args, True, WB) is not None:
                    return Route("cluster", WB)
        return Route("read")
    WB = BLOCK_WINDOWS
    while WB >= 1:
        if WB < W and _plan(*args, False, WB) is not None:
            return Route("grid", WB)
        WB //= 2
    return None


def pick_route(entry: str, **geometry) -> Route:
    """find_route, or ValueError where it finds none."""
    route = find_route(entry, **geometry)
    if route is None:
        raise ValueError(f"{entry}: one window of {geometry['window_size']} bases at slide "
                         f"{geometry['slide']} does not fit a block's shared memory")
    return route


# ---- binseg_l2's tiles -------------------------------------------------------------

# csrc/binseg.cu cuts each row of y [B, W] into tiles of consecutive
# windows, a block of 256 threads a tile, V = tile / 256 windows a thread.
# A row of one tile is one launch; a row of several is two (the tile sums
# first).  BINSEG_TILE and BINSEG_ONE_TILE come from a sweep of V over
# {4, 8, 16} at y [128, 3,312] and [4, 174,747] (chip_smoke.py, PERF.md).
BINSEG_THREADS = 256
BINSEG_TILE = 2048              # windows a tile where a row takes several (V = 8)
BINSEG_ONE_TILE = 4096          # a row of at most this many windows is one tile
BINSEG_MAX_TILE = 8192          # csrc/binseg.cuh::kMaxTileWindows: 33 KB of shared memory


def binseg_tiles(B: int, W: int, tile_windows: int = 0) -> tuple:
    """(tile_windows, n_tiles) of a binseg_l2 launch on y [B, W]: the
    windows a tile and the tiles a row, n_tiles = ceil(W / tile_windows).
    `tile_windows` > 0 forces the tile (any count up to BINSEG_MAX_TILE
    windows, or more where W is smaller: one tile), for checks and timings;
    0 takes the plan, whose tile is a multiple of 256 windows."""
    if tile_windows < 0:
        raise ValueError(f"tile_windows must be >= 0, got {tile_windows}")
    if tile_windows == 0:
        tile_windows = BINSEG_ONE_TILE if W <= BINSEG_ONE_TILE else BINSEG_TILE
    elif min(tile_windows, W) > BINSEG_MAX_TILE:
        raise ValueError(f"binseg_l2 takes tiles of at most {BINSEG_MAX_TILE} windows, "
                         f"got {tile_windows}")
    n_tiles = max(-(-W // tile_windows), 1)
    if B * n_tiles >= 2 ** 31:
        raise ValueError(f"binseg_l2: {B} rows of {n_tiles} tiles pass a launch's grid")
    return tile_windows, n_tiles
