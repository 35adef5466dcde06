"""``x @ int8 W * scale``: the CUDA kernel ``csrc/int8_matmul.cu`` and its
plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::int8_matmul``: the
weight-only product of the --int8 config (``a8=False``) and its int8-
activation variant (``a8=True``: x quantised per token by
``quantize_rows``, int8 x int8 with int32 accumulation, then the token scale
and the channel scale). ``quant_matmul`` is the named entry for
``aha_tpu/ops/pallas/quant_matmul.py::quant_matmul``, which computes the same
function as ``a8=False`` on an unstacked weight: it launches the same kernel
and keeps a launch count of its own. A stacked weight's layer is passed as
the view ``qvalue[l]``; no index is needed. ``int8_qlinear`` is the
weight-only product with a gradient for ``x`` (training over an int8 trunk):
forward this kernel, backward ``g @ (qvalue * scale)^T`` on a transient
dequantised weight through ``torch.matmul``, as JAX's ``auto`` backend
dequantises and lets XLA differentiate its einsum
(``aha_tpu/ops/quant.py:202-203``); no gradient for the frozen weight and
scale. ``plan`` chooses the kernel's
path, token tile, ring and K splits from the shapes alone, so the CPU tests
hold it: bf16 weight-only, and int8 activations with a bf16 output, at 1 to 16
rows the decode kernel (one launch whatever M, so a row gives the same bits at
every width), from 17 rows the wgmma kernels (bf16 weight-only with K split by
the weight's shape alone up to 4,096 rows, ``row_free_splits``, so that there
too a row gives the same bits at every width); f32 weight-only from 17 rows the
wgmma kernel too, on x split into three bf16 planes (``split_bf16x3``) whose
products add into one f32 sum (``int8_matmul_x3_plain`` models it); the rest
the earlier paths.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import LAUNCHES, PATH_LAUNCHES, _build
from .quantize_rows import quantize_rows, quantize_rows_plain, split_bf16x3, split_bf16x3_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BF16X3 = 3      # x is an f32 x's three bf16 planes (AHA_BF16X3)


def int8_matmul_plain(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor,
                      a8: bool = False) -> torch.Tensor:
    """x [..., K] @ qvalue [K, N] int8, then the per-output-channel scale
    once, cast to x's dtype. ``a8=False``: f32 accumulation. ``a8=True``:
    x is quantised per row; the int8 x int8 sum is exact (taken in f64,
    where every integer below 2^53 is exact, since neither the CPU nor the
    card multiplies int32 matrices through ``matmul``), rounded to f32 once
    like an int32 accumulator would be, then times the channel scale, then
    times the row scale. The TPU kernel adds its K-block partials in f32
    instead, which is the same number while the sum stays below 2^24."""
    if not a8:
        y = torch.matmul(x.float(), qvalue.float()) * scale.reshape(-1).float()
        return y.to(x.dtype)
    *lead, K = x.shape
    xq, sx = quantize_rows_plain(x.reshape(-1, K))
    acc = torch.matmul(xq.double(), qvalue.double()).float()
    y = acc * scale.reshape(-1).float() * sx
    return y.to(x.dtype).reshape(*lead, qvalue.shape[1])


def int8_matmul_x3_plain(x: torch.Tensor, qvalue: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """What the f32-activation wgmma path computes: x split into three bf16
    planes (``split_bf16x3_plain``), each plane's product with the int8 weight
    exact term by term and summed in f32, the three added in f32, then the
    per-channel scale once; f32 out. Equal to ``int8_matmul_plain`` but for
    the order of the f32 sums."""
    *lead, K = x.shape
    planes = split_bf16x3_plain(x.reshape(-1, K)).float()
    w = qvalue.float()
    acc = planes[0] @ w + planes[1] @ w + planes[2] @ w
    y = acc * scale.reshape(-1).float()
    return y.reshape(*lead, qvalue.shape[1])


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the kernel's paths (csrc/int8_matmul.cu; int4_matmul.cu and int4_matmul_t.cu
# number theirs alike), and their names in PATH_LAUNCHES
SCALAR, VEC16, TENSOR_CORE, WGMMA, DECODE = 0, 1, 2, 3, 4
# the warp-specialised kernel of bf16 x weight-only at many rows (csrc/quant_matmul_ws.cu,
# shared with int4_matmul), numbered beside them
WGMMA_WS = 5
PATH_NAMES = {SCALAR: "cuda_cores", VEC16: "cuda_cores", TENSOR_CORE: "mma_sync",
              WGMMA: "wgmma", DECODE: "decode", WGMMA_WS: "wgmma_ws"}
# the x operands of the wgmma kernel: bf16, int8, an f32 x's three bf16 planes (the
# code its C entry points take for the shared-memory query)
X_BF16, X_S8, X_F32 = 0, 1, 2
DECODE_MAX_M = 16        # rows up to which the product takes DECODE: x is mma.sync's 16-row A
WGMMA_MIN_M = DECODE_MAX_M + 1   # rows from which it takes WGMMA
WGMMA_TILE_CAP = 128     # rows of its token tile at most (two accumulator slabs of 64 registers)
# the widths the s8 warpgroup product takes from 17 rows (m64nNk32: 24, 32, then multiples of 16)
WGMMA_A8_TILES = (24, 32, 48, 64, 80, 96, 112, 128)
# f32 x as three bf16 planes from 17 rows: token tiles of multiples of 8 up to 64 (the
# three x tiles of a stage take three times a bf16 tile's room)
X3_TILE_CAP = 64
X3_TILES = tuple(range(24, X3_TILE_CAP + 1, 8))
# bytes of a stage's weight rows (64 of 128 columns): 144 apart for bf16 x, 128 apart
# (chunks swizzled) for int8 x
_W_STAGE = {False: 64 * 144, True: 64 * 128}
_X_ROW = {False: 128, True: 64}   # bytes of a row of 64 x values in a stage
SMEM_PER_SM = 233472     # 228 KB; each resident block also takes 1 KB of it
# The warp-specialised kernel (WGMMA_WS): bf16 x weight-only from WS_MIN_M rows. A
# block is a producer warpgroup and two consumer warpgroups, one block an SM; it owns
# 128 weight columns (a consumer's slab of 64 each) and ``tile`` token rows; a ring
# slot is the x tile (``tile`` rows of 128 bytes) and the raw bytes (int8: 64 rows
# 144 bytes apart, 9 KB; int4: 32 packed rows 160 bytes apart and the group's
# scales, 6 KB); as many slots as fit in a block's 227 KB, at most 6.
# From 171 rows (a prompt's system chunk; a fused pass's 196 and 220, B 8's 392 and 1,568,
# training's 926-2,048, the tower's 576 and 18,432): at each of these a decoder layer's
# four products (the projector's two, a tower layer's six) ran faster here than on the
# one-warpgroup wgmma kernel in the same call (chip_smoke.py phase 2, NVIDIA H100 80GB
# HBM3, 700 W: int8 0.2181 against 0.2737 ms at 171, 0.2420 / 0.2961 at 196, 1.6979 /
# 2.0286 at 2,048; int4 0.2943 / 0.3662 at 171, 2.1356 / 2.4938 at 2,048), and phase 2
# fails where it no longer does. Below 171 no path's row count was timed.
WS_MIN_M = 171
WS_TILES = tuple(range(96, 257, 16))       # int8 token tiles (tile / 2 accumulator registers)
WS_RAW = {8: 9216, 4: 6144}
WS_SMEM = 232448                           # a block's shared memory at most
# the plan's estimate of a launch (microseconds; ``ws_launch``): a stage of T token
# rows takes (T + WS_STAGE_ROWS) x WS_ROW_US on its SM (a row's 128 x 64 products at
# 70% of an SM's share of 989 TFLOP/s, and a fixed part), a block WS_BLOCK_US more
# (its ring filling, its epilogue), a K split its f32 partials' M N 8 bytes at
# WS_SPLIT_BYTES_PER_US and a reduce launch. The constants were fitted on an H100 to
# the times of every token tile at 1, 2, 3, 4 and 6 splits at the 7B paths' shapes
# (``python3 -m aha_tpu_torch.sweep_ws``): the launch they choose was within 4% of the
# fastest at every shape.
WS_ROW_US = 2 * 128 * 64 / (989e6 / 132 * 0.7)
WS_STAGE_ROWS = 96
WS_BLOCK_US = 0.5
WS_SPLIT_BYTES_PER_US = 1.5e6
WS_REDUCE_US = 1.0
# bf16 x weight-only from 17 rows splits K by the weight's shape alone
# (``row_free_splits``): both wgmma kernels add a split's stages in one order and the
# splits in split order, so a row gets the same bits whatever the rows beside it and
# whichever of the two kernels its row count takes (on an H100 the decode kernel's rows
# too were those bits at equal splits; its own splits serve a token's latency). A
# stream's frame is one frame step (49 rows at B 1), a quarter of a fused pass (196)
# and a row of a batch of 8 (392, 1,568), and its scores are held to each other across
# these (chip_smoke.py phase 7). The split count is the one whose estimate summed over
# these row counts is least. Above ROW_FREE_MAX_M rows (only the vision tower's batches
# of 8 frames and more), the launch of least estimate: there the estimate puts fc2's
# row-free four splits (K 4,096) at 2.2 times one split's time for a 32-frame batch.
ROW_FREE_M = (49, 196, 392, 1568)
ROW_FREE_MAX_M = 4096
# bytes of a decode ring slot: the x tile (16 rows) and the weight rows
DECODE_SLOTS = {a8: 16 * _X_ROW[a8] + _W_STAGE[a8] for a8 in (False, True)}
# the decode ring for grids of more than one round: the one that holds three blocks an SM
DECODE_BIG_RING = {False: 6, True: 8}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a product is launched: the kernel's path, and on a tensor-core path
    the token tile (the width of its warpgroup products; 16, the A operand's
    rows, on the decode path), the number of tiles, the ring's slots and its
    shared memory (the kernel asks for it and a refusal comes back as the
    launch's error); K splits everywhere."""
    path: int
    splits: int
    tile: int = 0
    tiles: int = 0
    stages: int = 0
    smem_bytes: int = 0


def token_tile(M: int, cap: int, widths: tuple[int, ...] | None = None) -> tuple[int, int]:
    """M rows in as few tiles of at most ``cap`` rows as cover them, evened out
    and rounded up to the 8 rows a warpgroup product's width moves in, or to the
    next of ``widths`` where the product takes only those: (rows per tile,
    tiles). 926 rows under a cap of 80 are 12 tiles of 80, under 128 8 tiles of
    120; 196 rows under 80 are 3 tiles of 72, under 128 in the s8 widths 2 tiles
    of 112."""
    tiles = -(-M // cap)
    rows = -(-M // tiles)
    tile = 8 * -(-rows // 8)
    if widths is not None:
        tile = min(w for w in widths if w >= tile)
    return tile, -(-M // tile)


def splits_on(sms: int, blocks: int, units: int) -> int:
    """Split K over blocks when the output-tile grid (``blocks``) would leave
    a card of ``sms`` SMs idle; ``units`` bounds the number of splits (each
    keeps at least one unit of K)."""
    want = -(-2 * sms // blocks)
    return max(1, min(want, units, 64))


def blocks_per_sm(tile: int, planes: int = 1) -> int:
    """Blocks of the wgmma kernel an SM holds: three up to 64 rows (gate_up's
    296 column blocks then run in one round), two for wider tiles (their
    accumulators need more than a third of the registers), and two for f32 x
    (``planes`` 3), whose three x tiles a stage take three times the room."""
    return 3 if tile <= 64 and planes == 1 else 2


def wgmma_ring(tile: int, a8: bool = False, planes: int = 1) -> tuple[int, int]:
    """(slots, shared memory bytes) of the wgmma kernel's ring at token tile
    ``tile``: a slot is the x tile (``tile`` rows of 128 bytes, 64 for int8 x;
    three such tiles for the planes of an f32 x) and the weight rows; six
    slots, fewer where the SM's blocks would not fit; 1 KB to align the tiles.
    The kernel computes the same (``aha_int8_matmul_wgmma_smem``)."""
    stage = planes * tile * _X_ROW[a8] + _W_STAGE[a8]
    stages = min(6, (SMEM_PER_SM // blocks_per_sm(tile, planes) - 2048) // stage)
    return stages, stages * stage + 1024


def wgmma_splits(places: int, blocks: int, stages: int) -> int:
    """K splits of the wgmma kernel for int8 x and an f32 x's planes (bf16 x
    weight-only takes ``row_free_splits``; whole stages of 64 rows): a grid smaller
    than one round of resident blocks (``places``) is split as far as still
    fits one round, 8 stages a split at least (qkv at 49 rows: 36 column blocks
    in 7 splits). A larger grid is not split: the partials of a split cost M N 8
    bytes of traffic, more than a last round that runs nearly empty saves (down
    at 1568 rows on an H100: two splits were slower than one)."""
    return max(1, min(places // blocks, stages // 8, 64))


def decode_blocks_per_sm(slots: int, a8: bool = False) -> int:
    """Blocks of the decode kernel an SM is sure to hold with a ring of
    ``slots`` (each block costs 1 KB of shared memory besides; the kernel is
    compiled for six at most): six with 3 slots, three with the big ring (6
    slots for bf16 x, 8 for int8 x)."""
    return min(6, SMEM_PER_SM // (slots * DECODE_SLOTS[a8] + 1024))


def decode_launch(sms: int, N: int, stages: int, a8: bool = False) -> tuple[int, int]:
    """(ring slots, K splits) of the decode kernel for a weight of N columns and
    ``stages`` 64-row stages, from the shape of W alone (never from M: a row
    gives the same bits at any M up to 16). Its blocks are short and the bytes
    bound them, so what counts is how evenly a grid fills the SMs. A grid of
    128-column blocks smaller than two an SM is split until it holds about two an
    SM, evened out over the stages (qkv's 36 blocks in 7 splits, o's 28 in 8,
    down's 28 in 9); gate_up's 296 are not split. These run in one round of
    six blocks an SM behind a ring of three slots. A grid larger than that round
    (the lm_head's 1,188 blocks) takes the ring that holds three blocks an SM
    (six slots, eight for int8 x): three even rounds. The same for int8 x. On an
    H100 each choice was the fastest of those tried for bf16 x at 1, 8 and 16
    rows, or within 1% of it (splits 4-14 for qkv and o, 1-8 for gate_up, 4-37
    for down, 1-2 for the lm_head; rings of 3, 4, 5, 6 and 8 slots)."""
    blocks = -(-N // 128)
    if blocks > decode_blocks_per_sm(3, a8) * sms:
        return DECODE_BIG_RING[a8], 1
    two = 2 * sms
    if blocks >= two:
        return 3, 1
    want = max(1, min(two // blocks, stages, 64))
    per = -(-stages // want)
    return 3, -(-stages // per)


def decode_column(warp: int, j: int, t: int) -> int:
    """Which of a block's weight columns column ``j`` (0 .. 7) of n-tile ``t``
    (0 .. 3) of warp ``warp``'s products is on the decode path: the thread with
    gid = j reads the words of columns 32 warp + 4 j .. + 3, whose byte t builds
    its B registers of n-tile t."""
    return 32 * warp + 4 * j + t


def fwd_row_to_column(row: int) -> int:
    """Which of a block's 128 weight columns accumulator row ``row`` (0 .. 63:
    slab 0, 64 .. 127: slab 1) of the wgmma kernels is (int8 here, and int4's
    forward): the thread that holds rows gid and gid + 8 of warp w in both slabs
    owns the four neighbouring columns 4 (8 w + gid) .. + 3."""
    slab, r = divmod(row, 64)
    w, q = divmod(r, 16)
    return 4 * (8 * w + q % 8) + 2 * slab + q // 8


def ws_ring(tile: int, bits: int = 8) -> tuple[int, int]:
    """(slots, shared memory bytes) of the warp-specialised kernel at token tile
    ``tile`` for int8 (``bits`` 8) or int4 weights: as many slots as fit beside
    1 KB of alignment and the barriers, at most six (the kernel's
    ``smem_bytes``, ``aha_quant_matmul_ws_smem``)."""
    stage = tile * 128 + WS_RAW[bits]
    stages = min(6, (WS_SMEM - 1024 - 256) // stage)
    return stages, stages * stage + 1024


def ws_launch(M: int, stages: int, N: int, sms: int, tiles: tuple[int, ...],
              unit: int = 1, splits: int | None = None) -> tuple[int, int, int]:
    """(tile, token tiles, K splits) of the warp-specialised kernel for M rows, a
    K of ``stages`` 64-row stages split in whole ``unit``s of stages (int4: a
    group), N columns (blocks of 128), one block an SM: the choice among the
    token tiles ``tiles`` and 1 .. 16 splits (``splits``: that many, the tile
    alone chosen) whose estimated time (``ws_estimate``) is least, fewer splits
    and wider tiles first where equal. A grid smaller than the card is split or
    cut into narrower token tiles; one of a few rounds keeps its tail."""
    units = stages // unit
    counts = range(1, min(units, 16) + 1) if splits is None else (splits,)
    best = None
    for tile in tiles:
        for n in counts:
            key = (ws_estimate(M, stages, N, sms, tile, n, unit), n, -tile)
            if best is None or key < best[0]:
                best = (key, tile, -(-M // tile), n)
    return best[1], best[2], best[3]


def ws_estimate(M: int, stages: int, N: int, sms: int, tile: int, splits: int,
                unit: int = 1) -> float:
    """The WS_* constants' estimate (microseconds) of a warp-specialised launch
    at token tile ``tile`` and ``splits`` K splits of whole ``unit``s of
    stages."""
    per = -(-(stages // unit) // splits) * unit
    stage_us = (tile + WS_STAGE_ROWS) * WS_ROW_US
    t = -(-(-(-M // tile) * -(-N // 128) * splits) // sms) * (per * stage_us + WS_BLOCK_US)
    if splits > 1:
        t += splits * M * N * 8 / WS_SPLIT_BYTES_PER_US + WS_REDUCE_US
    return t


@functools.lru_cache(maxsize=None)
def row_free_splits(K: int, N: int, sms: int) -> int:
    """The K splits of bf16 x weight-only from 17 to ROW_FREE_MAX_M rows on
    either wgmma kernel, from the weight's shape alone (never from M): the
    count, 1 .. 16 of whole
    stages, whose estimated warp-specialised launch (``ws_estimate`` at its best
    tile) summed over the ROW_FREE_M row counts is least. On the 7B: qkv, o_proj
    and gate_up 1, down 2."""
    stages = K // 64
    return min(range(1, min(stages, 16) + 1),
               key=lambda n: (sum(min(ws_estimate(M, stages, N, sms, t, n) for t in WS_TILES)
                                  for M in ROW_FREE_M), n))


def ws_plan(M: int, K: int, N: int, sms: int) -> Plan:
    """The warp-specialised launch of an int8 weight (bf16 x, weight-only), K
    split as ``row_free_splits`` says up to ROW_FREE_MAX_M rows."""
    tile, tiles, splits = ws_launch(
        M, K // 64, N, sms, WS_TILES,
        splits=row_free_splits(K, N, sms) if M <= ROW_FREE_MAX_M else None)
    stages, smem = ws_ring(tile)
    return Plan(WGMMA_WS, splits, tile, tiles, stages, smem)


def ws_column(consumer: int, warp: int, gid: int) -> int:
    """The first of the two neighbouring weight columns whose accumulator rows
    gid and gid + 8 (of warp ``warp``) a thread of the warp-specialised
    kernel's consumer ``consumer`` holds: the consumer converts slab
    ``consumer`` of ``fwd_row_to_column``'s relabelling, bytes 2 consumer and
    2 consumer + 1 of the thread's words of columns 4 (8 warp + gid) .. + 3."""
    return 4 * (8 * warp + gid) + 2 * consumer


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, *, bf16: bool, a8: bool = False,
         align: tuple[int, int, int] = (16, 16, 16), sms: int = 132) -> Plan:
    """The launch of ``int8_matmul`` / ``quant_matmul`` on a card of ``sms``
    SMs for x [M, K] (bf16 or f32, the output's type; ``a8``: quantised to int8
    first), qvalue [K, N] and scale [N] whose addresses (x's: the quantised x's
    with ``a8``) are multiples of ``align`` bytes. The two Hopper paths take a
    bf16 output, K % 64 == 0, N % 16 == 0 and 16-byte aligned operands, with
    either operand type under the same conditions (bf16 x weight-only from
    WS_MIN_M rows on the warp-specialised kernel); under the same conditions
    f32 x weight-only takes the wgmma kernel from 17 rows (as three bf16
    planes, an f32 output; 1 to 16 f32 rows stay on the CUDA cores). Pure (no
    card is asked) and remembered: a path's shapes recur with every pass."""
    ax, aw, asc = align
    hopper = K % 64 == 0 and N % 16 == 0 and ax % 16 == 0 and aw % 16 == 0 and asc % 16 == 0
    tensor_cores = bf16 and hopper
    if tensor_cores and M <= DECODE_MAX_M:
        slots, splits = decode_launch(sms, N, K // 64, a8)
        return Plan(DECODE, splits, 16, 1, slots, slots * DECODE_SLOTS[a8])
    if tensor_cores and not a8 and M >= WS_MIN_M:
        return ws_plan(M, K, N, sms)
    if tensor_cores:
        return wgmma_plan(M, K, N, a8, sms)
    if hopper and not bf16 and not a8 and M >= WGMMA_MIN_M:
        return x3_plan(M, K, N, sms)
    if (a8 or bf16) and M > 1 and K % 32 == 0 and N % 8 == 0 and ax % 16 == 0 and aw % 8 == 0:
        return Plan(TENSOR_CORE, splits_on(sms, -(-M // 64) * -(-N // 128), K // 256))
    path = VEC16 if N % 16 == 0 and aw % 16 == 0 else SCALAR
    return Plan(path, splits_on(sms, -(-N // 128) * (1 if M == 1 else -(-M // 4)), K // 256))


def wgmma_plan(M: int, K: int, N: int, a8: bool = False, sms: int = 132) -> Plan:
    """The launch of the one-warpgroup wgmma kernel (bf16 or int8 x, bf16
    output) at M >= 17 rows: a token tile of at most 128 rows (int8 x: among the
    s8 widths), its ring, K split as ``row_free_splits`` says for bf16 x and as
    ``wgmma_splits`` says for int8 x (whose exact integer sums no split order
    changes). bf16 x weight-only takes it below WS_MIN_M rows; ``chip_smoke.py``
    also launches it above, to time the kernel the warp-specialised one
    replaced there."""
    tile, tiles = token_tile(M, WGMMA_TILE_CAP, WGMMA_A8_TILES if a8 else None)
    stages, smem = wgmma_ring(tile, a8)
    splits = (wgmma_splits(blocks_per_sm(tile) * sms, tiles * -(-N // 128), K // 64) if a8
              else row_free_splits(K, N, sms))
    return Plan(WGMMA, splits, tile, tiles, stages, smem)


def x3_plan(M: int, K: int, N: int, sms: int) -> Plan:
    """The wgmma launch of f32 x as three bf16 planes at M >= 17 rows: token
    tiles of at most 64 rows, the ring that two blocks an SM leave room for, K
    split as for bf16 x."""
    tile, tiles = token_tile(M, X3_TILE_CAP)
    stages, smem = wgmma_ring(tile, planes=3)
    splits = wgmma_splits(blocks_per_sm(tile, 3) * sms, tiles * -(-N // 128), K // 64)
    return Plan(WGMMA, splits, tile, tiles, stages, smem)


def align_of(t: torch.Tensor) -> int:
    """The largest of 16, 8 and 1 that divides ``t``'s address."""
    return 16 if t.data_ptr() % 16 == 0 else (8 if t.data_ptr() % 8 == 0 else 1)


def _check(name: str, x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor) -> int:
    """Raise on what no path of the kernel takes; N otherwise."""
    K = x.shape[-1]
    if qvalue.dtype != torch.int8 or qvalue.dim() != 2 or qvalue.shape[0] != K:
        raise ValueError(f"{name}: weight must be int8 [K={K}, N], got "
                         f"{qvalue.dtype} {tuple(qvalue.shape)}")
    N = qvalue.shape[1]
    if scale.dtype != torch.float32 or scale.numel() != N:
        raise ValueError(f"{name}: scale must be f32 with {N} values, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} not supported")
    for what, t in (("x", x), ("qvalue", qvalue), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return N


def _launch(name: str, x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor,
            a8: bool) -> torch.Tensor:
    *lead, K = x.shape
    N = _check(name, x, qvalue, scale)
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if -(-M // 4) > 65535:
        raise ValueError(f"{name}: M={M} exceeds the kernel's grid")
    sx = None
    if a8:
        x2, sx = quantize_rows(x2)
    pl = plan(M, K, N, bf16=x.dtype == torch.bfloat16, a8=a8,
              align=(align_of(x2), align_of(qvalue), align_of(scale)),
              sms=num_sms(x.device.index or 0))
    operand = "s8" if a8 else "bf16" if x.dtype == torch.bfloat16 else "f32"
    if pl.path == WGMMA and operand == "f32":
        x2 = split_bf16x3(x2)
    launch_plan(x2, sx, qvalue, scale, y, pl)
    LAUNCHES[name] += 1
    PATH_LAUNCHES[f"{name}/{PATH_NAMES[pl.path]}/{operand}"] += 1
    return y.reshape(*lead, N)


def check_hopper_operands(name: str, x2: torch.Tensor, sx: torch.Tensor | None,
                          y: torch.Tensor, pl: Plan, a8_tiles: tuple[int, ...]) -> bool:
    """Raise on operands a Hopper plan's kernel would refuse (``name``: the
    product, int8 or int4): bf16 x weight-only or int8 x with its row scales
    and a bf16 output, or on the wgmma path an f32 x's three bf16 planes
    [3, M, K] and an f32 output, each at the token tiles its kernel is built
    for. -> whether x2 holds planes."""
    planes = x2.dim() == 3
    ok = (x2.dtype == torch.bfloat16 and sx is None and y.dtype == torch.float32
          and pl.path == WGMMA if planes else
          x2.dtype == (torch.bfloat16 if sx is None else torch.int8)
          and y.dtype == torch.bfloat16)
    if not ok:
        raise ValueError(f"{name}: path {pl.path} takes bf16 x, weight-only, or int8 x with "
                         f"its row scales, and a bf16 output; got {x2.dtype} x "
                         f"{'without' if sx is None else 'with'} row scales and a {y.dtype} "
                         f"output, x of {x2.dim()} dimensions (the wgmma path also takes "
                         f"an f32 x's three bf16 planes [3, M, K] and an f32 output)")
    tiles = X3_TILES if planes else a8_tiles if sx is not None else None
    if pl.path == WGMMA and tiles is not None and pl.tile not in tiles:
        kind = "f32" if planes else "int8"
        raise ValueError(f"{name}: the {kind} wgmma path takes token tiles {tiles}, got "
                         f"{pl.tile}")
    return planes


def check_ws_operands(name: str, x2: torch.Tensor, sx: torch.Tensor | None, y: torch.Tensor,
                      pl: Plan, tiles: tuple[int, ...]) -> None:
    """Raise on operands the warp-specialised kernel would refuse: it takes bf16
    x [M, K], weight-only, a bf16 output, at the token tiles it is built for."""
    if x2.dim() != 2 or x2.dtype != torch.bfloat16 or sx is not None or y.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the warp-specialised path takes bf16 x [M, K], weight-only, "
                         f"and a bf16 output; got {x2.dtype} x of {x2.dim()} dimensions "
                         f"{'without' if sx is None else 'with'} row scales and a {y.dtype} "
                         f"output")
    if pl.tile not in tiles:
        raise ValueError(f"{name}: the warp-specialised path takes token tiles {tiles}, "
                         f"got {pl.tile}")


def launch_plan(x2: torch.Tensor, sx: torch.Tensor | None, qvalue: torch.Tensor,
                scale: torch.Tensor, y: torch.Tensor, pl: Plan) -> None:
    """Launch the kernel into ``y`` [M, N] along ``pl`` (x2 [M, K] bf16 / f32,
    int8 with its row scales ``sx``, or on the wgmma path an f32 x's planes
    [3, M, K] from ``split_bf16x3`` with an f32 ``y``), checked by the
    wrappers. Not counted: ``chip_smoke.py`` also times here the kernels a plan
    no longer picks. Raises on a Hopper plan the kernels would refuse."""
    M, K = x2.shape[-2:]
    N = qvalue.shape[1]
    planes = False
    if pl.path in (WGMMA, DECODE):
        planes = check_hopper_operands("int8_matmul", x2, sx, y, pl, WGMMA_A8_TILES)
    if pl.path == DECODE and M > DECODE_MAX_M:
        raise ValueError(f"int8_matmul: the decode path takes at most {DECODE_MAX_M} rows, "
                         f"got {M}")
    ws = (torch.empty((pl.splits, M, N), dtype=torch.float32, device=x2.device)
          if pl.splits > 1 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x2.device).cuda_stream)
    lib = _build.library()
    if pl.path == WGMMA_WS:
        check_ws_operands("int8_matmul", x2, sx, y, pl, WS_TILES)
        err = lib.aha_quant_matmul_ws(x2.data_ptr(), qvalue.data_ptr(), scale.data_ptr(),
                                      y.data_ptr(), ws_ptr, M, K, N, 0, 8, pl.splits, pl.tile,
                                      stream)
        _build.check(lib, err, "int8_matmul")
        return
    tile = pl.stages if pl.path == DECODE else pl.tile
    if sx is not None:
        err = lib.aha_int8_matmul_a8(
            x2.data_ptr(), sx.data_ptr(), qvalue.data_ptr(), scale.data_ptr(), y.data_ptr(),
            ws_ptr, M, K, N, _DTYPES[y.dtype], pl.splits, pl.path, tile, stream)
    else:
        err = lib.aha_int8_matmul(
            x2.data_ptr(), qvalue.data_ptr(), scale.data_ptr(), y.data_ptr(), ws_ptr,
            M, K, N, _BF16X3 if planes else _DTYPES[x2.dtype], pl.splits, pl.path, tile, stream)
    _build.check(lib, err, "int8_matmul")


def int8_matmul(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor, *,
                a8: bool = False) -> torch.Tensor:
    """x [..., K] (f32 or bf16) @ qvalue [K, N] int8 * scale ([N] or [1, N]
    f32) -> [..., N] in x's dtype; ``a8`` quantises x per token first.
    Counted as ``int8_matmul`` or ``int8_matmul_a8``."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qvalue, scale, a8)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return _launch("int8_matmul_a8" if a8 else "int8_matmul", x, qvalue, scale, a8)


def quant_matmul(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 qvalue [K, N] * scale [1, N] -> [..., N]: the
    weight-only product under the name and signature of the TPU package's
    first int8 kernel. Launches the kernel of ``int8_matmul``; counted as
    ``quant_matmul``."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qvalue, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    return _launch("quant_matmul", x, qvalue, scale, False)


def int8_qlinear_vjp(grad: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dL/dx of ``x @ (qvalue * scale)``: the incoming gradient [..., N] times
    the weight transposed, dequantised as JAX's ``dequantize`` does (the
    product in f32, rounded once to the gradient's dtype)."""
    w = (qvalue.float() * scale.reshape(1, -1).float()).to(grad.dtype)
    return torch.matmul(grad, w.t())


class _Int8QLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qvalue, scale):
        ctx.save_for_backward(qvalue, scale)
        return int8_matmul(x, qvalue, scale)

    @staticmethod
    def backward(ctx, grad):
        qvalue, scale = ctx.saved_tensors
        return int8_qlinear_vjp(grad, qvalue, scale), None, None


def int8_qlinear(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``int8_matmul(x, qvalue, scale)`` (weight-only) that autograd can
    differentiate with respect to ``x``: the kernel forward, the dequantised
    transposed product backward. The weight and its scale are frozen."""
    return _Int8QLinear.apply(x, qvalue, scale)
