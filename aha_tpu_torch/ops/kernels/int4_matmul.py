"""``x @`` packed-int4 ``W`` with group scales: the CUDA kernel
``csrc/int4_matmul.cu`` and its plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::int4_matmul``: the
product behind every decoder projection, the projector and the lm_head of
the --int4 config, weight-only (``a8=False``) or with per-token int8
activations (``a8=True``). ``q4value`` [K/2, N] uint8 packs row 2j in the low
nibble and row 2j + 1 in the high nibble of byte j, values offset by 8;
``scale4`` [K/G, N] bf16 holds one scale per group of G rows and output
column (G = K // scale4.shape[0]). A stacked weight's layer is passed as the
views ``q4value[l]``, ``scale4[l]``. ``int4_qlinear`` is the same product
with a gradient for ``x`` (``aha_tpu/ops/pallas/fused_matmul.py::
int4_qlinear``): forward this kernel, backward ``int4_matmul_t``, nothing for
the frozen weight and scales. ``plan`` chooses the kernel's path from the
shapes alone, so the CPU tests hold it: bf16 x weight-only, and int8
activations with a bf16 output, at 1 to 16 rows the decode kernel (one launch
whatever M, so a row gives the same bits at every width), from 17 rows the
wgmma kernel; f32 weight-only from 17 rows the wgmma kernel too, on x split
into three bf16 planes (``split_bf16x3``) whose products add into each
group's f32 sum before its scale (``int4_matmul_x3_plain`` models it); the
rest the earlier paths.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, PATH_LAUNCHES, _build
from .int8_matmul import WGMMA_A8_TILES as _A8_WIDTHS
from .int8_matmul import (DECODE, DECODE_MAX_M, PATH_NAMES, SCALAR, TENSOR_CORE, VEC16, WGMMA,
                          WGMMA_MIN_M, WGMMA_WS, WS_MIN_M, X3_TILE_CAP, X3_TILES, Plan,
                          check_hopper_operands, check_ws_operands, decode_column,
                          fwd_row_to_column, num_sms, splits_on, token_tile, ws_column, ws_launch,
                          ws_ring)
from .int8_matmul import align_of as _align
from .quantize_rows import quantize_rows, quantize_rows_plain, split_bf16x3, split_bf16x3_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_BF16X3 = 3      # x is an f32 x's three bf16 planes (AHA_BF16X3)


def unpack_int4(q4value: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] uint8 -> [..., K, N] int8 in -8..7 (low nibble = even
    row, high nibble = odd row)."""
    *lead, Kh, N = q4value.shape
    low = (q4value & 0xF).to(torch.int8) - 8
    high = (q4value >> 4).to(torch.int8) - 8
    return torch.stack([low, high], dim=-2).reshape(*lead, 2 * Kh, N)


def int4_matmul_plain(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor,
                      a8: bool = False) -> torch.Tensor:
    """Rounds where the kernel rounds: a group's partial sum in f32
    (``a8``: exact integers, taken in f64 and rounded to f32 once, as an
    int32 accumulator converts), times the group's bf16 scale as f32, the
    groups added in f32, (``a8``: times the row scale,) one cast at the end."""
    *lead, K = x.shape
    Kh, N = q4value.shape
    n_groups = scale4.shape[0]
    G = K // n_groups
    x2 = x.reshape(-1, K)
    w = unpack_int4(q4value).reshape(n_groups, G, N)
    if a8:
        xq, sx = quantize_rows_plain(x2)
        part = torch.einsum("mgk,gkn->mgn", xq.double().reshape(-1, n_groups, G),
                            w.double()).float()
    else:
        part = torch.einsum("mgk,gkn->mgn", x2.float().reshape(-1, n_groups, G), w.float())
    y = (part * scale4.float()[None]).sum(dim=1)
    if a8:
        y = y * sx
    return y.to(x.dtype).reshape(*lead, N)


def int4_matmul_x3_plain(x: torch.Tensor, q4value: torch.Tensor,
                         scale4: torch.Tensor) -> torch.Tensor:
    """What the f32-activation wgmma path computes: x split into three bf16
    planes (``split_bf16x3_plain``); a group's partial sum is the three planes'
    products with the int4 values (each exact) added in f32, times the group's
    bf16 scale as f32; the groups added in f32; f32 out. Equal to
    ``int4_matmul_plain`` but for the order of the f32 sums."""
    *lead, K = x.shape
    N = q4value.shape[1]
    n_groups = scale4.shape[0]
    G = K // n_groups
    planes = split_bf16x3_plain(x.reshape(-1, K)).float().reshape(3, -1, n_groups, G)
    w = unpack_int4(q4value).reshape(n_groups, G, N).float()
    part = sum(torch.einsum("mgk,gkn->mgn", planes[q], w) for q in range(3))
    y = (part * scale4.float()[None]).sum(dim=1)
    return y.reshape(*lead, N)


WGMMA_TILE_CAP = 80      # rows of its token tile at most (two accumulator sets of 2 x 40 registers)
# the widths the s8 warpgroup product takes from 17 rows, up to the cap
WGMMA_A8_TILES = tuple(t for t in _A8_WIDTHS if t <= WGMMA_TILE_CAP)
WGMMA_STAGES = 6         # the wgmma kernel's ring slots
DECODE_STAGES = 7        # the decode kernel's ring slots (x tile, packed bytes, scales a slot)
# bytes of a packed row of a stage's 128 columns (strides at which the rows a warp
# reads at once fall in distinct banks: rows tig + 4 q for bf16 x, 2 tig + 8 m and
# the next for int8 x) and of a row of 64 x values
_W_ROW = {False: 160, True: 144}
_X_ROW = {False: 128, True: 64}
# bytes of a decode ring slot: the x tile (16 rows), 32 packed rows, 128 scales
DECODE_SLOT = {a8: 16 * _X_ROW[a8] + 32 * _W_ROW[a8] + 256 for a8 in (False, True)}
DECODE_SMEM = DECODE_STAGES * DECODE_SLOT[False]
DECODE_SMEM_A8 = DECODE_STAGES * DECODE_SLOT[True]
DECODE_BLOCKS_PER_SM = 4
# the warp-specialised kernel's token tiles: a consumer keeps two accumulator sets (the
# group's sum and the total) of tile / 2 registers each, 160 at the widest
WS_TILES = tuple(range(64, 161, 16))


SMEM_PER_SM = 233472     # 228 KB; each resident block also takes 1 KB of it


def wgmma_stage_bytes(tile: int, a8: bool = False, planes: int = 1) -> int:
    """Bytes of a wgmma ring slot at token tile ``tile``: the x tile (three for
    the planes of an f32 x), then the packed rows and the scales from a
    multiple of 1024 bytes (the kernel's ``stage_bytes``)."""
    return planes * tile * _X_ROW[a8] + -(-(32 * _W_ROW[a8] + 256) // 1024) * 1024


def wgmma_stages(tile: int, planes: int = 1) -> int:
    """Ring slots of the wgmma kernel: six, or for f32 x (three planes) as many
    as two blocks an SM leave room for, at most six (the kernel's ``stages``)."""
    if planes == 1:
        return WGMMA_STAGES
    return min(WGMMA_STAGES, (SMEM_PER_SM // 2 - 2048) // wgmma_stage_bytes(tile, planes=planes))


def decode_splits(sms: int, N: int, groups: int, a8: bool = False) -> int:
    """K splits of the decode kernel, whole groups each, from the shapes of W
    alone (never from M: a row gives the same bits at any M up to 16). The
    kernel is bound by each SM's issue, not by the memory: a grid of 128-column
    blocks smaller than half a round of resident blocks (two an SM of the four)
    is split as far as half a round holds, evened out over the groups (qkv's 36
    column blocks in 7 splits of 4 groups, o's 28 in 7, down's 28 in 9 of 17: on
    an H100 each was the fastest of 7 / 10 / 14 or 9 / 13 / 17 at 1, 8 and 16
    rows but o at 1 and 8, where 14 was a little faster). A grid between half a
    round and a round leaves some SMs a third more blocks than others: with bf16
    x it is cut in 4, gate_up's 296 blocks into 1,184 of 7 groups; with int8 x,
    whose blocks wait for the quantiser ahead of them and issue fewer
    instructions a stage, it is not cut (on an H100 faster from 4 rows on, a
    little slower at one: ``chip_smoke.py`` phase 2 times it in 4 splits too). A
    larger grid (the lm_head's 1,188) takes one."""
    half, blocks = DECODE_BLOCKS_PER_SM * sms // 2, -(-N // 128)
    if blocks > half:
        return 4 if blocks <= 2 * half and groups >= 16 and not a8 else 1
    want = max(1, min(half // blocks, groups, 64))
    per = -(-groups // want)
    return -(-groups // per)


def wgmma_splits(sms: int, blocks: int, groups: int, stages: int) -> int:
    """K splits of the wgmma kernel, whole groups each. A grid that leaves SMs
    idle (two blocks share an SM) is split as everywhere, four groups a split at
    least. A larger grid is split in 2 to 4 where K is long (64 stages of 64 a
    split at least) and its last round of blocks would run nearly empty: 336
    blocks of 296 stages on 264 places are two rounds for 1.27 rounds of work,
    in three splits four rounds of a third the length."""
    places = 2 * sms
    if blocks < places:
        return splits_on(sms, blocks, groups // 4)
    best, cost = 1, float(-(-blocks // places))
    for s in (2, 3, 4):
        if stages // s < 64 or groups < s:
            break
        c = -(-blocks * s // places) / s
        if c < cost - 0.1:
            best, cost = s, c
    return best


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, G: int, *, bf16: bool, a8: bool = False,
         align: tuple[int, int, int] = (16, 16, 16), sms: int = 132) -> Plan:
    """The launch of ``int4_matmul`` on a card of ``sms`` SMs for x [M, K]
    (bf16 or f32, the output's type; ``a8``: quantised to int8 first), q4value
    [K/2, N], scale4 [K/G, N] whose addresses (x's: the quantised x's with
    ``a8``) are multiples of ``align`` bytes. The two Hopper paths take a bf16
    output, G % 64 == 0, N % 16 == 0 and 16-byte aligned operands, with either
    operand type under the same conditions: the decode kernel at 1 to 16 rows,
    the wgmma kernel from 17 (int8 x: a token tile among the s8 widths; bf16 x
    from WS_MIN_M rows the warp-specialised kernel). Under
    the same conditions f32 x weight-only takes the wgmma kernel from 17 rows
    (three bf16 planes, an f32 output); 1 to 16 f32 rows stay on the CUDA
    cores. Pure (no card is asked) and remembered: a path's shapes recur with
    every pass."""
    ax, aw, asc = align
    hopper = G % 64 == 0 and N % 16 == 0 and ax % 16 == 0 and aw % 16 == 0 and asc % 16 == 0
    tensor_cores = bf16 and hopper
    if tensor_cores and M <= DECODE_MAX_M:
        return Plan(DECODE, decode_splits(sms, N, K // G, a8), 16, 1, DECODE_STAGES,
                    DECODE_SMEM_A8 if a8 else DECODE_SMEM)
    if tensor_cores and not a8 and M >= WS_MIN_M:
        return ws_plan(M, K, N, G, sms)
    if tensor_cores:
        return wgmma_plan(M, K, N, G, a8, sms)
    if hopper and not bf16 and not a8 and M >= WGMMA_MIN_M:
        return x3_plan(M, K, N, G, sms)
    if (a8 or bf16) and M > 1 and G % 32 == 0 and N % 8 == 0 and ax % 16 == 0 and aw % 8 == 0:
        return Plan(TENSOR_CORE, splits_on(sms, -(-M // 64) * -(-N // 128), K // 256))
    path = VEC16 if N % 16 == 0 and aw % 16 == 0 else SCALAR
    # whole groups per split, four groups in flight per block
    return Plan(path, splits_on(sms, -(-N // 128) * -(-M // 2), (K // G) // 4))


def wgmma_plan(M: int, K: int, N: int, G: int, a8: bool = False, sms: int = 132) -> Plan:
    """The launch of the one-warpgroup wgmma kernel (bf16 or int8 x, bf16
    output) at M >= 17 rows: a token tile of at most 80 rows (int8 x: among the
    s8 widths), six ring slots, whole groups a split. bf16 x weight-only takes
    it below WS_MIN_M rows; ``chip_smoke.py`` also launches it above, to time
    the kernel the warp-specialised one replaced there."""
    tile, tiles = token_tile(M, WGMMA_TILE_CAP, WGMMA_A8_TILES if a8 else None)
    splits = wgmma_splits(sms, tiles * -(-N // 128), K // G, K // 64)
    return Plan(WGMMA, splits, tile, tiles, WGMMA_STAGES,
                WGMMA_STAGES * wgmma_stage_bytes(tile, a8) + 1024)


def ws_plan(M: int, K: int, N: int, G: int, sms: int) -> Plan:
    """The warp-specialised launch of a packed int4 weight (bf16 x,
    weight-only): ``int8_matmul.ws_launch`` at the int4 tiles, whole groups a
    split."""
    tile, tiles, splits = ws_launch(M, K // 64, N, sms, WS_TILES, G // 64)
    stages, smem = ws_ring(tile, 4)
    return Plan(WGMMA_WS, splits, tile, tiles, stages, smem)


def x3_plan(M: int, K: int, N: int, G: int, sms: int) -> Plan:
    """The wgmma launch of f32 x as three bf16 planes at M >= 17 rows: token
    tiles of at most 64 rows, the ring that two blocks an SM leave room for,
    whole groups a split as for bf16 x."""
    tile, tiles = token_tile(M, X3_TILE_CAP)
    stages = wgmma_stages(tile, 3)
    splits = wgmma_splits(sms, tiles * -(-N // 128), K // G, K // 64)
    return Plan(WGMMA, splits, tile, tiles, stages,
                stages * wgmma_stage_bytes(tile, planes=3) + 1024)


def _check(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor) -> tuple[int, int]:
    """Raise on what no path of the kernel takes; (N, G) otherwise."""
    K = x.shape[-1]
    if (q4value.dtype != torch.uint8 or q4value.dim() != 2 or K % 2
            or q4value.shape[0] * 2 != K):
        raise ValueError(f"int4_matmul: weight must be uint8 [K/2={K // 2}, N], got "
                         f"{q4value.dtype} {tuple(q4value.shape)}")
    N = q4value.shape[1]
    if (scale4.dtype != torch.bfloat16 or scale4.dim() != 2 or scale4.shape[1] != N
            or scale4.shape[0] == 0 or K % scale4.shape[0]):
        raise ValueError(f"int4_matmul: scale4 must be bf16 [K/G, N={N}], got "
                         f"{scale4.dtype} {tuple(scale4.shape)}")
    G = K // scale4.shape[0]
    if G % 2:
        raise ValueError(f"int4_matmul: group size {G} must be even")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matmul: x dtype {x.dtype} not supported")
    for what, t in (("x", x), ("q4value", q4value), ("scale4", scale4)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul: {what} must be contiguous")
    return N, G


def int4_matmul(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor, *,
                a8: bool = False) -> torch.Tensor:
    """x [..., K] (f32 or bf16) @ packed q4value [K/2, N] uint8 with group
    scales scale4 [K/G, N] bf16 -> [..., N] in x's dtype. Any M, any N, K
    even, K % G == 0 and G even. Counted as ``int4_matmul`` or
    ``int4_matmul_a8``."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4value, scale4, a8)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    *lead, K = x.shape
    N, G = _check(x, q4value, scale4)
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if -(-M // 2) > 65535:
        raise ValueError(f"int4_matmul: M={M} exceeds the kernel's grid")
    sx = None
    if a8:
        x2, sx = quantize_rows(x2)
    pl = plan(M, K, N, G, bf16=x.dtype == torch.bfloat16, a8=a8,
              align=(_align(x2), _align(q4value), _align(scale4)),
              sms=num_sms(x.device.index or 0))
    operand = "s8" if a8 else "bf16" if x.dtype == torch.bfloat16 else "f32"
    if pl.path == WGMMA and operand == "f32":
        x2 = split_bf16x3(x2)
    launch_plan(x2, sx, q4value, scale4, y, pl)
    name = "int4_matmul_a8" if a8 else "int4_matmul"
    LAUNCHES[name] += 1
    PATH_LAUNCHES[f"{name}/{PATH_NAMES[pl.path]}/{operand}"] += 1
    return y.reshape(*lead, N)


def launch_plan(x2: torch.Tensor, sx: torch.Tensor | None, q4value: torch.Tensor,
                scale4: torch.Tensor, y: torch.Tensor, pl: Plan) -> None:
    """Launch the kernel into ``y`` [M, N] along ``pl`` (x2 [M, K] bf16 / f32,
    int8 with its row scales ``sx``, or on the wgmma path an f32 x's planes
    [3, M, K] from ``split_bf16x3`` with an f32 ``y``), checked by
    ``int4_matmul``. Not counted: ``chip_smoke.py`` also times here the kernels
    a plan no longer picks. Raises on a Hopper plan the kernels would refuse."""
    M, K = x2.shape[-2:]
    N = q4value.shape[1]
    planes = False
    if pl.path in (WGMMA, DECODE):
        planes = check_hopper_operands("int4_matmul", x2, sx, y, pl, WGMMA_A8_TILES)
    if pl.path == DECODE and M > DECODE_MAX_M:
        raise ValueError(f"int4_matmul: the decode path takes at most {DECODE_MAX_M} rows, "
                         f"got {M}")
    ws = (torch.empty((pl.splits, M, N), dtype=torch.float32, device=x2.device)
          if pl.splits > 1 else None)
    lib = _build.library()
    if pl.path == WGMMA_WS:
        check_ws_operands("int4_matmul", x2, sx, y, pl, WS_TILES)
        err = lib.aha_quant_matmul_ws(
            x2.data_ptr(), q4value.data_ptr(), scale4.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), M, K, N, K // scale4.shape[0], 4, pl.splits,
            pl.tile, ctypes.c_void_p(torch.cuda.current_stream(x2.device).cuda_stream))
        _build.check(lib, err, "int4_matmul")
        return
    err = lib.aha_int4_matmul(
        x2.data_ptr(), None if sx is None else sx.data_ptr(), q4value.data_ptr(),
        scale4.data_ptr(), y.data_ptr(), None if ws is None else ws.data_ptr(),
        M, K, N, K // scale4.shape[0], _BF16X3 if planes else _DTYPES[x2.dtype],
        _DTYPES[y.dtype], pl.splits, pl.path,
        pl.tile, ctypes.c_void_p(torch.cuda.current_stream(x2.device).cuda_stream))
    _build.check(lib, err, "int4_matmul")


class _Int4QLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q4value, scale4):
        ctx.save_for_backward(q4value, scale4)
        return int4_matmul(x, q4value, scale4)

    @staticmethod
    def backward(ctx, grad):
        from .int4_matmul_t import int4_matmul_t   # it imports unpack_int4 from here

        q4value, scale4 = ctx.saved_tensors
        return int4_matmul_t(grad.contiguous(), q4value, scale4), None, None


def int4_qlinear(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """``int4_matmul(x, q4value, scale4)`` (weight-only) that autograd can
    differentiate with respect to ``x``: the backward launches
    ``int4_matmul_t`` on the incoming gradient. The packed weight and its
    scales are frozen and get no gradient."""
    return _Int4QLinear.apply(x, q4value, scale4)
