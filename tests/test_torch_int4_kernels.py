"""The int4 products' tensor-core kernels, as far as a CPU can hold them: the
wrappers' pure choice of path, token tile, ring, splits and shared memory for
every shape ``chip_smoke.py`` drives; the relabelling of accumulator rows that
the wgmma kernels apply at their stores and of weight columns in the decode
kernel (1 .. 16 rows), whose unpacked registers are checked bit for bit; the
forward kernels' orders of sums (f32 group sums over 16-deep pieces, f32 x as
three bf16 planes a piece, the group's scale, groups and K splits added)
emulated in plain PyTorch against the Pallas kernel in interpret mode, and the
three-plane product of f32 x against the plain version and JAX's kernel; and
what the wrappers refuse. The kernels themselves run only on the card
(``chip_smoke.py`` phase 2 holds them against the plain versions there)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops.pallas.fused_matmul import int4_matmul as j_int4_matmul
from aha_tpu.ops.quant import quantize_array_int4

from aha_tpu_torch import bridge
from aha_tpu_torch.ops.kernels import int4_matmul as k4
from aha_tpu_torch.ops.kernels import int4_matmul_t as kt
from aha_tpu_torch.ops.kernels.int8_matmul import SCALAR, TENSOR_CORE, VEC16, WGMMA
from aha_tpu_torch.ops.kernels.quantize_rows import split_bf16x3_plain

SMEM = 232448          # bytes of shared memory a block may use on an H100
LM_HEAD = (3584, 152064)
PROJECTOR = ((1024, 3584), (3584, 3584))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    """``chip_smoke.py`` as a module: its shape lists are the 7B paths' shapes."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return bridge.tensor_from_numpy(np.asarray(x))


def _shapes(M):
    """(K, N) of every product the paths run at M rows."""
    smoke = _smoke()
    shapes = [(K, N) for _, K, N in smoke.LAYER]
    if M in (1, 4, 8):
        shapes.append(LM_HEAD)
    if M in (392, 1568):
        shapes = list(PROJECTOR)
    return shapes


def _rows():
    smoke = _smoke()
    return sorted({*smoke.PATH_M, 5, 9, smoke.TRAIN_T, 392, 1568})


@pytest.mark.parametrize("M", _rows())
def test_forward_plan_of_every_path_shape(M):
    """bf16, G 128, aligned: 1 to 16 rows on the decode kernel, from WS_MIN_M
    rows (171, 196, 220, 392, training's 926, 1,568) on the warp-specialised
    kernel (``test_ws_plan_of_every_7b_shape`` holds its plans), in between on
    the wgmma kernel, with a token tile
    that is a multiple of 8, at most 80 (two accumulator sets) and so at most
    the 256 a warpgroup product takes, tiles that cover M once, whole groups a
    split, and a ring that fits a block's shared memory twice on an SM."""
    for K, N in _shapes(M):
        pl = k4.plan(M, K, N, 128, bf16=True)
        if M <= k4.DECODE_MAX_M:
            assert pl == k4.plan(1, K, N, 128, bf16=True), (M, K, N)
            assert pl.path == k4.DECODE, (M, K, N)
            continue
        if M >= k4.WS_MIN_M:
            assert pl.path == k4.WGMMA_WS and pl == k4.ws_plan(M, K, N, 128, 132), (M, K, N)
            continue
        assert pl.path == k4.WGMMA and pl == k4.wgmma_plan(M, K, N, 128), (M, K, N)
        assert pl.tile % 8 == 0 and 8 <= pl.tile <= k4.WGMMA_TILE_CAP <= 256
        assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
        assert pl.stages >= 3
        assert pl.smem_bytes == pl.stages * (pl.tile * 128 + 6144) + 1024
        assert 2 * (pl.smem_bytes + 1024) <= SMEM
        groups = K // 128
        assert 1 <= pl.splits <= groups
        per_split = -(-groups // pl.splits)
        assert per_split * (pl.splits - 1) < groups          # no split is empty
        if pl.tiles * -(-N // 128) < 2 * 132:
            assert per_split >= 4 or pl.splits == 1
        else:
            assert pl.splits == 1 or K // 64 // pl.splits >= 64


@pytest.mark.parametrize("M,K,N,G,kw,path", [
    (70, 320, 132, 64, dict(bf16=True), SCALAR),                     # N not a multiple of 8
    (70, 320, 136, 32, dict(bf16=True), TENSOR_CORE),                # G 32: mma.sync
    (70, 320, 136, 64, dict(bf16=True), TENSOR_CORE),                # N not a multiple of 16
    (70, 320, 136, 24, dict(bf16=True), SCALAR),                     # G not a multiple of 16
    (70, 320, 144, 40, dict(bf16=True), VEC16),                      # G not a multiple of 16
    (926, 3584, 4608, 128, dict(bf16=False, align=(8, 16, 16)), VEC16),   # f32, x 8 bytes off
    (926, 3584, 4608, 128, dict(bf16=False, a8=True), TENSOR_CORE),  # int8 x, an f32 output
    (926, 3584, 4608, 128, dict(bf16=True, align=(8, 16, 16)), VEC16),
    (926, 3584, 4608, 128, dict(bf16=True, align=(16, 8, 16)), TENSOR_CORE),
    (13, 3584, 4608, 128, dict(bf16=False, a8=True), TENSOR_CORE),   # the same at 13 rows
    (1, 3584, 4608, 128, dict(bf16=False), VEC16),                   # a token in f32
    (8, 3584, 4608, 32, dict(bf16=True), TENSOR_CORE),               # decode rows at G 32
    (8, 320, 136, 64, dict(bf16=True), TENSOR_CORE),                 # N not a multiple of 16
    (8, 320, 132, 64, dict(bf16=True), SCALAR),                      # N not a multiple of 8
    (8, 3584, 4608, 128, dict(bf16=True, align=(8, 16, 16)), VEC16),   # a misaligned x
    (8, 3584, 4608, 128, dict(bf16=True, align=(16, 16, 8)), TENSOR_CORE),   # misaligned scales
    (1, 3584, 4608, 128, dict(bf16=False, a8=True), VEC16),          # the same at a token
])
def test_forward_plan_keeps_the_earlier_paths(M, K, N, G, kw, path):
    """(Aligned f32 x at 926 rows, once the sixth case here, takes the wgmma
    kernel since its three-plane operand came: it moved to
    ``test_f32_plan_takes_the_wgmma_kernel_from_17_rows``, and the misaligned
    f32 x took its place.)"""
    pl = k4.plan(M, K, N, G, **kw)
    assert pl.path == path and pl.tile == 0 and pl.smem_bytes == 0 and pl.splits >= 1


@pytest.mark.parametrize("M,K,N,G,kw,path", [
    (926, 3584, 4608, 128, dict(bf16=False), WGMMA),                 # f32
    (16, 3584, 4608, 128, dict(bf16=False), VEC16),                  # the last decode row
    (17, 3584, 4608, 128, dict(bf16=False), WGMMA),                  # the first wgmma row
    (17, 18944, 3584, 128, dict(bf16=False), WGMMA),
    (49, 3584, 4608, 128, dict(bf16=False), WGMMA),                  # a frame chunk in f32
    (196, 3584, 37888, 128, dict(bf16=False), WGMMA),                # a fused pass in f32
    (196, 18944, 3584, 64, dict(bf16=False), WGMMA),                 # G 64
    (49, 3584, 4608, 256, dict(bf16=False), WGMMA),                  # G 256
    (49, 320, 144, 32, dict(bf16=False), VEC16),                     # G 32
    (49, 320, 132, 64, dict(bf16=False), SCALAR),                    # N not a multiple of 8
    (49, 3584, 4608, 128, dict(bf16=False, a8=True), TENSOR_CORE),   # int8 x, f32 output
])
def test_f32_plan_takes_the_wgmma_kernel_from_17_rows(M, K, N, G, kw, path):
    """f32 x weight-only takes the wgmma kernel from 17 rows under the bf16
    path's conditions (G % 64, N % 16, 16-byte aligned operands), as three bf16
    planes: token tiles of 24 to 64 rows, the ring two blocks an SM leave room
    for (three to six slots), whole groups a split; 1 to 16 f32 rows and shapes
    the kernel does not take keep the earlier paths."""
    pl = k4.plan(M, K, N, G, **kw)
    assert pl.path == path
    if path != WGMMA:
        assert pl.tile == 0 and pl.smem_bytes == 0
        return
    assert pl == k4.x3_plan(M, K, N, G, 132)
    assert pl.tile in k4.X3_TILES and (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
    assert 3 <= pl.stages == k4.wgmma_stages(pl.tile, 3) <= 6
    assert pl.smem_bytes == pl.stages * (3 * pl.tile * 128 + 6144) + 1024 <= SMEM
    assert 2 * (pl.smem_bytes + 1024) <= k4.SMEM_PER_SM
    assert 1 <= pl.splits <= K // G


@pytest.mark.parametrize("M", [17, 49, 59, 171, 196, 220])
def test_f32_plan_of_every_path_shape(M):
    """Every f32 product a peft artifact's f32 frame chunks hand int4_matmul
    from 17 rows (the layer's four at ``chip_smoke.py``'s f32 rows, G 128):
    the wgmma kernel at the three-plane tiles."""
    for _, K, N in _smoke().LAYER:
        pl = k4.plan(M, K, N, 128, bf16=False)
        assert pl.path == WGMMA and pl.tile in k4.X3_TILES, (M, K, N)
        assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile


@pytest.mark.parametrize("M", [1, 127, 128, 129, 196, 233, 926, 1568])
def test_transposed_plan(M):
    smoke = _smoke()
    for _, K, N in smoke.LAYER:
        pl = kt.plan(M, K, N, 128, bf16=True)
        assert pl.path == kt.WGMMA and pl.splits == 1
        assert pl.tile % 8 == 0 and 8 <= pl.tile <= 128
        assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
        assert pl.smem_bytes == pl.stages * (pl.tile * 128 + 11264) + 1024 <= SMEM
    assert kt.plan(M, 136, 320, 68, bf16=True).path == TENSOR_CORE    # G not a multiple of 64
    assert kt.plan(M, 256, 96, 64, bf16=True).path == TENSOR_CORE     # N not a multiple of 64
    assert kt.plan(M, 64, 50, 64, bf16=True).path == 0                # ragged N
    assert kt.plan(M, 3584, 4608, 128, bf16=False).path == 0          # f32
    assert kt.plan(M, 3584, 4608, 128, bf16=True, aligned=False).path == 0


def test_token_tiles():
    assert k4.token_tile(926, 80) == (80, 12)
    assert k4.token_tile(926, 128) == (120, 8)
    assert k4.token_tile(196, 80) == (72, 3)
    assert k4.token_tile(49, 80) == (56, 1)
    for M in range(1, 700):
        for cap in (64, 80, 128):
            tile, tiles = k4.token_tile(M, cap)
            assert tile % 8 == 0 and tile <= cap and (tiles - 1) * tile < M <= tiles * tile


def test_transposed_rows_are_relabelled_not_moved():
    """The thread whose operand registers hold accumulator rows gid and gid + 8
    of warp w fills them with the low and the high nibbles of packed row
    8 w + gid of the slab: the plain index map is a permutation of each 64-row
    slab and sends packed row j to dx columns 2 j and 2 j + 1."""
    for slab in range(2):
        rows = range(64 * slab, 64 * slab + 64)
        assert sorted(kt.row_to_column(r) for r in rows) == list(rows)
        for w in range(4):
            for gid in range(8):
                j = 32 * slab + 8 * w + gid
                low, high = 64 * slab + 16 * w + gid, 64 * slab + 16 * w + gid + 8
                assert kt.row_to_column(low) == 2 * j
                assert kt.row_to_column(high) == 2 * j + 1


def test_forward_rows_are_relabelled_not_moved():
    """A thread's four accumulator rows (gid and gid + 8 in both slabs) are
    four neighbouring weight columns, 4-byte words of the packed rows."""
    assert sorted(k4.fwd_row_to_column(r) for r in range(128)) == list(range(128))
    for w in range(4):
        for gid in range(8):
            rows = (16 * w + gid, 16 * w + gid + 8, 64 + 16 * w + gid, 64 + 16 * w + gid + 8)
            first = 4 * (8 * w + gid)
            assert [k4.fwd_row_to_column(r) for r in rows] == [first, first + 1, first + 2,
                                                               first + 3]


# ---- the warp-specialised kernel (bf16 x weight-only from WS_MIN_M rows) ----------------

def _ws_shapes():
    """(M, K, N) of every int4 product the paths hand the warp-specialised
    kernel: the layer at the prompt's 171 rows, a fused pass's 196 and 220, B
    8's frame step (392) and fused pass (1,568), training's 926, 1,024 and
    2,048; the projector at 392 and 1,568."""
    smoke = _smoke()
    out = [(M, K, N) for M in (171, 196, 220, 392, 926, 1024, 1568, 2048)
           for _, K, N in smoke.LAYER]
    return out + [(M, K, N) for M in (392, 1568) for K, N in PROJECTOR]


@pytest.mark.parametrize("M,K,N", _ws_shapes())
def test_ws_plan_of_every_7b_shape(M, K, N):
    """From WS_MIN_M rows, G 128: the warp-specialised kernel at a token tile of
    64 .. 160 rows (a multiple of 16: the group's sums and the totals take T
    registers), tiles that cover M once, K split into whole groups with none
    empty, a ring of 3 .. 6 slots of 6 KB of raw bytes and scales beside the x
    tile that fits a block's 227 KB with its barriers, the launch of least
    estimated time."""
    pl = k4.plan(M, K, N, 128, bf16=True)
    assert pl.path == k4.WGMMA_WS and M >= k4.WS_MIN_M
    assert pl.tile in k4.WS_TILES and pl.tile % 16 == 0 and 64 <= pl.tile <= 160
    assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
    groups = K // 128
    per = -(-groups // pl.splits)
    assert 1 <= pl.splits <= min(16, groups) and per * (pl.splits - 1) < groups
    assert (pl.stages, pl.smem_bytes) == k4.ws_ring(pl.tile, 4)
    assert 3 <= pl.stages <= 6
    assert pl.smem_bytes == pl.stages * (pl.tile * 128 + 6144) + 1024
    assert pl.smem_bytes + 2 * 6 * 8 <= SMEM
    assert (pl.tile, pl.tiles, pl.splits) == k4.ws_launch(M, K // 64, N, 132, k4.WS_TILES, 2)


@pytest.mark.parametrize("M,K,N,G,kw,path", [
    (k4.WS_MIN_M - 1, 3584, 4608, 128, dict(bf16=True), WGMMA),       # below the threshold
    (k4.WS_MIN_M, 3584, 4608, 128, dict(bf16=True), k4.WGMMA_WS),     # the threshold
    (k4.WS_MIN_M, 3584, 4608, 64, dict(bf16=True), k4.WGMMA_WS),      # G 64
    (k4.WS_MIN_M, 3584, 4608, 128, dict(bf16=True, a8=True), WGMMA),  # int8 x
    (k4.WS_MIN_M, 3584, 4608, 128, dict(bf16=False), WGMMA),          # f32 x: three planes
    (k4.WS_MIN_M, 320, 136, 64, dict(bf16=True), TENSOR_CORE),        # N not a multiple of 16
    (k4.WS_MIN_M, 320, 256, 32, dict(bf16=True), TENSOR_CORE),        # G 32
])
def test_ws_threshold(M, K, N, G, kw, path):
    """bf16 x weight-only takes the warp-specialised kernel from WS_MIN_M rows
    under the Hopper paths' conditions; below it, with int8 or f32 x, and for
    shapes those paths do not take, the plan is the one it was."""
    assert k4.plan(M, K, N, G, **kw).path == path


def _ws_pair(v: int, sel: int) -> tuple[int, int]:
    """The warp-specialised consumer's two columns of one packed word, as in
    csrc/quant_matmul_ws.cu: low and high nibbles beside 0x43 by the byte
    selector, less the bf16 pair (136, 136), sorted by column: (column 0's
    pair, column 1's pair) as 32-bit words."""
    lo, hi = v & 0x0F0F0F0F, (v >> 4) & 0x0F0F0F0F

    def minus_136(word):
        halves = np.array([word & 0xFFFF, word >> 16], dtype=np.uint32) << 16
        vals = halves.view(np.float32) - np.float32(136.0)
        bits = (vals.view(np.uint32) >> 16).astype(np.uint32)
        assert np.array_equal((bits << 16).view(np.float32), vals)   # exact in bf16
        return int(bits[0]) | (int(bits[1]) << 16)

    even = minus_136(_byte_perm(lo, 0x43434343, sel))
    odd = minus_136(_byte_perm(hi, 0x43434343, sel))
    return _byte_perm(even, odd, 0x5410), _byte_perm(even, odd, 0x7632)


def _bf16_pair(word: int) -> tuple[float, float]:
    halves = np.array([word & 0xFFFF, word >> 16], dtype=np.uint32) << 16
    return tuple(float(h) for h in halves.view(np.float32))


def test_ws_operand_registers_are_the_weight_piece():
    """A stage's packed rows as the producer's 16-byte copies lay them (thread
    t, copy i: row (t + 128 i) // 8, chunk (t + 128 i) % 8, rows 160 bytes
    apart); consumer c's thread reads packed rows tig + 4 q at column word 8 w +
    gid and unpacks bytes 2 c and 2 c + 1: the registers of each piece hold, at
    wgmma's positions, the unpacked values of columns ws_column(c, w, gid) and
    the next at K rows 16 p + 2 tig (+ 8) and the next; every value of the
    stage once. Each of a warp's word reads meets 32 banks."""
    rng = np.random.default_rng(9)
    stage = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 32 * 128)).reshape(32, 128)
    w = k4.unpack_int4(torch.from_numpy(stage)).numpy()          # [64, 128]
    raw = np.zeros(32 * 160, dtype=np.uint8)
    for t in range(128):
        for i in range(2):
            idx = t + 128 * i
            row, chunk = idx // 8, idx % 8
            raw[row * 160 + 16 * chunk:row * 160 + 16 * chunk + 16] = \
                stage[row, 16 * chunk:16 * chunk + 16]
    seen = np.zeros_like(w, dtype=bool)
    for c in range(2):
        sel = 0x4342 if c else 0x4140
        for warp in range(4):
            for q in range(8):
                banks = {((tig + 4 * q) * 160 + 4 * (8 * warp + gid)) // 4 % 32
                         for gid in range(8) for tig in range(4)}
                assert len(banks) == 32
            for gid in range(8):
                for tig in range(4):
                    for q in range(8):
                        off = (tig + 4 * q) * 160 + 4 * (8 * warp + gid)
                        word = int(raw[off:off + 4].view(np.uint32)[0])
                        k = 2 * (tig + 4 * q)      # = 16 p + 2 tig + 8 (q % 2), p = q // 2
                        for e, reg in enumerate(_ws_pair(word, sel)):
                            col = k4.ws_column(c, warp, gid) + e
                            assert _bf16_pair(reg) == (w[k, col], w[k + 1, col])
                            seen[k:k + 2, col] = True
    assert seen.all()


@pytest.mark.parametrize("splits", ["plan", 1, 3])
def test_ws_order_of_sums(splits):
    """The warp-specialised kernel adds as the decode kernel does: a split's
    whole groups in order, a group's 16-deep pieces into its f32 sum, the sum
    times its scale into the split's total by one fused multiply-add, the
    splits in order, one cast (``decode_forward_emulated``), here at the splits
    its plan gives 232 rows of a narrow product (and at 1 and 3): within the
    card's 1e-2 of the largest value of JAX's kernel in interpret mode and one
    bf16 step of the plain version."""
    rng = np.random.default_rng(29)
    M, K, N, G = 232, 768, 256, 128
    pl = k4.plan(M, K, N, G, bf16=True)
    assert pl.path == k4.WGMMA_WS
    n = pl.splits if splits == "plan" else splits
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q4 = quantize_array_int4(jnp.asarray(w), 0, group=G)
    ref = np.asarray(j_int4_matmul(jnp.asarray(x).astype(jnp.bfloat16), q4["q4value"],
                                   q4["scale4"], interpret=True).astype(jnp.float32))
    xt = _t(x).to(torch.bfloat16)
    q, s = _t(q4["q4value"]), _t(q4["scale4"])
    out = decode_forward_emulated(xt, q, s, n).float().numpy()
    plain = k4.int4_matmul_plain(xt, q, s).float().numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    assert np.abs(out - plain).max() <= np.abs(plain).max() * 2.0 ** -8


def wgmma_forward_emulated(x, q4value, scale4):
    """The wgmma kernel's order of sums: per group the 16-deep pieces' products
    added one after the other in f32 (f32 x: its three bf16 planes hi, mid and
    lo, piece by piece, each plane's piece after the other), the group's sum
    times its scale as f32, the groups added in f32, one cast."""
    K = x.shape[-1]
    groups = scale4.shape[0]
    G = K // groups
    w = k4.unpack_int4(q4value).float()
    x2 = x.reshape(-1, K)
    planes = split_bf16x3_plain(x2).float() if x.dtype == torch.float32 else x2.float()[None]
    tot = torch.zeros((x2.shape[0], w.shape[1]), dtype=torch.float32)
    for g in range(groups):
        grp = torch.zeros_like(tot)
        for k0 in range(g * G, (g + 1) * G, 16):
            for plane in planes:
                grp = grp + plane[:, k0:k0 + 16] @ w[k0:k0 + 16]
        tot = tot + grp * scale4[g].float()
    return tot.to(x.dtype).reshape(*x.shape[:-1], -1)


def _tricky_f32(rng, M, K):
    """``test_torch_int8_kernels.tricky_f32``: mixed exponents, bf16 ties and
    ties moved one f32 step, zeros."""
    x = (rng.standard_normal((M, K)) * 2.0 ** rng.integers(-20, 21, (M, K))).astype(np.float32)
    b = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    _, e = np.frexp(b)
    tie = (b + np.sign(b) * np.ldexp(1.0, e - 9)).astype(np.float32)
    moved = np.nextafter(tie, np.where(rng.random((M, K)) < 0.5, np.inf, -np.inf).astype(
        np.float32)).astype(np.float32)
    which = rng.integers(0, 6, (M, K))
    x = np.where(which == 0, tie, np.where(which == 1, moved, x))
    x[rng.random((M, K)) < 0.02] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("M", [17, 49, 196])
def test_f32_three_plane_product_matches_plain_and_jax(M, group):
    """The product the f32 wgmma path computes (``int4_matmul_x3_plain``: the
    three planes' products added in a group's f32 sum before its bf16 scale;
    and the kernel's order of sums in ``wgmma_forward_emulated``) on
    activations of mixed exponents and bf16 ties, against the plain version and
    JAX's kernel in interpret mode with f32 x, within 1e-5 of the largest
    output."""
    rng = np.random.default_rng(200 + M + group)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = _tricky_f32(rng, M, K)
    q4 = quantize_array_int4(jnp.asarray(w), 0, group=group)
    ref = np.asarray(j_int4_matmul(jnp.asarray(x), q4["q4value"], q4["scale4"], interpret=True))
    xt, q, s = _t(x), _t(q4["q4value"]), _t(q4["scale4"])
    plain = k4.int4_matmul_plain(xt, q, s).numpy()
    x3 = k4.int4_matmul_x3_plain(xt, q, s)
    emulated = wgmma_forward_emulated(xt, q, s)
    assert x3.dtype == emulated.dtype == torch.float32 and x3.shape == (M, N)
    tol = 1e-5 * np.abs(ref).max()
    for got in (x3.numpy(), emulated.numpy()):
        assert np.abs(got - plain).max() <= tol
        assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("what,match", [
    ("decode", "and a bf16 output; got torch.bfloat16 x without row scales and a torch.float32"),
    ("bf16-out", "and a bf16 output; got torch.bfloat16 x without row scales and a torch.bfloat16"),
    ("tile", "the f32 wgmma path takes token tiles"),
])
def test_launch_plan_refuses_planes_the_kernel_does_not_take(what, match):
    """An f32 x's three planes on the decode path, with a bf16 output, or at a
    token tile the three-plane kernel is not built for (72) raise before any
    library is built or launched."""
    M, K, N, G = 49, 128, 32, 64
    planes = split_bf16x3_plain(torch.zeros((M, K)))
    q = torch.zeros((K // 2, N), dtype=torch.uint8)
    s = torch.ones((K // G, N), dtype=torch.bfloat16)
    y = torch.empty((M, N), dtype=torch.bfloat16 if what == "bf16-out" else torch.float32)
    if what == "decode":
        pl = k4.Plan(k4.DECODE, 1, 16, 1, 7, k4.DECODE_SMEM)
    else:
        tile = 72 if what == "tile" else 56
        stages = k4.wgmma_stages(tile, 3)
        pl = k4.Plan(WGMMA, 1, tile, 1, stages,
                     stages * k4.wgmma_stage_bytes(tile, planes=3) + 1024)
    with pytest.raises(ValueError, match=match):
        k4.launch_plan(planes, None, q, s, y, pl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 21, 232])
@pytest.mark.parametrize("group", [128, 256])
def test_forward_order_of_sums(group, M, dtype):
    """f32: 3e-5 against the Pallas kernel in interpret mode (f32 sums in another
    order). bf16 activations: the card's tolerance, 1e-2 of the largest value;
    against the plain version, which rounds at the same places, 3e-5 in f32 and
    one bf16 step."""
    rng = np.random.default_rng(7)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q4 = quantize_array_int4(jnp.asarray(w), 0, group=group)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(j_int4_matmul(jx, q4["q4value"], q4["scale4"], interpret=True)
                     .astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype))
    q, s = _t(q4["q4value"]), _t(q4["scale4"])
    out = wgmma_forward_emulated(xt, q, s)
    plain = k4.int4_matmul_plain(xt, q, s)
    assert out.shape == (M, N) and out.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=3e-5, atol=3e-5)
    else:
        assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
        step = np.abs(plain.float().numpy()).max() * 2.0 ** -8
        assert np.abs(out.float().numpy() - plain.float().numpy()).max() <= step


@pytest.mark.parametrize("entry", ["int4_matmul", "int4_matmul_t"])
@pytest.mark.parametrize("what,match", [
    ("strided", "must be contiguous"),
    ("dtype", "dtype torch.float16 not supported"),
    ("weight", "weight must be uint8"),
    ("scale", "scale4 must be bf16"),
    ("group", "group size 1 must be even"),
])
def test_wrappers_refuse(entry, what, match):
    """What no path of the kernels takes raises in the wrapper's check, whatever
    the device (a CPU tensor goes to the plain version before the check)."""
    K, N = 64, 32
    a = torch.zeros((5, K if entry == "int4_matmul" else N), dtype=torch.bfloat16)
    q = torch.zeros((K // 2, N), dtype=torch.uint8)
    s = torch.zeros((K // 32, N), dtype=torch.bfloat16)
    if what == "strided":
        a = torch.cat([a, a], dim=-1)[:, :a.shape[1]]
    if what == "dtype":
        a = a.to(torch.float16)
    if what == "weight":
        q = q.to(torch.int8)
    if what == "scale":
        s = s.float()
    if what == "group":
        s = torch.zeros((K, N), dtype=torch.bfloat16)
    check = k4._check if entry == "int4_matmul" else kt._check
    with pytest.raises(ValueError, match=match):
        check(a, q, s)


def test_a_misaligned_view_keeps_off_the_wgmma_path():
    """A contiguous view that starts 2 bytes into its buffer is not refused:
    it takes a path that needs no 16-byte rows."""
    buf = torch.zeros(8 * 128 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(8, 128)
    assert x.is_contiguous() and k4._align(x) < 16 and k4._align(buf) == 16
    pl = k4.plan(926, 3584, 4608, 128, bf16=True, align=(k4._align(x), 16, 16))
    assert pl.path != k4.WGMMA
    assert kt.plan(926, 3584, 4608, 128, bf16=True, aligned=False).path != kt.WGMMA


# ---- the decode rows (1 .. 16): one kernel, one plan, one order of sums ------------------


def _decode_shapes():
    """(M, K, N) of every product a 7B path hands the decode path: rows 1-16 at
    the four layer products (a token, verify passes of 4 and 8 and their 5 and 9
    rows, the 13-row generation prompt), 1, 4 and 8 at the lm_head."""
    smoke = _smoke()
    out = [(M, K, N) for M in range(1, 17) for _, K, N in smoke.LAYER]
    return out + [(M, *LM_HEAD) for M in (1, 4, 8)]


@pytest.mark.parametrize("M,K,N", _decode_shapes())
def test_decode_plan_of_every_7b_shape(M, K, N):
    """bf16, G 128, aligned, 1 to 16 rows: the decode kernel, with the same
    splits at every M (a row gives the same bits alone or with 15 others),
    whole groups a split and none empty, a grid of one round of four blocks an
    SM on average where a small grid is split, four splits of a grid between
    that and a round (gate_up), and a ring that fits four times in an SM."""
    pl = k4.plan(M, K, N, 128, bf16=True)
    assert pl.path == k4.DECODE and pl == k4.plan(16, K, N, 128, bf16=True)
    groups, blocks = K // 128, -(-N // 128)
    per = -(-groups // pl.splits)
    assert 1 <= pl.splits <= groups and per * (pl.splits - 1) < groups
    half = k4.DECODE_BLOCKS_PER_SM * 132 // 2
    assert pl.splits == (4 if half < blocks <= 2 * half else 1) or (
        blocks <= half and blocks * pl.splits <= half)
    assert pl.smem_bytes == k4.DECODE_SMEM and 4 * (pl.smem_bytes + 1024) <= 233472
    expect = {4608: 7, 37888: 4, 152064: 1}.get(N, 9 if K == 18944 else 7)
    assert pl.splits == expect, (M, K, N, pl.splits)


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (nibble i of s) of the
    eight bytes x (0 .. 3), y (4 .. 7)."""
    b = (x | (y << 32)).to_bytes(8, "little")
    return int.from_bytes(bytes(b[(s >> (4 * i)) & 7] for i in range(4)), "little")


def _nibble_pair(v: int, t: int) -> tuple[float, float]:
    """The kernel's nibble_pair<t>(v, v >> 4), its bf16 halves as numbers:
    permute, mask beside 0x43, subtract the bf16 pair (136, 136)."""
    sel = t | (t << 4) | ((4 + t) << 8) | ((4 + t) << 12)
    biased = (_byte_perm(v, v >> 4, sel) & 0x000F000F) | 0x43004300
    halves = np.array([biased & 0xFFFF, biased >> 16], dtype=np.uint32) << 16
    return tuple(float(h) - 136.0 for h in halves.view(np.float32))


def test_decode_registers_are_the_piece_of_w_the_product_reads():
    """Every thread's B registers of a stage (32 packed rows of a block's 128
    columns) against the unpacked weight: register (piece p, n-tile t, b0 / b1)
    of thread (gid, tig) of warp w holds rows 16 p + 2 tig (+ 8) and the next of
    column decode_column(w, gid, t). The stage holds every byte value."""
    rng = np.random.default_rng(3)
    stage = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 32 * 128)).reshape(32, 128)
    assert len(np.unique(stage)) == 256
    w = k4.unpack_int4(torch.from_numpy(stage)).numpy()          # [64, 128]
    seen = np.zeros_like(w, dtype=bool)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            col0 = 32 * warp + 4 * gid
            wq = [int.from_bytes(stage[tig + 4 * q, col0:col0 + 4].tobytes(), "little")
                  for q in range(8)]
            for p in range(4):
                for t in range(4):
                    col = k4.decode_column(warp, gid, t)
                    for r, k in ((0, 16 * p + 2 * tig), (1, 16 * p + 2 * tig + 8)):
                        got = _nibble_pair(wq[2 * p + r], t)
                        assert got == (w[k, col], w[k + 1, col]), (warp, lane, p, t, r)
                        seen[k:k + 2, col] = True
    assert seen.all()


def test_decode_columns_are_relabelled_not_moved():
    """A warp's B columns (gid, n-tile t) are its 32 weight columns once each;
    a thread's accumulator elements (t, e) are column 2 tig + e of n-tile t,
    i.e. the eight neighbouring columns 32 w + 8 tig .. + 7 it stores."""
    for warp in range(4):
        cols = sorted(k4.decode_column(warp, j, t) for j in range(8) for t in range(4))
        assert cols == list(range(32 * warp, 32 * warp + 32))
        for tig in range(4):
            mine = sorted(k4.decode_column(warp, 2 * tig + e, t)
                          for t in range(4) for e in range(2))
            assert mine == list(range(32 * warp + 8 * tig, 32 * warp + 8 * tig + 8))


def decode_forward_emulated(x, q4value, scale4, splits):
    """The decode kernel's order of sums: a split's whole groups in order; per
    group the 16-deep pieces' exact sums added one after the other into a set
    of f32 group sums that starts at zero (the two alternating sets only change
    when each is scaled, not what is added); the group's sum times its scale
    added into the split's f32 total by one fused multiply-add; the splits'
    partials added in split order from zero; one cast."""
    K = x.shape[-1]
    groups = scale4.shape[0]
    G = K // groups
    per = -(-groups // splits)
    w = k4.unpack_int4(q4value).double()
    xd = x.reshape(-1, K).float().double()
    out = torch.zeros((xd.shape[0], w.shape[1]), dtype=torch.float32)
    for s in range(splits):
        tot = torch.zeros_like(out)
        for g in range(s * per, min(groups, (s + 1) * per)):
            grp = torch.zeros_like(tot)
            for k0 in range(g * G, (g + 1) * G, 16):
                # a piece's 16 products and their sum exact (in f64, as the tensor
                # cores keep them), rounded once into the f32 group sum
                grp = (grp.double() + xd[:, k0:k0 + 16] @ w[k0:k0 + 16]).float()
            tot = (tot.double() + grp.double() * scale4[g].double()).float()   # fmaf
        out = tot if splits == 1 else out + tot
    return out.to(x.dtype).reshape(*x.shape[:-1], -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 13, 16])
@pytest.mark.parametrize("group", [128, 256])
def test_decode_order_of_sums(group, M, dtype):
    """At the plan's splits for the shape (4 at G 128: whole groups, one each)
    and at one split: f32 within 3e-5 of the Pallas kernel in interpret mode and
    of the plain version; bf16 activations within 1e-2 of the largest value of
    the Pallas kernel and one bf16 step of the plain version; and row r of the
    M-row product equal, bit for bit, to the one-row product of row r."""
    rng = np.random.default_rng(11 + M)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q4 = quantize_array_int4(jnp.asarray(w), 0, group=group)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(j_int4_matmul(jx, q4["q4value"], q4["scale4"], interpret=True)
                     .astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype))
    q, s = _t(q4["q4value"]), _t(q4["scale4"])
    splits = k4.plan(M, K, N, group, bf16=True).splits
    assert splits == K // group   # one group a split
    plain = k4.int4_matmul_plain(xt, q, s)
    for n_split in sorted({splits, 1}):
        out = decode_forward_emulated(xt, q, s, n_split)
        assert out.shape == (M, N) and out.dtype == xt.dtype
        rows = torch.cat([decode_forward_emulated(xt[r:r + 1], q, s, n_split) for r in range(M)])
        assert torch.equal(out, rows)
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)
            np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=3e-5, atol=3e-5)
        else:
            assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
            step = np.abs(plain.float().numpy()).max() * 2.0 ** -8
            assert np.abs(out.float().numpy() - plain.float().numpy()).max() <= step


# ---- int8 activations (a8): the same two kernels on s8 tensor cores ---------------------

A8_ROWS = (1, 2, 3, 4, 5, 7, 8, 9, 13, 15, 16, 17, 23, 24, 25, 49, 59, 79, 80, 81, 171, 196,
           220, 231, 232, 233, 392, 1568)


def _a8_shapes(M):
    """(K, N) of every product the int4 ``fused_a8`` path hands int4_matmul at M
    rows (and the rows phase 2 adds around them): the layer's four, the lm_head at
    1, 4 and 8, the projector at 392 and 1568."""
    shapes = [(K, N) for _, K, N in _smoke().LAYER] if M != 1568 else []
    if M in (1, 4, 8):
        shapes.append(LM_HEAD)
    if M in (392, 1568):
        shapes += list(PROJECTOR)
    return shapes


@pytest.mark.parametrize("M", A8_ROWS)
def test_a8_plan_of_every_7b_shape(M):
    """bf16 x quantised to int8, G 128, aligned: 1 to 16 rows on the decode kernel
    with the weight-only plan's K splits but gate_up unsplit (from W's shape alone:
    the plan of one row and of 16 is the same) and a ring of seven 5,888-byte slots that fits four
    blocks an SM; from 17 rows on the wgmma kernel with a token tile among the s8
    widths up to 80, tiles that cover M once, the weight-only rule for K splits
    and a six-slot ring of 64-byte x rows that fits two blocks an SM."""
    for K, N in _a8_shapes(M):
        pl = k4.plan(M, K, N, 128, bf16=True, a8=True)
        # weight-only's plan on the same kernels (from WS_MIN_M rows weight-only
        # takes the warp-specialised kernel; int8 x stays on wgmma)
        w4 = (k4.plan(M, K, N, 128, bf16=True) if M <= k4.DECODE_MAX_M
              else k4.wgmma_plan(M, K, N, 128))
        if M <= k4.DECODE_MAX_M:
            assert pl.path == k4.DECODE and pl == k4.plan(1, K, N, 128, bf16=True, a8=True)
            # the weight-only plan's splits, but gate_up's grid (half a round to a round)
            # unsplit
            assert pl.splits == (1 if N == 37888 else w4.splits) and (pl.tile, pl.tiles) == (16, 1)
            assert pl.stages == 7 and pl.smem_bytes == k4.DECODE_SMEM_A8 == 7 * (
                16 * 64 + 32 * 144 + 256)
            assert 4 * (pl.smem_bytes + 1024) <= 233472
            continue
        assert pl.path == k4.WGMMA, (M, K, N)
        assert pl.tile in k4.WGMMA_A8_TILES == (24, 32, 48, 64, 80)
        assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
        assert pl.tile >= w4.tile and pl.tiles == w4.tiles or pl.tiles < w4.tiles
        assert pl.stages == 6 and pl.smem_bytes == 6 * (pl.tile * 64 + 5120) + 1024
        assert 2 * (pl.smem_bytes + 1024) <= 233472
        assert pl.splits == k4.wgmma_splits(132, pl.tiles * -(-N // 128), K // 128, K // 64)


@pytest.mark.parametrize("M,K,N,G,kw,path", [
    (926, 3584, 4608, 128, dict(bf16=True, a8=True), k4.WGMMA),       # was mma.sync
    (13, 3584, 4608, 128, dict(bf16=True, a8=True), k4.DECODE),       # was mma.sync
    (1, 3584, 4608, 128, dict(bf16=True, a8=True), k4.DECODE),        # was the CUDA cores
    (70, 320, 136, 64, dict(bf16=True, a8=True), TENSOR_CORE),        # N not a multiple of 16
    (8, 320, 136, 64, dict(bf16=True, a8=True), TENSOR_CORE),         # ... at decode rows
    (70, 320, 136, 32, dict(bf16=True, a8=True), TENSOR_CORE),        # G 32
    (8, 3584, 4608, 32, dict(bf16=True, a8=True), TENSOR_CORE),       # ... at decode rows
    (70, 320, 132, 64, dict(bf16=True, a8=True), SCALAR),             # N not a multiple of 8
    (49, 3584, 4608, 128, dict(bf16=True, a8=True, align=(8, 16, 16)), VEC16),   # misaligned xq
    (8, 3584, 4608, 128, dict(bf16=True, a8=True, align=(16, 16, 8)), TENSOR_CORE),
])
def test_a8_plan_takes_the_new_paths_and_keeps_the_earlier_ones(M, K, N, G, kw, path):
    """The three int8-activation shapes that the earlier paths took (now on the
    Hopper kernels), and what stays there besides an f32 output
    (test_forward_plan_keeps_the_earlier_paths): N not a multiple of 16, G not a
    multiple of 64, misaligned operands."""
    pl = k4.plan(M, K, N, G, **kw)
    assert pl.path == path and pl.splits >= 1
    assert (pl.smem_bytes > 0) == (path in (k4.WGMMA, k4.DECODE))


def _nibble_columns(h: int, a: int, b: int) -> tuple[int, int]:
    """``nibble_columns<H>`` of csrc/wgmma.cuh, step by step: a permute pairs
    columns 2 h, 2 h + 1 of the two words, two masks split the nibbles, two
    permutes sort them by column, n + 0x78 with the top bit flipped is n - 8."""
    p = _byte_perm(a, b, 0x7362 if h else 0x5140)
    lo, hi = p & 0x0F0F0F0F, (p >> 4) & 0x0F0F0F0F
    c0 = ((_byte_perm(lo, hi, 0x5140) + 0x78787878) & 0xFFFFFFFF) ^ 0x80808080
    c1 = ((_byte_perm(lo, hi, 0x7362) + 0x78787878) & 0xFFFFFFFF) ^ 0x80808080
    return c0, c1


def _s8_bytes(v: int) -> list[int]:
    return list(np.frombuffer(v.to_bytes(4, "little"), dtype=np.int8))


A8_W_ROW = 144   # bytes from one packed row of a stage to the next, int8 x (both kernels)


def _a8_words(stage: np.ndarray, tig: int, col0: int) -> list[int]:
    """A thread's eight words of a stage with int8 x: packed rows 2 tig + (q & 1) +
    8 (q >> 1) at its four columns col0 .. col0 + 3 (as the kernels' w_off)."""
    raw = np.zeros((32, A8_W_ROW), dtype=np.uint8)
    raw[:, :128] = stage
    flat = raw.reshape(-1).tobytes()
    base = 2 * tig * A8_W_ROW + col0
    return [int.from_bytes(flat[base + ((q & 1) + 8 * (q >> 1)) * A8_W_ROW:][:4], "little")
            for q in range(8)]


def _every_byte_packed_stage(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    stage = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 32 * 128)).reshape(32, 128)
    assert len(np.unique(stage)) == 256
    return stage


def test_a8_nibbles_become_exact_s8():
    """Every byte value in every position: nibble_columns gives each column's
    four K rows 2 r .. 2 r + 3 as nibble - 8, the lowest row in the lowest byte."""
    rng = np.random.default_rng(9)
    for _ in range(64):
        rows = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 8)).reshape(2, 4)
        a, b = (int.from_bytes(rows[i].tobytes(), "little") for i in range(2))
        w = k4.unpack_int4(torch.from_numpy(rows)).numpy()        # [4 K rows, 4 columns]
        for h in (0, 1):
            c0, c1 = _nibble_columns(h, a, b)
            assert _s8_bytes(c0) == list(w[:, 2 * h]) and _s8_bytes(c1) == list(w[:, 2 * h + 1])


def test_a8_wgmma_registers_are_the_piece_of_w():
    """Every thread's A registers of a stage (int8 x: W^T is the register operand
    of m64nNk32 s8), every byte value: register r of piece p for slab s holds four
    consecutive K rows of one weight column as s8, at the positions the s8 fragment
    names (row gid for registers 0 and 2, gid + 8 for 1 and 3; k 4 tig .. + 3 for 0
    and 1, 16 + 4 tig .. + 3 for 2 and 3): row r of slab s is weight column
    fwd_row_to_column(64 s + r), k is stage row 32 p + k."""
    stage = _every_byte_packed_stage(3)
    w = k4.unpack_int4(torch.from_numpy(stage)).numpy()            # [64, 128]
    seen = np.zeros(w.shape, dtype=int)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            wq = _a8_words(stage, tig, 4 * (8 * warp + gid))
            for slab in range(2):
                for p in range(2):
                    regs = [*_nibble_columns(slab, wq[4 * p], wq[4 * p + 1]),
                            *_nibble_columns(slab, wq[4 * p + 2], wq[4 * p + 3])]
                    for r, reg in enumerate(regs):
                        col = k4.fwd_row_to_column(64 * slab + 16 * warp + gid + 8 * (r & 1))
                        k = 32 * p + 4 * tig + 16 * (r >> 1)
                        assert _s8_bytes(reg) == list(w[k:k + 4, col]), (warp, lane, slab, p, r)
                        seen[k:k + 4, col] += 1
    assert (seen == 1).all()


def test_a8_decode_registers_are_the_piece_of_w():
    """Every thread's B registers of a stage on the decode path with int8 x
    (m16n8k32 s8), every byte value: b0 / b1 of n-tile t in piece p of thread
    (gid, tig) of warp w hold K rows 32 p + 4 tig .. + 3 / 32 p + 16 + 4 tig .. + 3
    of column decode_column(w, gid, t) as s8, the lowest row in the lowest byte."""
    stage = _every_byte_packed_stage(4)
    w = k4.unpack_int4(torch.from_numpy(stage)).numpy()
    seen = np.zeros(w.shape, dtype=int)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            wq = _a8_words(stage, tig, 32 * warp + 4 * gid)
            for p in range(2):
                b0 = [*_nibble_columns(0, wq[4 * p], wq[4 * p + 1]),
                      *_nibble_columns(1, wq[4 * p], wq[4 * p + 1])]
                b1 = [*_nibble_columns(0, wq[4 * p + 2], wq[4 * p + 3]),
                      *_nibble_columns(1, wq[4 * p + 2], wq[4 * p + 3])]
                for t in range(4):
                    col = k4.decode_column(warp, gid, t)
                    for reg, k in ((b0[t], 32 * p + 4 * tig), (b1[t], 32 * p + 16 + 4 * tig)):
                        assert _s8_bytes(reg) == list(w[k:k + 4, col]), (warp, lane, p, t)
                        seen[k:k + 4, col] += 1
    assert (seen == 1).all()


def test_a8_shared_reads_fall_in_distinct_banks():
    """With int8 x a thread reads packed rows 2 tig + c + 8 m: at the 144-byte
    stride the words a warp reads at once (its 32 threads, one word each) meet 32
    banks in both kernels, where the bf16 kernels' 160 bytes would put two on a
    bank; 144 keeps the 16-byte copies aligned. The decode kernel's x tile (16 rows
    of 64 bytes in the 64-byte swizzle) is read by ldmatrix without conflicts and
    every chunk lands once."""
    assert A8_W_ROW % 16 == 0 and k4._W_ROW[True] == A8_W_ROW
    for row_bytes, distinct in ((A8_W_ROW, 32), (160, 16)):
        for warp in range(4):
            for c in range(2):
                for m in range(4):
                    for col0 in (lambda g: 4 * (8 * warp + g), lambda g: 32 * warp + 4 * g):
                        banks = {((2 * tig + c + 8 * m) * row_bytes + col0(gid)) // 4 % 32
                                 for gid in range(8) for tig in range(4)}
                        assert len(banks) == distinct
    for p in range(2):
        for half in (0, 1):
            for rows in (range(8), range(8, 16)):
                spans = {(xr * 64 + (((2 * p + half) ^ ((xr >> 1) & 3)) << 4)) % 128 // 16
                         for xr in rows}
                assert len(spans) == 8
    assert len({(r, c ^ ((r >> 1) & 3)) for r in range(16) for c in range(4)}) == 64


def a8_emulated(x, q4value, scale4, splits, route="a"):
    """The int8-activation kernels' order of sums (decode and wgmma alike): x
    quantised per row (the plain quantiser, bit-equal to the kernel's); a group's
    exact int32 sum, route "a" on the nibbles as n - 8, route "b" on the nibbles as
    u8 minus 8 sum x over the group; made f32 once; in each K split of whole groups,
    in group order from zero, the f32 product with the group's scale rounded, then
    the f32 sum rounded; the splits' totals added in split order from zero; times
    the row scale; one cast."""
    K = x.shape[-1]
    groups = scale4.shape[0]
    G = K // groups
    per = -(-groups // splits)
    xq, sx = k4.quantize_rows_plain(x.reshape(-1, K))
    xl = xq.long().reshape(-1, groups, G)
    nib = k4.unpack_int4(q4value).long() + 8                       # 0 .. 15
    nib = nib.reshape(groups, G, -1)
    if route == "a":
        part = torch.einsum("mgk,gkn->mgn", xl, nib - 8)
    else:
        part = torch.einsum("mgk,gkn->mgn", xl, nib) - 8 * xl.sum(-1, keepdim=True)
    assert part.abs().max() < 2 ** 24
    part = part.float()
    out = torch.zeros((xl.shape[0], nib.shape[-1]), dtype=torch.float32)
    for s in range(splits):
        tot = torch.zeros_like(out)
        for g in range(s * per, min(groups, (s + 1) * per)):
            tot = tot + part[:, g] * scale4[g].float()
        out = out + tot
    return (out * sx).to(x.dtype).reshape(*x.shape[:-1], -1)


@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("M", [1, 5, 16, 21, 232])
def test_a8_order_of_sums(M, splits, group):
    """bf16 x, int8 activations, both Hopper kernels' order of sums: route (b)'s
    u8 nibbles with the group's correction equal route (a) bit for bit; within one
    bf16 step of int4_matmul_plain(a8=True); within the card's tolerance, 1e-2 of
    the largest value, of the Pallas kernel in interpret mode, and with one split
    equal to it bit for bit on every row whose scale XLA's compiled quantiser makes
    the IEEE quotient absmax / 127 (on others it is one ulp off); each row of the
    M-row product equal to its one-row product."""
    from aha_tpu.ops.pallas.fused_matmul import _quantize_rows

    rng = np.random.default_rng(17 + M + group)
    K, N = 768, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q4 = quantize_array_int4(jnp.asarray(w), 0, group=group)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(j_int4_matmul(jx, q4["q4value"], q4["scale4"], a8=True, interpret=True)
                     .astype(jnp.float32))
    xt = _t(x).to(torch.bfloat16)
    q, s = _t(q4["q4value"]), _t(q4["scale4"])
    out = a8_emulated(xt, q, s, splits)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert torch.equal(out, a8_emulated(xt, q, s, splits, route="b"))
    rows = torch.cat([a8_emulated(xt[r:r + 1], q, s, splits) for r in range(M)])
    assert torch.equal(out, rows)
    plain = k4.int4_matmul_plain(xt, q, s, a8=True).float().numpy()
    assert np.abs(out.float().numpy() - plain).max() <= np.abs(plain).max() * 2.0 ** -8
    assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
    if splits == 1:
        _, js = jax.jit(_quantize_rows)(jx)
        ieee = np.asarray(js).reshape(-1) == k4.quantize_rows_plain(xt)[1].numpy().reshape(-1)
        assert ieee.sum() >= M // 2
        np.testing.assert_array_equal(out.float().numpy()[ieee], ref[ieee])


@pytest.mark.parametrize("what,match", [
    ("a8-f32-out", "and a bf16 output; got torch.int8 x with row scales and a torch.float32"),
    ("a8-tile", "takes token tiles"),
    ("int8-x-without-scales", "got torch.int8 x without row scales"),
    ("bf16-x-with-scales", "got torch.bfloat16 x with row scales"),
    ("decode-rows", "takes at most 16 rows"),
])
def test_launch_plan_refuses_an_a8_plan_the_kernels_do_not_take(what, match):
    """A wgmma plan for int8 x with an f32 output, or with a token tile the s8
    product has no width for (40), int8 x without its row scales, bf16 x with row
    scales, and a decode plan of 17 rows raise before any library is built or
    launched."""
    M, K, N, G = (17 if what == "decode-rows" else 40), 128, 32, 64
    x = torch.zeros((M, K), dtype=torch.bfloat16 if what == "bf16-x-with-scales" else torch.int8)
    sx = None if what == "int8-x-without-scales" else torch.ones(M, 1)
    q = torch.zeros((K // 2, N), dtype=torch.uint8)
    s = torch.ones((K // G, N), dtype=torch.bfloat16)
    y = torch.empty((M, N), dtype=torch.float32 if what == "a8-f32-out" else torch.bfloat16)
    if what == "decode-rows":
        pl = k4.Plan(k4.DECODE, 1, 16, 1, 7, k4.DECODE_SMEM_A8)
    else:
        tile = 40 if what == "a8-tile" else 48
        pl = k4.Plan(k4.WGMMA, 1, tile, 1, 6, 6 * k4.wgmma_stage_bytes(tile, True) + 1024)
    with pytest.raises(ValueError, match=match):
        k4.launch_plan(x, sx, q, s, y, pl)
