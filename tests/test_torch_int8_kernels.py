"""The int8 product's tensor-core kernels (wgmma from 17 rows, the decode
kernel at 1 to 16), with bf16 x weight-only, with int8 x, and with f32 x as
three bf16 planes on the wgmma kernel, as far as a CPU can hold them: the
split of an f32 x into its planes (exact) and the product it models against
the plain version and JAX's kernel; the wrapper's pure choice of
path, token tile, ring, splits and shared memory for every shape
``chip_smoke.py`` drives; the relabelling of accumulator rows and of B columns
at their stores and the byte permutes and bf16 additions that build their
operand registers from int8 words; their orders of sums (16-deep pieces in f32,
K splits added in a fixed order, the scale once, one cast) emulated in plain
PyTorch against the Pallas kernel in interpret mode, with a decode row the same
bits at every M; and what the wrappers refuse. The kernels themselves run only
on the card (``chip_smoke.py`` phase 2 holds them against the plain version
there)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops.pallas.fused_matmul import int8_matmul as j_int8_matmul
from aha_tpu.ops.quant import quantize_array

from aha_tpu_torch import bridge
from aha_tpu_torch.ops.kernels import int8_matmul as k8
from aha_tpu_torch.ops.kernels.int8_matmul import DECODE, SCALAR, TENSOR_CORE, VEC16, WGMMA
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
    """(K, N) of every int8 product the paths run at M rows."""
    shapes = [(K, N) for _, K, N in _smoke().LAYER]
    if M in (1, 4, 8):
        shapes.append(LM_HEAD)
    if M in (392, 1568):
        shapes = list(PROJECTOR)
    return shapes


@pytest.mark.parametrize("M", sorted({*_smoke().PATH_M, 5, 9, 392, 1568}))
def test_plan_of_every_path_shape(M):
    """bf16, weight-only, aligned: 1 to 16 rows (a token, a verify pass, the
    generation prompt) on the decode kernel with the plan of 16 rows, from
    WS_MIN_M rows (the prompt's 171, a fused pass's 196 and 220, B 8's 392 and
    1,568) on the warp-specialised kernel (``test_ws_plan_of_every_7b_shape``
    holds its plans), every other row count on the wgmma kernel, with a token
    tile that is a multiple of 8 and at most the cap, tiles that cover M once, a
    ring of at least three slots that fits as many blocks as an SM holds, and K
    splits from the weight's shape alone (``row_free_splits``), as on the
    warp-specialised kernel, that keep a small grid in one round of resident
    blocks."""
    for K, N in _shapes(M):
        pl = k8.plan(M, K, N, bf16=True)
        if M <= k8.DECODE_MAX_M:
            assert pl.path == DECODE and pl == k8.plan(16, K, N, bf16=True), (M, K, N)
            continue
        if M >= k8.WS_MIN_M:
            assert pl.path == k8.WGMMA_WS and pl == k8.ws_plan(M, K, N, 132), (M, K, N)
            continue
        assert pl.path == WGMMA and pl == k8.wgmma_plan(M, K, N), (M, K, N)
        assert pl.tile % 8 == 0 and 8 <= pl.tile <= k8.WGMMA_TILE_CAP <= 128
        assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
        assert pl.stages >= 3
        assert (pl.stages, pl.smem_bytes) == k8.wgmma_ring(pl.tile)
        assert pl.smem_bytes == pl.stages * (pl.tile * 128 + 64 * 144) + 1024 <= SMEM
        assert k8.blocks_per_sm(pl.tile) * (pl.smem_bytes + 1024) <= k8.SMEM_PER_SM
        blocks, places = pl.tiles * -(-N // 128), k8.blocks_per_sm(pl.tile) * 132
        assert pl.splits == 1 or pl.splits * blocks <= places
        assert 1 <= pl.splits <= max(1, K // 512)
        assert pl.splits == k8.row_free_splits(K, N, 132)


def test_plan_of_the_frame_chunk():
    """49 rows are one token tile of 56, three blocks an SM; K is split as at a
    fused pass's 196 rows and B 8's 392 and 1,568 on the warp-specialised
    kernel, so that a frame's rows get the same bits in each: down (K 18,944)
    in two splits, qkv, o and gate_up in one."""
    got = {name: k8.plan(49, K, N, bf16=True) for name, K, N in _smoke().LAYER}
    assert {p.tile for p in got.values()} == {56} and {p.tiles for p in got.values()} == {1}
    assert k8.blocks_per_sm(56) == 3
    assert got["qkv"].splits == 1 and got["o_proj"].splits == 1
    assert got["down"].splits == 2 and got["gate_up"].splits == 1
    for name, K, N in _smoke().LAYER:
        for M in (196, 392, 1568):
            pl = k8.plan(M, K, N, bf16=True)
            assert pl.path == k8.WGMMA_WS and pl.splits == got[name].splits, (name, M)


def _weights():
    """(K, N) of every int8 weight on the 7B paths: the decoder layer's four,
    the projector's two, the int8 tower's three."""
    smoke = _smoke()
    return ([(K, N) for _, K, N in smoke.LAYER] + list(PROJECTOR)
            + [(K, N) for _, K, N in smoke.TOWER])


@pytest.mark.parametrize("K,N", _weights())
def test_row_free_splits_of_every_7b_weight(K, N):
    """bf16 x weight-only from 17 to ROW_FREE_MAX_M rows splits K alike at
    every row count, on the one-warpgroup and the warp-specialised kernel: a
    row's sums run in one order whatever the rows beside it. The count is the
    one of least estimated warp-specialised time summed over ROW_FREE_M, at
    most 16 whole stages. Above ROW_FREE_MAX_M (the tower's batches of 8
    frames and more) the launch of least estimate."""
    want = k8.row_free_splits(K, N, 132)
    stages = K // 64
    assert 1 <= want <= min(16, stages)
    cost = lambda n: sum(min(k8.ws_estimate(M, stages, N, 132, t, n) for t in k8.WS_TILES)
                         for M in k8.ROW_FREE_M)
    assert all(cost(want) <= cost(n) for n in range(1, min(16, stages) + 1))
    paths = set()
    for M in (17, 49, 64, 129, 170, 171, 196, 392, 576, 1568, 2048, k8.ROW_FREE_MAX_M):
        pl = k8.plan(M, K, N, bf16=True)
        assert pl.splits == want, (M, pl)
        paths.add(pl.path)
    assert paths == {WGMMA, k8.WGMMA_WS}
    for M in (k8.ROW_FREE_MAX_M + 1, 18432):
        pl = k8.plan(M, K, N, bf16=True)
        assert (pl.tile, pl.tiles, pl.splits) == k8.ws_launch(M, stages, N, 132, k8.WS_TILES)


@pytest.mark.parametrize("M,K,N,kw,path", [
    (1, 3584, 4608, dict(bf16=True, align=(8, 16, 16)), VEC16),      # a token, x 8 bytes off
    (49, 3584, 4608, dict(bf16=False, align=(8, 16, 16)), VEC16),    # f32, x 8 bytes off
    (49, 3584, 4608, dict(bf16=False, a8=True), TENSOR_CORE),        # int8 x, f32 output
    (1, 3584, 4608, dict(bf16=True, a8=True, align=(2, 16, 16)), VEC16),   # int8 x 2 bytes off
    (70, 320, 136, dict(bf16=True), TENSOR_CORE),                    # N not a multiple of 16
    (70, 352, 256, dict(bf16=True), TENSOR_CORE),                    # K not a multiple of 64
    (7, 100, 77, dict(bf16=True), SCALAR),                           # ragged
    (49, 3584, 4608, dict(bf16=True, align=(2, 16, 16)), VEC16),     # x 2 bytes off
    (49, 3584, 4608, dict(bf16=True, align=(16, 8, 16)), TENSOR_CORE),
    (49, 3584, 4608, dict(bf16=True, align=(16, 16, 8)), TENSOR_CORE),
    (5, 3584, 4608, dict(bf16=False), VEC16),                        # decode rows: f32
    (8, 3584, 4608, dict(bf16=True, a8=True, align=(16, 16, 8)), TENSOR_CORE),  # int8 x, scale off
    (8, 320, 136, dict(bf16=True), TENSOR_CORE),                     # N not a multiple of 16
    (8, 352, 256, dict(bf16=True), TENSOR_CORE),                     # K not a multiple of 64
    (4, 3584, 4608, dict(bf16=True, align=(2, 16, 16)), VEC16),      # x 2 bytes off
    (13, 3584, 4608, dict(bf16=True, align=(16, 16, 8)), TENSOR_CORE),  # scale 8 bytes off
    (49, 320, 136, dict(bf16=True, a8=True), TENSOR_CORE),           # int8 x, N % 16 != 0
    (8, 320, 136, dict(bf16=True, a8=True), TENSOR_CORE),
])
def test_plan_keeps_the_earlier_paths(M, K, N, kw, path):
    """What neither Hopper kernel takes keeps the earlier paths, at a token, at
    decode rows and above: for int8 activations an f32 output, N not a multiple
    of 16, operands off 16 bytes, f32 x at decode rows or off 16 bytes.
    (Aligned f32 x at 49 rows, once the second case here, takes the wgmma
    kernel since its three-plane operand came: it moved to
    ``test_f32_plan_takes_the_wgmma_kernel_from_17_rows``, and the misaligned
    f32 x took its place.)"""
    pl = k8.plan(M, K, N, **kw)
    assert pl.path == path and pl.tile == 0 and pl.smem_bytes == 0 and pl.splits >= 1


@pytest.mark.parametrize("M,K,N,kw,path", [
    (49, 3584, 4608, dict(bf16=False), WGMMA),                       # a frame chunk in f32
    (16, 3584, 4608, dict(bf16=False), VEC16),                       # the last decode row
    (17, 3584, 4608, dict(bf16=False), WGMMA),                       # the first wgmma row
    (17, 18944, 3584, dict(bf16=False), WGMMA),
    (196, 3584, 37888, dict(bf16=False), WGMMA),                     # a fused pass in f32
    (196, 18944, 3584, dict(bf16=False), WGMMA),
    (392, 1024, 3584, dict(bf16=False), WGMMA),                      # the projector's 8 frames
    (1, 3584, 152064, dict(bf16=False), VEC16),                      # the lm_head's row
    (49, 3584, 4608, dict(bf16=False, align=(16, 16, 8)), VEC16),    # scale 8 bytes off
    (49, 320, 136, dict(bf16=False), SCALAR),                        # N not a multiple of 16
    (49, 352, 256, dict(bf16=False), VEC16),                         # K not a multiple of 64
    (49, 3584, 4608, dict(bf16=False, a8=True), TENSOR_CORE),        # int8 x, f32 output
])
def test_f32_plan_takes_the_wgmma_kernel_from_17_rows(M, K, N, kw, path):
    """f32 x weight-only takes the wgmma kernel from 17 rows under the bf16
    path's conditions (K % 64, N % 16, 16-byte aligned operands), as three bf16
    planes: token tiles of 24 to 64 rows, two blocks an SM, a ring of three to
    six slots that the kernel's own count of shared memory matches; 1 to 16 f32
    rows, shapes the kernel does not take and int8 x with an f32 output keep
    the earlier paths."""
    pl = k8.plan(M, K, N, **kw)
    assert pl.path == path
    if path != WGMMA:
        assert pl.tile == 0 and pl.smem_bytes == 0
        return
    assert pl == k8.x3_plan(M, K, N, 132)
    assert pl.tile in k8.X3_TILES and (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
    assert 3 <= pl.stages <= 6 and (pl.stages, pl.smem_bytes) == k8.wgmma_ring(pl.tile, planes=3)
    assert pl.smem_bytes == pl.stages * (3 * pl.tile * 128 + 64 * 144) + 1024 <= SMEM
    assert k8.blocks_per_sm(pl.tile, 3) == 2
    assert 2 * (pl.smem_bytes + 1024) <= k8.SMEM_PER_SM
    blocks = pl.tiles * -(-N // 128)
    assert pl.splits == 1 or pl.splits * blocks <= 2 * 132


@pytest.mark.parametrize("M", [17, 49, 59, 171, 196, 220, 392])
def test_f32_plan_of_every_path_shape(M):
    """Every f32 product of phase 6's exact traces and of a peft artifact's f32
    frame chunks (``chip_smoke.py``'s ``f32_8``) from 17 rows: the wgmma kernel
    at the three-plane tiles."""
    for K, N in (_shapes(M) if M != 392 else list(PROJECTOR)):
        pl = k8.plan(M, K, N, bf16=False)
        assert pl.path == WGMMA and pl.tile in k8.X3_TILES, (M, K, N)
        assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile


def test_token_tiles_under_the_int8_cap():
    cap = k8.WGMMA_TILE_CAP
    assert k8.token_tile(49, cap) == (56, 1)
    assert k8.token_tile(196, cap) == (104, 2)
    assert k8.token_tile(233, cap) == (120, 2)
    assert k8.token_tile(1568, cap) == (128, 13)
    assert k8.token_tile(2, cap) == (8, 1)
    for tile in range(8, 129, 8):
        stages, smem = k8.wgmma_ring(tile)
        assert 3 <= stages <= 6 and k8.blocks_per_sm(tile) * (smem + 1024) <= k8.SMEM_PER_SM


def test_rows_are_relabelled_not_moved():
    """A thread's four accumulator rows (gid and gid + 8 in both slabs) are
    four neighbouring weight columns: one 32-bit word of a weight row."""
    assert sorted(k8.fwd_row_to_column(r) for r in range(128)) == list(range(128))
    for w in range(4):
        for gid in range(8):
            rows = (16 * w + gid, 16 * w + gid + 8, 64 + 16 * w + gid, 64 + 16 * w + gid + 8)
            first = 4 * (8 * w + gid)
            assert [k8.fwd_row_to_column(r) for r in rows] == [first, first + 1, first + 2,
                                                               first + 3]


# ---- the warp-specialised kernel (bf16 x weight-only from WS_MIN_M rows) ----------------

def _ws_shapes():
    """(M, K, N) of every int8 product the paths hand the warp-specialised
    kernel: the layer at the prompt's 171 rows, a fused pass's 196 and 220, B
    8's frame step (392) and fused pass (1,568), training's 926, 1,024 and
    2,048; the projector at 392 and 1,568; the int8 tower at a frame (576) and
    a vision batch (18,432)."""
    smoke = _smoke()
    out = [(M, K, N) for M in (171, 196, 220, 392, 926, 1024, 1568, 2048)
           for _, K, N in smoke.LAYER]
    out += [(M, K, N) for M in (392, 1568) for K, N in PROJECTOR]
    return out + [(M, K, N) for M in smoke.TOWER_M for _, K, N in smoke.TOWER]


@pytest.mark.parametrize("M,K,N", _ws_shapes())
def test_ws_plan_of_every_7b_shape(M, K, N):
    """From WS_MIN_M rows: the warp-specialised kernel at a token tile of 96 ..
    256 rows (a multiple of 16), tiles that cover M once, K split into whole
    64-row stages with none empty (16 splits at most), a ring of 3 .. 6 slots
    whose bytes the kernel counts alike and that fits a block's 227 KB beside
    its barriers, the launch of least estimated time (``ws_launch``) at the K
    splits of the weight's shape (``row_free_splits``) up to ROW_FREE_MAX_M
    rows."""
    pl = k8.plan(M, K, N, bf16=True)
    assert pl.path == k8.WGMMA_WS and M >= k8.WS_MIN_M
    assert pl.tile in k8.WS_TILES and pl.tile % 16 == 0 and 96 <= pl.tile <= 256
    assert (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
    stages = K // 64
    per = -(-stages // pl.splits)
    assert 1 <= pl.splits <= min(16, stages) and per * (pl.splits - 1) < stages
    assert (pl.stages, pl.smem_bytes) == k8.ws_ring(pl.tile, 8)
    assert 3 <= pl.stages <= 6
    assert pl.smem_bytes == pl.stages * (pl.tile * 128 + 64 * 144) + 1024
    assert pl.smem_bytes + 2 * 6 * 8 <= SMEM   # the ring, its alignment and the barriers
    assert (pl.tile, pl.tiles, pl.splits) == k8.ws_launch(
        M, stages, N, 132, k8.WS_TILES,
        splits=k8.row_free_splits(K, N, 132) if M <= k8.ROW_FREE_MAX_M else None)


@pytest.mark.parametrize("M,K,N,kw,path", [
    (k8.WS_MIN_M - 1, 3584, 4608, dict(bf16=True), WGMMA),           # below the threshold
    (k8.WS_MIN_M, 3584, 4608, dict(bf16=True), k8.WGMMA_WS),         # the threshold
    (k8.WS_MIN_M, 3584, 4608, dict(bf16=True, a8=True), WGMMA),      # int8 x
    (k8.WS_MIN_M, 3584, 4608, dict(bf16=False), WGMMA),              # f32 x: three planes
    (k8.WS_MIN_M, 3584, 4608, dict(bf16=True, align=(2, 16, 16)), VEC16),   # x 2 bytes off
    (k8.WS_MIN_M, 320, 136, dict(bf16=True), TENSOR_CORE),           # N not a multiple of 16
    (k8.WS_MIN_M, 352, 256, dict(bf16=True), TENSOR_CORE),           # K not a multiple of 64
    (49, 3584, 4608, dict(bf16=True), WGMMA),                        # the frame chunk
])
def test_ws_threshold(M, K, N, kw, path):
    """bf16 x weight-only takes the warp-specialised kernel from WS_MIN_M rows
    under the Hopper paths' conditions; below it, with int8 or f32 x, and for
    shapes or addresses those paths do not take, the plan is the one it was."""
    assert k8.plan(M, K, N, **kw).path == path


def test_ws_rows_are_relabelled_not_moved():
    """Consumer c of the warp-specialised kernel converts slab c: its thread's
    accumulator rows gid and gid + 8 of warp w are weight columns
    ws_column(c, w, gid) and the next, fwd_row_to_column of rows 64 c + 16 w +
    gid (+ 8); both consumers together hold the block's 128 columns once."""
    cols = []
    for c in range(2):
        for w in range(4):
            for gid in range(8):
                n = k8.ws_column(c, w, gid)
                assert n % 2 == 0
                for e in range(2):
                    assert k8.fwd_row_to_column(64 * c + 16 * w + gid + 8 * e) == n + e
                    cols.append(n + e)
    assert sorted(cols) == list(range(128))


def test_ws_operand_registers_are_the_weight_piece():
    """A stage's raw rows as the producer's 16-byte copies lay them (thread t,
    copy i: row (t + 128 i) // 8, chunk (t + 128 i) % 8, rows 144 bytes apart);
    consumer c's thread reads the words of rows 16 p + 2 tig + (0, 1, 8, 9) at
    column word 8 w + gid and builds each piece's four registers with pair_bf16
    at bytes 2 c and 2 c + 1: at wgmma's register positions they hold its
    relabelled rows' weight values. Each of a warp's word reads meets 32 banks,
    and a quarter-warp's copies are eight distinct 16-byte places of one row."""
    rng = np.random.default_rng(13)
    stage = rng.integers(-128, 128, (64, 128)).astype(np.int8)
    raw = np.zeros(64 * 144, dtype=np.uint8)
    for t in range(128):
        for i in range(4):
            idx = t + 128 * i
            row, chunk = idx // 8, idx % 8
            raw[row * 144 + 16 * chunk:row * 144 + 16 * chunk + 16] = \
                stage[row, 16 * chunk:16 * chunk + 16].view(np.uint8)
    for i in range(4):
        for q in range(16):
            idx = [8 * q + t + 128 * i for t in range(8)]
            assert len({j // 8 for j in idx}) == 1 and len({j % 8 for j in idx}) == 8
    for c in range(2):
        for warp in range(4):
            for p in range(4):
                for d in (0, 1, 8, 9):
                    banks = {((16 * p + 2 * tig + d) * 144 + 4 * (8 * warp + gid)) // 4 % 32
                             for gid in range(8) for tig in range(4)}
                    assert len(banks) == 32
            for gid in range(8):
                for tig in range(4):
                    off = 2 * tig * 144 + 4 * (8 * warp + gid)
                    for p in range(4):
                        wq = [int(raw[off + (16 * p + d) * 144:off + (16 * p + d) * 144 + 4]
                                  .view(np.uint32)[0]) for d in (0, 1, 8, 9)]
                        regs = [_pair_bf16(wq[0], wq[1], 2 * c), _pair_bf16(wq[0], wq[1], 2 * c + 1),
                                _pair_bf16(wq[2], wq[3], 2 * c), _pair_bf16(wq[2], wq[3], 2 * c + 1)]
                        for i, (e, k_off) in enumerate(((0, 0), (1, 0), (0, 8), (1, 8))):
                            col = k8.ws_column(c, warp, gid) + e
                            k = 16 * p + 2 * tig + k_off
                            assert regs[i] == (float(stage[k, col]), float(stage[k + 1, col]))


@pytest.mark.parametrize("splits", ["plan", 1, 3])
def test_ws_order_of_sums(splits):
    """The warp-specialised kernel adds as the wgmma kernel does (16-deep pieces
    in f32 over a split's whole stages, splits in order, the scale once, one
    cast): ``wgmma_emulated`` at the splits its plan gives 232 rows of a narrow
    product (and at 1 and 3), within the card's 1e-2 of the largest value of
    JAX's kernel in interpret mode and one bf16 step of the plain version."""
    rng = np.random.default_rng(23)
    M, K, N = 232, 512, 256
    pl = k8.plan(M, K, N, bf16=True)
    assert pl.path == k8.WGMMA_WS
    n = pl.splits if splits == "plan" else splits
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = quantize_array(jnp.asarray(w), 0)
    ref = np.asarray(j_int8_matmul(jnp.asarray(x).astype(jnp.bfloat16), q["qvalue"], q["scale"],
                                   interpret=True).astype(jnp.float32))
    xt = _t(x).to(torch.bfloat16)
    qv, s = _t(q["qvalue"]), _t(q["scale"])
    out = wgmma_emulated(xt, qv, s, n).float().numpy()
    plain = k8.int8_matmul_plain(xt, qv, s).float().numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    assert np.abs(out - plain).max() <= np.abs(plain).max() * 2.0 ** -8


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _pair_bf16(a: int, b: int, c: int) -> tuple[float, float]:
    """``pair_bf16<C>`` of csrc/int8_matmul.cu on two 32-bit words, step by
    step: the byte permute, the two masks, the bf16x2 addition (exact)."""
    sel = [c, c, 4 + c, 4 + c]
    src = a.to_bytes(4, "little") + b.to_bytes(4, "little")
    p = int.from_bytes(bytes(src[s] for s in sel), "little")
    low = (p & 0x007F007F) | 0x43004300
    high = (p & 0x00800080) ^ 0xC300C300
    halves = []
    for shift in (0, 16):
        s = _bf16_value(np.array([(low >> shift) & 0xFFFF]))[0] + \
            _bf16_value(np.array([(high >> shift) & 0xFFFF]))[0]
        assert float(torch.tensor(s).to(torch.bfloat16)) == s     # the sum is a bf16
        halves.append(float(s))
    return halves[0], halves[1]


def test_int8_bytes_become_exact_bf16():
    """Every int8 value, through the masks and the bf16 addition, is itself."""
    for v in range(-128, 128):
        byte = v & 0xFF
        assert _pair_bf16(byte, byte << 8, 0) == (float(v), 0.0)
        assert _pair_bf16(byte << 24, byte << 24, 3) == (float(v), float(v))


def test_operand_registers_are_the_weight_piece():
    """The four registers a thread builds for piece p of a stage hold, at the
    positions wgmma's register operand names (rows gid and gid + 8, columns
    2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9), the weight values of its
    relabelled rows: row r of slab s is weight column fwd_row_to_column(64 s + r),
    operand column k is stage row 16 p + k."""
    rng = np.random.default_rng(3)
    stage = rng.integers(-128, 128, (64, 128)).astype(np.int8)
    words = stage.view(np.uint32)                     # [64 rows, 32 words of 4 columns]
    for warp in range(4):
        for gid in range(8):
            for tig in range(4):
                col_word = 8 * warp + gid
                for p in range(4):
                    rows = [16 * p + 2 * tig + d for d in (0, 1, 8, 9)]
                    wq = [int(words[r, col_word]) for r in rows]
                    for slab in range(2):
                        regs = [_pair_bf16(wq[0], wq[1], 2 * slab),
                                _pair_bf16(wq[0], wq[1], 2 * slab + 1),
                                _pair_bf16(wq[2], wq[3], 2 * slab),
                                _pair_bf16(wq[2], wq[3], 2 * slab + 1)]
                        for i, (row_off, k_off) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                            row = 64 * slab + 16 * warp + gid + row_off
                            col = k8.fwd_row_to_column(row)
                            k = 16 * p + 2 * tig + k_off
                            assert regs[i] == (float(stage[k, col]), float(stage[k + 1, col]))


def wgmma_emulated(x, qvalue, scale, splits):
    """The wgmma kernel's order of sums: in each K split the 16-deep pieces'
    products added one after the other in f32 (f32 x: its three bf16 planes
    hi, mid and lo, piece by piece, each plane's piece after the other), the
    splits' sums added in their order, times the scale once, one cast."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    planes = split_bf16x3_plain(x2).float() if x.dtype == torch.float32 else x2.float()[None]
    w = qvalue.float()
    per = -(-(K // 64) // splits) * 64
    total = torch.zeros((x2.shape[0], w.shape[1]), dtype=torch.float32)
    for s in range(splits):
        part = torch.zeros_like(total)
        for k0 in range(s * per, min(K, (s + 1) * per), 16):
            for plane in planes:
                part = part + plane[:, k0:k0 + 16] @ w[k0:k0 + 16]
        total = total + part
    return (total * scale.reshape(-1).float()).to(x.dtype)


def tricky_f32(rng, M, K):
    """f32 activations that try the split into bf16 planes: magnitudes from
    2^-20 to 2^20 side by side in a row, and in every third place a bf16 tie
    (a bf16 value plus half its step: the split rounds it to the even
    neighbour) or a tie moved one f32 step either way; signs mixed, some
    zeros."""
    x = (rng.standard_normal((M, K)) * 2.0 ** rng.integers(-20, 21, (M, K))).astype(np.float32)
    b = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    _, e = np.frexp(b)
    tie = (b + np.sign(b) * np.ldexp(1.0, e - 9)).astype(np.float32)   # half of bf16's step
    moved = np.nextafter(tie, np.where(rng.random((M, K)) < 0.5, np.inf, -np.inf).astype(
        np.float32)).astype(np.float32)
    which = rng.integers(0, 6, (M, K))
    x = np.where(which == 0, tie, np.where(which == 1, moved, x))
    x[rng.random((M, K)) < 0.02] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("M", [3, 17, 49])
def test_split_bf16x3_is_exact(M):
    """hi + mid + lo == x bit for bit (the residuals are exact in f32 and three
    planes hold x's 24 significant bits); hi is x rounded to nearest even (the
    ties go to the even neighbour), and each plane is at most half a step of
    the plane before it."""
    x = torch.from_numpy(tricky_f32(np.random.default_rng(M), M, 512))
    planes = split_bf16x3_plain(x)
    assert planes.shape == (3, M, 512) and planes.dtype == torch.bfloat16
    hi, mid, lo = planes.float()
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal((hi + mid) + lo, x) and torch.equal(hi + (mid + lo), x)
    for big, small in ((hi, mid), (mid, lo)):
        step = torch.where(big == 0, torch.zeros_like(big),
                           2.0 ** (torch.frexp(big).exponent.float() - 8))
        assert bool((small.abs() <= step / 2).all())


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("M", [17, 49, 196])
def test_f32_three_plane_product_matches_plain_and_jax(M, splits):
    """The product the f32 wgmma path computes (``int8_matmul_x3_plain``, and
    the kernel's order of sums in ``wgmma_emulated``) on activations of mixed
    exponents and bf16 ties, against the plain version (one f32 product) and
    JAX's kernel in interpret mode with f32 x, within 1e-5 of the largest
    output."""
    rng = np.random.default_rng(100 + M)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = tricky_f32(rng, M, K)
    q = quantize_array(jnp.asarray(w), 0)
    ref = np.asarray(j_int8_matmul(jnp.asarray(x), q["qvalue"], q["scale"], interpret=True))
    xt, qv, s = _t(x), _t(q["qvalue"]), _t(q["scale"])
    plain = k8.int8_matmul_plain(xt, qv, s).numpy()
    x3 = k8.int8_matmul_x3_plain(xt, qv, s)
    emulated = wgmma_emulated(xt, qv, s, splits)
    assert x3.dtype == emulated.dtype == torch.float32 and x3.shape == (M, N)
    tol = 1e-5 * np.abs(ref).max()
    for got in (x3.numpy(), emulated.numpy()):
        assert np.abs(got - plain).max() <= tol
        assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 21, 232])
def test_order_of_sums(M, dtype, splits):
    """f32: 3e-5 against the Pallas kernel in interpret mode (f32 sums in another
    order). bf16 activations: the card's tolerance, 1e-2 of the largest value;
    against the plain version, which rounds at the same places, 3e-5 in f32 and
    one bf16 step."""
    rng = np.random.default_rng(11)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = quantize_array(jnp.asarray(w), 0)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(j_int8_matmul(jx, q["qvalue"], q["scale"], interpret=True)
                     .astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype))
    qv, s = _t(q["qvalue"]), _t(q["scale"])
    out = wgmma_emulated(xt, qv, s, splits)
    plain = k8.int8_matmul_plain(xt, qv, s)
    assert out.shape == (M, N) and out.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=3e-5, atol=3e-5)
    else:
        assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
        step = np.abs(plain.float().numpy()).max() * 2.0 ** -8
        assert np.abs(out.float().numpy() - plain.float().numpy()).max() <= step


@pytest.mark.parametrize("what,match", [
    ("strided", "must be contiguous"),
    ("dtype", "x dtype torch.float16 not supported"),
    ("weight", "weight must be int8"),
    ("scale", "scale must be f32 with 32 values"),
])
def test_wrapper_refuses(what, match):
    """What no path of the kernel takes raises in the wrapper's check, whatever
    the device (a CPU tensor goes to the plain version before the check)."""
    K, N = 64, 32
    x = torch.zeros((5, K), dtype=torch.bfloat16)
    q = torch.zeros((K, N), dtype=torch.int8)
    s = torch.ones((1, N), dtype=torch.float32)
    if what == "strided":
        x = torch.cat([x, x], dim=-1)[:, :K]
    if what == "dtype":
        x = x.to(torch.float16)
    if what == "weight":
        q = q.to(torch.uint8)
    if what == "scale":
        s = s.to(torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        k8._check("int8_matmul", x, q, s)


def test_a_misaligned_view_keeps_the_old_path():
    """A contiguous view that starts 2 bytes into its buffer is not refused:
    it takes a path that needs no 16-byte rows."""
    buf = torch.zeros(49 * 3584 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(49, 3584)
    assert x.is_contiguous() and k8.align_of(x) < 16 and k8.align_of(buf) == 16
    pl = k8.plan(49, 3584, 4608, bf16=True, align=(k8.align_of(x), 16, 16))
    assert pl.path == VEC16


# ---- the decode rows (1 .. 16): one kernel, one plan, one order of sums ------------------


def _decode_shapes():
    """(M, K, N) of every product a 7B path hands the decode path: rows 1-16 at
    the four layer products (a token, verify passes of 4 and 8 and their 5 and 9
    rows, the 13-row generation prompt), 1, 4 and 8 at the lm_head."""
    out = [(M, K, N) for M in range(1, 17) for _, K, N in _smoke().LAYER]
    return out + [(M, *LM_HEAD) for M in (1, 4, 8)]


@pytest.mark.parametrize("M,K,N", _decode_shapes())
def test_decode_plan_of_every_7b_shape(M, K, N):
    """bf16, aligned, 1 to 16 rows: the decode kernel, with the same ring and
    splits at every M (a row gives the same bits alone or with 15 others), whole
    stages a split and none empty, a ring whose blocks fill the SM's shared
    memory as far as they go; a layer's grids split until about two blocks an
    SM and run in one round of six blocks an SM behind three slots; the
    lm_head's 1,188 blocks behind six slots, three an SM: three even rounds."""
    pl = k8.plan(M, K, N, bf16=True)
    assert pl.path == DECODE and pl == k8.plan(1, K, N, bf16=True) == k8.plan(16, K, N, bf16=True)
    assert (pl.tile, pl.tiles) == (16, 1)
    stages, blocks = K // 64, -(-N // 128)
    per = -(-stages // pl.splits)
    assert 1 <= pl.splits <= stages and per * (pl.splits - 1) < stages
    assert pl.smem_bytes == pl.stages * (16 * 128 + 64 * 144) <= SMEM
    held = k8.decode_blocks_per_sm(pl.stages)
    assert held * (pl.smem_bytes + 1024) <= k8.SMEM_PER_SM < (held + 1) * (pl.smem_bytes + 1024)
    if pl.stages == 3:
        assert held == 6 and blocks * pl.splits <= held * 132
        assert pl.splits == 1 or blocks * pl.splits <= 2 * 132 + blocks
    else:
        assert (pl.stages, held) == (6, 3) and blocks > 6 * 132 and blocks % (held * 132) == 0
    expect = {4608: 7, 37888: 1, 152064: 1}.get(N, 9 if K == 18944 else 8)
    assert pl.splits == expect, (M, K, N, pl.splits)


def test_decode_columns_are_relabelled_not_moved():
    """A warp's B columns (gid, n-tile t) are its 32 weight columns once each;
    a thread's accumulator elements (t, e) are column 2 tig + e of n-tile t,
    i.e. the eight neighbouring columns 32 w + 8 tig .. + 7 it stores."""
    for warp in range(4):
        cols = sorted(k8.decode_column(warp, j, t) for j in range(8) for t in range(4))
        assert cols == list(range(32 * warp, 32 * warp + 32))
        for tig in range(4):
            mine = sorted(k8.decode_column(warp, 2 * tig + e, t)
                          for t in range(4) for e in range(2))
            assert mine == list(range(32 * warp + 8 * tig, 32 * warp + 8 * tig + 8))


def test_decode_registers_are_the_piece_of_w_the_product_reads():
    """Every thread's B registers of a stage (64 rows of a block's 128 int8
    columns, every byte value) against the weight: register b0 / b1 of n-tile t
    in piece p of thread (gid, tig) of warp w holds rows 16 p + 2 tig (+ 8) and
    the next of column decode_column(w, gid, t), built by pair_bf16 from the
    words of rows 16 p + 2 tig + (0, 1, 8, 9) at columns 32 w + 4 gid .. + 3."""
    rng = np.random.default_rng(3)
    stage = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 64 * 128)).reshape(64, 128)
    w = stage.view(np.int8)
    seen = np.zeros(w.shape, dtype=bool)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            col0 = 32 * warp + 4 * gid
            for p in range(4):
                wq = [int.from_bytes(stage[16 * p + 2 * tig + d, col0:col0 + 4].tobytes(),
                                     "little") for d in (0, 1, 8, 9)]
                for t in range(4):
                    col = k8.decode_column(warp, gid, t)
                    for (a, b), k in (((wq[0], wq[1]), 16 * p + 2 * tig),
                                      ((wq[2], wq[3]), 16 * p + 2 * tig + 8)):
                        assert _pair_bf16(a, b, t) == (w[k, col], w[k + 1, col]), (warp, lane, p)
                        seen[k:k + 2, col] = True
    assert seen.all()


def test_decode_shared_reads_fall_in_distinct_banks():
    """Weight rows of a stage lie 144 bytes apart: each of a warp's 16 word
    reads of a stage (rows 16 p + 2 tig + d, words 8 w + gid) meets 32 banks."""
    for warp in range(4):
        for p in range(4):
            for d in (0, 1, 8, 9):
                banks = {((16 * p + 2 * tig + d) * 144 + 32 * warp + 4 * gid) // 4 % 32
                         for gid in range(8) for tig in range(4)}
                assert len(banks) == 32


def decode_emulated(x, qvalue, scale, splits):
    """The decode kernel's order of sums: a split's whole 64-row stages in order,
    each 16-deep piece's exact sum (in f64, as the tensor cores keep a piece's
    products) rounded once into the split's f32 sum, which starts at zero; the
    splits' sums added in split order from zero (splitk_reduce; one split is its
    own sum); times the column scale in f32; one cast."""
    K = x.shape[-1]
    per = -(-(K // 64) // splits) * 64
    w = qvalue.double()
    xd = x.reshape(-1, K).float().double()
    total = torch.zeros((xd.shape[0], w.shape[1]), dtype=torch.float32)
    for s in range(splits):
        part = torch.zeros_like(total)
        for k0 in range(s * per, min(K, (s + 1) * per), 16):
            part = (part.double() + xd[:, k0:k0 + 16] @ w[k0:k0 + 16]).float()
        total = total + part
    return (total * scale.reshape(-1).float()).to(x.dtype)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_decode_order_of_sums(M, dtype, splits):
    """At one split, three and the plan's eight (one stage each): f32 within 3e-5
    of the Pallas kernel in interpret mode and of the plain version; bf16
    activations within 1e-2 of the largest value of the Pallas kernel and one
    bf16 step of the plain version; and row r of the M-row product equal, bit for
    bit, to the one-row product of row r."""
    rng = np.random.default_rng(11 + M)
    K, N = 512, 256
    slots3 = 3 * k8.DECODE_SLOTS[False]
    assert k8.plan(M, K, N, bf16=True) == k8.Plan(DECODE, 8, 16, 1, 3, slots3)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = quantize_array(jnp.asarray(w), 0)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(j_int8_matmul(jx, q["qvalue"], q["scale"], interpret=True)
                     .astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype))
    qv, s = _t(q["qvalue"]), _t(q["scale"])
    out = decode_emulated(xt, qv, s, splits)
    rows = torch.cat([decode_emulated(xt[r:r + 1], qv, s, splits) for r in range(M)])
    assert out.shape == (M, N) and out.dtype == xt.dtype and torch.equal(out, rows)
    plain = k8.int8_matmul_plain(xt, qv, s)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=3e-5, atol=3e-5)
    else:
        assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
        step = np.abs(plain.float().numpy()).max() * 2.0 ** -8
        assert np.abs(out.float().numpy() - plain.float().numpy()).max() <= step


@pytest.mark.parametrize("what,match", [
    ("rows", "at most 16 rows"),
    ("f32", "takes bf16 x, weight-only"),
    ("a8", "takes bf16 x, weight-only"),
])
def test_launch_plan_refuses_what_the_decode_kernel_does_not_take(what, match):
    """A decode plan handed more than 16 rows, f32 activations, or int8 ones
    with their row scales and an f32 output raises before any library is built
    or launched."""
    M, K, N = (17 if what == "rows" else 4), 64, 32
    dtype = {"f32": torch.float32, "a8": torch.int8}.get(what, torch.bfloat16)
    x = torch.zeros((M, K), dtype=dtype)
    sx = torch.ones(M) if what == "a8" else None
    q = torch.zeros((K, N), dtype=torch.int8)
    s = torch.ones((1, N), dtype=torch.float32)
    y = torch.empty((M, N), dtype=torch.float32 if what == "a8" else torch.bfloat16)
    pl = k8.Plan(DECODE, 1, 16, 1, 3, 3 * k8.DECODE_SLOTS[False])
    with pytest.raises(ValueError, match=match):
        k8.launch_plan(x, sx, q, s, y, pl)


@pytest.mark.parametrize("what,match", [
    ("decode", "and a bf16 output; got torch.bfloat16 x without row scales and a torch.float32"),
    ("bf16-out", "and a bf16 output; got torch.bfloat16 x without row scales and a torch.bfloat16"),
    ("tile", "the f32 wgmma path takes token tiles"),
])
def test_launch_plan_refuses_planes_the_kernel_does_not_take(what, match):
    """An f32 x's three planes on the decode path, with a bf16 output, or at a
    token tile the three-plane kernel is not built for (72) raise before any
    library is built or launched."""
    M, K, N = 49, 64, 32
    planes = split_bf16x3_plain(torch.zeros((M, K)))
    q = torch.zeros((K, N), dtype=torch.int8)
    s = torch.ones((1, N), dtype=torch.float32)
    y = torch.empty((M, N), dtype=torch.bfloat16 if what == "bf16-out" else torch.float32)
    if what == "decode":
        pl = k8.Plan(DECODE, 1, 16, 1, 3, 3 * k8.DECODE_SLOTS[False])
    else:
        tile = 72 if what == "tile" else 56
        stages, smem = k8.wgmma_ring(tile, planes=3)
        pl = k8.Plan(WGMMA, 1, tile, 1, stages, smem)
    with pytest.raises(ValueError, match=match):
        k8.launch_plan(planes, None, q, s, y, pl)


# ---- int8 activations (a8): the same two kernels on s8 tensor cores ---------------------

A8_ROWS = (1, 4, 5, 8, 9, 13, 49, 59, 171, 196, 220, 392, 1568)


def _a8_shapes(M):
    """(K, N) of every product the ``fused_a8`` paths hand int8_matmul at M rows:
    the layer's four at every row count of a pass (392: a fused pass of 8
    frames), the lm_head at 1, 4 and 8, the projector at 392 and 1568."""
    shapes = [(K, N) for _, K, N in _smoke().LAYER] if M != 1568 else []
    if M in (1, 4, 8):
        shapes.append(LM_HEAD)
    if M in (392, 1568):
        shapes += list(PROJECTOR)
    return shapes


@pytest.mark.parametrize("M", A8_ROWS)
def test_a8_plan_of_every_path_shape(M):
    """bf16 x quantised to int8, aligned: 1 to 16 rows on the decode kernel with
    the weight-only plan's K splits (from W's shape alone: the plan of 1 row and
    of 16 is the same) and a ring of 3 slots, or 8 for the lm_head's grid; from 17
    rows on the wgmma kernel with a token tile among the widths the s8 product
    takes, tiles that cover M once, a ring of at least three slots of 64-byte x
    rows and 128-byte weight rows that fits the blocks an SM holds, and the
    weight-only wgmma plan's rule for K splits (at every row count: int8 x
    does not take the warp-specialised kernel)."""
    for K, N in _a8_shapes(M):
        pl = k8.plan(M, K, N, bf16=True, a8=True)
        # weight-only's plan on the same kernels (from WS_MIN_M rows weight-only
        # takes the warp-specialised kernel; int8 x stays on wgmma)
        w8 = k8.plan(M, K, N, bf16=True) if M <= k8.DECODE_MAX_M else k8.wgmma_plan(M, K, N)
        if M <= k8.DECODE_MAX_M:
            assert pl.path == DECODE and pl == k8.plan(16, K, N, bf16=True, a8=True), (M, K, N)
            assert pl.splits == w8.splits and (pl.tile, pl.tiles) == (16, 1)
            assert pl.stages == (8 if N == LM_HEAD[1] else 3)
            assert pl.smem_bytes == pl.stages * (16 * 64 + 64 * 128) <= SMEM
            held = k8.decode_blocks_per_sm(pl.stages, a8=True)
            assert held == (3 if pl.stages == 8 else 6)
            assert held * (pl.smem_bytes + 1024) <= k8.SMEM_PER_SM
            continue
        assert pl.path == WGMMA, (M, K, N)
        assert pl.tile in k8.WGMMA_A8_TILES and (pl.tiles - 1) * pl.tile < M <= pl.tiles * pl.tile
        assert pl.tile >= w8.tile and pl.tiles == w8.tiles or pl.tiles < w8.tiles
        assert (pl.stages, pl.smem_bytes) == k8.wgmma_ring(pl.tile, a8=True)
        assert 3 <= pl.stages <= 6
        assert pl.smem_bytes == pl.stages * (pl.tile * 64 + 64 * 128) + 1024 <= SMEM
        assert k8.blocks_per_sm(pl.tile) * (pl.smem_bytes + 1024) <= k8.SMEM_PER_SM
        blocks, places = pl.tiles * -(-N // 128), k8.blocks_per_sm(pl.tile) * 132
        assert pl.splits == k8.wgmma_splits(places, blocks, K // 64)


def test_a8_token_tiles():
    """The s8 warpgroup product takes widths 24, 32 and multiples of 16: 49 rows
    are one tile of 64, 196 two of 112, 392 four of 112, 1568 thirteen of 128."""
    tiles = k8.WGMMA_A8_TILES
    assert k8.token_tile(17, 128, tiles) == (24, 1)
    assert k8.token_tile(49, 128, tiles) == (64, 1)
    assert k8.token_tile(196, 128, tiles) == (112, 2)
    assert k8.token_tile(392, 128, tiles) == (112, 4)
    assert k8.token_tile(1568, 128, tiles) == (128, 13)
    for M in range(17, 600):
        tile, n = k8.token_tile(M, 128, tiles)
        assert tile in tiles and (n - 1) * tile < M <= n * tile


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of the
    eight bytes of x (0 .. 3) and y (4 .. 7)."""
    src = x.to_bytes(4, "little") + y.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)), "little")


def _byte_columns(h: int, r: list[int]) -> tuple[int, int]:
    """``byte_columns<H>`` of csrc/wgmma.cuh, step by step: four byte permutes."""
    sel = 0x7362 if h else 0x5140
    t0, t1 = _byte_perm(r[0], r[1], sel), _byte_perm(r[2], r[3], sel)
    return _byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632)


def _word_bytes(v: int) -> list[int]:
    return list(np.frombuffer(v.to_bytes(4, "little"), dtype=np.int8))


def _a8_stage(w: np.ndarray) -> bytes:
    """A stage's 64 weight rows of 128 int8 columns as the copies lay them out for
    int8 x: rows 128 bytes apart, chunk c of row r at chunk c ^ 2 ((r >> 2) & 3)."""
    out = bytearray(64 * 128)
    raw = w.view(np.uint8)
    for r in range(64):
        for c in range(8):
            pos = c ^ (2 * ((r >> 2) & 3))
            out[r * 128 + 16 * pos:r * 128 + 16 * pos + 16] = raw[r, 16 * c:16 * c + 16].tobytes()
    return bytes(out)


def _a8_words(stage: bytes, warp: int, tig: int, gid: int, p: int, g: int) -> list[int]:
    """The four words a thread reads for piece p, group g of a stage (int8 x):
    rows 32 p + 16 g + 4 tig + d at its byte offset 4 tig 128 + 4 ((8 w + gid) ^ 8 tig)
    past row 0 (the kernels' w_off) plus (32 p + 16 g + d) 128."""
    base = 4 * tig * 128 + 4 * ((8 * warp + gid) ^ (8 * tig))
    return [int.from_bytes(stage[base + (32 * p + 16 * g + d) * 128:][:4], "little")
            for d in range(4)]


def _every_byte_stage(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 64 * 128)).reshape(
        64, 128).view(np.int8)


def test_byte_columns_transpose_every_byte():
    """Four words of four columns become each column's four rows, for every byte
    value in every position."""
    rng = np.random.default_rng(5)
    for _ in range(64):
        rows = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), 16)).reshape(4, 4)
        words = [int.from_bytes(rows[d].tobytes(), "little") for d in range(4)]
        for h in (0, 1):
            c0, c1 = _byte_columns(h, words)
            assert c0.to_bytes(4, "little") == rows[:, 2 * h].tobytes()
            assert c1.to_bytes(4, "little") == rows[:, 2 * h + 1].tobytes()


def test_a8_wgmma_registers_are_the_piece_of_w_transposed():
    """Every thread's A registers of a stage (int8 x: W^T is the register operand
    of m64nNk32 s8), every byte value: register r of piece p for slab s holds four
    consecutive K values of one weight column, the lowest in the lowest byte, at
    the positions the s8 fragment names (row gid for registers 0 and 2, gid + 8
    for 1 and 3; k 4 tig .. + 3 for 0 and 1, 16 + 4 tig .. + 3 for 2 and 3): row
    r of slab s is weight column fwd_row_to_column(64 s + r), k is stage row
    32 p + k."""
    w = _every_byte_stage(3)
    stage = _a8_stage(w)
    seen = np.zeros(w.shape, dtype=int)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            for p in range(2):
                groups = [_a8_words(stage, warp, tig, gid, p, g) for g in (0, 1)]
                for slab in range(2):
                    a0, a1 = _byte_columns(slab, groups[0])
                    a2, a3 = _byte_columns(slab, groups[1])
                    for reg, (row_off, k_off) in zip((a0, a1, a2, a3),
                                                     ((0, 0), (8, 0), (0, 16), (8, 16))):
                        col = k8.fwd_row_to_column(64 * slab + 16 * warp + gid + row_off)
                        k = 32 * p + 4 * tig + k_off
                        assert _word_bytes(reg) == list(w[k:k + 4, col]), (warp, lane, p, slab)
                        seen[k:k + 4, col] += 1
    assert (seen == 1).all()


def test_a8_decode_registers_are_the_piece_of_w():
    """Every thread's B registers of a stage on the decode path with int8 x
    (m16n8k32 s8), every byte value: b0 / b1 of n-tile t in piece p of thread
    (gid, tig) of warp w hold rows 32 p + 4 tig .. + 3 / 32 p + 16 + 4 tig .. + 3
    of column decode_column(w, gid, t), the lowest row in the lowest byte."""
    w = _every_byte_stage(4)
    stage = _a8_stage(w)
    seen = np.zeros(w.shape, dtype=int)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            for p in range(2):
                regs = []
                for g in (0, 1):
                    words = _a8_words(stage, warp, tig, gid, p, g)
                    regs.append([*_byte_columns(0, words), *_byte_columns(1, words)])
                for t in range(4):
                    col = k8.decode_column(warp, gid, t)
                    for g, k in ((0, 32 * p + 4 * tig), (1, 32 * p + 16 + 4 * tig)):
                        assert _word_bytes(regs[g][t]) == list(w[k:k + 4, col]), (warp, lane, p)
                        seen[k:k + 4, col] += 1
    assert (seen == 1).all()


def test_a8_shared_reads_fall_in_distinct_banks():
    """The weight words a warp reads at once with int8 x (rows 32 p + 16 g +
    4 tig + d, the thread's word of its four columns) meet 32 banks; so do the
    rows of the x tile that one ldmatrix matrix reads (8 rows of 64 bytes in the
    64-byte swizzle, each lane the 16-byte chunk 2 p + lane / 16 of its row), and
    the copies place chunk c of x row r at c ^ ((r >> 1) & 3)."""
    for warp in range(4):
        for p in range(2):
            for g in range(2):
                for d in range(4):
                    banks = {(4 * tig * 128 + 4 * ((8 * warp + gid) ^ (8 * tig))
                              + (32 * p + 16 * g + d) * 128) // 4 % 32
                             for gid in range(8) for tig in range(4)}
                    assert len(banks) == 32
    for p in range(2):
        for half in (0, 1):
            for rows in (range(8), range(8, 16)):
                spans = {(xr * 64 + (((2 * p + half) ^ ((xr >> 1) & 3)) << 4)) % 128 // 16
                         for xr in rows}
                assert len(spans) == 8
    # every 16-byte chunk of a 16-row tile lands once, in its row
    places = {(r, c ^ ((r >> 1) & 3)) for r in range(16) for c in range(4)}
    assert len(places) == 64


def a8_emulated(x, qvalue, scale, splits):
    """The int8-activation kernels' order of sums: x quantised per row (the plain
    quantiser, bit-equal to the kernel's); in each K split of whole 64-row stages
    the exact int32 sum (in f64, exact), made f32 once; the splits' sums added in
    split order from zero in f32 (one split is its own sum); times the column
    scale, then the row scale, in f32; one cast."""
    K = x.shape[-1]
    xq, sx = k8.quantize_rows_plain(x.reshape(-1, K))
    per = -(-(K // 64) // splits) * 64
    xd, w = xq.double(), qvalue.double()
    total = torch.zeros((xd.shape[0], w.shape[1]), dtype=torch.float32)
    for s in range(splits):
        total = total + (xd[:, s * per:(s + 1) * per] @ w[s * per:(s + 1) * per]).float()
    return (total * scale.reshape(-1).float() * sx).to(x.dtype)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("M", [1, 5, 16, 21, 232])
def test_a8_order_of_sums_is_bit_exact(M, splits):
    """bf16 x, int8 activations: the new paths' order of sums equals the plain
    version bit for bit (the int32 sums are exact and stay below 2^24, so the
    split partials add exactly in f32), at decode rows and wgmma rows, with one
    split and three, and each row of the M-row product is its one-row product.
    Against the Pallas kernel in interpret mode: bit-equal on every row whose
    scale XLA's compiled quantiser makes the IEEE quotient absmax / 127 (it
    divides by multiplying with the reciprocal of 127, one ulp off on some rows);
    on the others within the card's tolerance, 1e-2 of the largest value."""
    from aha_tpu.ops.pallas.fused_matmul import _quantize_rows

    rng = np.random.default_rng(7 + M)
    K, N = 576, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = quantize_array(jnp.asarray(w), 0)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(j_int8_matmul(jx, q["qvalue"], q["scale"], a8=True, interpret=True)
                     .astype(jnp.float32))
    xt = _t(x).to(torch.bfloat16)
    qv, s = _t(q["qvalue"]), _t(q["scale"])
    out = a8_emulated(xt, qv, s, splits)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert torch.equal(out, k8.int8_matmul_plain(xt, qv, s, a8=True))
    rows = torch.cat([a8_emulated(xt[r:r + 1], qv, s, splits) for r in range(M)])
    assert torch.equal(out, rows)
    _, js = jax.jit(_quantize_rows)(jx)
    ieee = np.asarray(js).reshape(-1) == k8.quantize_rows_plain(xt)[1].numpy().reshape(-1)
    assert ieee.sum() >= M // 2
    np.testing.assert_array_equal(out.float().numpy()[ieee], ref[ieee])
    assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("K", [1024, 3584, 18944])
def test_quantize_rows_plain_matches_jax_at_the_layer_widths(K):
    """The quantiser in front of every int8-activation product, at the widths
    the 7B paths quantise (projector, layer, down's input), bf16 rows: scales and
    values bit-equal to the TPU package's _quantize_rows (the card's kernel is
    held bit-equal to this plain version in chip_smoke.py phase 2)."""
    from aha_tpu.ops.pallas.fused_matmul import _quantize_rows

    rng = np.random.default_rng(K)
    x = (rng.standard_normal((5, K)) * rng.uniform(0.1, 10.0, (5, 1))).astype(np.float32)
    jq, js = _quantize_rows(jnp.asarray(x).astype(jnp.bfloat16))
    tq, ts = k8.quantize_rows_plain(_t(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("what,match", [
    ("a8-f32-out", "and a bf16 output; got torch.int8 x with row scales and a torch.float32"),
    ("a8-tile", "takes token tiles"),
    ("int8-x-without-scales", "got torch.int8 x without row scales"),
])
def test_launch_plan_refuses_an_a8_plan_the_kernels_do_not_take(what, match):
    """A wgmma plan for int8 x with an f32 output, or with a token tile the s8
    product has no width for (40), and int8 x handed without its row scales,
    raise before any library is built or launched."""
    M, K, N = 40, 64, 32
    x = torch.zeros((M, K), dtype=torch.int8)
    sx = None if what == "int8-x-without-scales" else torch.ones(M, 1)
    q = torch.zeros((K, N), dtype=torch.int8)
    s = torch.ones((1, N), dtype=torch.float32)
    y = torch.empty((M, N), dtype=torch.float32 if what == "a8-f32-out" else torch.bfloat16)
    tile = 40 if what == "a8-tile" else 48
    stages, smem = k8.wgmma_ring(tile, a8=True)
    pl = k8.Plan(WGMMA, 1, tile, 1, stages, smem)
    with pytest.raises(ValueError, match=match):
        k8.launch_plan(x, sx, q, s, y, pl)
