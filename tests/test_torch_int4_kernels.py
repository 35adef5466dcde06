"""The int4 products' tensor-core kernels, as far as a CPU can hold them: the
wrappers' pure choice of path, token tile, ring, splits and shared memory for
every shape ``chip_smoke.py`` drives; the relabelling of accumulator rows that
the wgmma kernels apply at their stores and of weight columns in the decode
kernel (1 .. 16 rows), whose unpacked registers are checked bit for bit; the
forward kernels' orders of sums (f32 group sums over 16-deep pieces, the
group's scale, groups and K splits added) emulated in plain PyTorch against
the Pallas kernel in interpret mode; and what the wrappers refuse. The kernels themselves run only on the card
(``chip_smoke.py`` phase 2 holds them against the plain versions there)."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops.pallas.fused_matmul import int4_matmul as j_int4_matmul
from aha_tpu.ops.quant import quantize_array_int4

from aha_tpu_torch import bridge
from aha_tpu_torch.ops.kernels import int4_matmul as k4
from aha_tpu_torch.ops.kernels import int4_matmul_t as kt
from aha_tpu_torch.ops.kernels.int8_matmul import SCALAR, TENSOR_CORE, VEC16

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
    """bf16, G 128, aligned: from 14 rows on the wgmma kernel, with a token tile
    that is a multiple of 8, at most 80 (two accumulator sets) and so at most
    the 256 a warpgroup product takes, tiles that cover M once, whole groups a
    split, and a ring that fits a block's shared memory twice on an SM."""
    for K, N in _shapes(M):
        pl = k4.plan(M, K, N, 128, bf16=True)
        if M <= k4.DECODE_MAX_M:
            assert pl == k4.plan(1, K, N, 128, bf16=True), (M, K, N)
            assert pl.path == k4.DECODE, (M, K, N)
            continue
        assert pl.path == k4.WGMMA, (M, K, N)
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
    (926, 3584, 4608, 128, dict(bf16=False), VEC16),                 # f32
    (926, 3584, 4608, 128, dict(bf16=True, a8=True), TENSOR_CORE),   # int8 activations
    (926, 3584, 4608, 128, dict(bf16=True, align=(8, 16, 16)), VEC16),
    (926, 3584, 4608, 128, dict(bf16=True, align=(16, 8, 16)), TENSOR_CORE),
    (13, 3584, 4608, 128, dict(bf16=True, a8=True), TENSOR_CORE),    # a verify pass with int8 x
    (1, 3584, 4608, 128, dict(bf16=False), VEC16),                   # a token in f32
    (8, 3584, 4608, 32, dict(bf16=True), TENSOR_CORE),               # decode rows at G 32
    (8, 320, 136, 64, dict(bf16=True), TENSOR_CORE),                 # N not a multiple of 16
    (8, 320, 132, 64, dict(bf16=True), SCALAR),                      # N not a multiple of 8
    (8, 3584, 4608, 128, dict(bf16=True, align=(8, 16, 16)), VEC16),   # a misaligned x
    (8, 3584, 4608, 128, dict(bf16=True, align=(16, 16, 8)), TENSOR_CORE),   # misaligned scales
    (1, 3584, 4608, 128, dict(bf16=True, a8=True), VEC16),           # a token with int8 x
])
def test_forward_plan_keeps_the_earlier_paths(M, K, N, G, kw, path):
    pl = k4.plan(M, K, N, G, **kw)
    assert pl.path == path and pl.tile == 0 and pl.smem_bytes == 0 and pl.splits >= 1


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


def wgmma_forward_emulated(x, q4value, scale4):
    """The wgmma kernel's order of sums: per group the 16-deep pieces' products
    added one after the other in f32, the group's sum times its scale as f32,
    the groups added in f32, one cast."""
    K = x.shape[-1]
    groups = scale4.shape[0]
    G = K // groups
    w = k4.unpack_int4(q4value).float()
    xf = x.reshape(-1, K).float()
    tot = torch.zeros((xf.shape[0], w.shape[1]), dtype=torch.float32)
    for g in range(groups):
        grp = torch.zeros_like(tot)
        for k0 in range(g * G, (g + 1) * G, 16):
            grp = grp + xf[:, k0:k0 + 16] @ w[k0:k0 + 16]
        tot = tot + grp * scale4[g].float()
    return tot.to(x.dtype).reshape(*x.shape[:-1], -1)


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
