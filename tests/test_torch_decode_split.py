"""The window split of the cached-attention kernels (csrc/decode_attention.cu):
``plan()`` at every shape chip_smoke.py drives, and the split-and-merge
arithmetic emulated in PyTorch (``decode_attention_split_plain``) against the
JAX Pallas kernel (cached_decode_attention, interpret mode) and the JAX jnp
path, in f32, with the bf16 tensor-core path's roundings and with the f32
tensor-core path's bf16 planes. Inputs come from a numpy seed and go to both
packages."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aha_tpu.ops import attention as jattn
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops.pallas.decode_attention import cached_decode_attention

from aha_tpu_torch.ops import attention as tattn
from aha_tpu_torch.ops import kv_cache as tkv
from aha_tpu_torch.ops.kernels import decode_attention as da
from aha_tpu_torch.ops.rope import apply_rope

THETA = 10_000.0
SMS = 132
BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# (B, S, NH, KVH, Dh, Wp, q dtype, kv dtype): the 7B shapes of chip_smoke.py's
# phase 2 (every write pass's S, int8 KV, B = 2, S = 2 / 3 either side of 16
# rows, Wp across the slot tiles' edges), its f32 cases (the f32 frame chunks
# against the bf16 cache, one against an f32 cache, the local judge's f32 cache
# of 4,097 slots at a token and its rubric prefix) and its small ragged f32 cases
SMOKE_SHAPES = [(1, S, 28, 4, 128, 2049, BF, BF) for S in (1, 2, 3, 13, 49, 59, 171, 220)]
SMOKE_SHAPES += [(1, 49, 28, 4, 128, 2049, BF, I8), (1, 1, 28, 4, 128, 2049, BF, I8),
                 (2, 1, 28, 4, 128, 2049, BF, BF), (2, 13, 28, 4, 128, 2049, BF, BF)]
SMOKE_SHAPES += [(1, 3, 28, 4, 128, Wp, BF, BF) for Wp in (64, 65, 129)]
SMOKE_SHAPES += [(1, S, 28, 4, 128, 2049, F32, BF) for S in (49, 59, 171, 220)]
SMOKE_SHAPES += [(1, 49, 28, 4, 128, 2049, F32, F32), (1, 1, 28, 4, 128, 4097, F32, F32),
                 (1, 1695, 28, 4, 128, 4097, F32, F32)]
SMOKE_SHAPES += [(2, 5, 4, 2, 16, 77, F32, F32), (2, 3, 6, 2, 64, 129, F32, F32),
                 (1, 9, 8, 2, 32, 45, F32, F32), (2, 7, 4, 2, 128, 100, F32, I8)]
# f32 q against a bf16 cache off the tensor cores: fewer than 16 rows, head size 64
SMOKE_SHAPES += [(1, 2, 28, 4, 128, 2049, F32, BF), (2, 5, 4, 2, 64, 129, F32, BF)]


def _path_expected(S, NH, KVH, Dh, qdt, kvdt):
    if Dh != 128 or (NH // KVH) * S < 16:
        return da.CUDA_CORES
    if qdt == BF and kvdt in (BF, I8):
        return da.WGMMA
    return da.WGMMA_F32 if qdt == F32 and kvdt in (BF, F32) else da.CUDA_CORES


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: "-".join(map(str, s[:6])) +
                         f"-{str(s[6])[6:]}-{str(s[7])[6:]}")
def test_plan_at_smoke_shapes(shape):
    """The splits cover [0, Wp) once, in whole slot tiles, none empty; one
    batch row's blocks fit one round of resident blocks (2 a SM on the bf16
    tensor-core path, 1 on the f32 one, 4 on the CUDA cores) and make at least
    one wave of the card where the slot tiles allow it (at one block a SM, a
    wave less under one split's blocks), each split of at least MIN_TILES
    tiles; one split where one row's tiles alone fill the round; the splits are
    those of the same shape at B 1 (a row sums in the same order in a batch of
    any size); the path is the
    tensor cores' exactly at head size 128 from 16 rows per kv head for bf16 q
    (bf16 or int8 cache) and f32 q (bf16 or f32 cache); the wrapper's checks
    admit the shape's types."""
    B, S, NH, KVH, Dh, Wp, qdt, kvdt = shape
    pl = da.plan(B, S, NH, KVH, Dh, Wp, qdt, kvdt, sms=SMS)
    bounds = pl.bounds(Wp)
    assert bounds[0][0] == 0 and bounds[-1][1] == Wp
    assert all(hi > lo for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % pl.slot_tile == 0 for lo, _ in bounds)
    assert pl.span % pl.slot_tile == 0
    assert pl.path == _path_expected(S, NH, KVH, Dh, qdt, kvdt)
    M = (NH // KVH) * S
    assert pl.row_tiles == math.ceil(M / pl.row_tile)
    base = KVH * pl.row_tiles           # one batch row's blocks before any split
    n_tiles = math.ceil(Wp / pl.slot_tile)
    min_tiles = da.MIN_TILES[pl.path]
    assert pl.blocks == B * base * pl.splits
    assert (pl.splits, pl.span) == (lambda p: (p.splits, p.span))(
        da.plan(1, S, NH, KVH, Dh, Wp, qdt, kvdt, sms=SMS))
    assert pl.splits <= n_tiles
    if pl.splits > 1:
        assert base * pl.splits <= da.RESIDENT[pl.path] * SMS
        assert pl.span // pl.slot_tile >= min_tiles
        # a wave of the card where the slot tiles allow it; at one block a SM (the f32
        # tensor cores) a wave less at most one split's blocks, so as not to start a second
        wave = SMS if da.RESIDENT[pl.path] > 1 else SMS - base + 1
        assert base * pl.splits >= min(wave, base * (n_tiles // min_tiles))
    else:
        assert base * 2 > da.RESIDENT[pl.path] * SMS or n_tiles < 2 * min_tiles
    z = lambda *shape, dtype=F32: torch.zeros(shape, dtype=dtype, device="meta")
    scales = (z(B, Wp, KVH), z(B, Wp, KVH)) if kvdt == I8 else None
    da._check(z(B, S, NH, Dh, dtype=qdt), z(B, Wp, KVH, Dh, dtype=kvdt),
              z(B, Wp, KVH, Dh, dtype=kvdt), z(B, Wp, Dh), z(B, Wp, Dh),
              z(B, Wp, dtype=torch.int32), z(B, S, dtype=torch.int32), scales)


def test_plan_a_token_on_the_7b_fills_the_card():
    """S = 1 on the 7B: the CUDA-core path, 4 kv heads x 65 splits of 32 slots,
    more than 100 blocks (one block per kv head before the split); a frame
    chunk (S = 49): 6 row tiles x 4 kv heads x 11 splits of 192 slots in bf16,
    5 of 448 in f32."""
    pl = da.plan(1, 1, 28, 4, 128, 2049, BF, BF, sms=SMS)
    assert (pl.path, pl.splits, pl.span, pl.blocks) == (da.CUDA_CORES, 65, 32, 260)
    pl = da.plan(1, 49, 28, 4, 128, 2049, BF, BF, sms=SMS)
    assert (pl.path, pl.splits, pl.span, pl.blocks) == (da.WGMMA, 11, 192, 264)
    # the f32 frame chunk (f32 q, bf16 cache): one block a SM, 24 row tiles x 5 splits
    # of 448 slots; the judge's rubric prefix fills the card with its row tiles
    pl = da.plan(1, 49, 28, 4, 128, 2049, F32, BF, sms=SMS)
    assert (pl.path, pl.splits, pl.span, pl.blocks) == (da.WGMMA_F32, 5, 448, 120)
    pl = da.plan(1, 1695, 28, 4, 128, 4097, F32, F32, sms=SMS)
    assert (pl.path, pl.splits, pl.blocks) == (da.WGMMA_F32, 1, 744)


@pytest.mark.parametrize("Wp", [1, 31, 32, 33, 63, 64, 65, 2049])
@pytest.mark.parametrize("sms", [1, 8, 132, 10_000])
def test_plan_never_more_splits_than_slot_tiles(Wp, sms):
    for S, dt in ((1, BF), (20, BF), (3, F32)):
        pl = da.plan(1, S, 8, 2, 128, Wp, dt, dt, sms=sms)
        assert 1 <= pl.splits <= math.ceil(Wp / pl.slot_tile)
        assert (pl.splits - 1) * pl.span < Wp <= pl.splits * pl.span


def test_plan_one_split_where_the_rows_fill_the_card():
    """One split where one batch row's row tiles fill the round: a 600-row
    chunk is 66 row tiles x 4 kv heads, 264 blocks a row, at B 1 and B 8.
    Eight streams at S = 220 (25 row tiles, 100 blocks a row) keep B 1's two
    splits, so that each stream sums as it does alone."""
    for B in (1, 8):
        pl = da.plan(B, 600, 28, 4, 128, 2049, BF, BF, sms=SMS)
        assert pl.splits == 1 and pl.span >= 2049 and pl.path == da.WGMMA
        assert pl.blocks == B * 264
    one, eight = (da.plan(B, 220, 28, 4, 128, 2049, BF, BF, sms=SMS) for B in (1, 8))
    assert one.splits == eight.splits == 2 and one.span == eight.span
    assert eight.blocks == 8 * one.blocks


@pytest.mark.parametrize("B", [2, 3, 8])
@pytest.mark.parametrize("S,q,kv", [(1, BF, BF), (4, BF, BF), (49, BF, BF), (196, BF, BF),
                                    (1, F32, BF), (49, F32, BF), (49, BF, I8)])
def test_plan_splits_never_follow_the_batch(B, S, q, kv):
    """A batch of B rows launches B times one row's blocks with one row's
    splits and slots: the 7B's token, verify step, frame chunk and fused pass
    (14 of 28 heads too: a rank's heads under --mesh_model 2), each row summing
    in the order it does alone."""
    for NH, KVH in ((28, 4), (14, 2)):
        one = da.plan(1, S, NH, KVH, 128, 2081, q, kv, sms=SMS)
        pl = da.plan(B, S, NH, KVH, 128, 2081, q, kv, sms=SMS)
        assert (pl.path, pl.splits, pl.span, pl.row_tiles) == (
            one.path, one.splits, one.span, one.row_tiles)
        assert pl.blocks == B * one.blocks


# -- the split-and-merge arithmetic --------------------------------------------------


def _operands(rng, B, S, NH, KVH, Dh, Wp, int8=False):
    """numpy operands: q_rot, K, V, cos, sin, order (with empty slots), g
    (each query sees part of the cache), int8 scales."""
    q = rng.standard_normal((B, S, NH, Dh)).astype(np.float32)
    if int8:
        k, v = (rng.integers(-127, 128, (B, Wp, KVH, Dh)).astype(np.int8) for _ in range(2))
        scales = tuple((rng.random((B, Wp, KVH)) * 0.02 + 0.005).astype(np.float32)
                       for _ in range(2))
    else:
        k, v = (rng.standard_normal((B, Wp, KVH, Dh)).astype(np.float32) for _ in range(2))
        scales = None
    ang = rng.random((B, Wp, Dh // 2)).astype(np.float32) * 6.283
    ang = np.concatenate([ang, ang], axis=-1)
    order = np.stack([rng.permutation(Wp) for _ in range(B)]).astype(np.int32)
    order[:, -3:] = -1
    g = np.tile(Wp - S - Wp // 4 + np.arange(S, dtype=np.int32), (B, 1))
    return q, k, v, np.cos(ang), np.sin(ang), order, g, scales


def _jax_kernel(ops, dtype):
    q, k, v, cos, sin, order, g, scales = ops
    cast = (lambda x: jnp.asarray(x, dtype)) if dtype is not None else jnp.asarray
    kv = (jnp.asarray(k), jnp.asarray(v)) if k.dtype == np.int8 else (cast(k), cast(v))
    sc = None if scales is None else tuple(jnp.asarray(s) for s in scales)
    out = cached_decode_attention(cast(q), *kv, jnp.asarray(cos), jnp.asarray(sin),
                                  jnp.asarray(order), jnp.asarray(g), sc, interpret=True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _torch(ops, dtype=F32):
    q, k, v, cos, sin, order, g, scales = ops
    kv = (_t(k), _t(v)) if k.dtype == np.int8 else (_t(k).to(dtype), _t(v).to(dtype))
    sc = None if scales is None else tuple(_t(s) for s in scales)
    return [_t(q).to(dtype), *kv, _t(cos), _t(sin), _t(order), _t(g), sc]


@pytest.mark.parametrize("int8", [False, True], ids=["f32-kv", "int8-kv"])
@pytest.mark.parametrize("sms", [1, 132])
def test_split_emulation_matches_jax_kernel_f32(int8, sms):
    """f32 everywhere: the emulation, with two splits (sms = 1: an SM's four
    resident blocks over one batch row's two) and with the nine the card
    gets, against the JAX kernel and the port's plain version at 1e-4. S = 5
    at 4 / 2 heads: 10 rows, the CUDA-core path."""
    ops = _operands(np.random.default_rng(11 + int8), 2, 5, 4, 2, 128, 264, int8)
    args = _torch(ops)
    pl = da.plan(2, 5, 4, 2, 128, 264, F32, I8 if int8 else F32, sms=sms)
    assert pl.path == da.CUDA_CORES and pl.splits == (2 if sms == 1 else 9)
    emu = da.decode_attention_split_plain(*args, pl=pl).numpy()
    np.testing.assert_allclose(emu, _jax_kernel(ops, None), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(emu, da.decode_attention_plain(*args).numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kv", [BF, F32], ids=["bf16-kv", "f32-kv"])
@pytest.mark.parametrize("sms", [1, 132])
def test_split_emulation_f32_planes_matches_jax_kernel(kv, sms):
    """The f32 tensor-core path's arithmetic (q in three bf16 planes, the
    rotated key and an f32 V in two, p in three; f32 sums): f32 q against a
    bf16 cache, read as it lies, and against an f32 cache, with one split
    (sms = 1) and with the card's, against the JAX kernel with f32 q (which
    widens a bf16 cache on load and keeps the rotated key and p f32) and
    against the port's plain version, within 1e-5 of the largest output: the
    key's two planes hold it to 2^-18 of itself. S = 6 at 8 / 2 heads: 24
    rows, 520 slots, 3 splits of 192 on the card."""
    q, k, v, cos, sin, order, g, _ = _operands(np.random.default_rng(31), 1, 6, 8, 2, 128, 520)
    kc, vc = (_t(x).to(kv) for x in (k, v))
    args = [_t(q), kc, vc, _t(cos), _t(sin), _t(order), _t(g), None]
    pl = da.plan(1, 6, 8, 2, 128, 520, F32, kv, sms=sms)
    assert pl.path == da.WGMMA_F32 and pl.splits == (1 if sms == 1 else 3)
    emu = da.decode_attention_split_plain(*args, pl=pl, f32_planes=True)
    assert emu.dtype == F32
    jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16 if kv == BF else jnp.float32)
              for x in (kc, vc))
    ref = np.asarray(cached_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(order),
        jnp.asarray(g), None, interpret=True))
    assert np.abs(emu.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    plain = da.decode_attention_plain(*args).numpy()
    assert np.abs(emu.numpy() - plain).max() <= 1e-5 * np.abs(plain).max()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-kv", "int8-kv"])
def test_split_emulation_bf16_matches_jax_kernel_bf16(int8):
    """The tensor-core path's roundings (rotated K and p to bf16, bf16 q and
    output) against the JAX kernel in bf16, which rounds the rotated key and
    p where the kernel does and also takes cos / sin in bf16: within the card
    tolerance of chip_smoke.py, 1e-2 of the largest output. S = 6 at 8 / 2
    heads: 24 rows, the tensor-core path, 3 splits of 192 slots."""
    ops = _operands(np.random.default_rng(21 + int8), 1, 6, 8, 2, 128, 520, int8)
    args = _torch(ops, BF)
    pl = da.plan(1, 6, 8, 2, 128, 520, BF, I8 if int8 else BF, sms=SMS)
    assert pl.path == da.WGMMA and pl.splits == 3
    emu = da.decode_attention_split_plain(*args, pl=pl, bf16_products=True).float().numpy()
    ref = _jax_kernel(ops, jnp.bfloat16)
    assert np.abs(emu - ref).max() <= 1e-2 * np.abs(ref).max()
    plain = da.decode_attention_plain(*args).float().numpy()
    assert np.abs(emu - plain).max() <= 1e-2 * np.abs(plain).max()


def _schedule(jpolicy, tpolicy, schedule, B, KVH, NH, Dh, seed, tol):
    """The chunk schedule of test_torch_attention.py: the JAX cache and the
    port's written alike, then the emulation of each chunk's attention (with
    the plan of the card, in its arithmetic, and where that is the f32 tensor
    cores' also with the CUDA cores' plan) against the jnp path and the JAX
    kernel. -> the (path, splits) emulated, the card's path of each chunk."""
    from aha_tpu.ops.pallas.decode_attention import cached_decode_attention as jkernel
    from aha_tpu.ops.rope import apply_rope as japply_rope
    from aha_tpu.ops.rope import rope_cos_sin as jrope_cos_sin

    rng = np.random.default_rng(seed)
    jc = jkv.init_cache(jpolicy, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=Dh,
                        dtype=jnp.float32)
    tc = tkv.init_cache(tpolicy, device="cpu", num_layers=1, batch=B, num_kv_heads=KVH,
                        head_dim=Dh, dtype=torch.float32)
    sink_slots = jpolicy.num_sink if jpolicy.kind == "sink" else 0
    splits, paths = set(), []
    for S, vl in schedule:
        k_new, v_new, q = (rng.standard_normal(s).astype(np.float32)
                           for s in ((B, S, KVH, Dh), (B, S, KVH, Dh), (B, S, NH, Dh)))
        jplan = jkv.plan_update(jc, jpolicy, jnp.asarray(vl, jnp.int32), S)
        k_c, v_c, _, _ = jkv.write_layer(jc.k[0], jc.v[0], jnp.asarray(k_new),
                                         jnp.asarray(v_new), jplan, rope_theta=THETA)
        ref = np.asarray(jattn.cached_attention(
            jnp.asarray(q), k_c, v_c, jplan, rope_theta=THETA, sink_slots=sink_slots,
            sink_policy=jpolicy.kind == "sink", mask_mode=jpolicy.mask_mode,
            evicting=jpolicy.kind in ("sink", "sliding")))
        # the JAX kernel fed as aha_tpu/ops/attention.py feeds it
        w_cos, w_sin = jrope_cos_sin(jplan.write_pos, Dh, THETA)
        q_rot = japply_rope(jnp.asarray(q), w_cos, w_sin)
        D = (jplan.g[:, :1] - jplan.q_pos[:, :1]).astype(jnp.int32)
        delta = (jnp.where(jplan.new_order >= 0, jplan.new_key_pos - jplan.new_order + D, 0)
                 if jpolicy.kind == "sink" else jnp.zeros_like(jplan.new_key_pos))
        d_cos, d_sin = jrope_cos_sin(delta, Dh, THETA)
        if jpolicy.mask_mode == "hf":
            mo, mg = jkv.reference_mask_operands(jplan, sink_slots=sink_slots)
        else:
            mo, mg = jplan.new_order, jplan.g
        kern = np.asarray(jkernel(q_rot, k_c, v_c, d_cos, d_sin, mo, mg, interpret=True))
        jc = jkv.advance(jc, jplan, jc.k.at[0].set(k_c), jc.v.at[0].set(v_c))
        # port: the cache written as cached_attention's caller writes it, then the emulation
        tplan = tkv.plan_update(tc, tpolicy, torch.tensor(vl, dtype=torch.int32), S)
        tables = tattn.chunk_tables(tplan, tpolicy, Dh, THETA)
        tkv.write_layer(tc.k[0], tc.v[0], _t(k_new), _t(v_new), tplan,
                        rot=(tables.w_cos, tables.w_sin))
        tq = apply_rope(_t(q), tables.w_cos, tables.w_sin)
        Wp = tc.k.shape[2]
        # the card's plan, and the CUDA cores' where the card takes the tensor cores
        pl = da.plan(B, S, NH, KVH, Dh, Wp, F32, F32, sms=SMS)
        paths.append(pl.path)
        plans = [pl] + ([da.plan_on(da.CUDA_CORES, B, S, NH, KVH, Wp, sms=SMS)]
                        if pl.path != da.CUDA_CORES else [])
        for pl in plans:
            splits.add((pl.path, pl.splits))
            out = da.decode_attention_split_plain(
                tq, tc.k[0], tc.v[0], tables.d_cos, tables.d_sin, tables.mask_order,
                tables.mask_g, pl=pl, f32_planes=pl.path == da.WGMMA_F32).numpy()
            np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
            np.testing.assert_allclose(out, kern, rtol=tol, atol=tol)
        tkv.advance(tc, tplan)
    return splits, paths


@pytest.mark.parametrize("mask_mode", ["hf", "strict"])
def test_split_emulation_sink_schedule(mask_mode):
    """Sink policy, window 192 (193 slots): ragged chunks through the first
    eviction and the fill transient, against the jnp path and the JAX kernel
    at 1e-4 (test_torch_attention.py's tolerance on this schedule). Every
    chunk has 128 rows and more: the card's plan is the f32 tensor cores' (one
    split of 4 slot tiles; the sink slots' residual rotation gives the key a
    lo plane, the ring slots' none), and the CUDA cores' plan (7 splits of 32
    slots at 2 x 2 blocks) is held too."""
    kw = dict(window=192, num_sink=16, mask_mode=mask_mode)
    schedule = [(112, (100, 60)), (96, (96, 96)), (64, (40, 64)), (64, (64, 20))]
    splits, paths = _schedule(jkv.CachePolicy("sink", slot_pad=64, **kw),
                              tkv.CachePolicy("sink", **kw), schedule, B=2, KVH=2, NH=4, Dh=128,
                              seed=0, tol=1e-4)
    assert set(paths) == {da.WGMMA_F32}
    assert (da.WGMMA_F32, 1) in splits and max(n for p, n in splits if p == da.CUDA_CORES) > 1


def test_split_emulation_single_token():
    """The generation path at S = 1 (3 rows per kv head) after a prefill, one
    step with nothing new: 31 slots of 121 visible, 4 splits on the CUDA
    cores; the prefill (96 rows) on the f32 tensor cores, and held on the
    CUDA cores' plan too."""
    schedule = [(32, (32,)), (1, (1,)), (1, (0,)), (1, (1,))]
    splits, paths = _schedule(jkv.CachePolicy("sliding", window=120, slot_pad=8),
                              tkv.CachePolicy("sliding", window=120), schedule,
                              B=1, KVH=2, NH=6, Dh=128, seed=1, tol=1e-4)
    assert paths == [da.WGMMA_F32] + [da.CUDA_CORES] * 3
    assert {n for p, n in splits if p == da.CUDA_CORES} == {4}


def test_split_with_no_visible_slot_for_some_rows():
    """Split 0 (slots 0 .. 31) holds only slots that rows s = 0, 1 cannot
    see; its m is -inf for them and it must add nothing (no NaN from
    e^(-inf - M)); the other rows see slots in every split."""
    rng = np.random.default_rng(5)
    B, S, NH, KVH, Dh, Wp = 1, 4, 4, 2, 32, 96
    q, k, v, cos, sin, order, g, _ = _operands(rng, B, S, NH, KVH, Dh, Wp)
    order[0] = np.arange(Wp)
    order[0, :32] += 1000            # invisible to every row with g < 1000
    g[0] = [40, 70, 2000, 2000]
    args = _torch((q, k, v, cos, sin, order, g, None))
    pl = da.plan(B, S, NH, KVH, Dh, Wp, F32, F32, sms=SMS)
    assert pl.splits == 3 and pl.span == 32
    emu = da.decode_attention_split_plain(*args, pl=pl)
    assert torch.isfinite(emu).all()
    torch.testing.assert_close(emu, da.decode_attention_plain(*args), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_split_row_that_sees_nothing_gives_zeros(bf16):
    """g below every order: the row sees no slot in any split and comes out
    as exact zeros on both tensor-core paths (bf16, and f32 in planes); the
    other rows are untouched."""
    rng = np.random.default_rng(6)
    B, S, NH, KVH, Dh, Wp = 2, 8, 4, 2, 128, 400
    ops = list(_operands(rng, B, S, NH, KVH, Dh, Wp))
    ops[6][:, 3] = -1
    args = _torch(ops, BF if bf16 else F32)
    pl = da.plan(B, S, NH, KVH, Dh, Wp, args[0].dtype, args[1].dtype, sms=SMS)
    assert pl.path == (da.WGMMA if bf16 else da.WGMMA_F32) and pl.splits > 1
    emu = da.decode_attention_split_plain(*args, pl=pl, bf16_products=bf16,
                                          f32_planes=not bf16)
    plain = da.decode_attention_plain(*args)
    assert torch.count_nonzero(emu[:, 3]) == 0 and torch.count_nonzero(plain[:, 3]) == 0
    assert torch.count_nonzero(emu[:, 2]) > 0
    if not bf16:
        torch.testing.assert_close(emu, plain, rtol=1e-5, atol=1e-5)


def test_split_emulation_one_split_equals_plain():
    """A plan of one split (sms = 1, 8 kv heads) walks the whole window in
    one block: the emulation is the plain version up to the order of f32 sums."""
    ops = _operands(np.random.default_rng(7), 1, 3, 16, 8, 64, 150)
    args = _torch(ops)
    pl = da.plan(1, 3, 16, 8, 64, 150, F32, F32, sms=1)
    assert pl.splits == 1 and pl.span >= 150
    torch.testing.assert_close(da.decode_attention_split_plain(*args, pl=pl),
                               da.decode_attention_plain(*args), rtol=1e-5, atol=1e-5)


def test_decode_attention_wrapper_refuses_misaligned_rows():
    """The kernels read q, K, V, cos and sin in 16-byte vectors: a tensor
    whose first element is 8 bytes past a 16-byte boundary is refused, where
    the 4-element rule alone let it through."""
    B, S, NH, KVH, Dh, Wp = 1, 2, 4, 2, 128, 64
    base = torch.zeros(B * S * NH * Dh + 4, dtype=BF)
    q = base[4:].view(B, S, NH, Dh)      # 8 bytes in: 4-element aligned, not 16-byte
    args = [q, torch.zeros(B, Wp, KVH, Dh, dtype=BF), torch.zeros(B, Wp, KVH, Dh, dtype=BF),
            torch.zeros(B, Wp, Dh), torch.zeros(B, Wp, Dh),
            torch.zeros(B, Wp, dtype=torch.int32), torch.zeros(B, S, dtype=torch.int32), None]
    with pytest.raises(ValueError, match="16-byte"):
        da._check(*args)
    args[0] = q.clone()
    da._check(*args)


def test_decode_attention_wrapper_refuses_a_grid_too_tall():
    """B * KVH rows of the grid's third axis: at most 65,535."""
    z = torch.zeros
    args = (z(65536, 1, 1, 16, device="meta"), z(65536, 8, 1, 16, device="meta"),
            z(65536, 8, 1, 16, device="meta"), z(65536, 8, 16, device="meta"),
            z(65536, 8, 16, device="meta"), z(65536, 8, dtype=torch.int32, device="meta"),
            z(65536, 1, dtype=torch.int32, device="meta"), None)
    with pytest.raises(ValueError, match="grid"):
        da._check(*args)


@pytest.mark.parametrize("qdt, kvdt", [(F32, BF), (BF, F32)], ids=["f32-q-bf16-kv", "bf16-q-f32-kv"])
def test_cached_attention_hands_the_cache_as_it_lies(monkeypatch, qdt, kvdt):
    """``cached_attention``: f32 queries against a bf16 cache (a frame chunk
    behind a peft artifact's f32 projector) reach ``decode_attention`` with
    the bf16 cache as it lies, no widened copy, and give f32; bf16 queries
    against an f32 cache (the local judge's) are widened to f32 and their
    output rounded to bf16. Either equals JAX's kernel on the same values
    within 1e-5 of the largest output (bf16 out: one bf16 step)."""
    rng = np.random.default_rng(41)
    B, S, NH, KVH, Dh, Wp = 1, 5, 8, 2, 128, 96
    q, k, v, cos, sin, order, g, _ = _operands(rng, B, S, NH, KVH, Dh, Wp)
    w_ang = rng.random((B, S, Dh // 2)).astype(np.float32) * 6.283
    w_ang = np.concatenate([w_ang, w_ang], axis=-1)
    tables = tattn.ChunkTables(_t(np.cos(w_ang)), _t(np.sin(w_ang)), _t(cos), _t(sin), _t(order),
                               _t(g))
    seen = []
    real = tattn.decode_attention

    def recorded(q_rot, k_cache, v_cache, *a):
        seen.append((q_rot.dtype, k_cache.dtype, v_cache.dtype))
        return real(q_rot, k_cache, v_cache, *a)

    monkeypatch.setattr(tattn, "decode_attention", recorded)
    kc, vc = _t(k).to(kvdt), _t(v).to(kvdt)
    out = tattn.cached_attention(_t(q).to(qdt), kc, vc, tables)
    assert seen == [(F32, kvdt, kvdt)] and out.dtype == qdt
    q_rot = apply_rope(_t(q).to(qdt).float(), tables.w_cos, tables.w_sin).to(qdt)
    ref = np.asarray(cached_decode_attention(
        jnp.asarray(q_rot.float().numpy()), *(jnp.asarray(x.float().numpy(), jnp.float32)
                                             for x in (kc, vc)),
        jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(order), jnp.asarray(g), None,
        interpret=True))
    tol = 1e-5 if qdt == F32 else 2.0 ** -8
    assert np.abs(out.float().numpy() - ref).max() <= tol * np.abs(ref).max()
