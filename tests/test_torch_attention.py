"""Parity: the port's cached attention (the plain version of the CUDA kernel
in aha_tpu_torch/csrc/decode_attention.cu) against the JAX jnp path
(ops/attention.cached_attention) and the JAX Pallas kernel
(cached_decode_attention, interpret mode), on the chunk schedule of
tests/test_decode_attention.py. Inputs come from a numpy seed and go to
both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aha_tpu.ops import attention as jattn
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops.pallas.decode_attention import cached_decode_attention
from aha_tpu.ops.rope import apply_rope as japply_rope
from aha_tpu.ops.rope import rope_cos_sin as jrope_cos_sin

from aha_tpu_torch.ops import attention as tattn
from aha_tpu_torch.ops import kv_cache as tkv
from aha_tpu_torch.ops.kernels.decode_attention import decode_attention
from aha_tpu_torch.ops.rope import rope_cos_sin as trope_cos_sin


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


THETA = 10_000.0


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _jax_kernel(q, k_c, v_c, plan, policy, kv_scales=None):
    """The JAX kernel fed exactly as ops/attention.py feeds it."""
    Dh = q.shape[-1]
    w_cos, w_sin = jrope_cos_sin(plan.write_pos, Dh, THETA)
    q_rot = japply_rope(q.astype(jnp.float32), w_cos, w_sin).astype(q.dtype)
    D = (plan.g[:, :1] - plan.q_pos[:, :1]).astype(jnp.int32)
    if policy.kind == "sink":
        delta = jnp.where(plan.new_order >= 0, plan.new_key_pos - plan.new_order + D, 0)
    else:
        delta = jnp.zeros_like(plan.new_key_pos)
    d_cos, d_sin = jrope_cos_sin(delta, Dh, THETA)
    if policy.mask_mode == "hf" and policy.kind in ("sink", "sliding"):
        mo, mg = jkv.reference_mask_operands(
            plan, sink_slots=policy.num_sink if policy.kind == "sink" else 0)
    else:
        mo, mg = plan.new_order, plan.g
    return np.asarray(cached_decode_attention(q_rot, k_c, v_c, d_cos, d_sin, mo, mg,
                                              kv_scales, interpret=True))


def _run(jpolicy, tpolicy, schedule, B, KVH, NH, Dh, seed, tol_jnp, tol_kernel):
    rng = np.random.default_rng(seed)
    jc = jkv.init_cache(jpolicy, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=Dh,
                        dtype=jnp.float32)
    tc = tkv.init_cache(tpolicy, device="cpu", num_layers=1, batch=B, num_kv_heads=KVH,
                        head_dim=Dh, dtype=torch.float32)
    sink_slots = jpolicy.num_sink if jpolicy.kind == "sink" else 0
    for S, vl in schedule:
        k_new, v_new, q = (rng.standard_normal(s).astype(np.float32)
                           for s in ((B, S, KVH, Dh), (B, S, KVH, Dh), (B, S, NH, Dh)))
        # JAX: jnp reference path and the Pallas kernel
        jplan = jkv.plan_update(jc, jpolicy, jnp.asarray(vl, jnp.int32), S)
        k_c, v_c, _, _ = jkv.write_layer(jc.k[0], jc.v[0], jnp.asarray(k_new),
                                         jnp.asarray(v_new), jplan, rope_theta=THETA)
        ref = np.asarray(jattn.cached_attention(
            jnp.asarray(q), k_c, v_c, jplan, rope_theta=THETA, sink_slots=sink_slots,
            sink_policy=jpolicy.kind == "sink", mask_mode=jpolicy.mask_mode,
            evicting=jpolicy.kind in ("sink", "sliding")))
        kern = _jax_kernel(jnp.asarray(q), k_c, v_c, jplan, jpolicy)
        jc = jkv.advance(jc, jplan, jc.k.at[0].set(k_c), jc.v.at[0].set(v_c))
        # port
        tplan = tkv.plan_update(tc, tpolicy, torch.tensor(vl, dtype=torch.int32), S)
        tables = tattn.chunk_tables(tplan, tpolicy, Dh, THETA)
        tkv.write_layer(tc.k[0], tc.v[0], _t(k_new), _t(v_new), tplan,
                        rot=(tables.w_cos, tables.w_sin))
        out = tattn.cached_attention(_t(q), tc.k[0], tc.v[0], tables).numpy()
        tkv.advance(tc, tplan)
        np.testing.assert_allclose(out, ref, rtol=tol_jnp, atol=tol_jnp)
        np.testing.assert_allclose(out, kern, rtol=tol_kernel, atol=tol_kernel)


@pytest.mark.parametrize("mask_mode", ["hf", "strict"])
def test_cached_attention_sink_schedule(mask_mode):
    """Sink policy, window 192: ragged chunks through the first eviction and
    the fill transient. 1e-4: there the jnp path rotates keys write_pos ->
    key_pos while the kernel form composes delta_pos on the stored keys
    (same angles, another f32 evaluation order; test_decode_attention.py)."""
    kw = dict(window=192, num_sink=16, mask_mode=mask_mode)
    schedule = [(112, (100, 60)), (96, (96, 96)), (64, (40, 64)), (64, (64, 20))]
    # the JAX kernel wants block-aligned slots; the port's W+1 slots are
    # masked in the kernel, and the extra JAX slots are never visible
    _run(jkv.CachePolicy("sink", slot_pad=64, **kw), tkv.CachePolicy("sink", **kw), schedule,
         B=2, KVH=2, NH=4, Dh=128, seed=0, tol_jnp=1e-4, tol_kernel=1e-4)


def test_cached_attention_single_token():
    """The generation path: S=1 chunks after a prefill, incl. an empty step."""
    schedule = [(32, (32,)), (1, (1,)), (1, (0,)), (1, (1,))]
    _run(jkv.CachePolicy("sliding", window=120, slot_pad=8),
         tkv.CachePolicy("sliding", window=120), schedule,
         B=1, KVH=2, NH=6, Dh=128, seed=1, tol_jnp=2e-5, tol_kernel=2e-5)


def test_cached_attention_int8_kv():
    """int8 KV cache: the per-(slot, head) scales fold into score and
    probability columns. The port's write path quantizes like JAX's, and its
    attention matches the JAX kernel on the same int8 operands and the jnp
    int8 path."""
    jpolicy = jkv.CachePolicy("sliding", window=120, slot_pad=8)
    tpolicy = tkv.CachePolicy("sliding", window=120)
    rng = np.random.default_rng(3)
    B, KVH, NH, Dh, S = 2, 2, 4, 128, 96
    jc = jkv.init_cache(jpolicy, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=Dh,
                        dtype=jnp.int8)
    tc = tkv.init_cache(tpolicy, device="cpu", num_layers=1, batch=B, num_kv_heads=KVH,
                        head_dim=Dh,
                        dtype=torch.int8)
    for vl in [(96, 80), (64, 96)]:
        k_new, v_new = (rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
                        for _ in range(2))
        jplan = jkv.plan_update(jc, jpolicy, jnp.asarray(vl, jnp.int32), S)
        k_c, v_c, ks, vs = jkv.write_layer(jc.k[0], jc.v[0], jnp.asarray(k_new),
                                           jnp.asarray(v_new), jplan, jc.k_scale[0],
                                           jc.v_scale[0], rope_theta=THETA)
        jc = jkv.advance(jc, jplan, jc.k.at[0].set(k_c), jc.v.at[0].set(v_c),
                         jc.k_scale.at[0].set(ks), jc.v_scale.at[0].set(vs))
        tplan = tkv.plan_update(tc, tpolicy, torch.tensor(vl, dtype=torch.int32), S)
        tkv.write_layer(tc.k[0], tc.v[0], _t(k_new), _t(v_new), tplan, tc.k_scale[0],
                        tc.v_scale[0], rot=trope_cos_sin(tplan.write_pos, Dh, THETA))
        tkv.advance(tc, tplan)
    # the quantized cache, junk slot aside (it takes the padded tokens in no
    # set order): scales to f32 rounding, values within one step of the
    # int8 grid (the rotated keys differ in the last bit before rounding)
    W = tpolicy.window
    np.testing.assert_allclose(tc.k_scale.numpy()[:, :, :W], np.asarray(jc.k_scale)[:, :, :W],
                               rtol=1e-6)
    np.testing.assert_allclose(tc.v_scale.numpy()[:, :, :W], np.asarray(jc.v_scale)[:, :, :W],
                               rtol=1e-6)
    dk = tc.k.numpy()[:, :, :W].astype(int) - np.asarray(jc.k)[:, :, :W].astype(int)
    assert np.abs(dk).max() <= 1
    np.testing.assert_array_equal(tc.v.numpy()[:, :, :W], np.asarray(jc.v)[:, :, :W])

    # attention on identical int8 operands (the JAX cache's)
    Sq = 8
    q = rng.standard_normal((B, Sq, NH, Dh)).astype(np.float32)
    jplan = jkv.plan_update(jc, jpolicy, jnp.asarray((Sq, Sq), jnp.int32), Sq)
    scales = (jc.k_scale[0], jc.v_scale[0])
    kern = _jax_kernel(jnp.asarray(q), jc.k[0], jc.v[0], jplan, jpolicy, scales)
    ref = np.asarray(jattn.cached_attention(
        jnp.asarray(q), jc.k[0], jc.v[0], jplan, rope_theta=THETA, sink_policy=False,
        evicting=True, kv_scales=scales))
    tc.k.copy_(_t(jc.k[:, :, :W + 1]))
    tc.k_scale.copy_(_t(jc.k_scale[:, :, :W + 1]))
    tplan = tkv.plan_update(tc, tpolicy, torch.tensor((Sq, Sq), dtype=torch.int32), Sq)
    tables = tattn.chunk_tables(tplan, tpolicy, Dh, THETA)
    out = tattn.cached_attention(_t(q), tc.k[0], tc.v[0], tables,
                                 (tc.k_scale[0], tc.v_scale[0])).numpy()
    np.testing.assert_allclose(out, kern, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_decode_attention_wrapper_refuses_other_devices():
    """No silent fallback: only CPU tensors take the plain version; any
    other device reaches the kernel's checks or raises."""
    z = torch.zeros
    args = (z(1, 1, 2, 16, device="meta"), z(1, 8, 1, 16, device="meta"),
            z(1, 8, 1, 16, device="meta"), z(1, 8, 16, device="meta"),
            z(1, 8, 16, device="meta"), z(1, 8, dtype=torch.int32, device="meta"),
            z(1, 1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(*args)
