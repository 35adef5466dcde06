"""Parity of the port's tensor ops with their JAX twins, on the CPU: RoPE,
RMSNorm, letterbox, pooling, int8 dequantize / qlinear / embedding gather,
the plain int8 matmul against the JAX Pallas kernel (interpret mode), and
the ring-buffer cache bookkeeping (plan_update, write_layer, advance,
quantize_kv, the hf mask operands). Inputs come from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aha_tpu.models import qwen2 as jqwen2
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops import pooling as jpool
from aha_tpu.ops import preprocess as jpre
from aha_tpu.ops import quant as jquant
from aha_tpu.ops import rope as jrope
from aha_tpu.ops.pallas.fused_matmul import int8_matmul as jint8_matmul

from aha_tpu_torch.bridge import params_from_jax
from aha_tpu_torch.models import qwen2 as tqwen2
from aha_tpu_torch.ops import kv_cache as tkv
from aha_tpu_torch.ops import pooling as tpool
from aha_tpu_torch.ops import preprocess as tpre
from aha_tpu_torch.ops import quant as tquant
from aha_tpu_torch.ops import rope as trope
from aha_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_rope_tables_and_rotation():
    rng = np.random.default_rng(0)
    # positions past the 8192 split and negative residuals (the sink
    # policy's delta rotations) included
    pos = rng.integers(-300, 40_000, (3, 17)).astype(np.int32)
    for dh in (16, 128):
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), dh, 1e6)
        tc, ts = trope.rope_cos_sin(_t(pos), dh, 1e6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
        x = rng.standard_normal((3, 17, 4, dh)).astype(np.float32)
        np.testing.assert_allclose(
            trope.apply_rope(_t(x), tc, ts).numpy(),
            np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js)), atol=ATOL)
        np.testing.assert_allclose(
            trope.rotate_by_positions(_t(x), _t(pos), 1e4).numpy(),
            np.asarray(jrope.rotate_by_positions(jnp.asarray(x), jnp.asarray(pos), 1e4)),
            atol=ATOL)


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(tqwen2.rms_norm(_t(x), _t(s), 1e-6).numpy(),
                               np.asarray(jqwen2.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)),
                               atol=ATOL)


@pytest.mark.parametrize("hw", [(40, 48), (50, 30), (32, 32), (17, 64)])
def test_letterbox(hw):
    """Half-pixel bilinear resize + centred pad, in 0..255 pixel units: the
    two sides sum the same two weighted taps in another order, so they
    agree to f32 rounding (atol 1e-6 plus rtol 1e-6 of the pixel value)."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    ref = np.asarray(jpre.device_letterbox(jnp.asarray(frames), 32))
    out = tpre.device_letterbox(_t(frames), 32).numpy()
    assert out.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("mode,grid,out", [("average", 24, (7, 7)), ("average", 2, (1, 1)),
                                           ("max", 8, (2, 2)), ("stride_average", 8, (4, 4))])
def test_pool_patch_tokens(mode, grid, out):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, grid * grid, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tpool.pool_patch_tokens(_t(x), grid, out, mode).numpy(),
        np.asarray(jpool.pool_patch_tokens(jnp.asarray(x), grid, out, mode)), atol=ATOL)


@pytest.fixture(scope="module")
def q8():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((256, 128)) * 0.02).astype(np.float32)
    return jquant.quantize_array(jnp.asarray(w), 0)


def test_dequantize_and_qlinear(q8):
    tq = params_from_jax({"k": q8})["k"]
    np.testing.assert_allclose(tquant.dequantize(tq, torch.float32).numpy(),
                               np.asarray(jquant.dequantize(q8, jnp.float32)), atol=ATOL)
    x = np.random.default_rng(5).standard_normal((3, 7, 256)).astype(np.float32)
    np.testing.assert_allclose(tquant.qlinear(_t(x), tq).numpy(),
                               np.asarray(jquant.qlinear(jnp.asarray(x), q8)), atol=ATOL)


@pytest.mark.parametrize("M", [1, 7, 49])
def test_int8_matmul_plain_matches_pallas(q8, M):
    """The port's plain int8 product (what the CUDA kernel is held to)
    against the JAX kernel in interpret mode; 2e-5 as in
    tests/test_fused_matmul.py."""
    x = np.random.default_rng(6 + M).standard_normal((M, 256)).astype(np.float32)
    ref = np.asarray(jint8_matmul(jnp.asarray(x), q8["qvalue"], q8["scale"],
                                  block_n=128, block_k=256, interpret=True))
    tq = params_from_jax({"k": q8})["k"]
    out = int8_matmul(_t(x), tq["qvalue"], tq["scale"])
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(out.numpy(),
                                  int8_matmul_plain(_t(x), tq["qvalue"], tq["scale"]).numpy())


def test_int8_embedding_gather():
    rng = np.random.default_rng(7)
    table = jquant.quantize_array(jnp.asarray(rng.standard_normal((50, 16)), jnp.float32), 1)
    ids = rng.integers(0, 50, (2, 9)).astype(np.int32)
    ref = np.asarray(jqwen2.embed_tokens({"embed": {"weight": table}}, jnp.asarray(ids),
                                         dtype=jnp.float32))
    tp = params_from_jax({"embed": {"weight": table}})
    np.testing.assert_allclose(tqwen2.embed_tokens(tp, _t(ids), torch.float32).numpy(), ref,
                               atol=ATOL)


def test_int4_and_foreign_devices_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tquant.qlinear(torch.zeros(2, 4), {"q4value": torch.zeros(2, 3, dtype=torch.uint8),
                                           "scale4": torch.zeros(1, 3)})
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul(torch.zeros(2, 4, device="meta"),
                    torch.zeros(4, 3, dtype=torch.int8, device="meta"),
                    torch.zeros(1, 3, device="meta"))


def test_quantize_kv():
    x = np.random.default_rng(8).standard_normal((2, 5, 2, 16)).astype(np.float32)
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("kind", ["sink", "sliding", "static", "none"])
def test_cache_bookkeeping(kind):
    """plan_update / write_layer (keys rotated at write_pos) / advance over
    ragged chunks past the window, against the JAX cache. The junk slot's
    key_pos and contents are not compared: padded tokens land there in no
    set order, and its order is forced to -1 so nothing ever reads it."""
    W = 40 if kind != "none" else 200
    kw = dict(window=W, num_sink=4)
    jp, tp = jkv.CachePolicy(kind, **kw), tkv.CachePolicy(kind, **kw)
    B, KVH, Dh = 2, 2, 16
    jc = jkv.init_cache(jp, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=Dh,
                        dtype=jnp.float32)
    tc = tkv.init_cache(tp, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=Dh,
                        dtype=torch.float32)
    rng = np.random.default_rng(9)
    for S, vl in [(12, (12, 7)), (16, (16, 16)), (9, (0, 9)), (16, (11, 16)), (1, (1, 0))]:
        k, v = (rng.standard_normal((B, S, KVH, Dh)).astype(np.float32) for _ in range(2))
        jplan = jkv.plan_update(jc, jp, jnp.asarray(vl, jnp.int32), S)
        tplan = tkv.plan_update(tc, tp, torch.tensor(vl, dtype=torch.int32), S)
        for f in ("slots", "g", "q_pos", "write_pos", "valid", "shift", "new_order",
                  "new_seen", "new_length"):
            np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                          np.asarray(getattr(jplan, f)), err_msg=f)
        np.testing.assert_array_equal(tplan.new_key_pos.numpy()[:, :W],
                                      np.asarray(jplan.new_key_pos)[:, :W])
        for mode_slots in (0, jp.num_sink):
            jr, jq = jkv.reference_mask_operands(jplan, sink_slots=mode_slots)
            tr, tq = tkv.reference_mask_operands(tplan, sink_slots=mode_slots)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        k_c, v_c, _, _ = jkv.write_layer(jc.k[0], jc.v[0], jnp.asarray(k), jnp.asarray(v),
                                         jplan, rope_theta=1e4)
        jc = jkv.advance(jc, jplan, jc.k.at[0].set(k_c), jc.v.at[0].set(v_c))
        tkv.write_layer(tc.k[0], tc.v[0], _t(k), _t(v), tplan,
                        rot=trope.rope_cos_sin(tplan.write_pos, Dh, 1e4))
        tkv.advance(tc, tplan)
        np.testing.assert_allclose(tc.k.numpy()[:, :, :W], np.asarray(jc.k)[:, :, :W],
                                   atol=ATOL)
        np.testing.assert_array_equal(tc.v.numpy()[:, :, :W], np.asarray(jc.v)[:, :, :W])
        for f in ("order", "seen", "length"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
        np.testing.assert_array_equal(tc.key_pos.numpy()[:, :W], np.asarray(jc.key_pos)[:, :W])
    tkv.reset_cache(tc)
    jc = jkv.reset_cache(jc)
    for f in ("order", "seen", "length", "key_pos"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))


def test_kernel_build_failures_raise(tmp_path, monkeypatch):
    """No silent fallback: a missing nvcc and a failing nvcc both raise (the
    build runs only on first use; nothing is written outside BUILD_DIR)."""
    from aha_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no GPU compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.library()
    assert not list((tmp_path / "build").glob("*.so"))
