"""Model-level parity at the tiny preset, f32, on the CPU: the vision path
(letterbox, SigLIP tower, pooling, projector), the score heads and
decode_chunk over the sink cache through the first eviction (hidden states
and the cache state after every chunk), dense and int8 with merged
projections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.models import qwen2 as jqwen2
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops import quant
from aha_tpu.streaming.engine_core import _scores_from_hidden

from aha_tpu_torch.bridge import params_from_jax
from aha_tpu_torch.models import aha as taha
from aha_tpu_torch.models import qwen2 as tqwen2
from aha_tpu_torch.ops import kv_cache as tkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def model():
    params, cfg, _ = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    return params, cfg


@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_visual_embed(model, hw):
    params, cfg = model
    frames = np.random.default_rng(0).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    ref = np.asarray(jaha.visual_embed(params, cfg, jnp.asarray(frames)))
    out = taha.visual_embed(params_from_jax(jax.tree.map(np.asarray, params)), cfg,
                            _t(frames)).numpy()
    assert out.shape == ref.shape == (3, cfg.frame_num_tokens, cfg.llm.hidden_size)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_score_heads(model):
    params, cfg = model
    h = np.random.default_rng(1).standard_normal((2, 5, cfg.llm.hidden_size)).astype(np.float32)
    ref = np.asarray(_scores_from_hidden(params, cfg, jnp.asarray(h)))
    out = taha.scores_from_hidden(params_from_jax(jax.tree.map(np.asarray, params)), _t(h))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("variant", ["dense", "int8_merged"])
def test_decode_chunk(model, variant):
    """Ragged chunks through a 48-slot sink cache (window fill, eviction,
    hf post-fill mask). int8: JAX dequantizes then multiplies, the port
    scales the int8 product's f32 sum; the two agree to f32 rounding."""
    params, cfg = model
    llm = params["llm"]
    if variant == "int8_merged":
        llm = quant.merge_decoder_projections(quant.quantize_params(params)["llm"])
    tllm = params_from_jax(jax.tree.map(np.asarray, llm))
    q = cfg.llm
    kw = dict(window=48, num_sink=4)
    jp, tp = jkv.CachePolicy("sink", **kw), tkv.CachePolicy("sink", **kw)
    shape = dict(num_layers=q.num_layers, batch=2, num_kv_heads=q.num_kv_heads,
                 head_dim=q.head_dim)
    jc = jkv.init_cache(jp, dtype=jnp.float32, **shape)
    tc = tkv.init_cache(tp, dtype=torch.float32, **shape)
    jdecode = jax.jit(jqwen2.decode_chunk, static_argnums=(1, 2))
    rng = np.random.default_rng(2)
    for S, vl in [(20, (20, 13)), (16, (16, 16)), (16, (9, 16)), (1, (1, 1)), (16, (16, 5))]:
        x = rng.standard_normal((2, S, q.hidden_size)).astype(np.float32)
        jh, jc = jdecode(llm, q, jp, jc, jnp.asarray(x), jnp.asarray(vl, jnp.int32))
        th = tqwen2.decode_chunk(tllm, q, tp, tc, _t(x), torch.tensor(vl, dtype=torch.int32))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
        W = tp.window
        np.testing.assert_allclose(tc.k.numpy()[:, :, :W], np.asarray(jc.k)[:, :, :W],
                                   atol=ATOL)
        np.testing.assert_allclose(tc.v.numpy()[:, :, :W], np.asarray(jc.v)[:, :, :W],
                                   atol=ATOL)
        for f in ("order", "seen", "length"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
        np.testing.assert_array_equal(tc.key_pos.numpy()[:, :W], np.asarray(jc.key_pos)[:, :W])
    h = rng.standard_normal((2, q.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(tqwen2.lm_logits(tllm, q, _t(h)).numpy(),
                               np.asarray(jqwen2.lm_logits(llm, q, jnp.asarray(h))), atol=ATOL)
