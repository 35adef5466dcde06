"""Model-level parity at the tiny preset, f32, on the CPU: the vision path
(letterbox, SigLIP tower, pooling, projector), the score heads and
decode_chunk over the sink cache through the first eviction (hidden states
and the cache state after every chunk), dense, int8 and packed int4 with
merged projections, the int8-activation backend against JAX's w8a8 recipe,
and the layout of the port's seeded synthetic params."""

import dataclasses
import functools

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

from aha_tpu_torch import config as tconfig
from aha_tpu_torch import bridge
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


# the bridge puts a tree on the card unless told otherwise; these tests run on the host
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def port_cfg(cfg):
    """The port's own AhaConfig from the JAX package's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


@pytest.fixture(scope="module")
def model():
    params, cfg, _ = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    return params, cfg


@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_visual_embed(model, hw):
    params, cfg = model
    frames = np.random.default_rng(0).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    ref = np.asarray(jaha.visual_embed(params, cfg, jnp.asarray(frames)))
    out = taha.visual_embed(params_from_jax(jax.tree.map(np.asarray, params)), port_cfg(cfg),
                            _t(frames)).numpy()
    assert out.shape == ref.shape == (3, cfg.frame_num_tokens, cfg.llm.hidden_size)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_score_heads(model):
    params, cfg = model
    h = np.random.default_rng(1).standard_normal((2, 5, cfg.llm.hidden_size)).astype(np.float32)
    ref = np.asarray(_scores_from_hidden(params, cfg, jnp.asarray(h)))
    out = taha.scores_from_hidden(params_from_jax(jax.tree.map(np.asarray, params)), _t(h))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("variant", ["dense", "int8_merged", "int4_merged"])
def test_decode_chunk(model, variant):
    """Ragged chunks through a 48-slot sink cache (window fill, eviction,
    hf post-fill mask). int8 / int4: JAX dequantizes then multiplies (its
    path off the TPU), the port scales the integer product's f32 sum (per
    channel, or per group: one group per kernel at these widths); the two
    agree to f32 rounding, 1e-5."""
    params, cfg = model
    llm = params["llm"]
    if variant != "dense":
        bits = 4 if variant == "int4_merged" else 8
        llm = quant.merge_decoder_projections(quant.quantize_params(params, bits=bits)["llm"])
        assert ("q4value" in llm["layers"]["qkv_proj"]["kernel"]) == (bits == 4)
    tllm = params_from_jax(jax.tree.map(np.asarray, llm))
    q = cfg.llm
    tq = port_cfg(cfg).llm
    kw = dict(window=48, num_sink=4)
    jp, tp = jkv.CachePolicy("sink", **kw), tkv.CachePolicy("sink", **kw)
    shape = dict(num_layers=q.num_layers, batch=2, num_kv_heads=q.num_kv_heads,
                 head_dim=q.head_dim)
    jc = jkv.init_cache(jp, dtype=jnp.float32, **shape)
    tc = tkv.init_cache(tp, device="cpu", dtype=torch.float32, **shape)
    jdecode = jax.jit(jqwen2.decode_chunk, static_argnums=(1, 2))
    rng = np.random.default_rng(2)
    for S, vl in [(20, (20, 13)), (16, (16, 16)), (16, (9, 16)), (1, (1, 1)), (16, (16, 5))]:
        x = rng.standard_normal((2, S, q.hidden_size)).astype(np.float32)
        jh, jc = jdecode(llm, q, jp, jc, jnp.asarray(x), jnp.asarray(vl, jnp.int32))
        th = tqwen2.decode_chunk(tllm, tq, tp, tc, _t(x), torch.tensor(vl, dtype=torch.int32))
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
    np.testing.assert_allclose(tqwen2.lm_logits(tllm, tq, _t(h)).numpy(),
                               np.asarray(jqwen2.lm_logits(llm, q, jnp.asarray(h))), atol=ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_chunk_int8_activations(model, bits, monkeypatch):
    """backend="fused_a8" (per-token int8 activations in every decoder
    projection). int8 weights: against JAX under its w8a8 recipe
    (quant._FORCE_BACKEND, set and reset by monkeypatch), which is the same
    arithmetic: 1e-4, ten times the weight-only bound, because a rounding
    tie in the activation quantiser that falls the other way moves one
    int8 step of one activation. int4 weights: JAX has no int8-activation
    path off the TPU, so the port is held to its own weight-only result
    within the recipe's error (3% of the hidden states' mean magnitude, the
    bound of tests/test_fused_matmul.py::test_int4_matmul_a8_close_to_dequant)."""
    params, cfg = model
    llm = quant.merge_decoder_projections(quant.quantize_params(params, bits=bits)["llm"])
    tllm = params_from_jax(jax.tree.map(np.asarray, llm))
    q, tq = cfg.llm, port_cfg(cfg).llm
    kw = dict(window=48, num_sink=4)
    jp, tp = jkv.CachePolicy("sink", **kw), tkv.CachePolicy("sink", **kw)
    shape = dict(num_layers=q.num_layers, batch=2, num_kv_heads=q.num_kv_heads,
                 head_dim=q.head_dim)
    tc = tkv.init_cache(tp, device="cpu", dtype=torch.float32, **shape)
    x = np.random.default_rng(3).standard_normal((2, 20, q.hidden_size)).astype(np.float32)
    vl = torch.tensor((20, 13), dtype=torch.int32)
    th = tqwen2.decode_chunk(tllm, tq, tp, tc, _t(x), vl, backend="fused_a8").numpy()
    if bits == 8:
        monkeypatch.setattr(quant, "_FORCE_BACKEND", "w8a8")
        jc = jkv.init_cache(jp, dtype=jnp.float32, **shape)
        jh, _ = jqwen2.decode_chunk(llm, q, jp, jc, jnp.asarray(x), jnp.asarray(vl.numpy()))
        np.testing.assert_allclose(th, np.asarray(jh), atol=1e-4)
    else:
        fresh = tkv.init_cache(tp, device="cpu", dtype=torch.float32, **shape)
        ref = tqwen2.decode_chunk(tllm, tq, tp, fresh, _t(x), vl).numpy()
        assert np.abs(th - ref).mean() < 0.03 * np.abs(ref).mean()
        assert np.abs(th - ref).max() > 0          # the activations really were quantised


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_random_params_layout(model, mode):
    """The seeded synthetic params have the leaves, shapes and dtypes of the
    JAX tree they stand in for: quantize_params(bits) + merged decoder
    projections, bridged (vision tower and heads dense, embedding int8)."""
    params, cfg = model
    bits = 4 if mode == "int4" else 8
    qp = quant.quantize_params(params, bits=bits)
    ref = params_from_jax(jax.tree.map(
        np.asarray, {**qp, "llm": quant.merge_decoder_projections(qp["llm"])}))
    out = taha.random_params(port_cfg(cfg), mode=mode, device="cpu", seed=1)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, (tuple(tree.shape), tree.dtype)

    assert dict(leaves(out)) == dict(leaves(ref))
    with pytest.raises(ValueError, match="mode"):
        taha.random_params(port_cfg(cfg), mode="int2", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            taha.random_params(port_cfg(cfg), mode=mode)      # the default is the card
