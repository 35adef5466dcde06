"""The CLIP tower of the port (aha_tpu_torch/models/clip.py and its parts in
models/aha.py, models/loader.py and ops/quant.py) against the JAX package on
the CPU at the tiny preset: ``clip.forward`` dense and with int8 weights
(f32, 1e-5), ``init_params`` / ``init_aha_params`` and JAX's synthetic tree
(integer leaves bit-equal, normal leaves within 3 f32 ulps), the leaf list,
``quantize_params(quantize_vision=True)`` bit-equal, ``convert_clip`` on a
CLIPVisionModel state dict made from a seed, ``load_params`` on a CLIP
checkpoint, and a session with the CLIP tower and its CLS token:
``score_video`` at fused 1 and 4 and ``inference()`` within 1e-5 of one JAX
engine at fused 4, texts equal, ``visual_embed``'s first row the projected
CLS token."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu import config as jconfig
from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.models import aha as jaha
from aha_tpu.models import clip as jclip
from aha_tpu.models import loader as jloader
from aha_tpu.ops import quant as jquant
from aha_tpu.ops.kv_cache import CachePolicy as JCachePolicy
from aha_tpu.streaming.engine import StreamEngine as JStreamEngine
from aha_tpu.streaming.session import StreamSession as JStreamSession

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.models import aha as taha
from aha_tpu_torch.models import clip, jax_random, loader
from aha_tpu_torch.ops import quant
from aha_tpu_torch.streaming.session import build_session
from aha_tpu_torch.tokenization import build_stream_tokenizer

params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
QUERY = "What is happening in this video?"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


def bridged(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def clip_cfg(vocab_size: int = 512):
    return jconfig.aha_tiny(vocab_size).replace(vision=jconfig.clip_tiny(), frame_token_cls=True)


def assert_trees(got, ref, float_ulps: float = 0):
    """Same paths, shapes and dtypes; integer leaves bit-equal; float leaves
    within ``float_ulps`` steps of their dtype (0: bit-equal)."""
    fg, fr = loader._flatten(got), loader._flatten(ref)
    assert [p for p, _ in fg] == [p for p, _ in fr]
    for (path, a), (_, b) in zip(fg, fr):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        if not a.is_floating_point() or float_ulps == 0:
            assert torch.equal(a, b), path
            continue
        step = torch.from_numpy(np.spacing(np.abs(b.float().numpy())))
        if b.dtype == torch.bfloat16:
            step = step * 2**16
        assert ((a.float() - b.float()).abs() <= float_ulps * step).all(), path


def test_clip_presets_match_jax():
    for name in ("clip_large_336", "clip_tiny"):
        assert (dataclasses.asdict(getattr(tconfig, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
    assert tconfig.clip_large_336().grid_size == 24


@pytest.fixture(scope="module")
def tower():
    vcfg = jconfig.clip_tiny()
    params = jclip.init_params(vcfg, jax.random.PRNGKey(7))
    frames = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    return vcfg, params, frames


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_clip_init_params_matches_jax(dtype):
    """``clip.init_params`` draws JAX's tower from the same key, in slabs."""
    vcfg = jconfig.clip_tiny()
    ref = jclip.init_params(vcfg, jax.random.PRNGKey(7), jnp.dtype(dtype or "float32"))
    got = clip.init_params(tconfig.clip_tiny(), jax_random.prng_key(7),
                           getattr(torch, dtype or "float32"), "cpu", slab=777)
    assert_trees({"vision": got}, bridged({"vision": ref}),
                 float_ulps=3 if dtype is None else 1)


@pytest.mark.parametrize("quantised", [False, True])
def test_clip_forward_matches_jax(tower, quantised):
    """pixels -> tokens [N, 1 + P, H], CLS first, f32: dense within 1e-5 of
    JAX's, and with the tower's products on int8 weights (the weight-only
    kernel's plain version) within 1e-5 of JAX's ``qlinear`` path, relative to
    the largest output."""
    vcfg, params, frames = tower
    if quantised:
        params = jquant.quantize_params({"vision": params}, quantize_vision=True)["vision"]
        assert "qvalue" in params["layers"]["fc1"]["kernel"]
    ref = np.asarray(jclip.forward(params, vcfg, jclip.preprocess_frames(jnp.asarray(frames))))
    tp = bridged({"vision": params})["vision"]
    pixels = clip.preprocess_frames(torch.from_numpy(frames))
    np.testing.assert_allclose(pixels.numpy(), np.asarray(jclip.preprocess_frames(
        jnp.asarray(frames))), rtol=0, atol=1e-6)
    got = clip.forward(tp, tconfig.clip_tiny(), pixels).numpy()
    assert got.shape == ref.shape == (3, 5, 32)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_quick_gelu_matches_jax():
    x = np.random.default_rng(1).normal(size=(64,)).astype(np.float32) * 4
    np.testing.assert_allclose(clip._quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip._quick_gelu(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_init_aha_params_clip_matches_jax(dtype):
    cfg = clip_cfg()
    ref = jaha.init_aha_params(cfg, jax.random.PRNGKey(3), dtype and jnp.bfloat16)
    got = loader.init_aha_params(port_cfg(cfg), seed=3, dtype=dtype, device="cpu")
    assert_trees(got, bridged(ref), float_ulps=3 if dtype is None else 1)


def _jax_leaves(cfg, mode):
    s = jax.eval_shape(lambda: jaha.init_aha_params(cfg, jax.random.PRNGKey(0)))
    if mode is not None:
        s = jax.eval_shape(lambda p: jquant.quantize_params(p, bits=4 if mode == "int4" else 8),
                           s)
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: out.append((tuple(str(k.key) for k in p), tuple(leaf.shape),
                                    str(leaf.dtype))), s)
    return out


@pytest.mark.parametrize("preset", ["tiny", "7b"])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_leaf_specs_clip_match_eval_shape(preset, mode):
    """A CLIP tree's leaves in JAX's drawing order, at tiny and at CLIP-L/14-336."""
    base = {"tiny": clip_cfg(), "7b": jconfig.aha_7b().replace(
        vision=jconfig.clip_large_336(), frame_resolution=336, frame_token_cls=True)}[preset]
    got = [(p, s, str(d).removeprefix("torch.")) for p, s, d in
           loader.leaf_specs(port_cfg(base), mode)]
    assert got == _jax_leaves(base, mode)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_materialize_random_params_clip_matches_jax(mode):
    """JAX's synthetic CLIP tree at tiny: integer leaves and constant scales
    bit-equal, normal leaves within 3 f32 ulps (the CLS token and the pre-LN
    scale are drawn normal, as JAX's name rules draw them)."""
    cfg = clip_cfg()
    ref = jloader.materialize_random_params(cfg, mode)
    if mode is not None:
        ref = {**ref, "llm": jquant.merge_decoder_projections(ref["llm"])}
    got = loader.materialize_random_params(port_cfg(cfg), mode, device="cpu", slab=5000)
    assert_trees(got, bridged(ref), float_ulps=3)


def test_quantize_vision_clip_matches_jax():
    """``quantize_params(quantize_vision=True)`` over a CLIP tree: its layer
    kernels int8, its CLS token, patch kernel, position table and norms dense,
    bit-equal to JAX's."""
    cfg = clip_cfg()
    params = jaha.init_aha_params(cfg, jax.random.PRNGKey(2))
    ref = jquant.quantize_params(params, quantize_vision=True)
    got = quant.quantize_params(bridged(params), quantize_vision=True)
    assert_trees(got, bridged(ref))
    assert "qvalue" in got["vision"]["layers"]["q_proj"]["kernel"]
    assert got["vision"]["cls_embed"].dtype == torch.float32


def hf_clip_state_dict(vcfg, seed: int, prefix: str = "vision_model.") -> dict:
    """A CLIPVisionModel state dict ([out, in] weights) drawn from a seed, with
    the post-LN that the converters drop."""
    rng = np.random.default_rng(seed)
    H, I, P, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size, vcfg.num_layers

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {prefix + "embeddings.class_embedding": r(H),
          prefix + "embeddings.patch_embedding.weight": r(H, 3, P, P),
          prefix + "embeddings.position_embedding.weight": r(vcfg.num_patches + 1, H),
          prefix + "pre_layrnorm.weight": r(H), prefix + "pre_layrnorm.bias": r(H),
          prefix + "post_layernorm.weight": r(H), prefix + "post_layernorm.bias": r(H)}
    for i in range(L):
        lyr = f"{prefix}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{lyr}self_attn.{n}.weight"], sd[f"{lyr}self_attn.{n}.bias"] = r(H, H), r(H)
        sd[lyr + "mlp.fc1.weight"], sd[lyr + "mlp.fc1.bias"] = r(I, H), r(I)
        sd[lyr + "mlp.fc2.weight"], sd[lyr + "mlp.fc2.bias"] = r(H, I), r(H)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{lyr}{n}.weight"], sd[f"{lyr}{n}.bias"] = r(H), r(H)
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_clip_matches_jax(dtype):
    vcfg = jconfig.clip_tiny()
    sd = hf_clip_state_dict(vcfg, 11, prefix="model.vision_tower.vision_model.")
    ref = jloader.convert_clip(sd, vcfg, prefix="model.vision_tower.vision_model.",
                               dtype=jnp.dtype(dtype))
    got = loader.convert_clip({k: torch.from_numpy(v) for k, v in sd.items()},
                              tconfig.clip_tiny(), "model.vision_tower.vision_model.",
                              getattr(torch, dtype), "cpu")
    assert_trees({"vision": got}, bridged({"vision": ref}))


def test_load_params_clip_matches_jax(tmp_path):
    """A CLIP checkpoint (the port's export of JAX's tiny CLIP init, written as
    safetensors) read by both loaders: equal leaf for leaf; the export reads
    back to the same tree."""
    jcfg = clip_cfg(vocab_size=300)
    jp = jaha.init_aha_params(jcfg, jax.random.PRNGKey(4))
    tp, cfg = bridged(jp), port_cfg(jcfg)
    sd = {k: v.contiguous() for k, v in loader.export_hf_state_dict(tp, cfg).items()}
    loader.save_safetensors(sd, str(tmp_path / "model.safetensors"), {"format": "pt"})
    ref = jloader.load_params(str(tmp_path), jcfg, jnp.float32)
    got = loader.load_params(str(tmp_path), cfg, torch.float32, device="cpu")
    assert_trees(got, bridged(ref))
    assert_trees(got, tp)


# -- a session with the CLIP tower and its CLS token ---------------------------------------


@pytest.fixture(scope="module")
def clip_session():
    """JAX's tiny CLIP model with the CLS token, one JAX engine at fused 4
    (its sessions share its programs), the bridged params and the port's
    config and tokenizer."""
    params, cfg, tok = jaha.build_model_and_tokenizer(clip_cfg(), seed=0)
    assert cfg.frame_num_tokens == 2
    engine = JStreamEngine(params, cfg, JCachePolicy("sink", window=256, num_sink=8),
                           max_new_tokens=12, spec_tokens=1, fused_score_frames=4)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    return engine, tok, bridged(params), port_cfg(cfg), ttok


FRAMES = np.random.default_rng(5).integers(0, 256, (9, 40, 48, 3), dtype=np.uint8)


def test_clip_visual_embed_cls_first(clip_session):
    """visual_embed [N, 2, H]: row 0 the projected CLS token (the tower's
    first output, un-normalised; the projector's product at one row instead of
    two sums in another order, so within 1e-6 of the largest value), row 1 the
    pooled patches; within 1e-5 of JAX's."""
    engine, _, tp, cfg, _ = clip_session
    frames = torch.from_numpy(FRAMES[:3])
    emb = taha.visual_embed(tp, cfg, frames)
    ref = np.asarray(jaha.visual_embed(engine.params, engine.cfg, jnp.asarray(FRAMES[:3])))
    assert emb.shape == ref.shape == (3, 2, 64)
    assert np.abs(emb.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    from aha_tpu_torch.ops.preprocess import device_letterbox

    pixels = clip.preprocess_frames(device_letterbox(frames, 32))
    cls_tok = clip.forward(tp["vision"], cfg.vision, pixels)[:, :1]
    proj = taha.project_features(tp, cls_tok)          # another product shape: f32 sums differ
    assert (emb[:, :1] - proj).abs().max() <= 1e-6 * proj.abs().max()


@pytest.mark.parametrize("fused", [1, 4])
def test_clip_session_score_video_matches_jax(clip_session, fused):
    engine, tok, tp, cfg, ttok = clip_session
    jrows = JStreamSession(engine, tok, JInferConfig(grounding_mode=True, frame_fps=2.0)
                           ).score_video(FRAMES, query=QUERY)
    rows = build_session(tp, cfg, ttok, InferConfig(
        grounding_mode=True, frame_fps=2.0, kv_window=256, num_sink_tokens=8,
        fused_score_frames=fused, spec_decode_tokens=1), device="cpu").score_video(
            FRAMES, query=QUERY)
    got = np.asarray([[r[k] for k in KEYS] for r in rows])
    ref = np.asarray([[r[k] for k in KEYS] for r in jrows])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_clip_session_inference_matches_jax(clip_session):
    """inference() with the prob rule at a threshold from the run's own
    scores: the same responses at the same times, scores within 1e-5."""
    engine, tok, tp, cfg, ttok = clip_session
    common = dict(frame_fps=2.0, max_new_tokens=12)
    jrows = JStreamSession(engine, tok, JInferConfig(grounding_mode=True, **common)
                           ).score_video(FRAMES, query=QUERY)
    s = sorted(r["informative_score"] + r["relevance_score"] for r in jrows)
    thr = float(s[-3])                    # about three responses
    conv = [{"role": "user", "content": QUERY, "time": 0}]
    jsess = JStreamSession(engine, tok, JInferConfig(stream_end_prob_threshold=thr, **common))
    jsess.input_video_stream(FRAMES)
    jsess.input_query_stream(conv)
    jturns = jsess.inference()
    sess = build_session(tp, cfg, ttok, InferConfig(
        stream_end_prob_threshold=thr, kv_window=256, num_sink_tokens=8, fused_score_frames=4,
        spec_decode_tokens=1, **common), device="cpu")
    sess.input_video_stream(FRAMES)
    sess.input_query_stream(conv)
    turns = sess.inference()
    assert [(t["role"], t["time"], t["content"]) for t in turns] == \
        [(t["role"], t["time"], t["content"]) for t in jturns]
    assert sum(t["role"] == "assistant" for t in turns) >= 1
    got = np.asarray([[r[k] for k in KEYS] for r in sess.debug_data_list])
    ref = np.asarray([[r[k] for k in KEYS] for r in jsess.debug_data_list])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
