"""The SigLIP tower's MAP probe (``frame_token_cls``: aha_tpu_torch/models/
siglip.py::attention_pool and the CLS dispatch of models/aha.py) against the
JAX package on the CPU at the tiny preset: ``attention_pool`` within 1e-5
(f32), dense and with the probe's products on int8 weights; JAX's synthetic
tree with its head (integer leaves bit-equal, normal leaves within 3 f32
ulps); the port's own ``random_params`` tree with a head or a CLIP tower
serving; and a session with the probe's CLS token: ``score_video`` at fused 1
and 4 and ``inference()`` within 1e-5 of one JAX engine at fused 4, texts
equal, ``visual_embed``'s first row the projected probe output."""

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
from aha_tpu.models import loader as jloader
from aha_tpu.models import siglip as jsiglip
from aha_tpu.ops import quant as jquant
from aha_tpu.ops.kv_cache import CachePolicy as JCachePolicy
from aha_tpu.streaming.engine import StreamEngine as JStreamEngine
from aha_tpu.streaming.session import StreamSession as JStreamSession

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.models import aha as taha
from aha_tpu_torch.models import loader, siglip
from aha_tpu_torch.ops.preprocess import device_letterbox
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


def cls_cfg(vocab_size: int = 512):
    return jconfig.aha_tiny(vocab_size).replace(frame_token_cls=True)


@pytest.mark.parametrize("quantised", [False, True])
def test_attention_pool_matches_jax(quantised):
    """Post-LN patch tokens [N, P, H] -> [N, H], f32, within 1e-5 of the
    largest output; with the probe's products on int8 weights (the tower
    quantised as --vision_int8 does) against JAX's ``qlinear`` path."""
    vcfg = dataclasses.replace(jconfig.siglip_tiny(), use_head=True)
    params = jsiglip.init_params(vcfg, jax.random.PRNGKey(9))
    if quantised:
        params = jquant.quantize_params({"vision": params}, quantize_vision=True)["vision"]
        assert "qvalue" in params["head"]["q_proj"]["kernel"]
    tokens = np.random.default_rng(2).normal(size=(3, 4, 32)).astype(np.float32)
    ref = np.asarray(jsiglip.attention_pool(params["head"], vcfg, jnp.asarray(tokens)))
    got = siglip.attention_pool(bridged({"vision": params})["vision"]["head"],
                                tconfig.SiglipConfig(**dataclasses.asdict(vcfg)),
                                torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (3, 32)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_materialize_random_params_with_head_matches_jax(mode):
    """JAX's synthetic tree with the SigLIP head (frame_token_cls): the probe,
    its products and its LN scale (drawn normal by JAX's name rules) within 3
    f32 ulps, integer leaves bit-equal."""
    cfg = cls_cfg()
    ref = jloader.materialize_random_params(cfg, mode)
    if mode is not None:
        ref = {**ref, "llm": jquant.merge_decoder_projections(ref["llm"])}
    got = loader.materialize_random_params(port_cfg(cfg), mode, device="cpu", slab=5000)
    assert "head" in got["vision"]
    assert_trees(got, bridged(ref), float_ulps=3)


def assert_trees(got, ref, float_ulps: float = 0):
    fg, fr = loader._flatten(got), loader._flatten(ref)
    assert [p for p, _ in fg] == [p for p, _ in fr]
    for (path, a), (_, b) in zip(fg, fr):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        if not a.is_floating_point() or float_ulps == 0:
            assert torch.equal(a, b), path
            continue
        step = torch.from_numpy(np.spacing(np.abs(b.float().numpy())))
        assert ((a.float() - b.float()).abs() <= float_ulps * step).all(), path


@pytest.mark.parametrize("tower", ["siglip-cls", "clip"])
def test_random_params_serves_each_tower(tower):
    """The port's own seeded tree (``random_params``) for a SigLIP tower with
    its probe and for CLIP: the leaves JAX's tree has, and two frames scored."""
    cfg = port_cfg(cls_cfg() if tower == "siglip-cls" else cls_cfg().replace(
        vision=jconfig.clip_tiny()))
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = taha.random_params(cfg, mode="int8", device="cpu", seed=0)
    ref = loader.materialize_random_params(cfg, "int8", device="cpu")
    assert [p for p, _ in loader._flatten(params["vision"])] == \
        [p for p, _ in loader._flatten(ref["vision"])]
    rows = build_session(params, cfg, tok, InferConfig(grounding_mode=True),
                         device="cpu").score_video(np.zeros((2, 32, 32, 3), np.uint8))
    assert len(rows) == 2 and all(np.isfinite(r[k]) for r in rows for k in KEYS)


# -- a session with the probe's CLS token ----------------------------------------------------


@pytest.fixture(scope="module")
def cls_session():
    params, cfg, tok = jaha.build_model_and_tokenizer(cls_cfg(), seed=0)
    assert cfg.frame_num_tokens == 2 and "head" in params["vision"]
    engine = JStreamEngine(params, cfg, JCachePolicy("sink", window=256, num_sink=8),
                           max_new_tokens=12, spec_tokens=1, fused_score_frames=4)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    return engine, tok, bridged(params), port_cfg(cfg), ttok


FRAMES = np.random.default_rng(6).integers(0, 256, (9, 48, 40, 3), dtype=np.uint8)


def test_cls_visual_embed_probe_first(cls_session):
    """visual_embed [N, 2, H]: row 0 the projected probe output over the
    tower's patches, row 1 the pooled patches; within 1e-5 of JAX's."""
    engine, _, tp, cfg, _ = cls_session
    frames = torch.from_numpy(FRAMES[:3])
    emb = taha.visual_embed(tp, cfg, frames)
    ref = np.asarray(jaha.visual_embed(engine.params, engine.cfg, jnp.asarray(FRAMES[:3])))
    assert emb.shape == ref.shape == (3, 2, 64)
    assert np.abs(emb.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    spatial = siglip.forward(tp["vision"], cfg.vision,
                             siglip.preprocess_frames(device_letterbox(frames, 32)))
    cls_tok = siglip.attention_pool(tp["vision"]["head"], cfg.vision, spatial)[:, None]
    proj = taha.project_features(tp, cls_tok)
    assert (emb[:, :1] - proj).abs().max() <= 1e-6 * proj.abs().max()


def test_cls_needs_the_probe_head(cls_session):
    """A tree without vision/head cannot give frame_token_cls its token: the
    same refusal as JAX's."""
    _, _, tp, cfg, _ = cls_session
    vision = {k: v for k, v in tp["vision"].items() if k != "head"}
    with pytest.raises(ValueError, match="MAP probe"):
        taha.visual_embed({**tp, "vision": vision}, cfg, torch.from_numpy(FRAMES[:1]))


@pytest.mark.parametrize("fused", [1, 4])
def test_cls_session_score_video_matches_jax(cls_session, fused):
    engine, tok, tp, cfg, ttok = cls_session
    jrows = JStreamSession(engine, tok, JInferConfig(grounding_mode=True, frame_fps=2.0)
                           ).score_video(FRAMES, query=QUERY)
    rows = build_session(tp, cfg, ttok, InferConfig(
        grounding_mode=True, frame_fps=2.0, kv_window=256, num_sink_tokens=8,
        fused_score_frames=fused, spec_decode_tokens=1), device="cpu").score_video(
            FRAMES, query=QUERY)
    got = np.asarray([[r[k] for k in KEYS] for r in rows])
    ref = np.asarray([[r[k] for k in KEYS] for r in jrows])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_cls_session_inference_matches_jax(cls_session):
    engine, tok, tp, cfg, ttok = cls_session
    common = dict(frame_fps=2.0, max_new_tokens=12)
    jrows = JStreamSession(engine, tok, JInferConfig(grounding_mode=True, **common)
                           ).score_video(FRAMES, query=QUERY)
    s = sorted(r["informative_score"] + r["relevance_score"] for r in jrows)
    # halfway between the third and fourth largest scores: the top three frames fire, and
    # no score sits on the threshold, where the two packages' last f32 places (JAX's verify
    # pass composes one softmax, the port's replays the sequential passes) would decide
    thr = float(s[-3] + s[-4]) / 2
    assert min(abs(x - thr) for x in s) > 1e-4
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
