"""The port's slice as a whole: StreamSession on the CPU (plain versions of
the kernels) against the committed golden fixture (all four arrays) and
against the JAX session, fused scoring against per-frame scoring,
speculative generation against the sequential loop, and a run with jax and
aha_tpu blocked from importing."""

import dataclasses
import functools
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import quant
from aha_tpu.streaming.session import StreamSession as JStreamSession

from aha_tpu_torch import config as tconfig
from aha_tpu_torch import bridge
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.ops.kv_cache import CachePolicy
from aha_tpu_torch.streaming.engine import StreamEngine
from aha_tpu_torch.streaming.session import build_session
from aha_tpu_torch.tokenization import build_stream_tokenizer


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
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "golden_tiny_cpu.npz"
QUERY = "What is happening in this video?"
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
WIDTHS_1 = dict(fused_score_frames=1, spec_decode_tokens=1)
CPU = dict(device="cpu")


def _scores(rows):
    return np.asarray([[r[k] for k in KEYS] for r in rows], np.float32)


def port_cfg(cfg):
    """The port's own AhaConfig from the JAX package's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


@pytest.fixture(scope="module")
def tiny():
    """JAX params / config / tokenizer of the tiny preset, and the port's own
    config and tokenizer for it."""
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    assert (ttok.v_placeholder_id, ttok.eos_token_id) == (cfg.v_placeholder_id, cfg.eos_token_id)
    return params, cfg, tok, port_cfg(cfg), ttok


def test_golden_tiny_fixture_replay(tiny):
    """The port replays tests/fixtures/golden_tiny_cpu.npz (recorded by the
    JAX package, scripts/make_golden_fixture.py --mode tiny) from the
    bridged seed-0 params, all four arrays: per-frame and fused-4 scores at
    the fixture test's tolerance (atol 1e-4, rtol 1e-3), sequential and
    speculative (4 -> 8) texts exactly."""
    params, _, _, cfg, tok = tiny
    rec = np.load(FIXTURE, allow_pickle=False)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    common = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32)
    for width, key in ((1, "scores"), (4, "scores_fused4")):
        rows = build_session(tp, cfg, tok, InferConfig(
            grounding_mode=True, fused_score_frames=width, spec_decode_tokens=1, **common),
            **CPU).score_video(rec["frames"], query=QUERY)
        np.testing.assert_allclose(_scores(rows), rec[key], atol=1e-4, rtol=1e-3, err_msg=key)
    for (S, S_max), key in (((1, 1), "gen_texts_seq"), ((4, 8), "gen_texts_spec")):
        sess = build_session(tp, cfg, tok, InferConfig(
            stream_end_prob_threshold=-1e9, max_new_tokens=48, spec_decode_tokens=S,
            spec_decode_tokens_max=S_max, **common), **CPU)
        sess.input_video_stream(rec["frames"])
        sess.input_query_stream([{"role": "user", "content": QUERY, "time": 0}])
        texts = [t["content"] for t in sess.inference() if t["role"] == "assistant"]
        assert texts == list(rec[key]), key
        if S > 1:
            acc = sess.engine.spec_acceptance()
            assert acc["passes"] > 0 and acc["committed"] >= acc["passes"]


@pytest.fixture(scope="module")
def int8_engines(tiny):
    """One JAX engine for all trigger rules (the rules live in the session,
    so its compiled programs are shared), and the bridged params."""
    from aha_tpu.ops.kv_cache import CachePolicy
    from aha_tpu.streaming.engine import StreamEngine

    params, cfg = tiny[:2]
    qparams = quant.quantize_params(params)
    engine = StreamEngine(qparams, cfg, CachePolicy("sink", window=256, num_sink=8),
                          max_new_tokens=12, repetition_penalty=1.3, spec_tokens=1,
                          fused_score_frames=1)
    return engine, params_from_jax(jax.tree.map(np.asarray, qparams))


@pytest.mark.parametrize("rule", [dict(stream_end_prob_threshold=0.975),
                                  dict(stream_end_score_sum_threshold=2.2),
                                  dict(threshold_z=0.3, first_n_frames_no_generate=2),
                                  dict(stream_end_prob_threshold=0.975,
                                       remove_assistant_turns=True)],
                         ids=["prob", "sum", "z", "prob-rollback"])
def test_int8_session_matches_jax(tiny, int8_engines, rule):
    """int8-quantized tiny params, small sink window (evictions, hf post-fill
    mask), repetition penalty, and the rollback of remove_assistant_turns
    (the port's cache is updated in place, so it restores a copy):
    stepwise inference() and score_video against
    the JAX session's stepwise loop at widths 1 (the chunked loops are held
    against each other in tests/test_torch_trigger.py), in scores and texts."""
    _, _, tok, tcfg, ttok = tiny
    jengine, tparams = int8_engines
    kw = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8,
              max_new_tokens=12, repetition_penalty=1.3, **WIDTHS_1, **rule)
    icfg = JInferConfig(**kw)
    frames = np.random.default_rng(5).integers(0, 256, (10, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0},
            {"role": "user", "content": "And now?", "time": 2.5}]

    js = JStreamSession(jengine, tok, icfg)
    js.input_video_stream(frames)
    js.input_query_stream(conv)
    jturns = js.inference(chunked=False)
    ts = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    ts.input_video_stream(frames)
    ts.input_query_stream(conv)
    tturns = ts.inference(chunked=False)
    np.testing.assert_allclose(_scores(ts.debug_data_list), _scores(js.debug_data_list),
                               atol=1e-4, rtol=1e-3)
    assert [(t["role"], t["time"], t["content"]) for t in tturns] == \
        [(t["role"], t["time"], t["content"]) for t in jturns]
    assert any(t["role"] == "assistant" for t in tturns)
    # the session keeps its cache across videos: reset, then score_video
    ts.reset()
    js.reset()
    np.testing.assert_allclose(_scores(ts.score_video(frames[:6], query=QUERY)),
                               _scores(js.score_video(frames[:6], query=QUERY)),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("chunked", [True, False])
def test_inference_takes_the_jax_arguments(tiny, int8_engines, chunked):
    """inference(verbose=, chunked=) as the JAX session's: chunked=True runs
    the chunked trigger loops and chunked=False the stepwise loop, each
    giving the turns and scores of the JAX session's loop of the same
    name."""
    _, _, tok, tcfg, ttok = tiny
    jengine, tparams = int8_engines
    kw = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8,
              max_new_tokens=12, repetition_penalty=1.3, stream_end_prob_threshold=0.975,
              **WIDTHS_1)
    frames = np.random.default_rng(8).integers(0, 256, (6, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0}]
    js = JStreamSession(jengine, tok, JInferConfig(**kw))
    js.input_video_stream(frames)
    js.input_query_stream(conv)
    jturns = js.inference(verbose=False, chunked=chunked)
    ts = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    ts.input_video_stream(frames)
    ts.input_query_stream(conv)
    tturns = ts.inference(verbose=False, chunked=chunked)
    np.testing.assert_allclose(_scores(ts.debug_data_list), _scores(js.debug_data_list),
                               atol=1e-4, rtol=1e-3)
    assert [(t["role"], t["time"], t["content"]) for t in tturns] == \
        [(t["role"], t["time"], t["content"]) for t in jturns]


@pytest.mark.parametrize("how", ["config", "fps", "frame_interval"])
def test_set_fps_matches_jax(tiny, int8_engines, how):
    """frame_fps from the config, or unset (frame_fps=0) and given later by
    set_fps(fps=) or set_fps(frame_interval=), as the JAX session takes it:
    the same rate, interval and frame times in score_video."""
    _, _, tok, tcfg, ttok = tiny
    jengine, tparams = int8_engines
    kw = dict(grounding_mode=True, frame_fps=4.0 if how == "config" else 0.0,
              kv_cache_policy="sink", kv_window=256, num_sink_tokens=8, **WIDTHS_1)
    js = JStreamSession(jengine, tok, JInferConfig(**kw))
    ts = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    if how != "config":
        assert (ts.frame_fps, ts.frame_interval) == (js.frame_fps, js.frame_interval) == (None, None)
        for s in (js, ts):
            s.set_fps(**({"fps": 4.0} if how == "fps" else {"frame_interval": 0.25}))
    assert (ts.frame_fps, ts.frame_interval) == (js.frame_fps, js.frame_interval)
    frames = np.random.default_rng(9).integers(0, 256, (3, 40, 48, 3), dtype=np.uint8)
    trows, jrows = ts.score_video(frames, query=QUERY), js.score_video(frames, query=QUERY)
    assert [r["time"] for r in trows] == [r["time"] for r in jrows] == [0.0, 0.25, 0.5]
    np.testing.assert_allclose(_scores(trows), _scores(jrows), atol=1e-4, rtol=1e-3)


def test_set_fps_takes_one_of_its_two_arguments(tiny, int8_engines):
    """Neither or both: refused, as the JAX session refuses them."""
    _, _, tok, tcfg, ttok = tiny
    jengine, tparams = int8_engines
    kw = dict(grounding_mode=True, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8)
    js = JStreamSession(jengine, tok, JInferConfig(**kw))
    ts = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    for args in ({}, {"fps": 2.0, "frame_interval": 0.5}):
        with pytest.raises(AssertionError):
            js.set_fps(**args)
        with pytest.raises(ValueError, match="set_fps"):
            ts.set_fps(**args)


@pytest.mark.parametrize("chunked", [True, False])
def test_int4_session_matches_jax_at_product_widths(tiny, chunked):
    """Packed-int4 tiny params (merged projections, int4 projector and
    lm_head, int8 embedding), small sink window, repetition penalty, at the
    product widths: fused scoring of 4 frames per pass in score_video and
    speculative generation (4 candidates per pass) in inference(), against
    the JAX session at the same widths on the same tree, chunked loop
    against chunked loop and stepwise against stepwise, in scores (atol
    1e-4, rtol 1e-3) and texts."""
    from aha_tpu.ops.kv_cache import CachePolicy as JCachePolicy
    from aha_tpu.streaming.engine import StreamEngine as JStreamEngine

    params, cfg, tok, tcfg, ttok = tiny
    qparams = quant.quantize_params(params, bits=4)
    qparams = {**qparams, "llm": quant.merge_decoder_projections(qparams["llm"])}
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams))
    assert "q4value" in tparams["llm"]["lm_head"]["kernel"]
    kw = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8,
              max_new_tokens=12, repetition_penalty=1.3, fused_score_frames=4,
              spec_decode_tokens=4, spec_decode_tokens_max=4,
              stream_end_score_sum_threshold=2.2)
    jengine = JStreamEngine(qparams, cfg, JCachePolicy("sink", window=256, num_sink=8),
                            max_new_tokens=12, repetition_penalty=1.3, spec_tokens=4,
                            fused_score_frames=4)
    frames = np.random.default_rng(6).integers(0, 256, (10, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0}]
    js = JStreamSession(jengine, tok, JInferConfig(**kw))
    js.input_video_stream(frames)
    js.input_query_stream(conv)
    jturns = js.inference(chunked=chunked)
    ts = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    assert ts.engine.spec_tokens == 4 and ts.engine.fused_frames == 4
    ts.input_video_stream(frames)
    ts.input_query_stream(conv)
    tturns = ts.inference(chunked=chunked)
    np.testing.assert_allclose(_scores(ts.debug_data_list), _scores(js.debug_data_list),
                               atol=1e-4, rtol=1e-3)
    assert [(t["role"], t["time"], t["content"]) for t in tturns] == \
        [(t["role"], t["time"], t["content"]) for t in jturns]
    assert any(t["role"] == "assistant" for t in tturns)
    ts.reset()
    js.reset()
    np.testing.assert_allclose(_scores(ts.score_video(frames, query=QUERY)),
                               _scores(js.score_video(frames, query=QUERY)),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("chunked", [True, False])
def test_int8_session_matches_jax_at_product_widths(tiny, chunked):
    """int8-quantized tiny params with merged projections (as JAX's StreamEngine
    merges them), small sink window, repetition penalty, at the product widths of
    the JAX package's main path: fused scoring of 4 frames per pass in
    score_video and speculative generation (4 candidates per pass) in
    inference(), against the JAX session at the same widths on the same tree
    (chunked loop against chunked loop, stepwise against stepwise), in scores
    (atol 1e-4, rtol 1e-3) and texts."""
    from aha_tpu.ops.kv_cache import CachePolicy as JCachePolicy
    from aha_tpu.streaming.engine import StreamEngine as JStreamEngine

    params, cfg, tok, tcfg, ttok = tiny
    qparams = quant.quantize_params(params)
    qparams = {**qparams, "llm": quant.merge_decoder_projections(qparams["llm"])}
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams))
    layers = tparams["llm"]["layers"]
    assert "qkv_proj" in layers and "gate_up_proj" in layers
    assert layers["qkv_proj"]["kernel"]["qvalue"].dtype == torch.int8
    kw = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8,
              max_new_tokens=12, repetition_penalty=1.3, fused_score_frames=4,
              spec_decode_tokens=4, spec_decode_tokens_max=4,
              stream_end_score_sum_threshold=2.2)
    jengine = JStreamEngine(qparams, cfg, JCachePolicy("sink", window=256, num_sink=8),
                            max_new_tokens=12, repetition_penalty=1.3, spec_tokens=4,
                            fused_score_frames=4)
    frames = np.random.default_rng(7).integers(0, 256, (10, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0}]
    js = JStreamSession(jengine, tok, JInferConfig(**kw))
    js.input_video_stream(frames)
    js.input_query_stream(conv)
    jturns = js.inference(chunked=chunked)
    ts = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    assert ts.engine.spec_tokens == 4 and ts.engine.fused_frames == 4
    ts.input_video_stream(frames)
    ts.input_query_stream(conv)
    tturns = ts.inference(chunked=chunked)
    np.testing.assert_allclose(_scores(ts.debug_data_list), _scores(js.debug_data_list),
                               atol=1e-4, rtol=1e-3)
    assert [(t["role"], t["time"], t["content"]) for t in tturns] == \
        [(t["role"], t["time"], t["content"]) for t in jturns]
    assert any(t["role"] == "assistant" for t in tturns)
    assert ts.engine.spec_acceptance()["passes"] > 0
    ts.reset()
    js.reset()
    np.testing.assert_allclose(_scores(ts.score_video(frames, query=QUERY)),
                               _scores(js.score_video(frames, query=QUERY)),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("chunked", [True, False])
def test_int4_fused_a8_session_at_product_widths(tiny, chunked):
    """Packed-int4 tiny params with per-token int8 activations (backend
    "fused_a8", the W4A8 recipe), on the CPU through the plain versions, at the
    product widths: fused scoring of 4 frames and speculative generation 4 -> 8,
    in the chunked loop and in the stepwise one. Its texts equal its own texts at
    generation width 1 in the same loop, and its scores lie within the recipe's
    bound of the weight-only session's, 3% of their mean magnitude (the bound of
    tests/test_torch_models.py::test_decode_chunk_int8_activations): JAX has no
    int4 int8-activation path off the TPU (the kernel's parity with JAX in
    interpret mode is held in tests/test_torch_ops.py and test_torch_int4_kernels.py)."""
    params, cfg, tok, tcfg, ttok = tiny
    qparams = quant.quantize_params(params, bits=4)
    qparams = {**qparams, "llm": quant.merge_decoder_projections(qparams["llm"])}
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams))
    kw = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8,
              max_new_tokens=12, repetition_penalty=1.3, fused_score_frames=4,
              spec_decode_tokens=4, spec_decode_tokens_max=8,
              stream_end_score_sum_threshold=2.2)
    frames = np.random.default_rng(6).integers(0, 256, (10, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0}]

    def run(backend, **widths):
        ts = build_session(tparams, tcfg, ttok, InferConfig(**{**kw, **widths}), backend=backend,
                           **CPU)
        ts.input_video_stream(frames)
        ts.input_query_stream(conv)
        turns = [(t["role"], t["time"], t["content"]) for t in ts.inference(chunked=chunked)]
        streamed = _scores(ts.debug_data_list)
        ts.reset()
        return ts, turns, streamed, _scores(ts.score_video(frames, query=QUERY))

    ts, turns, streamed, fused = run("fused_a8")
    assert ts.engine.spec_tokens == 4 and ts.engine.spec_max == 8 and ts.engine.fused_frames == 4
    assert ts.engine.spec_acceptance()["passes"] > 0
    assert any(role == "assistant" for role, _, _ in turns)
    _, turns1, streamed1, _ = run("fused_a8", spec_decode_tokens=1, spec_decode_tokens_max=1)
    assert turns == turns1
    np.testing.assert_array_equal(streamed, streamed1)
    _, _, streamed_w, fused_w = run("fused")
    for got, ref in ((streamed, streamed_w), (fused, fused_w)):
        assert np.abs(got - ref).mean() < 0.03 * np.abs(ref).mean()
    assert np.abs(fused - fused_w).max() > 0          # the activations really were quantised


@pytest.fixture(scope="module")
def int8_port(tiny):
    params, _, _, tcfg, _ = tiny
    return params_from_jax(jax.tree.map(np.asarray, quant.quantize_params(params))), tcfg


@pytest.mark.parametrize("kind,mask_mode", [("sink", "hf"), ("sink", "strict"),
                                            ("sliding", "hf"), ("none", "hf")])
def test_fused_scoring_matches_per_frame(int8_port, kind, mask_mode):
    """score_stream with fused_score_frames=4 equals the per-frame loop for
    T = 13 (not a multiple of 4: the tail is padded with inactive frames),
    through the window fill of the evicting policies: scores to 1e-5 and the
    cache (metadata exactly, occupied K/V to 2e-5)."""
    tparams, tcfg = int8_port
    policy = CachePolicy(kind, window=20 if kind != "none" else 256, num_sink=4,
                         mask_mode=mask_mode)
    frames = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (1, 13, 3, tcfg.llm.hidden_size)) * 0.1).astype(np.float32))
    out = []
    for k in (1, 4):
        eng = StreamEngine(tparams, tcfg, policy, fused_score_frames=k, **CPU)
        cache = eng.new_cache()
        eng.append_ids(cache, [[5, 9, 17, 3]])
        out.append((eng.score_stream(cache, frames), cache))
    (s1, c1), (s4, c4) = out
    assert s4.shape == (1, 13, 3)
    np.testing.assert_allclose(s4.numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)
    keep = torch.arange(policy.num_slots) != policy.junk
    for f in ("order", "key_pos"):
        assert torch.equal(getattr(c4, f)[:, keep], getattr(c1, f)[:, keep]), f
    assert torch.equal(c4.seen, c1.seen) and torch.equal(c4.length, c1.length)
    occ = ((c1.order >= 0) & keep)[None, :, :, None, None]
    for f in ("k", "v"):
        np.testing.assert_allclose(torch.where(occ, getattr(c4, f), 0.0).numpy(),
                                   torch.where(occ, getattr(c1, f), 0.0).numpy(),
                                   rtol=2e-4, atol=2e-5)


PROMPT = [5, 9, 17, 3]
PREFILL = list(range(20, 44))


def _generate(tparams, tcfg, *, S, S_max=None, N=18, penalty=None, eos=None, kind="sink"):
    cfg = tcfg if eos is None else tcfg.replace(eos_token_id=eos)
    policy = CachePolicy(kind, window=24 if kind != "none" else 256, num_sink=4)
    eng = StreamEngine(tparams, cfg, policy, max_new_tokens=N, repetition_penalty=penalty,
                       spec_tokens=S, spec_tokens_max=S_max, **CPU)
    cache = eng.new_cache()
    eng.append_ids(cache, [PREFILL])
    out_ids, out_len, counts, last = eng.generate(cache, [PROMPT], eng.new_rep_counts())
    return out_ids, out_len, counts, last, cache, eng


def _assert_same_generation(a, b):
    """Tokens, lengths, repetition counts, last token and the cache after
    generation (metadata exactly, occupied K/V to 2e-5)."""
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    ca, cb = a[4], b[4]
    keep = torch.arange(ca.order.shape[1]) != ca.order.shape[1] - 1
    for f in ("order", "key_pos"):
        assert torch.equal(getattr(ca, f)[:, keep], getattr(cb, f)[:, keep]), f
    assert torch.equal(ca.seen, cb.seen) and torch.equal(ca.length, cb.length)
    occ = ((ca.order >= 0) & keep)[None, :, :, None, None]
    for f in ("k", "v"):
        np.testing.assert_allclose(torch.where(occ, getattr(ca, f), 0.0).numpy(),
                                   torch.where(occ, getattr(cb, f), 0.0).numpy(),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["width4", "width4to8", "penalty", "eos_mid_chunk",
                                  "budget_cut_mid_chunk", "sliding", "none"])
def test_generate_spec_matches_generate(int8_port, case):
    """generate_spec writes the tokens of generate, token for token, and
    leaves the same cache, across the window fill of a 24-slot cache: fixed
    width 4, adaptive 4 -> 8, with repetition penalty, with an eos that the
    model emits mid-chunk, with a token budget that ends mid-chunk (N = 6),
    and for the sliding and unbounded policies (the cases of
    tests/test_spec_generate.py)."""
    tparams, tcfg = int8_port
    kw = dict(S=4)
    if case == "width4to8":
        kw["S_max"] = 8
    elif case == "penalty":
        kw["penalty"] = 1.3
    elif case == "eos_mid_chunk":
        base = _generate(tparams, tcfg, S=1)
        kw["eos"] = int(base[0][0, 5])          # the sixth token ends the response
    elif case == "budget_cut_mid_chunk":
        kw["N"] = 6
    elif case in ("sliding", "none"):
        kw["kind"] = case
    spec = _generate(tparams, tcfg, **kw)
    seq = _generate(tparams, tcfg, **dict(kw, S=1, S_max=None))
    _assert_same_generation(spec, seq)
    assert int(seq[1][0]) == (6 if case in ("eos_mid_chunk", "budget_cut_mid_chunk") else 18)
    passes, committed, _ = spec[5].last_spec_info
    assert committed == int(spec[1][0]) and 1 <= passes <= committed


def test_generate_spec_full_acceptance_widens(int8_port):
    """A constant-argmax model (zeroed lm_head): after the first pass the
    drafter proposes the repeated token and every pass commits at full
    width; with spec_tokens_max=8 the acceptance EMA widens the passes, seen
    as fewer passes than fixed width 4. Outputs stay those of the
    sequential loop."""
    tparams, tcfg = int8_port
    head = tparams["llm"]["lm_head"]["kernel"]
    z = {**tparams, "llm": {**tparams["llm"], "lm_head": {"kernel": {
        "qvalue": torch.zeros_like(head["qvalue"]), "scale": head["scale"]}}}}
    seq = _generate(z, tcfg, S=1, N=40)
    fixed = _generate(z, tcfg, S=4, N=40)
    wide = _generate(z, tcfg, S=4, S_max=8, N=40)
    _assert_same_generation(fixed, seq)
    _assert_same_generation(wide, seq)
    assert int(seq[1][0]) == 40 and bool((seq[0] == seq[0][:, :1]).all())
    assert wide[5].last_spec_info[0] < fixed[5].last_spec_info[0] <= 11
    acc = wide[5].spec_acceptance()
    assert acc["committed"] == 40 and acc["tokens_per_pass"] > 4
    wide[5].reset_spec_totals()
    assert wide[5].spec_acceptance()["passes"] == 0


def test_build_session_refuses_what_is_not_ported(tiny):
    """Entry points run on the card by default and raise without one (no
    code path picks the CPU by itself); an unknown matmul backend, the
    int8-only 'pallas' backend on int4 weights, and the CLS token of
    frame_token_cls over a SigLIP tree without its MAP probe head raise."""
    params, _, _, cfg, tok = tiny
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    icfg = InferConfig(grounding_mode=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            build_session(tp, cfg, tok, icfg)
        with pytest.raises(RuntimeError, match="no GPU"):
            StreamEngine(tp, cfg, CachePolicy())
    with pytest.raises(ValueError, match="unknown matmul backend"):
        build_session(tp, cfg, tok, icfg, backend="auto", **CPU)
    q4 = params_from_jax(jax.tree.map(np.asarray, quant.quantize_params(params, bits=4)))
    sess = build_session(q4, cfg, tok, icfg, backend="pallas", **CPU)
    with pytest.raises(ValueError, match="int8 weights only"):
        sess.score_video(np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="MAP probe"):
        build_session(tp, cfg.replace(frame_token_cls=True), tok, icfg, **CPU).score_video(
            np.zeros((2, 32, 32, 3), np.uint8))


def test_port_runs_without_jax():
    """A fresh interpreter where importing jax, aha_tpu or any aha_tpu.*
    module raises imports every module of the port (the training modules,
    the command line, the drivers and the data modules with the rest, and the
    card's scripts chip_smoke.py and spec_divergence.py) and runs a tiny int4
    session at the product widths (chunked inference() with the prob and the
    z rule), ``infer`` of the command line on a clip written with cv2, the
    highlight chain on it (``infer --test_dataset tvsum``, ``grid-search``,
    ``evaluate``, ``highlight``; ``ops/signal.py`` and ``eval/`` with the rest),
    ``visualize`` (``drivers/visualize.py``; ``drivers/live_video.py``,
    ``utils/telemetry.py``, ``eval/llm_judge.py`` and ``models/clip.py`` with the
    rest),
    ``serve`` (multi-stream serving: ``engine_serve``, ``multi``,
    ``cli/serve``) on two requests of that clip over two slots, and one
    int4 QLoRA train step on the CPU from seeded synthetic params. The
    weights' modules (``models/jax_random.py``, ``models/loader.py``,
    ``golden.py``) are among those imported; they run with jax blocked in
    ``tests/test_torch_loader.py::test_weights_run_without_jax``. The
    parallel modules (``parallel/``, ``utils/dist.py``, ``dryrun_multichip``)
    and the native decoder (``native``) come in with the rest: the clip decoded
    natively where libav is built, the tiny tree's specs on a 2 x 2 mesh, ring
    attention at one rank."""
    code = textwrap.dedent(f"""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "aha_tpu"):
                    raise ImportError("blocked for this test: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import importlib, pkgutil
        import aha_tpu_torch
        for m in pkgutil.walk_packages(aha_tpu_torch.__path__, "aha_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke, spec_divergence   # the card's scripts, beside the package
        try:
            import aha_tpu.config
        except ImportError:
            pass
        else:
            raise AssertionError("aha_tpu was importable")
        import numpy as np
        from aha_tpu_torch.config import InferConfig, aha_tiny
        from aha_tpu_torch.tokenization import build_stream_tokenizer
        from aha_tpu_torch.models.aha import random_params
        from aha_tpu_torch.streaming.session import build_session
        cfg = aha_tiny()
        tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                     vocab_size=cfg.llm.vocab_size)
        cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id,
                          eos_token_id=tok.eos_token_id)
        params = random_params(cfg, mode="int4", device="cpu", seed=0)
        s = build_session(params, cfg, tok, InferConfig(
            stream_end_prob_threshold=-1e9, max_new_tokens=4), device="cpu")
        assert (s.engine.fused_frames, s.engine.spec_tokens, s.engine.spec_max) == (4, 4, 8)
        s.input_video_stream(np.zeros((3, 32, 32, 3), np.uint8))
        s.input_query_stream([{{"role": "user", "content": "hi", "time": 0}}])
        turns = s.inference()
        assert sum(t["role"] == "assistant" for t in turns) == 3, turns
        # the chunked loop's trigger loops: the z rule's one-row loop over fused passes
        s = build_session(params, cfg, tok, InferConfig(
            threshold_z=0.5, first_n_frames_no_generate=2, max_new_tokens=4), device="cpu")
        s.input_video_stream(np.random.default_rng(0).integers(0, 256, (9, 32, 32, 3),
                                                               dtype=np.uint8))
        s.input_query_stream([{{"role": "user", "content": "hi", "time": 0}}])
        s.inference()
        assert len(s.debug_data_list) == 9 and s._z_state is not None
        # the command line: infer on a clip written with cv2, a command not ported
        import json, os, tempfile
        import cv2
        from aha_tpu_torch.cli import main
        d = tempfile.mkdtemp()
        out = cv2.VideoWriter(os.path.join(d, "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 4.0,
                              (32, 32))
        for i in range(8):
            out.write(np.full((32, 32, 3), 20 * i, np.uint8))
        out.release()
        with open(os.path.join(d, "qa.json"), "w") as f:
            json.dump([{{"question_id": "q", "video": "v.mp4", "conversation": [
                {{"role": "user", "content": "hi", "time": 0}}]}}], f)
        assert main(["infer", "--model_preset", "tiny", "--device", "cpu",
                     "--synthetic_weights", "--int4", "--test_dataset", "generic",
                     "--input_dir", d, "--test_fname", os.path.join(d, "qa.json"),
                     "--output_fname", os.path.join(d, "out.jsonl"), "--max_new_tokens", "4",
                     "--stream_end_score_sum_threshold", "1.5"]) == 0
        with open(os.path.join(d, "out.jsonl")) as f:
            assert len(json.loads(f.readline())["debug_data"]) == 4
        # the highlight chain: infer over a TVSum-format benchmark, grid-search, evaluate,
        # highlight; visualize is refused
        out = cv2.VideoWriter(os.path.join(d, "w.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 4.0,
                              (32, 32))
        for i in range(8):
            out.write(np.full((32, 32, 3), 250 - 30 * i, np.uint8))
        out.release()
        with open(os.path.join(d, "info.tsv"), "w") as f:
            f.write("category\\tvideo_id\\ttitle\\turl\\tlength\\n"
                    "GA\\tv\\ta grey ramp\\turl\\t0:02\\nBK\\tw\\tfading\\turl\\t0:02\\n")
        with open(os.path.join(d, "anno.tsv"), "w") as f:
            f.write("".join(f"{{v}}\\t{{c}}\\t{{','.join(str(1 + (i * j) % 5) for j in range(8))}}\\n"
                            for v, c in (("v", "GA"), ("w", "BK")) for i in range(20)))
        pred, calib = os.path.join(d, "pred.json"), os.path.join(d, "params.json")
        assert main(["infer", "--model_preset", "tiny", "--device", "cpu",
                     "--synthetic_weights", "--int4", "--test_dataset", "tvsum",
                     "--input_dir", d, "--caption_metadata_file", os.path.join(d, "info.tsv"),
                     "--video_metadata_file", os.path.join(d, "meta.json"),
                     "--output_fname", pred, "--seed", "0"]) == 0
        with open(pred) as f:
            assert [len(x["debug_data"]) for x in json.load(f)] == [4, 4]
        gold = os.path.join(d, "anno.tsv")
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            assert main(["grid-search", "--test_dataset", "tvsum", "--pred_file", pred,
                         "--gold_file", gold, "--save_path", calib, "--seed", "0"]) == 0
            assert main(["evaluate", "--func", "tvsum", "--pred_file", pred, "--gold_file",
                         gold, "--params_file", calib]) == 0
            assert main(["highlight", "--pred_file", pred, "--video_uuid", "v", "--video_path",
                         os.path.join(d, "v.mp4"), "--output_filepath",
                         os.path.join(d, "reel.mp4"), "--max_duration", "2", "--params_file",
                         calib, "--source_fps", "4"]) == 0
        assert '"top5_mAP"' in printed.getvalue() and '"frames_written"' in printed.getvalue()
        with open(os.path.join(d, "metrics.json"), "w") as f:
            json.dump({{"mAP@50": 0.5, "mAP@15": 0.25, "top5_mAP": 0.75}}, f)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["visualize", "--func", "tvsum_sota", "--metrics_file",
                         os.path.join(d, "metrics.json"), "--output", os.path.join(d, "fig")]) == 0
        assert os.listdir(os.path.join(d, "fig")) == ["tvsum_results_comparison.png"]
        # the live-video demo's pieces (its runs: test_torch_live_video.py), the judge's
        from aha_tpu_torch.data.media import motion_mask
        assert motion_mask(np.zeros((3, 4, 4, 3), np.uint8), 0.02).tolist() == [True, False, False]
        from aha_tpu_torch.eval.llm_judge import analyze_magqa
        assert analyze_magqa([], num_examples=1)["n"] == 1
        for m in ("aha_tpu_torch.utils.telemetry", "aha_tpu_torch.drivers.live_video",
                  "aha_tpu_torch.drivers.visualize", "aha_tpu_torch.eval.llm_judge",
                  "aha_tpu_torch.models.clip"):
            assert m in sys.modules, m
        for m in ("aha_tpu_torch.ops.signal", "aha_tpu_torch.eval.scoring",
                  "aha_tpu_torch.eval.tvsum", "aha_tpu_torch.eval.hisum",
                  "aha_tpu_torch.eval.grounding", "aha_tpu_torch.eval.grid_search",
                  "aha_tpu_torch.eval.highlight", "aha_tpu_torch.eval.qvh",
                  "aha_tpu_torch.eval.captioning", "aha_tpu_torch.eval.soda",
                  "aha_tpu_torch.cli.evaluate"):
            assert m in sys.modules, m
        # training from the command line: a grounding mixture over the clip, an int8 trunk
        with open(os.path.join(d, "g.json"), "w") as f:
            json.dump([{{"video_uid": "v.mp4", "query": "thing", "timestamps": [[0.5, 1.0]]}}], f)
        with open(os.path.join(d, "mix.json"), "w") as f:
            json.dump([{{"dataset_cls": "GroundingStreamDataset", "video_root": d,
                        "anno_file": os.path.join(d, "g.json"),
                        "metadata_path": os.path.join(d, "meta.json"), "frame_fps": 2.0,
                        "max_num_frames": 4}}], f)
        assert main(["train", "--model_preset", "tiny", "--device", "cpu", "--dataset_config",
                     os.path.join(d, "mix.json"), "--output_dir", os.path.join(d, "tr"),
                     "--num_steps", "2", "--grad_accum_steps", "1", "--quantize_base",
                     "--remat_policy", "dots"]) == 0
        assert os.path.exists(os.path.join(d, "tr", "adapter.pt"))
        for m in ("aha_tpu_torch.data.collator", "aha_tpu_torch.data.datasets",
                  "aha_tpu_torch.data.conversations", "aha_tpu_torch.models.remat",
                  "aha_tpu_torch.cli.train"):
            assert m in sys.modules, m
        # multi-stream serving: serve two requests over two slots, one a clip
        with open(os.path.join(d, "req.jsonl"), "w") as f:
            f.write(json.dumps({{"key": "a", "video": os.path.join(d, "v.mp4"),
                                "conversation": [{{"role": "user", "content": "hi",
                                                   "time": 0}}]}}) + "\\n")
            f.write(json.dumps({{"key": "b", "video": os.path.join(d, "v.mp4"),
                                "conversation": []}}) + "\\n")
        assert main(["serve", "--model_preset", "tiny", "--device", "cpu",
                     "--synthetic_weights", "--int4", "--batch", "2", "--max_new_tokens", "4",
                     "--input", os.path.join(d, "req.jsonl"), "--output",
                     os.path.join(d, "served.jsonl"),
                     "--stream_end_prob_threshold=-1e9"]) == 0
        with open(os.path.join(d, "served.jsonl")) as f:
            served = {{json.loads(x)["key"]: json.loads(x) for x in f}}
        assert set(served) == {{"a", "b"}} and all(r["responses"] for r in served.values())
        for m in ("aha_tpu_torch.streaming.engine_serve", "aha_tpu_torch.streaming.multi",
                  "aha_tpu_torch.cli.serve"):
            assert m in sys.modules, m
        rows = build_session(params, cfg, tok, InferConfig(grounding_mode=True),
                             device="cpu").score_video(np.zeros((6, 32, 32, 3), np.uint8))
        assert len(rows) == 6
        assert "aha_tpu_torch.train.trainer" in sys.modules
        assert "aha_tpu_torch.drivers.benchmarks" in sys.modules
        assert "aha_tpu_torch.ops.kernels.flash_attention" in sys.modules
        from aha_tpu_torch.config import TrainConfig
        from aha_tpu_torch.train.trainer import init_train_state, make_train_step
        qparams = random_params(cfg, mode="int4", keep_dense=("projector", "lm_head"),
                                device="cpu", seed=0)
        tc = TrainConfig(grad_accum_steps=1)
        state, tx, labels, scale = init_train_state(cfg, tc, qparams, total_steps=4,
                                                    device="cpu")
        ids = np.array([tok.apply_chat_template([
            {{"role": "stream", "num_frames": 2, "learn": True}},
            {{"role": "assistant", "content": "ok", "learn": True}}])])
        state, parts = make_train_step(cfg, tc, tx, labels, scale, device="cpu")(state, {{
            "input_ids": ids, "labels": np.roll(ids, -1, 1).astype(np.int64),
            "frames": np.zeros((2, 32, 32, 3), np.uint8)}})
        assert state.step == 1 and np.isfinite(float(parts.total))
        # the weights' modules came in with the rest (their runs: test_torch_loader.py)
        for m in ("aha_tpu_torch.models.jax_random", "aha_tpu_torch.models.loader",
                  "aha_tpu_torch.golden"):
            assert m in sys.modules, m
        # parallelism and the native decoder (their runs: test_torch_parallel.py,
        # test_torch_sharded_serving.py, test_torch_dist_cli.py, test_torch_native_decoder.py)
        import torch
        from aha_tpu_torch import native
        if native.available():
            frames, idx = native.decode_video_native(os.path.join(d, "v.mp4"), output_fps=2.0,
                                                     output_size=32)
            assert frames.shape == (4, 32, 32, 3) and idx == [0, 2, 4, 6], idx
        from aha_tpu_torch.parallel.mesh import Mesh, param_specs
        from aha_tpu_torch.parallel.ring_attention import ring_causal_attention
        specs = param_specs(params, Mesh(2, 2, groups=False))
        assert specs["llm"]["lm_head"]["kernel"]["q4value"] == ("data", "model")
        q = torch.randn(1, 5, 2, 4)
        assert ring_causal_attention(q, q, q, None).shape == q.shape
        for m in ("aha_tpu_torch.parallel.mesh", "aha_tpu_torch.parallel.comm",
                  "aha_tpu_torch.parallel.sharded", "aha_tpu_torch.parallel.pipeline",
                  "aha_tpu_torch.parallel.ring_attention", "aha_tpu_torch.parallel.launch",
                  "aha_tpu_torch.utils.dist", "aha_tpu_torch.dryrun_multichip",
                  "aha_tpu_torch.native"):
            assert m in sys.modules, m
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "aha_tpu")]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
