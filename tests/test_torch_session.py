"""The port's slice as a whole: StreamSession on the CPU (plain versions of
the kernels) against the committed golden fixture and against the JAX
session, and a run with jax blocked from importing."""

import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from aha_tpu.config import InferConfig, aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import quant
from aha_tpu.streaming.session import StreamSession as JStreamSession

from aha_tpu_torch.bridge import params_from_jax
from aha_tpu_torch.streaming.session import build_session


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "golden_tiny_cpu.npz"
QUERY = "What is happening in this video?"
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
WIDTHS_1 = dict(fused_score_frames=1, spec_decode_tokens=1)


def _scores(rows):
    return np.asarray([[r[k] for k in KEYS] for r in rows], np.float32)


@pytest.fixture(scope="module")
def tiny():
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    return params, cfg, tok


def test_golden_tiny_fixture_replay(tiny):
    """The port replays tests/fixtures/golden_tiny_cpu.npz (recorded by the
    JAX package, scripts/make_golden_fixture.py --mode tiny) from the
    bridged seed-0 params: scores at the fixture test's tolerance, texts
    exactly."""
    params, cfg, tok = tiny
    rec = np.load(FIXTURE, allow_pickle=False)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    common = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=2048,
                  num_sink_tokens=32, **WIDTHS_1)
    rows = build_session(tp, cfg, tok, InferConfig(grounding_mode=True, **common)
                         ).score_video(rec["frames"], query=QUERY)
    np.testing.assert_allclose(_scores(rows), rec["scores"], atol=1e-4, rtol=1e-3)
    sess = build_session(tp, cfg, tok, InferConfig(
        stream_end_prob_threshold=-1e9, max_new_tokens=48, **common))
    sess.input_video_stream(rec["frames"])
    sess.input_query_stream([{"role": "user", "content": QUERY, "time": 0}])
    texts = [t["content"] for t in sess.inference() if t["role"] == "assistant"]
    assert texts == list(rec["gen_texts_seq"])


@pytest.fixture(scope="module")
def int8_engines(tiny):
    """One JAX engine for all trigger rules (the rules live in the session,
    so its compiled programs are shared), and the bridged params."""
    from aha_tpu.ops.kv_cache import CachePolicy
    from aha_tpu.streaming.engine import StreamEngine

    params, cfg, _ = tiny
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
    the JAX session's stepwise loop at widths 1 (which its own tests hold
    equal to the chunked loop), in scores and texts."""
    _, cfg, tok = tiny
    jengine, tparams = int8_engines
    icfg = InferConfig(frame_fps=2.0, kv_cache_policy="sink", kv_window=256,
                       num_sink_tokens=8, max_new_tokens=12, repetition_penalty=1.3,
                       **WIDTHS_1, **rule)
    frames = np.random.default_rng(5).integers(0, 256, (10, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0},
            {"role": "user", "content": "And now?", "time": 2.5}]

    js = JStreamSession(jengine, tok, icfg)
    js.input_video_stream(frames)
    js.input_query_stream(conv)
    jturns = js.inference(chunked=False)
    ts = build_session(tparams, cfg, tok, icfg)
    ts.input_video_stream(frames)
    ts.input_query_stream(conv)
    tturns = ts.inference()
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


def test_build_session_refuses_what_is_not_ported(tiny):
    params, cfg, tok = tiny
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    for widths in (dict(fused_score_frames=4, spec_decode_tokens=1),
                   dict(fused_score_frames=1, spec_decode_tokens=4)):
        with pytest.raises(NotImplementedError, match="widths 1"):
            build_session(tp, cfg, tok, InferConfig(grounding_mode=True, **widths))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            build_session(tp, cfg, tok, InferConfig(grounding_mode=True, **WIDTHS_1),
                          device="cuda")


def test_port_runs_without_jax():
    """A fresh interpreter where `import jax` fails imports every module of
    the port and runs a tiny session on the CPU from seeded synthetic
    params."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import importlib, pkgutil
        import aha_tpu_torch
        for m in pkgutil.walk_packages(aha_tpu_torch.__path__, "aha_tpu_torch."):
            importlib.import_module(m.name)
        import numpy as np
        from aha_tpu.config import InferConfig, aha_tiny
        from aha_tpu.tokenization import build_stream_tokenizer
        from aha_tpu_torch.models.aha import random_params
        from aha_tpu_torch.streaming.session import build_session
        cfg = aha_tiny()
        tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                     vocab_size=cfg.llm.vocab_size)
        cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id,
                          eos_token_id=tok.eos_token_id)
        s = build_session(random_params(cfg, seed=0), cfg, tok, InferConfig(
            stream_end_prob_threshold=-1e9, max_new_tokens=4, fused_score_frames=1,
            spec_decode_tokens=1))
        s.input_video_stream(np.zeros((3, 32, 32, 3), np.uint8))
        s.input_query_stream([{{"role": "user", "content": "hi", "time": 0}}])
        turns = s.inference()
        assert sum(t["role"] == "assistant" for t in turns) == 3, turns
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    if sys.modules[m] is not None]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
