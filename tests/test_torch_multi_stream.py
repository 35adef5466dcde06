"""The port's multi-stream serving (aha_tpu_torch/streaming/multi.py,
engine_serve.py, the engine and trigger loops at B rows) on the CPU: against
the JAX package's MultiStreamScorer / MultiStreamSession / MultiStreamServer
on the same bridged tiny params (JAX's multi-stream fixture: vocab 256, sink
window 64 with 4 sinks, so streams cross the window fill), and against the
port's own solo sessions (each stream of a batch equals an independent
StreamSession). Scores within rtol 3e-4 / atol 3e-5, response texts and
times equal, as tests/test_multi_stream.py holds JAX."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.streaming import multi as jmulti

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.ops import kv_cache
from aha_tpu_torch.streaming import multi
from aha_tpu_torch.streaming.session import build_session
from aha_tpu_torch.tokenization import build_stream_tokenizer

KEYS = ("informative_score", "relevance_score", "uncertainty_score")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg):
    """The port's own AhaConfig from the JAX package's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


@pytest.fixture(scope="module")
def model():
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(vocab_size=256), seed=0)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    return params, cfg, tok, tparams, port_cfg(cfg), ttok


BASE = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=64, num_sink_tokens=4,
            max_new_tokens=6)
WIDTHS = {"w1": dict(fused_score_frames=1, spec_decode_tokens=1, spec_decode_tokens_max=1),
          "w4": dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)}


def _kw(width="w1", **over):
    return {**BASE, **WIDTHS[width], **over}


def _videos(rng, lengths, r):
    return [rng.integers(0, 255, (n, r, r, 3), dtype=np.uint8) for n in lengths]


def _assistant(turns):
    return [(t["time"], t["content"]) for t in turns if t["role"] == "assistant"]


def _assert_stream(got, want_turns, want_debug, exact_times=True):
    """One stream's {"responses", "debug_data"} against a reference run:
    assistant turns equal, scores within tolerance, frame times equal."""
    assert _assistant(got["responses"]) == _assistant(want_turns)
    assert [d["time"] for d in got["debug_data"]] == [d["time"] for d in want_debug]
    for x, y in zip(got["debug_data"], want_debug):
        for k in KEYS:
            np.testing.assert_allclose(x[k], y[k], rtol=3e-4, atol=3e-5)


_JAX_ENGINES = {}


def _jax_engine(model, kw, batch):
    """JAX's StreamEngine for a session or server at ``kw`` over ``batch``
    rows. Sessions of one engine configuration share it, so that JAX traces
    and compiles its serving programs once for all of them (every case below
    keeps BASE's max_new_tokens for the same reason)."""
    params, cfg, tok = model[:3]
    jcfg = JInferConfig(**kw)
    ekey = (batch, jcfg.max_new_tokens, jcfg.spec_decode_tokens, jcfg.spec_decode_tokens_max,
            jcfg.fused_score_frames)
    if ekey not in _JAX_ENGINES:
        _JAX_ENGINES[ekey] = jmulti.MultiStreamSession(params, cfg, tok, jcfg,
                                                       batch=batch).engine
    return _JAX_ENGINES[ekey]


def _jax_server(model, kw, batch):
    params, cfg, tok = model[:3]
    return jmulti.MultiStreamServer(params, cfg, tok, JInferConfig(**kw), batch=batch,
                                    max_frames=MAX_FRAMES, engine=_jax_engine(model, kw, batch))


def _solo(model, kw, video, conv):
    """The port's own solo session over one stream: (turns, debug)."""
    _, _, _, tparams, tcfg, ttok = model
    s = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
    s.input_video_stream(video)
    s.input_query_stream(conv)
    return s.inference(), s.debug_data_list


# -- the cache -------------------------------------------------------------------------


def test_reset_cache_rows_matches_jax():
    """reset_cache_rows empties the metadata of the masked rows in place and
    leaves their K/V, as JAX's does."""
    rng = np.random.default_rng(0)
    B, W1 = 3, 9
    order = rng.integers(-1, 20, (B, W1)).astype(np.int32)
    key_pos = rng.integers(0, 30, (B, W1)).astype(np.int32)
    seen = rng.integers(0, 40, (B,)).astype(np.int32)
    length = rng.integers(0, 8, (B,)).astype(np.int32)
    k = rng.standard_normal((2, B, W1, 1, 4)).astype(np.float32)
    rows = np.array([True, False, True])
    jc = jkv.KVCache(k=k, v=k, key_pos=key_pos, order=order, seen=seen, length=length)
    jr = jkv.reset_cache_rows(jc, rows)
    tc = kv_cache.KVCache(*(torch.from_numpy(x.copy()) for x in (k, k, key_pos, order, seen,
                                                                  length)))
    assert kv_cache.reset_cache_rows(tc, rows) is tc
    for f in ("order", "key_pos", "seen", "length"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jr, f)), f)
    np.testing.assert_array_equal(tc.k.numpy(), k)
    np.testing.assert_array_equal(tc.order[1].numpy(), order[1])


# -- the lockstep scorer ------------------------------------------------------------------


@pytest.mark.parametrize("width", list(WIDTHS))
def test_multi_stream_scorer_matches_jax(model, width):
    """MultiStreamScorer (B 3, lengths 6 / 3 / 9, a stream without a query)
    against JAX's on the same params, and each stream against the port's
    solo score_video."""
    params, cfg, tok, tparams, tcfg, ttok = model
    videos = _videos(np.random.default_rng(0), [6, 3, 9], cfg.frame_resolution)
    queries = ["what is this?", None, "find the dog"]
    kw = _kw(width, grounding_mode=True, max_new_tokens=200)
    jout = jmulti.MultiStreamScorer(params, cfg, tok, JInferConfig(**kw), batch=3).score_videos(
        videos, queries, fps=1.0)
    tout = multi.MultiStreamScorer(tparams, tcfg, ttok, InferConfig(**kw), batch=3,
                                   **CPU).score_videos(videos, queries, fps=1.0)
    assert [len(x) for x in tout] == [6, 3, 9]
    for b in range(3):
        _assert_stream({"responses": [], "debug_data": tout[b]}, [], jout[b])
        solo = build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU)
        _assert_stream({"responses": [], "debug_data": tout[b]}, [],
                       solo.score_video(videos[b], query=queries[b]))


# -- the session and the server against JAX's ------------------------------------------------

CONVS3 = [[{"role": "user", "content": "what is happening?", "time": 0}],
          [],
          [{"role": "user", "content": "find the dog", "time": 2.0},
           {"role": "user", "content": "and now?", "time": 6.0}]]


@pytest.mark.parametrize("width", list(WIDTHS))
def test_multi_stream_session_matches_jax(model, width):
    """JAX's three-stream case (lengths 7 / 4 / 10, prob rule 0.55) through
    MultiStreamSession.run: equal to JAX's run (texts and times equal,
    traces within tolerance) and to the port's three solo sessions, at
    fused 1 / spec 1 and at fused 4 / spec 4 -> 8."""
    params, cfg, tok, tparams, tcfg, ttok = model
    videos = _videos(np.random.default_rng(1), [7, 4, 10], cfg.frame_resolution)
    kw = _kw(width, stream_end_prob_threshold=0.55)
    jout = jmulti.MultiStreamSession(params, cfg, tok, JInferConfig(**kw), batch=3,
                                     engine=_jax_engine(model, kw, 3)).run(videos, CONVS3, fps=1.0)
    tout = multi.MultiStreamSession(tparams, tcfg, ttok, InferConfig(**kw), batch=3,
                                    **CPU).run(videos, CONVS3, fps=1.0)
    n_resp = 0
    for b in range(3):
        _assert_stream(tout[b], jout[b]["responses"], jout[b]["debug_data"])
        assert [t for t in tout[b]["responses"] if t["role"] == "user"] == \
            [t for t in jout[b]["responses"] if t["role"] == "user"]
        _assert_stream(tout[b], *_solo(model, kw, videos[b], CONVS3[b]))
        n_resp += len(_assistant(tout[b]["responses"]))
    assert n_resp >= 2


SERVER_LENGTHS = [7, 2, 10, 4, 5]
# every server below sizes its frames buffer for the longest stream of any case,
# so that JAX compiles one serving program a configuration
MAX_FRAMES = 10
SERVER_CONVS = [[{"role": "user", "content": "what is happening?", "time": 0}],
                [],
                [{"role": "user", "content": "find the dog", "time": 2.0},
                 {"role": "user", "content": "and now?", "time": 6.0}],
                [{"role": "user", "content": "summarize", "time": 1.0}],
                [{"role": "user", "content": "anything new?", "time": 0}]]


def _server_items(cfg, seed=3):
    videos = _videos(np.random.default_rng(seed), SERVER_LENGTHS, cfg.frame_resolution)
    items = [(f"s{j}", videos[j], SERVER_CONVS[j]) for j in range(5)]
    # an empty stream: its result comes back without taking a slot
    items.insert(2, ("empty", np.zeros((0, cfg.frame_resolution, cfg.frame_resolution, 3),
                                       np.uint8), [{"role": "user", "content": "?", "time": 0}]))
    return videos, items


@pytest.mark.parametrize("width", list(WIDTHS))
def test_multi_stream_server_matches_jax(model, width):
    """MultiStreamServer, 5 requests (and an empty one) over 2 slots, so
    slots are refilled: equal to JAX's server and to the port's solo
    sessions, stream by stream."""
    params, cfg, tok, tparams, tcfg, ttok = model
    videos, items = _server_items(cfg)
    kw = _kw(width, stream_end_prob_threshold=0.55)
    jres = _jax_server(model, kw, 2).run_items(items, fps=1.0)
    done = []
    tres = multi.MultiStreamServer(tparams, tcfg, ttok, InferConfig(**kw), batch=2,
                                   max_frames=MAX_FRAMES, **CPU).run_items(
        items, fps=1.0, on_result=lambda k, r: done.append(k))
    assert set(tres) == set(jres) == {"empty", *(f"s{j}" for j in range(5))} == set(done)
    assert tres["empty"] == jres["empty"]
    n_resp = 0
    for j in range(5):
        _assert_stream(tres[f"s{j}"], jres[f"s{j}"]["responses"], jres[f"s{j}"]["debug_data"])
        _assert_stream(tres[f"s{j}"], *_solo(model, kw, videos[j], SERVER_CONVS[j]))
        n_resp += len(_assistant(tres[f"s{j}"]["responses"]))
    assert n_resp >= 3


# -- the server against JAX's and the port's own solo sessions, case by case ------------------


def _server_vs_solo(model, kw, items, batch, solo_kw=None, **run_kw):
    """Serve ``items`` over ``batch`` slots and hold each stream against JAX's
    server on the same items and config and against the port's solo session
    (``solo_kw[key]`` overrides its config). Returns the results, the number
    of responses and the server."""
    params, cfg, tok, tparams, tcfg, ttok = model
    jres = _jax_server(model, kw, batch).run_items(list(items), fps=1.0)
    server = multi.MultiStreamServer(tparams, tcfg, ttok, InferConfig(**kw), batch=batch,
                                     max_frames=MAX_FRAMES, **CPU)
    res = server.run_items(items, fps=1.0, **run_kw)
    assert set(res) == set(jres)
    n = 0
    for key, video, conv, *_ in items:
        _assert_stream(res[key], jres[key]["responses"], jres[key]["debug_data"])
        assert [t for t in res[key]["responses"] if t["role"] == "user"] == \
            [t for t in jres[key]["responses"] if t["role"] == "user"]
        _assert_stream(res[key], *_solo(model, {**kw, **(solo_kw or {}).get(key, {})},
                                        video, conv))
        n += len(_assistant(res[key]["responses"]))
    return res, n, server


def _items(cfg, lengths, convs, seed):
    videos = _videos(np.random.default_rng(seed), lengths, cfg.frame_resolution)
    return [(f"s{j}", videos[j], convs[j]) for j in range(len(lengths))]


Q0 = lambda j: [{"role": "user", "content": f"q{j}", "time": 0}]


def _case_thresholds(model, width):
    """Per-request rules: an unreachable prob threshold mutes its row, the
    sum rule and the z rule on others; each equals a solo session with the
    request's own rules."""
    cfg = model[1]
    items = _items(cfg, [5, 5, 6, 5], [Q0(j) for j in range(4)], 13)
    items[0] = (*items[0], {"stream_end_prob_threshold": 1e9})
    items[1] = (*items[1], None)
    items[2] = (*items[2], {"stream_end_score_sum_threshold": 1.5})
    items[3] = (*items[3], {"threshold_z": 0.5})
    kw = _kw(width, stream_end_prob_threshold=0.55, first_n_frames_no_generate=2,
             running_list_length=5)
    only = lambda **r: {"stream_end_prob_threshold": None, **r}
    res, n, _ = _server_vs_solo(model, kw, items, 2, solo_kw={
        "s0": only(stream_end_prob_threshold=1e9),
        "s2": only(stream_end_score_sum_threshold=1.5),
        "s3": only(threshold_z=0.5)})
    assert not _assistant(res["s0"]["responses"]) and len(res["s0"]["debug_data"]) == 5
    return n


def _case_z(model, width):
    """The z rule as the server's default (JAX's z case: 0.8, first 3
    frames, a window of 5)."""
    items = _items(model[1], [10, 10, 10], [Q0(j) for j in range(3)], 21)
    kw = _kw(width, threshold_z=0.8, first_n_frames_no_generate=3, running_list_length=5)
    return _server_vs_solo(model, kw, items, 3)[1]


def _case_min_interval(model, width):
    """response_min_interval_frames 3: the same suppressed triggers as solo."""
    items = _items(model[1], [9, 9], [Q0(j) for j in range(2)], 31)
    kw = _kw(width, stream_end_prob_threshold=0.55, response_min_interval_frames=3)
    res, n, _ = _server_vs_solo(model, kw, items, 2)
    for r in res.values():
        times = [t for t, _ in _assistant(r["responses"])]
        assert all(b - a >= 3 for a, b in zip(times, times[1:]))
    return n


def _case_rollback(model, width):
    """remove_assistant_turns: generation on a copy of the cache, two
    queries due at the same time interleaved with frames."""
    convs = [[{"role": "user", "content": "what is happening?", "time": 0}],
             [{"role": "user", "content": "first?", "time": 1.0},
              {"role": "user", "content": "second?", "time": 1.0}],
             [{"role": "user", "content": "find the dog", "time": 2.0}]]
    items = _items(model[1], [7, 4, 9], convs, 7)
    kw = _kw(width, stream_end_prob_threshold=0.55, remove_assistant_turns=True)
    return _server_vs_solo(model, kw, items, 3)[1]


def _case_retire_defer(model, width):
    """retire_defer 2 gives what retire_defer 1 gives (a schedule only)."""
    items = _items(model[1], [7, 3, 10, 5, 4],
                   [Q0(0), [], [{"role": "user", "content": "find", "time": 2.0}], Q0(3), []],
                   21)
    kw = _kw(width, stream_end_prob_threshold=0.55)
    base, n, _ = _server_vs_solo(model, kw, items, 2)
    _, _, _, tparams, tcfg, ttok = model
    got = multi.MultiStreamServer(tparams, tcfg, ttok, InferConfig(**kw, retire_defer=2),
                                  batch=2, max_frames=MAX_FRAMES, **CPU).run_items(items, fps=1.0)
    _assert_same(got, base)
    return n


def _assert_same(got, want):
    """Two runs' results: the same streams and turns, scores within
    tolerance (which rows share a pass moves the last f32 places)."""
    assert set(got) == set(want)
    for k in want:
        assert got[k]["responses"] == want[k]["responses"], k
        _assert_stream(got[k], want[k]["responses"], want[k]["debug_data"])


def _case_stats(model, width):
    """The instrumented stats path gives the production path's results, and
    its phase split adds up."""
    items = _items(model[1], [7, 3, 10, 5], [Q0(0), [], SERVER_CONVS[2], Q0(3)], 11)
    items[1] = (*items[1], {"stream_end_prob_threshold": 0.8})
    kw = _kw(width, stream_end_prob_threshold=0.55, threshold_z=None)
    prod, n, server = _server_vs_solo(model, kw, items, 2,
                                      solo_kw={"s1": {"stream_end_prob_threshold": 0.8}})
    stats = {}
    instr = server.run_items(items, fps=1.0, stats=stats)
    assert [sorted(_assistant(r["responses"])) for r in instr.values()] == \
        [sorted(_assistant(r["responses"])) for r in prod.values()]
    for k in prod:
        _assert_stream(instr[k], prod[k]["responses"], prod[k]["debug_data"])
    assert stats["iterations"] > 0 and stats["frames_scored"] == 25
    assert stats.get("tokens_generated", 0) > 0
    for phase in ("admit_s", "text_s", "score_s", "gen_s", "host_s"):
        assert stats[phase] >= 0.0
    assert server.latency_stats()["n_responses"] == n
    return n


def _case_live_feeder(model, width):
    """A feeder that yields None (nothing ready) gives eager feeding's
    results, also when it starves with no slot occupied."""
    items = _items(model[1], [5, 3, 6], [Q0(j) for j in range(3)], 5)
    kw = _kw(width, stream_end_prob_threshold=0.55)
    eager, n, server = _server_vs_solo(model, kw, items, 2)

    def starving():
        yield None
        yield None
        for it in items:
            yield it
            yield None

    _assert_same(server.run_items(starving(), fps=1.0), eager)
    return n


SERVER_CASES = {"thresholds": _case_thresholds, "z": _case_z,
                "min_interval": _case_min_interval, "rollback": _case_rollback,
                "retire_defer": _case_retire_defer, "stats": _case_stats,
                "live_feeder": _case_live_feeder}


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_server_matches_solo_sessions(model, case, width):
    """The continuous-batching server, case by case, against JAX's server on
    the same items and config and against the port's own solo sessions, at
    fused 1 / spec 1 and fused 4 / spec 4 -> 8; every case fires responses."""
    assert SERVER_CASES[case](model, width) >= 1


def test_refusals(model):
    """``mesh=`` is taken: a one-rank mesh serves as no mesh does (sharded
    meshes: tests/test_torch_sharded_serving.py); adapters are taken too, and
    go to the engine (tests/test_torch_adapters.py serves them)."""
    from aha_tpu_torch.parallel.mesh import make_mesh

    _, _, _, tparams, tcfg, ttok = model
    kw = _kw(stream_end_prob_threshold=0.5)
    mesh = make_mesh(1, 1)
    server = multi.MultiStreamServer(tparams, tcfg, ttok, InferConfig(**kw), batch=2,
                                     max_frames=4, mesh=mesh, **CPU)
    assert server.engine.mesh is None and server.engine.params is tparams
    scorer = multi.MultiStreamScorer(tparams, tcfg, ttok, InferConfig(**kw), batch=2, lora={},
                                     lora_scale=2.0, **CPU)
    assert scorer.engine.lora == {} and scorer.engine.lora_scale == 2.0
