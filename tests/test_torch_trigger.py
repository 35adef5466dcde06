"""The port's trigger loops (aha_tpu_torch/streaming/engine_trigger.py) and
its chunked inference() on the CPU: the z rule against JAX's, the engine's
loops (per frame, fused, the one-row multi loop) against the JAX engine's on
bridged dense f32 params, the chunked session against JAX's chunked session
on int8 params, and the port's chunked loop against its own stepwise loop
(the restatement of tests/test_streaming.py's and
tests/test_fused_scoring.py's chunked-vs-sequential tests)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import quant
from aha_tpu.ops.kv_cache import CachePolicy as JCachePolicy
from aha_tpu.streaming import engine_core
from aha_tpu.streaming.engine import StreamEngine as JStreamEngine
from aha_tpu.streaming.session import StreamSession as JStreamSession

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.ops.kv_cache import CachePolicy
from aha_tpu_torch.streaming import engine_trigger
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


params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")
HEADS = ("informative_score", "relevance_score")
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
F = 5                     # tokens a frame in the engine tests (they take embeddings)
POLICY = dict(kind="sink", window=24, num_sink=4)
CPU = dict(device="cpu")


def port_cfg(cfg):
    """The port's own AhaConfig from the JAX package's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


def _scores(rows):
    return np.asarray([[r[k] for k in KEYS] for r in rows], np.float64)


def _turns(turns):
    return [(t["role"], t["time"], t["content"]) for t in turns]


# -- the z rule -------------------------------------------------------------------


@pytest.mark.parametrize("L,first_n,z_thr", [(5, 3, 0.8), (20, 0, 0.3), (2, 2, -0.5),
                                             (6, 8, 1.5)])
def test_z_step_matches_jax(L, first_n, z_thr):
    """z_step (two rows, one with the rule off, rows inactive at random) and
    z_step_host against JAX's over 40 seeded scores with spikes: the same
    decisions and counts at every step, windows to 1e-6."""
    rng = np.random.default_rng(L + first_n)
    steps, B = 40, 2
    score = (0.9 + 0.05 * rng.standard_normal((steps, B))).astype(np.float32)
    score[rng.random((steps, B)) < 0.15] += 0.5
    active = rng.random((steps, B)) < 0.8
    thr = np.asarray([z_thr, np.inf], np.float32)
    jz = engine_core.make_core(aha_tiny(), JCachePolicy(), None, 0.0, 1).z_step
    jh, jc = jnp.zeros((B, L), jnp.float32), jnp.zeros((B,), jnp.int32)
    th, tc = torch.zeros((B, L)), torch.zeros((B,), dtype=torch.int32)
    hh, hc = np.zeros((1, L), np.float32), np.zeros((1,), np.int32)      # host mirror, row 0
    jhh, jhc = hh.copy(), hc.copy()
    fired = 0
    for t in range(steps):
        jh, jc, jf = jz(jh, jc, jnp.asarray(score[t]), jnp.asarray(active[t]),
                        jnp.asarray(thr), first_n)
        th, tc, tf = engine_trigger.z_step(th, tc, torch.from_numpy(score[t]),
                                           torch.from_numpy(active[t]), torch.from_numpy(thr),
                                           first_n)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
        host = engine_trigger.z_step_host(hh, hc, 0, score[t, 0], z_thr, first_n)
        assert host == engine_core.z_step_host(jhh, jhc, 0, score[t, 0], z_thr, first_n)
        np.testing.assert_array_equal(hh, jhh)
        fired += host
    assert fired > 0 or z_thr > 1.0


# -- the engine's loops against the JAX engine's --------------------------------------


@pytest.fixture(scope="module")
def dense():
    params, cfg, _ = jaha.build_model_and_tokenizer(aha_tiny(vocab_size=128), seed=0)
    return params, cfg, params_from_jax(jax.tree.map(np.asarray, params)), port_cfg(cfg)


@functools.lru_cache(maxsize=None)
def _embeds(T, H, seed):
    return (np.random.default_rng(seed).standard_normal((T, F, H)) * 0.1).astype(np.float32)


def _jax_engine(dense, k):
    params, cfg = dense[:2]
    return JStreamEngine(params, cfg, JCachePolicy(**POLICY), fused_score_frames=k)


def _port_engine(dense, k):
    tp, tcfg = dense[2:]
    return StreamEngine(tp, tcfg, CachePolicy(**POLICY), fused_score_frames=k, **CPU)


@pytest.fixture(scope="module")
def jax_engines(dense):
    return {k: _jax_engine(dense, k) for k in (1, 4)}


def _assert_meta_equal(tcache, jcache, junk):
    keep = np.arange(tcache.order.shape[1]) != junk
    for f in ("order", "key_pos"):
        np.testing.assert_array_equal(getattr(tcache, f).numpy()[:, keep],
                                      np.asarray(getattr(jcache, f))[:, keep], err_msg=f)
    for f in ("seen", "length"):
        np.testing.assert_array_equal(getattr(tcache, f).numpy(),
                                      np.asarray(getattr(jcache, f)), err_msg=f)


def _assert_cache_equal(a, b, junk):
    """Two port caches: metadata exactly, occupied K/V to 2e-5."""
    keep = torch.arange(a.order.shape[1]) != junk
    for f in ("order", "key_pos"):
        assert torch.equal(getattr(a, f)[:, keep], getattr(b, f)[:, keep]), f
    assert torch.equal(a.seen, b.seen) and torch.equal(a.length, b.length)
    occ = ((b.order >= 0) & keep)[None, :, :, None, None]
    for f in ("k", "v"):
        np.testing.assert_allclose(torch.where(occ, getattr(a, f), 0.0).numpy(),
                                   torch.where(occ, getattr(b, f), 0.0).numpy(),
                                   rtol=2e-4, atol=2e-5)


T13 = 13
# thresholds placed at the per-frame run's own score levels, so that triggers land
# mid-pass, at pass edges and not at all; then a resume_at that suppresses frames
CASES = ["prob_q15", "prob_q50", "prob_q85", "sum_0", "sum_5", "sum_9", "sum_never",
         "prob_q15_resume6"]


@pytest.fixture(scope="module")
def trace(dense, jax_engines):
    """The stream-end scores of the 13-frame stream, per frame (JAX)."""
    H = dense[1].llm.hidden_size
    _, s_all = jax_engines[1].score_stream(jax_engines[1].new_cache(),
                                           jnp.asarray(_embeds(T13, H, 5))[None])
    return np.asarray(s_all[0, :, 0] + s_all[0, :, 1], np.float64)


def _case(trace, name):
    cums = np.cumsum(trace)
    if name.startswith("prob"):
        q = {"q15": 0.15, "q50": 0.5, "q85": 0.85}[name.split("_")[1]]
        return dict(prob_threshold=float(np.quantile(trace, q)), sum_threshold=None,
                    resume_at=6 if name.endswith("resume6") else 0)
    at = name.split("_")[1]
    c = cums[-1] + 1.0 if at == "never" else cums[int(at)]
    return dict(prob_threshold=None, sum_threshold=float(c - 1e-6), resume_at=0)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_score_until_trigger_matches_jax(dense, jax_engines, trace, case, k):
    """score_until_trigger per frame (k = 1) and fused (k = 4, JAX's
    score_until_trigger_fused: tails of 1 frame, triggers in the middle of a
    pass) against the JAX engine's: equal frames scored, fired and cache metadata; the running
    sum and the scores to 1e-5 (dense f32 tiny)."""
    c = _case(trace, case)
    H = dense[1].llm.hidden_size
    frames = _embeds(T13, H, 5)
    jeng, teng = jax_engines[k], _port_engine(dense, k)
    jc, jsb, jn, jsum, jtrig = jeng.score_until_trigger(
        jeng.new_cache(), jnp.asarray(frames), T13, 0.0, c["prob_threshold"],
        c["sum_threshold"], HEADS, resume_at=c["resume_at"])
    tc = teng.new_cache()
    sb, n, ssum, trig = teng.score_until_trigger(
        tc, torch.from_numpy(frames), T13, 0.0, c["prob_threshold"], c["sum_threshold"], HEADS,
        resume_at=c["resume_at"])
    assert (n, trig) == (int(jn), bool(jtrig))
    np.testing.assert_allclose(ssum, float(jsum), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sb.numpy()[:n], np.asarray(jsb)[:n], rtol=1e-5, atol=1e-5)
    _assert_meta_equal(tc, jc, teng.policy.junk)
    if case == "sum_never":
        assert n == T13 and not trig
    if case == "sum_5":
        assert trig and n == 6 and ssum == 0.0        # frame 5: the middle of a pass at k 4


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_fused_scores_take_the_replayed_attention(dense, jax_engines, monkeypatch, kv):
    """score_stream at fused 4 (verify_frames and its commit) over 13 frames,
    through the window fill: on the f32 cache every verify pass's attention is
    replayed_attention (the steps' write passes in one launch), never the
    composed speculative_attention, and the scores hold to JAX's fused scores
    (1e-5) and to the port's per-frame scores (2e-5); on an int8 cache the
    composed one, as JAX composes it."""
    from aha_tpu_torch.models import qwen2 as tqwen2

    calls = {"replayed_attention": 0, "speculative_attention": 0}
    for name in calls:
        real = getattr(tqwen2, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tqwen2, name, counted)
    tp, tcfg = dense[2:]
    frames = _embeds(T13, tcfg.llm.hidden_size, 5)
    kv_dtype = torch.int8 if kv == "int8" else None
    eng = StreamEngine(tp, tcfg, CachePolicy(**POLICY), fused_score_frames=4, kv_dtype=kv_dtype,
                       **CPU)
    s4 = eng.score_stream(eng.new_cache(), torch.from_numpy(frames)[None])
    L, passes = tcfg.llm.num_layers, -(-T13 // 4)
    if kv == "int8":
        assert calls == {"replayed_attention": 0, "speculative_attention": L * passes}
        return
    assert calls == {"replayed_attention": L * passes, "speculative_attention": 0}
    _, js = jax_engines[4].score_stream(jax_engines[4].new_cache(), jnp.asarray(frames)[None])
    np.testing.assert_allclose(s4.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    eng1 = _port_engine(dense, 1)
    s1 = eng1.score_stream(eng1.new_cache(), torch.from_numpy(frames)[None])
    np.testing.assert_allclose(s4.numpy(), s1.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_fused_trigger_loop_matches_sequential(dense, trace, case):
    """The port's fused loop (k = 4) against its per-frame loop, the
    restatement of tests/test_fused_scoring.py::
    test_fused_trigger_loop_matches_sequential: equal frames scored and
    fired, scores and sum to 1e-5, and the same cache after the commit of
    a pass cut at its trigger (metadata exactly, occupied K/V to 2e-5)."""
    c = _case(trace, case)
    frames = torch.from_numpy(_embeds(T13, dense[1].llm.hidden_size, 5))
    out = []
    for k in (1, 4):
        eng = _port_engine(dense, k)
        cache = eng.new_cache()
        out.append((eng.score_until_trigger(cache, frames, T13, 0.0, c["prob_threshold"],
                                            c["sum_threshold"], HEADS,
                                            resume_at=c["resume_at"]), cache))
    ((s1, n1, sum1, t1), c1), ((s4, n4, sum4, t4), c4) = out
    assert (n4, t4) == (n1, t1)
    np.testing.assert_allclose(sum4, sum1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s4.numpy()[:n1], s1.numpy()[:n1], rtol=1e-5, atol=1e-6)
    _assert_cache_equal(c4, c1, CachePolicy(**POLICY).junk)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("rule", ["prob", "sum"])
def test_trigger_loop_resume_after_trigger(dense, jax_engines, rule, k):
    """Fired in the middle of a pass, then resumed on the rest of the stream
    from the committed cache with the carried sum (the session's
    generate-then-continue pattern; a sum hit carries 0), against the JAX
    engine, and at k = 4 against the port's per-frame loop: the restatement
    of tests/test_fused_scoring.py::test_fused_trigger_loop_resume_after_trigger."""
    T = 11
    H = dense[1].llm.hidden_size
    frames = _embeds(T, H, 6)
    _, s_all = jax_engines[1].score_stream(jax_engines[1].new_cache(),
                                           jnp.asarray(frames)[None])
    se = np.asarray(s_all[0, :, 0] + s_all[0, :, 1], np.float64)
    if rule == "prob":
        thr = dict(prob_threshold=float(se[5]) - 1e-6, sum_threshold=None)
        again = dict(prob_threshold=None, sum_threshold=None)
    else:
        thr = dict(prob_threshold=None, sum_threshold=float(se[:6].sum()) - 1e-6)
        again = thr
    runs = {}
    for name, eng in (("jax", jax_engines[k]), ("port", _port_engine(dense, k)),
                      ("port1", _port_engine(dense, 1))):
        frames_x = jnp.asarray(frames) if name == "jax" else torch.from_numpy(frames)
        cache = eng.new_cache()
        out = eng.score_until_trigger(cache, frames_x, T, 0.0, thr["prob_threshold"],
                                      thr["sum_threshold"], HEADS)
        if name == "jax":
            cache, out = out[0], out[1:]
        sb, n, ssum, trig = out
        n = int(n)
        assert bool(trig) and n <= 6
        out2 = eng.score_until_trigger(cache, frames_x[n:], T - n, float(ssum),
                                       again["prob_threshold"], again["sum_threshold"], HEADS)
        if name == "jax":
            cache, out2 = out2[0], out2[1:]
        runs[name] = (n, float(ssum), np.asarray(sb)[:n], int(out2[1]), float(out2[2]),
                      bool(out2[3]), np.asarray(out2[0])[:int(out2[1])], cache)
    ref = runs["jax"]
    for name in ("port", "port1"):
        got = runs[name]
        assert (got[0], got[3], got[5]) == (ref[0], ref[3], ref[5]), name
        for a, b in ((got[1], ref[1]), (got[4], ref[4])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        for a, b in ((got[2], ref[2]), (got[6], ref[6])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        _assert_meta_equal(got[7], ref[7], CachePolicy(**POLICY).junk)
    if rule == "sum":
        assert ref[1] == 0.0
    if k == 4:
        _assert_cache_equal(runs["port"][7], runs["port1"][7], CachePolicy(**POLICY).junk)


def _drive_multi(eng, frames, rule, z_state, is_jax):
    """Repeated score_until_trigger_multi calls at one row until the stream
    ends, each from where the last stopped. Returns ({frame: scores},
    trigger frames, cache, final sum, z state)."""
    T = frames.shape[1]
    cache = eng.new_cache()
    start, ssum, zs = 0, 0.0, z_state
    trace, events = {}, []
    while start < T:
        out = eng.score_until_trigger_multi(
            cache, frames, [start], [T], [ssum], rule.get("prob"), rule.get("sum"), HEADS,
            z_threshold=rule.get("z"), z_state=zs, first_n_frames=2)
        if is_jax:
            cache, out = out[0], out[1:]
        sb, i2, s2, trig, zh, zc = out
        zs = (zh, zc)
        i2 = int(np.asarray(i2)[0])
        sb = np.asarray(sb)
        for t in range(start, i2):
            trace[t] = sb[0, t].copy()
        if bool(np.asarray(trig)[0]):
            events.append(i2)
        start, ssum = i2, float(np.asarray(s2)[0])
    return trace, events, cache, ssum, (np.asarray(zs[0]), np.asarray(zs[1]))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("rule", ["prob", "sum", "z"])
def test_score_until_trigger_multi_matches_jax(dense, jax_engines, trace, rule, k):
    """score_until_trigger_multi at B = 1 (per frame and fused), driven to
    the end of a 13-frame stream: the same trigger frames, the same z
    window and count, scores and sums to 1e-5, the same cache metadata as
    the JAX engine's."""
    r = {"prob": dict(prob=float(np.quantile(trace, 0.6))),
         "sum": dict(sum=float(np.cumsum(trace)[2])),
         "z": dict(z=0.2)}[rule]
    frames = _embeds(T13, dense[1].llm.hidden_size, 5)[None]
    jeng, teng = jax_engines[k], _port_engine(dense, k)
    jt, jev, jc, jsum, jz = _drive_multi(jeng, jnp.asarray(frames), r, jeng.new_z_state(6), True)
    tt, tev, tc, tsum, tz = _drive_multi(teng, torch.from_numpy(frames), r, teng.new_z_state(6),
                                         False)
    assert tev == jev and len(jev) >= 2
    assert sorted(tt) == sorted(jt) == list(range(T13))
    for t in jt:
        np.testing.assert_allclose(tt[t], jt[t], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsum, jsum, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tz[1], jz[1])
    np.testing.assert_allclose(tz[0], jz[0], atol=1e-5)
    _assert_meta_equal(tc, jc, teng.policy.junk)


def test_trigger_loops_at_three_rows_match_jax(dense, trace):
    """Three rows (multi-stream serving), each with its own stream, start,
    limit, threshold (the prob rule, the sum rule, the z rule alone) and
    resume_at, driven call after call (a call returns when a row fires or
    reaches its limit) to every row's limit. Every call gives JAX's
    engine's next frames, fired rows, sums, z windows and scores (1e-5), and
    the cache ends with JAX's metadata; per frame and fused (k = 4)."""
    for k in (1, 4):
        _drive_rows(dense, trace, k, [0, 1, 2], with_jax=True)


def test_trigger_loops_take_batch_one(dense, trace):
    """Each of the three rows above, alone in an engine of batch one, gives
    what it gives among the three: the same scores (1e-5), fired frames and
    end cursor; per frame and fused (k = 4)."""
    for k in (1, 4):
        three = _drive_rows(dense, trace, k, [0, 1, 2])
        for b in range(3):
            alone = _drive_rows(dense, trace, k, [b])
            assert alone[0]["fired"] == three[b]["fired"], (k, b)
            assert alone[0]["end"] == three[b]["end"], (k, b)
            np.testing.assert_allclose(alone[0]["scores"], three[b]["scores"], rtol=1e-5,
                                       atol=1e-5)


def _drive_rows(dense, trace, k, rows, with_jax=False):
    """Drive the port's engine over the three-row case's ``rows`` to their
    limits (with ``with_jax``, JAX's engine beside it, checked call by call).
    Returns per row its scores over [start, limit), fired frames and end."""
    B, H = len(rows), dense[1].llm.hidden_size
    pick = lambda x, dt: np.asarray([x[r] for r in rows], dt)
    frames = np.stack([_embeds(T13, H, 5 + r) for r in rows])
    prob = pick([float(np.quantile(trace, 0.6)), np.inf, np.inf], np.float32)
    ssum = pick([np.inf, float(np.cumsum(trace)[2]), np.inf], np.float32)
    zthr = pick([np.inf, np.inf, 0.2], np.float32)
    limit = pick([T13, 11, 9], np.int32)
    resume = pick([0, 3, 0], np.int32)
    start = pick([0, 1, 0], np.int32)
    params, cfg, tp, tcfg = dense
    teng = StreamEngine(tp, tcfg, CachePolicy(**POLICY), batch=B, fused_score_frames=k, **CPU)
    tc, tz = teng.new_cache(), teng.new_z_state(6)
    if with_jax:
        jeng = JStreamEngine(params, cfg, JCachePolicy(**POLICY), batch=B, fused_score_frames=k)
        jc, jz = jeng.new_cache(), jeng.new_z_state(6)
    out = [dict(scores=[], fired=[], end=int(start[b])) for b in range(B)]
    run = np.zeros(B, np.float32)
    calls = fired_rows = 0
    while (start < limit).any():
        args = (start, limit, run, prob, ssum, HEADS)
        kw = dict(z_threshold=zthr, first_n_frames=2, resume_at=resume)
        tsb, ti, tsum, ttrig, tzh, tzc = teng.score_until_trigger_multi(
            tc, torch.from_numpy(frames), *args, z_state=tz, **kw)
        if with_jax:
            jc, jsb, ji, jsum, jtrig, jzh, jzc = jeng.score_until_trigger_multi(
                jc, jnp.asarray(frames), *args, z_state=jz, **kw)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_array_equal(ttrig, np.asarray(jtrig))
            np.testing.assert_allclose(tsum, np.asarray(jsum), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(tzc.numpy(), np.asarray(jzc))
            np.testing.assert_allclose(tzh.numpy(), np.asarray(jzh), atol=1e-5)
            for b in range(B):
                np.testing.assert_allclose(tsb.numpy()[b, start[b]:ti[b]],
                                           np.asarray(jsb)[b, start[b]:ti[b]], rtol=1e-5,
                                           atol=1e-5)
            jz = (jzh, jzc)
        for b in range(B):
            out[b]["scores"].extend(tsb.numpy()[b, start[b]:ti[b]].tolist())
            if ttrig[b]:
                out[b]["fired"].append(int(ti[b]))
            out[b]["end"] = int(ti[b])
        tz = (tzh, tzc)
        start, run = np.asarray(ti, np.int32), np.asarray(tsum, np.float32)
        calls += 1
        fired_rows += int(np.asarray(ttrig).sum())
    if with_jax:
        _assert_meta_equal(tc, jc, teng.policy.junk)
        assert calls >= 3 and fired_rows >= 3
    return out


# -- the chunked session against JAX's chunked session ---------------------------------


@pytest.fixture(scope="module")
def int8(dense):
    """int8 tiny (vocab 512: the session's tokenizer) with merged projections,
    as both engines serve it; JAX engines at widths 1 and at fused 4 /
    generation 4, shared across rules (the rules live in the session)."""
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    qparams = quant.quantize_params(params)
    qparams = {**qparams, "llm": quant.merge_decoder_projections(qparams["llm"])}
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    policy = JCachePolicy("sink", window=256, num_sink=8)
    jengines = {w: JStreamEngine(qparams, cfg, policy, max_new_tokens=8, repetition_penalty=1.3,
                                 spec_tokens=w, fused_score_frames=w) for w in (1, 4)}
    return jengines, tok, params_from_jax(jax.tree.map(np.asarray, qparams)), port_cfg(cfg), ttok


QUERY = "What is happening in this video?"
SESSION_CASES = {
    "prob": dict(stream_end_prob_threshold=0.985),
    "sum": dict(stream_end_score_sum_threshold=2.9),
    "z": dict(threshold_z=0.5, first_n_frames_no_generate=3, running_list_length=6),
    "prob_rollback": dict(stream_end_prob_threshold=0.985, remove_assistant_turns=True),
    "sum_min_interval": dict(stream_end_score_sum_threshold=1.9, response_min_interval_frames=3),
    "z_min_interval": dict(threshold_z=0.2, first_n_frames_no_generate=2,
                           response_min_interval_frames=4),
    "same_time_queries": dict(stream_end_prob_threshold=0.985),
}


def _run(make, frames, conv, chunked):
    s = make()
    s.input_video_stream(frames)
    s.input_query_stream(conv)
    return s, s.inference(chunked=chunked)


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_chunked_inference_matches_jax(int8, case, width):
    """The port's chunked inference() against JAX's chunked inference() on
    the same int8 tree (sink window 256, repetition penalty) at widths 1
    and at fused 4 with generation 4, for the prob, sum and z rules, the
    rollback of remove_assistant_turns, response_min_interval_frames and
    two queries due at the same time: scores at atol 1e-4 / rtol 1e-3, and
    (role, time, content) equal."""
    jengines, tok, tparams, tcfg, ttok = int8
    kw = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=8,
              max_new_tokens=8, repetition_penalty=1.3, fused_score_frames=width,
              spec_decode_tokens=width, spec_decode_tokens_max=width, **SESSION_CASES[case])
    frames = np.random.default_rng(5).integers(0, 256, (14, 40, 48, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": QUERY, "time": 0},
            {"role": "user", "content": "And now?", "time": 2.5}]
    if case == "same_time_queries":
        conv = [{"role": "user", "content": QUERY, "time": 1.0},
                {"role": "user", "content": "And now?", "time": 1.0}]
    js, jturns = _run(lambda: JStreamSession(jengines[width], tok, JInferConfig(**kw)),
                      frames, conv, True)
    ts, tturns = _run(lambda: build_session(tparams, tcfg, ttok, InferConfig(**kw), **CPU),
                      frames, conv, True)
    assert [r["time"] for r in ts.debug_data_list] == [r["time"] for r in js.debug_data_list]
    np.testing.assert_allclose(_scores(ts.debug_data_list), _scores(js.debug_data_list),
                               atol=1e-4, rtol=1e-3)
    assert _turns(tturns) == _turns(jturns)
    n = sum(t["role"] == "assistant" for t in tturns)
    assert 1 <= n < len(frames), n


# -- the port's chunked loop against its own stepwise loop -----------------------------


@pytest.fixture(scope="module")
def tiny128(dense):
    """The tiny preset at vocab 128 (tests/test_streaming.py's fixture) in
    the port, with its tokenizer."""
    _, cfg, tp, tcfg = dense
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    return tp, tcfg, ttok


def _session(tiny128, **overrides):
    tp, tcfg, ttok = tiny128
    kw = dict(frame_fps=1.0, stream_end_prob_threshold=5.0, kv_cache_policy="none",
              kv_window=2048, max_new_tokens=16, system_prompt="sys prompt")
    kw.update(overrides)
    return lambda: build_session(tp, tcfg, ttok, InferConfig(**kw), **CPU)


def _frames(n, seed, res=32):
    return np.random.default_rng(seed).integers(0, 255, size=(n, res, res, 3), dtype=np.uint8)


def _assert_same_run(a, b, ra, rb, n_frames):
    assert len(a.debug_data_list) == len(b.debug_data_list) == n_frames
    for x, y in zip(a.debug_data_list, b.debug_data_list):
        assert x["time"] == y["time"]
        for key in KEYS:
            np.testing.assert_allclose(x[key], y[key], rtol=2e-4, atol=2e-5)
    assert _turns(ra) == _turns(rb)


@pytest.mark.parametrize("fused", [1, 4])
def test_chunked_inference_matches_stepwise(tiny128, fused):
    """Chunked and stepwise loops give the same scores, trigger frames and
    responses (prob rule)."""
    make = _session(tiny128, stream_end_prob_threshold=0.5, fused_score_frames=fused)
    conv = [{"role": "user", "content": "q", "time": 0}]
    a, ra = _run(make, _frames(8, 9), conv, False)
    b, rb = _run(make, _frames(8, 9), conv, True)
    _assert_same_run(a, b, ra, rb, 8)
    assert any(r["role"] == "assistant" for r in ra)


@pytest.mark.parametrize("fused", [1, 4])
def test_chunked_inference_sum_threshold(tiny128, fused):
    make = _session(tiny128, stream_end_prob_threshold=None, stream_end_score_sum_threshold=2.0,
                    fused_score_frames=fused)
    a, ra = _run(make, _frames(10, 11), [], False)
    b, rb = _run(make, _frames(10, 11), [], True)
    _assert_same_run(a, b, ra, rb, 10)
    assert 1 <= sum(r["role"] == "assistant" for r in ra) < 10


@pytest.mark.parametrize("fused", [1, 4])
def test_chunked_inference_threshold_z_matches_stepwise(tiny128, fused):
    """The z rule through the one-row multi loop (its window on the device)
    and z_step_host for prefix frames: the stepwise host rule's trigger
    frames, responses and scores, across the response boundary where the
    window spans a host-checked prefix frame."""
    make = _session(tiny128, stream_end_prob_threshold=None, threshold_z=0.8,
                    first_n_frames_no_generate=3, running_list_length=5, max_new_tokens=4,
                    fused_score_frames=fused)
    conv = [{"role": "user", "content": "q", "time": 0}]
    a, ra = _run(make, _frames(12, 13), conv, False)
    b, rb = _run(make, _frames(12, 13), conv, True)
    _assert_same_run(a, b, ra, rb, 12)
    assert any(r["role"] == "assistant" for r in ra), "the stream must fire the z rule"


@pytest.mark.parametrize("fused", [1, 4])
def test_chunked_matches_stepwise_same_time_queries(tiny128, fused):
    """Two queries due at the same time interleave as q1, frame, q2, frame
    in both loops."""
    make = _session(tiny128, stream_end_prob_threshold=0.5, fused_score_frames=fused)
    conv = [{"role": "user", "content": "first?", "time": 2.0},
            {"role": "user", "content": "second?", "time": 2.0}]
    a, ra = _run(make, _frames(7, 21), conv, False)
    b, rb = _run(make, _frames(7, 21), conv, True)
    _assert_same_run(a, b, ra, rb, 7)


@pytest.mark.parametrize("fused", [1, 4])
def test_response_min_interval_frames(tiny128, fused):
    """The gate suppresses triggers within N frames of the previous
    response, identically in both loops, and fires less than the ungated
    run."""
    conv = [{"role": "user", "content": "q", "time": 0}]

    def run(chunked, gap):
        make = _session(tiny128, stream_end_prob_threshold=0.5,
                        response_min_interval_frames=gap, fused_score_frames=fused)
        return _run(make, _frames(10, 9), conv, chunked)

    _, r_base = run(False, None)
    n_base = sum(r["role"] == "assistant" for r in r_base)
    assert n_base >= 3
    a, ra = run(False, 4)
    b, rb = run(True, 4)
    times = [r["time"] for r in ra if r["role"] == "assistant"]
    assert 1 <= len(times) < n_base
    assert all(t1 - t0 >= 4 for t0, t1 in zip(times, times[1:]))
    _assert_same_run(a, b, ra, rb, 10)
