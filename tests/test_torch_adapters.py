"""LoRA adapters on the port's serving path, on the CPU at the tiny preset,
against the JAX package: ``decode_chunk`` and ``decode_chunk_spec`` with
adapters (dense, int8 merged and int4 merged trunks; a chunk and S = 1; the
composed and the replayed verify pass) at 1e-5, the peft loader
(``convert_peft_lora``, ``convert_peft_modules_to_save``, ``load_adapter``
with and without ``adapter_config.json``, ``apply_overrides``) equal to JAX's
on the same directory, adapters trained three steps by the port and served
by a port session as JAX's ``build_session(lora=)`` serves them, the
multi-stream scorer and server with adapters against JAX's, and f32 peft
overrides over a bf16 tree (JAX's promotions) against JAX's session."""

import dataclasses
import functools
import json
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu import config as jconfig
from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.models import aha as jaha
from aha_tpu.models import loader as jloader
from aha_tpu.models import qwen2 as jqwen2
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops import quant
from aha_tpu.ops import spec_decode as jspec
from aha_tpu.streaming import multi as jmulti
from aha_tpu.streaming.session import build_session as jbuild_session
from aha_tpu.train import lora as jlora

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.models import loader
from aha_tpu_torch.models import qwen2 as tqwen2
from aha_tpu_torch.ops import kv_cache as tkv
from aha_tpu_torch.ops import spec_decode as tspec
from aha_tpu_torch.streaming import multi
from aha_tpu_torch.streaming.session import build_session
from aha_tpu_torch.tokenization import build_stream_tokenizer
from aha_tpu_torch.train import trainer as ttrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
CPU = dict(device="cpu")
ATOL = 1e-5
SCALE = 2.0
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(cfg):
    """The port's own AhaConfig from the JAX package's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


def numpy_lora(qcfg, seed=0, r=4):
    """Adapters on the seven projections with B != 0, from numpy."""
    rng = np.random.default_rng(seed)
    L = qcfg.num_layers
    return {name: {"a": (rng.standard_normal((L, din, r)) * 0.1).astype(np.float32),
                   "b": (rng.standard_normal((L, r, dout)) * 0.05).astype(np.float32)}
            for name, (din, dout) in jlora.proj_dims(qcfg).items()}


def _scores(rows):
    return np.asarray([[r[k] for k in KEYS] for r in rows], np.float64)


# -- the decoder passes ------------------------------------------------------------------

B = 2
S = 4
VARIANTS = ["dense", "int8_merged", "int4_merged"]


@pytest.fixture(scope="module")
def decoder():
    """The tiny decoder's trunks (dense, int8 and int4 with merged q/k/v and
    gate/up), bridged, and one adapter tree on both sides."""
    qcfg = jconfig.qwen2_tiny(vocab_size=97)
    params = jqwen2.init_params(qcfg, jax.random.PRNGKey(0))
    trunks = {"dense": params}
    for bits in (8, 4):
        trunks[f"int{bits}_merged"] = quant.merge_decoder_projections(
            quant.quantize_params(params, bits=bits))
    lora = numpy_lora(qcfg)
    return (qcfg, tconfig.QwenConfig(**dataclasses.asdict(qcfg)), trunks,
            {k: params_from_jax(_np(v)) for k, v in trunks.items()}, lora,
            params_from_jax(lora))


_jdecode = jax.jit(jqwen2.decode_chunk, static_argnums=(1, 2))
_jverify = jax.jit(jqwen2.decode_chunk_spec, static_argnums=(1, 2))


def _caches(qcfg, window=32, num_sink=4):
    jp = jkv.CachePolicy("sink", window=window, num_sink=num_sink)
    tp = tkv.CachePolicy("sink", window=window, num_sink=num_sink)
    shape = dict(num_layers=qcfg.num_layers, batch=B, num_kv_heads=qcfg.num_kv_heads,
                 head_dim=qcfg.head_dim)
    return (jp, tp, jkv.init_cache(jp, dtype=jnp.float32, **shape),
            tkv.init_cache(tp, device="cpu", dtype=torch.float32, **shape))


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_chunk_with_adapters(decoder, variant):
    """Ragged chunks and single tokens through a 36-slot sink cache past its
    fill, adapters on all seven projections (merged trunks: each on its slice
    of the merged product): hidden states and the written K/V equal JAX's to
    1e-5, and the adapters move the hidden states."""
    qcfg, tq, trunks, tparams, lora, tlora = decoder
    llm, tllm = trunks[variant], tparams[variant]
    jp, tp, jc, tc = _caches(qcfg)
    rng = np.random.default_rng(1)
    for n, vl in [(20, (20, 13)), (1, (1, 1)), (16, (16, 5)), (1, (1, 0)), (12, (12, 12))]:
        x = rng.standard_normal((B, n, qcfg.hidden_size)).astype(np.float32)
        plain = tqwen2.decode_chunk(tllm, tq, tp, tc.clone(), _t(x),
                                    torch.tensor(vl, dtype=torch.int32))
        jh, jc = _jdecode(llm, qcfg, jp, jc, jnp.asarray(x), jnp.asarray(vl, jnp.int32),
                          lora=lora, lora_scale=SCALE)
        th = tqwen2.decode_chunk(tllm, tq, tp, tc, _t(x), torch.tensor(vl, dtype=torch.int32),
                                 lora=tlora, lora_scale=SCALE)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
        assert (th - plain).abs().max() > 1e-3
        occ = (tc.order.numpy() >= 0)[None, :, :, None, None]
        for f in ("k", "v"):
            np.testing.assert_allclose(np.where(occ, getattr(tc, f).numpy(), 0),
                                       np.where(occ, np.asarray(getattr(jc, f)), 0), atol=ATOL)
    assert int(tc.seen[0]) > 36


@pytest.mark.parametrize("replay", [False, True], ids=["composed", "replayed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_chunk_spec_with_adapters(decoder, variant, replay):
    """The read-only verify pass of S = 4 tokens with adapters, on a cache
    past its fill: hidden states and in-flight K/V equal JAX's verify pass
    with the same adapters (1e-5), composed or with the attention replayed,
    and the port's own four sequential passes with adapters (2e-5)."""
    qcfg, tq, trunks, tparams, lora, tlora = decoder
    llm, tllm = trunks[variant], tparams[variant]
    jp, tp, jc, tc = _caches(qcfg)
    rng = np.random.default_rng(2)
    full = jnp.full((B,), 8, jnp.int32)
    for _ in range(5):
        x = (rng.standard_normal((B, 8, qcfg.hidden_size)) * 0.1).astype(np.float32)
        _, jc = _jdecode(llm, qcfg, jp, jc, jnp.asarray(x), full, lora=lora, lora_scale=SCALE)
        tqwen2.decode_chunk(tllm, tq, tp, tc, _t(x), torch.full((B,), 8, dtype=torch.int32),
                            lora=tlora, lora_scale=SCALE)
    embs = (rng.standard_normal((B, S, qcfg.hidden_size)) * 0.1).astype(np.float32)
    jplans = jspec.plan_compose(jc, jp, jnp.full((B,), S, jnp.int32), S)
    tplans = tspec.plan_compose(tc, tp, torch.full((B,), S, dtype=torch.int32), S)
    jh, jik, jiv = _jverify(llm, qcfg, jp, jc, jnp.asarray(embs), jplans, lora=lora,
                            lora_scale=SCALE)
    th, tik, tiv = tqwen2.decode_chunk_spec(tllm, tq, tp, tc, _t(embs), tplans, replay=replay,
                                            lora=tlora, lora_scale=SCALE)
    for got, ref in ((th, jh), (tik, jik), (tiv, jiv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    seq = tc.clone()
    one = torch.ones((B,), dtype=torch.int32)
    h_seq = torch.cat([tqwen2.decode_chunk(tllm, tq, tp, seq, _t(embs[:, j:j + 1]), one,
                                           lora=tlora, lora_scale=SCALE) for j in range(S)], 1)
    np.testing.assert_allclose(th.numpy(), h_seq.numpy(), rtol=2e-5, atol=2e-5)


# -- the peft loader --------------------------------------------------------------------


@pytest.fixture(scope="module")
def peft_dir(tmp_path_factory):
    """scripts/make_synthetic_hf_checkpoint.py's checkpoint and peft adapter
    (bf16 .safetensors, r 4, alpha 8, modules_to_save), and a copy of the
    adapter without its adapter_config.json."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_synthetic_hf_checkpoint as mk

    ov, adapter = mk.generate(str(tmp_path_factory.mktemp("ckpt")))
    bare = tmp_path_factory.mktemp("bare")
    shutil.copy(pathlib.Path(adapter) / "adapter_model.safetensors", bare)
    return ov, adapter, str(bare), jconfig.aha_tiny(vocab_size=mk.VOCAB)


def _assert_trees_equal(got, ref, path=""):
    """A port tree against a JAX tree: the same keys and the same values."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32), path)
    assert got.dtype == torch.float32, path


@pytest.mark.parametrize("config_json", [True, False], ids=["with_config", "without_config"])
def test_peft_loader_matches_jax(peft_dir, config_json):
    """convert_peft_lora and convert_peft_modules_to_save on the directory's
    state dict (read by the port's own reader), load_adapter (lora_alpha / r
    from adapter_config.json: 8 / 4; without it JAX's 32 / 16) and
    apply_overrides onto the bridged base tree: equal to JAX's, f32."""
    _, adapter, bare, cfg = peft_dir
    path = adapter if config_json else bare
    tcfg = port_cfg(cfg)
    sd, jsd = loader.read_state_dict(path), jloader._read_state_dict(path)
    _assert_trees_equal(loader.convert_peft_lora(sd, tcfg.llm, device="cpu"),
                        jloader.convert_peft_lora(jsd, cfg.llm))
    _assert_trees_equal(loader.convert_peft_modules_to_save(sd, device="cpu"),
                        jloader.convert_peft_modules_to_save(jsd))
    lora, over, scale = loader.load_adapter(path, tcfg, device="cpu")
    jl, jo, js = jloader.load_adapter(path, cfg)
    assert scale == js == (2.0 if config_json else 32.0 / 16.0)
    _assert_trees_equal(lora, jl)
    _assert_trees_equal(over, jo)
    base = jaha.init_aha_params(cfg, jax.random.PRNGKey(0))
    merged = loader.apply_overrides(params_from_jax(_np(base)), over)
    ref = jloader.apply_overrides(base, jo)
    _assert_trees_equal({k: merged[k] for k in ("projector", "heads")},
                        {k: ref[k] for k in ("projector", "heads")})
    _assert_trees_equal(merged["llm"]["lm_head"], ref["llm"]["lm_head"])
    assert merged["llm"]["layers"] is not None and "embed" in merged["llm"]
    with pytest.raises(ValueError, match="no lora_A"):
        loader.convert_peft_lora({}, tcfg.llm, device="cpu")


def test_save_adapter_round_trip(peft_dir, tmp_path):
    """save_adapter writes what JAX's load_adapter (the safetensors package)
    reads back equal: the adapters, the scale, and the modules_to_save of a
    tree."""
    _, adapter, _, cfg = peft_dir
    tcfg = port_cfg(cfg)
    lora, over, scale = loader.load_adapter(adapter, tcfg, device="cpu")
    params = loader.apply_overrides(params_from_jax(_np(jaha.init_aha_params(
        cfg, jax.random.PRNGKey(0)))), over)
    out = loader.save_adapter(str(tmp_path / "peft"), lora, scale, params)
    jl, jo, js = jloader.load_adapter(out, cfg)
    assert js == scale
    _assert_trees_equal(lora, jl)
    _assert_trees_equal(over, jo)
    again = loader.load_adapter(out, tcfg, device="cpu")
    _assert_trees_equal(again[0], jl)


# -- a session over adapters the port trained --------------------------------------------


def test_trained_adapters_serve_as_in_jax(tmp_path):
    """Three port train steps of the tiny QLoRA model (int4 trunk, dense
    projector and lm_head, adapters on the seven projections), written as a
    peft directory (save_adapter) and carried to JAX, the adapters through
    bridge.numpy_from_params too: a port session with them scores frames as
    JAX's build_session(lora=) does (1e-5) and writes the same texts."""
    params, cfg, tok = jaha.build_model_and_tokenizer(jconfig.aha_tiny(vocab_size=128), seed=1)
    qp = quant.quantize_params(params, keep_dense=("projector", "lm_head"), bits=4)
    tcfg = port_cfg(cfg)
    tc = tconfig.TrainConfig(lora=tconfig.LoraConfig(dropout=0.0), learning_rate=1e-2,
                             warmup_ratio=0.0, grad_accum_steps=1)
    state, tx, labels, scale = ttrainer.init_train_state(
        tcfg, tc, params_from_jax(_np(qp)), total_steps=10, seed=3, device="cpu")
    step = ttrainer.make_train_step(tcfg, tc, tx, labels, scale, device="cpu")
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    batch, _ = ttrainer.synthetic_batch(tcfg, ttok, np.random.default_rng(0), n_frames=3, B=2)
    for _ in range(3):
        state, _ = step(state, batch)
    trained = state.tree["lora"]
    assert all(float(ab["b"].abs().max()) > 0 for ab in trained.values())
    out = loader.save_adapter(str(tmp_path / "peft"), trained, scale, state.tree["model"])

    jl, jo, js = jloader.load_adapter(out, cfg)
    carried = bridge.numpy_from_params(trained)
    for name in trained:
        for k in ("a", "b"):
            np.testing.assert_array_equal(carried[name][k], np.asarray(jl[name][k]))
    tl, to, ts = loader.load_adapter(out, tcfg, device="cpu")
    assert ts == js == scale
    kw = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=64, num_sink_tokens=4,
              fused_score_frames=1, spec_decode_tokens=1, max_new_tokens=8)
    frames = np.random.default_rng(5).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    jparams = jloader.apply_overrides(qp, jo)
    tparams = loader.apply_overrides(params_from_jax(_np(qp)), to)
    jsess = jbuild_session(jparams, cfg, tok, JInferConfig(grounding_mode=True, **kw), lora=jl,
                           lora_scale=js)
    tsess = build_session(tparams, tcfg, ttok, InferConfig(grounding_mode=True, **kw), lora=tl,
                          lora_scale=ts, **CPU)
    got, ref = (_scores(s.score_video(frames, query="what?")) for s in (tsess, jsess))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    thr = float(np.median(got[:, 0]))
    texts = []
    for build, conf, l, s in ((jbuild_session, JInferConfig, jl, js),
                              (functools.partial(build_session, **CPU), InferConfig, tl, ts)):
        p, t = (jparams, tok) if build is jbuild_session else (tparams, ttok)
        c = cfg if build is jbuild_session else tcfg
        sess = build(p, c, t, conf(stream_end_prob_threshold=thr, **kw), lora=l, lora_scale=s)
        sess.input_video_stream(frames)
        sess.input_query_stream([{"role": "user", "content": "what?", "time": 0}])
        texts.append([(x["time"], x["content"]) for x in sess.inference()
                      if x["role"] == "assistant"])
    assert texts[0] == texts[1] and texts[0]
    plain = build_session(tparams, tcfg, ttok, InferConfig(grounding_mode=True, **kw), **CPU)
    assert np.abs(_scores(plain.score_video(frames, query="what?")) - got).max() > 1e-4


# -- multi-stream serving with adapters --------------------------------------------------


@pytest.fixture(scope="module")
def model():
    params, cfg, tok = jaha.build_model_and_tokenizer(jconfig.aha_tiny(vocab_size=256), seed=0)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    lora = numpy_lora(cfg.llm, seed=4)
    return (params, cfg, tok, params_from_jax(_np(params)), port_cfg(cfg), ttok, lora,
            params_from_jax(lora))


MULTI = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=64, num_sink_tokens=4,
             max_new_tokens=6, fused_score_frames=1, spec_decode_tokens=1,
             spec_decode_tokens_max=1)


def _assert_stream(got, ref):
    assert [(t["time"], t["content"]) for t in got["responses"] if t["role"] == "assistant"] \
        == [(t["time"], t["content"]) for t in ref["responses"] if t["role"] == "assistant"]
    assert [d["time"] for d in got["debug_data"]] == [d["time"] for d in ref["debug_data"]]
    np.testing.assert_allclose(_scores(got["debug_data"]), _scores(ref["debug_data"]),
                               rtol=3e-4, atol=3e-5)


def test_multi_stream_scorer_with_adapters(model):
    """MultiStreamScorer(lora=) over 2 streams (one without a query) against
    JAX's with the same adapters, and against the port's solo sessions with
    them; the adapters move the scores."""
    params, cfg, tok, tparams, tcfg, ttok, lora, tlora = model
    rng = np.random.default_rng(0)
    videos = [rng.integers(0, 255, (n, 32, 32, 3), dtype=np.uint8) for n in (6, 4)]
    queries = ["what is this?", None]
    kw = dict(grounding_mode=True, **MULTI)
    jout = jmulti.MultiStreamScorer(params, cfg, tok, JInferConfig(**kw), batch=2, lora=lora,
                                    lora_scale=SCALE).score_videos(videos, queries, fps=1.0)
    scorer = multi.MultiStreamScorer(tparams, tcfg, ttok, InferConfig(**kw), batch=2, lora=tlora,
                                     lora_scale=SCALE, **CPU)
    tout = scorer.score_videos(videos, queries, fps=1.0)
    for b in range(2):
        _assert_stream({"responses": [], "debug_data": tout[b]},
                       {"responses": [], "debug_data": jout[b]})
        solo = build_session(tparams, tcfg, ttok, InferConfig(**kw), lora=tlora,
                             lora_scale=SCALE, **CPU).score_video(videos[b], query=queries[b])
        np.testing.assert_allclose(_scores(tout[b]), _scores(solo), rtol=3e-4, atol=3e-5)
    plain = multi.MultiStreamScorer(tparams, tcfg, ttok, InferConfig(**kw), batch=2,
                                    **CPU).score_videos(videos, queries, fps=1.0)
    assert np.abs(_scores(plain[0]) - _scores(tout[0])).max() > 1e-4


def test_multi_stream_server_with_adapters(model):
    """MultiStreamServer(lora=) over 3 requests and 2 slots (a slot is
    refilled) against JAX's server with the same adapters: texts, times and
    scores, stream by stream; responses fire."""
    params, cfg, tok, tparams, tcfg, ttok, lora, tlora = model
    rng = np.random.default_rng(1)
    videos = [rng.integers(0, 255, (n, 32, 32, 3), dtype=np.uint8) for n in (7, 4, 6)]
    convs = [[{"role": "user", "content": "what is happening?", "time": 0}],
             [{"role": "user", "content": "find the dog", "time": 1.0}],
             [{"role": "user", "content": "and now?", "time": 0}]]
    items = [(f"s{j}", v, c) for j, (v, c) in enumerate(zip(videos, convs))]
    kw = dict(stream_end_prob_threshold=0.5, **MULTI)
    jres = jmulti.MultiStreamServer(params, cfg, tok, JInferConfig(**kw), batch=2, max_frames=8,
                                    lora=lora, lora_scale=SCALE).run_items(items, fps=1.0)
    tres = multi.MultiStreamServer(tparams, tcfg, ttok, InferConfig(**kw), batch=2, max_frames=8,
                                   lora=tlora, lora_scale=SCALE, **CPU).run_items(items, fps=1.0)
    assert set(tres) == set(jres) == {"s0", "s1", "s2"}
    for k in tres:
        _assert_stream(tres[k], jres[k])
    assert sum(t["role"] == "assistant" for r in tres.values() for t in r["responses"]) >= 2


# -- f32 peft overrides over a bf16 tree ----------------------------------------------------


def test_f32_overrides_on_a_bf16_tree_match_jax():
    """A bf16 tree (the deployment dtype) under a peft artifact's f32
    modules_to_save, with adapters: the f32 projector makes the tower run in
    f32 and the frame embeddings f32, the decoder's frame chunks promote
    against the bf16 weights (and attend to the bf16 cache widened to f32),
    the f32 lm_head gives f32 logits, as JAX's einsums promote them; the
    session's scores equal JAX's within the bf16 tolerance of the 7B fixture
    (atol 2e-2, rtol 5e-2) and its texts are JAX's."""
    cfg = jconfig.aha_tiny(vocab_size=128).replace(dtype="bfloat16")
    params, cfg, tok = jaha.build_model_and_tokenizer(cfg, seed=2, dtype=jnp.bfloat16)
    rng = np.random.default_rng(6)
    H, Hv, V = cfg.llm.hidden_size, cfg.vision.hidden_size, cfg.llm.vocab_size
    f32 = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    over = {"projector": {"fc1": {"kernel": f32(Hv, H), "bias": f32(H)},
                          "fc2": {"kernel": f32(H, H), "bias": f32(H)}},
            "heads": {n: {"kernel": f32(H, c)} for n, c in
                      (("informative", 2), ("relevance", 1), ("uncertainty", 1))},
            "llm": {"lm_head": {"kernel": f32(H, V)}}}
    lora = numpy_lora(cfg.llm, seed=7)
    jparams = jloader.apply_overrides(params, jax.tree.map(jnp.asarray, over))
    tparams = loader.apply_overrides(params_from_jax(_np(params)), params_from_jax(over))
    assert tparams["llm"]["layers"]["o_proj"]["kernel"].dtype == torch.bfloat16
    tcfg = port_cfg(cfg)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    kw = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=64, num_sink_tokens=4,
              fused_score_frames=1, spec_decode_tokens=1, max_new_tokens=6)
    frames = np.random.default_rng(8).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    tsess = build_session(tparams, tcfg, ttok, InferConfig(grounding_mode=True, **kw),
                          lora=params_from_jax(lora), lora_scale=SCALE, **CPU)
    emb = tsess.engine.encode_frames(frames[:2])
    assert emb.dtype == torch.float32
    got = _scores(tsess.score_video(frames, query="what?"))
    jsess = jbuild_session(jparams, cfg, tok, JInferConfig(grounding_mode=True, **kw), lora=lora,
                           lora_scale=SCALE)
    ref = _scores(jsess.score_video(frames, query="what?"))
    assert np.all(np.abs(got - ref) <= 2e-2 + 5e-2 * np.abs(ref)), np.abs(got - ref).max(0)
    thr = float(np.median(got[:, 0]))
    texts = []
    for build, p, c, t, conf, l in ((jbuild_session, jparams, cfg, tok, JInferConfig, lora),
                                    (functools.partial(build_session, **CPU), tparams, tcfg,
                                     ttok, InferConfig, params_from_jax(lora))):
        sess = build(p, c, t, conf(stream_end_prob_threshold=thr, **kw), lora=l,
                     lora_scale=SCALE)
        sess.input_video_stream(frames)
        sess.input_query_stream([{"role": "user", "content": "what?", "time": 0}])
        texts.append([(x["time"], x["content"]) for x in sess.inference()
                      if x["role"] == "assistant"])
    assert texts[0] == texts[1] and texts[0]
