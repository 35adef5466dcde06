"""Sharded serving on the CPU: the port's StreamEngine, MultiStreamServer and
``serve`` command on a gloo world of 4 ranks (data 2 x model 2; one world
running every case, tests/_torch_world.py) against the port's one-rank
engine and server and against the JAX package's engine and server on the
same mesh of its 8-device CPU mesh, on the tiny tree bridged from JAX's
(vocab 256, sink window 64 with 4 sinks).

  * the engine at fused 1 / speculative 1 and fused 2 / speculative 2: the
    prompt chunk's logits, score_stream's scores and serve_step's within 1e-5
    of the one-rank engine (JAX's: its multi-stream tolerance), generated ids
    and serve_step's cursors and flags equal;
  * MultiStreamServer over 4 ragged streams on 2 slots: responses equal,
    debug scores within the same tolerances;
  * ``serve --mesh_data 2 --mesh_model 2`` writes the lines that
    ``--mesh_data 1`` writes.
"""

import dataclasses
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.parallel import mesh as jmesh
from aha_tpu.streaming import multi as jmulti
from aha_tpu.streaming.engine import StreamEngine as JStreamEngine

from aha_tpu_torch import config as tconfig
from aha_tpu_torch.cli import main
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.parallel.launch import start
from aha_tpu_torch.tokenization import build_stream_tokenizer

MESH = (2, 2)
POLICY = dict(kind="sink", window=64, num_sink=4)
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
B, T = 4, 6
PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]]
GEN = [[11, 12], [13], [14, 15], [16]]
SERVE_KW = dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=64, num_sink_tokens=4,
                max_new_tokens=6, fused_score_frames=2, spec_decode_tokens=2,
                spec_decode_tokens_max=2, stream_end_prob_threshold=0.55)
CONVS = [[{"role": "user", "content": "what is happening?", "time": 0}], [],
         [{"role": "user", "content": "find the dog", "time": 2.0}],
         [{"role": "user", "content": "anything new?", "time": 0}]]


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


def write_clip(path, n_frames, fps=4.0, size=(40, 32), seed=0):
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 23) % 255, np.uint8)
        frame[:12, :12] = rng.integers(0, 255, (12, 12, 3))
        out.write(frame)
    out.release()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(vocab_size=256), seed=0)
    tcfg = port_cfg(cfg)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    tree = jax.tree.map(np.asarray, params)
    r = cfg.frame_resolution
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (B * T, r, r, 3), dtype=np.uint8)
    videos = [rng.integers(0, 255, (n, r, r, 3), dtype=np.uint8) for n in (5, 3, 7, 4)]
    items = [(f"s{j}", videos[j], CONVS[j]) for j in range(4)]
    d = tmp_path_factory.mktemp("serve")
    for j, n in enumerate((12, 8)):
        write_clip(d / f"v{j}.mp4", n, seed=j)
    reqs = [{"key": f"r{j}", "video": str(d / f"v{j}.mp4"), "conversation": c}
            for j, c in enumerate(CONVS[:2])]
    (d / "requests.jsonl").write_text("".join(json.dumps(x) + "\n" for x in reqs))
    flags = ["serve", "--model_preset", "tiny", "--device", "cpu", "--int8", "--frame_fps",
             "2", "--max_new_tokens", "6", "--kv_window", "64", "--num_sink_tokens", "4",
             "--stream_end_prob_threshold", "0.5", "--batch", "2", "--input",
             str(d / "requests.jsonl")]
    return dict(params=params, cfg=cfg, tok=tok, tcfg=tcfg, ttok=ttok, tree=tree,
                frames=frames, items=items, flags=flags, dir=d)


def _cases(s):
    cases = [(f"engine_w{w}", "engine", dict(tree=s["tree"], cfg=s["tcfg"], frames=s["frames"],
                                            prompts=PROMPTS, gen=GEN, width=w, shape=MESH,
                                            policy=POLICY)) for w in (1, 2)]
    cases.append(("server", "server", dict(tree=s["tree"], cfg=s["tcfg"], tok=s["ttok"],
                                           icfg=InferConfig(**SERVE_KW), items=s["items"],
                                           batch=2, max_frames=8, shape=MESH)))
    cases.append(("serve_cli", "serve_cli", dict(argv=s["flags"] + [
        "--output", str(s["dir"] / "sharded.jsonl"), "--mesh_data", "2", "--mesh_model", "2"])))
    return cases


@pytest.fixture(scope="module")
def world(setup):
    import _torch_world

    return start(_torch_world.run, 4, _cases(setup), timeout=240)


def _jax_engine(s, width):
    m = jmesh.make_mesh(*MESH, devices=jax.devices()[:4])
    eng = JStreamEngine(s["params"], s["cfg"], jkv.CachePolicy(**POLICY), batch=B,
                        max_new_tokens=6, mesh=m, spec_tokens=width, spec_tokens_max=width,
                        fused_score_frames=width)
    fe = np.asarray(eng.encode_frames(s["frames"])).reshape(B, T, s["cfg"].frame_num_tokens, -1)
    cache = eng.new_cache()
    cache, logits = eng.append_ids(cache, PROMPTS)
    cache, scores = eng.score_stream(cache, fe)
    cache, ids, n, _, _ = eng.generate(cache, GEN, eng.new_rep_counts())
    res = eng.serve_step(eng.reset_cache(cache), [[] for _ in range(B)], np.ones(B, bool), fe,
                         np.zeros(B, np.int64), np.full(B, T, np.int64), np.zeros(B),
                         eng.new_rep_counts(), 0.3, None,
                         ("informative_score", "relevance_score"), GEN[0])
    return {"logits": np.asarray(logits), "scores": np.asarray(scores), "ids": np.asarray(ids),
            "n": np.asarray(n), "serve_scores": np.asarray(res[1]),
            "serve_next": np.asarray(res[2]), "serve_fired": np.asarray(res[4]),
            "serve_ids": np.asarray(res[5]), "serve_n": np.asarray(res[6])}


@pytest.fixture(scope="module")
def refs(world, setup):
    """JAX's sharded engine and server and the port's one rank, computed
    while the world runs."""
    import _torch_world

    from concurrent.futures import ThreadPoolExecutor

    s = setup
    m = jmesh.make_mesh(*MESH, devices=jax.devices()[:4])

    def jax_server():
        return jmulti.MultiStreamServer(s["params"], s["cfg"], s["tok"],
                                        JInferConfig(**SERVE_KW), batch=2, max_frames=8,
                                        mesh=m).run_items(list(s["items"]), fps=1.0)

    # JAX's programs compile on threads of their own, side by side
    with ThreadPoolExecutor(3) as pool:
        jserver = pool.submit(jax_server)
        jeng = {w: pool.submit(_jax_engine, s, w) for w in (1, 2)}
        out = {"one": {w: _torch_world.engine(s["tree"], s["tcfg"], s["frames"], PROMPTS, GEN,
                                              w, policy=POLICY) for w in (1, 2)},
               "one_server": _torch_world.server(s["tree"], s["tcfg"], s["ttok"],
                                                 InferConfig(**SERVE_KW), s["items"], 2, 8)}
        out["jax"] = {w: f.result() for w, f in jeng.items()}
        out["jax_server"] = jserver.result()
    assert main(s["flags"] + ["--output", str(s["dir"] / "one.jsonl")]) == 0
    return out


@pytest.fixture(scope="module")
def results(world, refs):
    return world.result()[0]


EXACT = ("ids", "n", "serve_next", "serve_fired", "serve_ids", "serve_n")


@pytest.mark.parametrize("width", [1, 2])
def test_engine_sharded(results, refs, width):
    got = results[f"engine_w{width}"]
    one, jx = refs["one"][width], refs["jax"][width]
    for k in EXACT:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jx[k], err_msg=f"{k} vs JAX")
    for k in ("logits", "scores", "serve_scores"):
        np.testing.assert_allclose(got[k], one[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k], jx[k], rtol=3e-4, atol=3e-5, err_msg=f"{k} vs JAX")
    assert got["serve_fired"].any() and got["n"].min() >= 1


def _stream(res):
    return ([(t["role"], t.get("time"), t.get("content")) for t in res["responses"]],
            np.asarray([[d[k] for k in KEYS] for d in res["debug_data"]]),
            [d["time"] for d in res["debug_data"]])


def test_server_sharded(results, refs):
    """2 x B ragged streams over B = 2 slots, so slots are refilled."""
    got = results["server"]
    assert set(got) == set(refs["one_server"]) == set(refs["jax_server"])
    n_resp = 0
    for key in got:
        g, one, jx = (_stream(r[key]) for r in (got, refs["one_server"], refs["jax_server"]))
        assert g[0] == one[0] == jx[0], key
        assert g[2] == one[2] == jx[2], key
        np.testing.assert_allclose(g[1], one[1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[1], jx[1], rtol=3e-4, atol=3e-5)
        n_resp += sum(t[0] == "assistant" for t in g[0])
    assert n_resp >= 2


def test_serve_command_sharded(results, setup, refs):
    """The sharded command's lines are the one-process command's, in order."""
    assert results["serve_cli"] == 0
    d = setup["dir"]
    got = (d / "sharded.jsonl").read_text().splitlines()
    want = (d / "one.jsonl").read_text().splitlines()
    assert got == want and len(got) == 2
    assert any(json.loads(x)["responses"] for x in got)
