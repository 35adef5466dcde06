"""The port's command line and the host modules behind ``infer`` on the CPU:
cv2 decoding and the streaming-QA dataset against JAX's on cv2-written clips,
the driver against JAX's driver on bridged sessions, ``python -m
aha_tpu_torch.cli infer`` end to end at the tiny preset, its serving options
(``--w8a8``, ``--vision_int8``, ``--lora_pretrained``) against the JAX
command, and the dispatcher's eight commands."""

import dataclasses
import functools
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aha_tpu import native
from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.config import aha_tiny
from aha_tpu.data import media as jmedia
from aha_tpu.data import pipeline as jpipeline
from aha_tpu.drivers import benchmarks as jbenchmarks
from aha_tpu.drivers import eval_dataset as jeval_dataset
from aha_tpu.models import aha as jaha
from aha_tpu.ops import quant
from aha_tpu.streaming.session import build_session as jbuild_session

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.cli import COMMANDS, cmd_infer, main
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.data import media, pipeline
from aha_tpu_torch.drivers import benchmarks, eval_dataset
from aha_tpu_torch.streaming.session import build_session
from aha_tpu_torch.tokenization import build_stream_tokenizer

cv2 = pytest.importorskip("cv2")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("informative_score", "relevance_score", "uncertainty_score")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_fake_video(path, n_frames=24, fps=8.0, size=(64, 48)):
    """tests/test_drivers.py's recipe: a grey ramp with a noisy corner."""
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    rng = np.random.default_rng(hash(str(path)) % 2**31)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 10) % 255, np.uint8)
        frame[:10, :10] = rng.integers(0, 255, (10, 10, 3))
        out.write(frame)
    out.release()


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    write_fake_video(d / "vidA.mp4")
    write_fake_video(d / "vidB.mp4", n_frames=20, fps=10.0, size=(48, 64))
    qa = [{"question_id": "q1", "video": "vidA.mp4",
           "conversation": [{"role": "user", "content": "what?", "time": 0},
                            {"role": "user", "content": "now?", "time": 1.5}]},
          {"question_id": "q2", "video": "missing.mp4",
           "conversation": [{"role": "user", "content": "what?", "time": 0}]},
          {"question_id": "q3", "video": "vidB.avi",          # found as vidB.mp4
           "conversation": [{"role": "user", "content": "and this?", "time": 0.5}]}]
    (d / "qa.json").write_text(json.dumps(qa))
    return d


@pytest.fixture()
def cv2_only(monkeypatch):
    """JAX's decoder prefers its native libav build where there is one; the
    port's does too, so both are held to their cv2 paths."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")   # the port's too


@pytest.mark.parametrize("fps,size,max_frames", [(2.0, 32, None), (3.0, 40, 5), (8.0, 24, None),
                                                 (0.5, 32, None)])
def test_decode_video_matches_jax(video_dir, cv2_only, fps, size, max_frames):
    """The cv2 decode with letterboxing: the same frames, bit for bit, and
    the same source indices, on a wide and a tall clip."""
    for name in ("vidA.mp4", "vidB.mp4"):
        path = str(video_dir / name)
        got, idx = media.decode_video(path, output_fps=fps, output_size=size,
                                      max_frames=max_frames)
        ref, ref_idx = jmedia.decode_video(path, output_fps=fps, output_size=size,
                                           max_frames=max_frames)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert idx == ref_idx


def test_decode_video_refuses_what_it_cannot_open(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        media.decode_video(str(tmp_path / "none.mp4"), output_fps=1.0)


@pytest.mark.parametrize("fn", ["round_time_by_fps", "ceil_time_by_fps", "floor_time_by_fps"])
def test_time_by_fps_matches_jax(fn):
    rng = np.random.default_rng(0)
    for t, fps in zip(rng.uniform(-1, 12, 50), rng.choice([0.5, 1.0, 2.0, 3.0, 29.97], 50)):
        assert getattr(media, fn)(t, fps, 0.0, 10.0) == getattr(jmedia, fn)(t, fps, 0.0, 10.0)


def test_resize_and_pad_frame_matches_jax():
    rng = np.random.default_rng(1)
    for h, w in ((48, 64), (64, 48), (33, 33), (10, 70)):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(media.resize_and_pad_frame(frame, 32),
                                      jmedia.resize_and_pad_frame(frame, 32))


@pytest.mark.parametrize("kw", [dict(output_fps=2.0, max_num_frames=100),
                                dict(output_fps="auto", max_num_frames=6),
                                dict(output_fps=2.0, max_num_frames=4,
                                     time_instruction_format="timechat"),
                                dict(output_fps=1.0, max_num_frames=100,
                                     time_instruction_format="vtimellm", start_idx=1)])
def test_streaming_qa_dataset_matches_jax(video_dir, cv2_only, kw):
    """Items of StreamingVideoQADataset against JAX's: question id, frames,
    conversation (system turn, time instructions), fps and duration; a
    missing video is an item of Nones; a .avi name finds its .mp4."""
    args = (str(video_dir / "qa.json"), str(video_dir))
    got = eval_dataset.StreamingVideoQADataset(*args, output_resolution=32, **kw)
    ref = jeval_dataset.StreamingVideoQADataset(*args, output_resolution=32, **kw)
    assert len(got) == len(ref)
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert (a[0], a[2], a[3], a[4]) == (b[0], b[2], b[3], b[4])
        if b[1] is None:
            assert a[1] is None
        else:
            np.testing.assert_array_equal(a[1], b[1])


def test_prefetch_iterable_matches_jax():
    """Order kept, and a producer's exception raised at the consumer after
    the items before it."""
    assert list(pipeline.prefetch_iterable(iter(range(20)), depth=3)) == \
        list(jpipeline.prefetch_iterable(iter(range(20)), depth=3))

    def failing():
        yield 1
        yield 2
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in pipeline.prefetch_iterable(failing()):
            got.append(x)
    assert got == [1, 2]


def test_round_numbers_matches_jax():
    rng = np.random.default_rng(2)
    data = [{"time": float(t), "s": float(s), "tiny": float(s) * 1e-5, "n": 3, "z": 0.0,
             "nested": [float(s) * 10]}
            for t, s in zip(rng.uniform(0, 100, 30), rng.standard_normal(30))]
    assert benchmarks.round_numbers(data, 3) == jbenchmarks.round_numbers(data, 3)
    for x in (0.0, 1.23456e-7, -4.5678e-4, 12.3456):
        assert benchmarks.truncate_sig(x) == jbenchmarks.truncate_sig(x)


# -- the driver against JAX's --------------------------------------------------------


def port_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


@pytest.fixture(scope="module")
def tiny_int8():
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    qparams = quant.quantize_params(params)
    ttok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                  vocab_size=cfg.llm.vocab_size)
    return (qparams, cfg, tok,
            bridge.params_from_jax(jax.tree.map(np.asarray, qparams), device="cpu"),
            port_cfg(cfg), ttok)


@pytest.mark.parametrize("mode", ["generation", "grounding"])
def test_run_streaming_qa_matches_jax(tiny_int8, video_dir, cv2_only, tmp_path, mode):
    """run_streaming_qa of the port and of JAX on sessions over the same int8
    tree (chunked inference() at fused 4 and generation 4 -> 8, or
    score_video): the same JSONL lines, scores within 1e-3 after the
    driver's rounding to 3 places, turns equal; the missing video skipped."""
    qparams, cfg, tok, tparams, tcfg, ttok = tiny_int8
    kw = dict(frame_fps=2.0, frame_resolution=cfg.frame_resolution, kv_cache_policy="sink",
              kv_window=256, num_sink_tokens=8, max_new_tokens=8, repetition_penalty=1.3)
    kw.update(grounding_mode=True) if mode == "grounding" else kw.update(
        stream_end_score_sum_threshold=2.9)
    drive = dict(test_fname=str(video_dir / "qa.json"), input_dir=str(video_dir),
                 frame_fps=2.0, max_num_frames=10, grounding_mode=mode == "grounding")
    ref = jbenchmarks.run_streaming_qa(jbuild_session(qparams, cfg, tok, JInferConfig(**kw)),
                                       output_fname=str(tmp_path / "jax.jsonl"), **drive)
    got = benchmarks.run_streaming_qa(
        build_session(tparams, tcfg, ttok, InferConfig(**kw), device="cpu"),
        output_fname=str(tmp_path / "port.jsonl"), **drive)
    lines = [json.loads(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert lines == json.loads(json.dumps(got))
    assert [r["question_id"] for r in got] == [r["question_id"] for r in ref] == ["q1", "q3"]
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        assert a["video_duration"] == b["video_duration"]
        assert [(t["role"], t["time"], t["content"]) for t in a["model_response_list"]] == \
            [(t["role"], t["time"], t["content"]) for t in b["model_response_list"]]
        assert [d["time"] for d in a["debug_data"]] == [d["time"] for d in b["debug_data"]]
        np.testing.assert_allclose([[d[k] for k in KEYS] for d in a["debug_data"]],
                                   [[d[k] for k in KEYS] for d in b["debug_data"]], atol=1e-3)
    if mode == "generation":
        assert any(t["role"] == "assistant" for r in got for t in r["model_response_list"])


# -- the command line -------------------------------------------------------------------


def _infer_argv(video_dir, out, *extra):
    return ["infer", "--model_preset", "tiny", "--device", "cpu", "--synthetic_weights",
            "--test_dataset", "youcook2", "--input_dir", str(video_dir),
            "--test_fname", str(video_dir / "qa.json"), "--output_fname", str(out),
            "--frame_fps", "2", "--max_num_frames", "8", "--max_new_tokens", "6", *extra]


@pytest.mark.parametrize("mode", ["generation", "grounding"])
def test_cli_infer_writes_the_jax_format(video_dir, tmp_path, mode):
    """``python -m aha_tpu_torch.cli infer`` at the tiny preset on the CPU
    with synthetic int8 weights (then int4 in grounding mode): one JSONL
    line a found video with the keys of the JAX command's lines, finite
    scores, and responses in generation mode."""
    out = tmp_path / "pred.jsonl"
    extra = (["--int8", "--stream_end_prob_threshold", "0.5"] if mode == "generation"
             else ["--int4", "--grounding_mode"])
    res = subprocess.run([sys.executable, "-m", "aha_tpu_torch.cli",
                          *_infer_argv(video_dir, out, *extra)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["question_id"] for x in lines] == ["q1", "q3"]
    for x in lines:
        assert set(x) == {"question_id", "model_response_list", "video_duration", "debug_data"}
        assert x["debug_data"] and all(set(d) == {"time", *KEYS} for d in x["debug_data"])
        assert all(np.isfinite(d[k]) for d in x["debug_data"] for k in KEYS)
        roles = [t["role"] for t in x["model_response_list"]]
        assert ("assistant" in roles) == (mode == "generation")


# the serving options of infer, each run on both sides: int8 weights, the int8 tower and
# per-token int8 activations at fused 8 (JAX's random init, so the tower is quantised); the
# int8 tower alone; the reference's checkpoint and peft artifact (bf16 .safetensors, r 4);
# a peft directory written by the port over synthetic int8 weights (the overrides stay
# dense f32 there), at one stream and at two; --vision_int8 over dense synthetic weights,
# whose tower JAX leaves dense
SERVING_OPTIONS = {
    "w8a8": ["--w8a8"],
    "vision_int8": ["--int8", "--vision_int8"],
    "llm_pretrained": ["--int8", "--llm_pretrained", "{ckpt}", "--tokenizer_pretrained",
                       "{ckpt}", "--lora_pretrained", "{adapter}"],
    "lora_pretrained": ["--synthetic_weights", "--int8", "--lora_pretrained", "{peft}"],
    "dense_synthetic": ["--synthetic_weights", "--vision_int8"],
    "concurrent_streams": ["--synthetic_weights", "--int8", "--concurrent_streams", "2",
                           "--lora_pretrained", "{peft}"],
}


@pytest.fixture(scope="module")
def port_peft(tmp_path_factory):
    """A peft directory for the tiny preset (vocab 512) written by the port's
    save_adapter: seeded r 4 adapters on the seven projections (B != 0),
    alpha 8, and f32 projector, heads and lm_head."""
    from aha_tpu_torch.models import loader
    from aha_tpu_torch.train.lora import proj_dims

    cfg = tconfig.aha_tiny()
    g = torch.Generator().manual_seed(11)
    rand = lambda *shape: torch.randn(shape, generator=g) * 0.05
    L, H, Hv, V = (cfg.llm.num_layers, cfg.llm.hidden_size, cfg.vision.hidden_size,
                   cfg.llm.vocab_size)
    lora = {n: {"a": rand(L, din, 4) * 2, "b": rand(L, 4, dout)}
            for n, (din, dout) in proj_dims(cfg.llm).items()}
    modules = {"projector": {"fc1": {"kernel": rand(Hv, H), "bias": rand(H)},
                             "fc2": {"kernel": rand(H, H), "bias": rand(H)}},
               "heads": {n: {"kernel": rand(H, c)} for n, c in
                         (("informative", 2), ("relevance", 1), ("uncertainty", 1))},
               "llm": {"lm_head": {"kernel": rand(H, V)}}}
    return loader.save_adapter(str(tmp_path_factory.mktemp("peft")), lora, 2.0, modules)


@pytest.mark.parametrize("case", list(SERVING_OPTIONS))
def test_cli_infer_runs_the_serving_options(video_dir, cv2_only, tmp_path, monkeypatch,
                                           checkpoint_and_adapter, port_peft, case):
    """``infer`` with --w8a8, --vision_int8 or --lora_pretrained (the options the
    port refused before) against the JAX command with the same flags: the same
    lines, turns equal, scores within 1e-3 after `round_numbers`' 3 places
    (2e-3 with int8 activations, whose quantiser ties can fall the other way).
    Widths 1 (--w8a8: its fused 8), as the commands' plumbing is what is held."""
    from aha_tpu.cli.infer import cmd_infer as jcmd_infer

    monkeypatch.setattr(quant, "_FORCE_BACKEND", None)      # JAX's --w8a8 sets it
    ckpt, adapter = checkpoint_and_adapter
    flags = [f.format(ckpt=ckpt, adapter=adapter, peft=port_peft)
             for f in SERVING_OPTIONS[case]]
    flags += ["--spec_decode_tokens", "1", "--stream_end_prob_threshold", "0.5"]
    if case != "w8a8":
        flags += ["--fused_score_frames", "1"]
    argv = [a for a in _infer_argv(video_dir, tmp_path / "port.jsonl")[1:]
            if a != "--synthetic_weights"] + flags
    cmd_infer(argv)
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    jargv[jargv.index("--output_fname") + 1] = str(tmp_path / "jax.jsonl")
    jcmd_infer(jargv)
    got = [json.loads(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    ref = [json.loads(x) for x in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [x["question_id"] for x in got] == [x["question_id"] for x in ref] == ["q1", "q3"]
    for a, b in zip(got, ref):
        assert a.keys() == b.keys() and a["video_duration"] == b["video_duration"]
        assert a["model_response_list"] == b["model_response_list"]
        assert [d["time"] for d in a["debug_data"]] == [d["time"] for d in b["debug_data"]]
        np.testing.assert_allclose([[d[k] for k in KEYS] for d in a["debug_data"]],
                                   [[d[k] for k in KEYS] for d in b["debug_data"]],
                                   atol=2e-3 if case == "w8a8" else 1e-3)


def _session_scores(sess, frames):
    return np.asarray([[r[k] for k in KEYS] for r in sess.score_video(frames, query="what?")])


def test_cli_infer_refuses_a_run_without_synthetic_weights(video_dir, tmp_path):
    """Refused before the loader was ported; now, as in JAX, a run with
    neither --synthetic_weights nor --llm_pretrained serves the seed-0 random
    init (``init_aha_params``), here quantised by --int8: the session scores
    frames as the JAX command's does (atol 1e-3), and the command writes its
    lines."""
    import argparse

    from aha_tpu.cli._session import _add_infer_flags as jflags
    from aha_tpu.cli._session import _build_session as jbuild

    from aha_tpu_torch.cli._session import _add_infer_flags, _build_session

    argv = [a for a in _infer_argv(video_dir, tmp_path / "x.jsonl", "--int8",
                                   "--stream_end_prob_threshold", "0.5")
            if a != "--synthetic_weights"]
    cmd_infer(argv[1:])
    assert len((tmp_path / "x.jsonl").read_text().splitlines()) == 2

    def args(add, *extra):
        p = argparse.ArgumentParser()
        add(p)
        return p.parse_args(["--test_dataset", "youcook2", "--input_dir", ".",
                             "--output_fname", "unused", "--model_preset", "tiny", "--int8",
                             "--grounding_mode", *extra])

    frames = np.random.default_rng(2).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        _session_scores(_build_session(args(_add_infer_flags, "--device", "cpu")), frames),
        _session_scores(jbuild(args(jflags)), frames), atol=1e-3)


@pytest.fixture(scope="module")
def checkpoint_and_adapter(tmp_path_factory):
    """scripts/make_synthetic_hf_checkpoint.py's reduced llava-onevision
    checkpoint (bf16 .safetensors shards, config.json, a BPE tokenizer) and
    its peft adapter directory."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_synthetic_hf_checkpoint

    return make_synthetic_hf_checkpoint.generate(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def checkpoint(checkpoint_and_adapter):
    return checkpoint_and_adapter[0]


@pytest.mark.parametrize("weights", ["checkpoint-int8", "dense-synthetic"])
def test_cli_infer_runs_checkpoints_and_dense_synthetic_weights(video_dir, tmp_path, checkpoint,
                                                               weights):
    """``python -m aha_tpu_torch.cli infer --llm_pretrained DIR
    --tokenizer_pretrained DIR --int8`` (the port's own safetensors reader),
    and ``--synthetic_weights`` without a quantised form (JAX's dense tree in
    the preset's dtype): the command writes its lines with finite scores."""
    out = tmp_path / "pred.jsonl"
    argv = _infer_argv(video_dir, out, "--grounding_mode")
    if weights == "checkpoint-int8":
        argv = [a for a in argv if a != "--synthetic_weights"]
        argv += ["--llm_pretrained", checkpoint, "--tokenizer_pretrained", checkpoint, "--int8"]
    res = subprocess.run([sys.executable, "-m", "aha_tpu_torch.cli", *argv],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["question_id"] for x in lines] == ["q1", "q3"]
    assert all(np.isfinite(d[k]) for x in lines for d in x["debug_data"] for k in KEYS)


def test_cli_dispatcher():
    """The JAX command names, all eight ported (infer, demo, serve, train,
    grid-search, evaluate, highlight, visualize); an unknown command exits 2.
    The live-video datasets and demo run in tests/test_torch_live_video.py,
    visualize in tests/test_torch_visualize.py."""
    from aha_tpu.cli import COMMANDS as JCOMMANDS

    from aha_tpu_torch.cli import (cmd_demo, cmd_evaluate, cmd_grid_search, cmd_highlight,
                                   cmd_serve, cmd_train, cmd_visualize)

    assert set(COMMANDS) == set(JCOMMANDS) and COMMANDS["infer"] is cmd_infer
    ported = {"serve": cmd_serve, "train": cmd_train, "grid-search": cmd_grid_search,
              "evaluate": cmd_evaluate, "highlight": cmd_highlight, "demo": cmd_demo,
              "visualize": cmd_visualize}
    assert all(COMMANDS[name] is cmd for name, cmd in ported.items())
    assert set(COMMANDS) - set(ported) == {"infer"}
    assert main(["nonsense"]) == 2 and main([]) == 0


def test_cli_flags_match_jax():
    """The infer flags are JAX's, with their defaults, plus --device."""
    import argparse

    from aha_tpu.cli import _add_infer_flags as jflags
    from aha_tpu_torch.cli._session import _add_infer_flags

    def defaults(add):
        p = argparse.ArgumentParser()
        add(p)
        return {a.dest: (a.default, tuple(a.choices or ())) for a in p._actions
                if a.dest != "help"}

    got, ref = defaults(_add_infer_flags), defaults(jflags)
    assert got.pop("device") == ("cuda", ())
    assert got == ref


def test_session_has_args(tiny_int8):
    """session.args is the InferConfig, as the drivers read it."""
    _, _, _, tparams, tcfg, ttok = tiny_int8
    icfg = InferConfig(grounding_mode=True, frame_resolution=tcfg.frame_resolution)
    s = build_session(tparams, tcfg, ttok, icfg, device="cpu")
    assert s.args is icfg and s.args.system_prompt == JInferConfig().system_prompt
