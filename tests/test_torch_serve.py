"""The port's multi-stream command line on the CPU: ``infer
--concurrent_streams 3`` and ``serve`` (aha_tpu_torch/cli/serve.py) at the
tiny preset against the JAX commands on the same clips, written with cv2.
Neither side is given weights, so both serve JAX's seed-0 init quantised by
--int8; the lines must agree in keys and content (scores within 1e-3 after
`round_numbers`' 3 places), with adapters and with --w8a8 too, and what is not
ported is refused."""

import json
import pathlib

import numpy as np
import pytest
import torch

from aha_tpu import native
from aha_tpu.cli.infer import cmd_infer as jcmd_infer
from aha_tpu.cli.serve import cmd_serve as jcmd_serve

from aha_tpu_torch.cli import cmd_infer, cmd_serve, main

cv2 = pytest.importorskip("cv2")

KEYS = ("informative_score", "relevance_score", "uncertainty_score")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cv2_only(monkeypatch):
    """Both packages decode with their native libav builds where there is
    one; both are held to their cv2 paths."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")   # the port's too


def write_clip(path, n_frames, fps=4.0, size=(40, 32), seed=0):
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 23) % 255, np.uint8)
        frame[:12, :12] = rng.integers(0, 255, (12, 12, 3))
        out.write(frame)
    out.release()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three clips of 3-5 s at 4 fps (6-10 frames at 2 fps) and a QA file
    over them: queries at t = 0 and mid-stream, one stream without one."""
    d = tmp_path_factory.mktemp("clips")
    for j, n in enumerate((20, 12, 16)):
        write_clip(d / f"v{j}.mp4", n, seed=j)
    convs = [[{"role": "user", "content": "what is happening?", "time": 0},
              {"role": "user", "content": "and now?", "time": 2.5}],
             [],
             [{"role": "user", "content": "find the dog", "time": 1.0}]]
    qa = [{"question_id": f"q{j}", "video": f"v{j}.mp4", "conversation": c}
          for j, c in enumerate(convs)]
    (d / "qa.json").write_text(json.dumps(qa))
    reqs = [{"key": f"r{j}", "video": str(d / f"v{j}.mp4"), "conversation": c}
            for j, c in enumerate(convs)]
    reqs[2]["stream_end_score_sum_threshold"] = 1.5        # a rule of its own
    (d / "requests.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return d


# widths 1: the commands' plumbing is what these tests hold (the widths are held by
# tests/test_torch_multi_stream.py), and JAX compiles fewer programs for them
COMMON = ["--model_preset", "tiny", "--int8", "--frame_fps", "2", "--max_new_tokens", "6",
          "--kv_window", "64", "--num_sink_tokens", "4", "--stream_end_prob_threshold", "0.5",
          "--fused_score_frames", "1", "--spec_decode_tokens", "1"]


def _lines(path):
    return [json.loads(x) for x in pathlib.Path(path).read_text().splitlines()]


def _assert_scores(a, b):
    assert [d["time"] for d in a] == [d["time"] for d in b]
    np.testing.assert_allclose([[d[k] for k in KEYS] for d in a],
                               [[d[k] for k in KEYS] for d in b], atol=1e-3)


@pytest.mark.parametrize("mode", ["generation", "grounding"])
def test_infer_concurrent_streams_matches_jax(clips, tmp_path, mode):
    """``infer --concurrent_streams 3`` (generation: the continuous-batching
    server; grounding: the lockstep scorer) against the JAX command: the
    same lines in dataset order, turns equal, scores within 1e-3."""
    argv = ["--test_dataset", "youcook2", "--input_dir", str(clips),
            "--test_fname", str(clips / "qa.json"), "--max_num_frames", "10",
            "--concurrent_streams", "3", *COMMON]
    if mode == "grounding":
        argv += ["--grounding_mode"]
    jcmd_infer(argv + ["--output_fname", str(tmp_path / "jax.jsonl")])
    cmd_infer(argv + ["--output_fname", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    got, ref = _lines(tmp_path / "port.jsonl"), _lines(tmp_path / "jax.jsonl")
    assert [x["question_id"] for x in got] == [x["question_id"] for x in ref] == \
        ["q0", "q1", "q2"]
    for a, b in zip(got, ref):
        assert a.keys() == b.keys() == {"question_id", "model_response_list",
                                        "video_duration", "debug_data"}
        assert a["video_duration"] == b["video_duration"]
        assert a["model_response_list"] == b["model_response_list"]
        _assert_scores(a["debug_data"], b["debug_data"])
    if mode == "generation":
        assert any(t["role"] == "assistant" for x in got for t in x["model_response_list"])


def test_serve_matches_jax(clips, tmp_path):
    """``serve`` on a JSONL of 3 requests (one with its own rule) over 3
    slots (the programs of the infer test above, which JAX's compile cache
    then serves), and a request whose video cannot be read: one result line
    per request with the JAX command's keys and content (--emit_scores), the
    unreadable one as an error line."""
    reqs = (clips / "requests.jsonl").read_text() + json.dumps(
        {"key": "bad", "video": str(clips / "none.mp4")}) + "\n"
    (tmp_path / "in.jsonl").write_text(reqs)
    argv = ["--input", str(tmp_path / "in.jsonl"), "--batch", "3", "--max_frames", "10",
            "--emit_scores", *COMMON]
    jcmd_serve(argv + ["--output", str(tmp_path / "jax.jsonl")])
    cmd_serve(argv + ["--output", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    got = {x["key"]: x for x in _lines(tmp_path / "port.jsonl")}
    ref = {x["key"]: x for x in _lines(tmp_path / "jax.jsonl")}
    assert set(got) == set(ref) == {"r0", "r1", "r2", "bad"}
    assert set(got["bad"]) == set(ref["bad"]) == {"key", "error"}
    for k in ("r0", "r1", "r2"):
        assert got[k].keys() == ref[k].keys() == {"key", "responses", "debug_data"}
        assert got[k]["responses"] == ref[k]["responses"]
        _assert_scores(got[k]["debug_data"], ref[k]["debug_data"])
    assert any(t["role"] == "assistant" for x in got.values() for t in x.get("responses", []))


@pytest.fixture(scope="module")
def port_peft(tmp_path_factory):
    """A peft directory for the tiny preset written by the port's save_adapter:
    seeded r 4 adapters (B != 0) at alpha 8, f32 projector, heads and lm_head."""
    from aha_tpu_torch import config as tconfig
    from aha_tpu_torch.models import loader
    from aha_tpu_torch.train.lora import proj_dims

    cfg = tconfig.aha_tiny()
    g = torch.Generator().manual_seed(12)
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


@pytest.mark.parametrize("case", ["lora_pretrained", "w8a8"])
def test_serve_runs_the_serving_options(clips, tmp_path, monkeypatch, port_peft, case):
    """``serve`` with --lora_pretrained (a peft directory written by the port,
    over the seed-0 init quantised by --int8) or --w8a8 (the int8 tower and
    per-token int8 activations; fused scoring stays at its width at --batch 3)
    against the JAX command on the same requests: one line per request, the
    same keys and responses, scores within 1e-3 (2e-3 with int8 activations)."""
    from aha_tpu.ops import quant

    monkeypatch.setattr(quant, "_FORCE_BACKEND", None)      # JAX's --w8a8 sets it
    flags = ["--lora_pretrained", port_peft] if case == "lora_pretrained" else ["--w8a8"]
    argv = ["--input", str(clips / "requests.jsonl"), "--batch", "3", "--max_frames", "10",
            "--emit_scores", *COMMON, *flags]
    jcmd_serve(argv + ["--output", str(tmp_path / "jax.jsonl")])
    cmd_serve(argv + ["--output", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    got = {x["key"]: x for x in _lines(tmp_path / "port.jsonl")}
    ref = {x["key"]: x for x in _lines(tmp_path / "jax.jsonl")}
    assert set(got) == set(ref) == {"r0", "r1", "r2"}
    for k in ref:
        assert got[k].keys() == ref[k].keys() == {"key", "responses", "debug_data"}
        assert got[k]["responses"] == ref[k]["responses"]
        assert [d["time"] for d in got[k]["debug_data"]] == \
            [d["time"] for d in ref[k]["debug_data"]]
        np.testing.assert_allclose([[d[x] for x in KEYS] for d in got[k]["debug_data"]],
                                   [[d[x] for x in KEYS] for d in ref[k]["debug_data"]],
                                   atol=2e-3 if case == "w8a8" else 1e-3)
    assert any(t["role"] == "assistant" for x in got.values() for t in x["responses"])


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--mesh_model", "2"], "mesh 1x2 needs 2 ranks; start it with torchrun "
                 "--nproc_per_node 2", id="flags0-item 12")])
def test_serve_refuses_what_is_not_ported(clips, tmp_path, capsys, flags, item):
    """A sharded mesh in one process, without a world of its size, exits 2
    naming the ranks the mesh needs (the mesh runs under torchrun:
    tests/test_torch_sharded_serving.py), and writes no line."""
    out = tmp_path / "out.jsonl"
    assert main(["serve", "--model_preset", "tiny", "--device", "cpu",
                 "--input", str(clips / "requests.jsonl"), "--output", str(out),
                 "--stream_end_prob_threshold", "0.5", *flags]) == 2
    assert item in capsys.readouterr().err
    assert not out.exists()
