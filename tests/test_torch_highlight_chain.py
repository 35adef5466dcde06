"""The highlight chain of the port on the CPU against the JAX package's, in one
process: the drivers of ``infer`` (``run_tvsum`` plain, degraded, with a
title ablation and with no query; ``run_hisum``; the offline baseline is in
``test_torch_eval.py``, whose worker has room for its JAX session)
on sessions built by each command line from the same flags (JAX's synthetic
tiny int8 tree, which the port draws bit for bit), with the same videos,
queries, true frames, times and responses and scores within 1e-3 after the
drivers' rounding; then the whole chain through ``python -m
aha_tpu_torch.cli`` (``infer --test_dataset tvsum``, ``grid-search``,
``evaluate``, ``highlight``) beside JAX's commands with the same flags.

One JAX session serves the module (its programs compile once); JAX's
``infer`` command is run on it through its own ``_build_session`` name after
the flags it was given are checked to be the session's."""

import argparse
import json
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from aha_tpu import native
from aha_tpu.cli import evaluate as jevaluate
from aha_tpu.cli import infer as jinfer
from aha_tpu.cli._session import _add_infer_flags as jflags
from aha_tpu.cli._session import _build_session as jbuild
from aha_tpu.drivers import benchmarks as jbenchmarks

from aha_tpu_torch.cli import infer as tinfer
from aha_tpu_torch.cli import main
from aha_tpu_torch.cli._session import _add_infer_flags as tflags
from aha_tpu_torch.cli._session import _build_session as tbuild
from aha_tpu_torch.drivers import benchmarks

cv2 = pytest.importorskip("cv2")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
# the session both command lines build; the driver flags vary per run
FLAGS = ["--model_preset", "tiny", "--synthetic_weights", "--int8", "--frame_fps", "2",
         "--max_new_tokens", "12"]
DRIVER_ONLY = {"test_dataset", "input_dir", "output_fname", "test_fname",
               "caption_metadata_file", "video_metadata_file", "anno_file", "hisum_h5_file",
               "no_query", "title_ablation", "title_table", "seed", "device"}
# clips: name -> (source frames at 8 fps, category, title); one length, so that JAX
# compiles one scoring program for all of them
CLIPS = {"vidA": (40, "GA", "a grey ramp"), "vidB": (40, "BK", "noise in a corner"),
         "vidC": (40, "GA", "cooking pasta")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _cv2_only():
    """Both packages decode with their native libav builds where there is
    one; both are held to their cv2 paths here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setenv("AHA_NATIVE_DECODER", "off")   # the port's too
        yield


def write_clip(path, n_frames, fps=8.0, size=(64, 48), seed=0):
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    r = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 9 + seed * 40) % 255, np.uint8)
        frame[:12, :12] = r.integers(0, 255, (12, 12, 3))
        out.write(frame)
    out.release()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three clips and the benchmarks' files around them: TVSum's info TSV
    (a video without a caption among the clips' neighbours), an annotation
    TSV of 20 annotators a video, a title-ablation table, and Mr.HiSum's
    metadata CSV, test keys and gtscore h5."""
    import h5py

    d = tmp_path_factory.mktemp("chain")
    v = d / "videos"
    v.mkdir()
    r = np.random.default_rng(3)
    for i, (name, (n, _, _)) in enumerate(CLIPS.items()):
        write_clip(v / f"{name}.mp4", n, seed=i)
    write_clip(v / "uncaptioned.mp4", 16, seed=9)
    with open(d / "info.tsv", "w") as f:
        f.write("category\tvideo_id\ttitle\turl\tlength\n")
        for name, (n, cat, title) in CLIPS.items():
            f.write(f"{cat}\t{name}\t{title}\thttp://x/{name}\t0:0{n // 8}\n")
    with open(d / "anno.tsv", "w") as f:
        for name, (n, cat, _) in CLIPS.items():
            for _ in range(20):
                f.write(f"{name}\t{cat}\t" + ",".join(str(x) for x in r.integers(1, 6, n)) + "\n")
    (d / "titles.json").write_text(json.dumps({
        name: {"ambiguous_title": f"something {i}", "unrelated_title": f"baking bread {i}"}
        for i, name in enumerate(CLIPS)}))
    (d / "hisum_meta.csv").write_text(
        "video_id,title,labels,youtube_id,yt8m_file\n"
        "video_1,a grey ramp,\"['Food', '']\",vidA,f1\n"
        "video_2,cooking pasta,not a list,vidC,f2\n"
        "video_3,gone,\"[]\",nope,f3\n")
    (d / "hisum_keys.json").write_text(json.dumps({"test_keys": ["video_2", "video_3", "video_9",
                                                                 "video_1"]}))
    with h5py.File(d / "hisum.h5", "w") as hdf:
        for key, n in (("video_1", 11), ("video_2", 12)):
            hdf.create_group(key).create_dataset("gtscore", data=r.random(n))
    return d


@pytest.fixture(autouse=True, scope="module")
def port_infer(data, tmp_path_factory):
    """``python -m aha_tpu_torch.cli infer --test_dataset tvsum`` at the tiny
    preset on the CPU, started when the module starts so that it runs while
    the module's JAX session is built: (process, predictions, metadata)."""
    d = tmp_path_factory.mktemp("port-infer")
    pred, meta = d / "pred.json", d / "meta.json"
    proc = subprocess.Popen([sys.executable, "-m", "aha_tpu_torch.cli",
                             *_infer_argv(data, "tvsum", pred, meta), "--device", "cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    yield proc, pred, meta
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def parse(add, argv):
    p = argparse.ArgumentParser()
    add(p)
    return p.parse_args(argv)


def session_args(argv):
    return {k: v for k, v in vars(argv).items() if k not in DRIVER_ONLY}


@pytest.fixture(scope="module")
def sessions():
    """(JAX session, its parsed flags, port session), each built by its own
    command line from FLAGS with tvsum's grounding rule applied."""
    base = ["--test_dataset", "tvsum", "--input_dir", ".", "--output_fname", "unused",
            "--grounding_mode", *FLAGS]
    jargs = parse(jflags, base)
    return jbuild(jargs), jargs, tbuild(parse(tflags, base + ["--device", "cpu"]))


def record_queries(monkeypatch, session):
    """The queries a driver hands ``score_video``, in order."""
    queries = []
    score_video = session.score_video

    def recorded(frames, query=None):
        queries.append(query)
        return score_video(frames, query=query)

    monkeypatch.setattr(session, "score_video", recorded)
    return queries


def assert_results_match(got, ref):
    """Keys, videos, true frames, times, responses and durations equal;
    scores within 1e-3 after the drivers' rounding to 3 places."""
    assert [x.get("video_uuid") for x in got] == [x.get("video_uuid") for x in ref]
    for a, b in zip(got, ref):
        assert list(a) == list(b)
        for k in a:
            if k != "debug_data":
                assert a[k] == b[k], k
        assert len(a["debug_data"]) == len(b["debug_data"]) > 0
        assert [list(d) for d in a["debug_data"]] == [list(d) for d in b["debug_data"]]
        assert [d["time"] for d in a["debug_data"]] == [d["time"] for d in b["debug_data"]]
        np.testing.assert_allclose([[d[k] for k in KEYS] for d in a["debug_data"]],
                                   [[d[k] for k in KEYS] for d in b["debug_data"]], atol=1e-3)


TVSUM_RUNS = {
    "plain": dict(seed=0),
    "degraded": dict(seed=1, degraded=True,
                     dropout_types=("color_banding", "blackout", "quality")),
    "title_ablation": dict(seed=None, title_ablation="unrelated"),
    "no_query": dict(seed=2, no_query=True),
}


@pytest.mark.parametrize("case", list(TVSUM_RUNS))
def test_run_tvsum_matches_jax(data, sessions, tmp_path, monkeypatch, case):
    """``run_tvsum`` of the port and of JAX on the clips: the same videos in
    metadata order (the uncaptioned one skipped), the same queries drawn in
    the same order (seed None: from the global ``random``, seeded alike), the
    same true frames; a degraded run's dropout segments come from
    ``hash(video_uuid)``, equal within this process; the metadata scans
    written alike."""
    jsess, _, tsess = sessions
    kw = dict(TVSUM_RUNS[case])
    if kw.get("title_ablation"):
        kw["title_table"] = str(data / "titles.json")
    runs = []
    for name, mod, sess in (("port", benchmarks, tsess), ("jax", jbenchmarks, jsess)):
        queries = record_queries(monkeypatch, sess)
        random.seed(1234)
        res = mod.run_tvsum(sess, input_dir=str(data / "videos"),
                            caption_file=str(data / "info.tsv"),
                            video_metadata_file=str(tmp_path / f"{name}-meta.json"),
                            output_fname=str(tmp_path / f"{name}.json"), frame_fps=2.0, **kw)
        assert json.loads((tmp_path / f"{name}.json").read_text()) == json.loads(json.dumps(res))
        runs.append((res, queries))
    (got, got_q), (ref, ref_q) = runs
    assert got_q == ref_q and len(got_q) == 3
    assert all(q == "" for q in got_q) == (case == "no_query")
    assert sorted(x["video_uuid"] for x in got) == sorted(CLIPS)
    assert_results_match(got, ref)
    assert json.loads((tmp_path / "port-meta.json").read_text()) == \
        json.loads((tmp_path / "jax-meta.json").read_text())
    for x in got:
        n = CLIPS[x["video_uuid"]][0]
        assert x["true_frames_list"] == list(range(0, n, 4)) and x["video_duration"] == n / 8


def test_run_hisum_matches_jax(data, sessions, tmp_path, monkeypatch):
    """``run_hisum`` over test keys with a missing metadata row, a missing
    video and a label list that does not parse: the same results in key
    order, queries and categories."""
    jsess, _, tsess = sessions
    runs = []
    for name, mod, sess in (("port", benchmarks, tsess), ("jax", jbenchmarks, jsess)):
        queries = record_queries(monkeypatch, sess)
        res = mod.run_hisum(sess, input_dir=str(data / "videos"),
                            anno_file=str(data / "hisum_keys.json"),
                            h5_file=str(data / "hisum.h5"),
                            hisum_metadata=str(data / "hisum_meta.csv"),
                            video_metadata_file=str(tmp_path / f"{name}-meta.json"),
                            output_fname=str(tmp_path / f"{name}.json"), frame_fps=2.0, seed=4)
        assert json.loads((tmp_path / f"{name}.json").read_text()) == json.loads(json.dumps(res))
        runs.append((res, queries))
    (got, got_q), (ref, ref_q) = runs
    assert got_q == ref_q and len(got_q) == 2
    assert [(x["h5_identifier"], x["categories"]) for x in got] == [("video_2", []),
                                                                    ("video_1", ["Food"])]
    assert_results_match(got, ref)


def test_session_find_ticks_matches_jax(sessions):
    """``StreamSession.find_ticks`` at the session's rate and at another."""
    jsess, _, tsess = sessions
    scores = np.abs(np.convolve(np.random.default_rng(5).normal(size=240), np.ones(9) / 9, "same"))
    for fps, kw in ((None, {}), (1.0, {}), (4.0, dict(min_separation=3, prominence=0.01))):
        got = tsess.find_ticks(scores, fps, **kw)
        assert got == jsess.find_ticks(scores, fps, **kw)
    assert tsess.find_ticks(scores) and tsess.frame_fps == 2.0


@pytest.mark.parametrize("dataset,extra,grounding", [
    ("tvsum", [], True), ("tvsum_degraded", ["--stream_end_prob_threshold", "0.5"], False),
    ("hisum", [], True), ("youcook2", ["--grounding_mode"], True),
    ("youcook2", ["--threshold_z", "1.5"], False)])
def test_cli_infer_grounding_rule_matches_jax(monkeypatch, dataset, extra, grounding):
    """A scoring-only dataset, or --grounding_mode, with no stopping
    criterion runs in grounding mode; the session each command would build
    gets the same flags."""
    seen = []

    class Built(Exception):
        pass

    def capture(args):
        seen.append(session_args(args))
        raise Built

    argv = ["--test_dataset", dataset, "--input_dir", ".", "--output_fname", "x", *FLAGS, *extra]
    for mod, cmd, more in ((tinfer, tinfer.cmd_infer, ["--device", "cpu"]),
                           (jinfer, jinfer.cmd_infer, [])):
        monkeypatch.setattr(mod, "_build_session", capture)
        with pytest.raises(Built):
            cmd(argv + more)
    assert seen[0] == seen[1] and seen[0]["grounding_mode"] is grounding


def _infer_argv(data, dataset, out, meta):
    argv = ["infer", "--test_dataset", dataset, "--input_dir", str(data / "videos"),
            "--output_fname", str(out), "--video_metadata_file", str(meta), "--seed", "0", *FLAGS]
    if dataset == "hisum":
        return argv + ["--caption_metadata_file", str(data / "hisum_meta.csv"), "--anno_file",
                       str(data / "hisum_keys.json"), "--hisum_h5_file", str(data / "hisum.h5")]
    return argv + ["--caption_metadata_file", str(data / "info.tsv")]


def jax_infer(sessions, monkeypatch, argv):
    """JAX's ``infer`` command on the module's JAX session, after checking
    that the flags would build that session."""
    jsess, jargs, _ = sessions

    def reuse(args):
        assert session_args(args) == session_args(jargs)
        return jsess

    monkeypatch.setattr(jinfer, "_build_session", reuse)
    jinfer.cmd_infer(argv)


def test_cli_chain_matches_jax(data, sessions, port_infer, tmp_path, monkeypatch, capsys):
    """``python -m aha_tpu_torch.cli infer --test_dataset tvsum`` at the tiny
    preset with synthetic int8 weights on the CPU, then ``grid-search``,
    ``evaluate`` and ``highlight`` on its predictions through the command
    line's ``main``: the predictions within 1e-3 of JAX's ``infer`` with the
    same flags; JAX's grid-search and evaluate on the port's predictions
    print and write what the port's do; the reel has the frames it says."""
    proc, pred, meta = port_infer
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    jpred = tmp_path / "jax-pred.json"
    jax_infer(sessions, monkeypatch, _infer_argv(data, "tvsum", jpred, meta)[1:])
    got, ref = json.loads(pred.read_text()), json.loads(jpred.read_text())
    assert_results_match(got, ref)
    assert {x["video_uuid"] for x in got} == set(CLIPS)
    for x in got:
        assert set(x) == {"video_uuid", "model_response_list", "video_duration",
                          "true_frames_list", "debug_data"}
        assert len(x["true_frames_list"]) == len(x["debug_data"])

    gold = str(data / "anno.tsv")
    outs = []
    for name, grid, evaluate in (("port", None, None),
                                 ("jax", jevaluate.cmd_grid_search, jevaluate.cmd_evaluate)):
        params, metrics = tmp_path / f"{name}-params.json", tmp_path / f"{name}-metrics.json"
        g = ["--test_dataset", "tvsum", "--pred_file", str(pred), "--gold_file", gold,
             "--save_path", str(params), "--seed", "0"]
        e = ["--func", "tvsum", "--pred_file", str(pred), "--gold_file", gold, "--params_file",
             str(params), "--output_file", str(metrics)]
        if grid is None:
            assert main(["grid-search", *g]) == 0 and main(["evaluate", *e]) == 0
        else:
            grid(g)
            evaluate(e)
        outs.append((capsys.readouterr().out, params.read_text(), metrics.read_text()))
    assert outs[0] == outs[1]
    m = json.loads(outs[0][2])
    assert set(m["overall"]) == {"mAP50", "mAP15", "top5_mAP", "spearman", "kendall", "f1@15"}
    assert set(m["per_category"]) == {"GA", "BK"}

    reel = tmp_path / "reel.mp4"
    argv = ["--pred_file", str(pred), "--video_uuid", "vidC", "--video_path",
            str(data / "videos" / "vidC.mp4"), "--max_duration", "4", "--params_file",
            str(tmp_path / "port-params.json"), "--source_fps", "8"]
    assert main(["highlight", *argv, "--output_filepath", str(reel)]) == 0
    got_hl = capsys.readouterr().out
    jevaluate.cmd_highlight(argv + ["--output_filepath", str(tmp_path / "jax-reel.mp4")])
    assert got_hl == capsys.readouterr().out
    cap = cv2.VideoCapture(str(reel))
    n = 0
    while cap.read()[0]:
        n += 1
    assert json.loads(got_hl)["frames_written"] == n


@pytest.mark.parametrize("dataset", ["tvsum_degraded", "hisum"])
def test_cli_infer_other_datasets_match_jax(data, sessions, tmp_path, monkeypatch, dataset):
    """The port's ``infer --test_dataset tvsum_degraded`` and ``hisum`` (its
    own session from the flags) against JAX's command with the same flags."""
    meta = tmp_path / "meta.json"
    tinfer.cmd_infer(_infer_argv(data, dataset, tmp_path / "port.json", meta)[1:]
                     + ["--device", "cpu"])
    jax_infer(sessions, monkeypatch, _infer_argv(data, dataset, tmp_path / "jax.json", meta)[1:])
    got = json.loads((tmp_path / "port.json").read_text())
    assert_results_match(got, json.loads((tmp_path / "jax.json").read_text()))
    assert len(got) == (2 if dataset == "hisum" else 3)
