"""The live-video slice of the port on the CPU against the JAX package:
``media.motion_mask`` / ``reencode_video``, the tick tables and the dialogue
tagger (bit for bit), ``utils/telemetry.py`` (``StepTimer.summary``'s keys,
``flops_estimate`` on a product equal to XLA's count, ``DeviceMonitor``'s
report), ``drivers/live_video.infer_on_live_video`` with and without the
motion skip on one bridged tiny session (scores within 1e-5 before JAX's
3-place rounding and equal after it; ticks, ground truth and frames scored
equal; the JSON and the plot written), ``render_demo_video`` frame for frame,
the session's interactive API (``encode_given_query`` + ``input_one_frame``:
per-frame scores within 1e-5 of JAX's, responses equal, and bit for bit the
port's own stepwise loop), and the commands: ``demo`` and ``infer
--test_dataset arl_scout | hubble_space | jkim_landing`` (a cv2 clip and a
frame folder, ``--start_sec``), whose printed JSON equals JAX's command's on
the same flags at ``--model_preset tiny`` except the telemetry's numbers."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu import native
from aha_tpu.cli import infer as jinfer
from aha_tpu.config import InferConfig as JInferConfig
from aha_tpu.config import aha_tiny
from aha_tpu.data import media as jmedia
from aha_tpu.drivers import live_video as jlive
from aha_tpu.models import aha as jaha
from aha_tpu.ops.kv_cache import CachePolicy as JCachePolicy
from aha_tpu.streaming.engine import StreamEngine as JStreamEngine
from aha_tpu.streaming.session import StreamSession as JStreamSession
from aha_tpu.utils import telemetry as jtelemetry

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.cli import infer as tinfer
from aha_tpu_torch.config import InferConfig
from aha_tpu_torch.data import media
from aha_tpu_torch.drivers import live_video
from aha_tpu_torch.streaming.session import build_session
from aha_tpu_torch.tokenization import build_stream_tokenizer
from aha_tpu_torch.utils import telemetry

cv2 = pytest.importorskip("cv2")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TICKS = ROOT / "configs" / "tick_tables" / "demo_ticks.json"
KEYS = ("informative_score", "relevance_score", "uncertainty_score")
QUERY = "What is happening in this video?"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cv2_decoder(monkeypatch):
    """Both packages decode with their native libav builds where there is
    one; both are held to their cv2 paths."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")   # the port's too


def stepped_frames(n: int, hw=(40, 48), seed: int = 0) -> np.ndarray:
    """Frames with static stretches (4 frames a level) and noise on some, so
    that a motion threshold keeps a known share."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, *hw, 3), np.uint8)
    for t in range(n):
        out[t] = (t // 4) * 23 % 256
        if t % 7 == 3:
            out[t, :8, :8] = rng.integers(0, 256, (8, 8, 3))
    return out


# -- host functions, bit for bit -------------------------------------------------------------


@pytest.mark.parametrize("threshold, max_skip", [(0.0, 8), (0.02, 8), (0.05, 3), (1.0, 4)])
def test_motion_mask_matches_jax(threshold, max_skip):
    frames = stepped_frames(40)
    frames[5:9] += np.random.default_rng(1).integers(0, 3, frames[5:9].shape, dtype=np.uint8)
    got = media.motion_mask(frames, threshold, max_skip=max_skip)
    np.testing.assert_array_equal(got, jmedia.motion_mask(frames, threshold, max_skip=max_skip))
    assert got[0] and got.dtype == bool
    assert media.motion_mask(frames[:0], 0.02).shape == (0,)


def test_reencode_video_matches_jax(tmp_path):
    src = tmp_path / "src.mp4"
    media.write_video(stepped_frames(24, (48, 64)), str(src), 8.0)
    outs = []
    for mod, name in ((media, "port.mp4"), (jmedia, "jax.mp4")):
        n = mod.reencode_video(str(src), str(tmp_path / name), fps=4.0, size=(32, 24))
        frames, _ = media.decode_video(str(tmp_path / name), output_fps=4.0, output_size=32)
        outs.append((n, frames))
    assert outs[0][0] == outs[1][0] == 12
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_tick_tables_match_jax(tmp_path):
    for name in ("arl_scout", "hubble_space", "jkim_landing"):
        spans = live_video.load_tick_table(str(TICKS), name)
        assert spans == jlive.load_tick_table(str(TICKS), name)
        assert bool(spans) == (name != "jkim_landing")     # its entry lists no span yet
        assert live_video.spans_to_ticks(spans) == jlive.spans_to_ticks(spans)
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"x": {"ticks": [1, 2.5]}}))
    assert live_video.load_tick_table(str(legacy), "x") == jlive.load_tick_table(str(legacy), "x")
    assert live_video.spans_to_ticks([3.0, (1, 2, "a")]) == jlive.spans_to_ticks([3.0, (1, 2, "a")])
    with pytest.raises(KeyError):
        live_video.load_tick_table(str(TICKS), "no_such_video")


def test_tagger_matches_jax():
    segs = [{"start": 0.0, "end": 2.0, "text": "Go forward to the door."},
            {"start": 2.5, "end": 3.0, "text": "okay okay"},
            {"start": 4.0, "end": 6.0, "text": "Stop! Take a photo of the object."},
            {"start": 7.0, "end": 9.0, "text": "turn left and look"}]
    for kw in ({}, {"threshold": 1.0}, {"keywords": {"door": 5.0}}):
        got = live_video.tag_important_segments(segs, **kw)
        assert got == jlive.tag_important_segments(segs, **kw)
        assert live_video.segments_to_gt_ticks(got) == jlive.segments_to_gt_ticks(got)


def test_step_timer_and_monitor_match_jax():
    timers = [telemetry.StepTimer(), jtelemetry.StepTimer()]
    assert timers[0].summary() == timers[1].summary() == {"n": 0}
    for t in timers:
        for _ in range(3):
            with t:
                pass
    assert list(timers[0].summary()) == list(timers[1].summary())
    assert timers[0].summary()["n"] == 3
    mon = telemetry.DeviceMonitor(0.01, devices=["cpu"]).start()
    mon.stop()
    rep = mon.report()
    assert list(rep) == list(jtelemetry.DeviceMonitor(0.01).report())
    assert rep["peak_hbm_gb"] == 0.0 and rep["samples"] >= 2 and rep["peak_ram_gb"] > 0
    with telemetry.profile_trace(None):
        pass


@pytest.mark.parametrize("shape", [(5, 7, 3), (64, 32, 48), (1, 128, 9)])
def test_flops_estimate_matches_jax(shape):
    """One f32 product [M, K] @ [K, N]: 2 M N K flops and (M K + K N + M N)
    x 4 bytes, as XLA's cost analysis counts them. (On the CPU XLA turns a
    bf16 dot into converts around an f32 one and counts those too.)"""
    M, K, N = shape
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(K, N)).astype(np.float32)
    got = telemetry.flops_estimate(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    ref = jtelemetry.flops_estimate(jnp.dot, jnp.asarray(a), jnp.asarray(b))
    assert got == ref == {"flops": 2.0 * M * K * N, "bytes_accessed": 4.0 * (M * K + K * N + M * N)}


# -- the scoring pass on one bridged tiny session --------------------------------------------


@pytest.fixture(scope="module")
def sessions():
    """JAX's tiny seed-0 model and one JAX engine at fused 4 (its sessions
    share its programs), and a port session builder on the bridged tree."""
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    engine = JStreamEngine(params, cfg, JCachePolicy("sink", window=2048, num_sink=32),
                           max_new_tokens=12, spec_tokens=1, fused_score_frames=4)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    d = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    d["llm"] = tconfig.QwenConfig(**cfg.llm.__dict__)
    d["vision"] = tconfig.SiglipConfig(**cfg.vision.__dict__)
    tcfg = tconfig.AhaConfig(**d)
    ttok = build_stream_tokenizer(None, frame_num_tokens=tcfg.frame_num_tokens,
                                  vocab_size=tcfg.llm.vocab_size)

    def port(icfg: dict, **widths):
        return build_session(tp, tcfg, ttok, InferConfig(**icfg, **widths), device="cpu")

    def jax_(icfg: dict):
        return JStreamSession(engine, tok, JInferConfig(**icfg))

    return jax_, port


@pytest.mark.parametrize("skip", [None, 0.02])
def test_infer_on_live_video_matches_jax(sessions, tmp_path, skip):
    """Scored frames within 1e-5 before rounding, debug_data equal after JAX's
    3-place rounding, ticks / gt / frames scored equal, the JSON and the plot
    written; under the motion skip held frames copy the last scored one."""
    jax_, port = sessions
    frames = stepped_frames(24)
    gt = live_video.load_tick_table(str(TICKS), "hubble_space")
    runs = []
    for mod, make in ((jlive, jax_), (live_video, port)):
        sess = make(dict(grounding_mode=True, frame_fps=2.0))
        out = tmp_path / mod.__name__.split(".")[0]
        res = mod.infer_on_live_video(sess, frames, QUERY, 2.0, output_dir=str(out),
                                      gt_ticks=gt, motion_skip_threshold=skip)
        assert (out / "live_scores.png").stat().st_size > 0
        assert json.loads((out / "live_scores.json").read_text()) == json.loads(json.dumps(res))
        runs.append((res, sess.debug_data_list))
    (ref, jraw), (got, raw) = runs
    assert len(raw) == len(jraw) == got["frames_scored"]
    np.testing.assert_allclose([[r[k] for k in KEYS] for r in raw],
                               [[r[k] for k in KEYS] for r in jraw], rtol=0, atol=1e-5)
    assert got == ref
    kept = 24 if skip is None else int(media.motion_mask(frames, skip).sum())
    assert got["frames_scored"] == kept and (skip is None or kept < 24)


def test_render_demo_video_matches_jax(tmp_path):
    """The stitched MP4 read back with cv2: T frames, each equal to the one
    JAX's writer wrote."""
    frames = stepped_frames(12, (32, 48))
    scores = np.linspace(0.1, 0.9, 12) ** 2
    back = []
    for mod in (live_video, jlive):
        path = mod.render_demo_video(frames, scores, 2.0, str(tmp_path / f"{mod.__name__}.mp4"),
                                     ticks=[1.5, 4.0], plot_height=40)
        cap = cv2.VideoCapture(path)
        got = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            got.append(f)
        back.append(np.stack(got))
    assert back[0].shape == (12, 72, 48, 3)
    np.testing.assert_array_equal(back[0], back[1])


def test_interactive_api_matches_jax_and_stepwise(sessions):
    """encode_given_query, then input_one_frame a frame at a time: per-frame
    dicts within 1e-5 of JAX's, the same responses on the same frames (some
    fire), and every score and response equal bit for bit to the port's
    stepwise inference() over the same frames and query."""
    jax_, port = sessions
    frames = stepped_frames(12)
    probe = port(dict(grounding_mode=True, frame_fps=2.0))
    rows = probe.score_video(frames, query=QUERY)
    thr = sorted(r["informative_score"] + r["relevance_score"] for r in rows)[-4]
    icfg = dict(stream_end_prob_threshold=float(thr), frame_fps=2.0, max_new_tokens=12)
    outs = []
    for sess in (jax_(icfg), port(icfg, fused_score_frames=1, spec_decode_tokens=1)):
        sess.input_video_stream(frames)
        sess.encode_given_query(QUERY)
        outs.append([sess.input_one_frame() for _ in range(len(frames))])
    ref, got = outs
    assert [list(r) for r in got] == [list(r) for r in ref]
    for r, j in zip(got, ref):
        assert (r["frame_idx"], r["time"], r["response"]) == (j["frame_idx"], j["time"],
                                                              j["response"])
        np.testing.assert_allclose([r[k] for k in KEYS], [j[k] for k in KEYS], rtol=0, atol=1e-5)
    assert sum(r["response"] is not None for r in got) >= 2
    step = port(icfg, fused_score_frames=1, spec_decode_tokens=1)
    step.input_video_stream(frames)
    step.input_query_stream([{"role": "user", "content": QUERY, "time": 0}])
    turns = step.inference(chunked=False)
    assert [[d[k] for k in KEYS] for d in step.debug_data_list] == \
        [[r[k] for k in KEYS] for r in got]
    assert [t["content"] for t in turns if t["role"] == "assistant"] == \
        [r["response"] for r in got if r["response"] is not None]


# -- the commands ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("live")
    media.write_video(stepped_frames(40, (48, 64)), str(d / "clip.mp4"), 8.0)
    folder = d / "frames"
    folder.mkdir()
    for i, f in enumerate(stepped_frames(10, (36, 52), seed=3)):
        cv2.imwrite(str(folder / f"{i:04d}.png"), f)
    table = json.loads(TICKS.read_text())
    (d / "arl_only.json").write_text(json.dumps({"arl_scout": table["arl_scout"]}))
    return d


def _strip_telemetry(line: str) -> tuple[dict, list]:
    out = json.loads(line)
    tel = out.pop("telemetry")
    return out, sorted(tel)


def _run(cmd, argv, capsys) -> str:
    cmd(argv)
    return capsys.readouterr().out


# dataset -> (input, tick table, extra flags): a cv2 clip, a frame folder with --start_sec,
# a clip at 1 fps with a table that has no entry for the dataset
LIVE = {"arl_scout": ("clip.mp4", TICKS, ["--frame_fps", "2"]),
        "hubble_space": ("frames", TICKS, ["--frame_fps", "2", "--start_sec", "1.5"]),
        "jkim_landing": ("clip.mp4", "arl_only.json", ["--frame_fps", "1", "--query",
                                                      "a docking"])}


@pytest.mark.parametrize("dataset", sorted(LIVE))
def test_cli_infer_live_dataset_matches_jax(clips, tmp_path, capsys, dataset):
    """``infer --test_dataset <live>`` at the tiny preset: the printed JSON
    equal to JAX's command's (telemetry: the same keys), the result file's
    debug_data equal, the plot written beside it. A tick table with no entry
    for the dataset gives no ground truth (its KeyError swallowed, as in
    JAX)."""
    src, table, extra = LIVE[dataset]
    outs = []
    for name, cmd in (("port", tinfer.cmd_infer), ("jax", jinfer.cmd_infer)):
        (tmp_path / name).mkdir()
        argv = ["--model_preset", "tiny", "--test_dataset", dataset, "--input_dir",
                str(clips / src), "--output_fname", str(tmp_path / name / "live.json"),
                "--tick_table", str(clips / table), *extra]
        if name == "port":
            argv += ["--device", "cpu"]
        printed = _run(cmd, argv, capsys)
        outs.append((_strip_telemetry(printed.strip().splitlines()[-1]),
                     json.loads((tmp_path / name / "live.json").read_text())))
        assert (tmp_path / name / "live_scores.png").exists()
    (got, got_file), (ref, ref_file) = outs
    assert got == ref
    assert got_file["debug_data"] == ref_file["debug_data"]
    assert bool(got[0]["gt_ticks"]) == (dataset != "jkim_landing")


def test_cli_demo_matches_jax(clips, tmp_path, capsys):
    """``demo`` with the tick table, the motion skip and the stitched video:
    the printed JSON equal to JAX's (telemetry: the same keys), frames scored
    below frames decoded, the plot and a readable MP4 of one frame a decoded
    frame, equal to JAX's."""
    outs = []
    for name, cmd in (("port", tinfer.cmd_demo), ("jax", jinfer.cmd_demo)):
        argv = ["--model_preset", "tiny", "--video", str(clips / "clip.mp4"), "--query", QUERY,
                "--output_dir", str(tmp_path / name), "--frame_fps", "4", "--tick_table",
                str(TICKS), "--tick_name", "arl_scout", "--render_video",
                "--motion_skip_threshold", "0.02"]
        if name == "port":
            argv += ["--device", "cpu"]
        lines = _run(cmd, argv, capsys).strip().splitlines()
        assert lines[-1] == f"stitched demo video: {tmp_path / name}/demo_stitched.mp4"
        cap = cv2.VideoCapture(str(tmp_path / name / "demo_stitched.mp4"))
        n = 0
        while cap.read()[0]:
            n += 1
        outs.append((_strip_telemetry(lines[-2]), n))
        assert (tmp_path / name / "live_scores.png").exists()
    (got, n_got), (ref, n_ref) = outs
    assert got == ref and n_got == n_ref == 20
    assert got[0]["frames_scored"] < 20 and got[0]["gt_spans"]
