"""``aha infer`` and ``aha demo`` on the port: the benchmark drivers and the
live-video entry points (``aha_tpu/cli/infer.py``).

``infer``: tvsum / tvsum_degraded / hisum score each video with no generation
(``run_tvsum``, ``run_hisum``); the streaming-QA datasets (youcook2 / magqa /
charades / generic) run ``run_streaming_qa``, at one stream or at
``--concurrent_streams`` N in one batched engine, in generation and in
grounding mode; the live-video datasets (arl_scout / hubble_space /
jkim_landing) score one video file or frame folder against its query
(``drivers/live_video.py``), with the tick table's ground truth where it has
an entry, and report the run's telemetry. A scoring-only dataset, or
``--grounding_mode``, with no stopping criterion runs in grounding mode, as
in JAX.

``demo``: one video scored in grounding mode at the product cache (sink 2048
+ 32), ticks detected, the plot written and, with ``--render_video``, the
stitched MP4; ``--motion_skip_threshold`` skips the frames that carry no new
content.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

from ._session import _add_infer_flags, _build_session

LIVE_DATASETS = ("arl_scout", "hubble_space", "jkim_landing")
# the live-video datasets' running queries where --query is not given
DEFAULT_QUERIES = {
    "arl_scout": "what objects are in this room?",
    "hubble_space": "Launch of the Hubble Space Telescope, April 24-29 1990",
    "jkim_landing": "NASA Astronaut Jonny Kim Soyuz MS-27 Docking",
}


def _monitor(session):
    from ..utils import telemetry

    return telemetry.DeviceMonitor(devices=[session.engine.device])


def _infer_live(session, args):
    """The live-video branch: frames of a video file or a frame folder from
    ``--start_sec`` on, scored against the query; the result JSON (with the
    debug data) to ``--output_fname``, the rest printed."""
    from ..data import media
    from ..drivers import live_video

    query = args.query or DEFAULT_QUERIES[args.test_dataset]
    size = session.args.frame_resolution
    if os.path.isdir(args.input_dir):
        frames, fps, _ = media.load_frame_folder(args.input_dir, output_size=size,
                                                 output_fps=args.frame_fps)
    else:
        frames, _ = media.decode_video(args.input_dir, output_fps=args.frame_fps,
                                       output_size=size)
        fps = args.frame_fps
    if args.start_sec > 0:
        frames = frames[int(args.start_sec * fps):]
    gt_ticks = None
    if args.tick_table and os.path.exists(args.tick_table):
        try:
            gt_ticks = live_video.load_tick_table(args.tick_table, args.test_dataset)
        except KeyError:          # no entry for this dataset: no ground truth
            pass
    result = live_video.infer_on_live_video(
        session, frames, query, fps, output_dir=os.path.dirname(args.output_fname) or ".",
        gt_ticks=gt_ticks, monitor=_monitor(session))
    with open(args.output_fname, "w") as f:
        json.dump(result, f)
    print(json.dumps({k: v for k, v in result.items() if k != "debug_data"}, default=float))


def cmd_infer(argv):
    from ..drivers import benchmarks

    p = argparse.ArgumentParser(prog="aha infer")
    _add_infer_flags(p)
    args = p.parse_args(argv)
    if args.grounding_mode or args.test_dataset in ("tvsum", "tvsum_degraded", "hisum",
                                                    *LIVE_DATASETS):
        # scoring-only passes need no stopping criterion
        if (args.stream_end_prob_threshold is None and args.threshold_z is None
                and args.stream_end_score_sum_threshold is None):
            args.grounding_mode = True
    session = _build_session(args)
    if args.test_dataset in LIVE_DATASETS:
        _infer_live(session, args)
        return
    if args.test_dataset in ("tvsum", "tvsum_degraded"):
        benchmarks.run_tvsum(
            session, input_dir=args.input_dir, caption_file=args.caption_metadata_file,
            video_metadata_file=args.video_metadata_file, output_fname=args.output_fname,
            frame_fps=args.frame_fps, degraded=args.test_dataset == "tvsum_degraded",
            title_ablation=args.title_ablation, title_table=args.title_table,
            no_query=args.no_query, seed=args.seed)
        return
    if args.test_dataset == "hisum":
        benchmarks.run_hisum(
            session, input_dir=args.input_dir, anno_file=args.anno_file,
            h5_file=args.hisum_h5_file, hisum_metadata=args.caption_metadata_file,
            video_metadata_file=args.video_metadata_file, output_fname=args.output_fname,
            frame_fps=args.frame_fps, no_query=args.no_query, seed=args.seed)
        return
    run = benchmarks.run_streaming_qa
    if args.concurrent_streams > 1:
        run = functools.partial(benchmarks.run_streaming_qa_multi,
                                batch=args.concurrent_streams)
    run(session, test_fname=args.test_fname, input_dir=args.input_dir,
        output_fname=args.output_fname, frame_fps=args.frame_fps,
        max_num_frames=args.max_num_frames, grounding_mode=args.grounding_mode,
        start_idx=args.start_idx, end_idx=args.end_idx,
        time_instruction_format=args.time_instruction_format)


def demo_args(argv) -> argparse.Namespace:
    """``demo``'s flags parsed, with its fixed settings (grounding mode at the
    product cache, JAX's demo values) set on them."""
    p = argparse.ArgumentParser(prog="aha demo")
    p.add_argument("--device", default="cuda",
                   help="torch device of the session (default: the card; 'cpu' runs the "
                        "kernels' plain versions on the host)")
    p.add_argument("--video", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--output_dir", default="outputs/demo")
    p.add_argument("--frame_fps", type=float, default=1.0)
    p.add_argument("--tick_table", default=None)
    p.add_argument("--tick_name", default=None)
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--model_preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--llm_pretrained", default=None)
    p.add_argument("--tokenizer_pretrained", default=None)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--vision_int8", action="store_true",
                   help="quantize the vision tower too (see aha infer)")
    p.add_argument("--w8a8", action="store_true",
                   help="serving mode: int8 weights, per-token int8 activations, an int8 "
                        "vision tower and fused width 8 (see aha infer --w8a8)")
    p.add_argument("--motion_skip_threshold", type=float, default=None,
                   help="skip scoring frames whose mean pixel change since the last scored "
                        "frame is below this (0..1, e.g. 0.02); their scores are held on "
                        "the time grid (media.motion_mask)")
    p.add_argument("--motion_max_skip", type=int, default=8,
                   help="always score at least every Nth frame under --motion_skip_threshold")
    args = p.parse_args(argv)
    args.grounding_mode = True
    args.stream_end_prob_threshold = None
    args.threshold_z = None
    args.stream_end_score_sum_threshold = None
    args.remove_assistant_turns = False
    args.score_heads = "relevance_score,informative_score"
    args.repetition_penalty = None
    args.max_new_tokens = 200
    args.kv_cache_policy = "sink"
    args.kv_window = 2048
    args.num_sink_tokens = 32
    return args


def cmd_demo(argv):
    """Live-video demo: score a video, detect ticks, write the plot and,
    with ``--render_video``, the stitched MP4."""
    import numpy as np

    from ..data import media
    from ..drivers import live_video

    args = demo_args(argv)
    session = _build_session(args)

    frames, _ = media.decode_video(args.video, output_fps=args.frame_fps,
                                   output_size=session.args.frame_resolution)
    gt_ticks = None
    if args.tick_table and args.tick_name:
        gt_ticks = live_video.load_tick_table(args.tick_table, args.tick_name)
    result = live_video.infer_on_live_video(
        session, frames, args.query, args.frame_fps, output_dir=args.output_dir,
        gt_ticks=gt_ticks, monitor=_monitor(session),
        motion_skip_threshold=args.motion_skip_threshold, motion_max_skip=args.motion_max_skip)
    print(json.dumps({k: v for k, v in result.items() if k != "debug_data"}, default=float))
    if args.render_video:
        scores = np.asarray([d["relevance_score"] for d in result["debug_data"]])
        out = live_video.render_demo_video(frames, scores, args.frame_fps,
                                           f"{args.output_dir}/demo_stitched.mp4",
                                           ticks=result["ticks"])
        print(f"stitched demo video: {out}")
