"""``aha infer`` on the port: the benchmark drivers (``aha_tpu/cli/infer.py:12-121``).
tvsum / tvsum_degraded / hisum score each video with no generation
(``run_tvsum``, ``run_hisum``); the streaming-QA datasets (youcook2 / magqa /
charades / generic) run ``run_streaming_qa``, at one stream or at
``--concurrent_streams`` N in one batched engine, in generation and in
grounding mode. A scoring-only dataset, or ``--grounding_mode``, with no
stopping criterion runs in grounding mode, as in JAX. The live-video
datasets are not ported (ROADMAP.md, Queue 1 item 7)."""

from __future__ import annotations

import argparse
import functools

from ._session import _add_infer_flags, _build_session

# datasets of the JAX command that are not ported yet (ROADMAP.md, Queue 1 item 7)
_DATASETS_NOT_PORTED = ("arl_scout", "hubble_space", "jkim_landing")


def cmd_infer(argv):
    from ..drivers import benchmarks

    p = argparse.ArgumentParser(prog="aha infer")
    _add_infer_flags(p)
    args = p.parse_args(argv)
    if args.test_dataset in _DATASETS_NOT_PORTED:
        raise NotImplementedError(
            f"--test_dataset {args.test_dataset} is not ported to aha_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 7)")
    if args.grounding_mode or args.test_dataset in ("tvsum", "tvsum_degraded", "hisum"):
        # scoring-only passes need no stopping criterion
        if (args.stream_end_prob_threshold is None and args.threshold_z is None
                and args.stream_end_score_sum_threshold is None):
            args.grounding_mode = True
    session = _build_session(args)
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
