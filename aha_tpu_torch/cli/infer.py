"""``aha infer`` on the port: the streaming-QA benchmark driver, at one
stream or at ``--concurrent_streams`` N in one batched engine, in generation
and in grounding mode (``aha_tpu/cli/infer.py:12-121``, its youcook2 /
magqa / charades / generic branches)."""

from __future__ import annotations

import argparse
import functools

from ._session import _add_infer_flags, _build_session

# datasets of the JAX command that are not ported yet (ROADMAP.md, Queue 1 item 7)
_DATASETS_NOT_PORTED = ("tvsum", "tvsum_degraded", "hisum", "arl_scout", "hubble_space",
                        "jkim_landing")


def cmd_infer(argv):
    from ..drivers import benchmarks

    p = argparse.ArgumentParser(prog="aha infer")
    _add_infer_flags(p)
    args = p.parse_args(argv)
    if args.test_dataset in _DATASETS_NOT_PORTED:
        raise NotImplementedError(
            f"--test_dataset {args.test_dataset} is not ported to aha_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 7)")
    session = _build_session(args)
    run = benchmarks.run_streaming_qa
    if args.concurrent_streams > 1:
        run = functools.partial(benchmarks.run_streaming_qa_multi,
                                batch=args.concurrent_streams)
    run(session, test_fname=args.test_fname, input_dir=args.input_dir,
        output_fname=args.output_fname, frame_fps=args.frame_fps,
        max_num_frames=args.max_num_frames, grounding_mode=args.grounding_mode,
        start_idx=args.start_idx, end_idx=args.end_idx,
        time_instruction_format=args.time_instruction_format)
