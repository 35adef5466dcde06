"""The streaming-QA drivers: ``run_streaming_qa`` and the two passes it
runs, and ``run_streaming_qa_multi`` over concurrent streams, the port's
copy of ``aha_tpu/drivers/benchmarks.py:48-91, 290-491``. Output: JSONL, one
line per question in dataset order, {question_id, model_response_list,
video_duration, debug_data} with the scores rounded as the reference rounds
them. The tvsum / hisum drivers are not ported (ROADMAP.md, Queue 1 item
7)."""

from __future__ import annotations

import json

import numpy as np

from ..data.pipeline import prefetch_iterable
from ..streaming.session import StreamSession
from .eval_dataset import StreamingVideoQADataset


def truncate_sig(x: float, sig: int = 3) -> float:
    if x == 0:
        return 0
    return float(f"{x:.{sig}g}")


def round_numbers(data, n: int = 3):
    """Floats to n decimals, or to n significant digits where |x| <= 10^-n,
    through lists and dicts."""
    if isinstance(data, list):
        return [round_numbers(d, n) for d in data]
    if isinstance(data, dict):
        return {k: round_numbers(v, n) for k, v in data.items()}
    if isinstance(data, float):
        return truncate_sig(data, n) if abs(data) <= 10 ** (-n) else round(data, n)
    return data


def _score_only_pass(session: StreamSession, frames, fps: float, query: str):
    """Scores with no generation (``score_video``): (responses, debug)."""
    session.reset()
    session.set_fps(fps=fps)
    session.score_video(frames, query=query)
    return [], session.debug_data_list


def _full_pass(session: StreamSession, frames, fps: float, conversation):
    """``inference()`` over the video with the conversation's queries:
    (responses, debug)."""
    session.reset()
    session.set_fps(fps=fps)
    session.input_video_stream(frames)
    session.input_query_stream(conversation)
    responses = session.inference()
    return responses, session.debug_data_list


def run_streaming_qa(session: StreamSession, *, test_fname: str, input_dir: str,
                     output_fname: str, frame_fps: float, max_num_frames: int,
                     grounding_mode: bool = False, start_idx: int = 0,
                     end_idx: int | None = None,
                     time_instruction_format: str | None = None) -> list[dict]:
    """youcook2 / magqa / charades / generic at one stream: each question's
    video through ``inference()`` (or, in grounding mode, ``score_video``
    with the first user turn as the query), written to ``output_fname`` as
    it completes. Returns the results."""
    dataset = StreamingVideoQADataset(
        test_fname, input_dir, start_idx=start_idx, end_idx=end_idx, output_fps=frame_fps,
        output_resolution=session.args.frame_resolution, max_num_frames=max_num_frames,
        time_instruction_format=time_instruction_format,
        system_prompt=session.args.system_prompt)
    results = []
    items = prefetch_iterable((dataset[i] for i in range(len(dataset))), depth=2)
    with open(output_fname, "w") as f_out:
        for i, (question_id, frames, conversation, fps, duration) in enumerate(items):
            if question_id is None:
                continue
            if grounding_mode:
                query = next((t["content"] for t in conversation if t["role"] == "user"), "")
                _, debug = _score_only_pass(session, frames, fps, query)
                responses = [{"time": t.get("time", 0), "content": t["content"], "role": "user"}
                             for t in conversation if t["role"] == "user"]
            else:
                user_turns = [t for t in conversation if t["role"] == "user"]
                responses, debug = _full_pass(session, frames, fps, user_turns)
            res = {"question_id": question_id, "model_response_list": responses,
                   "video_duration": duration, "debug_data": round_numbers(debug, 3)}
            results.append(res)
            f_out.write(json.dumps(res) + "\n")
            if i % 5 == 0:
                f_out.flush()
    return results


def run_streaming_qa_multi(session: StreamSession, *, batch: int, test_fname: str,
                           input_dir: str, output_fname: str, frame_fps: float,
                           max_num_frames: int, grounding_mode: bool = False,
                           start_idx: int = 0, end_idx: int | None = None,
                           time_instruction_format: str | None = None) -> list[dict]:
    """``run_streaming_qa`` over ``batch`` concurrent streams in one batched
    engine (``infer --concurrent_streams N``), on ``session``'s weights,
    device and settings. The lines have the solo driver's format and, per
    stream, its content, in dataset order. Grounding mode scores fixed
    groups of ``batch`` videos in lockstep (``MultiStreamScorer``, the last
    group padded with empty streams); generation mode runs continuous
    batching (``MultiStreamServer``): a slot is refilled the moment its
    stream ends. Needs a fixed frame_fps."""
    from ..streaming.multi import MultiStreamScorer, MultiStreamServer

    if not isinstance(frame_fps, (int, float)) or frame_fps <= 0:
        raise ValueError("concurrent streams need a fixed positive frame_fps")
    eng = session.engine
    dataset = StreamingVideoQADataset(
        test_fname, input_dir, start_idx=start_idx, end_idx=end_idx, output_fps=frame_fps,
        output_resolution=session.args.frame_resolution, max_num_frames=max_num_frames,
        time_instruction_format=time_instruction_format,
        system_prompt=session.args.system_prompt)
    kw = dict(batch=batch, device=eng.device, backend=eng.backend, lora=eng.lora,
              lora_scale=eng.lora_scale)
    results: list[dict] = []
    if grounding_mode:
        scorer = MultiStreamScorer(eng.params, eng.cfg, session.tokenizer, session.args, **kw)
        S = session.args.frame_resolution

        def flush_group(group, f_out):
            n = len(group)
            if n == 0:
                return
            # empty pad streams cost nothing: the scorer's active mask blanks them
            items = group + [(None, np.zeros((0, S, S, 3), np.uint8), [], frame_fps, 0.0)
                             ] * (batch - n)
            # a real stream without a query scores behind "" as the solo driver's
            # does; a pad has no query chunk at all
            queries = [next((t["content"] for t in it[2] if t["role"] == "user"),
                            "" if it[0] is not None else None) for it in items]
            debugs = scorer.score_videos([it[1] for it in items], queries, fps=frame_fps)
            for it, dbg in zip(items[:n], debugs[:n]):
                res = {"question_id": it[0],
                       "model_response_list": [{"time": t.get("time", 0),
                                                "content": t["content"], "role": "user"}
                                               for t in it[2] if t["role"] == "user"],
                       "video_duration": it[4], "debug_data": round_numbers(dbg, 3)}
                results.append(res)
                f_out.write(json.dumps(res) + "\n")
            f_out.flush()

        group: list = []
        with open(output_fname, "w") as f_out:
            for i in range(len(dataset)):
                item = dataset[i]
                if item[0] is None:
                    continue
                group.append(item)
                if len(group) == batch:
                    flush_group(group, f_out)
                    group = []
            flush_group(group, f_out)
        return results

    server = MultiStreamServer(eng.params, eng.cfg, session.tokenizer, session.args,
                               max_frames=max_num_frames, **kw)
    meta: dict[int, tuple] = {}
    order: list[int] = []

    def gen_items():
        # the next videos decode on the host while the card serves the current ones
        raw = prefetch_iterable(((idx, dataset[idx]) for idx in range(len(dataset))), depth=2)
        for idx, (qid, frames, conversation, _fps, duration) in raw:
            if qid is None:
                continue
            meta[idx] = (qid, duration)
            order.append(idx)
            yield idx, frames, [t for t in conversation if t["role"] == "user"]

    done: dict[int, dict] = {}
    written = [0]
    with open(output_fname, "w") as f_out:

        def flush_ordered():
            while written[0] < len(order) and order[written[0]] in done:
                idx = order[written[0]]
                row = done.pop(idx)
                qid, duration = meta[idx]
                res = {"question_id": qid, "model_response_list": row["responses"],
                       "video_duration": duration,
                       "debug_data": round_numbers(row["debug_data"], 3)}
                results.append(res)
                f_out.write(json.dumps(res) + "\n")
                written[0] += 1
            f_out.flush()

        def on_result(idx, row):
            done[idx] = row
            flush_ordered()

        server.run_items(gen_items(), fps=frame_fps, on_result=on_result)
        flush_ordered()
    return results
